"""Synthetic dataset fixtures of the port (the mnist, cifar, LM,
frappe, census, heart and iris parts of elasticdl_tpu/testing/data.py):
the same seed writes the same bytes, so both packages train on one
record file."""

import csv
import os

import numpy as np

from elasticdl_tpu_torch.common import tensor_utils
from elasticdl_tpu_torch.data.record_file import RecordFileWriter


def create_mnist_record_file(path, num_records, seed=0, image_hw=28,
                             num_classes=10, learnable=True):
    """MNIST-shaped records. If ``learnable``, the label's block of pixels is
    brightened (orthogonal class signals) so tests can assert the model
    actually learns."""
    rng = np.random.RandomState(seed)
    with RecordFileWriter(path) as writer:
        for _ in range(num_records):
            label = int(rng.randint(num_classes))
            image = rng.rand(image_hw * image_hw) * 32.0
            if learnable:
                block = image.shape[0] // num_classes
                image[label * block:(label + 1) * block] += 192.0
            image = image.reshape(image_hw, image_hw)
            writer.write(
                tensor_utils.dumps(
                    {"image": image.astype(np.float32), "label": label}
                )
            )
    return path


def create_cifar_record_file(path, num_records, seed=0):
    """CIFAR-shaped (32, 32, 3) records whose brightness grows with the
    label."""
    rng = np.random.RandomState(seed)
    with RecordFileWriter(path) as writer:
        for _ in range(num_records):
            label = int(rng.randint(10))
            image = (rng.rand(32, 32, 3) * 127 + label * 12).astype(np.float32)
            writer.write(
                tensor_utils.dumps({"image": image, "label": label})
            )
    return path


def create_frappe_record_file(path, num_records, seed=0, input_length=10,
                              max_id=5383):
    """Frappe-style rows: ``input_length`` sparse feature ids in
    [0, max_id) and a click label (the parity of their sum).
    ``input_length=32, max_id=1_000_000`` gives the recsys ranker's
    records."""
    rng = np.random.RandomState(seed)
    with RecordFileWriter(path) as writer:
        for _ in range(num_records):
            ids = rng.randint(0, max_id, size=(input_length,))
            label = int(ids.sum() % 2)
            writer.write(
                tensor_utils.dumps(
                    {"feature_ids": ids.astype(np.int64), "label": label}
                )
            )
    return path


def create_lm_record_file(path, num_records, seed=0, seq_len=32,
                          vocab=256):
    """Byte-token LM sequences for the transformer zoo model. Each record
    is a +1-chain (tokens[i+1] = tokens[i]+1 mod vocab) so next-token
    prediction is fully learnable."""
    rng = np.random.RandomState(seed)
    with RecordFileWriter(path) as writer:
        for _ in range(num_records):
            start = int(rng.randint(vocab))
            tokens = (start + np.arange(seq_len + 1)) % vocab
            writer.write(
                tensor_utils.dumps({"tokens": tokens.astype(np.int64)})
            )
    return path


def create_census_record_file(path, num_records, seed=0):
    """Census-style mixed dense+categorical rows (wide&deep workload)."""
    rng = np.random.RandomState(seed)
    education = ["Bachelors", "HS-grad", "Masters", "Doctorate",
                 "Some-college"]
    workclass = ["Private", "Self-emp", "Federal-gov", "Local-gov"]
    with RecordFileWriter(path) as writer:
        for _ in range(num_records):
            age = float(rng.randint(17, 90))
            hours = float(rng.randint(1, 99))
            edu = education[rng.randint(len(education))]
            work = workclass[rng.randint(len(workclass))]
            label = int((age > 40) ^ (edu in ("Masters", "Doctorate")))
            writer.write(
                tensor_utils.dumps(
                    {
                        "age": age,
                        "hours_per_week": hours,
                        "education": edu,
                        "workclass": work,
                        "label": label,
                    }
                )
            )
    return path


def create_heart_record_file(path, num_records, seed=0):
    """Heart-disease-style mixed rows (reference heart_functional_api
    feature schema: numerics + age + string thal + binary target)."""
    rng = np.random.RandomState(seed)
    thal_values = ["fixed", "normal", "reversible"]
    with RecordFileWriter(path) as writer:
        for _ in range(num_records):
            thal = thal_values[rng.randint(len(thal_values))]
            age = float(rng.randint(29, 77))
            oldpeak = float(rng.rand() * 4)
            label = int((age > 55) ^ (thal == "normal"))
            writer.write(
                tensor_utils.dumps(
                    {
                        "age": age,
                        "trestbps": float(rng.randint(94, 200)),
                        "chol": float(rng.randint(126, 400)),
                        "thalach": float(rng.randint(71, 202)),
                        "oldpeak": oldpeak,
                        "slope": float(rng.randint(1, 4)),
                        "ca": float(rng.randint(0, 4)),
                        "thal": thal,
                        "target": label,
                    }
                )
            )
    return path


def create_iris_csv(path, num_records, seed=0):
    """Iris-style CSV: a header, four features near the class index and
    the class (0, 1 or 2)."""
    rng = np.random.RandomState(seed)
    with open(path, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(
            ["sepal_length", "sepal_width", "petal_length", "petal_width",
             "class"]
        )
        for _ in range(num_records):
            label = int(rng.randint(3))
            row = (rng.rand(4) + label).round(3)
            writer.writerow(list(row) + [label])
    return path


def make_local_args(model_zoo, model_def, training_data,
                    validation_data="", minibatch_size=16, num_epochs=1,
                    extra=None):
    """Parse a Local-strategy ``train`` namespace of the port."""
    from elasticdl_tpu_torch.common.args import build_parser

    argv = [
        "--model_zoo", model_zoo,
        "--model_def", model_def,
        "--training_data", training_data,
        "--minibatch_size", str(minibatch_size),
        "--num_epochs", str(num_epochs),
    ]
    if validation_data:
        argv += ["--validation_data", validation_data]
    if extra:
        argv += list(extra)
    return build_parser("train").parse_args(argv)


def model_zoo_dir():
    """Path of the port's model_zoo directory."""
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.join(here, "model_zoo")
