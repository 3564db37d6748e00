"""Synthetic dataset fixtures of the port (the mnist, cifar, LM and
frappe parts of elasticdl_tpu/testing/data.py): the same seed writes the
same bytes, so both packages train on one record file."""

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
