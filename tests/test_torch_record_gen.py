"""The port's record converters (``elasticdl_tpu_torch/tools/record_gen/``)
against the root tools of the JAX package, and the port's data helpers
for them (``testing.data.create_adult_csv``, ``testing.tiny_zoo``,
``testing.prepare_csv``).

Each case of the root tests (``tests/test_table_reader_and_tools.py``'s
``TestRecordGenTools`` and ``TestPerDatasetConverters``) runs the port's
tool and the root tool on the same inputs with the same seed, and holds
the files they write byte-equal (the port's codec and RecordFile writer
write the JAX package's bytes), then checks what the root test checks on
the port's files. Also: census_gen's records train through the port's
Local executor, and a CLI run of a port converter.
"""

import csv
import filecmp
import os
import subprocess
import sys

import numpy as np
import pytest

from elasticdl_tpu_torch.common import tensor_utils
from elasticdl_tpu_torch.data.record_file import RecordFileScanner
from elasticdl_tpu_torch.tools.record_gen import (
    census_gen,
    csv_to_records,
    frappe_gen,
    heart_gen,
    image_label_gen,
    numpy_to_records,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT_TOOLS = os.path.join(REPO, "tools", "record_gen")


def _root(name):
    """The root tool module ``name`` (tools/record_gen/<name>.py); its
    ``_split``, which the tools import when they run, is loaded too."""
    sys.path.insert(0, ROOT_TOOLS)
    try:
        __import__("_split")
        return __import__(name)
    finally:
        sys.path.remove(ROOT_TOOLS)


def _rows(path, n=10_000):
    with RecordFileScanner(path, 0, n) as scanner:
        return [tensor_utils.loads(p) for p in scanner]


def _same_tree(a, b):
    """Every file under ``a`` and ``b``: the same names, the same bytes."""
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    match, mismatch, errors = filecmp.cmpfiles(a, b, names, shallow=False)
    assert not mismatch and not errors, (mismatch, errors)
    return names


def _adult_csv(tmp_path, n=40):
    from elasticdl_tpu_torch.testing.data import create_adult_csv

    path = create_adult_csv(str(tmp_path / "adult.data"), n, seed=1)
    with open(path, "a", newline="") as f:
        out = csv.writer(f)
        out.writerow(["bad row"])           # malformed: dropped
        out.writerow(["?", "Private", "77516", "Bachelors", "13",
                      "Never-married", "Tech-support", "Own-child",
                      "White", "Female", "0", "0", "40.0",
                      "United-States", "<=50K"])  # missing: dropped
    return path


def test_create_adult_csv_is_the_jax_bytes(tmp_path):
    from elasticdl_tpu.testing.data import create_adult_csv as jax_adult
    from elasticdl_tpu_torch.testing.data import create_adult_csv

    for seed in (0, 1):
        a = create_adult_csv(str(tmp_path / f"p{seed}"), 64, seed=seed)
        b = jax_adult(str(tmp_path / f"j{seed}"), 64, seed=seed)
        assert open(a, "rb").read() == open(b, "rb").read()
    with open(a) as f:
        rows = list(csv.reader(f))
    assert len(rows) == 64 and {len(r) for r in rows} == {15}
    assert {r[-1] for r in rows} <= {">50K", "<=50K"}


@pytest.mark.parametrize("per_file", [0, 7])
def test_csv_to_records_roundtrip(tmp_path, per_file):
    src = tmp_path / "in.csv"
    with open(src, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["a", "label", "name"])
        for i in range(20):
            w.writerow([i * 1.5, i % 2, f"n{i}"])
    (tmp_path / "p").mkdir()
    (tmp_path / "j").mkdir()
    got = csv_to_records.convert(str(src), str(tmp_path / "p" / "out.rec"),
                                 per_file)
    _root("csv_to_records").convert(
        str(src), str(tmp_path / "j" / "out.rec"), per_file)
    names = _same_tree(tmp_path / "p", tmp_path / "j")
    assert len(got) == len(names) == (3 if per_file else 1)
    rows = [r for path in got for r in _rows(path)]
    assert rows[2] == {"a": 3.0, "label": 0, "name": "n2"}


@pytest.mark.parametrize("shards", [0, 30])
def test_numpy_to_records(tmp_path, shards):
    x = np.arange(100 * 4, dtype=np.float32).reshape(100, 4)
    y = np.arange(100) % 10
    (tmp_path / "p").mkdir()
    (tmp_path / "j").mkdir()
    n = numpy_to_records.convert(x, y, str(tmp_path / "p" / "img.rec"),
                                 key="image", records_per_shard=shards,
                                 fraction=0.9)
    _root("numpy_to_records").convert(
        x, y, str(tmp_path / "j" / "img.rec"), key="image",
        records_per_shard=shards, fraction=0.9)
    names = _same_tree(tmp_path / "p", tmp_path / "j")
    assert n == 90
    if shards:
        assert names == ["img.rec-00000", "img.rec-00001", "img.rec-00002"]
    rows = _rows(str(tmp_path / "p" / names[0]))
    np.testing.assert_array_equal(np.asarray(rows[1]["image"]), x[1])
    assert rows[1]["label"] == 1


def test_frappe_gen_feature_map_and_padding(tmp_path):
    train = tmp_path / "frappe.train.libfm"
    val = tmp_path / "frappe.validation.libfm"
    train.write_text("1 u:1 i:7 ctx:3\n-1 u:2 i:7\n1 u:1 i:9 ctx:3 w:5\n")
    val.write_text("-1 u:2 i:9 ctx:4\n")
    splits = {"train": str(train), "validation": str(val)}
    out = frappe_gen.convert(str(tmp_path / "p"), splits)
    want = _root("frappe_gen").convert(str(tmp_path / "j"), splits)
    assert out == want
    _same_tree(tmp_path / "p", tmp_path / "j")
    assert out["frappe_train.rec"] == 3 and out["maxlen"] == 4
    assert out["feature_num"] == 8
    rows = _rows(str(tmp_path / "p" / "frappe_train.rec"))
    np.testing.assert_array_equal(np.asarray(rows[0]["features"]),
                                  [0, 1, 2, 3])   # left-padded
    assert rows[0]["label"] == 1 and rows[1]["label"] == 0
    vrow = _rows(str(tmp_path / "p" / "frappe_validation.rec"))[0]
    np.testing.assert_array_equal(np.asarray(vrow["features"]), [0, 4, 5, 7])


def test_image_label_gen_shards_and_fraction(tmp_path):
    x = np.arange(10 * 4 * 4, dtype=np.float32).reshape(10, 4, 4)
    y = np.arange(10) % 3
    root = _root("image_label_gen")
    for fraction, subdir in ((1.0, "train"), (0.5, "half")):
        shards = image_label_gen.convert(
            x, y, str(tmp_path / "p"), "mnist", subdir,
            records_per_shard=4, fraction=fraction)
        root.convert(x, y, str(tmp_path / "j"), "mnist", subdir,
                     records_per_shard=4, fraction=fraction)
        names = _same_tree(tmp_path / "p" / "mnist" / subdir,
                           tmp_path / "j" / "mnist" / subdir)
        assert len(shards) == len(names) == (3 if fraction == 1 else 2)
    rows = _rows(str(tmp_path / "p" / "mnist" / "train" / "data-00001"))
    np.testing.assert_array_equal(np.asarray(rows[0]["features"]), x[4])
    assert rows[0]["label"] == 4 % 3


def test_distributed_gen_multiprocessing(tmp_path):
    for i in range(3):
        with open(tmp_path / f"in{i}.csv", "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["a", "label"])
            for j in range(5):
                w.writerow([i * 100 + j, j % 2])
    inputs = [str(tmp_path / f"in{i}.csv") for i in range(3)]
    env = {**os.environ, "PYTHONPATH": REPO + os.pathsep
           + os.environ.get("PYTHONPATH", "")}
    for out, cmd, module in (
            ("p", ["-m", "elasticdl_tpu_torch.tools.record_gen"
                   ".distributed_gen"],
             "elasticdl_tpu_torch.testing.prepare_csv"),
            ("j", [os.path.join(ROOT_TOOLS, "distributed_gen.py")],
             "elasticdl_tpu.testing.prepare_csv")):
        result = subprocess.run(
            [sys.executable, *cmd, *inputs, "--output_dir",
             str(tmp_path / out), "--module", module, "--num_workers", "2",
             "--records_per_file", "4"],
            capture_output=True, text=True, env=env, timeout=120)
        assert result.returncode == 0, result.stderr
    shards = _same_tree(tmp_path / "p", tmp_path / "j")
    assert shards == ["data-0-0000", "data-0-0001", "data-0-0002",
                      "data-1-0000", "data-1-0001"]
    rows = [r for s in shards for r in _rows(str(tmp_path / "p" / s))]
    assert {r["a"] for r in rows} == {
        str(i * 100 + j) for i in range(3) for j in range(5)}


def test_prepare_csv_yields_what_jax_yields(tmp_path):
    from elasticdl_tpu.testing.prepare_csv import prepare as jax_prepare
    from elasticdl_tpu_torch.testing.prepare_csv import prepare

    path = tmp_path / "in.csv"
    path.write_text("a,b\n1,x\n2,y\n")
    with open(path, "rb") as f, open(path, "rb") as g:
        got, want = list(prepare(f, str(path))), list(jax_prepare(g, "x"))
    assert got == want == [{"a": "1", "b": "x"}, {"a": "2", "b": "y"}]


def test_census_gen_cleans_splits_and_trains(tmp_path):
    from elasticdl_tpu_torch.api.local_executor import LocalExecutor
    from elasticdl_tpu_torch.data.factory import create_data_reader
    from elasticdl_tpu_torch.testing import data as tdata

    adult = _adult_csv(tmp_path)
    counts = census_gen.convert(adult, str(tmp_path / "o"),
                                val_fraction=0.25, seed=0)
    want = _root("census_gen").convert(adult, str(tmp_path / "j"),
                                       val_fraction=0.25, seed=0)
    assert counts == want == {"census_val.rec": 10, "census_train.rec": 30}
    _same_tree(tmp_path / "o", tmp_path / "j")
    train = str(tmp_path / "o" / "census_train.rec")
    rows = _rows(train)
    assert len(rows) == 30
    row = rows[0]
    assert {"education", "workclass", "age", "hours_per_week",
            "label"} <= set(row)
    assert isinstance(row["age"], float) and row["label"] in (0, 1)
    assert create_data_reader(data_origin=train).create_shards() == {
        train: (0, 30)}
    from elasticdl_tpu_torch.model_zoo.census import census_wide_deep as m

    features, labels = m.dataset_fn(
        [tensor_utils.dumps(r) for r in rows[:8]], "training", None)
    assert features["ids"].shape == (8, 4) and labels.shape == (8,)
    # The converted records train through the port's Local executor.
    args = tdata.make_local_args(
        tdata.model_zoo_dir(), "census.census_wide_deep.custom_model",
        train, validation_data=str(tmp_path / "o" / "census_val.rec"),
        minibatch_size=8, extra=["--device", "cpu"])
    result = LocalExecutor(args).run()
    assert result["steps"] == 4
    assert np.isfinite(result["final_loss"])
    assert 0.0 <= result["eval_metrics"]["accuracy"] <= 1.0


def test_census_gen_cli(tmp_path):
    adult = _adult_csv(tmp_path, n=20)
    env = {**os.environ, "PYTHONPATH": REPO}
    proc = subprocess.run(
        [sys.executable, "-m", "elasticdl_tpu_torch.tools.record_gen"
         ".census_gen", adult, str(tmp_path / "o"), "--val_fraction",
         "0.5", "--seed", "3"], capture_output=True, text=True, env=env,
        timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "wrote 10 records to" in proc.stdout
    _root("census_gen").convert(adult, str(tmp_path / "j"), 0.5, 3)
    _same_tree(tmp_path / "o", tmp_path / "j")


def test_heart_gen_coerces_and_splits(tmp_path):
    path = str(tmp_path / "heart.csv")
    with open(path, "w", newline="") as f:
        out = csv.writer(f)
        out.writerow(["age", "trestbps", "chol", "thalach", "oldpeak",
                      "slope", "ca", "thal", "target"])
        rng = np.random.RandomState(2)
        for i in range(20):
            out.writerow([int(30 + rng.randint(40)), 120, 200, 150, "1.5",
                          2, 0, ["fixed", "normal", "reversible"][i % 3],
                          i % 2])
    counts = heart_gen.convert(path, str(tmp_path / "o"), val_fraction=0.2,
                               seed=0)
    want = _root("heart_gen").convert(path, str(tmp_path / "j"),
                                      val_fraction=0.2, seed=0)
    assert counts == want
    assert counts["heart_train.rec"] == 16 and counts["heart_val.rec"] == 4
    _same_tree(tmp_path / "o", tmp_path / "j")
    row = _rows(str(tmp_path / "o" / "heart_train.rec"))[0]
    assert isinstance(row["oldpeak"], float)
    assert isinstance(row["thal"], str)
    assert row["label"] in (0, 1)


def test_tiny_recsys_zoo_shrinks_and_restores_the_twin():
    import elasticdl_tpu_torch.core.model_spec as ms
    from elasticdl_tpu_torch.model_zoo.recsys import recsys_sparse as zoo
    from elasticdl_tpu_torch.testing.tiny_zoo import tiny_recsys_zoo

    before = (zoo.VOCAB, zoo.DIM, zoo.TABLE_SPECS, ms.load_module)
    with tiny_recsys_zoo(vocab=64, dim=8) as tiny:
        assert tiny is zoo and (zoo.VOCAB, zoo.DIM) == (64, 8)
        (spec,) = zoo.TABLE_SPECS
        assert (spec.vocab, spec.dim, spec.name) == (64, 8, zoo.TABLE_NAME)
        module, func = ms.load_model_zoo_module(
            os.path.join(REPO, "elasticdl_tpu_torch", "model_zoo"),
            "recsys.recsys_sparse.custom_model")
        assert module is zoo and func == "custom_model"
        model = zoo.custom_model(device="cpu")
        assert model.layers[0].weight.shape[1] == 8
        with pytest.raises(RuntimeError):
            with tiny_recsys_zoo(vocab=32, dim=4):
                raise RuntimeError("inside")
        assert (zoo.VOCAB, zoo.DIM) == (64, 8)
    assert (zoo.VOCAB, zoo.DIM, zoo.TABLE_SPECS, ms.load_module) == before
