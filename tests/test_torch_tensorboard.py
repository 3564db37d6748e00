"""The port's TensorBoard writer (``master/tensorboard_service.py``)
against the JAX package's, and the Local executor's summaries.

- With ``time.time`` patched to one value (it stamps the events and
  names the file) both writers give byte-equal event files and equal
  ``scalars.jsonl`` mirrors for the same scalars.
- Every record of the port's file is framed as TFRecord with masked
  crc32c checksums that verify.
- ``TensorboardService`` writes train and eval scalars; ``start()``
  without a ``tensorboard`` binary only warns; ``close()`` ends it.
- ``--tensorboard_log_dir`` in the port's executor: ``train/loss`` at
  step 100 (where the loss is read anyway) and the final eval metrics.
"""

import os
import struct
import time

import numpy as np
import pytest

from elasticdl_tpu.master import tensorboard_service as jax_tb
from elasticdl_tpu_torch.master import tensorboard_service as port_tb
from elasticdl_tpu_torch.testing import data as tdata

SCALARS = [({"train/loss": 0.6931}, 100), ({"train/loss": 0.25}, 200),
           ({"eval/accuracy": 0.75, "eval/auc": 0.8125}, 200),
           ({"big_step": 1.0}, 2 ** 40)]


def _write(module, logdir):
    with module.SummaryWriter(logdir) as writer:
        for scalars, step in SCALARS:
            writer.add_scalars(scalars, step)
    files = sorted(os.listdir(logdir))
    return {name: open(os.path.join(logdir, name), "rb").read()
            for name in files}


def test_event_files_byte_equal_to_jax(tmp_path, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1792252330.125)
    want = _write(jax_tb, str(tmp_path / "jax"))
    got = _write(port_tb, str(tmp_path / "port"))
    assert sorted(got) == sorted(want)
    assert any(n.startswith("events.out.tfevents.1792252330.") for n in got)
    for name in want:
        assert got[name] == want[name], name


def _records(data):
    """The payloads of a TFRecord file, each checksum verified."""
    out, pos = [], 0
    while pos < len(data):
        header = data[pos:pos + 8]
        (length,) = struct.unpack("<Q", header)
        (hcrc,) = struct.unpack("<I", data[pos + 8:pos + 12])
        assert hcrc == port_tb._masked_crc(header)
        payload = data[pos + 12:pos + 12 + length]
        (pcrc,) = struct.unpack("<I", data[pos + 12 + length:
                                           pos + 16 + length])
        assert pcrc == port_tb._masked_crc(payload)
        out.append(payload)
        pos += 16 + length
    return out


def test_records_are_checksummed_tfrecords(tmp_path):
    files = _write(port_tb, str(tmp_path))
    events = [v for k, v in files.items() if k.startswith("events")][0]
    payloads = _records(events)
    assert len(payloads) == 1 + len(SCALARS)
    assert b"brain.Event:2" in payloads[0]
    assert b"eval/auc" in payloads[3]
    # crc32c("123456789") is the standard check value
    assert port_tb._crc32c(b"123456789") == 0xE3069283


def test_service_writes_and_closes(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path / "nowhere"))
    service = port_tb.TensorboardService(str(tmp_path / "tb"))
    service.write_dict_to_summary({"train/loss": 1.5}, 3)
    service.write_eval_metrics(3, {"accuracy": 0.5})
    service.write_eval_metrics(4, {})
    service.start()                  # no binary: a warning, no process
    assert not service.keep_running()
    service.close()
    with pytest.raises(ValueError, match="closed"):
        service._writer.add_scalars({"x": 1.0}, 5)
    lines = open(str(tmp_path / "tb" / "scalars.jsonl")).read().splitlines()
    assert len(lines) == 2 and '"eval/accuracy": 0.5' in lines[1]


def test_local_executor_writes_loss_and_eval_metrics(tmp_path):
    import json

    from elasticdl_tpu_torch.api.local_executor import LocalExecutor

    train = tdata.create_iris_csv(str(tmp_path / "train.csv"), 400, seed=1)
    valid = tdata.create_iris_csv(str(tmp_path / "valid.csv"), 40, seed=2)
    logdir = str(tmp_path / "tb")
    args = tdata.make_local_args(
        tdata.model_zoo_dir(), "iris.iris_dnn.custom_model", train,
        validation_data=valid, minibatch_size=4,
        extra=["--device", "cpu", "--tensorboard_log_dir", logdir])
    result = LocalExecutor(args).run()
    assert result["steps"] == 100
    rows = [json.loads(line) for line in
            open(os.path.join(logdir, "scalars.jsonl"))]
    assert [r["step"] for r in rows] == [100, 100]
    assert np.isclose(rows[0]["train/loss"], result["final_loss"])
    assert rows[1]["eval/accuracy"] == pytest.approx(
        result["eval_metrics"]["accuracy"])
