"""The master's write-ahead journal in the port
(``elasticdl_tpu_torch/master/journal.py``,
``elasticdl_tpu_torch/tools/check_journal.py``) on the CPU.

The JAX package's ``tests/test_journal.py`` cases run against the port:
framing and seq, a torn tail truncated, mid-file corruption caught by
the fsck, snapshot compaction, replay into an equivalent dispatcher
(with and without a snapshot), fenced and deduplicated reports after
recovery, loud replay divergence, and the model version and retry counts
through compaction.

Then the two packages are held to each other: the same scripted
dispatcher, servicer and eval events through a JAX and a port control
plane write byte-equal ``journal.log`` files, with and without
compaction and with bf16 eval outputs. The one field that may differ is
named: a metric that computes in its outputs' dtype reads a bf16 output
as bf16 in JAX and as the f32 it widens to in the port (the port's eval
fold, ``master/evaluation_service.py``), so the ``results`` of an
``eval_round`` close (and of the snapshot's eval state) differ there and
nowhere else. Each package's journal, a JAX-written one with
``relaunch``, ``sched`` and ``stream`` records among them, recovers in
the other into field-equal dispatcher state, eval state and replay
stats.
"""

import os

import ml_dtypes
import numpy as np
import pytest

from elasticdl_tpu.master import evaluation_service as jes
from elasticdl_tpu.master import journal as jj
from elasticdl_tpu.master import servicer as jsv
from elasticdl_tpu.master import task_dispatcher as jtd
from elasticdl_tpu_torch.common import dtypes
from elasticdl_tpu_torch.common.constants import TaskType
from elasticdl_tpu_torch.master import evaluation_service as pes
from elasticdl_tpu_torch.master import journal as pj
from elasticdl_tpu_torch.master import servicer as psv
from elasticdl_tpu_torch.master import task_dispatcher as ptd
from elasticdl_tpu_torch.master.journal import (
    JournalFormatError,
    MasterJournal,
    read_records,
    recover_master_state,
)
from elasticdl_tpu_torch.master.servicer import MasterServicer
from elasticdl_tpu_torch.master.task_dispatcher import TaskDispatcher
from elasticdl_tpu_torch.tools.check_journal import check_journal

JAX = dict(journal=jj, dispatcher=jtd, eval=jes, servicer=jsv)
PORT = dict(journal=pj, dispatcher=ptd, eval=pes, servicer=psv)


def make_dispatcher(records=100, per_task=10, epochs=1, shuffle=False,
                    **kw):
    return TaskDispatcher(
        training_shards={"f1": (0, records)},
        records_per_task=per_task,
        num_epochs=epochs,
        shuffle=shuffle,
        seed=3,
        **kw,
    )


def journaled_pair(tmp_path, snapshot_every=1000, **disp_kw):
    """(dispatcher with journal attached, journal)."""
    journal = MasterJournal(
        str(tmp_path / "journal"), snapshot_every=snapshot_every
    )
    dispatcher = make_dispatcher(**disp_kw)
    journal.open_generation()
    dispatcher.attach_journal(journal)
    return dispatcher, journal


def normalized(state: dict) -> dict:
    return {k: v for k, v in state.items() if k != "worker_version"}


def recover(tmp_path, **disp_kw):
    """Fresh journal handle + fresh dispatcher, replayed (the crash
    path: nothing from the old process survives but the file)."""
    journal = MasterJournal(str(tmp_path / "journal"))
    dispatcher = make_dispatcher(**disp_kw)
    servicer = MasterServicer(dispatcher, journal=journal)
    stats = recover_master_state(journal, dispatcher, servicer=servicer)
    return dispatcher, servicer, journal, stats


# ---- tests/test_journal.py on the port ----------------------------------


def test_port_journal_records_roundtrip_and_seq(tmp_path):
    journal = MasterJournal(str(tmp_path / "j"))
    journal.open_generation()
    journal.append("version", model_version=3)
    journal.append("version", model_version=7)
    journal.close()
    records = [r for _o, _e, r in read_records(journal.path)]
    assert [r["t"] for r in records] == [
        "generation", "version", "version",
    ]
    assert [r["seq"] for r in records] == [1, 2, 3]
    assert check_journal(journal.path) == []


def test_port_journal_torn_tail_is_truncated_not_fatal(tmp_path):
    journal = MasterJournal(str(tmp_path / "j"))
    journal.open_generation()
    journal.append("version", model_version=1)
    journal.close()
    good = open(journal.path, "rb").read()
    # Crash mid-write: a partial frame lands after the good bytes.
    with open(journal.path, "ab") as fh:
        fh.write(b"\x07\x00\x00\x00GARBAGE-NO-CRC"[:9])
    again = MasterJournal(str(tmp_path / "j"))
    assert again.open_generation() == 1  # fenced past gen 0
    again.close()
    blob = open(journal.path, "rb").read()
    assert blob.startswith(good)  # intact prefix preserved


def test_port_journal_mid_file_corruption_detected_by_fsck(tmp_path):
    journal = MasterJournal(str(tmp_path / "j"))
    journal.open_generation()
    for v in range(4):
        journal.append("version", model_version=v)
    journal.close()
    # A byte flipped INSIDE the first record's payload: framing cannot
    # resync, so the rest reads as a torn tail the fsck must flag.
    with open(journal.path, "r+b") as fh:
        fh.seek(12)
        byte = fh.read(1)
        fh.seek(12)
        fh.write(bytes([byte[0] ^ 0xFF]))
    errors = check_journal(journal.path)
    assert errors and any("torn" in e or "trailing" in e for e in errors)


def test_port_journal_snapshot_compacts_file(tmp_path):
    dispatcher, journal = journaled_pair(
        tmp_path, snapshot_every=4, records=100, per_task=10
    )
    for _ in range(4):
        task = dispatcher.get(0)
        dispatcher.report(task.task_id, True)
    types = [r["t"] for _o, _e, r in read_records(journal.path)]
    assert types[0] == "generation"
    assert "snapshot" in types
    assert len([t for t in types if t in ("dispatch", "report")]) < 8
    assert check_journal(journal.path) == []
    journal.close()


def _drive(dispatcher, n_complete=3, n_fail=1):
    for _ in range(n_complete):
        task = dispatcher.get(0)
        dispatcher.report(task.task_id, True)
    for _ in range(n_fail):
        task = dispatcher.get(1)
        dispatcher.report(task.task_id, False, err_reason="boom")
    # Two leases left in flight (the crash-survivor scenario).
    dispatcher.get(0)
    dispatcher.get(1)


@pytest.mark.parametrize("snapshot_every", [1000, 3])
def test_port_replay_recovers_equivalent_state(tmp_path, snapshot_every):
    dispatcher, journal = journaled_pair(
        tmp_path, snapshot_every=snapshot_every,
        records=100, per_task=10, epochs=2, shuffle=True,
    )
    _drive(dispatcher)
    dead = dispatcher.export_state()
    journal.close()
    recovered, _servicer, journal2, stats = recover(
        tmp_path, records=100, per_task=10, epochs=2, shuffle=True
    )
    assert normalized(recovered.export_state()) == normalized(dead)
    assert stats["generation"] == 1
    assert stats["snapshot"] == (snapshot_every == 3)
    assert sorted(stats["known_workers"]) == [0, 1]
    journal2.close()


def test_port_torn_tail_recovers_to_last_intact_record(tmp_path):
    dispatcher, journal = journaled_pair(tmp_path, records=40, per_task=10)
    t1 = dispatcher.get(0)
    dispatcher.report(t1.task_id, True)
    checkpointed = dispatcher.export_state()
    dispatcher.get(0)  # the dispatch whose record we tear
    journal.close()
    size = os.path.getsize(journal.path)
    with open(journal.path, "r+b") as fh:
        fh.truncate(size - 5)
    recovered, _sv, journal2, _stats = recover(
        tmp_path, records=40, per_task=10
    )
    assert normalized(recovered.export_state()) == normalized(checkpointed)
    journal2.close()


def test_port_recovered_master_fences_and_dedups_reports(tmp_path):
    dispatcher, journal = journaled_pair(tmp_path, records=40, per_task=10)
    servicer = MasterServicer(dispatcher, journal=journal)
    done = servicer.get_task({"worker_id": 0})["task"]["task_id"]
    assert servicer.report_task_result(
        {"task_id": done, "worker_id": 0}
    )["accepted"]
    leased = servicer.get_task({"worker_id": 0})["task"]["task_id"]
    journal.close()
    recovered, servicer2, journal2, _stats = recover(
        tmp_path, records=40, per_task=10
    )
    assert servicer2.generation == 1
    # A duplicate of a pre-crash-applied report: the original outcome.
    dup = servicer2.report_task_result(
        {"task_id": done, "worker_id": 0, "generation": 0}
    )
    assert dup["accepted"] and dup["generation"] == 1
    # The surviving lease re-reports and applies exactly once.
    late = servicer2.report_task_result(
        {"task_id": leased, "worker_id": 0, "generation": 0}
    )
    assert late["accepted"]
    assert recovered.counters.total_records[TaskType.TRAINING] == 20
    # A task id no incarnation ever dispatched: fenced.
    bogus = servicer2.report_task_result(
        {"task_id": 999, "worker_id": 0, "generation": 0}
    )
    assert not bogus["accepted"] and bogus["fenced"]
    journal2.close()


def test_port_replay_divergence_fails_loudly(tmp_path):
    dispatcher, journal = journaled_pair(tmp_path, records=40, per_task=10)
    dispatcher.get(0)
    journal.close()
    journal2 = MasterJournal(str(tmp_path / "journal"))
    wrong = make_dispatcher(records=40, per_task=20)
    with pytest.raises(JournalFormatError, match="diverged"):
        recover_master_state(journal2, wrong)
    journal2.close()


def test_port_model_version_survives_compaction(tmp_path):
    dispatcher, journal = journaled_pair(
        tmp_path, snapshot_every=2, records=40, per_task=10
    )
    journal.append("version", model_version=5)
    for _ in range(2):  # crosses the cadence -> snapshot + compaction
        t = dispatcher.get(0)
        dispatcher.report(t.task_id, True)
    types = [r["t"] for _o, _e, r in read_records(journal.path)]
    assert "version" not in types  # compacted away
    journal.close()
    _recovered, servicer, journal2, stats = recover(
        tmp_path, records=40, per_task=10
    )
    assert stats["model_version"] == 5
    assert servicer.model_version == 5
    journal2.close()


def test_port_retry_counts_survive_recovery(tmp_path):
    dispatcher, journal = journaled_pair(tmp_path, records=20, per_task=10)
    task = dispatcher.get(0)
    dispatcher.report(task.task_id, False, err_reason="x")
    journal.close()
    recovered, _sv, journal2, _stats = recover(
        tmp_path, records=20, per_task=10
    )
    key = f"{task.shard_name}:{task.start}:{task.end}"
    assert recovered._task_retry_count[key] == 1
    journal2.close()


# ---- the two packages' journals held to each other ----------------------


def mean_f64(labels, outputs):
    return float(np.mean(np.asarray(outputs, np.float64)))


def mean_native(labels, outputs):
    """A metric that computes in its outputs' own dtype."""
    return float(np.mean(np.asarray(outputs)))


def bf16_outputs(pkg, values):
    """A bf16 output as each package's master receives it: ml_dtypes'
    bfloat16 in JAX, its bits as ``BFLOAT16_BITS`` in the port."""
    arr = np.asarray(values, np.float32).astype(ml_dtypes.bfloat16)
    if pkg is PORT:
        return arr.view(np.uint16).view(dtypes.BFLOAT16_BITS)
    return arr


def plane(pkg, journal_dir, snapshot_every=1000, metric=mean_f64,
          recover=False, fence=False):
    """A journaled control plane of ``pkg``: (dispatcher, eval service,
    servicer, journal, replay stats or None)."""
    journal = pkg["journal"].MasterJournal(
        journal_dir, snapshot_every=snapshot_every)
    dispatcher = pkg["dispatcher"].TaskDispatcher(
        training_shards={"t": (0, 40)}, evaluation_shards={"v": (0, 8)},
        records_per_task=4, num_epochs=2, shuffle=True, seed=3)
    eval_service = pkg["eval"].EvaluationService(
        dispatcher, {"m": metric}, eval_steps=8)
    stats = None
    if recover:
        servicer = pkg["servicer"].MasterServicer(
            dispatcher, eval_service, journal=journal)
        stats = pkg["journal"].recover_master_state(
            journal, dispatcher, servicer=servicer,
            eval_service=eval_service, fence=fence)
    else:
        journal.open_generation()
        dispatcher.attach_journal(journal)
        eval_service.attach_journal(journal)
        servicer = pkg["servicer"].MasterServicer(
            dispatcher, eval_service, journal=journal,
            generation=journal.generation)
    return dispatcher, eval_service, servicer, journal, stats


def script(pkg, servicer, steps=10, bf16=True, last_lease=True):
    """The scripted events: trained tasks with versions, one failure, an
    eval round opened by a version, folded and closed, more leases."""
    for i in range(3):
        task = servicer.get_task({"worker_id": 0})["task"]
        servicer.report_version(
            {"worker_id": 0, "model_version": 4 * (i + 1)})
        servicer.report_task_result({
            "task_id": task["task_id"], "worker_id": 0,
            "err_reason": "boom" if i == 1 else ""})
    for _ in range(steps):
        task = servicer.get_task({"worker_id": 1})["task"]
        if task is None:
            break
        if task["type"] == TaskType.EVALUATION:
            ids = np.arange(task["start"], task["end"])
            values = ids * 0.3 + 0.01
            outputs = (bf16_outputs(pkg, values) if bf16
                       else values.astype(np.float32))
            servicer.report_evaluation_metrics({
                "worker_id": 1, "task_id": task["task_id"],
                "model_outputs": outputs,
                "labels": ids.astype(np.int32)})
        servicer.report_task_result(
            {"task_id": task["task_id"], "worker_id": 1})
    if last_lease:
        servicer.get_task({"worker_id": 0})
    servicer.report_version({"worker_id": 1, "model_version": 40})


def write_both(tmp_path, name, **kw):
    """The script through a JAX and a port plane: both journals' bytes
    and dispatcher exports."""
    out = {}
    for tag, pkg in (("jax", JAX), ("port", PORT)):
        d = str(tmp_path / name / tag)
        metric = kw.get("metric", mean_f64)
        dispatcher, _es, servicer, journal, _ = plane(
            pkg, d, snapshot_every=kw.get("snapshot_every", 1000),
            metric=metric)
        script(pkg, servicer, bf16=kw.get("bf16", True))
        journal.append("shard_map", version=2,
                       map={"version": 2, "shards": ["a:1", "b:2"]})
        journal.close()
        with open(os.path.join(d, "journal.log"), "rb") as fh:
            out[tag] = (fh.read(), dispatcher.export_state(), d)
    return out


@pytest.mark.parametrize("snapshot_every,bf16", [
    (1000, True), (1000, False), (5, True)],
    ids=["no_compaction_bf16", "no_compaction_f32", "compaction_bf16"])
def test_both_packages_write_byte_equal_journals(tmp_path, snapshot_every,
                                                 bf16):
    out = write_both(tmp_path, "j", snapshot_every=snapshot_every,
                     bf16=bf16)
    jax_bytes, jax_state, jax_dir = out["jax"]
    port_bytes, port_state, port_dir = out["port"]
    kinds = [r["t"] for _o, _e, r in read_records(
        os.path.join(port_dir, "journal.log"))]
    if snapshot_every == 1000:
        for kind in ("dispatch", "report", "version", "eval_round",
                     "eval_fold", "create_tasks", "shard_map"):
            assert kind in kinds
    else:
        assert "snapshot" in kinds
    # No field is excluded: leases carry no clock (a recovered lease is
    # re-stamped at replay) and the snapshot no start times.
    assert port_bytes == jax_bytes
    assert port_state == jax_state
    assert check_journal(port_dir) == [] and check_journal(jax_dir) == []


def test_bf16_results_are_the_one_named_difference(tmp_path):
    """A metric in the outputs' own dtype: the bf16 mean in JAX, the f32
    mean in the port. The eval_round close's ``results`` is the one
    field that differs (and, after compaction, the snapshot's
    ``eval.results``); every other byte of both files is equal."""
    for snapshot_every in (1000, 5):
        out = write_both(tmp_path, f"s{snapshot_every}",
                         snapshot_every=snapshot_every, metric=mean_native)
        jrec = [r for _o, _e, r in read_records(
            os.path.join(out["jax"][2], "journal.log"))]
        prec = [r for _o, _e, r in read_records(
            os.path.join(out["port"][2], "journal.log"))]
        assert out["jax"][0] != out["port"][0]
        assert len(jrec) == len(prec)
        differing = []
        for a, b in zip(jrec, prec):
            if a["t"] == "eval_round" and a["event"] == "close":
                differing.append(("eval_round", "results"))
                assert a["results"] != b["results"]
                a, b = dict(a), dict(b)
                a.pop("results"), b.pop("results")
            elif a["t"] == "snapshot" and a["eval"]["results"]:
                differing.append(("snapshot", "eval.results"))
                a, b = dict(a), dict(b)
                a["eval"], b["eval"] = dict(a["eval"]), dict(b["eval"])
                a["eval"].pop("results"), b["eval"].pop("results")
            assert pj.tensor_utils.dumps(a) == pj.tensor_utils.dumps(b)
        assert differing and set(differing) <= {
            ("eval_round", "results"), ("snapshot", "eval.results")}


def eval_state(eval_service):
    job = eval_service._eval_job
    open_round = None
    if job is not None:
        open_round = {
            "model_version": int(job.model_version),
            "total": int(job._total_tasks),
            "completed": int(job._completed_tasks),
            "folded": sorted(int(t) for t in job._folded_tasks),
            "result": job.evaluation_metrics.result(),
        }
    return {"open": open_round,
            "last": int(eval_service._last_eval_version),
            "results": dict(eval_service.completed_results)}


def comparable_stats(pkg, stats):
    """Replay stats with the eval carry (raw outputs) as its bytes in the
    package's own codec, which the two packages share."""
    out = {k: v for k, v in stats.items() if k != "recovery_seconds"}
    out["known_workers"] = sorted(out["known_workers"])
    out["eval"] = pkg["journal"].tensor_utils.dumps(out["eval"])
    return out


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("snapshot_every", [1000, 5])
def test_each_package_recovers_the_others_journal(tmp_path, writer,
                                                  snapshot_every):
    """A journal left with an open eval round (one fold in) and a live
    lease, written by one package, recovers in both into field-equal
    dispatcher state, eval state and replay stats."""
    writer_pkg = JAX if writer == "jax" else PORT
    src = str(tmp_path / "src")
    _d, _es, servicer, journal, _ = plane(
        writer_pkg, src, snapshot_every=snapshot_every)
    script(writer_pkg, servicer, steps=6)
    journal.close()
    # A second writer incarnation, so recovery crosses a generation.
    _d, _es, servicer, journal, _ = plane(
        writer_pkg, src, snapshot_every=snapshot_every, recover=True)
    # Worker 2 folds one task of the round the last version opened and
    # holds it: the round is open with a fold in, the task leased.
    while True:
        task = servicer.get_task({"worker_id": 2})["task"]
        if task["type"] == TaskType.EVALUATION:
            break
        servicer.report_task_result(
            {"task_id": task["task_id"], "worker_id": 2})
    ids = np.arange(task["start"], task["end"])
    servicer.report_evaluation_metrics({
        "worker_id": 2, "task_id": task["task_id"],
        "model_outputs": bf16_outputs(writer_pkg, ids * 0.7),
        "labels": ids.astype(np.int32)})
    journal.append("relaunch", kind="gang", generation=2, shard=-1)
    journal.close()
    states = {}
    for tag, pkg in (("jax", JAX), ("port", PORT)):
        d = str(tmp_path / tag)
        os.makedirs(d)
        with open(os.path.join(src, "journal.log"), "rb") as fh:
            blob = fh.read()
        with open(os.path.join(d, "journal.log"), "wb") as fh:
            fh.write(blob)
        dispatcher, eval_service, servicer, journal, stats = plane(
            pkg, d, recover=True)
        states[tag] = (dispatcher.export_state(), eval_state(eval_service),
                       comparable_stats(pkg, stats), servicer.model_version,
                       sorted(dispatcher.doing_start_times()))
        journal.close()
    assert states["port"] == states["jax"]
    _state, evals, stats, version, doing = states["port"]
    assert stats["generation"] == 2 and version == 40
    assert stats["relaunch"] == {"gang": 2, "row_service": {}}
    assert task["task_id"] in doing
    assert evals["open"] is not None and evals["open"]["folded"]


def test_jax_sched_and_stream_records_recover_in_the_port(tmp_path):
    """``sched``, ``relaunch`` and ``stream`` records have no producer in
    the port yet; a JAX-written journal holding them (a streaming
    dispatcher's partitions and ranges, a job table with a preemption,
    a row-service pod relaunch), with and without compaction, recovers
    in the port into the JAX recovery's state."""
    for snapshot_every in (1000, 3):
        d = str(tmp_path / f"s{snapshot_every}")
        journal = jj.MasterJournal(d, snapshot_every=snapshot_every)
        dispatcher = jtd.TaskDispatcher(
            training_shards={}, records_per_task=4, streaming=True)
        journal.open_generation()
        dispatcher.attach_journal(journal)
        dispatcher.register_stream_partition("clicks")
        dispatcher.create_stream_tasks("clicks", 0, 12)
        for event, extra in (
                ("submit", {"spec": {"shards": {"d": [0, 8]}},
                            "priority": 3, "gang_size": 2}),
                ("schedule", {}), ("run", {}), ("preempt", {}),
                ("resume", {}), ("run", {})):
            journal.append("sched", event=event, job="urgent", **extra)
        journal.append("relaunch", kind="row_service", generation=3,
                       shard=1)
        task = dispatcher.get(0)
        dispatcher.report(task.task_id, True)
        dispatcher.get(1)
        dispatcher.create_stream_tasks("clicks", 12, 20)
        journal.close()
        recovered = {}
        for tag, pkg in (("jax", JAX), ("port", PORT)):
            j = pkg["journal"].MasterJournal(d)
            disp = pkg["dispatcher"].TaskDispatcher(
                training_shards={}, records_per_task=4, streaming=True)
            # Replay only: no generation opened on the shared file.
            carry = pkg["journal"].apply_replay(disp, j.replay_records())
            recovered[tag] = (disp.export_state(),
                              comparable_stats(pkg, dict(carry)))
        assert recovered["port"] == recovered["jax"]
        stats = recovered["port"][1]
        assert stats["sched"]["jobs"]["urgent"]["preemptions"] == 1
        assert stats["sched"]["jobs"]["urgent"]["state"] == "running"
        assert stats["relaunch"] == {"gang": 0, "row_service": {1: 3}}
        assert stats["stream"]["partitions"]["clicks"]["next"] == 20
        assert stats["stream"]["partitions"]["clicks"]["committed"] == 4
