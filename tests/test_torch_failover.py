"""The hot-standby master in the port (``master/standby.py``,
``master/main.py``'s ``--standby``, ``chaos/failover_drill.py``) and the
journal's eval-round event sourcing and fencing, on the CPU.

The JAX package's ``tests/test_failover.py`` cases run against the port:
an open eval round through recovery, compaction and two incarnations, a
duplicate fold journaled once, closed rounds' results; a zombie primary
fenced in its journal and its RPCs, a fenced compaction, a reopen above
the fence, an unreadable fence failing closed, a monotone fence file;
the standby's takeover over real gRPC and the warm handover into
``Master``; ``--standby`` without ``--journal_dir``; the fsck's record
kinds, fence order and zombie appends; the composed master and row-shard
kill.

Across the packages: a JAX standby takes over from a port primary and a
port standby from a JAX primary on one journal directory (one ``fence``
file, one ``journal.lock``), and a fenced zombie of either package lands
no record after the other's fence. The CLI runs as processes: a
``master.main --journal_dir`` primary and a ``--standby`` beside it, the
primary SIGKILLed, then the promoted standby SIGKILLed and a cold
relaunch. Last, the port's failover drill runs in standby mode with real
master processes.
"""

import os
import socket
import time
from types import SimpleNamespace

import numpy as np
import pytest

from elasticdl_tpu.comm import rpc as jrpc
from elasticdl_tpu.master import journal as jj
from elasticdl_tpu.master import servicer as jsv
from elasticdl_tpu.master import standby as jstandby
from elasticdl_tpu.master import task_dispatcher as jtd
from elasticdl_tpu_torch.comm import rpc as prpc
from elasticdl_tpu_torch.common.constants import TaskType
from elasticdl_tpu_torch.master import journal as pj
from elasticdl_tpu_torch.master import servicer as psv
from elasticdl_tpu_torch.master import standby as pstandby
from elasticdl_tpu_torch.master import task_dispatcher as ptd
from elasticdl_tpu_torch.master.evaluation_service import EvaluationService
from elasticdl_tpu_torch.master.journal import (
    JournalFencedError,
    MasterJournal,
    read_records,
    recover_master_state,
)
from elasticdl_tpu_torch.master.servicer import SERVICE_NAME, MasterServicer
from elasticdl_tpu_torch.tools.check_journal import check_journal

METRICS = {
    "mean_out": lambda labels, outputs: float(
        np.mean(np.asarray(outputs, np.float64))
    )
}
JAX = dict(journal=jj, dispatcher=jtd, servicer=jsv, standby=jstandby,
           rpc=jrpc)
PORT = dict(journal=pj, dispatcher=ptd, servicer=psv, standby=pstandby,
            rpc=prpc)


def make_dispatcher(records=40, eval_records=8, per_task=4, pkg=None):
    module = (pkg or PORT)["dispatcher"]
    return module.TaskDispatcher(
        training_shards={"train": (0, records)},
        evaluation_shards=(
            {"val": (0, eval_records)} if eval_records else {}
        ),
        records_per_task=per_task,
        num_epochs=1,
        shuffle=False,
        seed=3,
    )


def journaled_plane(tmp_path, snapshot_every=1000, **disp_kw):
    journal = MasterJournal(
        str(tmp_path / "journal"), snapshot_every=snapshot_every
    )
    dispatcher = make_dispatcher(**disp_kw)
    journal.open_generation()
    dispatcher.attach_journal(journal)
    eval_service = EvaluationService(dispatcher, METRICS, eval_steps=8)
    eval_service.attach_journal(journal)
    return dispatcher, eval_service, journal


def recover_plane(tmp_path, **disp_kw):
    journal = MasterJournal(str(tmp_path / "journal"))
    dispatcher = make_dispatcher(**disp_kw)
    eval_service = EvaluationService(dispatcher, METRICS, eval_steps=8)
    servicer = MasterServicer(dispatcher, eval_service, journal=journal)
    stats = recover_master_state(
        journal, dispatcher, servicer=servicer, eval_service=eval_service,
    )
    return dispatcher, eval_service, servicer, journal, stats


def fold(eval_service, task, scale=0.5):
    ids = np.arange(task.start, task.end, dtype=np.float64)
    eval_service.report_evaluation_metrics(
        ids * scale, ids, task_id=task.task_id
    )


def drain_eval_round(dispatcher, eval_service, model_version):
    """Pull + fold + complete every queued EVALUATION task; the final
    metrics dict (None until the round closes)."""
    results = None
    while True:
        task = dispatcher.get(0)
        if task is None or task.type != TaskType.EVALUATION:
            if task is not None:
                dispatcher.report(task.task_id, True)
                continue
            break
        fold(eval_service, task)
        dispatcher.report(task.task_id, True)
        results = eval_service.complete_task(model_version)
        if results is not None:
            break
    return results


# ---- eval-round event sourcing ------------------------------------------


def test_port_open_eval_round_survives_recovery(tmp_path):
    dispatcher, eval_service, journal = journaled_plane(tmp_path)
    assert eval_service.try_to_create_new_job(8)
    # Fold + complete ONE of the two eval tasks, then "crash".
    task = dispatcher.get(0)
    assert task.type == TaskType.EVALUATION
    fold(eval_service, task)
    dispatcher.report(task.task_id, True)
    assert eval_service.complete_task(8) is None  # round still open
    journal.close()

    d2, es2, _servicer, _j2, _stats = recover_plane(tmp_path)
    job = es2._eval_job
    assert job is not None, "open round dropped by recovery"
    assert job.model_version == 8
    assert job._completed_tasks == 1
    assert job._folded_tasks == {task.task_id}
    assert es2._last_eval_version == 8
    # The second eval task replayed back into todo; a re-attached
    # worker pulls it and closes the round with full data.
    task2 = d2.get(0)
    assert task2.type == TaskType.EVALUATION
    fold(es2, task2)
    d2.report(task2.task_id, True)
    results = es2.complete_task(8)
    assert results is not None
    # Twin: the same round with no crash gives identical metrics.
    td = make_dispatcher()
    te = EvaluationService(td, METRICS, eval_steps=8)
    assert te.try_to_create_new_job(8)
    assert drain_eval_round(td, te, 8) == results


def test_port_duplicate_fold_not_rejournaled(tmp_path):
    dispatcher, eval_service, journal = journaled_plane(tmp_path)
    assert eval_service.try_to_create_new_job(8)
    task = dispatcher.get(0)
    fold(eval_service, task, 1.0)
    # At-least-once re-send: folded once, journaled once.
    fold(eval_service, task, 1.0)
    folds = [r for r in journal.replay_records() if r["t"] == "eval_fold"]
    assert len(folds) == 1


def test_port_eval_round_survives_snapshot_compaction(tmp_path):
    # snapshot_every=1: every dispatch/report compacts the file, so the
    # raw eval records are discarded — the open round rides the
    # snapshot record itself.
    dispatcher, eval_service, journal = journaled_plane(
        tmp_path, snapshot_every=1
    )
    assert eval_service.try_to_create_new_job(8)
    task = dispatcher.get(0)
    fold(eval_service, task)
    dispatcher.report(task.task_id, True)  # triggers compaction
    eval_service.complete_task(8)
    kinds = {r["t"] for r in journal.replay_records()}
    assert "eval_fold" not in kinds, "compaction kept raw eval records"
    journal.close()
    _d2, es2, _s, _j, _stats = recover_plane(tmp_path)
    job = es2._eval_job
    assert job is not None and job._completed_tasks == 1
    assert job._folded_tasks == {task.task_id}


def test_port_round_progress_survives_two_incarnations(tmp_path):
    """Completed counts ride REPORT records; the open_generation scan
    must fold them into the journal-side mirror too, or the SECOND
    incarnation's snapshots regress the count."""
    dispatcher, eval_service, journal = journaled_plane(tmp_path)
    assert eval_service.try_to_create_new_job(8)
    task = dispatcher.get(0)
    fold(eval_service, task)
    dispatcher.report(task.task_id, True)
    eval_service.complete_task(8)  # 1 of 2 complete
    journal.close()

    j2 = MasterJournal(str(tmp_path / "journal"), snapshot_every=1)
    d2 = make_dispatcher()
    es2 = EvaluationService(d2, METRICS, eval_steps=8)
    recover_master_state(j2, d2, eval_service=es2)
    task2 = d2.get(0)
    d2.report(task2.task_id, False, err_reason="requeue me")
    assert not any(
        r["t"] == "report" and r["task_id"] == task.task_id
        for r in j2.replay_records()
    ), "compaction kept the raw report record"
    j2.close()

    _d3, es3, _s3, _j3, _stats = recover_plane(tmp_path)
    job = es3._eval_job
    assert job is not None
    assert job._completed_tasks == 1
    assert job._folded_tasks == {task.task_id}


def test_port_closed_round_results_survive(tmp_path):
    dispatcher, eval_service, journal = journaled_plane(tmp_path)
    assert eval_service.try_to_create_new_job(8)
    results = drain_eval_round(dispatcher, eval_service, 8)
    assert results is not None
    journal.close()
    _d2, es2, _s, _j, _stats = recover_plane(tmp_path)
    assert es2._eval_job is None
    assert es2.completed_results[8] == results
    assert es2._last_eval_version == 8


def test_port_relaunch_generations_survive_compaction(tmp_path):
    journal = MasterJournal(str(tmp_path / "journal"), snapshot_every=1)
    dispatcher = make_dispatcher()
    journal.open_generation()
    dispatcher.attach_journal(journal)
    journal.append("relaunch", kind="gang", generation=3, shard=-1)
    journal.append("relaunch", kind="row_service", generation=2, shard=0)
    task = dispatcher.get(0)
    dispatcher.report(task.task_id, True)  # compaction
    assert "relaunch" not in {r["t"] for r in journal.replay_records()}
    journal.close()
    stats = MasterJournal(str(tmp_path / "journal")).recover_into(
        make_dispatcher())
    assert stats["relaunch"] == {"gang": 3, "row_service": {0: 2}}


# ---- dual-master fencing -------------------------------------------------


def fenced_total(servicer):
    return sum(
        series["value"]
        for family in servicer.metrics_plane.registry.snapshot()["families"]
        if "master_fenced_requests_total" in family["name"]
        for series in family["series"]
    )


@pytest.mark.parametrize("zombie_pkg,live_pkg", [
    ("port", "port"), ("jax", "port"), ("port", "jax")])
def test_zombie_primary_fenced_everywhere(tmp_path, zombie_pkg, live_pkg):
    """A zombie primary of either package, fenced by a takeover of
    either package on the same directory: its appends are rejected, its
    RPCs answer stale_master, the live master resolves the same reports,
    and no record of the zombie's generation lands after the fence."""
    zp = PORT if zombie_pkg == "port" else JAX
    lp = PORT if live_pkg == "port" else JAX
    journal_dir = str(tmp_path / "journal")
    zombie_journal = zp["journal"].MasterJournal(journal_dir)
    zombie_journal.open_generation()
    zombie_dispatcher = make_dispatcher(eval_records=0, pkg=zp)
    zombie_dispatcher.attach_journal(zombie_journal)
    zombie = zp["servicer"].MasterServicer(
        zombie_dispatcher, None, journal=zombie_journal,
        generation=zombie_journal.generation,
    )
    # One resolved task (the ledger answer) and one live lease.
    t1 = zombie.get_task({"worker_id": 0})["task"]
    assert zombie.report_task_result(
        {"task_id": t1["task_id"], "err_reason": "", "worker_id": 0}
    )["accepted"]
    t2 = zombie.get_task({"worker_id": 0})["task"]

    new_journal = lp["journal"].MasterJournal(journal_dir)
    new_dispatcher = make_dispatcher(eval_records=0, pkg=lp)
    new_servicer = lp["servicer"].MasterServicer(
        new_dispatcher, None, journal=new_journal
    )
    stats = lp["journal"].recover_master_state(
        new_journal, new_dispatcher, servicer=new_servicer, fence=True,
    )
    assert stats["generation"] == zombie_journal.generation + 1

    # 1. The zombie's journal appends are rejected before a byte lands.
    size = os.path.getsize(os.path.join(journal_dir, "journal.log"))
    with pytest.raises(zp["journal"].JournalFencedError):
        zombie_journal.append("version", model_version=99)
    with pytest.raises(zp["journal"].JournalFencedError):
        zombie_dispatcher.get(0)
    assert os.path.getsize(
        os.path.join(journal_dir, "journal.log")) == size
    # 2. Its RPC handlers reject loudly (after the is_fenced cache).
    time.sleep(0.15)
    resp = zombie.report_task_result(
        {"task_id": t2["task_id"], "err_reason": "", "worker_id": 0}
    )
    assert resp["stale_master"] and not resp["accepted"]
    assert fenced_total(zombie) >= 1
    resp = zombie.get_task({"worker_id": 0})
    assert resp["stale_master"] and resp["task"] is None
    # 3. The live master resolves the same reports.
    resp = new_servicer.report_task_result(
        {"task_id": t2["task_id"], "err_reason": "", "worker_id": 0}
    )
    assert resp["accepted"]
    resp = new_servicer.report_task_result(
        {"task_id": t1["task_id"], "err_reason": "", "worker_id": 0}
    )
    assert resp["accepted"], "ledger answer lost across the takeover"
    # 4. Nothing of the zombie's generation follows the fence record,
    # and both packages' fscks read the file clean.
    records = [r for _o, _e, r in read_records(
        os.path.join(journal_dir, "journal.log"))]
    fence_at = [i for i, r in enumerate(records) if r["t"] == "fence"]
    assert fence_at
    assert all(r.get("generation", stats["generation"])
               >= stats["generation"] for r in records[fence_at[0]:])
    assert check_journal(journal_dir) == []
    from tools.check_journal import check_journal as jax_check_journal

    assert jax_check_journal(journal_dir) == []


def test_port_snapshot_compaction_is_fenced(tmp_path):
    journal_dir = str(tmp_path / "journal")
    zombie = MasterJournal(journal_dir, snapshot_every=1)
    zombie.open_generation()
    dispatcher = make_dispatcher(eval_records=0)
    dispatcher.attach_journal(zombie)
    # The fence lands between the zombie's last append and its
    # compaction.
    standby = MasterJournal(journal_dir)
    standby.publish_fence(zombie.generation + 1)
    with pytest.raises(JournalFencedError):
        zombie._snapshot_locked()
    assert standby.has_state()


def test_port_reopen_never_lands_under_the_fence(tmp_path):
    journal_dir = str(tmp_path / "journal")
    old = MasterJournal(journal_dir)
    old.open_generation()
    standby = MasterJournal(journal_dir)
    standby.publish_fence(old.generation + 1)
    standby.open_generation()
    # The old primary restarted by its supervisor (the plain restart
    # path, no takeover fence) must still fence the promoted standby.
    restarted = MasterJournal(journal_dir)
    restarted_gen = restarted.open_generation()
    assert restarted_gen > standby.generation
    assert restarted.fence_generation() == restarted_gen
    with pytest.raises(JournalFencedError):
        standby.append("version", model_version=1)
    restarted.append("version", model_version=1)  # sole writer


def test_port_unreadable_fence_fails_closed(tmp_path):
    journal = MasterJournal(str(tmp_path / "journal"))
    journal.open_generation()
    journal.close()
    with open(journal.fence_path, "w") as fh:
        fh.write("not json{")
    assert MasterJournal(str(tmp_path / "journal")).is_fenced()
    with pytest.raises(RuntimeError):
        MasterJournal(str(tmp_path / "journal")).open_generation()


def test_port_fence_file_is_monotonic(tmp_path):
    journal = MasterJournal(str(tmp_path / "journal"))
    assert journal.publish_fence(5) == 5
    assert journal.publish_fence(3) == 5, "fence regressed"
    assert journal.fence_generation() == 5


# ---- the hot standby (in-process, real gRPC) ----------------------------


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def standby_takeover(tmp_path, primary_pkg, standby_pkg):
    """A primary of one package serving over gRPC, a standby of the
    other tailing its journal; a port worker client drives two tasks,
    the primary's server dies, the standby fences and promotes, and the
    client drains the job on it."""
    from elasticdl_tpu_torch.worker.master_client import MasterClient

    journal_dir = str(tmp_path / "journal")
    journal = primary_pkg["journal"].MasterJournal(journal_dir)
    journal.open_generation()
    dispatcher = make_dispatcher(eval_records=0, pkg=primary_pkg)
    dispatcher.attach_journal(journal)
    servicer = primary_pkg["servicer"].MasterServicer(
        dispatcher, None, journal=journal, generation=journal.generation,
    )
    primary = primary_pkg["rpc"].RpcServer(
        "localhost:0", {SERVICE_NAME: servicer.handlers()}
    ).start()
    standby_port = _free_port()

    def assemble(d, j):
        return None, standby_pkg["servicer"].MasterServicer(
            d, None, journal=j)

    standby = standby_pkg["standby"].StandbyMaster(
        journal_dir, lambda: make_dispatcher(eval_records=0,
                                             pkg=standby_pkg),
        assemble,
        primary_addr=f"localhost:{primary.port}",
        serve_addr=f"localhost:{standby_port}",
        heartbeat_secs=0.05, miss_threshold=2, poll_secs=0.05,
    )
    thread = standby.start()
    try:
        client = MasterClient(
            f"localhost:{primary.port},localhost:{standby_port}",
            worker_id=0, connect_timeout=10, retries=2,
        )
        completed = 0
        for _ in range(2):
            task, _fin = client.get_task()
            client.report_task_result(task.task_id)
            completed += 1
        # A third task leased and held across the takeover.
        held, _fin = client.get_task()
        time.sleep(0.2)  # the standby tails what just happened
        primary.stop(None)  # the SIGKILL stand-in: server gone
        deadline = time.monotonic() + 15
        while not standby.promoted and time.monotonic() < deadline:
            time.sleep(0.05)
        assert standby.promoted, "standby never took over"
        assert standby.takeover_stats["takeover_seconds"] < 5.0
        assert held.task_id in dict(standby.dispatcher.doing_start_times())
        finished = False
        late = False
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            try:
                if not late:
                    # The held lease's late report, to the new
                    # generation, accepted once.
                    client.report_task_result(held.task_id)
                    late = True
                    completed += 1
                    continue
                task, finished = client.get_task()
            except prpc.RpcError:
                client.reconnect()
                time.sleep(0.05)
                continue
            if finished:
                break
            if task is not None and task.type == TaskType.TRAINING:
                client.report_task_result(task.task_id)
                completed += 1
        assert finished, "job never drained on the promoted standby"
        assert completed == 10
        assert standby.dispatcher.counters.total_records[
            TaskType.TRAINING] == 40
        resolved = [row[0] for row in
                    standby.dispatcher.export_state()["resolved"]]
        assert len(resolved) == len(set(resolved))
        assert client.last_generation == standby.generation == 1
        client.close()
    finally:
        standby.close()
        thread.join(timeout=5)
    assert check_journal(journal_dir) == []
    return standby


def test_port_standby_takeover_serves_warm_state(tmp_path):
    standby_takeover(tmp_path, PORT, PORT)


@pytest.mark.parametrize("primary,standby", [("jax", "port"),
                                             ("port", "jax")])
def test_standby_takes_over_across_packages(tmp_path, primary, standby):
    """One journal directory, a primary of one package and a standby of
    the other: the standby tails, fences and promotes over the other
    package's records."""
    standby_takeover(tmp_path, JAX if primary == "jax" else PORT,
                     JAX if standby == "jax" else PORT)


def test_port_cli_standby_requires_journal_dir():
    from elasticdl_tpu_torch.master.main import run_standby

    assert run_standby(SimpleNamespace(journal_dir="")) == 2


# ---- --standby warm-dispatcher handover ----------------------------------


def _mnist_args(tmp_path, records, journal=True):
    from elasticdl_tpu_torch.common.args import parse_master_args
    from elasticdl_tpu_torch.testing.data import (
        create_mnist_record_file,
        model_zoo_dir,
    )

    train = create_mnist_record_file(str(tmp_path / "t.rec"), records)
    argv = ["--model_zoo", model_zoo_dir(),
            "--model_def", "mnist.mnist_functional.custom_model",
            "--training_data", train,
            "--minibatch_size", "8",
            "--num_minibatches_per_task", "1",
            "--job_name", "warmjob",
            "--master_addr", "localhost:0"]
    if journal:
        argv += ["--journal_dir", str(tmp_path / "journal")]
    return lambda: parse_master_args(argv)


def test_port_warm_handover_skips_full_replay(tmp_path, monkeypatch):
    """``--standby`` promotion hands the continuously-replayed WARM
    dispatcher into ``Master``: no ``replay_records``, no
    ``recover_master_state``, the standby's dispatcher object adopted
    with its state intact."""
    from elasticdl_tpu_torch.core.model_spec import get_model_spec
    from elasticdl_tpu_torch.master import journal as journal_mod
    from elasticdl_tpu_torch.master.main import Master, build_dispatcher
    from elasticdl_tpu_torch.master.standby import StandbyMaster

    make_args = _mnist_args(tmp_path, 64)
    args = make_args()
    primary = Master(args)
    for _ in range(3):
        task = primary.task_dispatcher.get(0)
        primary.task_dispatcher.report(task.task_id, True)
    open_lease = primary.task_dispatcher.get(0)

    spec = get_model_spec(
        model_zoo=args.model_zoo, model_def=args.model_def,
        dataset_fn=args.dataset_fn, loss=args.loss,
        optimizer=args.optimizer, eval_metrics_fn=args.eval_metrics_fn,
        callbacks=args.callbacks,
        custom_data_reader=args.custom_data_reader, device="cpu",
    )
    standby = StandbyMaster(
        str(tmp_path / "journal"),
        dispatcher_factory=lambda: build_dispatcher(args, spec),
        assemble=None, primary_addr="localhost:1", serve_addr="",
    )
    assert standby.poll_journal() > 0  # the warm tail caught up
    primary._journal.close()
    warm = standby.hand_over()

    calls = {"replay_records": 0}
    orig_replay = journal_mod.MasterJournal.replay_records

    def counting_replay(self, *a, **kw):
        calls["replay_records"] += 1
        return orig_replay(self, *a, **kw)

    monkeypatch.setattr(
        journal_mod.MasterJournal, "replay_records", counting_replay)

    def forbid_cold_recovery(*_a, **_kw):
        raise AssertionError(
            "warm handover must not run recover_master_state")

    monkeypatch.setattr(
        "elasticdl_tpu_torch.master.journal.recover_master_state",
        forbid_cold_recovery)
    promoted = Master(make_args(), warm_state=warm)
    assert calls["replay_records"] == 0
    assert promoted.task_dispatcher is standby._dispatcher
    doing = dict(promoted.task_dispatcher.doing_start_times())
    assert open_lease.task_id in doing
    assert len(promoted.task_dispatcher.export_state()["resolved"]) == 3
    assert promoted._journal.generation > standby._carry["generation"]
    assert promoted._recovery_stats["generation"] == (
        promoted._journal.generation)
    assert promoted.servicer.generation == promoted._journal.generation
    promoted._journal.close()


def test_port_warm_handover_requires_journal_dir(tmp_path):
    from elasticdl_tpu_torch.master.main import Master

    args = _mnist_args(tmp_path, 16, journal=False)()
    with pytest.raises(ValueError, match="journal_dir"):
        Master(args, warm_state={"dispatcher": None, "stats": {}})


# ---- fsck: record kinds + fence order -----------------------------------


def _write_raw_journal(path, records):
    from elasticdl_tpu_torch.common import tensor_utils
    from elasticdl_tpu_torch.master.journal import _frame

    with open(path, "wb") as fh:
        for record in records:
            fh.write(_frame(tensor_utils.dumps(record)))


def test_port_check_journal_accepts_new_record_kinds(tmp_path):
    dispatcher, eval_service, journal = journaled_plane(tmp_path)
    assert eval_service.try_to_create_new_job(8)
    task = dispatcher.get(0)
    fold(eval_service, task, 1.0)
    journal.append("relaunch", kind="gang", generation=1, shard=-1)
    journal.append("fence", generation=journal.generation)
    journal.close()
    assert check_journal(str(tmp_path / "journal")) == []


def test_port_check_journal_rejects_non_monotonic_fences(tmp_path):
    path = str(tmp_path / "journal.log")
    _write_raw_journal(path, [
        {"t": "generation", "seq": 1, "generation": 1},
        {"t": "fence", "seq": 2, "generation": 5},
        {"t": "fence", "seq": 3, "generation": 3},
    ])
    assert any("non-monotonic" in e for e in check_journal(path))


def test_port_check_journal_flags_zombie_appends_after_fence(tmp_path):
    path = str(tmp_path / "journal.log")
    _write_raw_journal(path, [
        {"t": "generation", "seq": 1, "generation": 1},
        {"t": "fence", "seq": 2, "generation": 5},
        {"t": "dispatch", "seq": 3, "task_id": 1, "worker_id": 0,
         "generation": 1,
         "task": {"shard_name": "s", "start": 0, "end": 4,
                  "type": "training", "model_version": -1,
                  "task_id": 1}},
    ])
    errors = check_journal(path)
    assert any("zombie" in e for e in errors)
    from tools.check_journal import check_journal as jax_check_journal

    assert errors == jax_check_journal(path)


# ---- composed multi-plane kill ------------------------------------------


def _build_row_service(ckpt_dir, log_dir):
    from elasticdl_tpu_torch.embedding.optimizer import Adam
    from elasticdl_tpu_torch.embedding.row_service import HostRowService
    from elasticdl_tpu_torch.native.row_store import (
        make_host_optimizer,
        make_host_table,
    )

    svc = HostRowService(
        {"rows": make_host_table("rows", 8)},
        make_host_optimizer(Adam(lr=0.01)),
    )
    svc.configure_checkpoint(str(ckpt_dir), checkpoint_steps=4,
                             delta_chain_max=3, async_write=False)
    svc.configure_push_log(str(log_dir), group_ms=0.5)
    return svc


def _row_schedule(n, seed=9):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        ids = np.unique(rng.randint(0, 128, 12)).astype(np.int64)
        out.append((ids, rng.rand(ids.size, 8).astype(np.float32)))
    return out


def _push_rows(svc, schedule, start, end):
    for seq in range(start, end + 1):
        ids, grads = schedule[seq - 1]
        svc._push_row_grads({
            "table": "rows", "ids": ids, "grads": grads,
            "client": "trainer", "seq": seq,
        })


def _rows(svc):
    return {name: view.to_arrays()
            for name, view in svc.host_tables.items()
            if name != "__row_service_seqs__"}


def test_port_composed_master_and_shard_kill(tmp_path):
    """The MASTER and one ROW SHARD die in the same window — the master
    mid-lease, the shard with group commits queued. Both recoveries
    (journal replay; checkpoint chain + push-log replay) converge on
    their own: exactly-once task accounting, and rows byte-equal to a
    fault-free twin with no acked push re-driven."""
    schedule = _row_schedule(12)
    twin = _build_row_service(tmp_path / "twin_ckpt",
                              tmp_path / "twin_wal")
    _push_rows(twin, schedule, 1, 12)
    twin_state = _rows(twin)
    twin.stop()

    dispatcher, _eval_service, journal = journaled_plane(
        tmp_path, eval_records=0, records=24
    )
    svc = _build_row_service(tmp_path / "ckpt", tmp_path / "wal")
    done = dispatcher.get(0)
    dispatcher.report(done.task_id, True)
    leased = dispatcher.get(0)  # held across the kill window
    _push_rows(svc, schedule, 1, 8)

    # ---- the composed kill window ----
    pre_kill_ids = {name: np.sort(np.asarray(ids, np.int64))
                    for name, (ids, _r) in _rows(svc).items()}
    svc._push_log.abandon()     # shard SIGKILL stand-in
    svc._ckpt_writer.close()
    journal.close()             # master SIGKILL stand-in

    # ---- both planes recover on their own ----
    dispatcher2, _e2, _s2, journal2, _stats = recover_plane(
        tmp_path, eval_records=0, records=24
    )
    doing = dict(dispatcher2.doing_start_times())
    assert leased.task_id in doing
    _task, _wid, requeued, duplicate = dispatcher2.apply_report(
        leased.task_id, True)
    assert not requeued and not duplicate
    _task, _wid, _rq, duplicate = dispatcher2.apply_report(
        leased.task_id, True)
    assert duplicate
    resolved_first = {done.task_id, leased.task_id}
    while True:
        task = dispatcher2.get(0)
        if task is None:
            break
        assert task.task_id not in resolved_first
        resolved_first.add(task.task_id)
        dispatcher2.report(task.task_id, True)
    assert dispatcher2.finished()
    assert dispatcher2.counters.total_records[TaskType.TRAINING] == 24
    resolved_ids = [row[0] for row in
                    dispatcher2.export_state()["resolved"]]
    assert len(resolved_ids) == len(set(resolved_ids))

    svc2 = _build_row_service(tmp_path / "ckpt", tmp_path / "wal")
    assert svc2._push_count == 8
    for name, ids in pre_kill_ids.items():
        have = np.sort(np.asarray(_rows(svc2)[name][0], np.int64))
        assert np.isin(ids, have).all(), name
    _push_rows(svc2, schedule, 9, 12)
    final = _rows(svc2)
    for name in sorted(twin_state):
        ids_t, rows_t = twin_state[name]
        ids_f, rows_f = final[name]
        assert np.array_equal(np.asarray(ids_t), np.asarray(ids_f)), name
        assert np.array_equal(np.asarray(rows_t, np.float64),
                              np.asarray(rows_f, np.float64)), name
    svc2.stop()
    journal2.close()


# ---- the drill ------------------------------------------------------------


def test_port_drill_standby_mode(tmp_path):
    """The port's drill in standby mode with real master processes of
    the port: three SIGKILL failovers and the zombie partition, the job
    drained exactly once, the journal clean."""
    from elasticdl_tpu_torch.chaos.failover_drill import RECORDS, run_drill

    result = run_drill(str(tmp_path / "drill"), "standby")
    assert result["problems"] == []
    assert result["fsck"] == []
    assert result["trained_records"] == RECORDS
    assert len(result["failovers"]) == 4
    assert result["zombie"] and result["zombie"]["fenced"]
    assert not result["resize_pending_at_end"]
    assert len(result["downtimes_secs"]) >= 3
    assert all(f["recovery"]["kind"] == "warm_takeover"
               for f in result["failovers"])


# ---- the CLI: a primary, a standby and a cold relaunch ------------------


def test_cli_primary_standby_then_cold_relaunch(tmp_path):
    """``master.main --journal_dir J`` as the primary, ``master.main
    --standby --journal_dir J --primary_addr ...`` beside it, and a
    scripted worker holding a lease at each kill: the primary SIGKILLed
    (the standby fences and promotes), then the promoted standby
    SIGKILLed and ``master.main --journal_dir J`` relaunched cold on the
    primary's address (it replays the journal). Both late reports are
    accepted, the job drains with every task resolved once, the last
    generation is 2 and the journal reads clean."""
    import signal
    import subprocess
    import sys

    from elasticdl_tpu_torch.master.main import build_dispatcher
    from elasticdl_tpu_torch.worker.master_client import MasterClient

    make_args = _mnist_args(tmp_path, 64)
    args = make_args()
    journal_dir = args.journal_dir
    p1, p2 = _free_port(), _free_port()
    flags = ["--model_zoo", args.model_zoo, "--model_def", args.model_def,
             "--training_data", args.training_data, "--minibatch_size", "8",
             "--num_minibatches_per_task", "1", "--journal_dir", journal_dir]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo)
    procs = []

    def master(*extra, log):
        proc = subprocess.Popen(
            [sys.executable, "-m", "elasticdl_tpu_torch.master.main",
             *flags, *extra], env=env, cwd=str(tmp_path),
            stdout=open(str(tmp_path / log), "w"), stderr=subprocess.STDOUT)
        procs.append(proc)
        return proc

    def log(name):
        return (tmp_path / name).read_text()

    def until(cond, what, timeout=60.0):
        deadline = time.monotonic() + timeout
        while not cond():
            assert time.monotonic() < deadline, what
            time.sleep(0.05)

    try:
        primary = master("--master_addr", f"localhost:{p1}", log="p.log")
        # The standby starts once the primary serves: a standby whose
        # first beats miss a still-importing primary promotes at once,
        # and the primary then fences it.
        until(lambda: "Master RPC serving" in log("p.log"),
              "the primary never served")
        standby = master("--standby", "--master_addr", f"localhost:{p2}",
                         "--primary_addr", f"localhost:{p1}",
                         "--standby_heartbeat_secs", "0.1",
                         "--standby_miss_threshold", "2", log="s.log")
        client = MasterClient(f"localhost:{p1},localhost:{p2}",
                              worker_id=0, connect_timeout=60, retries=3)
        until(lambda: "standby: heartbeating" in log("s.log"),
              "the standby never started tailing")
        reported = []

        def ride(fn, timeout=120.0):
            deadline = time.monotonic() + timeout
            while True:
                try:
                    return fn()
                except prpc.RpcError:
                    assert time.monotonic() < deadline, "a call never rode out"
                    client.reconnect()
                    time.sleep(0.05)

        def run_task():
            task, finished = ride(client.get_task)
            if task is not None and task.type != TaskType.WAIT:
                return task, finished
            return None, finished

        for _ in range(2):
            task, _f = run_task()
            ride(lambda: client.report_task_result(task.task_id))
            reported.append(task.task_id)
        held, _f = run_task()
        os.kill(primary.pid, signal.SIGKILL)
        primary.wait(timeout=30)
        # The late report rides out to the promoted standby.
        ride(lambda: client.report_task_result(held.task_id))
        reported.append(held.task_id)
        assert "taking over: fence generation 1" in log("s.log")
        assert client.last_generation == 1
        held2, _f = run_task()
        os.kill(standby.pid, signal.SIGKILL)
        standby.wait(timeout=30)
        relaunch = master("--master_addr", f"localhost:{p1}", log="r.log")
        ride(lambda: client.report_task_result(held2.task_id))
        reported.append(held2.task_id)
        assert "record(s) replayed" in log("r.log")
        assert client.last_generation == 2
        finished = False
        while not finished:
            task, finished = run_task()
            if task is not None:
                ride(lambda: client.report_task_result(task.task_id))
                reported.append(task.task_id)
        client.close()
        assert relaunch.wait(timeout=60) == 0
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    assert len(reported) == len(set(reported)) == 9  # 8 + train-end
    assert check_journal(journal_dir) == []
    records = [r for _o, _e, r in read_records(
        os.path.join(journal_dir, "journal.log"))]
    assert max(r["generation"] for r in records
               if r["t"] == "generation") == 2
    from elasticdl_tpu_torch.core.model_spec import get_model_spec

    spec = get_model_spec(args.model_zoo, args.model_def, device="cpu")
    dispatcher = build_dispatcher(args, spec)
    pj.apply_replay(dispatcher, MasterJournal(journal_dir).replay_records())
    assert dispatcher.finished()
    assert dispatcher.counters.total_records[TaskType.TRAINING] == 64
    resolved = [row[0] for row in dispatcher.export_state()["resolved"]]
    assert sorted(resolved) == sorted(reported)
