"""The gang scheduler in the port (``elasticdl_tpu_torch/master/
scheduler.py`` and the master's ``--sched``) on the CPU.

One scripted submit / tick / preempt / resume / cancel sequence through
a JAX and a port scheduler writes byte-equal journals (the ``sched``
records among them) with equal tick actions and an equal ``render()``
(its clock field taken out); each package restores the other's job
table, and the port's standby warm-replays a JAX-written one; a fenced
zombie's submit leaves no trace; the usage plane's fair share orders
equal priorities the same way in both; ``submit_job`` and
``sched_status`` answer over the port's gRPC (to the JAX stub too); and
a ``--sched`` master adopts the CLI's job, takes a higher-priority job
over the RPC that preempts it, and exits once both are done.
"""

import json
import os
import threading
import time
import urllib.request

import numpy as np
import pytest

from elasticdl_tpu.master import journal as jj
from elasticdl_tpu.master import scheduler as jsched
from elasticdl_tpu.master import servicer as jsv
from elasticdl_tpu.master import task_dispatcher as jtd
from elasticdl_tpu.observability import registry as jreg
from elasticdl_tpu_torch.master import journal as pj
from elasticdl_tpu_torch.master import scheduler as psched
from elasticdl_tpu_torch.master import servicer as psv
from elasticdl_tpu_torch.master import task_dispatcher as ptd
from elasticdl_tpu_torch.master.journal import (
    JournalFencedError,
    MasterJournal,
    read_records,
)
from elasticdl_tpu_torch.observability import registry as preg
from elasticdl_tpu_torch.tools.check_journal import check_journal

JAX = dict(journal=jj, sched=jsched, servicer=jsv, dispatcher=jtd,
           registry=jreg)
PORT = dict(journal=pj, sched=psched, servicer=psv, dispatcher=ptd,
            registry=preg)
PKGS = {"jax": JAX, "port": PORT}


def spec(records=8, per_task=4, shard="d"):
    return {"shards": {shard: [0, records]}, "records_per_task": per_task,
            "num_epochs": 1, "seed": 0}


def usage_rows(shares):
    """A ``/usage`` body: one principal row a job, its share axes."""
    return {"principals": [
        {"principal": {"job": job, "component": "worker",
                       "purpose": "training"},
         "share": {"requests": share, "rows": share / 2}}
        for job, share in shares.items()]}


def drain(disp, worker_id=0):
    n = 0
    while True:
        task = disp.get(worker_id)
        if task is None:
            return n
        disp.report(task.task_id, True)
        n += 1


def scripted(pkg, journal_dir):
    """The scripted arbitration; returns (journal bytes, tick actions,
    render without ``now``, callback log, export_state)."""
    journal = pkg["journal"].MasterJournal(journal_dir)
    journal.open_generation()
    shares = {"batch": 0.0}
    calls = []
    sched = pkg["sched"].GangScheduler(
        slots_fn=lambda: 2, journal=journal,
        usage_fn=lambda: usage_rows(shares),
        registry=pkg["registry"].MetricsRegistry())
    actions = []

    def cb(kind):
        return lambda job_id, entry: calls.append(
            (kind, job_id, entry["state"], entry["preemptions"]))

    sched.submit("batch", spec=spec(16), priority=1, gang_size=2,
                 preempt_cb=cb("preempt"), resume_cb=cb("resume"))
    sched.submit("tail", spec=spec(8), priority=1, gang_size=1)
    actions.append(sched.tick())
    job, disp = sched.lease_for(0)
    leased = disp.get(0)
    disp.report(disp.get(0).task_id, True)
    sched.submit("urgent", spec=spec(8), priority=9, gang_size=2)
    actions.append(sched.tick())                   # preempts batch
    assert job == "batch" and leased is not None
    assert sched.lease_for(0)[0] == "urgent"
    drain(sched.dispatcher_of("urgent"))
    shares.update(batch=0.5, tail=0.1)             # fair share moves
    actions.append(sched.tick())                   # urgent done
    sched.submit("lost", spec={"shards": {}}, priority=5, gang_size=1)
    actions.append(sched.tick())                   # bad spec: cancel
    assert sched.cancel("tail") in (True, False)
    actions.append(sched.tick())
    drain(sched.dispatcher_of("batch"))
    actions.append(sched.tick())
    sched.submit("batch", spec=spec(4), priority=2, gang_size=1)
    actions.append(sched.tick())
    render = sched.render()
    render.pop("now")
    state = sched.export_state()
    journal.close()
    with open(os.path.join(journal_dir, "journal.log"), "rb") as fh:
        return fh.read(), actions, render, calls, state


def test_both_schedulers_journal_byte_equal_records(tmp_path):
    out = {tag: scripted(pkg, str(tmp_path / tag))
           for tag, pkg in PKGS.items()}
    assert out["port"][0] == out["jax"][0]
    for i in range(1, 5):
        assert out["port"][i] == out["jax"][i]
    _bytes, actions, render, calls, state = out["port"]
    assert actions[0] == ["schedule:batch", "run:batch"]
    assert actions[1] == ["preempt:batch", "schedule:urgent",
                          "run:urgent"]
    assert "done:urgent" in actions[2]
    assert calls[0] == ("preempt", "batch", "running", 0)
    assert ("resume", "batch", "scheduled", 1) in calls
    assert render["jobs"]["lost"]["state"] == "cancelled"
    assert render["preemptions"] == 1
    assert state["jobs"]["urgent"]["state"] == "done"
    kinds = [r["t"] for _o, _e, r in read_records(
        str(tmp_path / "port" / "journal.log"))]
    assert kinds.count("sched") == 20
    assert check_journal(str(tmp_path / "port")) == []


@pytest.mark.parametrize("writer,reader", [("jax", "port"),
                                           ("port", "jax")])
def test_each_package_restores_the_others_table(tmp_path, writer, reader):
    journal_dir = str(tmp_path / "journal")
    scripted(PKGS[writer], journal_dir)
    restored = {}
    for tag in (writer, reader):
        pkg = PKGS[tag]
        journal = pkg["journal"].MasterJournal(journal_dir)
        carry = pkg["journal"].apply_replay(
            pkg["dispatcher"].TaskDispatcher({}, shuffle=False),
            journal.replay_records())
        sched = pkg["sched"].GangScheduler(
            slots_fn=lambda: 2,
            registry=pkg["registry"].MetricsRegistry())
        sched.restore(carry["sched"])
        restored[tag] = (carry["sched"], sched.export_state())
        journal.close()
    assert restored[reader] == restored[writer]
    fold, state = restored[reader]
    assert fold["jobs"]["batch"]["state"] == "running"
    # An in-flight job comes back preempted: its gang died with the old
    # incarnation, and the next tick journals the resume.
    assert state["jobs"]["batch"]["state"] == "preempted"
    assert state["jobs"]["urgent"]["state"] == "done"
    assert state["preemptions"] == 1


def test_standby_warm_replays_a_jax_job_table(tmp_path):
    from elasticdl_tpu_torch.master.standby import StandbyMaster

    journal_dir = str(tmp_path / "journal")
    journal = jj.MasterJournal(journal_dir)
    journal.open_generation()
    sched = jsched.GangScheduler(slots_fn=lambda: 2, journal=journal,
                                 registry=jreg.MetricsRegistry())
    sched.submit("batch", spec=spec(), priority=1, gang_size=2)
    sched.tick()
    standby = StandbyMaster(
        journal_dir, dispatcher_factory=lambda: ptd.TaskDispatcher(
            {}, shuffle=False),
        assemble=None, primary_addr="localhost:1", serve_addr="",
        metrics_registry=preg.MetricsRegistry())
    assert standby.poll_journal() > 0
    assert standby._carry["sched"]["jobs"]["batch"]["state"] == "running"
    # The tail only: the next poll folds just the appended records.
    sched.submit("urgent", spec=spec(), priority=9, gang_size=2)
    sched.tick()
    assert standby.poll_journal() == 4
    fold = standby._carry["sched"]
    assert fold == sched.export_state()
    assert fold["jobs"]["batch"]["state"] == "preempted"
    assert fold["jobs"]["urgent"]["state"] == "running"
    assert fold["preemptions"] == 1
    standby.stop()
    journal.close()


def test_fenced_zombie_submit_leaves_no_trace(tmp_path):
    journal_a = MasterJournal(str(tmp_path / "journal"))
    journal_a.open_generation()
    sched_a = psched.GangScheduler(slots_fn=lambda: 2, journal=journal_a,
                                   registry=preg.MetricsRegistry())
    sched_a.submit("ok", spec=spec(), gang_size=1)
    journal_b = MasterJournal(str(tmp_path / "journal"))
    journal_b.open_generation()  # fences A
    with pytest.raises(JournalFencedError):
        sched_a.submit("zombie-job", spec=spec(), gang_size=1)
    assert "zombie-job" not in sched_a.render()["jobs"]
    servicer = psv.MasterServicer(
        ptd.TaskDispatcher({"f": (0, 8)}, shuffle=False),
        journal=journal_a, generation=journal_a.generation,
        scheduler=sched_a)
    resp = servicer.submit_job({"job": "zombie-rpc", "spec": spec(),
                                "gang_size": 1})
    assert resp["stale_master"] and not resp["accepted"]
    assert "zombie-rpc" not in sched_a.render()["jobs"]
    journal_b.close()
    j3 = MasterJournal(str(tmp_path / "journal"))
    fold = j3.recover_into(ptd.TaskDispatcher({"f": (0, 8)},
                                              shuffle=False))["sched"]
    assert set(fold["jobs"]) == {"ok"}
    j3.close()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fair_share_orders_equal_priorities_alike(seed):
    """Equal priorities schedule least-consumed first (the usage plane's
    mean share), ties by submit order; the two packages agree on the
    allocation and the rendered shares."""
    rng = np.random.RandomState(seed)
    jobs = [f"j{i}" for i in range(5)]
    shares = {j: float(rng.choice([0.0, 0.1, 0.25, 0.5])) for j in jobs}
    gangs = {j: int(rng.randint(1, 3)) for j in jobs}
    out = {}
    for tag, pkg in PKGS.items():
        sched = pkg["sched"].GangScheduler(
            slots_fn=lambda: 3, usage_fn=lambda: usage_rows(shares),
            registry=pkg["registry"].MetricsRegistry())
        for job in jobs:
            sched.submit(job, spec=spec(), priority=1,
                         gang_size=gangs[job])
        actions = sched.tick()
        render = sched.render()
        render.pop("now")
        out[tag] = (actions, render)
    assert out["port"] == out["jax"]
    render = out["port"][1]
    order = sorted(jobs, key=lambda j: (shares[j], jobs.index(j)))
    free, want = 3, []
    for job in order:  # first fit in fair-share order
        if gangs[job] <= free:
            want.append(job)
            free -= gangs[job]
    assert sorted(j for j in jobs
                  if render["jobs"][j]["state"] == "running") == want
    for job in jobs:
        assert render["jobs"][job]["usage_share"] == pytest.approx(
            (shares[job] + shares[job] / 2) / 2)


def test_submit_job_and_sched_status_over_the_ports_grpc():
    from elasticdl_tpu.comm.rpc import RpcStub as JaxStub
    from elasticdl_tpu_torch.comm.rpc import RpcServer, RpcStub

    sched = psched.GangScheduler(slots_fn=lambda: 1,
                                 registry=preg.MetricsRegistry())
    servicer = psv.MasterServicer(
        ptd.TaskDispatcher({}, shuffle=False), scheduler=sched)
    server = RpcServer("localhost:0",
                       {psv.SERVICE_NAME: servicer.handlers()}).start()
    try:
        stub = RpcStub(f"localhost:{server.port}", psv.SERVICE_NAME)
        resp = stub.call("submit_job", job="a", spec=spec(),
                         priority=3, gang_size=1)
        assert resp == {"accepted": True, "job": "a",
                        "state": "submitted", "generation": 0}
        again = stub.call("submit_job", job="a", spec=spec())
        assert not again["accepted"] and "already active" in again["error"]
        jstub = JaxStub(f"localhost:{server.port}", jsv.SERVICE_NAME)
        assert jstub.call("submit_job", job="b", spec=spec(),
                          priority=5)["accepted"]
        sched.tick()
        status = stub.call("sched_status")
        assert status["enabled"] and not status["fenced"]
        assert status["jobs"]["b"]["state"] == "running"
        assert status["jobs"]["a"]["state"] == "submitted"
        lease = stub.call("get_task", worker_id=0)
        assert lease["job"] == "b" and lease["task"]["task_id"] >= 0
        stub.close()
        jstub.close()
    finally:
        server.stop(0)


def test_sched_master_adopts_the_cli_job_and_is_preempted(tmp_path):
    """``--sched``: the CLI's job is in the table at construction (else
    its workers wait forever); a priority-10 job submitted over the RPC
    preempts it, runs to done, and the CLI job resumes and finishes; the
    run loop exits, the worker learns ``finished``, and the journal's
    cold fold says both jobs are done after exactly one preemption."""
    from elasticdl_tpu_torch.comm.rpc import RpcStub
    from elasticdl_tpu_torch.common.args import (
        build_parser,
        parse_worker_args,
    )
    from elasticdl_tpu_torch.master.main import Master
    from elasticdl_tpu_torch.testing.data import (
        create_mnist_record_file,
        model_zoo_dir,
    )
    from elasticdl_tpu_torch.worker.main import build_worker

    train = create_mnist_record_file(str(tmp_path / "t.rec"), 256, seed=1)
    urgent = create_mnist_record_file(str(tmp_path / "u.rec"), 64, seed=2)
    journal_dir = str(tmp_path / "journal")
    common = ["--model_zoo", model_zoo_dir(),
              "--model_def", "mnist.mnist_functional.custom_model",
              "--training_data", train, "--minibatch_size", "16",
              "--num_epochs", "4", "--job_name", "demo"]
    master = Master(build_parser("master").parse_args(common + [
        "--sched", "true", "--journal_dir", journal_dir,
        "--master_addr", "localhost:0", "--metrics_port", "0"]))
    assert master.scheduler.job_state("demo") == "submitted"
    master.prepare()
    codes = {}
    run_thread = threading.Thread(
        # The linger after the exit gate (two poll intervals) must
        # outlast the worker's 2 s sleep on a WAIT answer.
        target=lambda: codes.update(master=master.run(poll_secs=1.5)),
        daemon=True)
    run_thread.start()
    worker = build_worker(parse_worker_args(common + [
        "--worker_id", "0", "--master_addr", f"localhost:{master.port}",
        "--device", "cpu", "--master_reattach_grace", "5"]))
    stub = RpcStub(f"localhost:{master.port}", psv.SERVICE_NAME)
    seen = []

    def submit_when_running():
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            if master.scheduler.job_state("demo") == "running":
                break
            time.sleep(0.02)
        seen.append(stub.call("submit_job", job="urgent", priority=10,
                              gang_size=1,
                              spec={"shards": {urgent: [0, 64]},
                                    "records_per_task": 16,
                                    "num_epochs": 1, "seed": 0}))
        with urllib.request.urlopen(
                f"http://localhost:{master.metrics_plane.http_port}"
                "/sched") as resp:
            seen.append(json.loads(resp.read()))

    submitter = threading.Thread(target=submit_when_running, daemon=True)
    submitter.start()
    worker_thread = threading.Thread(target=worker.run, daemon=True)
    worker_thread.start()
    try:
        worker_thread.join(timeout=180)
        assert not worker_thread.is_alive(), "the worker never finished"
        submitter.join(timeout=60)
        run_thread.join(timeout=60)
        assert not run_thread.is_alive() and codes["master"] == 0
        assert seen[0]["accepted"]
        assert set(seen[1]["jobs"]) == {"demo", "urgent"}
        table = master.scheduler.render()
    finally:
        stub.close()
        if worker_thread.is_alive():
            worker.request_stop()
        if run_thread.is_alive():
            master.request_stop()
            run_thread.join(timeout=30)
    assert {j: e["state"] for j, e in table["jobs"].items()} == {
        "demo": "done", "urgent": "done"}
    assert table["jobs"]["demo"]["preemptions"] == 1
    fold = pj.new_sched_state()
    for _o, _e, record in read_records(
            os.path.join(journal_dir, pj.JOURNAL_FILE)):
        if record["t"] == pj.SNAPSHOT and record.get("sched"):
            fold = record["sched"]
        elif record["t"] == pj.SCHED:
            pj.apply_sched_record(fold, record)
    assert {j: e["state"] for j, e in fold["jobs"].items()} == {
        "demo": "done", "urgent": "done"}
    assert fold["preemptions"] == 1
    assert check_journal(journal_dir) == []
    assert master.task_dispatcher.counters.total_records[
        "training"] == 4 * 256
