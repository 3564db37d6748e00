"""The port's instance manager (``elasticdl_tpu_torch/master/instance_manager.py``)
held to the JAX package's on the CPU.

The same scripts of pod events and calls drive a JAX and a port manager,
each over its own package's ``TaskDispatcher`` and a fake k8s client that
records every call: the create, delete and Service calls (whole
manifests), the live workers, the re-queued tasks and the dispatchers'
exported state come out equal. The scripts cover the exit-137-versus-
user-crash rule, relaunch under a fresh id, the budget, the straggler
kill (and the kill of a pod already gone), the multi-host gang restart
with its stale events, row-service pods (start, relaunch, stale events,
shards, a shard added and drained, adoption), scale-up and drain, and
the chaos observer's events. Journaled ``relaunch`` records are
byte-equal to JAX's, and a recovered port journal adopts the pods under
their true names. The port master's pod commands are JAX's with the
port's modules.
"""

import os

import pytest

from elasticdl_tpu.master import instance_manager as jim
from elasticdl_tpu.master import journal as jj
from elasticdl_tpu.master import task_dispatcher as jtd
from elasticdl_tpu_torch.master import instance_manager as pim
from elasticdl_tpu_torch.master import journal as pj
from elasticdl_tpu_torch.master import task_dispatcher as ptd
from elasticdl_tpu_torch.platform import k8s_client as pkc

PKGS = {"jax": (jim, jtd, jj), "port": (pim, ptd, pj)}


class RecordingK8s:
    """Records every call; ``delete_result`` None plays a 404."""

    def __init__(self):
        self.calls = []
        self.delete_result = True

    def create_pod(self, manifest):
        self.calls.append(("create_pod", manifest))

    def create_service(self, manifest):
        self.calls.append(("create_service", manifest))

    def delete_pod(self, name, **kw):
        self.calls.append(("delete_pod", name))
        return self.delete_result

    def delete_service(self, name):
        self.calls.append(("delete_service", name))

    def get_pod(self, name):
        return None

    def watch_job_pods(self, job_name, callback, stop):
        self.calls.append(("watch", job_name))


def event(name, rtype="worker", index=0, etype="DELETED", phase="",
          exit_code=None):
    return {"type": etype, "object": {
        "metadata": {"name": name, "labels": {
            pkc.ELASTICDL_REPLICA_TYPE_KEY: rtype,
            pkc.ELASTICDL_REPLICA_INDEX_KEY: str(index)}},
        "status": {"phase": phase, "exit_code": exit_code}}}


def worker_event(wid, suffix="", **kw):
    return event(pkc.get_worker_pod_name("j", wid) + suffix, "worker", wid,
                 **kw)


def rs_event(shard, generation=0, **kw):
    return event(pkc.get_row_service_pod_name("j", generation, shard),
                 "rowservice", shard, **kw)


def task_key(task):
    return None if task is None else (task.shard_name, task.start,
                                      task.end, task.type)


def run_script(script, n=2, **kw):
    """``script(mgr, disp, client, seen)`` through both packages: each
    package's recorded calls, observations and dispatcher export."""
    out = {}
    for tag, (im, td, _) in PKGS.items():
        disp = td.TaskDispatcher(training_shards={"f": (0, 96)},
                                 records_per_task=16, shuffle=False)
        client = RecordingK8s()
        mgr = im.InstanceManager(
            disp, client, job_name="j", image_name="img",
            worker_command=lambda wid: ["run", str(wid)], num_workers=n,
            **kw)
        seen = []
        observed = []
        im.set_chaos_observer(
            lambda ev, **info: observed.append((ev, info)))
        try:
            script(mgr, disp, client, seen)
        finally:
            im.set_chaos_observer(None)
        seen.append(("live", mgr.live_workers))
        seen.append(("rows", mgr.row_service_shards()))
        out[tag] = (client.calls, seen, observed, disp.export_state())
    return out


def deleted_relaunches(mgr, disp, client, seen):
    mgr.start_workers()
    leased = disp.get(worker_id=1)
    mgr._event_cb(worker_event(1))
    seen.append(disp.doing_tasks_of(1))
    seen.append(task_key(disp.get(worker_id=2)) == task_key(leased))


def killed_versus_crashed(mgr, disp, client, seen):
    mgr.start_workers()
    disp.get(worker_id=0)
    disp.get(worker_id=1)
    mgr._event_cb(worker_event(0, etype="MODIFIED", phase="Failed",
                               exit_code=137))
    mgr._event_cb(worker_event(1, etype="MODIFIED", phase="Failed",
                               exit_code=1))
    mgr._event_cb(worker_event(2, etype="MODIFIED", phase="Running"))
    seen.append((disp.doing_tasks_of(0), disp.doing_tasks_of(1)))


def budget(mgr, disp, client, seen):
    mgr.start_workers()
    mgr._event_cb(worker_event(0))
    seen.append(dict(mgr.live_workers))
    mgr._event_cb(worker_event(1))
    mgr._event_cb(worker_event(2))


def straggler_kills(mgr, disp, client, seen):
    mgr.start_workers()
    disp.get(worker_id=0)
    disp.get(worker_id=1)
    mgr.kill_worker(0)  # the pod exists: its DELETED event recovers it
    seen.append(disp.doing_tasks_of(0))
    client.delete_result = None  # a pod already gone (404)
    mgr.kill_worker(1)
    seen.append(disp.doing_tasks_of(1))
    mgr.kill_worker(9)  # unknown: nothing


def stopped(mgr, disp, client, seen):
    mgr.start_workers()
    mgr.stop()
    mgr._handle_dead_worker(0)
    mgr._event_cb(worker_event(1))
    seen.append(mgr.scale_up(2))


def gang_restart(mgr, disp, client, seen):
    mgr.start_workers()
    disp.get(worker_id=0)
    disp.get(worker_id=2)
    mgr._event_cb(worker_event(1))
    seen.append([disp.doing_tasks_of(w) for w in range(3)])
    # The deletions the restart itself caused: stale, no cascade.
    mgr._event_cb(worker_event(0))
    mgr._event_cb(worker_event(2))
    seen.append(dict(mgr.live_workers))
    # A fresh death of a generation-1 pod: another restart.
    mgr._event_cb(worker_event(1, suffix="-g1"))
    mgr._event_cb(worker_event(0, suffix="-g1", etype="MODIFIED",
                               phase="Failed", exit_code=1))


def row_service_pods(mgr, disp, client, seen):
    mgr.start_row_service()
    mgr.start_workers()
    mgr._event_cb(rs_event(1))  # shard 1 dies: generation 1
    mgr._event_cb(rs_event(1))  # stale duplicate for generation 0
    mgr._event_cb(rs_event(0, etype="MODIFIED", phase="Failed",
                           exit_code=1))  # any failure relaunches
    mgr._event_cb(rs_event(1, generation=1, etype="MODIFIED",
                           phase="Running"))
    seen.append(mgr.add_row_service_shard())
    seen.append(mgr.row_service_shards())
    seen.append(mgr.drain_row_service_shard(1))
    seen.append(mgr.drain_row_service_shard(7))
    mgr._event_cb(rs_event(1, generation=1))  # drained: no relaunch
    seen.append(mgr.drain_row_service_shard(2))
    seen.append(mgr.add_row_service_shard())


def adopted(mgr, disp, client, seen):
    mgr.adopt_workers([0, 3], gang_generation=2)
    mgr.adopt_row_service({1: 2, 2: 0})
    seen.append((mgr.live_workers, mgr.row_service_shards()))
    mgr._event_cb(rs_event(1, generation=2))
    seen.append(mgr.scale_up(1))


def scale_and_drain(mgr, disp, client, seen):
    mgr.start_workers()
    leased = disp.get(worker_id=1)
    seen.append(mgr.scale_up(2))
    seen.append(mgr.drain_worker(1))
    seen.append(task_key(disp.get(worker_id=1)))  # fenced: None
    seen.append(mgr.drain_worker(7))
    mgr._event_cb(worker_event(1))  # the drained pod's own event
    seen.append(task_key(disp.get(worker_id=0)) == task_key(leased))
    _task, _w, _r, duplicate = disp.apply_report(leased.task_id, True)
    seen.append(duplicate)


SCRIPTS = {
    "deleted_relaunches": (deleted_relaunches, {}),
    "killed_versus_crashed": (killed_versus_crashed, {}),
    "budget": (budget, {"n": 1, "max_relaunches": 1}),
    "straggler_kills": (straggler_kills, {}),
    "stopped": (stopped, {}),
    "gang_restart": (gang_restart, {"n": 3, "multihost": True}),
    "row_service_pods": (row_service_pods, {
        "row_service_command": lambda s: ["serve-rows", str(s)],
        "row_service_resource_request": "cpu=2,memory=1Gi",
        "num_row_service_shards": 2, "n": 1}),
    "adopted": (adopted, {
        "multihost": True,
        "row_service_command": lambda s: ["serve-rows", str(s)]}),
    "scale_and_drain": (scale_and_drain, {}),
}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_managers_act_as_jax_s(name):
    script, kw = SCRIPTS[name]
    out = run_script(script, **kw)
    jax_calls, jax_seen, jax_observed, jax_state = out["jax"]
    calls, seen, observed, state = out["port"]
    assert calls == jax_calls
    assert seen == jax_seen
    assert observed == jax_observed
    assert state == jax_state
    assert calls  # every script touches the pod plane


def test_the_rules_the_scripts_pin():
    """A few of the JAX semantics, read off the port's runs."""
    calls, seen, observed, _ = run_script(killed_versus_crashed)["port"]
    # 137 relaunches under id 2; the user crash (exit 1) stays dead-not-
    # replaced and keeps its task.
    assert seen[-2] == ("live", {1: "elasticdl-tpu-j-worker-1",
                                 2: "elasticdl-tpu-j-worker-2"})
    assert seen[0][0] == [] and len(seen[0][1]) == 1
    assert [ev for ev, _ in observed] == ["worker_dead",
                                         "worker_relaunched"]
    calls, seen, _, _ = run_script(gang_restart, n=3,
                                   multihost=True)["port"]
    names = [m["metadata"]["name"] for kind, m in calls
             if kind == "create_pod"]
    assert names[3:6] == [f"elasticdl-tpu-j-worker-{w}-g1"
                          for w in range(3)]
    assert names[6:] == [f"elasticdl-tpu-j-worker-{w}-g2"
                         for w in range(3)]
    assert seen[1] == {w: f"elasticdl-tpu-j-worker-{w}-g1"
                       for w in range(3)}
    calls, seen, _, _ = run_script(
        row_service_pods, **SCRIPTS["row_service_pods"][1])["port"]
    pods = [m["metadata"]["name"] for kind, m in calls
            if kind == "create_pod"
            and "rowservice" in m["metadata"]["name"]]
    assert pods == ["elasticdl-tpu-j-rowservice",
                    "elasticdl-tpu-j-rowservice-s1",
                    "elasticdl-tpu-j-rowservice-s1-r1",
                    "elasticdl-tpu-j-rowservice-r1",
                    "elasticdl-tpu-j-rowservice-s2",
                    "elasticdl-tpu-j-rowservice-s1"]


class V1Pod:
    """A ``kubernetes`` V1Pod's attribute shape, as a watch delivers it."""

    def __init__(self, name, labels, phase, exit_code):
        class NS:
            def __init__(self, **kw):
                self.__dict__.update(kw)

        term = NS(exit_code=exit_code) if exit_code is not None else None
        self.metadata = NS(name=name, labels=labels)
        self.status = NS(phase=phase, container_statuses=[
            NS(state=NS(terminated=term))])


@pytest.mark.parametrize("raw", [
    {"type": "MODIFIED", "object": V1Pod(
        "elasticdl-tpu-j-worker-4", {pkc.ELASTICDL_REPLICA_TYPE_KEY:
                                     "worker",
                                     pkc.ELASTICDL_REPLICA_INDEX_KEY: "4"},
        "Failed", 137)},
    {"type": "ADDED", "object": V1Pod("x", None, "Pending", None)},
    worker_event(3, etype="MODIFIED", phase="Failed", exit_code=1),
    rs_event(2, generation=1),
    {"type": "DELETED"},
])
def test_pod_events_classify_as_in_jax(raw):
    assert pim.classify_pod_event(raw) == jim.classify_pod_event(raw)


def journaled_run(tag, journal_dir):
    im, td, jmod = PKGS[tag]
    journal = jmod.MasterJournal(journal_dir)
    journal.open_generation()
    disp = td.TaskDispatcher(training_shards={"f": (0, 64)},
                             records_per_task=16, shuffle=False)
    disp.attach_journal(journal)
    client = RecordingK8s()
    mgr = im.InstanceManager(
        disp, client, job_name="j", image_name="img",
        worker_command=lambda w: ["worker", str(w)], num_workers=2,
        multihost=True, row_service_command=lambda s: ["rs", str(s)],
        num_row_service_shards=2, journal=journal)
    mgr.start_row_service()
    mgr.start_workers()
    disp.get(worker_id=0)
    mgr._event_cb(worker_event(0))           # gang restart: generation 1
    mgr._event_cb(rs_event(1))               # shard 1: generation 1
    mgr._event_cb(rs_event(1, generation=1))  # shard 1: generation 2
    mgr.add_row_service_shard()              # shard 2 at generation 0
    mgr._event_cb(worker_event(1, suffix="-g1"))  # generation 2
    journal.close()
    with open(os.path.join(journal_dir, "journal.log"), "rb") as fh:
        return fh.read(), client.calls


def test_relaunch_records_are_jax_s_and_adopt_true_names(tmp_path):
    jax_bytes, jax_calls = journaled_run("jax", str(tmp_path / "jax"))
    port_bytes, port_calls = journaled_run("port", str(tmp_path / "port"))
    assert port_bytes == jax_bytes
    assert port_calls == jax_calls
    kinds = [(r["t"], r.get("kind")) for _o, _e, r in pj.read_records(
        str(tmp_path / "port" / "journal.log"))]
    assert kinds.count(("relaunch", "gang")) == 2
    assert kinds.count(("relaunch", "row_service")) == 3
    # Each package recovers the other's journal to the same generations,
    # and the port adopts the pods under their true names.
    stats = {}
    for tag, other in (("port", "jax"), ("jax", "port")):
        _im, td, jmod = PKGS[tag]
        disp = td.TaskDispatcher(training_shards={"f": (0, 64)},
                                 records_per_task=16, shuffle=False)
        stats[tag] = jmod.MasterJournal(
            str(tmp_path / other)).recover_into(disp)["relaunch"]
    assert stats["port"] == stats["jax"] == {
        "gang": 2, "row_service": {1: 2, 2: 0}}
    names = {}
    for tag, (im, td, _) in PKGS.items():
        mgr = im.InstanceManager(
            td.TaskDispatcher(training_shards={"f": (0, 64)},
                              records_per_task=16, shuffle=False),
            RecordingK8s(), job_name="j", image_name="img",
            worker_command=lambda w: ["worker"], num_workers=2,
            multihost=True, row_service_command=lambda s: ["rs"],
            num_row_service_shards=2)
        mgr.adopt_workers([0, 1], gang_generation=stats[tag]["gang"])
        mgr.adopt_row_service(stats[tag]["row_service"])
        names[tag] = (mgr.live_workers, mgr.row_service_shards())
    assert names["port"] == names["jax"]
    assert names["port"][0][0] == "elasticdl-tpu-j-worker-0-g2"
    assert names["port"][1] == {0: "elasticdl-tpu-j-rowservice",
                                1: "elasticdl-tpu-j-rowservice-s1-r2",
                                2: "elasticdl-tpu-j-rowservice-s2"}


def test_master_pod_commands_are_jax_s(tmp_path):
    """The port master's row-service and worker commands: JAX's with the
    port's modules and zoo (the worker's passthrough is each package's
    own flags)."""
    from elasticdl_tpu.common.args import parse_master_args as jax_args
    from elasticdl_tpu.master.main import Master as JaxMaster
    from elasticdl_tpu.testing import data as jdata
    from elasticdl_tpu_torch.common.args import parse_master_args
    from elasticdl_tpu_torch.master.main import Master
    from elasticdl_tpu_torch.testing import data as pdata

    train = pdata.create_frappe_record_file(str(tmp_path / "t.rec"), 32,
                                            seed=10, input_length=10,
                                            max_id=5500)
    flags = ["--model_def", "deepfm.deepfm_host.custom_model",
             "--training_data", train, "--minibatch_size", "16",
             "--num_workers", "2", "--num_row_service_shards", "2",
             "--job_name", "hostjob", "--checkpoint_dir",
             str(tmp_path / "ckpt"), "--checkpoint_steps", "4",
             "--row_service_admission_limit", "8",
             "--row_service_push_durable_wait_secs", "5",
             "--master_addr", "localhost:50123"]
    jax = JaxMaster(jax_args(["--model_zoo", jdata.model_zoo_dir()]
                             + flags))
    port = Master(parse_master_args(["--model_zoo", pdata.model_zoo_dir()]
                                    + flags))
    try:
        assert port._uses_row_service() and jax._uses_row_service()
        assert port._row_service_addr() == jax._row_service_addr() == (
            "elasticdl-tpu-hostjob-rowservice:6100,"
            "elasticdl-tpu-hostjob-rowservice-s1:6100")
        assert port._master_addr_for_workers() == \
            jax._master_addr_for_workers() == \
            "elasticdl-tpu-hostjob-master:50123"

        def ported(cmd):
            return [a.replace("elasticdl_tpu.", "elasticdl_tpu_torch.")
                    .replace(jdata.model_zoo_dir(), pdata.model_zoo_dir())
                    for a in cmd]

        for shard in (0, 1):
            assert port._row_service_command(shard) == ported(
                jax._row_service_command(shard))
        got, want = port._worker_command(3), jax._worker_command(3)
        head = got.index("--row_service_addr") + 2
        assert got[:head] == ported(want[:head])
        assert got[1:3] == ["-m", "elasticdl_tpu_torch.worker.main"]
        # The passthrough parses back to the master's own flags.
        from elasticdl_tpu_torch.common.args import parse_worker_args

        worker = parse_worker_args(got[3:])
        assert (worker.worker_id, worker.num_row_service_shards,
                worker.job_name) == (3, 2, "hostjob")
    finally:
        port.stop()
