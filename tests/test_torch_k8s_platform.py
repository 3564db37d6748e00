"""The port's k8s platform plane (``elasticdl_tpu_torch/platform/``) held to
the JAX package's on the CPU.

Resource and volume strings parse to the same fragments (and the same
errors); every pod and Service name, label key, port and manifest is the
JAX builders' byte for byte, so a master of either package adopts the
other's pods by name; ``render_job_manifests`` gives the same YAML; the
gated ``Client`` raises ``K8sUnavailableError`` here (no ``kubernetes``
package) in both; ``PodMonitor`` and ``JobMonitor`` over the same fake
client reach the same outcomes and tail the same logs.
"""

import pytest

from elasticdl_tpu.platform import job_monitor as jjm
from elasticdl_tpu.platform import k8s_client as jkc
from elasticdl_tpu.platform import k8s_resource as jkr
from elasticdl_tpu.platform import k8s_volume as jkv
from elasticdl_tpu_torch.platform import job_monitor as pjm
from elasticdl_tpu_torch.platform import k8s_client as pkc
from elasticdl_tpu_torch.platform import k8s_resource as pkr
from elasticdl_tpu_torch.platform import k8s_volume as pkv


def both(jax_fn, port_fn, *args, **kwargs):
    """Each package's answer, or the type of what it raised."""
    out = []
    for fn in (jax_fn, port_fn):
        try:
            out.append(fn(*args, **kwargs))
        except Exception as exc:  # compared by type
            out.append(type(exc))
    return out


@pytest.mark.parametrize("spec", [
    "", "cpu=1,memory=4096Mi", "disk=1Gi,gpu=1,tpu=8",
    " cpu = 0.5 , memory=2Gi ,", "ephemeral-storage=10G", "cpu=250m",
    "flux=1", "cpu=abc", "cpu", "CPU=2",
])
def test_resource_strings_parse_as_in_jax(spec):
    want, got = both(jkr.parse_resource, pkr.parse_resource, spec)
    assert got == want
    want, got = both(jkr.resource_requirements, pkr.resource_requirements,
                     spec, "cpu=4" if spec.startswith("cpu") else "")
    assert got == want


@pytest.mark.parametrize("spec", [
    "", "claim_name=pvc0,mount_path=/data",
    "claim_name=pvc0,mount_path=/data;"
    "host_path=/tmp/x,mount_path=/x,sub_path=sub",
    "host_path=/h,mount_path=/m,type=Directory;;",
    "mount_path=/data", "claim_name=a,host_path=/b,mount_path=/c",
    "claim_name=a,mount_path=/c,bogus=1", "claim_name",
])
def test_volume_strings_parse_as_in_jax(spec):
    want, got = both(jkv.parse_volume, pkv.parse_volume, spec)
    assert got == want


@pytest.mark.parametrize("job", ["j", "job-1", "recsys"])
def test_names_labels_and_ports_are_jax_s(job):
    assert pkc.get_master_pod_name(job) == jkc.get_master_pod_name(job)
    assert pkc.get_master_service_name(job) == \
        jkc.get_master_service_name(job)
    assert pkc.get_tensorboard_service_name(job) == \
        jkc.get_tensorboard_service_name(job)
    for wid in (0, 3, 17):
        assert pkc.get_worker_pod_name(job, wid) == \
            jkc.get_worker_pod_name(job, wid)
    for shard in (0, 1, 15):
        assert pkc.get_row_service_service_name(job, shard) == \
            jkc.get_row_service_service_name(job, shard)
        for generation in (0, 1, 4):
            assert pkc.get_row_service_pod_name(job, generation, shard) \
                == jkc.get_row_service_pod_name(job, generation, shard)
    for shard in (-1, 0, 2):
        assert pkc._labels(job, "worker", shard) == \
            jkc._labels(job, "worker", shard)
    for name in ("ELASTICDL_JOB_KEY", "ELASTICDL_REPLICA_TYPE_KEY",
                 "ELASTICDL_REPLICA_INDEX_KEY", "MASTER_PORT",
                 "ROW_SERVICE_PORT", "TENSORBOARD_PORT"):
        assert getattr(pkc, name) == getattr(jkc, name)


POD_CASES = [
    dict(name="p", job_name="j", replica_type="master", image="i",
         command=["c"]),
    dict(name=jkc.get_worker_pod_name("job1", 3), job_name="job1",
         replica_type="worker", replica_index=3, image="img:latest",
         command=["python", "-m", "x", "--flag", "1"],
         resource_request="cpu=1,gpu=1", resource_limit="cpu=2",
         volume="host_path=/d,mount_path=/d;claim_name=c,mount_path=/e",
         envs={"A": "1", "B": 2}, owner={"name": "master-pod",
                                          "uid": "uid-1"}),
    dict(name="rs", job_name="j", replica_type="rowservice",
         replica_index=0, image="i", command=["serve"], namespace="ns",
         restart_policy="OnFailure", envs={}),
]


@pytest.mark.parametrize("case", range(len(POD_CASES)))
def test_pod_manifests_are_jax_s(case):
    kw = POD_CASES[case]
    assert pkc.build_pod_manifest(**kw) == jkc.build_pod_manifest(**kw)


def test_service_manifests_and_yaml_are_jax_s():
    pairs = [
        (pkc.build_master_service_manifest("job1"),
         jkc.build_master_service_manifest("job1")),
        (pkc.build_master_service_manifest("job1", "ns", 7000),
         jkc.build_master_service_manifest("job1", "ns", 7000)),
        (pkc.build_tensorboard_service_manifest("job1"),
         jkc.build_tensorboard_service_manifest("job1")),
        (pkc.build_tensorboard_service_manifest("j", "ns", 7, "NodePort"),
         jkc.build_tensorboard_service_manifest("j", "ns", 7, "NodePort")),
    ] + [
        (pkc.build_row_service_service_manifest("j", shard=s),
         jkc.build_row_service_service_manifest("j", shard=s))
        for s in (0, 1, 5)
    ]
    for got, want in pairs:
        assert got == want
    docs = [pkc.build_pod_manifest(**POD_CASES[1])] + [p[0] for p in pairs]
    text = pkc.render_job_manifests(docs)
    assert text == jkc.render_job_manifests(docs)
    import yaml

    assert list(yaml.safe_load_all(text)) == docs


def test_client_raises_without_the_kubernetes_package():
    for mod in (jkc, pkc):
        with pytest.raises(mod.K8sUnavailableError, match="kubernetes"):
            mod.Client(namespace="default")
    assert issubclass(pkc.K8sUnavailableError, RuntimeError)


class _Pod:
    def __init__(self, name, phase, rtype):
        class Meta:
            pass

        class Status:
            pass

        self.metadata = Meta()
        self.metadata.name = name
        self.metadata.labels = {pkc.ELASTICDL_REPLICA_TYPE_KEY: rtype}
        self.status = Status()
        self.status.phase = phase


class _Pods:
    """Each get_pod answers the next phase of the script (None: 404);
    with ``repeat`` the last phase repeats, else the pod is gone for
    good once the script ends."""

    def __init__(self, phases, pods=(), repeat=True):
        self._phases = list(phases)
        self._pods = list(pods)
        self._repeat = repeat
        self.logs = []

    def get_pod(self, name):
        if not self._phases:
            return None
        if self._repeat and len(self._phases) == 1:
            phase = self._phases[0]
        else:
            phase = self._phases.pop(0)
        return None if phase is None else _Pod(name, phase, "master")

    def get_pod_log(self, name, tail_lines=100):
        self.logs.append(name)
        return "boom"

    def list_job_pods(self, job):
        return self._pods


MONITOR_CASES = [
    (["Running", "Succeeded"], True, {}),
    (["Running", "Failed"], True, {}),
    ([None], True, {}),
    ([None, "Running", "Succeeded"], True, {}),
    (["Running"], False, {}),
    (["Running"], False, {"unknown_ok": True}),
    ([], False, {}),
    (["Running", "Succeeded"], False, {}),
    (["Pending"], False, {}),
]


@pytest.mark.parametrize("case", range(len(MONITOR_CASES)))
def test_monitors_reach_jax_s_outcomes(case):
    phases, repeat, kw = MONITOR_CASES[case]
    side_pods = [_Pod("w0", "Running", "worker"),
                 _Pod("rs", "Failed", "rowservice")]
    outcomes = []
    for mod in (jjm, pjm):
        seen = []
        for run in ("pod", "pod_outcome", "job", "job_outcome"):
            client = _Pods(phases, side_pods, repeat=repeat)
            if run.startswith("pod"):
                mon = mod.PodMonitor(client, "p", poll_secs=0.001,
                                     not_found_retries=2, **kw)
                value = mon.wait_outcome() if run.endswith("outcome") \
                    else mon.wait()
            else:
                mon = mod.JobMonitor(client, "j", poll_secs=0.001, **kw)
                value = (mon.wait_outcome(not_found_retries=2)
                         if run.endswith("outcome")
                         else mon.wait(not_found_retries=2))
            seen.append((run, value, client.logs))
        outcomes.append(seen)
    assert outcomes[1] == outcomes[0]


def test_job_monitor_snapshot_and_timeout_as_jax():
    pods = [_Pod("w0", "Running", "worker"),
            _Pod("w1", "Failed", "worker"),
            _Pod("rs", "Failed", "rowservice")]
    snaps = [mod.JobMonitor(_Pods(["Running"], pods), "j").snapshot()
             for mod in (jjm, pjm)]
    assert snaps[1] == snaps[0] == {
        "worker": {"w0": "Running", "w1": "Failed"},
        "rowservice": {"rs": "Failed"}}
    # A master that never finishes: the wait times out as a failure.
    for mod in (jjm, pjm):
        mon = mod.JobMonitor(_Pods(["Running"], pods), "j",
                             poll_secs=0.001)
        assert mon.wait_outcome(timeout=0.02) == mod.OUTCOME_FAILED
