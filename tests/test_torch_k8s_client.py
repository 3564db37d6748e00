"""The port's CLI (``elasticdl_tpu_torch/api/client.py``, behind ``python -m
elasticdl_tpu_torch``) and image builder (``api/image_builder.py``) held
to the JAX package's on the CPU.

``train`` (and ``evaluate``) with another strategy than Local prints the
master pod's and its Services' manifests when ``kubernetes`` is missing,
as JAX's does: the same documents apart from the command, which names
the port's master and carries the port's own flags (they parse back to
the job's). With a stand-in ``Client`` the manifests are created and
``--wait`` follows the master pod to its end. ``clean`` returns 2
without ``kubernetes`` or a job name, and ``Client.delete_job`` deletes
what JAX's deletes, past errors under ``--force``. ``chaos`` raises
naming its ROADMAP item; ``trace`` runs the trace export. The image
builder, given a fake docker client, builds and pushes the port's
package (not JAX's, without the kernel and row-store build caches)
under a Dockerfile that installs torch and no jax.
"""

import os

import pytest
import yaml

from elasticdl_tpu.api import client as jcl
from elasticdl_tpu.api import image_builder as jib
from elasticdl_tpu.platform import k8s_client as jkc
from elasticdl_tpu.testing import data as jdata
from elasticdl_tpu_torch.api import client as pcl
from elasticdl_tpu_torch.api import image_builder as pib
from elasticdl_tpu_torch.platform import k8s_client as pkc
from elasticdl_tpu_torch.testing import data as pdata


def submit_flags(zoo, train, tb):
    return ["--model_zoo", zoo, "--model_def",
            "mnist.mnist_functional.custom_model", "--training_data",
            train, "--minibatch_size", "16", "--distribution_strategy",
            "MeshStrategy", "--image_name", "img:1", "--job_name", "cj",
            "--namespace", "ns", "--envs", "A=1,B=two", "--volume",
            "host_path=/d,mount_path=/d", "--master_resource_request",
            "cpu=2,memory=2Gi", "--num_workers", "3",
            "--tensorboard_log_dir", tb]


def printed_docs(capsys, main, argv):
    assert main(argv) == 0
    return list(yaml.safe_load_all(capsys.readouterr().out))


@pytest.mark.parametrize("role", ["train", "evaluate"])
def test_submit_prints_jax_s_manifests(tmp_path, capsys, role):
    train = pdata.create_mnist_record_file(str(tmp_path / "t.rec"), 16,
                                           seed=1)
    tb = str(tmp_path / "tb")
    extra = [] if role == "train" else ["--checkpoint_dir_for_init",
                                        str(tmp_path / "ck")]
    flags = submit_flags(pdata.model_zoo_dir(), train, tb)
    if role == "evaluate":
        flags = flags + extra
        flags[flags.index("--training_data")] = "--validation_data"
        i = flags.index("--tensorboard_log_dir")
        del flags[i:i + 2]
    port = printed_docs(capsys, pcl.main, [role] + flags)
    jflags = [a.replace(pdata.model_zoo_dir(), jdata.model_zoo_dir())
              for a in flags]
    jax = printed_docs(capsys, jcl.main, [role] + jflags)
    assert [d["kind"] for d in port] == [d["kind"] for d in jax] == (
        ["Pod", "Service", "Service"] if role == "train"
        else ["Pod", "Service"])
    commands = [d["spec"]["containers"][0].pop("command") for d in
                (port[0], jax[0])]
    assert port == jax
    assert commands[0][:3] == ["python", "-m",
                               "elasticdl_tpu_torch.master.main"]
    assert commands[1][:3] == ["python", "-m", "elasticdl_tpu.master.main"]
    # The port's passthrough is the job's own flags, for the port master.
    from elasticdl_tpu_torch.common.args import parse_master_args

    master = parse_master_args(commands[0][3:])
    assert (master.job_name, master.image_name, master.num_workers,
            master.namespace, master.envs) == ("cj", "img:1", 3, "ns",
                                               "A=1,B=two")
    assert port[0]["metadata"]["name"] == pkc.get_master_pod_name("cj")


class StandIn:
    """What ``Client`` offers the CLI, recorded; the master pod's phase
    follows ``phases``."""

    made = []

    def __init__(self, namespace="default", force_kube_config=False):
        self.calls = [("client", namespace, force_kube_config)]
        self.phases = list(StandIn.phases)
        StandIn.made.append(self)

    def create_pod(self, manifest):
        self.calls.append(("create_pod", manifest["metadata"]["name"]))

    def create_service(self, manifest):
        self.calls.append(("create_service",
                           manifest["metadata"]["name"]))

    def get_pod(self, name):
        class Pod:
            pass

        pod = Pod()
        pod.status = Pod()
        pod.status.phase = self.phases.pop(0)
        return pod

    def list_job_pods(self, job):
        return []

    def get_pod_log(self, name, tail_lines=100):
        self.calls.append(("log", name))
        return "tail"

    def delete_job(self, job_name, force=False):
        self.calls.append(("delete_job", job_name, force))


@pytest.mark.parametrize("phases,code", [(["Succeeded"], 0),
                                         (["Failed"], 1)])
def test_submit_creates_and_waits_as_jax(tmp_path, monkeypatch, phases,
                                         code):
    train = pdata.create_mnist_record_file(str(tmp_path / "t.rec"), 16,
                                           seed=1)
    flags = submit_flags(pdata.model_zoo_dir(), train, "") + [
        "--wait", "--force_use_kube_config_file"]
    StandIn.phases = phases
    calls = {}
    for tag, mod, kc in (("port", pcl, pkc), ("jax", jcl, jkc)):
        StandIn.made = []
        monkeypatch.setattr(kc, "Client", StandIn)
        argv = ["train"] + [a.replace(pdata.model_zoo_dir(),
                                      jdata.model_zoo_dir())
                            if tag == "jax" else a for a in flags]
        assert mod.main(argv) == code
        calls[tag] = StandIn.made[0].calls
    assert calls["port"] == calls["jax"]
    assert calls["port"][:3] == [
        ("client", "ns", True), ("create_pod", "elasticdl-tpu-cj-master"),
        ("create_service", "elasticdl-tpu-cj-master")]
    for tag, mod, kc in (("port", pcl, pkc), ("jax", jcl, jkc)):
        StandIn.made = []
        monkeypatch.setattr(kc, "Client", StandIn)
        assert mod.main(["clean", "--job_name", "cj", "--force"]) == 0
        calls[tag] = StandIn.made[0].calls
    assert calls["port"] == calls["jax"] == [
        ("client", "default", False), ("delete_job", "cj", True)]


def test_clean_without_kubernetes_or_a_job_returns_2():
    for mod in (pcl, jcl):
        assert mod.main(["clean", "--job_name", "cj"]) == 2
        assert mod.main(["clean"]) == 2
        assert mod.main(["nonsense"]) == 2
        assert mod.main([]) == 2


def test_chaos_and_trace_raise_naming_their_items(monkeypatch):
    """``chaos`` hands its flags to ``chaos/runner.main`` and ``trace``
    to ``observability/trace_export.main``, as JAX's CLI does (the
    chaos runs themselves: tests/test_torch_chaos.py; the traced job:
    tests/test_torch_profile_plane.py)."""
    from elasticdl_tpu_torch.chaos import runner
    from elasticdl_tpu_torch.observability import trace_export

    handed = []
    monkeypatch.setattr(runner, "main",
                        lambda argv: handed.append(argv) or 0)
    assert pcl.main(["chaos", "run", "--seed", "3"]) == 0
    assert handed == [["run", "--seed", "3"]]
    seen = []
    monkeypatch.setattr(trace_export, "main",
                        lambda argv: seen.append(argv) or 0)
    assert pcl.main(["trace", "--model", "dense"]) == 0
    assert seen == [["--model", "dense"]]


class FakeCore:
    def __init__(self, pods, fail_list=False):
        self._pods = pods
        self._fail_list = fail_list

    def list_namespaced_pod(self, namespace, label_selector):
        if self._fail_list:
            raise RuntimeError("list refused")

        class Items:
            pass

        out = Items()
        out.items = []
        for name in self._pods:
            pod = Items()
            pod.metadata = Items()
            pod.metadata.name = name
            out.items.append(pod)
        return out


def delete_job_calls(mod, force, fail_on=(), fail_list=False):
    client = object.__new__(mod.Client)
    client.namespace = "ns"
    client._core = FakeCore(["p0", "p1"], fail_list)
    calls = []

    def record(kind):
        def call(name, **kw):
            calls.append((kind, name))
            if name in fail_on:
                raise RuntimeError(f"{name} refused")
        return call

    client.delete_pod = record("pod")
    client.delete_service = record("service")
    try:
        client.delete_job("cj", force=force)
    except RuntimeError as exc:
        calls.append(("raised", str(exc)))
    return calls


@pytest.mark.parametrize("force,fail_on,fail_list", [
    (False, (), False), (True, ("p0",), False), (False, ("p0",), False),
    (True, ("elasticdl-tpu-cj-rowservice-s3",), False), (True, (), True),
    (False, (), True)])
def test_delete_job_deletes_what_jax_s_deletes(force, fail_on, fail_list):
    got = delete_job_calls(pkc, force, fail_on, fail_list)
    assert got == delete_job_calls(jkc, force, fail_on, fail_list)
    if not fail_on and not fail_list:
        assert len(got) == 2 + 1 + 1 + 16  # pods, master, tb, 16 shards


class FakeDocker:
    def __init__(self, build_error=None):
        self.calls = []
        self.build_error = build_error
        self.context = None

    def build(self, path, tag, rm, decode):
        self.calls.append(("build", tag, rm, decode))
        with open(os.path.join(path, "Dockerfile")) as fh:
            dockerfile = fh.read()
        self.context = (sorted(os.listdir(path)), dockerfile, {
            d for d, _, _ in os.walk(path)})
        yield {"stream": "Step 1/5\n"}
        if self.build_error:
            yield {"error": self.build_error}

    def push(self, image, stream, decode):
        self.calls.append(("push", image, stream, decode))
        yield {"status": "pushed"}


def test_image_builder_packages_the_port(tmp_path, monkeypatch):
    zoo = tmp_path / "zoo"
    (zoo / "m").mkdir(parents=True)
    (zoo / "m" / "model.py").write_text("x = 1\n")
    # A package tree whose build caches must stay out of the image.
    import shutil

    framework = tmp_path / "framework"
    shutil.copytree(os.path.dirname(os.path.dirname(pib.__file__)),
                    framework / "elasticdl_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    for cache in ("ops", "native"):
        build = framework / "elasticdl_tpu_torch" / cache / "_build"
        build.mkdir()
        (build / "kernel.so").write_bytes(b"\0")
        (build / "lock").write_text("")
    monkeypatch.setattr(pib, "_framework_root", lambda: str(framework))
    docker = FakeDocker()
    image = pib.build_and_push_docker_image(
        str(zoo), docker_image_repository="reg.io/team/", tag="t1",
        client=docker)
    assert image == "reg.io/team/elasticdl_tpu_torch:t1"
    assert docker.calls == [("build", image, True, True),
                            ("push", image, True, True)]
    names, dockerfile, dirs = docker.context
    assert names == ["Dockerfile", "elasticdl_tpu_torch", "model_zoo"]
    assert "torch" in dockerfile and "jax" not in dockerfile
    assert "flax" not in dockerfile
    assert not any(d.endswith(os.path.join("ops", "_build"))
                   or d.endswith(os.path.join("native", "_build"))
                   or "__pycache__" in d for d in dirs)
    assert any(d.endswith(os.path.join("elasticdl_tpu_torch", "platform"))
               for d in dirs)
    # The same flow as JAX's: build then push, no push without a
    # repository, a build error raised, the context removed after.
    jax_docker = FakeDocker()
    jib.build_and_push_docker_image(str(zoo), "reg.io/team", tag="t1",
                                    client=jax_docker)
    assert [c[0] for c in jax_docker.calls] == [c[0] for c in docker.calls]
    docker = FakeDocker()
    assert pib.build_and_push_docker_image(
        str(zoo), tag="t2", client=docker) == "elasticdl_tpu_torch:t2"
    assert [c[0] for c in docker.calls] == ["build"]
    with pytest.raises(RuntimeError, match="docker build failed: no"):
        pib.build_and_push_docker_image(str(zoo), tag="t3",
                                        client=FakeDocker("no"))
    # Without a docker SDK the context stays for an external builder.
    made = []
    real = pib.prepare_build_context

    def prepare(*a, **kw):
        made.append(real(*a, **kw))
        return made[-1]

    monkeypatch.setattr(pib, "prepare_build_context", prepare)
    assert pib.build_and_push_docker_image(str(zoo), tag="t4") == \
        "elasticdl_tpu_torch:t4"
    assert os.path.exists(os.path.join(made[0], "Dockerfile"))
    shutil.rmtree(made[0])
    assert pib.generate_dockerfile("base:1", "einops") == \
        jib.generate_dockerfile("base:1", "einops").replace(
            "jax flax optax numpy msgpack grpcio", "torch numpy grpcio"
        ).replace("/opt/elasticdl_tpu:", "/opt/elasticdl_tpu_torch:"
                  ).replace("elasticdl_tpu /opt/elasticdl_tpu/elasticdl_tpu",
                            "elasticdl_tpu_torch /opt/elasticdl_tpu_torch/"
                            "elasticdl_tpu_torch").replace(
            "model_zoo /opt/elasticdl_tpu/", "model_zoo /opt/elasticdl_tpu_torch/"
        ).replace("WORKDIR /opt/elasticdl_tpu\n",
                  "WORKDIR /opt/elasticdl_tpu_torch\n")
