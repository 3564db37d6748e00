"""Kubernetes platform client (port of elasticdl_tpu/platform/k8s_client.py;
reference common/k8s_client.py, 500 LoC).

The names, labels and manifests are the JAX package's byte for byte, so a
master of either package adopts the other's pods by name.

Split in two so everything above it is testable without a cluster:

- **Manifest builders** — pure functions producing plain-dict pod/service
  manifests with the reference's conventions: fixed names
  ``elasticdl-tpu-{job}-master`` / ``...-worker-{id}``, labels for job
  membership, owner references master→children so deleting the master
  reaps the job (reference k8s_client.py:329-367), restart policy Never
  (the instance manager owns relaunch, not the kubelet).
- **Client** — a thin gated wrapper over the ``kubernetes`` package
  (in-cluster config with kube-config fallback, reference
  k8s_client.py:51-80) exposing create/delete/get/watch. When the package
  is missing, ``render_job_manifests`` still yields YAML for
  ``kubectl apply`` (the reference's yaml-dump mode).
"""

import time
from typing import Callable, Dict, List, Optional

from elasticdl_tpu_torch.common.log_utils import get_logger
from elasticdl_tpu_torch.platform.k8s_resource import resource_requirements
from elasticdl_tpu_torch.platform.k8s_volume import parse_volume

logger = get_logger("k8s")

ELASTICDL_JOB_KEY = "elasticdl-tpu-job-name"
ELASTICDL_REPLICA_TYPE_KEY = "elasticdl-tpu-replica-type"
ELASTICDL_REPLICA_INDEX_KEY = "elasticdl-tpu-replica-index"

MASTER_PORT = 50001


def get_master_pod_name(job_name: str) -> str:
    return f"elasticdl-tpu-{job_name}-master"


def get_worker_pod_name(job_name: str, worker_id: int) -> str:
    return f"elasticdl-tpu-{job_name}-worker-{worker_id}"


def get_master_service_name(job_name: str) -> str:
    return get_master_pod_name(job_name)


def _labels(job_name: str, replica_type: str, replica_index: int = -1):
    labels = {
        "app": "elasticdl-tpu",
        ELASTICDL_JOB_KEY: job_name,
        ELASTICDL_REPLICA_TYPE_KEY: replica_type,
    }
    if replica_index >= 0:
        labels[ELASTICDL_REPLICA_INDEX_KEY] = str(replica_index)
    return labels


def build_pod_manifest(
    name: str,
    job_name: str,
    replica_type: str,
    image: str,
    command: List[str],
    replica_index: int = -1,
    namespace: str = "default",
    resource_request: str = "",
    resource_limit: str = "",
    volume: str = "",
    envs: Optional[Dict[str, str]] = None,
    restart_policy: str = "Never",
    owner: Optional[dict] = None,
) -> dict:
    volumes, mounts = parse_volume(volume)
    container = {
        "name": "main",
        "image": image,
        "command": command,
        "imagePullPolicy": "IfNotPresent",
        "resources": resource_requirements(resource_request, resource_limit),
        "env": [
            {"name": k, "value": str(v)} for k, v in (envs or {}).items()
        ] + [{
            "name": "MY_POD_IP",
            "valueFrom": {"fieldRef": {"fieldPath": "status.podIP"}},
        }],
    }
    if mounts:
        container["volumeMounts"] = mounts
    manifest = {
        "apiVersion": "v1",
        "kind": "Pod",
        "metadata": {
            "name": name,
            "namespace": namespace,
            "labels": _labels(job_name, replica_type,
                              replica_index),
        },
        "spec": {
            "containers": [container],
            "restartPolicy": restart_policy,
        },
    }
    if volumes:
        manifest["spec"]["volumes"] = volumes
    if owner is not None:
        # Owner reference master→child: deleting the master garbage-collects
        # every worker pod (reference k8s_client.py:329-344).
        manifest["metadata"]["ownerReferences"] = [{
            "apiVersion": "v1",
            "kind": "Pod",
            "name": owner["name"],
            "uid": owner["uid"],
            "controller": True,
            "blockOwnerDeletion": True,
        }]
    return manifest


def build_master_service_manifest(
    job_name: str, namespace: str = "default", port: int = MASTER_PORT
) -> dict:
    return {
        "apiVersion": "v1",
        "kind": "Service",
        "metadata": {
            "name": get_master_service_name(job_name),
            "namespace": namespace,
            "labels": _labels(job_name, "master"),
        },
        "spec": {
            "selector": _labels(job_name, "master"),
            "ports": [{"port": port, "targetPort": port}],
            "clusterIP": "None",  # headless: workers dial the pod directly
        },
    }


TENSORBOARD_PORT = 6006
ROW_SERVICE_PORT = 6100


def get_row_service_pod_name(job_name: str, generation: int = 0,
                             shard: int = 0) -> str:
    """Reference PS pods relaunch with the SAME id behind a fixed
    service name (k8s_instance_manager.py:303-308); pod deletion is
    async, so each relaunch generation gets a fresh pod name while the
    stable Service keeps routing. ``shard``: one pod per row-service
    shard (the reference's N PS pods, `elasticdl-{job}-ps-{id}`);
    shard 0 keeps the legacy unsuffixed name."""
    base = f"elasticdl-tpu-{job_name}-rowservice"
    if shard:
        base += f"-s{shard}"
    return base if generation == 0 else f"{base}-r{generation}"


def get_row_service_service_name(job_name: str, shard: int = 0) -> str:
    """Stable DNS name workers dial (reference fixed service names
    `elasticdl-{job}-ps-{id}` port 2222, k8s_client.py:19-22); one
    Service per shard (client-side id%N routing needs a stable
    per-shard address, never round-robin across shards)."""
    base = f"elasticdl-tpu-{job_name}-rowservice"
    return base if shard == 0 else f"{base}-s{shard}"


def build_row_service_service_manifest(
    job_name: str, namespace: str = "default",
    port: int = ROW_SERVICE_PORT, shard: int = 0,
) -> dict:
    return {
        "apiVersion": "v1",
        "kind": "Service",
        "metadata": {
            "name": get_row_service_service_name(job_name, shard),
            "namespace": namespace,
            "labels": _labels(job_name, "rowservice", shard),
        },
        "spec": {
            # Selector pins the shard index: each shard Service must
            # route to exactly its own pod (rows live by id % N).
            "selector": _labels(job_name, "rowservice", shard),
            "ports": [{"port": port, "targetPort": port}],
            "clusterIP": "None",
        },
    }


def get_tensorboard_service_name(job_name: str) -> str:
    return f"tensorboard-{job_name}"


def build_tensorboard_service_manifest(
    job_name: str, namespace: str = "default", port: int = TENSORBOARD_PORT,
    service_type: str = "LoadBalancer",
) -> dict:
    """External TensorBoard endpoint selecting the master pod (the TB
    subprocess runs there) — reference k8s_tensorboard_client.py +
    k8s_client.py:386-405."""
    return {
        "apiVersion": "v1",
        "kind": "Service",
        "metadata": {
            "name": get_tensorboard_service_name(job_name),
            "namespace": namespace,
            "labels": _labels(job_name, "tensorboard"),
        },
        "spec": {
            "selector": _labels(job_name, "master"),
            "ports": [{"port": port, "targetPort": port}],
            "type": service_type,
        },
    }


def render_job_manifests(manifests: List[dict]) -> str:
    """YAML multi-doc dump for `kubectl apply -f -` (yaml-dump mode)."""
    import yaml

    return "---\n".join(yaml.safe_dump(m, sort_keys=False) for m in manifests)


class K8sUnavailableError(RuntimeError):
    pass


def _load_k8s(force_kube_config: bool = False):
    try:
        from kubernetes import client, config, watch  # noqa: F401
    except ImportError as exc:
        raise K8sUnavailableError(
            "The 'kubernetes' package is not installed; use "
            "--distribution_strategy=Local or render manifests with "
            "render_job_manifests() and `kubectl apply`"
        ) from exc
    if force_kube_config:
        config.load_kube_config()
    else:
        try:
            config.load_incluster_config()
        except Exception:
            config.load_kube_config()
    return client, watch


class Client:
    """Pod/service create-delete-get-watch (reference k8s_client.py:51-500).

    All mutating methods take plain-dict manifests from the builders above.
    """

    def __init__(self, namespace: str = "default",
                 force_kube_config: bool = False):
        k8s_client, k8s_watch = _load_k8s(force_kube_config)
        self._core = k8s_client.CoreV1Api()
        self._watch_mod = k8s_watch
        self.namespace = namespace

    def create_pod(self, manifest: dict):
        return self._core.create_namespaced_pod(
            self.namespace, manifest
        )

    def delete_pod(self, name: str, grace_period_seconds: int = 0):
        from kubernetes.client.rest import ApiException

        try:
            return self._core.delete_namespaced_pod(
                name, self.namespace,
                grace_period_seconds=grace_period_seconds,
            )
        except ApiException as exc:
            if exc.status == 404:
                return None
            raise

    def get_pod(self, name: str):
        from kubernetes.client.rest import ApiException

        try:
            return self._core.read_namespaced_pod(name, self.namespace)
        except ApiException as exc:
            if exc.status == 404:
                return None
            raise

    def get_pod_log(self, name: str, tail_lines: int = 100) -> str:
        """Tail of a pod's log (job monitor failure reporting)."""
        from kubernetes.client.rest import ApiException

        try:
            return self._core.read_namespaced_pod_log(
                name, self.namespace, tail_lines=tail_lines
            )
        except ApiException as exc:
            return f"<no log: {exc.status}>"

    def create_service(self, manifest: dict):
        return self._core.create_namespaced_service(
            self.namespace, manifest
        )

    def delete_service(self, name: str):
        from kubernetes.client.rest import ApiException

        try:
            return self._core.delete_namespaced_service(
                name, self.namespace
            )
        except ApiException as exc:
            if exc.status == 404:
                return None
            raise

    def list_job_pods(self, job_name: str):
        selector = f"{ELASTICDL_JOB_KEY}={job_name}"
        return self._core.list_namespaced_pod(
            self.namespace, label_selector=selector
        ).items

    def watch_job_pods(self, job_name: str,
                       event_callback: Callable[[dict], None],
                       stop: Callable[[], bool] = lambda: False):
        """Stream pod events to ``event_callback`` until ``stop()``
        (reference k8s_client.py:110-124 watch thread)."""
        selector = f"{ELASTICDL_JOB_KEY}={job_name}"
        watcher = self._watch_mod.Watch()
        while not stop():
            try:
                for event in watcher.stream(
                    self._core.list_namespaced_pod,
                    self.namespace,
                    label_selector=selector,
                    timeout_seconds=60,
                ):
                    event_callback(event)
                    if stop():
                        return
            except Exception as exc:
                logger.warning("Pod watch stream error, retrying: %s", exc)
                time.sleep(1.0)

    def delete_job(self, job_name: str, force: bool = False):
        """Delete every pod and service of a job (`clean` subcommand).

        ``force`` keeps going past per-resource API errors so a partially
        broken job can still be reaped (`clean --force`)."""
        errors = []
        try:
            pods = self.list_job_pods(job_name)
        except Exception as exc:
            if not force:
                raise
            logger.warning("clean --force: list failed (%s)", exc)
            pods = []
        for pod in pods:
            try:
                self.delete_pod(pod.metadata.name)
            except Exception as exc:
                if not force:
                    raise
                errors.append(f"{pod.metadata.name}: {exc}")
        try:
            self.delete_service(get_master_service_name(job_name))
        except Exception as exc:
            if not force:
                raise
            errors.append(f"service: {exc}")
        for optional_service in (
            # Exist only for some job shapes (--tensorboard_log_dir /
            # host-tier models); delete_service no-ops on 404. Row
            # services are per-shard (shard 0 = legacy unsuffixed
            # name); sweeping a fixed shard range keeps `clean`
            # argument-free.
            get_tensorboard_service_name(job_name),
            *(
                get_row_service_service_name(job_name, shard)
                for shard in range(16)
            ),
        ):
            try:
                self.delete_service(optional_service)
            except Exception as exc:
                if not force:
                    raise
                errors.append(f"{optional_service}: {exc}")
        for err in errors:
            logger.warning("clean --force skipped error: %s", err)
