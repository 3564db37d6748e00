"""The ``elasticdl_tpu_torch`` CLI (port of elasticdl_tpu/api/client.py;
reference elasticdl/python/elasticdl/client.py + api.py): ``train |
evaluate | predict | serve | route | chaos | trace | clean``.

- ``--distribution_strategy=Local``: run the whole job in-process via
  LocalExecutor (or, for ``evaluate``/``predict``, EvalPredictExecutor)
  on CUDA unless ``--device cpu`` (reference api.py:20-23).
- otherwise: submit to kubernetes — create the master pod (``python -m
  elasticdl_tpu_torch.master.main`` with the job's flags), its Service
  and, with ``--tensorboard_log_dir``, the TensorBoard Service; the
  master creates everything else (reference api.py:175-216). Without the
  ``kubernetes`` package the manifests are printed for ``kubectl apply
  -f -``. ``--wait`` polls the master pod to its end (``JobMonitor``).
- ``serve``: the online inference server (serving/server.py).
- ``route``: the serving fleet's router (serving/router.py).
- ``clean``: delete every pod/service of a job (reference
  ``elasticdl clean``); 2 without the ``kubernetes`` package.
- ``trace``: a traced in-process job exported as Perfetto JSON, with
  its critical-path report (observability/trace_export.py).
- ``chaos``: the chaos harness's ``run``/``soak``
  (chaos/runner.py), on CUDA unless ``--device cpu``.
"""

import json
import sys

from elasticdl_tpu_torch.common.args import (
    build_arguments_from_parsed_result,
    build_parser,
    parse_envs,
)
from elasticdl_tpu_torch.common.log_utils import get_logger
from elasticdl_tpu_torch.platform.k8s_client import (
    MASTER_PORT,
    K8sUnavailableError,
    build_master_service_manifest,
    build_pod_manifest,
    get_master_pod_name,
    render_job_manifests,
)

logger = get_logger("client")

_SUBCOMMANDS = ("train", "evaluate", "predict", "serve", "route",
                "chaos", "trace", "clean")


def _master_manifests(args, mode: str):
    """Pod + service manifests for the master (reference api.py:175-216)."""
    passthrough = build_arguments_from_parsed_result(
        args, filter_args=["force"]
    )
    command = (
        ["python", "-m", "elasticdl_tpu_torch.master.main"] + passthrough
    )
    pod = build_pod_manifest(
        name=get_master_pod_name(args.job_name),
        job_name=args.job_name,
        replica_type="master",
        image=args.image_name,
        command=command,
        namespace=args.namespace,
        resource_request=args.master_resource_request,
        resource_limit=args.master_resource_limit,
        volume=args.volume,
        envs=parse_envs(args.envs),
        restart_policy=args.restart_policy,
    )
    service = build_master_service_manifest(
        args.job_name, namespace=args.namespace, port=MASTER_PORT
    )
    manifests = [pod, service]
    if getattr(args, "tensorboard_log_dir", ""):
        # External TB endpoint over the master's tensorboard subprocess
        # (reference api.py wires k8s_tensorboard_client when
        # --tensorboard_log_dir is set).
        from elasticdl_tpu_torch.platform.k8s_client import (
            build_tensorboard_service_manifest,
        )

        manifests.append(build_tensorboard_service_manifest(
            args.job_name, namespace=args.namespace
        ))
    return manifests


def _submit_job(args, mode: str) -> int:
    manifests = _master_manifests(args, mode)
    try:
        from elasticdl_tpu_torch.platform.k8s_client import Client

        client = Client(
            namespace=args.namespace,
            force_kube_config=args.force_use_kube_config_file,
        )
    except K8sUnavailableError:
        print(render_job_manifests(manifests))
        logger.warning(
            "kubernetes package unavailable — printed manifests instead; "
            "apply with: kubectl apply -f -"
        )
        return 0
    client.create_pod(manifests[0])
    for service in manifests[1:]:
        client.create_service(service)
    logger.info(
        "Submitted job %s (master pod %s)",
        args.job_name, manifests[0]["metadata"]["name"],
    )
    if getattr(args, "wait", False):
        from elasticdl_tpu_torch.platform.job_monitor import JobMonitor

        ok = JobMonitor(
            client, args.job_name,
            unknown_ok=getattr(args, "wait_unknown_ok", False),
        ).wait()
        return 0 if ok else 1
    return 0


def _run_local(args, mode: str) -> int:
    if mode == "train":
        from elasticdl_tpu_torch.api.local_executor import LocalExecutor

        result = LocalExecutor(args).run()
        logger.info("Job finished: %s", result)
        return 0
    # evaluate / predict only: boot from checkpoint, no training tasks
    # (reference scripts/client_test.sh evaluate/predict blocks).
    from elasticdl_tpu_torch.api.eval_predict_executor import (
        EvalPredictExecutor,
    )

    result = EvalPredictExecutor(args, mode).run()
    logger.info("%s finished: %s", mode, json.dumps(result))
    return 0


def _clean(args) -> int:
    if not args.job_name:
        logger.error("clean requires --job_name")
        return 2
    try:
        from elasticdl_tpu_torch.platform.k8s_client import Client

        Client(
            namespace=args.namespace,
            force_kube_config=args.force_use_kube_config_file,
        ).delete_job(args.job_name, force=args.force)
    except K8sUnavailableError as exc:
        logger.error("clean needs the kubernetes package: %s", exc)
        return 2
    return 0


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] not in _SUBCOMMANDS:
        print(
            "usage: elasticdl_tpu_torch "
            "{train|evaluate|predict|serve|route|chaos|trace|clean} "
            "<flags>",
            file=sys.stderr,
        )
        return 2
    mode, rest = argv[0], argv[1:]
    if mode == "serve":
        # The serving plane has its own flag surface (bundle dir,
        # batching knobs) and no job/k8s context — dispatch directly.
        from elasticdl_tpu_torch.serving.server import main as serve_main

        return serve_main(rest)
    if mode == "route":
        # Fleet front-end over N serve replicas: routing policies,
        # request hedging, tiered shedding.
        from elasticdl_tpu_torch.serving.router import main as route_main

        return route_main(rest)
    if mode == "trace":
        # Distributed-tracing demo/smoke: traced in-process job →
        # Perfetto JSON + the critical-path report.
        from elasticdl_tpu_torch.observability.trace_export import (
            main as trace_main,
        )

        return trace_main(rest)
    if mode == "chaos":
        # Fault-injection harness: runs against the in-process cluster,
        # no job/k8s context — dispatch directly.
        from elasticdl_tpu_torch.chaos.runner import main as chaos_main

        return chaos_main(rest)
    try:
        args = build_parser(mode).parse_args(rest)
    except SystemExit as exc:  # argparse has printed the usage
        return int(exc.code or 0)
    if mode == "clean":
        return _clean(args)
    if args.distribution_strategy == "Local":
        return _run_local(args, mode)
    return _submit_job(args, mode)
