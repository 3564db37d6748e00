"""Worker process entry point (port of elasticdl_tpu/worker/main.py).

``python -m elasticdl_tpu_torch.worker.main --worker_id N --master_addr
H:P <flags>``: connect the master channel with retries, build the Worker
(with a MeshRunner over the port's one-card mesh when
``--distribution_strategy MeshStrategy``), pull tasks until the job
drains. It runs on CUDA unless ``--device cpu``; without a card and
without that flag it raises.

A host-tier model (``make_host_runner``) with ``--row_service_addr``
pulls and pushes its rows through a shared row service
(``embedding/row_service.py``); with ``--num_workers`` > 1 it needs one.

Under MeshStrategy a device-tier sparse model gets its runner with the
mesh (row-sharded tables), any other model a ``MeshRunner`` wired to its
zoo module's layout extras.

Several processes, one a card: ``--num_jax_processes N
--coordinator_addr host:port [--jax_process_id i]`` (the id defaults
to ``--worker_id``) wires ``torch.distributed`` before the zoo module is
imported (``parallel/multihost.py``); the process drives ``cuda:<i mod
cards>`` (``cuda:0`` where the host has one card), and the mesh of
``--mesh_shape`` spans the processes, each giving its share of the
entries. Such a job needs MeshStrategy. With ``--checkpoint_dir`` every
process holds a ``CheckpointHook(backend="orbax")``: the processes
write each version together, each its parts of the state
(``checkpoint/orbax_backend.py``, ``torch.distributed.checkpoint``),
and ``--checkpoint_dir_for_init`` (or a rolling directory that holds a
version) restores onto the job's layout. The gang restart that
relaunches every process on a membership change is not ported (ROADMAP
item 8d-iii). The XLA compilation cache and the step profiler have no
flag here.
"""

import os
import sys

import torch

from elasticdl_tpu_torch.common.args import parse_worker_args
from elasticdl_tpu_torch.common.constants import DistributionStrategy
from elasticdl_tpu_torch.common.device import resolve_device
from elasticdl_tpu_torch.common.log_utils import get_logger
from elasticdl_tpu_torch.common.timing import Timing
from elasticdl_tpu_torch.core.model_spec import get_model_spec
from elasticdl_tpu_torch.data.factory import (
    create_data_reader,
    parse_data_reader_params,
)
from elasticdl_tpu_torch.worker.worker import Worker

logger = get_logger("worker_main")


def refuse_shared_data(mesh, data_axis: str):
    """Raise where two processes of ``mesh`` share a coordinate of the
    data axis (``tp`` or ``sp`` across them): each worker pulls its own
    tasks from the master, so their halves of one global batch would be
    different tasks' records. The JAX worker assumes they are equal
    (``make_array_from_process_local_data``) and does nothing to make
    them so; the port refuses. Such a mesh runs through a
    ``MeshRunner`` fed the global batch's blocks (``place_batch``)."""
    if not getattr(mesh, "spans_processes", False):
        return
    blocks, _ = mesh.block_of(data_axis)
    if blocks < mesh.process_count:
        raise NotImplementedError(
            f"mesh {dict(mesh.shape)} over {mesh.process_count} processes "
            f"has {blocks} block(s) of the data axis {data_axis!r}: "
            "processes that share a data coordinate would pull different "
            "tasks into one batch (ROADMAP item 8); run tp or sp across "
            "processes through a MeshRunner fed the global batch")


def _init_multihost(args, device: torch.device) -> torch.device:
    """Wire ``torch.distributed`` for ``--num_jax_processes`` > 1 (the
    JAX worker's wiring, ``elasticdl_tpu/worker/main.py:55-71``) and
    return this process's device: ``cuda:<process id mod cards>``."""
    num_procs = getattr(args, "num_jax_processes", 1)
    if num_procs <= 1:
        return device
    from elasticdl_tpu_torch.parallel import multihost

    # The process id must be stable across relaunches (membership
    # changes restart the whole job from a checkpoint).
    process_id = getattr(args, "jax_process_id", -1)
    if process_id < 0:
        process_id = args.worker_id
    if process_id >= num_procs:
        raise ValueError(
            f"process id {process_id} out of range for {num_procs} "
            "processes: relaunches of a multi-host job must reuse the "
            "dead worker's process id (pass --jax_process_id)"
        )
    coordinator = multihost.coordinator_from_args(args)
    if args.distribution_strategy != DistributionStrategy.MESH:
        raise ValueError(
            "--num_jax_processes > 1 needs --distribution_strategy "
            "MeshStrategy: the processes train one model over one mesh")
    if device.type == "cuda":
        device = torch.device("cuda", process_id % torch.cuda.device_count())
    multihost.initialize_multihost(coordinator, num_procs, process_id,
                                   device=device)
    return device


def build_worker(args, master_client=None) -> Worker:
    """Assemble a Worker from parsed args (shared with tests)."""
    # Multi-host: wire torch.distributed BEFORE the user's zoo module is
    # imported below (it may build tensors at import time).
    device = _init_multihost(args,
                             resolve_device(getattr(args, "device", None)))
    # The model's initial weights come from --random_seed, as in the
    # Local executor: a worker and a Local run of the same records start
    # from the same weights. The draw leaves the caller's default
    # generator as it was.
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(args.random_seed)
        spec = get_model_spec(
            model_zoo=args.model_zoo,
            model_def=args.model_def,
            dataset_fn=args.dataset_fn,
            loss=args.loss,
            optimizer=args.optimizer,
            eval_metrics_fn=args.eval_metrics_fn,
            callbacks=args.callbacks,
            custom_data_reader=args.custom_data_reader,
            device=device,
        )
    reader_params = parse_data_reader_params(
        getattr(args, "data_reader_params", "")
    )
    data_origin = (
        getattr(args, "training_data", "")
        or getattr(args, "validation_data", "")
        or getattr(args, "prediction_data", "")
    )
    # An origin-less worker gets a record-file reader that fails at
    # first read, not at boot.
    reader = create_data_reader(
        data_origin=data_origin,
        custom_reader=spec.custom_data_reader,
        **reader_params,
    )
    step_runner = None
    if args.distribution_strategy == DistributionStrategy.MESH:
        from elasticdl_tpu_torch.parallel.mesh import (
            make_mesh,
            parse_mesh_args,
        )
        from elasticdl_tpu_torch.parallel.mesh_runner import (
            make_runner_for_spec,
        )

        from elasticdl_tpu_torch.parallel import multihost

        shape, axes = parse_mesh_args(args.mesh_shape, args.mesh_axes)
        # A process's entries are one device (its card, or the CPU) seen
        # as each of them; with several processes each gives its share
        # of the global shape.
        size = 1
        for n in shape or (1,):
            size *= n
        mesh = make_mesh(shape, axes,
                         [device] * max(1, size // multihost.process_count()))
        refuse_shared_data(mesh, "dp" if "dp" in mesh.shape else axes[0])
        if spec.make_sparse_runner is not None:
            # The device-tier sparse plane over the mesh: its tables
            # (and slots) row-shard over the first mesh axis, the dense
            # model runs the global batch with its optimizer replicated.
            import inspect

            params = inspect.signature(spec.make_sparse_runner).parameters
            accepts_mesh = "mesh" in params or any(
                p.kind is inspect.Parameter.VAR_KEYWORD
                for p in params.values())
            if not accepts_mesh:
                raise ValueError(
                    f"{args.model_def}: make_sparse_runner must accept "
                    "mesh=... to run under MeshStrategy")
            # The sparse step has no accumulation mode: refuse rather
            # than silently change the effective batch.
            if getattr(args, "grads_to_wait", 1) > 1 or (
                getattr(args, "use_async", False)
                and getattr(args, "lr_staleness_modulation", False)
            ):
                raise ValueError(
                    "device-tier sparse models do not support "
                    "--grads_to_wait > 1 or async staleness LR "
                    "modulation under MeshStrategy; the sparse step "
                    "applies each batch's row grads directly")
            step_runner = spec.make_sparse_runner(mesh=mesh, axis=axes[0])
        else:
            # Rebuilt for the mesh from the same seed: the same weights
            # (a mesh-aware model runs ring attention over sp).
            with torch.random.fork_rng(devices=[]):
                torch.manual_seed(args.random_seed)
                spec.model = spec.make_model(mesh)
            step_runner = make_runner_for_spec(
                spec,
                mesh,
                # grads_to_wait maps onto gradient accumulation before
                # the sync apply; async staleness LR modulation becomes
                # per-microbatch 1/staleness weighting.
                accum_steps=getattr(args, "grads_to_wait", 1),
                staleness_modulation=(
                    getattr(args, "use_async", False)
                    and getattr(args, "lr_staleness_modulation", False)
                ),
            )
    if spec.make_host_runner is not None:
        # Host-tier model (embedding/host_engine.py): the zoo module
        # supplies the runner holding its row stores.
        if step_runner is not None:
            raise ValueError(
                "host-tier models (make_host_runner) do not combine "
                "with MeshStrategy; use the default strategy"
            )
        row_addr = getattr(args, "row_service_addr", "")
        if row_addr:
            # Rows live behind the shared row service. Check the
            # signature up front: catching TypeError around the call
            # would also swallow TypeErrors raised inside the factory.
            import inspect

            params = inspect.signature(spec.make_host_runner).parameters
            accepts_remote = "remote_addr" in params or any(
                p.kind is inspect.Parameter.VAR_KEYWORD
                for p in params.values()
            )
            if not accepts_remote:
                raise ValueError(
                    f"{args.model_def}: make_host_runner must accept "
                    "remote_addr=... to run against --row_service_addr"
                )
            step_runner = spec.make_host_runner(remote_addr=row_addr)
        else:
            if getattr(args, "num_workers", 1) > 1:
                # Per-process tables would silently fork: each process
                # would train (and lose) its own rows.
                raise ValueError(
                    "host-tier models with num_workers > 1 need a shared "
                    "row service: start embedding.row_service and pass "
                    "--row_service_addr"
                )
            step_runner = spec.make_host_runner()
    if step_runner is None and spec.make_sparse_runner is not None:
        # Device-tier sparse model under the default strategy: the
        # single-device runner (tables on the card next to the model),
        # the same wiring LocalExecutor uses.
        step_runner = spec.make_sparse_runner()
    if master_client is None:
        from elasticdl_tpu_torch.worker.master_client import MasterClient

        master_client = MasterClient(
            args.master_addr, worker_id=args.worker_id
        )
    # Workload attribution (observability/principal.py): every RPC this
    # process makes meters under this identity. The job name comes
    # from the launcher's env; unset folds to "unknown".
    from elasticdl_tpu_torch.observability import principal as _principal

    _principal.set_process_principal(
        job=os.environ.get("ELASTICDL_JOB_NAME", ""),
        component="worker", purpose="training",
    )
    recorder_spans = int(getattr(args, "flight_recorder", 0) or 0)
    if recorder_spans > 0:
        # Tracing on: step-phase spans into the process ring; they
        # piggyback to the master on the same snapshot RPCs as metrics.
        from elasticdl_tpu_torch.observability import tracing

        tracing.set_process_role("worker", str(args.worker_id))
        tracing.install_recorder(
            tracing.FlightRecorder(recorder_spans)
        )
    checkpoint_hook = None
    # Single-host: one writer (worker 0) suffices, the state is the one
    # job's. Multi-host: EVERY process holds a hook; the orbax backend's
    # saves are written by all processes together (the worker calls
    # maybe_save at the same versions everywhere).
    from elasticdl_tpu_torch.parallel import multihost

    mesh_multihost = (
        args.distribution_strategy == DistributionStrategy.MESH
        and multihost.process_count() > 1
    )
    if getattr(args, "checkpoint_dir", "") and (
            args.worker_id == 0 or mesh_multihost):
        from elasticdl_tpu_torch.checkpoint import CheckpointHook

        checkpoint_hook = CheckpointHook(
            checkpoint_dir=args.checkpoint_dir,
            checkpoint_steps=getattr(args, "checkpoint_steps", 0),
            num_shards=getattr(args, "checkpoint_shards", 1) or 1,
            keep_max=getattr(args, "keep_checkpoint_max", 3),
            # Mesh multi-host only: no process holds every leaf; each
            # writes its parts. Other strategies keep the native saver.
            backend="orbax" if mesh_multihost else "native",
            host_tables=getattr(step_runner, "host_tables", None),
            delta_chain_max=(
                0 if mesh_multihost
                else getattr(args, "checkpoint_delta_chain", 0)
            ),
        )
    from elasticdl_tpu_torch.callbacks import (
        ensure_saved_model_exporter,
        set_callback_parameters,
    )

    callbacks = ensure_saved_model_exporter(
        spec.callbacks_fn() if spec.callbacks_fn else [],
        getattr(args, "output", ""),
    )
    set_callback_parameters(
        callbacks,
        batch_size=args.minibatch_size,
        epochs=getattr(args, "num_epochs", 1),
    )
    return Worker(
        worker_id=args.worker_id,
        master_client=master_client,
        model_spec=spec,
        data_reader=reader,
        minibatch_size=args.minibatch_size,
        step_runner=step_runner,
        # SSP mapping: the master observes every N-th version only.
        version_report_steps=getattr(args, "get_model_steps", 1),
        prediction_outputs_processor=spec.prediction_outputs_processor,
        callbacks=callbacks,
        # Worker.__init__ publishes this into the process registry
        # (phase histograms on /metrics), which also enables measuring.
        timing=Timing(args.log_level.upper() == "DEBUG"),
        checkpoint_hook=checkpoint_hook,
        fuse_task_steps=getattr(args, "fuse_task_steps", False),
        prefetch_depth=getattr(args, "prefetch_depth", 2),
        host_prefetch_depth=getattr(args, "host_prefetch_depth", 2),
        metrics_report_secs=getattr(args, "metrics_report_secs", 15.0),
        master_reattach_grace=getattr(
            args, "master_reattach_grace", 60.0
        ),
        random_seed=args.random_seed,
        **resolve_init_checkpoint(args),
    )


def resolve_init_checkpoint(args) -> dict:
    """Pick the restore source for a booting worker.

    Priority: the job's rolling --checkpoint_dir when it already holds a
    valid version (a relaunch mid-job resumes the latest state), else
    the user's --checkpoint_dir_for_init (warm start / transfer —
    restore REQUIRED: a bad dir must fail loudly, not train from
    scratch), else fresh init.
    """
    rolling = getattr(args, "checkpoint_dir", "")
    user_init = getattr(args, "checkpoint_dir_for_init", "")
    if rolling:
        from elasticdl_tpu_torch.checkpoint.hooks import has_valid_checkpoint

        if has_valid_checkpoint(rolling):
            return {
                "checkpoint_dir_for_init": rolling,
                "checkpoint_init_required": True,
            }
    return {
        "checkpoint_dir_for_init": user_init,
        "checkpoint_init_required": bool(user_init),
    }


def main(argv=None):
    args = parse_worker_args(argv)
    worker = build_worker(args)
    # k8s sends SIGTERM ahead of the KILL: stop at the next task
    # boundary, checkpoint the freshest state, hand the task back.
    import signal

    signal.signal(
        signal.SIGTERM, lambda signum, frame: worker.request_stop()
    )
    result = worker.run()
    logger.info("Worker %d done: %s", args.worker_id, result)
    from elasticdl_tpu_torch.parallel import multihost

    multihost.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
