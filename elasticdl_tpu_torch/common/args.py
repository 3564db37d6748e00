"""The flags of the ``train``, ``evaluate``, ``predict``, ``master`` and
``worker`` roles (the subset of elasticdl_tpu/common/args.py that the
port's executors, ``master/main.py`` and ``worker/main.py`` read, with
the same names and defaults), plus ``--device``;
``build_arguments_from_parsed_result`` re-serializes parsed args into a
command line, as there.

The master's and worker's flags for parts that are not ported yet
(k8s, the autoscaler, the gang scheduler, streams, the prober) are
parsed so that asking for one raises with the ROADMAP item that holds
it.
"""

import argparse
from itertools import chain


def pos_int(value):
    res = int(value)
    if res <= 0:
        raise ValueError(f"Positive integer required, got {value}")
    return res


def non_neg_int(value):
    res = int(value)
    if res < 0:
        raise ValueError(f"Non-negative integer required, got {value}")
    return res


def pos_float(value):
    res = float(value)
    if res <= 0:
        raise ValueError(f"Positive float required, got {value}")
    return res


def str2bool(value):
    if isinstance(value, bool):
        return value
    if value.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if value.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError(f"Boolean value expected, got {value!r}")


def add_bool_param(parser, name, default, help_msg):
    parser.add_argument(
        name, type=str2bool, nargs="?", const=True, default=default,
        help=help_msg
    )


def add_common_params(parser):
    parser.add_argument(
        "--model_zoo", help="Directory containing user-defined model modules",
        required=True,
    )
    parser.add_argument(
        "--model_def",
        help="Model module path, e.g. transformer.transformer_lm."
             "custom_model",
        required=True,
    )
    parser.add_argument("--dataset_fn", default="dataset_fn")
    parser.add_argument("--loss", default="loss")
    parser.add_argument("--optimizer", default="optimizer")
    parser.add_argument("--eval_metrics_fn", default="eval_metrics_fn")
    parser.add_argument("--custom_data_reader", default="custom_data_reader")
    parser.add_argument("--callbacks", default="callbacks")
    parser.add_argument(
        "--distribution_strategy",
        default="Local",
        choices=["Local", "MeshStrategy", "ParameterServerStrategy",
                 "AllreduceStrategy"],
    )
    parser.add_argument("--data_reader_params", type=str, default="")
    parser.add_argument("--log_level", default="INFO",
                        choices=["DEBUG", "INFO", "WARNING", "ERROR"])
    parser.add_argument("--device", default=None,
                        help="cuda (default) or cpu; without a GPU the "
                             "CPU must be asked for")


def add_train_params(parser):
    parser.add_argument("--tensorboard_log_dir", default="")
    parser.add_argument("--num_epochs", type=pos_int, default=1)
    parser.add_argument("--training_data", default="")
    parser.add_argument("--validation_data", default="")
    parser.add_argument("--evaluation_steps", type=non_neg_int, default=0)
    parser.add_argument("--checkpoint_steps", type=non_neg_int, default=0)
    parser.add_argument("--checkpoint_dir", default="")
    parser.add_argument("--keep_checkpoint_max", type=non_neg_int, default=3)
    parser.add_argument("--checkpoint_delta_chain", type=non_neg_int,
                        default=0,
                        help="Max incremental delta checkpoints riding "
                             "one full base before a save compacts into "
                             "a fresh base (host-tier embedding rows "
                             "only; dense state always rides in full). "
                             "0 (default) = full snapshots only")
    parser.add_argument("--checkpoint_shards", type=pos_int, default=1,
                        help="Shard files per checkpoint version "
                             "(reference: one file per PS pod)")
    parser.add_argument("--checkpoint_dir_for_init", default="")
    parser.add_argument("--output", default="",
                        help="Export directory for the trained model")
    parser.add_argument("--minibatch_size", type=pos_int, required=True)
    parser.add_argument("--random_seed", type=non_neg_int, default=0)
    parser.add_argument("--max_steps", type=non_neg_int, default=0)
    parser.add_argument("--prefetch_depth", type=non_neg_int, default=2,
                        help="Background batch-decode queue depth "
                             "(0 disables prefetching)")


def add_evaluate_params(parser):
    parser.add_argument("--validation_data", default="", required=False)
    parser.add_argument("--checkpoint_dir_for_init", required=True)
    parser.add_argument("--minibatch_size", type=pos_int, required=True)
    parser.add_argument("--num_minibatches_per_task", type=pos_int, default=2)


def add_predict_params(parser):
    parser.add_argument("--prediction_data", required=True)
    parser.add_argument("--checkpoint_dir_for_init", required=True)
    parser.add_argument("--minibatch_size", type=pos_int, required=True)
    parser.add_argument("--num_minibatches_per_task", type=pos_int, default=2)


def add_task_plane_params(parser):
    """The master's and worker's flags beyond ``add_train_params``."""
    parser.add_argument("--job_name", default="elasticdl-tpu-job")
    parser.add_argument("--num_workers", type=pos_int, default=1)
    parser.add_argument("--master_addr", default="localhost:50001")
    parser.add_argument("--prediction_data", default="")
    parser.add_argument("--num_minibatches_per_task", type=pos_int, default=2)
    parser.add_argument("--evaluation_start_delay_secs", type=pos_int,
                        default=100)
    parser.add_argument("--evaluation_throttle_secs", type=non_neg_int,
                        default=0)
    parser.add_argument("--grads_to_wait", type=pos_int, default=1,
                        help="Gradient accumulation steps before an "
                             "apply under MeshStrategy")
    add_bool_param(parser, "--use_async", False,
                   "Async apply (staleness-modulated LR) instead of sync")
    parser.add_argument("--lr_staleness_modulation", type=str2bool,
                        nargs="?", const=True, default=False)
    parser.add_argument("--get_model_steps", type=pos_int, default=1,
                        help="Report every N-th model version to the "
                             "master")
    parser.add_argument("--mesh_shape", default="",
                        help="e.g. '4' or '2,2'; empty = every device "
                             "on the first axis")
    parser.add_argument("--mesh_axes", default="dp")
    parser.add_argument("--host_prefetch_depth", type=pos_int, default=2,
                        help="Host-tier row pull-ahead depth; must be "
                             ">= 1")
    add_bool_param(parser, "--fuse_task_steps", False,
                   "Run all of a task's minibatches in one multi-step "
                   "call")
    parser.add_argument("--task_timeout_secs", type=pos_float,
                        default=300.0)
    parser.add_argument("--master_reattach_grace", type=pos_float,
                        default=60.0,
                        help="Seconds a worker rides out an unreachable "
                             "master")
    parser.add_argument("--metrics_port", type=int, default=-1,
                        help="Master /metrics port; 0 = ephemeral, -1 "
                             "(default) disables")
    parser.add_argument("--flight_recorder", type=int, default=0,
                        help="Spans kept in the tracing ring; 0 = "
                             "tracing off")
    parser.add_argument("--metrics_report_secs", type=pos_float,
                        default=15.0,
                        help="Seconds between the worker's registry "
                             "snapshots on master RPCs")
    parser.add_argument("--metrics_ttl_secs", type=pos_float, default=None,
                        help="Age-out of a silent worker's metrics; "
                             "default 2 x task_timeout_secs")
    parser.add_argument("--master_admission_limit", type=int, default=0,
                        help="Concurrent master handlers before "
                             "priority shedding; 0 (default) = off")
    parser.add_argument("--usage_max_jobs", type=non_neg_int, default=0)
    parser.add_argument("--row_service_addr", default="",
                        help="Host-tier models: address (or comma list "
                             "of shard addresses) of the shared row "
                             "service (embedding/row_service.py); "
                             "needed with --num_workers > 1")
    parser.add_argument("--journal_dir", default="",
                        help="Master write-ahead job-state journal "
                             "directory: dispatch/report events + "
                             "periodic snapshots, replayed on master "
                             "restart so task accounting survives the "
                             "crash. Point at storage that outlives "
                             "the master; empty (default) disables")
    add_bool_param(parser, "--standby", False,
                   "Run this master as a HOT STANDBY: tail "
                   "--journal_dir into a continuously-replayed warm "
                   "state and heartbeat --primary_addr; on missed "
                   "heartbeats fence the old incarnation and take over "
                   "serving on --master_addr. Requires --journal_dir on "
                   "storage shared with the primary")
    parser.add_argument("--primary_addr", default="",
                        help="Standby role: the primary master address "
                             "to heartbeat (defaults to --master_addr)")
    parser.add_argument("--standby_heartbeat_secs", type=pos_float,
                        default=1.0,
                        help="Standby role: primary heartbeat cadence")
    parser.add_argument("--standby_miss_threshold", type=int, default=3,
                        help="Standby role: consecutive missed "
                             "heartbeats before takeover")
    # Not ported yet: each raises when asked for (master/main.py).
    parser.add_argument("--image_name", default="",
                        help="k8s: not ported yet (item 8d-iii)")
    add_bool_param(parser, "--autoscale", False,
                   "Autoscaling: not ported yet (item 8d-iii)")
    # Row-plane elasticity (master/row_reshard.py): the master runs the
    # shard-map authority over the --row_service_addr fleet.
    add_bool_param(parser, "--row_reshard", False,
                   "Run the row-service shard-map controller in the "
                   "master tick (needs --row_service_addr and "
                   "--row_reshard_state or --journal_dir; live range "
                   "rebalancing + "
                   "hot-row read replicas)")
    parser.add_argument("--row_reshard_state", default="",
                        help="Shard-map authority state file (default: "
                             "<journal_dir>/shard_map.json; required "
                             "when no --journal_dir is set)")
    parser.add_argument("--row_reshard_cooldown_secs", type=pos_float,
                        default=30.0,
                        help="Quiet period between reshard actions "
                             "(range moves / replica updates)")
    parser.add_argument("--row_replica_top_k", type=pos_int, default=64,
                        help="Hottest ids per table eligible for read "
                             "replication")
    parser.add_argument("--row_replica_count", type=non_neg_int,
                        default=2,
                        help="Read replicas per hot id (capped at "
                             "fleet size - 1; 0 disables replication)")
    add_bool_param(parser, "--row_pod_autoscale", False,
                   "Row-service pods grown and drained with splits and "
                   "merges: not ported yet (item 8d-iii)")
    add_bool_param(parser, "--sched", False,
                   "The gang scheduler: not ported yet (item 8d-ii)")
    parser.add_argument("--stream_dir", default="",
                        help="Streaming ingestion: not ported yet (item "
                             "8d-ii)")
    add_bool_param(parser, "--probes", False,
                   "Synthetic probing: not ported yet (item 8d-ii)")


def add_worker_params(parser):
    parser.add_argument("--worker_id", type=non_neg_int, required=True)
    # Multi-host meshes: not ported yet (worker/main.py raises).
    parser.add_argument("--num_jax_processes", type=pos_int, default=1,
                        help="Multi-host mesh: not ported yet")
    parser.add_argument("--coordinator_addr", default="",
                        help="Multi-host mesh: not ported yet")
    parser.add_argument("--jax_process_id", type=int, default=-1,
                        help="Multi-host mesh: not ported yet")


def _master_params(parser):
    add_train_params(parser)
    add_task_plane_params(parser)


def _worker_params(parser):
    _master_params(parser)
    add_worker_params(parser)


_ROLES = {"train": add_train_params, "evaluate": add_evaluate_params,
          "predict": add_predict_params, "master": _master_params,
          "worker": _worker_params}


def build_parser(role: str = "train") -> argparse.ArgumentParser:
    if role not in _ROLES:
        raise ValueError(
            f"role {role!r} not ported yet (ported: {', '.join(_ROLES)}; "
            "the clean role waits for k8s, ROADMAP Queue 1, item 8)")
    parser = argparse.ArgumentParser(prog=f"elasticdl_tpu_torch-{role}",
                                     allow_abbrev=False)
    add_common_params(parser)
    _ROLES[role](parser)
    return parser


def parse_master_args(args=None):
    return build_parser("master").parse_args(args=args)


def parse_worker_args(args=None):
    return build_parser("worker").parse_args(args=args)


def build_arguments_from_parsed_result(args, filter_args=None):
    """Reserialize parsed args back into a CLI list for spawning child
    processes (reference args.py build_arguments_from_parsed_result).

    None-valued optionals are SKIPPED, not stringified: an unset
    ``--metrics_ttl_secs`` (default None = "derive from
    task_timeout_secs") would otherwise re-serialize as the literal
    string "None", which the worker parser's ``pos_float`` rejects —
    omitting the flag reproduces the default-deriving behavior in the
    child process."""
    items = vars(args).items()
    if filter_args:
        items = filter(lambda kv: kv[0] not in filter_args, items)

    def _to_pair(key, value):
        if value is None:
            return []
        if isinstance(value, bool):
            return [f"--{key}", "true" if value else "false"]
        return [f"--{key}", str(value)]

    return list(chain.from_iterable(_to_pair(k, v) for k, v in items))
