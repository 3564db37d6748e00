"""The flags of the ``train``, ``evaluate``, ``predict``, ``clean``,
``master`` and ``worker`` roles (the subset of
elasticdl_tpu/common/args.py that the port's executors, the CLI
(``api/client.py``), ``master/main.py`` and ``worker/main.py`` read,
with the same names and defaults), plus ``--device``;
``build_arguments_from_parsed_result`` re-serializes parsed args into a
command line, as there, and ``parse_envs`` reads ``k=v`` lists.

The k8s plane's flags (``add_k8s_params``) ride every role but
``clean``: a ``train`` with another strategy than Local hands its whole
command line to the master pod, and the master hands its own to the
worker pods.
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


def parse_envs(arg):
    """Parse ``key1=val1,key2=val2`` into a dict (reference args.py:61-87)."""
    envs = {}
    if not arg:
        return envs
    for kv in arg.split(","):
        kv = kv.strip()
        if not kv:
            continue
        if "=" not in kv:
            raise ValueError(f"Malformed env entry {kv!r}; expected k=v")
        key, _, value = kv.partition("=")
        envs[key.strip()] = value.strip()
    return envs


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


def add_k8s_params(parser):
    """The job's identity and its pods (JAX's ``add_common_params`` k8s
    part): the master pod's manifest, the worker and row-service pods the
    instance manager creates, and ``--wait`` on the submitted job."""
    parser.add_argument("--job_name", default="elasticdl-tpu-job")
    parser.add_argument("--envs", type=str, default="",
                        help="Runtime environment variables, k1=v1,k2=v2")
    parser.add_argument("--image_name", default="",
                        help="Container image for spawned pods")
    parser.add_argument("--namespace", default="default")
    parser.add_argument("--num_workers", type=pos_int, default=1)
    parser.add_argument("--worker_resource_request",
                        default="cpu=1,memory=4096Mi")
    parser.add_argument("--worker_resource_limit", default="")
    parser.add_argument("--master_resource_request",
                        default="cpu=0.1,memory=1024Mi")
    parser.add_argument("--master_resource_limit", default="")
    parser.add_argument("--volume", default="")
    parser.add_argument("--restart_policy", default="Never")
    parser.add_argument("--master_addr", default="localhost:50001")
    parser.add_argument("--docker_image_repository", default="")
    add_bool_param(parser, "--force_use_kube_config_file", False,
                   "Use kube config file instead of in-cluster config")
    add_bool_param(parser, "--wait", False,
                   "After submitting to k8s, poll the job to completion "
                   "(exit 0 on master Succeeded) — reference "
                   "k8s_job_monitor semantics")
    add_bool_param(parser, "--wait_unknown_ok", False,
                   "With --wait: treat a master pod that vanishes while "
                   "Running as completed (clusters that GC finished pods "
                   "between polls); default treats it as not-success")


def add_clean_params(parser):
    add_bool_param(parser, "--force", False, "Force-delete job resources")
    parser.add_argument("--job_name", default="")
    parser.add_argument("--namespace", default="default")
    add_bool_param(parser, "--force_use_kube_config_file", False,
                   "Use kube config file instead of in-cluster config")


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
    # SLO engine (observability/timeseries.py + slo.py): the master
    # samples its telemetry into a bounded time-series store each run
    # tick, evaluates the SLO rules on it, and serves /timeseries and
    # /alerts next to /metrics.
    parser.add_argument("--timeseries_secs", type=float, default=5.0,
                        help="Master time-series sampling cadence "
                             "(seconds); 0 disables the store, the SLO "
                             "engine, and the /timeseries + /alerts "
                             "endpoints")
    parser.add_argument("--slo_rules", default="",
                        help="JSON SLO rule file; empty = the built-in "
                             "default rules")
    parser.add_argument("--incident_dir", default="",
                        help="Write a black-box incident bundle here "
                             "(flight-recorder trace, time-series "
                             "window, critical-path attribution, "
                             "journal tail) whenever an SLO rule "
                             "starts firing; empty (default) disables "
                             "capture")
    # The worker's step-window trace (utils/profiler.py).
    parser.add_argument("--profile_dir", default="",
                        help="Write a torch.profiler Chrome trace (CPU "
                             "and CUDA activities) of a step window "
                             "here")
    parser.add_argument("--profile_start_step", type=non_neg_int,
                        default=5)
    parser.add_argument("--profile_steps", type=pos_int, default=5)
    # Continuous profiling (observability/profiler.py): a sampling
    # profiler whose flame-table windows ride the metrics piggyback
    # into the master's /profile endpoint.
    parser.add_argument("--profile_hz", type=float, default=0.0,
                        help="Sampling-profiler rate (Hz) for master "
                             "and workers; flame-table windows serve on "
                             "the master's /profile endpoint; 0 "
                             "(default) = off")
    parser.add_argument("--profile_window_secs", type=pos_float,
                        default=10.0,
                        help="Sampling-profiler window length: stacks "
                             "fold per window, windows ride the "
                             "metrics piggyback to the master")
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
    # Several processes over one mesh (worker/main.py): the master reads
    # the count to give each worker pod a stable process id.
    parser.add_argument("--num_jax_processes", type=pos_int, default=1,
                        help=">1 wires torch.distributed across worker "
                             "processes (one mesh over the processes)")
    parser.add_argument("--coordinator_addr", default="",
                        help="torch.distributed rendezvous host:port "
                             "(required when num_jax_processes > 1)")
    parser.add_argument("--jax_process_id", type=int, default=-1,
                        help="Stable process id; -1 = use worker_id. "
                             "Elastic relaunches must reuse the dead "
                             "worker's id")
    # Row-service pods (master/main.py _row_service_command): the master
    # launches them for host-tier models whose zoo module defines
    # make_row_service.
    parser.add_argument("--num_row_service_shards", type=pos_int,
                        default=1,
                        help="Row-service shard pods (reference "
                             "--num_ps_pods): rows live by id %% N, one "
                             "stable Service + pod per shard, each with "
                             "its own checkpoint subdir (max 16)")
    parser.add_argument("--row_service_resource_request",
                        default="cpu=1,memory=4096Mi",
                        help="Resources for the row-service pod (the "
                             "reference's --ps_resource_request role); "
                             "CPU-only, independent of worker sizing")
    parser.add_argument("--row_service_resource_limit", default="")
    parser.add_argument("--row_service_checkpoint_steps", type=non_neg_int,
                        default=0,
                        help="Checkpoint interval for the row service, in "
                             "gradient PUSHES (its version unit). 0 = "
                             "derive from --checkpoint_steps scaled by "
                             "num_workers")
    parser.add_argument("--row_service_push_log",
                        choices=["durable", "applied", "off"],
                        default="durable",
                        help="Write-ahead push log mode for launched "
                             "row-service pods (with --checkpoint_dir): "
                             "durable (default, acked-push RPO=0), "
                             "applied (RPO = one group window), off")
    parser.add_argument("--row_service_push_log_group_ms", type=float,
                        default=2.0,
                        help="Group-commit window for the row-service "
                             "push log")
    parser.add_argument("--row_service_admission_limit", type=int,
                        default=0,
                        help="Priority admission control on launched "
                             "row-service pods; 0 (default) = off")
    parser.add_argument("--row_service_push_durable_wait_secs",
                        type=float, default=60.0,
                        help="Ceiling on the row-service durable-ack "
                             "fsync wait")
    # Closed-loop elastic autoscaling (master/autoscaler.py): queue
    # depth, worker step utilization and p99 straggler attribution grow
    # and shrink the worker fleet between the bounds.
    add_bool_param(parser, "--autoscale", False,
                   "Enable the master's closed-loop autoscaler "
                   "(k8s mode: scales worker pods between "
                   "--autoscale_min_workers/--autoscale_max_workers)")
    parser.add_argument("--autoscale_min_workers", type=pos_int,
                        default=1)
    parser.add_argument("--autoscale_max_workers", type=non_neg_int,
                        default=0,
                        help="0 = use --num_workers as the ceiling")
    parser.add_argument("--autoscale_cooldown_secs", type=pos_float,
                        default=60.0,
                        help="Quiet period after any scale decision")
    parser.add_argument("--autoscale_hysteresis_ticks", type=pos_int,
                        default=3,
                        help="Consecutive agreeing poll ticks required "
                             "before a decision fires")
    parser.add_argument("--autoscale_up_backlog_factor", type=pos_float,
                        default=2.0,
                        help="Scale up when todo depth exceeds this "
                             "many tasks per live worker (and workers "
                             "are saturated)")
    parser.add_argument("--autoscale_up_utilization", type=pos_float,
                        default=0.7,
                        help="Minimum mean worker_step_utilization for "
                             "scale-up")
    parser.add_argument("--autoscale_down_utilization", type=pos_float,
                        default=0.3,
                        help="Scale down when the queue is empty and "
                             "mean utilization sits below this")
    add_bool_param(parser, "--autoscale_from_timeseries", False,
                   "Feed the autoscaler the mean worker utilization "
                   "over --autoscale_trend_window_secs from the "
                   "time-series store (requires --timeseries_secs "
                   "> 0)")
    parser.add_argument("--autoscale_trend_window_secs", type=pos_float,
                        default=120.0,
                        help="Trailing window for the time-series-"
                             "backed utilization signal")
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
                   "Close the split/merge pod loop (master/"
                   "autoscaler.py RowServicePodScaler): grow spawns a "
                   "row-service pod before splitting onto it, and a "
                   "merged-away pod drains once the shard-map "
                   "controller retires its slot (needs --row_reshard "
                   "and k8s)")
    # Multi-tenant gang scheduling (master/scheduler.py): many jobs on
    # one fleet, the job table event-sourced onto --journal_dir.
    add_bool_param(parser, "--sched", False,
                   "Run the multi-job gang scheduler in the master "
                   "(submit_job RPC + /sched endpoint; job table "
                   "event-sources onto --journal_dir and survives "
                   "failover)")
    # Streaming ingestion (master/stream_ingest.py + data/stream.py):
    # online learning from an append-only record stream.
    parser.add_argument("--stream_dir", default="",
                        help="Directory of *.edlstream append-only "
                             "partitions (data/stream.py). Non-empty "
                             "switches the dispatcher to streaming "
                             "mode: unbounded offset-ranged tasks, "
                             "journaled watermarks, watermark-"
                             "triggered eval, /stream endpoint")
    parser.add_argument("--stream_max_todo", type=pos_int, default=64,
                        help="Backpressure bound: stop generating "
                             "stream tasks while the todo queue holds "
                             "this many (stream_ingest_backpressure_"
                             "seconds meters the stall)")
    parser.add_argument("--stream_eval_every_records", type=non_neg_int,
                        default=0,
                        help="Open an eval round each time this many "
                             "stream records commit past the watermark "
                             "(replaces epoch-end eval in streaming "
                             "mode; 0 disables)")
    parser.add_argument("--stream_poll_secs", type=pos_float,
                        default=0.5,
                        help="Stream tail poll + pump cadence")
    # Synthetic probing (observability/prober.py): black-box canary
    # probes against the reserved top-of-int64 id range, served at
    # /probes; /healthz becomes the aggregated probe verdict (200/503).
    add_bool_param(parser, "--probes", False,
                   "Run the synthetic canary prober inside the master "
                   "(dispatch/row/stream probes auto-wire from the "
                   "matching flags; serving needs "
                   "--probe_serving_addr)")
    parser.add_argument("--probe_interval_secs", type=pos_float,
                        default=15.0,
                        help="Cadence for each registered probe")
    parser.add_argument("--probe_serving_addr", default="",
                        help="host:port of a serving router; non-empty "
                             "registers the serving_freshness probe "
                             "(canary push -> prediction change)")
    parser.add_argument("--probe_serving_feature_key", default="",
                        help="Sparse feature key the serving_freshness "
                             "probe queries with a canary id (empty = "
                             "'ids')")


def add_worker_params(parser):
    parser.add_argument("--worker_id", type=non_neg_int, required=True)


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
    parser = argparse.ArgumentParser(prog=f"elasticdl_tpu_torch-{role}",
                                     allow_abbrev=False)
    if role == "clean":
        add_clean_params(parser)
        return parser
    if role not in _ROLES:
        raise ValueError(f"Unknown role {role}")
    add_common_params(parser)
    add_k8s_params(parser)
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
