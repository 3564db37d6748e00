"""The flags of the ``train``, ``evaluate`` and ``predict`` roles (the
subset of elasticdl_tpu/common/args.py that ``api/local_executor.py``
and ``api/eval_predict_executor.py`` read, with the same names and
defaults), plus ``--device``."""

import argparse


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


_ROLES = {"train": add_train_params, "evaluate": add_evaluate_params,
          "predict": add_predict_params}


def build_parser(role: str = "train") -> argparse.ArgumentParser:
    if role not in _ROLES:
        raise ValueError(
            f"role {role!r} not ported yet (ported: {', '.join(_ROLES)}; "
            "the master, worker and clean roles wait for the worker's "
            "slice)")
    parser = argparse.ArgumentParser(prog=f"elasticdl_tpu_torch-{role}",
                                     allow_abbrev=False)
    add_common_params(parser)
    _ROLES[role](parser)
    return parser
