"""``python -m elasticdl_tpu_torch {serve,train,evaluate,predict} ...``.

- ``serve``: the online inference server (serving/server.py).
- ``train``: a training job with ``--distribution_strategy Local``, run
  in-process by ``api/local_executor.LocalExecutor``; ``--checkpoint_dir``
  saves it, ``--checkpoint_dir_for_init`` resumes from a checkpoint.
- ``evaluate`` / ``predict``: a job booting from
  ``--checkpoint_dir_for_init`` that scores ``--validation_data`` or
  hands the predictions over ``--prediction_data`` to the zoo module's
  ``PredictionOutputsProcessor`` (``api/eval_predict_executor``).

Each runs on CUDA unless ``--device cpu``. Other strategies, and the JAX
CLI's other subcommands (route, chaos, trace, clean), are not ported
yet.
"""

import json
import sys

_PORTED = ("serve", "train", "evaluate", "predict")


def _run_local(role: str, argv) -> int:
    from elasticdl_tpu_torch.common.args import build_parser

    try:
        args = build_parser(role).parse_args(argv)
    except SystemExit as exc:  # argparse has printed the usage
        return int(exc.code or 0)
    if args.distribution_strategy != "Local":
        raise NotImplementedError(
            f"--distribution_strategy {args.distribution_strategy} is not "
            "ported yet (ported: Local)"
        )
    from elasticdl_tpu_torch.common.log_utils import get_logger

    logger = get_logger("client")
    if role == "train":
        from elasticdl_tpu_torch.api.local_executor import LocalExecutor

        result = LocalExecutor(args).run()
        logger.info("Job finished: %s", result)
        return 0
    # evaluate / predict only: boot from checkpoint, no training tasks
    # (reference scripts/client_test.sh evaluate/predict blocks).
    from elasticdl_tpu_torch.api.eval_predict_executor import (
        EvalPredictExecutor,
    )

    result = EvalPredictExecutor(args, role).run()
    logger.info("%s finished: %s", role, json.dumps(result))
    return 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(f"usage: python -m elasticdl_tpu_torch {{{','.join(_PORTED)}}}"
              " [options]")
        return 0 if argv else 2
    command, rest = argv[0], argv[1:]
    if command == "serve":
        from elasticdl_tpu_torch.serving.server import main as serve_main

        return serve_main(rest)
    if command in ("train", "evaluate", "predict"):
        return _run_local(command, rest)
    print(f"elasticdl_tpu_torch: subcommand {command!r} not yet ported "
          f"(ported: {', '.join(_PORTED)})", file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main())
