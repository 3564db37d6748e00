"""``python -m elasticdl_tpu_torch {serve,train} ...``.

- ``serve``: the online inference server (serving/server.py).
- ``train``: a training job with ``--distribution_strategy Local``, run
  in-process by ``api/local_executor.LocalExecutor`` on CUDA unless
  ``--device cpu``. Other strategies, and the JAX CLI's other
  subcommands (evaluate, predict, route, chaos, trace, clean), are not
  ported yet.
"""

import sys

_PORTED = ("serve", "train")


def _train(argv) -> int:
    from elasticdl_tpu_torch.common.args import build_parser

    try:
        args = build_parser("train").parse_args(argv)
    except SystemExit as exc:  # argparse has printed the usage
        return int(exc.code or 0)
    if args.distribution_strategy != "Local":
        raise NotImplementedError(
            f"--distribution_strategy {args.distribution_strategy} is not "
            "ported yet (ported: Local)"
        )
    from elasticdl_tpu_torch.api.local_executor import LocalExecutor
    from elasticdl_tpu_torch.common.log_utils import get_logger

    result = LocalExecutor(args).run()
    get_logger("client").info("Job finished: %s", result)
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
    if command == "train":
        return _train(rest)
    print(f"elasticdl_tpu_torch: subcommand {command!r} not yet ported "
          f"(ported: {', '.join(_PORTED)})", file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main())
