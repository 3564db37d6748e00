"""Where a Local train step spends its device time, on one GPU.

    python -m elasticdl_tpu_torch.tools.profile_training [--batch 8]
        [--seq 1024] [--iters 5]
    python -m elasticdl_tpu_torch.tools.profile_training --model recsys
        [--batch 512] [--iters 5]

``--model transformer`` (the default) builds the transformer-LM
flagship (bench_suite.py ``_TRANSFORMER_SIZES["transformer"]``, vocab
32768, bf16, remat off, dropout 0) with seeded random weights and the
zoo twin's Adam 1e-3 and runs ``core.step.build_train_step`` on seeded
random token batches. ``--model recsys`` builds the recsys ranker twin
at full width (1,000,000 x 256 table, 32 ids an example) and runs its
sparse runner's step with the kernels pinned (``use_pallas="always"``)
on seeded random id batches.

Either way it times ``--iters`` steps with CUDA events beside the
host's time to issue them, then runs ``--iters`` steps under
``torch.profiler`` and prints one JSON line: the device time per step
(the union of kernel intervals; user annotations such as
``Optimizer.step`` are not kernels and are left out), its share of the
unprofiled step time (the profiler slows the host, so its own window
would understate the share), and the device time per step summed by
kernel name (largest first).
"""

import argparse
import json
import time

import numpy as np
import torch

from elasticdl_tpu_torch import bridge
from elasticdl_tpu_torch.core.step import build_train_step
from elasticdl_tpu_torch.core.train_state import init_train_state
from elasticdl_tpu_torch.model_zoo.transformer import transformer_lm
from elasticdl_tpu_torch.models.transformer import (
    TransformerConfig,
    TransformerLM,
)
from elasticdl_tpu_torch.tools.profile_serving import FLAGSHIP, _union_us


def _transformer(batch, seq):
    cfg = TransformerConfig(**FLAGSHIP, compute_dtype=torch.bfloat16)
    model = TransformerLM(cfg)
    model.load_state_dict(bridge.state_dict_from_flax(
        bridge.init_flax_params(cfg, seed=0)))
    state = init_train_state(model.cuda(), transformer_lm.optimizer(),
                             seed=0)
    rng = np.random.default_rng(0)
    batches = []
    for _ in range(2):
        tokens = rng.integers(0, cfg.vocab_size,
                              (batch, seq + 1)).astype(np.int32)
        batches.append({"features": tokens[:, :-1],
                        "labels": tokens[:, 1:],
                        "mask": np.ones(batch, np.float32)})
    return state, build_train_step(transformer_lm.loss), batches


def _recsys(batch):
    from elasticdl_tpu_torch.model_zoo.recsys import recsys_sparse

    torch.manual_seed(0)
    runner = recsys_sparse.make_sparse_runner(use_pallas="always")
    rng = np.random.default_rng(0)
    batches = []
    for _ in range(8):   # fresh ids each step, as a training stream has
        ids = rng.integers(0, recsys_sparse.VOCAB,
                           (batch, recsys_sparse.INPUT_LENGTH))
        batches.append({"features": {recsys_sparse.FEATURE_KEY: ids},
                        "labels": (ids.sum(axis=1) % 2).astype(np.int32),
                        "mask": np.ones(batch, np.float32)})
    state = runner.init_state(recsys_sparse.custom_model(device="cuda"),
                              recsys_sparse.optimizer(), batches[0], seed=0)
    return state, runner.train_step(recsys_sparse.loss), batches


def main(argv=None) -> int:
    parser = argparse.ArgumentParser("profile_training")
    parser.add_argument("--model", choices=("transformer", "recsys"),
                        default="transformer")
    parser.add_argument("--batch", type=int, default=None,
                        help="8 (transformer) or 512 (recsys)")
    parser.add_argument("--seq", type=int, default=1024)
    parser.add_argument("--iters", type=int, default=5)
    parser.add_argument("--top", type=int, default=16)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_training needs a CUDA device")
    if args.model == "recsys":
        args.batch = args.batch or 512
        state, step, batches = _recsys(args.batch)
        shape = [args.batch, 32]
    else:
        args.batch = args.batch or 8
        state, step, batches = _transformer(args.batch, args.seq)
        shape = [args.batch, args.seq]

    def run(n):
        for i in range(n):
            step(state, batches[i % len(batches)])

    run(3)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    run(args.iters)
    end.record()
    issue_ms = (time.perf_counter() - t0) * 1e3 / args.iters
    torch.cuda.synchronize()
    step_ms = start.elapsed_time(end) / args.iters

    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        run(args.iters)
        torch.cuda.synchronize()

    kernels = {}
    intervals = []
    for evt in prof.events():
        if (evt.device_type != torch.autograd.DeviceType.CUDA
                or getattr(evt, "is_user_annotation", False)):
            continue
        span = (evt.time_range.start, evt.time_range.end)
        intervals.append(span)
        kernels[evt.name] = kernels.get(evt.name, 0.0) + span[1] - span[0]
    busy_us = _union_us(intervals)
    ranked = sorted(kernels.items(), key=lambda kv: -kv[1])
    print(json.dumps({
        "device": torch.cuda.get_device_name(0),
        "model": args.model, "shape": shape, "step_ms": step_ms,
        "issue_ms": issue_ms,
        "device_events_per_step": len(intervals) / args.iters,
        "device_ms_per_step": busy_us / args.iters / 1e3,
        "device_share_of_step": busy_us / args.iters / 1e3 / step_ms,
        "kernels_ms_per_step": [
            {"name": name[:120], "ms": us / args.iters / 1e3,
             "share": us / busy_us if busy_us else None}
            for name, us in ranked[:args.top]
        ],
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
