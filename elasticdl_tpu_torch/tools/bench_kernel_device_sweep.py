"""Device-time sweep of the port's embedding kernels against the library
routes, on one GPU.

    python -m elasticdl_tpu_torch.tools.bench_kernel_device_sweep \
        [--out PATH] [--iters 20] [--windows 5]

Port of tools/bench_kernel_device_sweep.py at its own tiers, over a
1,000,000-row f32 table:

- lookup at (D, L, B) in {(256, 32, 64), (256, 32, 512), (256, 64, 1024),
  (512, 64, 1024)}, sum combiner, weights 1: kernel #6
  (``lookup_combine_pallas``), kernel #5 (``lookup_combine_aligned``),
  the library route (``lookup_combine(force_xla=True)``: gather, then
  ``combine``) and ``torch.nn.functional.embedding_bag`` (one library
  call computing the same sums, a yardstick);
- Adagrad apply at n in {256, 4096, 16384} random ids (deduplicated,
  plus one pad): ``sparse_apply`` "always" (kernel #7) vs "never" (the
  library route);
- SGD and Momentum apply at the same n: "fused" (kernel #8) vs "never".

The table and slot state are threaded between calls in place (each call
updates the state the last one left, as the JAX tool donates it). Each
call takes the next of several id sets, enough that their rows exceed
the card's 50 MB L2 twice over, so rows come from HBM as in training.
Times are device time off ``torch.profiler`` (the kernels' own
durations, summed per call; medians over windows), never wall clock;
``bound_ms`` is the least time for the bytes the call must move (each
distinct row read once, each output or updated row written once) at the
H100's 3.35 TB/s. Prints one JSON row per tier and writes them, with the
card's name, to ``--out`` when given; it writes no other file.
"""

import argparse
import json
import math
from typing import Callable, List, Sequence

import numpy as np
import torch

VOCAB = 1_000_000
LOOKUP_TIERS = ((256, 32, 64), (256, 32, 512), (256, 64, 1024),
                (512, 64, 1024))
APPLY_ROWS = (256, 4096, 16384)
APPLY_DIM = 256
HBM_BYTES_PER_S = 3.35e12      # H100 SXM
F32_OPS_PER_S = 67e12
L2_BYTES = 50 * 2 ** 20


def device_ms(fn: Callable, iters: int = 20, windows: int = 5,
              warmup: int = 3):
    """Per-call device ms: the durations of every kernel and memset the
    calls launched, as ``torch.profiler`` records them on the card,
    summed over ``iters`` calls and divided by ``iters``; the median of
    ``windows`` such windows, and the windows. A call of these kernels
    takes tens of µs of host time to issue, more than the kernel takes
    on the card, so a CUDA-event window around back-to-back calls would
    time the host. A window in which the profiler recorded no device
    event at all is measured again (it happened to one tier of one run),
    up to ``3 * windows`` tries; fewer than half the windows then
    raises."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    times = []
    for _ in range(3 * windows):
        if len(times) == windows:
            break
        with torch.profiler.profile(activities=activities) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        spans = [evt.time_range.end - evt.time_range.start
                 for evt in prof.events()
                 if evt.device_type == torch.autograd.DeviceType.CUDA
                 and not getattr(evt, "is_user_annotation", False)]
        if spans:
            times.append(sum(spans) / 1e3 / iters)
    if 2 * len(times) < windows:
        raise RuntimeError(f"torch.profiler recorded device time in "
                           f"{len(times)} of {windows} windows")
    return float(np.median(times)), times


def cycling(fn: Callable, inputs: Sequence) -> Callable:
    """A no-argument callable running ``fn(*inputs[i])`` for i = 0, 1,
    2, ... round the list."""
    state = {"i": 0}

    def call():
        out = fn(*inputs[state["i"] % len(inputs)])
        state["i"] += 1
        return out

    return call


def sets_for(bytes_per_call: float) -> int:
    """How many input sets make the rows of a cycle exceed the L2 twice."""
    return int(min(64, max(2, math.ceil(2 * L2_BYTES / bytes_per_call))))


def _bound(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / F32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def lookup_bound(batch: int, num_ids: int, dim: int, distinct_rows: float):
    """Least time for one lookup on an H100: each distinct row read once,
    ids and weights read once, the (B, D) output written once."""
    return _bound(distinct_rows * dim * 4 + batch * num_ids * 8
                  + batch * dim * 4, 2.0 * batch * num_ids * dim)


def row_update_bound(rows: float, n: int, dim: int, slots: int):
    """Least time for one row update: each real row and its ``slots``
    slot rows read and written once, its gradient read once, the n ids
    read once."""
    return _bound(rows * dim * 4 * (2 * (1 + slots) + 1) + n * 4,
                  6.0 * rows * dim)


def uniform_table(vocab: int, dim: int, gen: torch.Generator):
    return torch.empty(vocab, dim, device="cuda").uniform_(
        -dim ** -0.5, dim ** -0.5, generator=gen)


def lookup_inputs(batch: int, num_ids: int, dim: int, gen):
    """Id sets (int32 on the card, weights 1) and their mean number of
    distinct rows."""
    count = sets_for(batch * num_ids * dim * 4)
    sets = []
    distinct = []
    for _ in range(count):
        ids = torch.randint(0, VOCAB, (batch, num_ids), generator=gen,
                            device="cuda", dtype=torch.int32)
        sets.append((ids, torch.ones(batch, num_ids, device="cuda")))
        distinct.append(torch.unique(ids).numel())
    return sets, float(np.mean(distinct))


def lookup_rows(pe, gen, iters: int, windows: int) -> List[dict]:
    rows = []
    for dim, num_ids, batch in LOOKUP_TIERS:
        table = uniform_table(VOCAB, dim, gen)
        sets, distinct = lookup_inputs(batch, num_ids, dim, gen)
        times = {}
        for name, fn in (
                ("kernel_ms", lambda i, w: pe.lookup_combine_pallas(
                    table, i, w, "sum")),
                ("aligned_ms", lambda i, w: pe.lookup_combine_aligned(
                    table, i, w, "sum")),
                ("route_ms", lambda i, w: pe.lookup_combine(
                    table, i, w, "sum", force_xla=True)),
                ("embedding_bag_ms", lambda i, w:
                 torch.nn.functional.embedding_bag(
                     i, table, per_sample_weights=w, mode="sum"))):
            times[name] = device_ms(cycling(fn, sets), iters, windows)[0]
        bound_ms, bound_by = lookup_bound(batch, num_ids, dim, distinct)
        row = {"dim": dim, "L": num_ids, "batch": batch, "vocab": VOCAB,
               "distinct_rows": distinct, "id_sets": len(sets), **times,
               "bound_ms": bound_ms, "bound_by": bound_by}
        print(json.dumps({"lookup": row}), flush=True)
        rows.append(row)
        del table, sets
        torch.cuda.empty_cache()
    return rows


def apply_inputs(n: int, dim: int, rng):
    """Id sets as ``sparse_apply`` gets them (sorted distinct ids and one
    pad, int32 on the card) with their gradients, and the mean number of
    real rows."""
    count = sets_for(n * dim * 4 * 5)
    sets, real = [], []
    for _ in range(count):
        ids = np.unique(rng.randint(0, VOCAB, n))
        real.append(ids.size)
        uids = torch.from_numpy(np.concatenate([ids, [VOCAB]]).astype(
            np.int32)).cuda()
        grads = torch.from_numpy(rng.randn(uids.numel(), dim).astype(
            np.float32)).cuda()
        sets.append((uids, grads))
    return sets, float(np.mean(real))


def apply_ms(opt, mode: str, sets, gen, iters: int, windows: int):
    from elasticdl_tpu_torch.embedding.optimizer import (
        init_slot_tables,
        sparse_apply,
    )

    table = uniform_table(VOCAB, APPLY_DIM, gen)
    slots = init_slot_tables(opt, VOCAB, APPLY_DIM, device="cuda")
    ms = device_ms(cycling(lambda i, g: sparse_apply(
        opt, table, slots, i, g, step=1, use_pallas=mode), sets),
        iters, windows)[0]
    del table, slots
    torch.cuda.empty_cache()
    return ms


def apply_rows(iters: int, windows: int, gen, rng):
    from elasticdl_tpu_torch.embedding.optimizer import SGD, Adagrad, Momentum

    adagrad, fused = [], []
    for n in APPLY_ROWS:
        sets, real = apply_inputs(n, APPLY_DIM, rng)
        for name, opt, mode, out in (
                ("adagrad", Adagrad(lr=0.05), "always", adagrad),
                ("sgd", SGD(lr=0.05), "fused", fused),
                ("momentum", Momentum(lr=0.05), "fused", fused)):
            kernel = apply_ms(opt, mode, sets, gen, iters, windows)
            route = apply_ms(opt, "never", sets, gen, iters, windows)
            bound_ms, bound_by = row_update_bound(
                real, n + 1, APPLY_DIM, len(opt.slot_names))
            row = {"opt": name, "mode": mode, "dim": APPLY_DIM, "rows": real,
                   "vocab": VOCAB, "id_sets": len(sets), "kernel_ms": kernel,
                   "route_ms": route, "bound_ms": bound_ms,
                   "bound_by": bound_by}
            print(json.dumps({"sparse_update": row}), flush=True)
            out.append(row)
    return adagrad, fused


def sweep(iters: int = 20, windows: int = 5, seed: int = 0) -> dict:
    """Every tier; returns the rows by section."""
    from elasticdl_tpu_torch.ops import pallas_embedding as pe

    if not torch.cuda.is_available():
        raise RuntimeError("bench_kernel_device_sweep needs a CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rng = np.random.RandomState(seed)
    lookup = lookup_rows(pe, gen, iters, windows)
    adagrad, fused = apply_rows(iters, windows, gen, rng)
    return {"device": torch.cuda.get_device_name(0),
            "method": "device time per call off torch.profiler (kernel "
                      "durations summed), median of windows; state "
                      "threaded in place; id sets rotated past the L2",
            "lookup": lookup, "sparse_update": adagrad,
            "fused_sparse_update": fused}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser("bench_kernel_device_sweep")
    parser.add_argument("--out", default="",
                        help="write the rows as JSON to this path")
    parser.add_argument("--iters", type=int, default=20)
    parser.add_argument("--windows", type=int, default=5)
    args = parser.parse_args(argv)
    result = sweep(args.iters, args.windows)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
