"""Where a tiered pull's host time goes: one process, no RPC, no card.

A ``TieredTable`` over the native store at the recsys shape (1,000,000 x
256 rows materialised through a 100,000-row hot tier by default), then
``chip_smoke.py`` (g)'s schedule (batches of 16,384 ids from a working
set of 65,536 rows, 64 strangers, 4,096 rows replaced every 5 batches),
each batch pulled as the row service's handler pulls it (``prefault``,
``get`` with the sweep deferred, ``maybe_sweep``). The first half of the
batches warms the working set; the second half runs under ``cProfile``.
Prints one JSON line: ms a pull, and the cumulative seconds of the tier's
functions (the sweep, its victim buffer, faults, demotions, cold reads
and writes) over the profiled pulls.

    python -m elasticdl_tpu_torch.tools.profile_tier_sweep [--vocab N]
        [--budget N] [--batches N] [--dir PATH]
"""

import argparse
import cProfile
import json
import pstats
import shutil
import tempfile
import time

import numpy as np

FUNCTIONS = ("sweep", "_victims", "_rebuild_victim_buf", "prefault", "get",
             "_fault", "_demote", "get_rows", "put_rows", "touch")


def main(argv=None):
    from elasticdl_tpu_torch.native.row_store import make_host_table
    from elasticdl_tpu_torch.storage import TierPolicy, tier_host_tables

    parser = argparse.ArgumentParser("profile_tier_sweep")
    parser.add_argument("--vocab", type=int, default=1_000_000)
    parser.add_argument("--dim", type=int, default=256)
    parser.add_argument("--budget", type=int, default=100_000)
    parser.add_argument("--batches", type=int, default=20)
    parser.add_argument("--dir", default="")
    args = parser.parse_args(argv)
    root = args.dir or tempfile.mkdtemp(prefix="tier_sweep_")
    table = tier_host_tables({"t": make_host_table("t", args.dim)}, root,
                             TierPolicy(args.budget))["t"]
    try:
        t0 = time.perf_counter()
        for lo in range(0, args.vocab, 16384):
            table.get(np.arange(lo, min(lo + 16384, args.vocab),
                                dtype=np.int64))
        fill_s = time.perf_counter() - t0
        rng = np.random.RandomState(13)
        working = rng.choice(args.vocab, 65536, replace=False)
        batches = []
        for b in range(args.batches):
            if b and b % 5 == 0:
                gone = rng.choice(65536, 4096, replace=False)
                working[gone] = rng.randint(0, args.vocab, 4096)
            batches.append(np.unique(np.concatenate([
                rng.choice(working, 16384, replace=False),
                rng.randint(0, args.vocab, 64)])).astype(np.int64))

        def pull(ids):
            table.prefault(ids)
            table.get(ids, _defer_sweep=True)
            table.maybe_sweep()

        half = len(batches) // 2
        for ids in batches[:half]:
            pull(ids)
        prof = cProfile.Profile()
        t0 = time.perf_counter()
        prof.enable()
        for ids in batches[half:]:
            pull(ids)
        prof.disable()
        wall = time.perf_counter() - t0
        stats = pstats.Stats(prof).stats
        cumulative = {}
        for (path, _line, name), row in stats.items():
            if name in FUNCTIONS and "/storage/" in path:
                cumulative[name] = cumulative.get(name, 0.0) + row[3]
        print(json.dumps({
            "vocab": args.vocab, "dim": args.dim, "budget": args.budget,
            "fill_s": fill_s, "profiled_pulls": len(batches) - half,
            "ms_a_pull": wall * 1e3 / (len(batches) - half),
            "cumulative_s": cumulative,
            "cold_rows": table.tier_stats()["members"]["t"]["cold_store"][
                "live_rows"],
        }))
    finally:
        table.tier_group.close()
        if not args.dir:
            shutil.rmtree(root, ignore_errors=True)


if __name__ == "__main__":
    main()
