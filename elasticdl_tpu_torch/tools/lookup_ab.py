"""Times builds of the embedding lookups (#5 and #6) against each other in
one call, on one GPU.

    python -m elasticdl_tpu_torch.tools.lookup_ab [--old NAME=PATH ...]

Builds with ``nvcc`` (``ops/_build.py``'s flags, ``flash_fwd_ab.build``,
which passes ``-I csrc`` so that a source staged elsewhere finds
``hopper.cuh``), all at once, into a temporary directory: each ``--old``
source (another ``embedding_lookup.cu`` with the same C entry points: an
earlier commit's, say, staged under the git-ignored ``.smoke_archive/``),
then the variants of this tree's source in ``VARIANTS`` (one constant of
the launch geometry changed), then ``tree``, this tree's source.

At each of the sweep tool's four lookup tiers (``LOOKUP_TIERS``: a
1,000,000-row f32 table, sum, weights 1, the sweep's id sets from the
same seed, rotated past the L2) each build's #5 is launched through its
C entry point into an output filled with NaN and held to the plain
version (chip_smoke.EMB_TOL), then timed: device ms a call off
``torch.profiler`` (``bench_kernel_device_sweep.device_ms``), the builds
in list order and then reversed. Each build's #6 is held and timed the
same way (``lookup_ms``), beside ``embedding_bag`` and the bound in the
same call. Prints the card, each
build's ptxas lines for the aligned kernel, and one JSON line per build
and tier (with this tree's launch plan: instance, strip width, strips,
ring slots, blocks, shared memory).
"""

import argparse
import ctypes
import json
import os
import sys
import tempfile

import numpy as np

from elasticdl_tpu_torch.tools import flash_fwd_ab

REPO = flash_fwd_ab.REPO
# name -> (text of this tree's source, replacement)
VARIANTS = {
    "wide": ("constexpr int kMinStripCols = 32;",
             "constexpr int kMinStripCols = 128;"),    # 512-byte strips
    "deep": ("constexpr int kMaxSlots = 24;",
             "constexpr int kMaxSlots = 32;"),         # a ring of 32
    "shallow": ("constexpr int kMaxSlots = 24;",
                "constexpr int kMaxSlots = 16;"),      # a ring of 16
    "slot_barriers": ("constexpr int kStageSlots = 8;",
                      "constexpr int kStageSlots = 1;"),  # one a slot
}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--old", action="append", default=[],
                        metavar="NAME=PATH",
                        help="another embedding_lookup.cu to time")
    parser.add_argument("--iters", type=int, default=20)
    parser.add_argument("--windows", type=int, default=5)
    args = parser.parse_args(argv)
    sys.path.insert(0, REPO)
    import torch

    import chip_smoke as cs
    from elasticdl_tpu_torch.ops import pallas_embedding as pe
    from elasticdl_tpu_torch.tools import bench_kernel_device_sweep as tool

    if not torch.cuda.is_available():
        print("lookup_ab: no CUDA device", file=sys.stderr)
        return 2
    print(cs.smi("name,power.limit"), flush=True)
    source = os.path.join(os.path.dirname(pe.__file__), "csrc",
                          pe._LOOKUP_SOURCE)
    with open(source) as f:
        text = f.read()
    variants = dict(item.split("=", 1) for item in args.old)
    ok = True
    with tempfile.TemporaryDirectory() as tmp:
        for name, (old, new) in VARIANTS.items():
            if old not in text:
                raise ValueError(f"{old!r} not in {source}")
            variants[name] = os.path.join(tmp, f"{name}.cu")
            with open(variants[name], "w") as f:
                f.write(text.replace(old, new))
        variants["tree"] = source
        libs = {}
        for name, (path, log) in flash_fwd_ab.build(variants, tmp).items():
            for kernel, line in cs.ptxas_lines(log):
                if kernel.startswith("lookup_aligned_kernel"):
                    print(f"  {name}: {kernel}: {line}", flush=True)
            libs[name] = pe._bind_lookup(ctypes.CDLL(path))
        order = list(libs) + list(reversed(libs))
        gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
        for dim, num_ids, batch in tool.LOOKUP_TIERS:
            table = tool.uniform_table(tool.VOCAB, dim, gen)
            sets, distinct = tool.lookup_inputs(batch, num_ids, dim, gen)
            ids, w = sets[0]
            want = pe.lookup_combine_reference(table, ids, w, "sum")
            out = torch.empty(batch, dim, device="cuda")
            rows = {}
            for name, lib in libs.items():
                readings, good = {}, True
                for aligned in (True, False):
                    out.fill_(float("nan"))
                    err = pe._lookup_launch(lib, aligned, table, ids, w, out,
                                            "sum")
                    cs.check(err == 0, f"{name}: CUDA error {err}")
                    torch.cuda.synchronize()
                    readings[aligned] = cs.grad_readings(out, want)
                    good = (good and bool(torch.isfinite(out).all())
                            and cs.emb_within(readings[aligned],
                                              cs.EMB_TOL["lookup"]))
                ok = ok and good
                rows[name] = {"variant": name, "dim": dim, "L": num_ids,
                              "batch": batch, "vocab": tool.VOCAB,
                              "distinct_rows": distinct, **readings[True],
                              "lookup_max_abs_err":
                                  readings[False]["max_abs_err"],
                              "ok": good, "ms_windows": [],
                              "lookup_ms_windows": []}

            def timed(fn):
                return tool.device_ms(tool.cycling(fn, sets), args.iters,
                                      args.windows)

            for name in order:
                lib = libs[name]
                for aligned, key in ((True, "ms_windows"),
                                     (False, "lookup_ms_windows")):
                    rows[name][key].append(timed(
                        lambda i, w: pe._lookup_launch(
                            lib, aligned, table, i, w, out, "sum"))[0])
            same_call = {
                "embedding_bag_ms": timed(
                    lambda i, w: torch.nn.functional.embedding_bag(
                        i, table, per_sample_weights=w, mode="sum"))[0],
            }
            bound_ms, bound_by = tool.lookup_bound(batch, num_ids, dim,
                                                   distinct)
            plan = pe.aligned_plan(table, ids, out, libs["tree"])
            for row in rows.values():
                row.update(ms=float(np.median(row["ms_windows"])),
                           lookup_ms=float(np.median(
                               row["lookup_ms_windows"])),
                           bound_ms=bound_ms, bound_by=bound_by,
                           tree_plan=plan, **same_call)
                print(json.dumps(row), flush=True)
            del table, sets, ids, w, want, out
            torch.cuda.empty_cache()
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
