"""Times builds of the flash-attention backward (#3 dq, #4 dk/dv) against
each other in one call, on one GPU.

    python -m elasticdl_tpu_torch.tools.flash_bwd_ab [--old NAME=PATH ...]

Builds with ``nvcc`` (``ops/_build.py``'s flags, ``flash_fwd_ab.build``),
all at once, into a temporary directory: each ``--old`` source (another
``flash_attention_bwd.cu`` with the same C entry points: an earlier
commit's, say, or a draft staged under the git-ignored
``.smoke_archive/``), then ``tree``, this tree's source.

At each shape of SHAPES (bf16, causal: the flagship's BH 32 x S 1024,
the ring's local block BH 4 x 2048 as a past chunk, every pair
unmasked, and as the diagonal chunk, all at D 128; S 1024 at D 64, the
zoo twin's train step at D 16 and S 1024 at D 32: the head dims on each
side of both kernels' routes) each build's dq, dk and dv are held
against the plain version (chip_smoke.BWD_TOL) and timed: device ms a
launch from a CUDA graph of 50 launches replayed five times, the builds
in list order and then reversed, beside the bound, the pair's sum
(dq + dk/dv) and SDPA's flash backward op on the same work, measured the
same way. Prints the card, each build's ptxas lines and one JSON line
per build and shape.
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
# (name, bh, sq, sk, d, q_offset, k_offset), causal.
SHAPES = [("flagship", 32, 1024, 1024, 128, 0, 0),
          ("ring_past", 4, 2048, 2048, 128, 2048, 0),
          ("ring_diagonal", 4, 2048, 2048, 128, 0, 0),
          ("d64", 32, 1024, 1024, 64, 0, 0),
          ("twin", 64, 127, 127, 16, 0, 0),
          ("d32", 32, 1024, 1024, 32, 0, 0)]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--old", action="append", default=[],
                        metavar="NAME=PATH",
                        help="another flash_attention_bwd.cu to time")
    args = parser.parse_args(argv)
    sys.path.insert(0, REPO)
    import torch

    import chip_smoke as cs
    from elasticdl_tpu_torch.ops import flash_attention as fa

    if not torch.cuda.is_available():
        print("flash_bwd_ab: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.smi("name,power.limit"), flush=True)
    variants = dict(item.split("=", 1) for item in args.old)
    variants["tree"] = os.path.join(os.path.dirname(fa.__file__), "csrc",
                                    fa._BWD_SOURCE)
    tol = cs.BWD_TOL["bfloat16"]
    with tempfile.TemporaryDirectory() as tmp:
        libs = {}
        for name, (path, log) in flash_fwd_ab.build(variants, tmp).items():
            for kernel, line in cs.ptxas_lines(log):
                print(f"  {name}: {kernel}: {line}", flush=True)
            libs[name] = fa._bind_bwd(ctypes.CDLL(path))
        # The smoke's seed: the flagship inputs are its first case's.
        rng = np.random.default_rng(cs.SEED + 10)
        order = list(libs) + list(reversed(libs))
        for shape, bh, sq, sk, d, q_offset, k_offset in SHAPES:
            inputs = cs.chunk_inputs(torch, rng, bh, sq, sk, d,
                                     torch.bfloat16, True, q_offset,
                                     k_offset)
            want = fa.flash_chunk_grads_reference(*inputs, q_offset,
                                                  k_offset, True,
                                                  d ** -0.5)
            outs = tuple(torch.empty((bh, rows, d), device="cuda")
                         for rows in (sq, sk, sk))
            launchers, rows = {}, {}
            for name, lib in libs.items():
                for out in outs:
                    out.fill_(float("nan"))
                launch = cs.bwd_launcher(fa, lib, inputs, outs, q_offset,
                                         True, k_offset)
                launch("dq")
                launch("dkv")
                torch.cuda.synchronize()
                readings = {grad: cs.grad_readings(g, w) for grad, g, w in
                            zip(("dq", "dk", "dv"), outs, want)}
                rows[name] = {
                    "variant": name, "case": shape, "shape": [bh, sq, sk, d],
                    "q_offset": q_offset, "k_offset": k_offset, **readings,
                    "ok": all(bool(torch.isfinite(g).all())
                              and cs.within(readings[grad], tol)
                              for grad, g in zip(("dq", "dk", "dv"), outs)),
                    "dq_replays": [], "dkv_replays": []}
                launchers[name] = launch
            for name in order:
                for kind in ("dq", "dkv"):
                    rows[name][f"{kind}_replays"] += cs.graph_ms(
                        torch, lambda: launchers[name](kind))
            lib_causal = cs.unmasked_pairs(sq, sk, q_offset, k_offset,
                                           True) < sq * sk
            sdpa = cs.graph_ms(torch, cs.sdpa_backward(
                torch, *inputs[:4], lib_causal, cs.FLAGSHIP["n_heads"]))
            bounds = {kind: cs.bwd_bound(bh, sq, sk, d, "bfloat16", True,
                                         products, outputs, q_offset,
                                         k_offset)
                      for kind, products, outputs in (("dq", 3, 1),
                                                      ("dkv", 4, 2))}
            for row in rows.values():
                for kind in ("dq", "dkv"):
                    row[f"{kind}_ms"] = float(
                        np.median(row[f"{kind}_replays"]))
                    row[f"{kind}_bound_ms"], row[f"{kind}_bound_by"] = \
                        bounds[kind]
                row.update(pair_ms=row["dq_ms"] + row["dkv_ms"],
                           library_ms=float(np.median(sdpa)),
                           library_causal=lib_causal)
                print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
