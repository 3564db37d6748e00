"""Times builds of the ring's chunk-update kernel (#2) against each other
in one call, on one GPU.

    python -m elasticdl_tpu_torch.tools.chunk_ab \
        [--old NAME[@CONSUMERS]=PATH ...]

Builds with ``nvcc`` (``ops/_build.py``'s flags, ``flash_fwd_ab.build``,
which passes ``-I csrc`` so that a source staged elsewhere finds
``hopper.cuh``), all at once, into a temporary directory: each ``--old``
source (another ``flash_chunk_update.cu`` with the same C entry point: an
earlier commit's, say, staged under the git-ignored ``.smoke_archive/``),
then ``one``, this tree's source with a single consumer warpgroup
(``kConsumers`` 1: every key tile folded into the carry in turn), then
``tree``, this tree's source. CONSUMERS (default 1) names how many
running states an old build folds the key tiles into, so that each build
is held to the plain version folded in its own order.

At each shape of SHAPES (bf16, the ring's local block BH 4 x 2048 x
2048: a past chunk with a folded carry, every pair unmasked, and the
diagonal chunk with the initial carry, at D 128 and 64) each build is
held against that plain version (chip_smoke.CHUNK_TOL) and timed: device
ms a launch from a CUDA graph of 50 launches replayed five times, the
builds in list order and then reversed, beside the bound and SDPA's
flash forward over the same chunk (chip_smoke.sdpa_forward: the chunk's
products without the carry, a yardstick), measured the same way. Prints
the card, each build's ptxas lines (registers, spills, shared memory and
any C75xx warning) and one JSON line per build and shape.
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
# (name, d, q_offset, k_offset, carry) at BH 4 x Sq 2048 x Sk 2048, causal.
SHAPES = [("past", 128, 4096, 0, "folded"),
          ("diagonal", 128, 2048, 2048, "initial"),
          ("past", 64, 4096, 0, "folded"),
          ("diagonal", 64, 2048, 2048, "initial")]
ONE_CONSUMER = ("constexpr int kConsumers = 2;",
                "constexpr int kConsumers = 1;")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--old", action="append", default=[],
                        metavar="NAME[@CONSUMERS]=PATH",
                        help="another flash_chunk_update.cu to time, "
                             "folding its key tiles into CONSUMERS states")
    args = parser.parse_args(argv)
    sys.path.insert(0, REPO)
    import torch

    import chip_smoke as cs
    from elasticdl_tpu_torch.ops import flash_attention as fa

    if not torch.cuda.is_available():
        print("chunk_ab: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.smi("name,power.limit"), flush=True)
    source = os.path.join(os.path.dirname(fa.__file__), "csrc",
                          fa._CHUNK_SOURCE)
    variants, consumers = {}, {}
    for item in args.old:
        label, path = item.split("=", 1)
        name, _, count = label.partition("@")
        variants[name], consumers[name] = path, int(count or 1)
    with tempfile.TemporaryDirectory() as tmp:
        with open(source) as f:
            text = f.read()
        if ONE_CONSUMER[0] not in text:
            raise ValueError(f"{ONE_CONSUMER[0]!r} not in {source}")
        variants["one"] = os.path.join(tmp, "one_consumer.cu")
        with open(variants["one"], "w") as f:
            f.write(text.replace(*ONE_CONSUMER))
        consumers["one"] = 1
        variants["tree"], consumers["tree"] = source, None
        libs = {}
        for name, (path, log) in flash_fwd_ab.build(variants, tmp).items():
            for line in cs.kernel_ptxas(log, "flash_chunk_"):
                print(f"  {name}: {line}", flush=True)
            libs[name] = fa._bind_chunk(ctypes.CDLL(path))
        rng = np.random.default_rng(cs.SEED + 70)
        order = list(libs) + list(reversed(libs))
        bh, sq, sk = 4, 2048, 2048
        for shape, d, q_off, k_off, carry in SHAPES:
            q, k, v = (torch.from_numpy(rng.standard_normal(
                (bh, rows, d), dtype=np.float32)).to("cuda", torch.bfloat16)
                for rows in (sq, sk, sk))
            scale = d ** -0.5
            state = (torch.full((bh, sq, 1), -1e30, device="cuda"),
                     torch.zeros((bh, sq, 1), device="cuda"),
                     torch.zeros((bh, sq, d), device="cuda"))
            if carry == "folded":   # as chip_smoke.chunk_kernel_phase's
                k0, v0 = (torch.from_numpy(rng.standard_normal(
                    (bh, 256, d), dtype=np.float32)).to("cuda", torch.bfloat16)
                    for _ in range(2))
                state = fa.flash_chunk_update_reference(
                    q, k0, v0, *state, q_off, -256, False, scale)
            outs = [torch.empty_like(t) for t in state]
            rows = {}
            for name, lib in libs.items():
                for out in outs:
                    out.fill_(float("nan"))
                err = fa._chunk_launch(lib, (q, k, v, *state), outs, q_off,
                                       k_off, True, scale)
                cs.check(err == 0, f"{name}: CUDA error {err}")
                torch.cuda.synchronize()
                want = fa.flash_chunk_update_reference(
                    q, k, v, *state, q_off, k_off, True, scale,
                    block_k=fa.chunk_block_k(d, torch.bfloat16),
                    consumers=(consumers[name]
                               or fa.chunk_consumers(d, torch.bfloat16)))
                readings = {o: cs.grad_readings(g, w) for o, g, w in
                            zip(("m", "l", "acc"), outs, want)}
                rows[name] = {
                    "variant": name, "case": shape,
                    "shape": [bh, sq, sk, d], "q_offset": q_off,
                    "k_offset": k_off, "carry": carry, **readings,
                    "ok": all(bool(torch.isfinite(g).all())
                              and cs.within(readings[o],
                                            cs.CHUNK_TOL["bfloat16"])
                              for o, g in zip(("m", "l", "acc"), outs)),
                    "ms_replays": []}
            for name in order:
                lib = libs[name]
                rows[name]["ms_replays"] += cs.graph_ms(
                    torch, lambda: fa._chunk_launch(
                        lib, (q, k, v, *state), outs, q_off, k_off, True,
                        scale))
            lib_causal = q_off == k_off
            sdpa = cs.graph_ms(torch, cs.sdpa_forward(
                torch, q, k, v, lib_causal, cs.FLAGSHIP["n_heads"]))
            bound_ms, bound_by = cs.chunk_bound(bh, sq, sk, d, "bfloat16",
                                                True, q_off, k_off)
            for row in rows.values():
                row.update(ms=float(np.median(row["ms_replays"])),
                           bound_ms=bound_ms, bound_by=bound_by,
                           yardstick_ms=float(np.median(sdpa)),
                           yardstick_causal=lib_causal)
                print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
