"""Times builds of the flash-attention forward (#1) against each other in
one call, on one GPU.

    python -m elasticdl_tpu_torch.tools.flash_fwd_ab \
        [--old NAME[@BLOCK_K]=PATH ...]

Builds with ``nvcc`` (``ops/_build.py``'s flags), all at once, into a
temporary directory: each ``--old`` source (another
``flash_attention_fwd.cu`` with the same C entry point: an earlier
commit's, say, or a draft), then ``tree``, this tree's source. An old
source is held to the plain version folded over BLOCK_K keys, or, with
no BLOCK_K, over this tree's key-tile width (``forward_block_k``).

At each shape of SHAPES (causal, bf16: the flagship's B 8 x S 1024 and
the ring comparison's B 1 x S 8192 at D 128, the zoo twin's train step
at D 16, and S 1024 at D 16 and 32) each build is held against that
plain version (chip_smoke.FWD_TOL) and timed: device ms a launch from a
CUDA graph of 50 launches replayed five times, the builds in list order
and then reversed, beside SDPA's device time taken the same way. Prints
the card, each build's ptxas lines and one JSON line per build and
shape.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SHAPES = [(8, 4, 1024, 128), (1, 4, 8192, 128),   # (b, h, s, d), causal
          (8, 8, 127, 16), (8, 8, 1024, 16), (8, 8, 1024, 32)]


def build(variants, out_dir):
    """{name: (library path, nvcc log)}, compiled in parallel; a source
    outside csrc/ finds the headers there (hopper.cuh)."""
    from elasticdl_tpu_torch.ops import _build

    procs = {}
    for name, source in variants.items():
        out = os.path.join(out_dir, f"lib{name}.so")
        procs[name] = (out, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", _build.CSRC_DIR,
             "-o", out, source],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = {}
    for name, (out, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        built[name] = (out, log)
    return built


def load(path):
    fn = ctypes.CDLL(path).edl_flash_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--old", action="append", default=[],
                        metavar="NAME[@BLOCK_K]=PATH",
                        help="another flash_attention_fwd.cu to time, "
                             "rounding p at BLOCK_K-key tiles")
    args = parser.parse_args(argv)
    sys.path.insert(0, REPO)
    import torch

    import chip_smoke as cs
    from elasticdl_tpu_torch.ops import flash_attention as fa

    if not torch.cuda.is_available():
        print("flash_fwd_ab: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.smi("name,power.limit"), flush=True)
    source = os.path.join(fa.__file__.rsplit(os.sep, 1)[0], "csrc",
                          fa._SOURCE)
    variants, block_ks = {}, {}
    for item in args.old:
        label, path = item.split("=", 1)
        name, _, block_k = label.partition("@")
        variants[name] = path
        block_ks[name] = int(block_k) if block_k else None
    variants["tree"], block_ks["tree"] = source, None
    with tempfile.TemporaryDirectory() as tmp:
        built = build(variants, tmp)
        libs = {}
        for name, (path, log) in built.items():
            for kernel, line in cs.ptxas_lines(log):
                print(f"  {name}: {kernel}: {line}", flush=True)
            libs[name] = load(path)
        rng = np.random.default_rng(cs.SEED)
        order = list(libs) + list(reversed(libs))
        for b, h, s, d in SHAPES:
            q, k, v = (torch.from_numpy(rng.standard_normal(
                (b * h, s, d), dtype=np.float32)).to("cuda", torch.bfloat16)
                for _ in range(3))
            scale = d ** -0.5
            o = torch.empty_like(q)
            lse = torch.empty((b * h, s), device="cuda")
            ptrs = [t.data_ptr() for t in (q, k, v, o, lse)]
            rows = {name: {"variant": name, "shape": [b * h, s, d],
                           "ms_replays": []} for name in libs}
            for name, fn in libs.items():
                block_k = (block_ks[name]
                           or fa.forward_block_k(d, torch.bfloat16))
                err = fn(*ptrs, b * h, s, d, 1, scale, 1,
                         torch.cuda.current_stream().cuda_stream)
                cs.check(err == 0, f"{name}: CUDA error {err}")
                want, want_lse = fa.flash_forward_reference(
                    q, k, v, True, scale, block_k)
                rows[name].update(
                    block_k=block_k, o=cs.grad_readings(o, want),
                    lse=cs.lse_reading(lse, want_lse))
                rows[name]["ok"] = (cs.within(rows[name]["o"],
                                              cs.FWD_TOL["bfloat16"])
                                    and rows[name]["lse"]
                                    <= cs.FWD_TOL["bfloat16"]["lse"])
            for name in order:
                fn = libs[name]
                rows[name]["ms_replays"] += cs.graph_ms(
                    torch, lambda: fn(*ptrs, b * h, s, d, 1, scale, 1,
                                      torch.cuda.current_stream()
                                      .cuda_stream))
            q4, k4, v4 = (x.view(b, h, s, d) for x in (q, k, v))
            sdpa = cs.graph_ms(
                torch, lambda: torch.nn.functional.
                scaled_dot_product_attention(q4, k4, v4, is_causal=True,
                                             scale=scale))
            bound_ms, bound_by = cs.flash_bound(b * h, s, d, "bfloat16",
                                                True)
            for row in rows.values():
                row.update(ms=float(np.median(row["ms_replays"])),
                           library_ms=float(np.median(sdpa)),
                           bound_ms=bound_ms, bound_by=bound_by)
                print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
