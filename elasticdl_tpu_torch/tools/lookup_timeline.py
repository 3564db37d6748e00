"""Per-warp timeline of the aligned embedding lookup (#5), on one GPU.

    python -m elasticdl_tpu_torch.tools.lookup_timeline

Builds this tree's ``embedding_lookup.cu`` twice with ``nvcc`` (``ops/
_build.py``'s flags, ``flash_fwd_ab.build``): as it is, and with the
edits of ``PROBES``, which read the card's global timer (``%globaltimer``,
ns) in ``lookup_aligned_kernel`` and have lane 0 of each warp write,
over its strip's first six outputs once they are stored: its start (the
timer's low 24 bits), the ns from its start until its first fills are
issued, until its first stage has landed, until its outputs are
stored, the ns it spent in barrier waits, and its SM. At each of the
sweep tool's four lookup tiers (``bench_kernel_device_sweep.
LOOKUP_TIERS``, the sweep's inputs from the same seed) it launches the
probed build on a few id sets and prints, per phase, the 0th, 50th,
90th and 100th percentile over the warps of the last launch, the span
from the first warp's start to the last warp's end, and the device ms
(``torch.profiler``) of both builds. The probes read the timer about
3 + 2 L / stage times a warp; the two builds' device ms say what that
costs. Nothing is checked: six outputs a warp are timestamps.
"""

import ctypes
import json
import os
import sys
import tempfile

import numpy as np

from elasticdl_tpu_torch.tools import flash_fwd_ab

REPO = flash_fwd_ab.REPO
ROW_W = ("  const float* row_w = weights + static_cast<size_t>(row) * "
         "num_ids;\n")
# [(text of the sound source, replacement)]; each text occurs once
# (tests/test_torch_pallas_embedding.py).
PROBES = [
    ("// acc += w * x, one step of a sum in id order: the product rounded\n",
     "__device__ __forceinline__ unsigned long long probe_ns() {\n"
     "  unsigned long long t;\n"
     "  asm volatile(\"mov.u64 %0, %globaltimer;\" : \"=l\"(t) :: "
     "\"memory\");\n"
     "  return t;\n"
     "}\n\n"
     "// acc += w * x, one step of a sum in id order: the product rounded\n"),
    (ROW_W + "\n  // Ids and weights 32 at a time",
     ROW_W + "  const unsigned long long t0 = probe_ns();\n"
     "  unsigned long long t_landed = 0, waited = 0;\n"
     "\n  // Ids and weights 32 at a time"),
    ("  for (int st = 0; st < stages; ++st) refill(st, st * stage, 0);\n",
     "  for (int st = 0; st < stages; ++st) refill(st, st * stage, 0);\n"
     "  const unsigned long long t_issued = probe_ns();\n"),
    ("    mbar_wait(bar0 + 8 * st, phase);\n",
     "    const unsigned long long t_wait = probe_ns();\n"
     "    mbar_wait(bar0 + 8 * st, phase);\n"
     "    const unsigned long long t_go = probe_ns();\n"
     "    waited += t_go - t_wait;\n"
     "    if (l0 == 0) t_landed = t_go;\n"),
    ("        out_row[c] = normalise(acc[k], d);\n      }\n    }\n  }\n}\n",
     "        out_row[c] = normalise(acc[k], d);\n      }\n    }\n  }\n"
     "  const unsigned long long t_done = probe_ns();\n"
     "  __syncwarp();  // after every lane's own stores\n"
     "  if (lane == 0) {\n"
     "    unsigned sm;\n"
     "    asm volatile(\"mov.u32 %0, %smid;\" : \"=r\"(sm));\n"
     "    out_row[0] = static_cast<float>(t0 & 0xFFFFFF);\n"
     "    out_row[1] = static_cast<float>(t_issued - t0);\n"
     "    out_row[2] = static_cast<float>(t_landed - t0);\n"
     "    out_row[3] = static_cast<float>(t_done - t0);\n"
     "    out_row[4] = static_cast<float>(waited);\n"
     "    out_row[5] = static_cast<float>(sm);\n"
     "  }\n"
     "}\n"),
]
PHASES = ("issued", "first_stage_landed", "done", "waited")


def probed(source: str) -> str:
    for old, new in PROBES:
        if source.count(old) != 1:
            raise ValueError(f"probe anchor not once in the source: {old!r}")
        source = source.replace(old, new)
    return source


def percentiles(values):
    return [round(float(v)) for v in np.percentile(values, [0, 50, 90, 100])]


def main(argv=None) -> int:
    sys.path.insert(0, REPO)
    import torch

    import chip_smoke as cs
    from elasticdl_tpu_torch.ops import pallas_embedding as pe
    from elasticdl_tpu_torch.tools import bench_kernel_device_sweep as tool

    if not torch.cuda.is_available():
        print("lookup_timeline: no CUDA device", file=sys.stderr)
        return 2
    print(cs.smi("name,power.limit"), flush=True)
    source = os.path.join(os.path.dirname(pe.__file__), "csrc",
                          pe._LOOKUP_SOURCE)
    with open(source) as f:
        text = f.read()
    with tempfile.TemporaryDirectory() as tmp:
        variants = {"tree": source,
                    "probed": os.path.join(tmp, "probed.cu")}
        with open(variants["probed"], "w") as f:
            f.write(probed(text))
        libs = {name: pe._bind_lookup(ctypes.CDLL(path)) for name, (path, _)
                in flash_fwd_ab.build(variants, tmp).items()}
        gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
        for dim, num_ids, batch in tool.LOOKUP_TIERS:
            table = tool.uniform_table(tool.VOCAB, dim, gen)
            sets, _ = tool.lookup_inputs(batch, num_ids, dim, gen)
            out = torch.empty(batch, dim, device="cuda")
            plan = pe.aligned_plan(table, sets[0][0], out, libs["tree"])
            for k in range(4):   # the last launch is read
                ids, w = sets[k % len(sets)]
                err = pe._lookup_launch(libs["probed"], True, table, ids, w,
                                        out, "sum")
                cs.check(err == 0, f"CUDA error {err}")
            torch.cuda.synchronize()
            cols = plan["cols"]
            probes = torch.cat([out[:, s * cols:s * cols + 6]
                                for s in range(plan["strips"])])
            probes = probes.double().cpu().numpy()
            start = probes[:, 0] - probes[:, 0].min()
            row = {"dim": dim, "L": num_ids, "batch": batch, "plan": plan,
                   "warps": int(len(probes)),
                   "sms": int(len(set(probes[:, 5].astype(int)))),
                   "ns_p0_p50_p90_p100": {
                       "start": percentiles(start),
                       **{name: percentiles(probes[:, 1 + i])
                          for i, name in enumerate(PHASES)}},
                   "span_ns": round(float((start + probes[:, 3]).max()))}
            for name, lib in libs.items():
                row[f"{name}_ms"] = tool.device_ms(tool.cycling(
                    lambda i, w: pe._lookup_launch(lib, True, table, i, w,
                                                   out, "sum"), sets))[0]
            print(json.dumps(row), flush=True)
            del table, sets, out
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
