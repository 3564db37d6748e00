"""Mutants of the flash-attention forward (#1) against chip_smoke.py's
``kernel check``, on one GPU.

    python -m elasticdl_tpu_torch.tools.flash_fwd_mutants

For the sound source and for each mutant below, copies the repository
into a temporary directory, edits ``flash_attention_fwd.cu`` there,
builds it and runs ``chip_smoke.kernel_phase`` with a check that records
instead of raising (four copies at a time). Prints one JSON line per
source: the cases that failed, with their readings (elem and relative
L2 of o against the plain version folded over the kernel's key tiles,
lse's error). A run that dies (a CUDA fault) counts as failing every
case. Exits non-zero if the sound source fails a case or a mutant fails
none. The checkout itself is never edited.

Each kernel of the file gets the same five mutants: ``wgmma_*`` edit
the wgmma kernel (bf16 D 64 and 128), ``ring_*`` the mma.sync kernel
(bf16 D 16 and 32):
- ``*_stage_off_by_one``: the products read the ring stage (slot) of
  the previous tile, not the one the pipeline filled for this tile;
- ``*_alpha_dropped``: the accumulator not rescaled when the max grows;
- ``*_ragged_mask_dropped``: keys past the sequence's end not masked;
- ``*_diagonal_mask_dropped``: keys after the query not masked;
- ``*_p_not_zeroed``: masked probabilities left to exp(s - m), which is
  1 where a row's max is still -1e30 (the "saturated" case).

No mutant skips the wgmma kernel's wait on a slot's full barrier: what
the products then read depends on a race with the TMA copy and on what
the SM's shared memory held from the block before (often the same
head's K/V tiles, the very data it wants), so a run can pass, and the
block may exit with copies still landing in its freed shared memory.
"""

import json
import os
import shutil
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SOURCE = os.path.join("elasticdl_tpu_torch", "ops", "csrc",
                      "flash_attention_fwd.cu")

_RING_MASK = ("          if (kpos >= seq_len || (causal && kpos > qpos)) {\n"
              "            x = kNegInf;\n            drop")
_WGMMA_MASK = _RING_MASK.replace("drop", "dead").replace(
    "kNegInf;", "kNegInfLog2;")

# name -> (the kernel the edits land in, [(text of the sound source,
# replacement)]); each text must occur, and only its first occurrence is
# replaced, which lies in that kernel (tests/test_torch_flash_attention.py).
MUTANTS = {
    "ring_stage_off_by_one": ("flash_fwd_bf16_kernel", [(
        "    const int ring_stage = tile % kStagesA;\n",
        "    const int ring_stage = (tile + kStagesA - 1) % kStagesA;\n")]),
    "ring_alpha_dropped": ("flash_fwd_bf16_kernel", [(
        "      acc[nb][0] *= alpha0;\n      acc[nb][1] *= alpha0;\n"
        "      acc[nb][2] *= alpha1;\n      acc[nb][3] *= alpha1;\n", "")]),
    "ring_ragged_mask_dropped": ("flash_fwd_bf16_kernel", [(
        _RING_MASK, _RING_MASK.replace("kpos >= seq_len || ", ""))]),
    "ring_diagonal_mask_dropped": ("flash_fwd_bf16_kernel", [(
        _RING_MASK, _RING_MASK.replace(" || (causal && kpos > qpos)", ""))]),
    "ring_p_not_zeroed": ("flash_fwd_bf16_kernel", [(
        "        if ((drop >> (nb * 4 + i)) & 1u) p = 0.f;\n", "")]),
    "wgmma_stage_off_by_one": ("flash_fwd_wgmma_kernel", [(
        "    const uint32_t k_tile = base + L::ring + slot * 2 * "
        "L::kv_bytes;\n",
        "    const uint32_t k_tile = base + L::ring +\n"
        "        ((slot + kSlotsB - 1) % kSlotsB) * 2 * L::kv_bytes;\n")]),
    "wgmma_alpha_dropped": ("flash_fwd_wgmma_kernel", [(
        "      acc[4 * j + 0] *= alpha0;\n      acc[4 * j + 1] *= alpha0;\n"
        "      acc[4 * j + 2] *= alpha1;\n      acc[4 * j + 3] *= alpha1;\n",
        "")]),
    "wgmma_ragged_mask_dropped": ("flash_fwd_wgmma_kernel", [(
        _WGMMA_MASK, _WGMMA_MASK.replace("kpos >= seq_len || ", ""))]),
    "wgmma_diagonal_mask_dropped": ("flash_fwd_wgmma_kernel", [(
        _WGMMA_MASK, _WGMMA_MASK.replace(" || (causal && kpos > qpos)", ""))]),
    "wgmma_p_not_zeroed": ("flash_fwd_wgmma_kernel", [(
        "        if ((dead >> (4 * j + i)) & 1u) p = 0.f;\n", "")]),
}

RUNNER = """
import json, sys
sys.path.insert(0, ".")
import torch
import chip_smoke
from elasticdl_tpu_torch.ops import flash_attention as fa

torch.backends.cuda.matmul.allow_tf32 = False
_, checks = chip_smoke.kernel_phase(torch, fa, check=lambda c, m: None,
                                    timed=False)
print("FAILED", json.dumps([
    {"case": c["case"], "elem": c["o"]["elem"], "l2": c["o"]["l2"],
     "lse": c["lse"]} for c in checks if not c["ok"]]))
"""


def mutate(source: str, edits) -> str:
    for old, new in edits:
        if old not in source:
            raise ValueError(f"mutant text not in the source: {old!r}")
        source = source.replace(old, new, 1)
    return source


def run(name: str, edits):
    """The cases the source fails (a list), or the tail of the output of
    a run that died (a str)."""
    with tempfile.TemporaryDirectory() as tmp:
        copy = os.path.join(tmp, "repo")
        shutil.copytree(REPO, copy, ignore=shutil.ignore_patterns(
            ".git", "_build", ".smoke_archive", "__pycache__"))
        path = os.path.join(copy, SOURCE)
        with open(path) as f:
            text = f.read()
        with open(path, "w") as f:
            f.write(mutate(text, edits))
        proc = subprocess.run([sys.executable, "-c", RUNNER], cwd=copy,
                              capture_output=True, text=True)
    lines = [line for line in proc.stdout.splitlines()
             if line.startswith("FAILED ")]
    if proc.returncode != 0 or not lines:
        return f"{proc.stdout[-2000:]}\n{proc.stderr[-2000:]}"
    return json.loads(lines[-1][len("FAILED "):])


def main() -> int:
    sources = [("sound", [])] + [(name, edits)
                                 for name, (_, edits) in MUTANTS.items()]
    with ThreadPoolExecutor(4) as pool:
        results = list(pool.map(lambda item: run(*item), sources))
    bad = []
    for (name, _), failed in zip(sources, results):
        died = isinstance(failed, str)
        print(json.dumps({"source": name, "died": died,
                          "failed_cases": failed}), flush=True)
        if name == "sound" and (died or failed):
            bad.append(name)
        elif name != "sound" and not failed:
            bad.append(name)
    if bad:
        print(f"flash_fwd_mutants: not separated: {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
