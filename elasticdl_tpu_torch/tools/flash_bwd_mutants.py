"""Mutants of the flash-attention backward, dk/dv (#4, ``MUTANTS``) and
dq (#3, ``DQ_MUTANTS``), against chip_smoke.py's ``bwd kernel check``,
on one GPU.

    python -m elasticdl_tpu_torch.tools.flash_bwd_mutants

For the sound source and for each mutant below, copies the repository
into a temporary directory, edits ``flash_attention_bwd.cu`` there,
builds it and runs ``chip_smoke.bwd_kernel_phase`` with a check that
records instead of raising (four copies at a time). Prints one JSON line
per source: the cases that failed, with their readings (elem and
relative L2 of dq, dk and dv against the plain version). A run that dies
(a CUDA fault) counts as failing every case. Exits non-zero if the sound
source fails a case or a mutant fails none. The checkout itself is never
edited.

``wgmma_*`` edit the wgmma kernel (bf16 D 64 and 128), ``ring_*`` the
mma.sync kernel (bf16 D 16 and 32):
- ``*_slot_off_by_one``: the products read Q and dO from the other ring
  slot, not the one filled for this tile;
- ``*_first_tile_off_by_one``: the loop starts one q tile after the
  first that the causal mask leaves reachable;
- ``*_diagonal_mask_dropped``: queries before the key not masked;
- ``*_lse_wrong_slot``: lse and delta read from the other slot;
- ``ring_ragged_rows_unmasked``: a ragged q tile's rows past Sq (copies
  of row Sq - 1) not masked;
- ``*_dk_scale_dropped``: dK stored without its scale (first rows);
- ``*_empty_tile_unstored``: a k tile that no query reaches returns
  without storing its zeros (the "beyond" cases, whose outputs start as
  NaN).

The wgmma kernel has no ragged-rows mutant: TMA fills a ragged tile's
rows past Sq with zeros, so q, dO, lse and delta are 0 there, p = 1 and
dS = 0, and those rows add nothing to dK or dV with or without their
mask; dropping it would be an equivalent mutant.

``DQ_MUTANTS``: ``wgmma_dq_*`` edit the dq wgmma kernel (bf16 D 64 and
128), ``ring_dq_*`` the dq mma.sync kernel (bf16 D 16 and 32):
- ``*_slot_off_by_one``: the products read K and V from another ring
  slot than the one filled for this key tile;
- ``*_last_tile_dropped``: the key-tile count is one short (a q tile
  that needs one tile gets none);
- ``*_diagonal_mask_off_by_one``: the key on a row's own position is
  masked too;
- ``*_lse_not_log2``: lse taken in natural-log units against scores in
  log2 units;
- ``*_scale_dropped``: dq stored without its scale (first rows);
- ``*_ds_truncated``: dS cut to bf16 toward zero, not rounded to the
  nearest;
- ``*_no_key_tile_unstored``: a q tile that no key reaches returns
  without storing its zeros (the "before" and "future" cases, whose
  outputs start as NaN);
- ``wgmma_dq_second_sum_dropped``: the first consumer warpgroup stores
  its own sum without the second's;
- ``ring_dq_ragged_keys_unmasked``: a ragged key tile's rows past Sk
  (copies of row Sk - 1) not masked.

The dq wgmma kernel has no ragged-keys mutant: TMA fills a ragged key
tile's rows past Sk with zeros, so K = V = 0 there, s = 0 and p =
2^(-lse); dS may be non-zero there, but dS K adds dS x 0 = 0 to dq. A
row whose lse is -1e30 (p = inf at those keys) reaches no key at all, so
the causal mask zeroes their p all the same. Dropping the mask would be
an equivalent mutant; it stays in the kernel.
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
                      "flash_attention_bwd.cu")

_RING_DIAGONAL = (" ||\n               (causal && q_offset + q_start + c < "
                  "(hi ? gk1 : gk0)))) {\n")

# name -> (the kernel the edits land in, [(text of the sound source,
# replacement)]); each text must occur, and only its first occurrence is
# replaced, which lies in that kernel (tests/test_torch_flash_attention.py).
MUTANTS = {
    "ring_slot_off_by_one": ("flash_bwd_dkv_ring_kernel", [(
        "        reinterpret_cast<const __nv_bfloat16*>(ring + slot * "
        "L::slot);\n",
        "        reinterpret_cast<const __nv_bfloat16*>(\n"
        "            ring + ((slot + 1) % kSlotsA) * L::slot);\n")]),
    "ring_first_tile_off_by_one": ("flash_bwd_dkv_ring_kernel", [(
        "  const int first = dkv_first_tile(k_offset + k_start, q_offset, "
        "causal);\n",
        "  const int first =\n"
        "      dkv_first_tile(k_offset + k_start, q_offset, causal) + 1;\n")]),
    "ring_diagonal_mask_dropped": ("flash_bwd_dkv_ring_kernel", [(
        _RING_DIAGONAL, ")) {\n")]),
    "ring_lse_wrong_slot": ("flash_bwd_dkv_ring_kernel", [(
        "        reinterpret_cast<const float*>(ring + slot * L::slot + "
        "L::stats);\n",
        "        reinterpret_cast<const float*>(\n"
        "            ring + ((slot + 1) % kSlotsA) * L::slot + L::stats);\n")]),
    "ring_ragged_rows_unmasked": ("flash_bwd_dkv_ring_kernel", [(
        "              (c >= q_rows ||\n", "              (false ||\n")]),
    "ring_dk_scale_dropped": ("flash_bwd_dkv_ring_kernel", [(
        "          make_float2(dka[nb][0] * scale, dka[nb][1] * scale);\n",
        "          make_float2(dka[nb][0], dka[nb][1]);\n")]),
    "ring_empty_tile_unstored": ("flash_bwd_dkv_ring_kernel", [(
        "  // dK (scaled once, in f32) and dV; zeros where no query "
        "reached.\n",
        "  if (count <= 0) return;\n")]),
    "wgmma_slot_off_by_one": ("flash_bwd_dkv_wgmma_kernel", [(
        "    const uint32_t q_tile = base + L::ring + slot * L::slot;\n",
        "    const uint32_t q_tile =\n"
        "        base + L::ring + ((slot + 1) % kSlotsB) * L::slot;\n")]),
    "wgmma_first_tile_off_by_one": ("flash_bwd_dkv_wgmma_kernel", [(
        "      dkv_first_tile(k_offset + k_start, q_offset, causal);\n",
        "      dkv_first_tile(k_offset + k_start, q_offset, causal) + 1;\n")]),
    "wgmma_diagonal_mask_dropped": ("flash_bwd_dkv_wgmma_kernel", [(
        "        if (edge && (q_start + c >= sq ||\n"
        "                     (causal && q_offset + q_start + c < "
        "(e < 2 ? gk0 : gk1)))) {\n",
        "        if (edge && (q_start + c >= sq)) {\n")]),
    "wgmma_lse_wrong_slot": ("flash_bwd_dkv_wgmma_kernel", [(
        "    const float* lse_s = stats + slot * 2 * kBlock;\n",
        "    const float* lse_s = stats + ((slot + 1) % kSlotsB) * 2 * "
        "kBlock;\n")]),
    "wgmma_dk_scale_dropped": ("flash_bwd_dkv_wgmma_kernel", [(
        "          make_float2(dka[4 * j] * scale, dka[4 * j + 1] * scale);\n",
        "          make_float2(dka[4 * j], dka[4 * j + 1]);\n")]),
    "wgmma_empty_tile_unstored": ("flash_bwd_dkv_wgmma_kernel", [(
        "  const size_t head = static_cast<size_t>(bh) * sk * D;\n",
        "  if (count <= 0) return;\n"
        "  const size_t head = static_cast<size_t>(bh) * sk * D;\n")]),
}

_RING_DQ_MASK = ("              (kl >= sk || (causal && (hi ? gq1 : gq0) "
                 "< k_offset + kl))) {\n")
_WGMMA_DQ_MASK = ("                     (causal && (e < 2 ? gq0 : gq1) < "
                  "k_offset + kl))) {\n")


def _truncated(lo, hi):
    """C text of two floats cut to a bf16 pair toward zero (the upper
    halves of their bits), in pack_bf16's order."""
    return (f"(__float_as_uint({lo}) >> 16) |\n"
            f"              (__float_as_uint({hi}) & 0xffff0000u)")


# The dq kernels' mutants, as MUTANTS.
DQ_MUTANTS = {
    "ring_dq_slot_off_by_one": ("flash_bwd_dq_ring_kernel", [(
        "    const bf16* ks = ring + (i % kSlotsA) * L::slot;\n",
        "    const bf16* ks = ring + ((i + 1) % kSlotsA) * L::slot;\n")]),
    "ring_dq_last_tile_dropped": ("flash_bwd_dq_ring_kernel", [(
        "  const int count = dq_num_tiles(q_offset + q_start, k_offset, sk, "
        "causal);\n  // Starts the copy",
        "  const int count =\n      dq_num_tiles(q_offset + q_start, "
        "k_offset, sk, causal) - 1;\n  // Starts the copy")]),
    "ring_dq_diagonal_mask_off_by_one": ("flash_bwd_dq_ring_kernel", [(
        _RING_DQ_MASK, _RING_DQ_MASK.replace("< k_offset", "<= k_offset"))]),
    "ring_dq_ragged_keys_unmasked": ("flash_bwd_dq_ring_kernel", [(
        _RING_DQ_MASK, _RING_DQ_MASK.replace("(kl >= sk ||", "(false ||"))]),
    "ring_dq_lse_not_log2": ("flash_bwd_dq_ring_kernel", [(
        "  const float lse0 = row0 < q_rows ? lrow[row0] * kLog2e : 0.f;\n"
        "  const float lse1 = row0 + 8 < q_rows ? lrow[row0 + 8] * kLog2e "
        ": 0.f;\n",
        "  const float lse0 = row0 < q_rows ? lrow[row0] : 0.f;\n"
        "  const float lse1 = row0 + 8 < q_rows ? lrow[row0 + 8] : 0.f;\n")]),
    "ring_dq_scale_dropped": ("flash_bwd_dq_ring_kernel", [(
        "          make_float2(acc[nb][0] * scale, acc[nb][1] * scale);\n",
        "          make_float2(acc[nb][0], acc[nb][1]);\n")]),
    "ring_dq_ds_truncated": ("flash_bwd_dq_ring_kernel", [(
        "          pack_bf16(ds[0][0], ds[0][1]), pack_bf16(ds[0][2], "
        "ds[0][3]),\n          pack_bf16(ds[1][0], ds[1][1]), "
        "pack_bf16(ds[1][2], ds[1][3]),\n",
        "".join(f"          {_truncated(f'ds[{h}][{e}]', f'ds[{h}][{e + 1}]')}"
                ",\n" for h in (0, 1) for e in (0, 2)))]),
    "ring_dq_no_key_tile_unstored": ("flash_bwd_dq_ring_kernel", [(
        "  // dq, scaled once in f32; zeros where no key reached.\n",
        "  if (count <= 0) return;\n")]),
    "wgmma_dq_slot_off_by_one": ("flash_bwd_dq_wgmma_kernel", [(
        "    const uint32_t k_tile = base + L::ring + slot * L::slot;\n",
        "    const uint32_t k_tile =\n"
        "        base + L::ring + ((slot + 1) % kSlotsB) * L::slot;\n")]),
    "wgmma_dq_last_tile_dropped": ("flash_bwd_dq_wgmma_kernel", [(
        "  const int count = dq_num_tiles(q_offset + q_start, k_offset, sk, "
        "causal);\n  const int warp",
        "  const int count =\n      dq_num_tiles(q_offset + q_start, "
        "k_offset, sk, causal) - 1;\n  const int warp")]),
    "wgmma_dq_diagonal_mask_off_by_one": ("flash_bwd_dq_wgmma_kernel", [(
        _WGMMA_DQ_MASK, _WGMMA_DQ_MASK.replace("< k_offset", "<= k_offset"))]),
    "wgmma_dq_lse_not_log2": ("flash_bwd_dq_wgmma_kernel", [(
        "  const float lse0 = in0 ? lse[rows_at + row0] * kLog2e : 0.f;\n"
        "  const float lse1 = in1 ? lse[rows_at + row0 + 8] * kLog2e : "
        "0.f;\n",
        "  const float lse0 = in0 ? lse[rows_at + row0] : 0.f;\n"
        "  const float lse1 = in1 ? lse[rows_at + row0 + 8] : 0.f;\n")]),
    "wgmma_dq_scale_dropped": ("flash_bwd_dq_wgmma_kernel", [(
        "          make_float2(dqa[4 * j] * scale, dqa[4 * j + 1] * scale);\n",
        "          make_float2(dqa[4 * j], dqa[4 * j + 1]);\n")]),
    "wgmma_dq_ds_truncated": ("flash_bwd_dq_wgmma_kernel", [(
        "        da[kk][r] = pack_bf16(dp[8 * kk + 2 * r], "
        "dp[8 * kk + 2 * r + 1]);\n",
        "        da[kk][r] = " + _truncated("dp[8 * kk + 2 * r]",
                                        "dp[8 * kk + 2 * r + 1]") + ";\n")]),
    "wgmma_dq_second_sum_dropped": ("flash_bwd_dq_wgmma_kernel", [(
        "  for (int j = 0; j < kOut; ++j) dqa[j] += sums[j * 128 + tid];\n",
        "  for (int j = 0; j < kOut; ++j) dqa[j] += 0.f;\n")]),
    "wgmma_dq_no_key_tile_unstored": ("flash_bwd_dq_wgmma_kernel", [(
        "  const size_t at0 = (rows_at + row0) * D + 2 * t;\n",
        "  if (count <= 0) return;\n"
        "  const size_t at0 = (rows_at + row0) * D + 2 * t;\n")]),
}

RUNNER = """
import json, sys
sys.path.insert(0, ".")
import torch
import chip_smoke
from elasticdl_tpu_torch.ops import flash_attention as fa

torch.backends.cuda.matmul.allow_tf32 = False
_, checks = chip_smoke.bwd_kernel_phase(torch, fa, check=lambda c, m: None,
                                        timed=False)
print("FAILED", json.dumps([
    {"case": c["case"], "shape": c["shape"], "dtype": c["dtype"],
     "k_offset": c["k_offset"],
     **{g: {"elem": c[g]["elem"], "l2": c[g]["l2"]}
        for g in ("dq", "dk", "dv")}}
    for c in checks if not c["ok"]]))
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
    sources = [("sound", [])] + [
        (name, edits) for table in (MUTANTS, DQ_MUTANTS)
        for name, (_, edits) in table.items()]
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
        print(f"flash_bwd_mutants: not separated: {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
