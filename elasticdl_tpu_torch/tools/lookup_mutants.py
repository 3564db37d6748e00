"""Mutants of the aligned embedding lookup (#5) against chip_smoke.py's
lookup checks, on one GPU.

    python -m elasticdl_tpu_torch.tools.lookup_mutants

For the sound source and for each mutant in ``MUTANTS``, copies the
repository into a temporary directory, edits ``embedding_lookup.cu``
there, builds it and runs ``chip_smoke.lookup_checks`` (every lookup
case of #5 and #6, each also launched through the C entry point into a
NaN-filled output) with a check that records instead of raising, three
copies at a time. Each copy runs under its own time limit: a mutant that
hangs the ring (a barrier that never completes) is killed there, which
ends its CUDA context, and counts as caught. A run that dies (a CUDA
fault) counts as failing every case. Prints one JSON line per source:
the cases of #5 that failed, with their readings, and the number of #6's
(the zero-denominator mutant edits the normalisation the two kernels
share). Exits non-zero if the sound source fails any case of either
kernel, or a mutant fails no case of #5. The checkout itself is never
edited.

- ``invalid_id_read``: an id outside the table reads its slot (whatever
  an earlier lap left there) instead of the zero strip;
- ``slot_off_by_one``: each id reads the next slot of its stage;
- ``valid_bits_stale``: the in-table bits of the first 32 ids serve
  every later chunk;
- ``parity_not_flipped``: a stage's wait keeps parity 0 on every lap;
- ``expect_tx_short``: a copy arms its barrier with 16 bytes fewer than
  it brings;
- ``last_id_dropped``: the row's last id reads the zero strip;
- ``strip_offset_wrong``: every strip of a split row copies the row's
  first columns;
- ``weights_ignored``: acc += x instead of w * x;
- ``zero_denominator_guard_dropped``: acc / d even where d is 0.
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
                      "embedding_lookup.cu")
TIMEOUT_S = 150

# name -> [(text of the sound source, replacement)]; each text occurs
# once in the sound source (tests/test_torch_pallas_embedding.py).
MUTANTS = {
    "invalid_id_read": [(
        "(cur_valid >> bit) & 1u ? strips0 + j * kCols : zero;",
        "strips0 + j * kCols;")],
    "slot_off_by_one": [(
        "(cur_valid >> bit) & 1u ? strips0 + j * kCols : zero;",
        "(cur_valid >> bit) & 1u ? strips0 + ((j + 1) % stage) * kCols\n"
        "                                   : zero;")],
    "valid_bits_stale": [(
        "      cur_valid = __ballot_sync(kFull, in_table(cur_id, vocab));\n",
        "")],
    "parity_not_flipped": [("      phase ^= 1;\n", "")],
    "expect_tx_short": [(
        "          mbar_expect_tx(bar, bytes);\n",
        "          mbar_expect_tx(bar, bytes - 16);\n")],
    "last_id_dropped": [(
        "(cur_valid >> bit) & 1u ? strips0 + j * kCols : zero;",
        "(cur_valid >> bit) & 1u && l0 + j + 1 < num_ids\n"
        "              ? strips0 + j * kCols : zero;")],
    "strip_offset_wrong": [(
        "  const float* src = table + col0;\n",
        "  const float* src = table;\n")],
    "weights_ignored": [("  acc = __fadd_rn(acc, __fmul_rn(w, x));\n",
                         "  acc = __fadd_rn(acc, x);\n")],
    "zero_denominator_guard_dropped": [(
        "  return positive ? acc / (positive ? d : 1.f) : 0.f;\n",
        "  return acc / d;\n")],
}

RUNNER = """
import json, sys
sys.path.insert(0, ".")
import numpy as np
import torch
import chip_smoke
from elasticdl_tpu_torch.ops import pallas_embedding as pe

checks = chip_smoke.lookup_checks(
    torch, pe, np.random.default_rng(chip_smoke.SEED + 20),
    torch.Generator(device="cuda").manual_seed(chip_smoke.SEED + 20),
    check=lambda c, m: None)
print("FAILED", json.dumps([
    {k: c[k] for k in ("kernel", "dim", "batch", "num_ids", "combiner",
                       "weights", "table_layout", "elem", "l2",
                       "c_entry_bit_equal")}
    for c in checks if not c["ok"]]))
"""


def mutate(source: str, edits) -> str:
    for old, new in edits:
        if old not in source:
            raise ValueError(f"mutant text not in the source: {old!r}")
        source = source.replace(old, new, 1)
    return source


def run(name: str, edits):
    """The lookup cases the source fails, or the tail of the output of a
    run that died or timed out."""
    with tempfile.TemporaryDirectory() as tmp:
        copy = os.path.join(tmp, "repo")
        shutil.copytree(REPO, copy, ignore=shutil.ignore_patterns(
            ".git", "_build", ".smoke_archive", "__pycache__"))
        path = os.path.join(copy, SOURCE)
        with open(path) as f:
            text = f.read()
        with open(path, "w") as f:
            f.write(mutate(text, edits))
        try:
            proc = subprocess.run([sys.executable, "-c", RUNNER], cwd=copy,
                                  capture_output=True, text=True,
                                  timeout=TIMEOUT_S)
        except subprocess.TimeoutExpired as exc:
            return f"timed out after {exc.timeout} s"
    for line in proc.stdout.splitlines():
        tag, _, rest = line.partition(" ")
        if tag == "FAILED" and proc.returncode == 0:
            return json.loads(rest)
    return f"{proc.stdout[-2000:]}\n{proc.stderr[-2000:]}"


def main() -> int:
    sources = [("sound", [])] + list(MUTANTS.items())
    with ThreadPoolExecutor(3) as pool:
        results = list(pool.map(lambda item: run(*item), sources))
    bad = []
    for (name, _), failed in zip(sources, results):
        died = isinstance(failed, str)
        aligned = [] if died else [
            c for c in failed if c["kernel"] == "lookup_combine_aligned"]
        print(json.dumps({
            "source": name, "died": died,
            "failed_cases": failed if died else aligned,
            "lookup_combine_failed": None if died else
            len(failed) - len(aligned)}), flush=True)
        if name == "sound":
            if died or failed:
                bad.append(name)
        elif not died and not aligned:
            bad.append(name)
    if bad:
        print(f"lookup_mutants: not separated: {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
