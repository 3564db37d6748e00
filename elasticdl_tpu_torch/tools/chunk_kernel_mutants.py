"""Mutants of the chunk-update kernel (#2) against chip_smoke.py's
``chunk kernel check``, on one GPU.

    python -m elasticdl_tpu_torch.tools.chunk_kernel_mutants

For the sound source and for each mutant below, copies the repository
into a temporary directory, edits ``flash_chunk_update.cu`` there (the
bf16 kernel, the one the ring runs), builds it and runs
``chip_smoke.chunk_kernel_phase`` with a check that records instead of
raising, then ``chip_smoke.ring_check_phase`` (the ring, which runs the
kernel, against #1/#3/#4 on the whole sequence) the same way. Prints
one JSON line per source: the chunk cases that failed, with their
readings (elem and relative L2 of m, l and acc), and every ring case's
readings (elem and L2 of out, dq, dk, dv, and whether it kept
chip_smoke.RING_TOL). Exits non-zero if the sound source fails a case
or a mutant fails no chunk case. The checkout itself is never edited.

Mutants:
- ``p_not_zeroed``: masked probabilities left to underflow (a row whose
  keys are all masked while its m is -1e30 then adds exp(0) = 1);
- ``alpha_dropped``: the accumulator not rescaled when the max grows;
- ``carry_ignored``: (m, l, acc) initialised instead of read;
- ``k_offset_ignored``: the chunk's keys taken to start at position 0.
"""

import json
import os
import shutil
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SOURCE = os.path.join("elasticdl_tpu_torch", "ops", "csrc",
                      "flash_chunk_update.cu")

# name -> [(text of the sound source, replacement)]; each text must occur,
# and only its first occurrence (the bf16 kernel's) is replaced.
MUTANTS = {
    "p_not_zeroed": [(
        "        if (masked_tile && key_masked(qpos, kl, k_offset, sk, "
        "causal)) {\n          p = 0.f;\n        }\n", "")],
    "alpha_dropped": [(
        "      acc[nb][0] *= alpha0;\n      acc[nb][1] *= alpha0;\n"
        "      acc[nb][2] *= alpha1;\n      acc[nb][3] *= alpha1;\n", "")],
    "carry_ignored": [
        ("  float m0 = live0 ? m_in[row_head + row0] : kNegInf;\n"
         "  float m1 = live1 ? m_in[row_head + row1] : kNegInf;\n"
         "  float l0 = live0 ? l_in[row_head + row0] : 0.f;\n"
         "  float l1 = live1 ? l_in[row_head + row1] : 0.f;\n",
         "  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;\n"),
        ("      acc[nb][0] = x0.x;\n      acc[nb][1] = x0.y;\n"
         "      acc[nb][2] = x1.x;\n      acc[nb][3] = x1.y;\n",
         "      acc[nb][0] = acc[nb][1] = acc[nb][2] = acc[nb][3] = 0.f;\n"),
    ],
    "k_offset_ignored": [(
        "  const int q_start = q_offset + q_local;\n",
        "  const int q_start = q_offset + q_local;\n  k_offset = 0;\n")],
}

RUNNER = """
import json, sys
sys.path.insert(0, ".")
import torch
import chip_smoke
from elasticdl_tpu_torch.ops import flash_attention as fa
from elasticdl_tpu_torch.ops import ring_attention as ra

failed = set()
def record(cond, message):
    if not cond:
        failed.add(message.split(" outside")[0].split(":")[0])
_, checks = chip_smoke.chunk_kernel_phase(torch, fa, check=record,
                                          timed=False)
out = []
for c in checks:
    label = "chunk kernel {}/{}/D{}/{}".format(
        c["case"], c["dtype"], c["shape"][3], c["carry"])
    if label in failed:
        out.append({"case": label[len("chunk kernel "):], **{
            o: {"elem": c[o]["elem"], "l2": c[o]["l2"]}
            for o in ("m", "l", "acc")}})
print("FAILED", json.dumps(out))
ring, _ = chip_smoke.ring_check_phase(torch, fa, ra,
                                      check=lambda c, m: None, timed=False)
names = ("out", "dq", "dk", "dv")
print("RING", json.dumps([
    {"shape": c["shape"], "dtype": c["dtype"],
     "ok": all(chip_smoke.within(c[n], c["tol"]) for n in names),
     **{n: {"elem": c[n]["elem"], "l2": c[n]["l2"]} for n in names}}
    for c in ring]))
"""


def mutate(source: str, edits) -> str:
    for old, new in edits:
        if old not in source:
            raise ValueError(f"mutant text not in the source: {old!r}")
        source = source.replace(old, new, 1)
    return source


def run(name: str, edits):
    """(the chunk cases the source fails, its ring readings)."""
    with tempfile.TemporaryDirectory() as tmp:
        copy = os.path.join(tmp, "repo")
        shutil.copytree(REPO, copy, ignore=shutil.ignore_patterns(
            ".git", "_build", "chiprun_out", ".smoke_archive",
            "__pycache__"))
        path = os.path.join(copy, SOURCE)
        with open(path) as f:
            text = f.read()
        with open(path, "w") as f:
            f.write(mutate(text, edits))
        proc = subprocess.run([sys.executable, "-c", RUNNER], cwd=copy,
                              capture_output=True, text=True)
    found = {}
    for line in proc.stdout.splitlines():
        tag, _, rest = line.partition(" ")
        if tag in ("FAILED", "RING"):
            found[tag] = json.loads(rest)
    if proc.returncode != 0 or len(found) < 2:
        raise RuntimeError(f"{name}: the check run failed\n"
                           f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    return found["FAILED"], found["RING"]


def main() -> int:
    bad = []
    for name, edits in [("sound", [])] + list(MUTANTS.items()):
        failed, ring = run(name, edits)
        print(json.dumps({"source": name, "failed_cases": failed,
                          "ring": ring}), flush=True)
        if name == "sound" and not all(case["ok"] for case in ring):
            bad.append(name)
        elif (name == "sound") == bool(failed):
            bad.append(name)
    if bad:
        print(f"chunk_kernel_mutants: not separated: {bad}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
