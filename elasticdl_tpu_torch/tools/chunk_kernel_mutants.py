"""Mutants of the chunk-update kernel (#2) against chip_smoke.py's
``chunk kernel check``, on one GPU.

    python -m elasticdl_tpu_torch.tools.chunk_kernel_mutants [--tests
        [--test-file PATH]]

For the sound source and for each mutant below, copies the repository
into a temporary directory, edits ``flash_chunk_update.cu`` there, builds
it and runs ``chip_smoke.chunk_kernel_phase`` with a check that records
instead of raising, then ``chip_smoke.ring_check_phase`` (the ring, which
runs the kernel, against #1/#3/#4 on the whole sequence) the same way,
four copies at a time. Prints one JSON line per source: the chunk cases
that failed, with their readings (elem and relative L2 of m, l and acc,
and whether the C entry's NaN-filled and aliased launches were
bit-equal to the wrapper's), and every ring case's readings (elem and L2
of out, dq, dk, dv, and whether it kept chip_smoke.RING_TOL). A run that
dies (a CUDA fault) counts as failing every case. Exits non-zero if the
sound source fails a case or a ring case, or a mutant fails no chunk
case. The checkout itself is never edited.

``--tests`` runs, instead, the sound source and each of
``WGMMA_MUTANTS`` (the route of bf16 D 64, which the test's cases take)
through ``tests/test_torch_cuda_kernels.py::
test_cuda_chunk_kernel_matches_plain`` (pytest, the ``cuda`` marker) and
prints each source's passed and failed cases; it exits non-zero if the
sound source fails a case or a mutant fails none. ``--test-file`` runs
that test (its ``test_cuda_chunk_kernel_matches_plain``) from another
file, an earlier commit's say, against the same builds.

``MUTANTS`` edit the mma.sync kernel (bf16 D 16 and 32):
- ``p_not_zeroed``: masked probabilities left to underflow (a row whose
  keys are all masked while its m is -1e30 then adds exp(0) = 1);
- ``alpha_dropped``: the accumulator not rescaled when the max grows;
- ``carry_ignored``: (m, l, acc) initialised instead of read;
- ``k_offset_ignored``: the chunk's keys taken to start at position 0.

``WGMMA_MUTANTS`` edit the wgmma kernel (bf16 D 64 and 128):
- ``wgmma_p_not_zeroed``, ``wgmma_alpha_dropped``,
  ``wgmma_carry_ignored``, ``wgmma_k_offset_ignored``: as above;
- ``wgmma_second_state_dropped``: the merge takes consumer 0's state
  alone (consumer 1's m read as -1e30);
- ``wgmma_second_acc_unscaled``: consumer 1's acc added without its
  factor 2^(m1 - m);
- ``wgmma_slot_off_by_one``: the products read K and V from another ring
  slot than the one filled for this key tile;
- ``wgmma_last_tile_dropped``: the key-tile count is one short;
- ``wgmma_ragged_keys_unmasked``: keys past Sk (zero-filled rows, whose
  scores are 0) not masked;
- ``wgmma_no_key_tile_uncopied``: a q tile that no key reaches returns
  without copying its carry to the outputs.
"""

import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SOURCE = os.path.join("elasticdl_tpu_torch", "ops", "csrc",
                      "flash_chunk_update.cu")

# name -> [(text of the sound source, replacement)]; each text must occur,
# and only its first occurrence (the mma.sync kernel's) is replaced.
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

# The same for the wgmma kernel; each text occurs once in the sound
# source, inside flash_chunk_wgmma_kernel
# (tests/test_torch_flash_attention.py).
WGMMA_MUTANTS = {
    "wgmma_p_not_zeroed": [(
        "        if ((dead >> (4 * j + e)) & 1u) p = 0.f;\n", "")],
    "wgmma_alpha_dropped": [(
        "      acc[4 * j] *= alpha0;\n      acc[4 * j + 1] *= alpha0;\n"
        "      acc[4 * j + 2] *= alpha1;\n      acc[4 * j + 3] *= alpha1;\n",
        "")],
    "wgmma_carry_ignored": [(
        "  if (wg == 0) {\n    if (in0) {\n",
        "  if (false) {\n    if (in0) {\n")],
    "wgmma_k_offset_ignored": [(
        "  const int q_start = q_tile * kBlock;  // local position of the "
        "tile's row 0\n",
        "  const int q_start = q_tile * kBlock;\n  k_offset = 0;\n")],
    "wgmma_second_state_dropped": [(
        "    const float om0 = other[kOut * 128 + tid];\n"
        "    const float om1 = other[(kOut + 1) * 128 + tid];\n",
        "    const float om0 = kNegInfLog2;\n"
        "    const float om1 = kNegInfLog2;\n")],
    "wgmma_second_acc_unscaled": [(
        "other[i * 128 + tid] * (hi ? b1 : b0);\n",
        "other[i * 128 + tid];\n")],
    "wgmma_slot_off_by_one": [(
        "    const uint32_t k_tile = base + L::ring + slot * L::slot;\n",
        "    const uint32_t k_tile =\n"
        "        base + L::ring + ((slot + 1) % kSlots) * L::slot;\n")],
    "wgmma_last_tile_dropped": [(
        "  const int count = chunk_num_tiles(q_offset + q_start, k_offset, "
        "sk, causal);\n",
        "  const int count =\n      chunk_num_tiles(q_offset + q_start, "
        "k_offset, sk, causal) - 1;\n")],
    "wgmma_ragged_keys_unmasked": [(
        "          if (kl >= sk || (causal && (e < 2 ? gq0 : gq1) < "
        "k_offset + kl)) {\n",
        "          if (false || (causal && (e < 2 ? gq0 : gq1) < "
        "k_offset + kl)) {\n")],
    "wgmma_no_key_tile_uncopied": [(
        "    copy_carry<D>(m_in, l_in, acc_in, m_out, l_out, acc_out, "
        "rows_at,\n                  tile_rows(q_start, sq));\n", "")],
}

RUNNER = """
import json, sys
sys.path.insert(0, ".")
import torch
import chip_smoke
from elasticdl_tpu_torch.ops import flash_attention as fa
from elasticdl_tpu_torch.ops import ring_attention as ra

torch.backends.cuda.matmul.allow_tf32 = False
_, checks = chip_smoke.chunk_kernel_phase(torch, fa, check=lambda c, m: None,
                                          timed=False)
print("FAILED", json.dumps([
    {"case": "{}/{}/D{}/{}".format(c["case"], c["dtype"], c["shape"][3],
                                   c["carry"]),
     "c_entry_bit_equal": c["c_entry_bit_equal"],
     "aliased_bit_equal": c["aliased_bit_equal"],
     **{o: {"elem": c[o]["elem"], "l2": c[o]["l2"]}
        for o in ("m", "l", "acc")}}
    for c in checks if not c["ok"]]))
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


TEST_FILE = os.path.join("tests", "test_torch_cuda_kernels.py")


def pytest_cmd(test_file: str):
    return [sys.executable, "-m", "pytest", "--noconftest", "-o",
            "markers=cuda", "-m", "cuda", "-q", "-p", "no:cacheprovider",
            test_file, "-k",
            "test_cuda_chunk_kernel_matches_plain and not ring_past"]


def _in_copy(edits, cmd):
    """``cmd`` run in a temporary copy of the repository whose chunk
    source carries ``edits``: the CompletedProcess, or the message of a
    run that timed out."""
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
        try:
            return subprocess.run(cmd, cwd=copy, capture_output=True,
                                  text=True, timeout=600)
        except subprocess.TimeoutExpired as exc:
            return f"timed out after {exc.timeout} s"


def run(name: str, edits):
    """(the chunk cases the source fails, its ring readings), or (the
    tail of the output of a run that died, None)."""
    proc = _in_copy(edits, [sys.executable, "-c", RUNNER])
    if isinstance(proc, str):
        return proc, None
    found = {}
    for line in proc.stdout.splitlines():
        tag, _, rest = line.partition(" ")
        if tag in ("FAILED", "RING"):
            found[tag] = json.loads(rest)
    if proc.returncode != 0 or "FAILED" not in found:
        return f"{proc.stdout[-2000:]}\n{proc.stderr[-2000:]}", None
    return found["FAILED"], found.get("RING")


def run_tests(edits, test_file: str):
    """{"passed", "failed"}: pytest's counts for the chunk test on this
    source (cases that errored count as failed; a run that timed out
    reads ``failed`` None)."""
    proc = _in_copy(edits, pytest_cmd(test_file))
    if isinstance(proc, str):
        return {"passed": 0, "failed": None, "note": proc}
    counts = {word: sum(int(n) for n in re.findall(rf"(\d+) {word}",
                                                   proc.stdout[-400:]))
              for word in ("passed", "failed", "error")}
    return {"passed": counts["passed"],
            "failed": counts["failed"] + counts["error"]}


def main_tests(test_file: str) -> int:
    sources = [("sound", [])] + list(WGMMA_MUTANTS.items())
    with ThreadPoolExecutor(4) as pool:
        results = list(pool.map(lambda item: run_tests(item[1], test_file),
                                sources))
    bad = []
    for (name, _), counts in zip(sources, results):
        print(json.dumps({"source": name, "test_file": test_file,
                          **counts}), flush=True)
        sound = counts["failed"] == 0 and counts["passed"] > 0
        if sound != (name == "sound"):
            bad.append(name)
    if bad:
        print(f"chunk_kernel_mutants --tests: not separated: {bad}",
              file=sys.stderr)
        return 1
    return 0


def main() -> int:
    argv = sys.argv[1:]
    if "--tests" in argv:
        test_file = TEST_FILE
        if "--test-file" in argv:
            test_file = os.path.abspath(argv[argv.index("--test-file") + 1])
        return main_tests(test_file)
    sources = [("sound", [])] + list(MUTANTS.items()) + list(
        WGMMA_MUTANTS.items())
    with ThreadPoolExecutor(4) as pool:
        results = list(pool.map(lambda item: run(*item), sources))
    bad = []
    for (name, _), (failed, ring) in zip(sources, results):
        died = isinstance(failed, str)
        print(json.dumps({"source": name, "died": died,
                          "failed_cases": failed, "ring": ring}),
              flush=True)
        if name == "sound":
            if died or failed or ring is None \
                    or not all(case["ok"] for case in ring):
                bad.append(name)
        elif not died and not failed:
            bad.append(name)
    if bad:
        print(f"chunk_kernel_mutants: not separated: {bad}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
