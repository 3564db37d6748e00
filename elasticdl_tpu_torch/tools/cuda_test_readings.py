"""Readings behind two cases of tests/test_torch_cuda_kernels.py, on the
card:

    python -m elasticdl_tpu_torch.tools.cuda_test_readings

- the chunk update (#2), bf16 D 64, every ``CHUNK_CASES`` kind: for m,
  l and acc, the largest |g - w| / (1 + |w|) against the plain version
  folded in the kernel's own order (the test's limit is 2e-2), and the
  elem (max |g - w| / (|w| + median|w|)) and relative L2 readings
  against the plain version over the whole chunk (the test holds them to
  chip_smoke.CHUNK_WHOLE_TOL), each for the kernel and for the own-order
  plain version;
- the lookups (#5, #6) at the ``L96`` case (V 64, D 256, B 37, 96 ids a
  row, ids outside the table late in the row): per combiner, the largest
  |kernel - plain|, the elements past the test's limit (atol 1e-6 +
  rtol 1e-5 |plain|), whether kernel and plain are bit-equal, and the
  kernel's and the plain version's largest distance from the same sum
  taken in numpy float64 from the test's arrays.

It rebuilds the test's inputs from the same seeds; it prints one JSON
line per reading.
"""

import json

import numpy as np
import torch

from elasticdl_tpu_torch.ops import flash_attention as fa
from elasticdl_tpu_torch.ops import pallas_embedding as pe

CHUNK_CASES = {
    "diagonal": (16, 16, 16, 16, True),
    "past": (16, 16, 32, 0, True),
    "future": (16, 16, 0, 16, True),
    "first_rows_masked": (16, 24, 8, 12, True),
    "ragged": (20, 37, 40, 10, True),
    "full": (16, 24, 0, 0, False),
}
V = 64


def _ratio(got, want):
    return float(((got.double() - want.double()).abs()
                  / (1 + want.double().abs())).max())


def _elem_l2(got, want):
    """[elem, l2]: max |g - w| / (|w| + median|w|), ||g - w|| / ||w||."""
    got, want = got.double(), want.double()
    err = (got - want).abs()
    floor = max(float(want.abs().median()), 1e-30)
    return [float((err / (want.abs() + floor)).max()),
            float(err.norm() / max(float(want.norm()), 1e-30))]


def _carry(bh, sq, d, seed):
    rng = np.random.default_rng(seed)
    m = rng.standard_normal((bh, sq, 1), dtype=np.float32)
    l = rng.uniform(0.5, 3.0, (bh, sq, 1)).astype(np.float32)
    acc = rng.standard_normal((bh, sq, d), dtype=np.float32)
    return m, l, acc


def chunk_readings(dtype=torch.bfloat16, d=64):
    for case, (sq, sk, q_off, k_off, causal) in sorted(CHUNK_CASES.items()):
        rng = np.random.default_rng(3)
        q = rng.standard_normal((8, sq * 8, d), dtype=np.float32)
        k, v = (rng.standard_normal((8, sk * 8, d), dtype=np.float32)
                for _ in range(2))
        args = [torch.from_numpy(x).to("cuda", dtype) for x in (q, k, v)] + [
            torch.from_numpy(x).cuda() for x in _carry(8, sq * 8, d, 5)]
        offsets = (q_off * 8, k_off * 8, causal)
        got = fa.flash_chunk_update(*args, *offsets)
        whole = fa.flash_chunk_update_reference(*args, *offsets)
        order = fa.flash_chunk_update_reference(
            *args, *offsets, block_k=fa.chunk_block_k(d, dtype),
            consumers=fa.chunk_consumers(d, dtype))
        print(json.dumps({"chunk": case, "dtype": str(dtype), "d": d,
                          "outputs": ["m", "l", "acc"],
                          "kernel_vs_own_order": [_ratio(g, w) for g, w in
                                                  zip(got, order)],
                          "kernel_vs_whole_elem_l2": [
                              _elem_l2(g, w) for g, w in zip(got, whole)],
                          "own_order_vs_whole_elem_l2": [
                              _elem_l2(o, w) for o, w in zip(order, whole)],
                          "own_order_vs_whole": [_ratio(o, w) for o, w in
                                                 zip(order, whole)]}))


def lookup_readings(dim=256, batch=37, num_ids=96):
    rng = np.random.RandomState(7)
    table = rng.randn(V, dim).astype(np.float32)
    ids = rng.randint(0, V, (batch, num_ids)).astype(np.int32)
    weights = rng.rand(batch, num_ids).astype(np.float32)
    weights[2] = 0.0
    weights[3, 2:] = 0.0
    ids[::2, -26] = V
    ids[1::2, -6] = -1
    ids[::3, -1] = V
    t = torch.from_numpy(table).cuda()
    i, w = torch.from_numpy(ids).cuda(), torch.from_numpy(weights).cuda()
    for fn in (pe.lookup_combine_pallas, pe.lookup_combine_aligned):
        for combiner in ("sum", "mean", "sqrtn"):
            got = fn(t, i, w, combiner)
            want = pe.lookup_combine_reference(t, i, w, combiner)
            exact = f64_lookup(table, ids, weights, combiner)
            got, want = got.cpu().numpy(), want.cpu().numpy()
            diff = np.abs(got - want)
            print(json.dumps({
                "lookup": fn.__name__, "combiner": combiner,
                "max_abs": float(diff.max()),
                "past_limit": int((diff > 1e-6 + 1e-5 * np.abs(want)).sum()),
                "elements": diff.size,
                "bit_equal": bool(np.array_equal(got.view(np.int32),
                                                 want.view(np.int32))),
                "kernel_vs_f64": float(np.abs(got - exact).max()),
                "plain_vs_f64": float(np.abs(want - exact).max()),
            }))


def f64_lookup(table, ids, weights, combiner):
    """The lookup of the numpy arrays, every step in float64 (an id
    outside [0, V) reads as a zero row)."""
    vocab = table.shape[0]
    valid = (ids >= 0) & (ids < vocab)
    rows = np.where(valid[..., None],
                    table.astype(np.float64)[np.clip(ids, 0, vocab - 1)],
                    0.0)
    w = weights.astype(np.float64)
    acc = (w[..., None] * rows).sum(axis=1)
    if combiner == "sum":
        return acc
    denom = (w.sum(axis=1) if combiner == "mean"
             else np.sqrt((w * w).sum(axis=1)))[:, None]
    return np.where(denom > 0, acc / np.where(denom > 0, denom, 1.0), 0.0)


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("cuda_test_readings needs a CUDA device")
    print(json.dumps({"device": torch.cuda.get_device_name(0)}))
    chunk_readings()
    lookup_readings()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
