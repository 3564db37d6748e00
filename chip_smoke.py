#!/usr/bin/env python3
"""GPU smoke of the PyTorch port (``elasticdl_tpu_torch``) on one card.

    python3 chip_smoke.py

1. Prints the card (``nvidia-smi`` name and power limit) and versions.
2. Builds every CUDA kernel of the port from ``elasticdl_tpu_torch/ops/csrc``.
3. Holds each kernel against its plain PyTorch version on the card:
   flash-attention forward at the flagship forward's shape (B 8, H 4,
   S 1024, D 128, causal, bf16), at the served requests' (S 128 and a
   ragged S 100), and at further shapes that reach every instance of
   the kernel (bf16 and f32, head dim 16, 32, 64 and 128, causal and
   not, ragged last tiles); times the kernel, the plain version and the
   PyTorch library call that computes the same function (SDPA, a
   yardstick only) at the first. The zoo twin (head dim 16) runs a
   ragged forward on the card through the kernel.
4. Serves the transformer-LM flagship (vocab 32768, d_model 512, 4 heads
   of 128, 8 layers, d_ff 2048, max_len 1024, bf16, random weights from
   a seed carried through ``bridge.state_dict_from_flax``): exports a
   bundle, starts ``InferenceServer`` on CUDA and sends three JSON
   predicts of 128 tokens, two of them concurrent so the batcher forms
   a batch of two, then one of 100 tokens (a length that is not a tile
   multiple). Kernel launch counts are zeroed just before and read
   just after.
5. Checks every reply is 200, that each layer of each served batch went
   through the kernel (the 100-token request too), that the answers
   match an in-process ``ServedModel.predict`` and the same bundle run
   on the CPU through the plain versions.
6. Times a batched predict at B 8 x S 1024: the forward over several
   windows with CUDA events (median and spread, with the host's time to
   issue each window and the card's clocks after), and the host clock
   around ``ServedModel.predict``.
7. Holds the backward kernels (dq and dk/dv, ``flash_chunk_grads``)
   against their plain version on the card: the flagship's shape (BH 32,
   S 1024, D 128) bf16 causal and not and f32 causal, ragged lengths and
   every head dim, a ring chunk (Sq 512 of Sk 1024 at q_offset 512), the
   zoo twin's training shape, and gradients through ``flash_attention``
   against the CPU plain path. Each check prints its readings (largest
   error, median and largest |w|, relative L2) and, for bf16, the same
   readings of the plain version without its bf16 roundings, which must
   fall outside the limits. Times each kernel, the plain version and
   SDPA's backward (a yardstick only) at the flagship shape.
8. Trains the zoo twin for 5 steps through ``LocalExecutor`` on the card
   and on the CPU from the same seed: the losses, the first step's
   gradients and every parameter's change agree, and the ``--output``
   bundle serves on the card. Steps are recorded by a ``Callback``
   passed to the executor.
9. Trains the flagship through ``LocalExecutor`` (a zoo module written
   to a temp dir calls the twin's ``custom_model`` with the flagship
   config, bench_suite.py's ``_transformer_spec``): 40 steps at B 8 x
   S 1024 on +1-chain records. Launch counts are zeroed just before and
   read just after: 8 forward, 8 dq and 8 dk/dv launches a step. Checks
   finite parameters and a falling loss; times the step with CUDA
   events beside the host's time to issue it.
10. ``embedding kernel check``: every embedding kernel and rule against
   its plain version on the card (``ops/pallas_embedding.py``): both
   lookups (#6 ``lookup_combine``, #5 ``lookup_combine_aligned``) at the
   recsys step's shape (1M x 256, B 512, L 32) and at odd batches,
   widths 16 to 2000 (130: not a multiple of 4), zero-weight rows under
   mean and sqrtn and ids outside the table; the row kernel (#7) under
   SGD, Momentum, Adagrad, Adam and AMSGrad and the fused one (#8, SGD
   and Momentum) at the step's 1M x 256 shape and at odd n, Adam at
   steps 1 and 7, Nesterov on and off, cases where eps matters, with
   pads that carry gradients and every untouched row and slot checked
   bit-equal. Each case prints its readings; the limits sit between the
   sound readings and those of mutants of the sources (PERF.md).
11. ``sparse training``: the recsys twin at full width (1,000,000 x 256
   f32 table, 32 ids an example, Adagrad rows, bf16 MLP, Adam) through
   ``LocalExecutor`` from a zoo module written to a temp dir that pins
   the kernels with ``use_pallas="always"``: 2048 frappe-style records,
   B 512, 6 epochs, 1024 validation records. Launch counts are zeroed
   just before and read just after: lookup = train steps + eval
   batches, row update = train steps. The same run on the library route
   ("never") from the same seed: the losses and the touched rows agree,
   untouched rows stay bit-equal to their initial values, the loss
   falls; step ms (CUDA events) beside issue ms, examples/s, peak memory.
   Then the twin at 100,000 x 64 for 5 steps with the kernels, on the
   card and on the CPU (plain versions), agreeing.
12. ``fused path``: ``DeviceSparseRunner`` over the recsys table with
   Momentum (Nesterov) and ``use_pallas="fused"`` for 10 steps against
   "never": one fused-kernel launch a step.
13. ``sparse sweep``: ``tools/bench_kernel_device_sweep.py``'s tiers
   (kernel, library and bound ms, a JSON line each), the path on which
   kernel #5's launches are counted.
14. Prints a ``serving``, a ``training``, a ``sparse_training`` and a
   ``kernels`` JSON line (the three flash kernels and the four embedding
   kernels with their ms, plain ms, library ms, bound ms and launches;
   the row kernels with a per-rule list) and, last,
   ``{"ok": true, "device": {...}}``.

Any failed phase raises, so the script exits non-zero; without CUDA it
exits 2 and prints no result.
"""

import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np

HBM_BYTES_PER_S = 3.35e12        # H100 SXM
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}
SERVE_TOKENS = 128
RAGGED_TOKENS = 100   # a served length that is not a multiple of the tile
SEED = 0
DEVICE = "cuda"
# bench_suite.py _TRANSFORMER_SIZES["transformer"] at the bench's
# vocab and context.
FLAGSHIP = dict(vocab_size=32768, d_model=512, n_heads=4, n_layers=8,
                d_ff=2048, max_len=1024)

# Stated tolerances. bf16 o: one bf16 rounding of o and of each p
# (relative 2^-9), p taken against the running max in the kernel and the
# final max in the plain version. f32: the order of f32 sums over up to
# 1024 keys. lse: f32 sums in a different order, in both dtypes.
TOL = {"bfloat16": dict(o=2e-2, lse=1e-3), "float32": dict(o=2e-5, lse=2e-5)}
# Backward (dq, dk, dv in f32) against the plain version on the same
# inputs, per tensor: |g - w| <= elem * (|w| + median|w|) at every
# element, and ||g - w|| / ||w|| <= l2. bf16: kernel and plain version
# round ds and p to bf16 at the same points, from an exp whose last f32
# bits differ, so a rounding flips only now and then; one flip in a row
# that sums few terms (the first causal rows) moves an element by about
# 2^-8 of its size, which sets elem. The plain version without those
# roundings (the "unrounded" reading, printed beside) differs by about
# 2^-9 at every term: l2 sits between the two readings, and the script
# checks that the unrounded one fails. f32: sums over up to 1024 keys or
# queries in another order.
BWD_TOL = {"bfloat16": dict(elem=3e-2, l2=2e-4),
           "float32": dict(elem=2e-5, l2=1e-6)}
# Gradients through flash_attention on the card vs the CPU plain path,
# bf16 leaves: o and the gradients are rounded to bf16 on both sides,
# and a flip of o's rounding carries into every gradient of its row.
GRAD_TOL = dict(elem=6e-2, l2=5e-3)
# The zoo twin, 5 Local steps on the card vs the CPU (bf16 products in
# another order): the loss at each step, relative; the first step's
# gradient of every parameter and each parameter's change over the 5
# Adam steps, relative L2 per tensor (Adam's first step is lr * sign(g),
# so a sign that flips on a near-zero gradient moves a whole step). The
# key biases' true gradient is 0 (a bias shared by every key of a row
# leaves its softmax alone): both sides' gradients are noise and Adam
# steps them by it, so they are left out.
TRAJ_TOL = dict(loss=2e-4, grad_l2=2e-2, delta_l2=2.5e-1)
TRAIN_STEPS = 40
TRAIN_BATCH = 8
FLAGSHIP_ZOO = """
import torch

from elasticdl_tpu_torch.model_zoo.transformer import transformer_lm as twin
from elasticdl_tpu_torch.model_zoo.transformer.transformer_lm import (
    dataset_fn, eval_metrics_fn, loss, optimizer)
from elasticdl_tpu_torch.models.transformer import TransformerConfig

CONFIG = TransformerConfig(vocab_size=32768, d_model=512, n_heads=4,
                           n_layers=8, d_ff=2048, max_len=1024,
                           dropout_rate=0.0, remat=False,
                           compute_dtype=torch.bfloat16)


def custom_model(device=None):
    return twin.custom_model(config=CONFIG, device=device)
"""
# The recsys ranker (model_zoo/recsys/recsys_sparse.py, bench_suite.py's
# "recsys" config): a 1M x 256 f32 table, 32 ids an example, batch 512.
EMB_VOCAB, EMB_DIM, EMB_IDS, EMB_BATCH = 1_000_000, 256, 32, 512
# Embedding kernels against their plain versions on the same inputs
# (grad_readings per output; row updates read the change of each touched
# row and slot, kernel vs plain). nvcc contracts a * b + c into fused
# multiply-adds where the plain version rounds the product first: on an
# H100 (80GB HBM3, 700 W) sound readings reach L2 1.2e-7 / elem 5.3e-7
# (lookups) and 4.1e-7 / 4.2e-6 (row updates), while mutants of the
# sources (eps dropped, Nesterov ignored, weights ignored) read 0.47 L2
# or more and a zero denominator gives NaN; a mutant that writes pads
# fails the bit-equality of untouched rows (PERF.md).
EMB_TOL = {"lookup": dict(elem=1e-5, l2=1e-6),
           "rows": dict(elem=3e-5, l2=2e-6)}
RECSYS_TABLE = "item_emb"
SPARSE_RECORDS, SPARSE_EVAL_RECORDS, SPARSE_EPOCHS = 2048, 1024, 6
FUSED_STEPS = 10
SMALL_VOCAB, SMALL_DIM = 100_000, 64
# The recsys twin's zoo module as a user would write it, pinning the
# kernels through the JAX package's own switch (or the library route).
RECSYS_ZOO = """
import functools

from elasticdl_tpu_torch.model_zoo.recsys import recsys_sparse as twin
from elasticdl_tpu_torch.model_zoo.recsys.recsys_sparse import (  # noqa
    custom_model, dataset_fn, eval_metrics_fn, loss, optimizer)

make_sparse_runner = functools.partial(twin.make_sparse_runner,
                                       use_pallas="{mode}")
"""
# The twin at a small width, kernels pinned.
SMALL_ZOO = f"""
from elasticdl_tpu_torch.embedding.device_sparse import (
    DeviceSparseRunner, TableSpec)
from elasticdl_tpu_torch.embedding.optimizer import Adagrad
from elasticdl_tpu_torch.model_zoo.recsys import recsys_sparse as twin
from elasticdl_tpu_torch.model_zoo.recsys.recsys_sparse import (  # noqa
    dataset_fn, eval_metrics_fn, loss, optimizer)

SPECS = (TableSpec(twin.TABLE_NAME, vocab={SMALL_VOCAB}, dim={SMALL_DIM},
                   feature_key=twin.FEATURE_KEY),)


def custom_model(device=None):
    return twin.RecsysRanker(emb_dim={SMALL_DIM}).to(device)


def make_sparse_runner():
    return DeviceSparseRunner(SPECS, Adagrad(lr=0.05), use_pallas="always")
"""
# The recsys twin, kernels ("always", "fused") against the library route
# ("never") on the card from the same seed: per-step losses (relative)
# and the change of the touched rows and their slots (relative L2). The
# rows' first Adagrad steps are ~1e-5 and follow d_emb, which comes back
# through the bf16 MLP: a lookup sum in another order flips bf16
# roundings, and a sound run on an H100 reads 2.3e-2 on the changes
# (max abs 4.2e-6) and 5.7e-5 on the losses, where a wiring fault (rows
# updated with another row's gradient, or not at all) reads about 1.
SPARSE_TOL = dict(loss=1e-3, delta_l2=0.1)
# The small twin, 5 steps on the card vs the CPU: losses (relative), the
# change of the table and of every dense parameter (relative L2; Adam's
# first step is lr * sign(g)).
SMALL_TOL = dict(loss=2e-3, delta_l2=0.25)
# Served logits against the in-process predict / the CPU run of the same
# bundle: relative L2 error. Both run the bf16 model; a different batch
# size or device changes the matrix products' summation order, and a
# one-ulp bf16 difference in one layer carries through the next ones.
LOGITS_REL_TOL = 2e-2


def check(cond, message):
    if not cond:
        raise AssertionError(message)


def cuda_windows(fn, iters, windows, warmup=3):
    """Per-call ms over ``windows`` windows of ``iters`` calls each,
    timed with CUDA events, and the host's ms to issue each window's
    calls (the time before the end event is recorded)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    device_ms, issue_ms = [], []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        issue_ms.append((time.perf_counter() - t0) * 1e3 / iters)
        torch.cuda.synchronize()
        device_ms.append(start.elapsed_time(end) / iters)
    return device_ms, issue_ms


def spread(values):
    return {"median": float(np.median(values)), "min": min(values),
            "max": max(values), "windows": values}


def cuda_ms(fn, iters, windows=5):
    """Median per-call ms over several windows."""
    return float(np.median(cuda_windows(fn, iters, windows)[0]))


def smi(query):
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]


def flash_bound(bh, s, d, dtype, causal):
    """Least time for the flash forward's work on an H100: each input
    read once and each output written once over the memory rate, against
    the unmasked score pairs' two products over the peak rate."""
    elt = 2 if dtype == "bfloat16" else 4
    nbytes = 4 * bh * s * d * elt + bh * s * 4
    pairs = s * (s + 1) // 2 if causal else s * s
    ops = 2 * 2 * bh * pairs * d
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def ptxas_lines(log):
    """(kernel, "registers / spills / shared memory") per compiled
    kernel in an nvcc -Xptxas -v log."""
    import re

    name, out = "?", []
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '_Z\w*?\d"
                          r"([a-z][a-z0-9_]*_kernel)I(\w*?)EE", line)
        if entry:
            targs = re.findall(r"Li(\d+)|Lb(\d)|(float4|float)",
                               entry.group(2))
            name = f"{entry.group(1)}<{','.join(''.join(t) for t in targs)}>"
        elif "spill" in line or "registers" in line or "error" in line:
            out.append((name, line.split(":", 1)[-1].strip()))
    return out


def kernel_phase(torch, fa):
    """Each case: kernel vs plain version on the same inputs; the first
    (the flagship serving shape) is also timed."""
    rng = np.random.default_rng(SEED)
    cases = [  # (b, h, s, d, dtype, causal)
        (8, 4, 1024, 128, "bfloat16", True),   # the B 8 x S 1024 forward
        (2, 4, SERVE_TOKENS, 128, "bfloat16", True),  # a served batch
        (1, 4, RAGGED_TOKENS, 128, "bfloat16", True),  # a ragged request
        (8, 4, 512, 64, "bfloat16", False),
        (2, 4, 256, 64, "bfloat16", True),
        (2, 8, RAGGED_TOKENS, 16, "bfloat16", True),   # the zoo twin
        (2, 4, 200, 32, "bfloat16", False),
        (2, 4, 256, 128, "float32", True),
        (2, 4, 256, 64, "float32", False),
        (2, 4, 130, 16, "float32", True),
        (2, 4, 37, 32, "float32", False),
    ]
    results = []
    for b, h, s, d, dtype_name, causal in cases:
        dtype = getattr(torch, dtype_name)
        q, k, v = (
            torch.from_numpy(rng.standard_normal((b * h, s, d),
                                                 dtype=np.float32))
            .to("cuda", dtype)
            for _ in range(3)
        )
        scale = d ** -0.5
        o, lse = fa.flash_forward_cuda(q, k, v, causal, scale)
        torch.cuda.synchronize()
        o_ref, lse_ref = fa.flash_forward_reference(q, k, v, causal, scale)
        torch.cuda.synchronize()
        o_err = (o.float() - o_ref.float()).abs()
        o_tol = TOL[dtype_name]["o"] * (1 + o_ref.float().abs())
        lse_err = (lse - lse_ref).abs().max().item()
        res = {
            "shape": [b * h, s, d], "dtype": dtype_name, "causal": causal,
            "max_abs_err": o_err.max().item(), "lse_max_abs_err": lse_err,
            "tol": TOL[dtype_name],
        }
        print("kernel check", json.dumps(res), flush=True)
        check(bool(torch.isfinite(o.float()).all()), f"non-finite o {res}")
        check(bool((o_err <= o_tol).all()), f"o outside tolerance {res}")
        check(lse_err <= TOL[dtype_name]["lse"] * (1 + lse_ref.abs().max()
                                                   .item()),
              f"lse outside tolerance {res}")
        results.append((res, (q, k, v, causal, scale, b, h)))
    flagship, (q, k, v, causal, scale, b, h) = results[0]
    bh, s, d = flagship["shape"]
    kernel_windows = cuda_windows(
        lambda: fa.flash_forward_cuda(q, k, v, causal, scale), iters=50,
        windows=5)[0]
    kernel_ms = float(np.median(kernel_windows))
    plain_ms = cuda_ms(lambda: fa.flash_forward_reference(q, k, v, causal,
                                                          scale), iters=5)
    q4, k4, v4 = (x.view(b, h, s, d) for x in (q, k, v))
    library_ms = cuda_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(
            q4, k4, v4, is_causal=causal, scale=scale), iters=50)
    bound_ms, bound_by = flash_bound(bh, s, d, flagship["dtype"], causal)
    return {
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "elasticdl_tpu_torch/ops/csrc/flash_attention_fwd.cu",
        "replaces": "elasticdl_tpu/ops/flash_attention.py:156",
        "shape": flagship["shape"], "dtype": flagship["dtype"],
        "causal": causal,
        "max_abs_err": max(r["max_abs_err"] for r, _ in results),
        "lse_max_abs_err": max(r["lse_max_abs_err"] for r, _ in results),
        "checks": [r for r, _ in results],
        "ms": kernel_ms, "kernel_ms": kernel_ms,
        "kernel_ms_windows": kernel_windows, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms,
    }


def post_json(port, tokens):
    body = json.dumps({"features": tokens.tolist()}).encode("utf-8")
    request = urllib.request.Request(
        f"http://localhost:{port}/v1/predict", data=body,
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(request, timeout=600) as resp:
        return resp.status, json.loads(resp.read())


def rel_err(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def grad_readings(g, w):
    """g against w (tensors, one device): the largest |g - w|, the
    median and largest |w|, the largest |g - w| / (|w| + median|w|)
    ("elem") and ||g - w|| / ||w|| ("l2")."""
    g, w = g.float(), w.float()
    err = (g - w).abs()
    size = w.abs()
    median = size.median().item()
    return {
        "max_abs_err": err.max().item(), "median_abs": median,
        "max_abs": size.max().item(),
        "elem": (err / (size + max(median, 1e-30))).max().item(),
        "l2": (err.norm() / w.norm().clamp_min(1e-30)).item(),
    }


def within(reading, tol):
    return reading["elem"] <= tol["elem"] and reading["l2"] <= tol["l2"]


def zoo_phase(torch, fa):
    """The zoo twin (head dim 16) on the card: a ragged forward goes
    through the kernel in every layer and matches the CPU run."""
    from elasticdl_tpu_torch.model_zoo.transformer import transformer_lm

    torch.manual_seed(SEED)
    model = transformer_lm.custom_model(device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(SEED + 2).integers(
        0, model.cfg.vocab_size, (2, RAGGED_TOKENS)))
    with torch.inference_mode():
        want = model(tokens).numpy()
        model = model.to(DEVICE)
        before = fa.launches
        got = model(tokens.to(DEVICE)).cpu().numpy()
        launches = fa.launches - before
    err = rel_err(got, want)
    print("zoo twin", json.dumps({"head_dim": model.cfg.head_dim,
                                  "seq": RAGGED_TOKENS,
                                  "flash_launches": launches,
                                  "rel_err_vs_cpu_plain": err}), flush=True)
    check(launches == model.cfg.n_layers,
          f"zoo twin: {launches} flash launches for "
          f"{model.cfg.n_layers} layers")
    check(err <= LOGITS_REL_TOL, f"zoo twin != CPU plain: {err}")


def serving_phase(torch, fa, bundle_root):
    from elasticdl_tpu_torch import bridge
    from elasticdl_tpu_torch.models.transformer import (
        TransformerConfig,
        TransformerLM,
    )
    from elasticdl_tpu_torch.serving.export import (
        export_serving_bundle,
        load_model,
    )
    from elasticdl_tpu_torch.serving.model_store import ModelStore
    from elasticdl_tpu_torch.serving.server import InferenceServer

    cfg = TransformerConfig(**FLAGSHIP, compute_dtype=torch.bfloat16)
    model = TransformerLM(cfg)
    model.load_state_dict(bridge.state_dict_from_flax(
        bridge.init_flax_params(cfg, seed=SEED)))
    bundle = os.path.join(bundle_root, "v1")
    rng = np.random.default_rng(SEED + 1)
    export_serving_bundle(
        bundle, model,
        batch_example=np.zeros((1, SERVE_TOKENS), np.int32),
        model_def="transformer.transformer_lm.custom_model", version=1,
    )
    store = ModelStore(bundle_root, device=DEVICE)
    served = store.load_initial()
    server = InferenceServer(store, max_batch_size=8,
                             batch_deadline_ms=200.0, port=0).start()
    lengths = [SERVE_TOKENS] * 3 + [RAGGED_TOKENS]
    requests = [rng.integers(0, cfg.vocab_size, (1, n),
                             dtype=np.int64).astype(np.int32)
                for n in lengths]
    replies = [None] * len(requests)

    def send(i):
        replies[i] = post_json(server.port, requests[i])

    try:
        fa.launches = 0                       # the main path starts here
        t0 = time.monotonic()
        send(0)                               # alone: a batch of one
        pair = [threading.Thread(target=send, args=(i,)) for i in (1, 2)]
        for t in pair:
            t.start()
        for t in pair:
            t.join()
        before_ragged = fa.launches
        send(3)                               # ragged: not a tile multiple
        ragged_launches = fa.launches - before_ragged
        http_s = time.monotonic() - t0
        launches = fa.launches                # ... and ends here
        occupancy = dict(server.predictor.batch_occupancy)
        statuses = [status for status, _ in replies]
    finally:
        server.stop()
    batches = sum(occupancy.values())
    print("serving requests", json.dumps({
        "lengths": lengths, "statuses": statuses,
        "batch_occupancy": occupancy, "flash_launches": launches,
        "ragged_request_launches": ragged_launches, "seconds": http_s}),
        flush=True)
    check(statuses == [200] * len(requests), f"statuses {statuses}")
    check(max(occupancy) > 1, f"no batch larger than one: {occupancy}")
    check(launches == cfg.n_layers * batches,
          f"{launches} flash launches for {batches} batches of "
          f"{cfg.n_layers} layers: a layer left the kernel path")
    check(ragged_launches == cfg.n_layers,
          f"the {RAGGED_TOKENS}-token request made {ragged_launches} "
          f"flash launches, not {cfg.n_layers}")

    answers = [np.asarray(body["predictions"], np.float32)
               for _, body in replies]
    in_process = [served.predict(tokens) for tokens in requests]
    cpu_model = load_model(bundle, device="cpu")
    with torch.inference_mode():
        on_cpu = [cpu_model(torch.from_numpy(requests[i])).numpy()
                  for i in (0, 3)]
    errs = [rel_err(a, b) for a, b in zip(answers, in_process)]
    cpu_errs = [rel_err(answers[i], want) for i, want in zip((0, 3), on_cpu)]
    cpu_err = max(cpu_errs)
    print("serving checks", json.dumps({
        "rel_err_vs_in_process": errs,
        "rel_err_vs_cpu_plain": dict(zip(("s128", "s100"), cpu_errs)),
        "max_abs_err_vs_cpu_plain": max(
            float(np.abs(answers[i] - want).max())
            for i, want in zip((0, 3), on_cpu))}), flush=True)
    for a, n in zip(answers, lengths):
        check(a.shape == (1, n, cfg.vocab_size),
              f"prediction shape {a.shape}")
        check(bool(np.isfinite(a).all()), "non-finite predictions")
    check(max(errs) <= LOGITS_REL_TOL, f"served != in-process: {errs}")
    check(cpu_err <= LOGITS_REL_TOL, f"served != CPU plain: {cpu_errs}")

    # Timing at the full context: B 8 x S 1024.
    big = rng.integers(0, cfg.vocab_size, (8, cfg.max_len),
                       dtype=np.int64).astype(np.int32)
    gpu_model = load_model(bundle, device=DEVICE)
    tokens = torch.from_numpy(big).to(DEVICE)
    with torch.inference_mode():
        forward, issue = cuda_windows(lambda: gpu_model(tokens), iters=5,
                                      windows=9)
    clocks = smi("clocks.sm,clocks.max.sm,power.draw,temperature.gpu")
    t_host = []
    for _ in range(3):
        t0 = time.monotonic()
        out = served.predict(big)
        t_host.append((time.monotonic() - t0) * 1e3)
    check(out.shape == (8, cfg.max_len, cfg.vocab_size)
          and bool(np.isfinite(out).all()), "B8xS1024 predict")
    return {
        "model": "transformer flagship (bench_suite.py _TRANSFORMER_SIZES"
                 "['transformer']), random weights, seed 0",
        "requests": len(replies), "statuses": statuses,
        "batch_occupancy": {str(k): v for k, v in occupancy.items()},
        "flash_launches": launches, "batches": batches,
        "http_seconds": http_s,
        "rel_err_vs_in_process": max(errs),
        "rel_err_vs_cpu_plain": cpu_err,
        "predict_b8_s1024_forward_ms": spread(forward),
        "predict_b8_s1024_issue_ms": spread(issue),
        "clocks_after_forward": clocks,
        "predict_b8_s1024_host_ms": min(t_host),
    }


def bwd_bound(bh, sq, sk, d, dtype, causal, products, outputs):
    """Least time for one backward kernel on an H100: q, k, v, dO read
    once, lse and delta once, ``outputs`` f32 (BH, S, D) tensors written
    once, over the memory rate; against ``products`` products over the
    unmasked pairs at the peak rate."""
    elt = 2 if dtype == "bfloat16" else 4
    nbytes = (2 * bh * sq * d + 2 * bh * sk * d) * elt + 2 * bh * sq * 4 \
        + outputs * bh * sk * d * 4
    pairs = sq * (sq + 1) // 2 if causal else sq * sk
    ops = 2 * products * bh * pairs * d
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def chunk_inputs(torch, rng, bh, sq, sk, d, dtype, causal, q_offset):
    """q, k, v, dO on the card and lse (the scores' logsumexp under the
    mask) and delta = rowsum(dO o o) as the forward would give them."""
    q, do = (torch.from_numpy(rng.standard_normal((bh, sq, d),
                                                  dtype=np.float32))
             .to("cuda", dtype) for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((bh, sk, d),
                                                 dtype=np.float32))
            .to("cuda", dtype) for _ in range(2))
    s = torch.matmul(q.float(), k.float().transpose(1, 2)) * d ** -0.5
    if causal:
        qpos = q_offset + torch.arange(sq, device="cuda")
        kpos = torch.arange(sk, device="cuda")
        s = s.masked_fill(qpos[:, None] < kpos[None, :], -1e30)
    lse = torch.logsumexp(s, dim=-1, keepdim=True)
    p = torch.exp(s - lse)
    o = torch.matmul(p, v.float())
    delta = (do.float() * o).sum(dim=-1, keepdim=True)
    return q, k, v, do, lse.contiguous(), delta.contiguous()


def bwd_kernel_phase(torch, fa):
    """The backward kernels against their plain version, then timed."""
    rng = np.random.default_rng(SEED + 10)
    cases = [  # (bh, sq, sk, d, dtype, causal, q_offset)
        (32, 1024, 1024, 128, "bfloat16", True, 0),   # the flagship step
        (32, 1024, 1024, 128, "bfloat16", False, 0),
        (32, 1024, 1024, 128, "float32", True, 0),
        (8, 100, 100, 128, "bfloat16", True, 0),      # ragged last tiles
        (8, 37, 37, 16, "bfloat16", False, 0),
        (8, 130, 130, 32, "float32", True, 0),
        (8, 200, 200, 64, "float32", False, 0),
        (8, 512, 1024, 128, "bfloat16", True, 512),   # a ring chunk
        (64, 127, 127, 16, "bfloat16", True, 0),      # the zoo twin's step
    ]
    checks = []
    for bh, sq, sk, d, dtype_name, causal, q_offset in cases:
        args = chunk_inputs(torch, rng, bh, sq, sk, d,
                            getattr(torch, dtype_name), causal, q_offset)
        got = fa.flash_chunk_grads_cuda(*args, q_offset, 0, causal,
                                        d ** -0.5)
        torch.cuda.synchronize()
        want = fa.flash_chunk_grads_reference(*args, q_offset, 0, causal,
                                              d ** -0.5)
        unrounded = None
        if dtype_name == "bfloat16":   # the same sums without the roundings
            unrounded = fa.flash_chunk_grads_reference(
                *(x.float() for x in args[:4]), *args[4:], q_offset, 0,
                causal, d ** -0.5)
        torch.cuda.synchronize()
        tol = BWD_TOL[dtype_name]
        res = {"shape": [bh, sq, sk, d], "dtype": dtype_name,
               "causal": causal, "q_offset": q_offset, "tol": tol}
        for i, (name, g, w) in enumerate(zip(("dq", "dk", "dv"), got, want)):
            reading = grad_readings(g, w)
            res[f"{name}_max_abs_err"] = reading["max_abs_err"]
            res[name] = reading
            if unrounded is not None:
                res[f"{name}_unrounded"] = grad_readings(unrounded[i], w)
        print("bwd kernel check", json.dumps(res), flush=True)
        for name, g in zip(("dq", "dk", "dv"), got):
            check(bool(torch.isfinite(g).all()), f"non-finite {name} {res}")
            check(within(res[name], tol), f"{name} outside tolerance {res}")
            if unrounded is not None:
                check(not within(res[f"{name}_unrounded"], tol),
                      f"{name}: the unrounded plain version passes the "
                      f"limits, which could not see a rounding fault {res}")
        checks.append(res)

    # Gradients through flash_attention: card (kernels) vs CPU (plain).
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 256, 4, 128),
                                                    dtype=np.float32))
               .to(torch.bfloat16) for _ in range(3))
    grads = []
    for dev in ("cuda", "cpu"):
        leaves = [x.to(dev).requires_grad_() for x in (q, k, v)]
        out = fa.flash_attention(*leaves)
        (out.float() * out.float().cos()).sum().backward()
        grads.append([x.grad.float().cpu() for x in leaves])
    torch.cuda.synchronize()
    readings = {name: grad_readings(g, w)
                for name, g, w in zip(("dq", "dk", "dv"), *grads)}
    print("bwd autograd check", json.dumps({
        "shape": [2, 256, 4, 128], "dtype": "bfloat16",
        "vs_cpu_plain": readings, "tol": GRAD_TOL}), flush=True)
    for name, reading in readings.items():
        check(within(reading, GRAD_TOL),
              f"flash_attention {name} vs CPU plain: {reading}")

    # Times at the flagship's shape: each kernel alone, through the C
    # entry points (these launches are not counted), the plain version
    # and SDPA's backward for the pair.
    bh, s, d = 32, 1024, 128
    args = chunk_inputs(torch, rng, bh, s, s, d, torch.bfloat16, True, 0)
    lib = fa._bwd_library()
    q, k, v, do, lse, delta = args
    dq = torch.empty(q.shape, dtype=torch.float32, device="cuda")
    dk, dv = torch.empty_like(dq), torch.empty_like(dq)
    ptrs = [t.data_ptr() for t in args]
    tail = (bh, s, s, d, 1, 0, 0, d ** -0.5, 1)

    def launch(name, outs):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, f"edl_flash_attention_bwd_{name}")(
            *ptrs, *(t.data_ptr() for t in outs), *tail, stream)
        check(err == 0, f"{name} launch: CUDA error {err}")

    dq_windows = cuda_windows(lambda: launch("dq", (dq,)), 50, 5)[0]
    dkv_windows = cuda_windows(lambda: launch("dkv", (dk, dv)), 50, 5)[0]
    plain_ms = cuda_ms(lambda: fa.flash_chunk_grads_reference(
        *args, 0, 0, True, d ** -0.5), iters=5)
    q4, k4, v4 = (x.view(8, 4, s, d).detach().requires_grad_()
                  for x in (q, k, v))
    out = torch.nn.functional.scaled_dot_product_attention(
        q4, k4, v4, is_causal=True, scale=d ** -0.5)
    do4 = do.view(8, 4, s, d)
    library_ms = cuda_ms(lambda: torch.autograd.grad(
        out, (q4, k4, v4), do4, retain_graph=True), iters=50)
    errs = {"dq": max(c["dq_max_abs_err"] for c in checks),
            "dkv": max(max(c["dk_max_abs_err"], c["dv_max_abs_err"])
                       for c in checks)}
    rows = []
    for name, replaces, windows, products, outputs in (
            ("flash_attention_bwd_dq",
             "elasticdl_tpu/ops/flash_attention.py:493", dq_windows, 3, 1),
            ("flash_attention_bwd_dkv",
             "elasticdl_tpu/ops/flash_attention.py:528", dkv_windows, 4, 2)):
        bound_ms, bound_by = bwd_bound(bh, s, s, d, "bfloat16", True,
                                       products, outputs)
        rows.append({
            "name": name, "route": "cuda",
            "source": "elasticdl_tpu_torch/ops/csrc/flash_attention_bwd.cu",
            "replaces": replaces, "shape": [bh, s, d], "dtype": "bfloat16",
            "causal": True,
            "max_abs_err": errs[name.rsplit("_", 1)[1]],
            "ms": float(np.median(windows)), "ms_windows": windows,
            "plain_ms": plain_ms, "plain_computes": "dq, dk and dv",
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms,
            "library_call": "SDPA backward (dq, dk and dv together)",
        })
    return rows, checks


def path_ids(rng, vocab, batch, num_ids):
    """A recsys batch's ids and their ``unique_pad`` (sorted distinct ids
    padded with the vocab size to batch x num_ids), as numpy."""
    ids = rng.integers(0, vocab, (batch, num_ids)).astype(np.int32)
    uniq = np.unique(ids)
    pads = np.full(ids.size - uniq.size, vocab, np.int32)
    return ids, np.concatenate([uniq, pads]).astype(np.int32)


def uniform_table(torch, vocab, dim, scale, gen):
    return torch.empty(vocab, dim, device="cuda").uniform_(
        -scale, scale, generator=gen)


def emb_within(reading, tol):
    return (np.isfinite(reading["max_abs_err"]) and within(reading, tol))


def lookup_checks(torch, pe, rng, gen):
    """Both lookup kernels against the plain version: the recsys step's
    shape and the edge cases (odd batches, widths 16-2000 with one not
    a multiple of 4, zero-weight rows under mean and sqrtn, ids outside
    the table)."""
    cases = [  # (vocab, dim, batch, num_ids, combiner, weights)
        (EMB_VOCAB, EMB_DIM, EMB_BATCH, EMB_IDS, "sum", "ones"),
        (4096, 16, 37, 5, "mean", "zero_rows"),
        (4096, 128, 37, 9, "sqrtn", "zero_rows"),
        (4096, 256, 37, 32, "sqrtn", "random"),
        (4096, 512, 64, 64, "sum", "random"),
        (4096, 130, 37, 7, "mean", "zero_rows"),     # D % 4 != 0
        (4096, 2000, 9, 3, "sqrtn", "random"),       # two column tiles
        (4096, 64, 16, 6, "mean", "out_of_range"),
    ]
    checks = []
    tables = {}
    for vocab, dim, batch, num_ids, combiner, kind in cases:
        key = (vocab, dim)
        if key not in tables:
            tables = {key: uniform_table(torch, vocab, dim, dim ** -0.5,
                                         gen)}
        table = tables[key]
        ids = rng.integers(0, vocab, (batch, num_ids)).astype(np.int32)
        w = (np.ones((batch, num_ids), np.float32) if kind == "ones"
             else rng.random((batch, num_ids), dtype=np.float32))
        if kind == "zero_rows":
            w[::3] = 0.0
            w[1, num_ids // 2:] = 0.0
        if kind == "out_of_range":
            ids[::2, 0] = vocab
            ids[1::2, -1] = -1
        ids_t = torch.from_numpy(ids).cuda()
        w_t = torch.from_numpy(w).cuda()
        want = pe.lookup_combine_reference(table, ids_t, w_t, combiner)
        for name, fn in (("lookup_combine", pe.lookup_combine_pallas),
                         ("lookup_combine_aligned",
                          pe.lookup_combine_aligned)):
            got = fn(table, ids_t, w_t, combiner)
            torch.cuda.synchronize()
            reading = grad_readings(got, want)
            res = {"kernel": name, "vocab": vocab, "dim": dim,
                   "batch": batch, "num_ids": num_ids,
                   "combiner": combiner, "weights": kind, **reading,
                   "tol": EMB_TOL["lookup"]}
            print("embedding kernel check", json.dumps(res), flush=True)
            check(bool(torch.isfinite(got).all()), f"non-finite {res}")
            check(emb_within(reading, EMB_TOL["lookup"]),
                  f"{name} outside tolerance {res}")
            checks.append(res)
    try:
        pe.lookup_combine_aligned(tables[(4096, 64)][:4095],
                                  ids_t, w_t, "mean")
        check(False, "aligned lookup took a vocab that is not a multiple "
                     "of 8")
    except ValueError:
        pass
    return checks


RULE_HYPER = {
    "sgd": dict(lr=0.05),
    "momentum": dict(lr=0.05, momentum=0.9),
    "adagrad": dict(lr=0.05, eps=1e-8),
    "adam": dict(lr=0.01, beta1=0.9, beta2=0.999, eps=1e-8),
    "amsgrad": dict(lr=0.01, beta1=0.9, beta2=0.999, eps=1e-8),
}


def rule_slots(torch, rule, vocab, dim, gen, tiny):
    """The rule's slot tables as an optimizer would leave them after a
    few steps (``tiny``: zeros, so that eps matters)."""
    from elasticdl_tpu_torch.ops.pallas_embedding import RULE_SLOTS

    n_slots = RULE_SLOTS[rule]
    if tiny or rule == "sgd":
        return [torch.zeros(vocab, dim, device="cuda")
                for _ in range(n_slots)]
    if rule == "adagrad":
        return [torch.full((vocab, dim), 0.1, device="cuda")]
    return [uniform_table(torch, vocab, dim, 0.01, gen).abs_()
            for _ in range(n_slots)]


def row_update_checks(torch, pe, rng, gen):
    """Kernels #7 (every rule) and #8 (SGD, momentum) against the plain
    version: the recsys step's shape (1M x 256, a batch's unique ids
    padded with the vocab size), odd n and widths 16 and 130, Adam at
    steps 1 and 7, Nesterov on and off, and cases where eps matters
    (zero slots, gradients of 1e-8). Pads carry nonzero gradients; every
    row a pad or nobody names, and its slots, must stay bit-equal."""
    cases = []   # (kernel, rule, vocab, dim, n, step, nesterov, tiny)
    for rule in ("sgd", "momentum", "adagrad", "adam", "amsgrad"):
        cases.append(("row_update", rule, EMB_VOCAB, EMB_DIM, None, 1,
                      False, False))
        cases.append(("row_update", rule, 4096, 16, 37, 1, False, False))
        cases.append(("row_update", rule, 4096, 130, 37, 7, True, False))
    cases += [
        ("row_update", "adam", EMB_VOCAB, EMB_DIM, None, 7, False, False),
        ("row_update", "momentum", EMB_VOCAB, EMB_DIM, None, 1, True,
         False),
        ("row_update", "adagrad", 4096, 256, 37, 1, False, True),
        ("row_update", "adam", 4096, 256, 37, 1, False, True),
        ("row_update", "amsgrad", 4096, 256, 37, 7, False, True),
        ("fused_row_update", "sgd", EMB_VOCAB, EMB_DIM, None, 1, False,
         False),
        ("fused_row_update", "momentum", EMB_VOCAB, EMB_DIM, None, 1,
         False, False),
        ("fused_row_update", "momentum", EMB_VOCAB, EMB_DIM, None, 1,
         True, False),
        ("fused_row_update", "sgd", 4096, 16, 37, 1, False, False),
        ("fused_row_update", "momentum", 4096, 130, 37, 1, True, False),
    ]
    checks = []
    for kernel, rule, vocab, dim, n, step, nesterov, tiny in cases:
        if n is None:     # the path's layout: sorted ids, trailing pads
            _, uids = path_ids(rng, vocab - 1, EMB_BATCH, EMB_IDS)
            uids[uids == vocab - 1] = vocab
        else:             # shuffled, with pads among the ids
            real = rng.choice(vocab - 1, n - 5, replace=False)
            uids = rng.permutation(np.concatenate(
                [real, np.full(5, vocab)])).astype(np.int32)
        grads = rng.standard_normal((uids.size, dim), dtype=np.float32)
        if tiny:
            grads *= 1e-8
        before = [uniform_table(torch, vocab, dim, dim ** -0.5, gen)] + \
            rule_slots(torch, rule, vocab, dim, gen, tiny)
        ids_t = torch.from_numpy(uids).cuda()
        g_t = torch.from_numpy(grads).cuda()
        hyper = dict(RULE_HYPER[rule], nesterov=nesterov)
        got = [t.clone() for t in before]
        pe.row_update(rule, ids_t, g_t, got, fused=kernel != "row_update",
                      step=step, **hyper)
        want = [t.clone() for t in before]
        pe.row_update_reference(
            rule, ids_t, g_t, want,
            bc=pe.bias_corrections(hyper.get("beta1", 0.0),
                                   hyper.get("beta2", 0.0), step), **hyper)
        torch.cuda.synchronize()
        rows = ids_t[ids_t < vocab].long()
        untouched = torch.ones(vocab, dtype=torch.bool, device="cuda")
        untouched[rows] = False
        res = {"kernel": kernel, "rule": rule, "vocab": vocab, "dim": dim,
               "n": int(uids.size), "rows": int(rows.numel()), "step": step,
               "nesterov": nesterov, "eps_matters": tiny,
               "tol": EMB_TOL["rows"]}
        same = True
        for name, g, w, b in zip(("table", "slot0", "slot1", "slot2"), got,
                                 want, before):
            reading = grad_readings(g[rows] - b[rows], w[rows] - b[rows])
            res[name] = reading
            same = same and torch.equal(g[untouched], b[untouched])
        res["untouched_bit_equal"] = bool(same)
        print("embedding kernel check", json.dumps(res), flush=True)
        check(same, f"{kernel} {rule}: a pad or untouched row changed")
        for name in ("table", "slot0", "slot1", "slot2")[:len(got)]:
            check(emb_within(res[name], EMB_TOL["rows"]),
                  f"{kernel} {rule} {name} outside tolerance {res}")
        checks.append(res)
        del before, got, want
    return checks


def embedding_kernel_phase(torch, pe):
    """Every embedding kernel and rule against its plain version on the
    card (no timing)."""
    rng = np.random.default_rng(SEED + 20)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 20)
    return (lookup_checks(torch, pe, rng, gen)
            + row_update_checks(torch, pe, rng, gen))


def table_snapshot(torch):
    """A Callback that keeps a copy of every sparse table (on its device)
    as it stands before the first train step."""
    from elasticdl_tpu_torch.callbacks import Callback

    class TableSnapshot(Callback):
        initial = None

        def on_train_batch_begin(self, owner=None):
            if self.initial is None:
                self.initial = {name: t.clone()
                                for name, t in owner.state.tables.items()}

    return TableSnapshot()


def frappe_ids(num_records, input_length, max_id, seed):
    """The ids ``create_frappe_record_file`` writes for these arguments."""
    rng = np.random.RandomState(seed)
    return np.stack([rng.randint(0, max_id, size=(input_length,))
                     for _ in range(num_records)])


def touched_rows(torch, ids, vocab):
    mask = torch.zeros(vocab, dtype=torch.bool, device="cuda")
    mask[torch.from_numpy(np.unique(ids)).cuda()] = True
    return mask


def window_ms(record, warm, window):
    """Step ms over windows of ``window`` steps after ``warm`` (CUDA
    events) and the host's ms to issue each window's steps."""
    step_ms, issue_ms = [], []
    for i in range(warm, len(record.events) - window + 1, window):
        step_ms.append(record.events[i][0].elapsed_time(
            record.events[i + window - 1][1]) / window)
        issue_ms.append(float(np.mean(record.issue_ms[i:i + window])))
    return step_ms, issue_ms


def write_zoo(root, name, source):
    zoo = os.path.join(root, "zoo")
    os.makedirs(os.path.join(zoo, name), exist_ok=True)
    with open(os.path.join(zoo, name, "rec.py"), "w") as f:
        f.write(source)
    return zoo


def sparse_training_phase(torch, pe, root):
    """The recsys twin at full width through LocalExecutor, its zoo
    module pinning the kernels (use_pallas="always"), then the same run
    on the library route ("never") from the same seed."""
    from elasticdl_tpu_torch.api.local_executor import LocalExecutor
    from elasticdl_tpu_torch.testing import data as tdata

    train = tdata.create_frappe_record_file(
        os.path.join(root, "recsys_train.rec"), SPARSE_RECORDS, seed=SEED,
        input_length=EMB_IDS, max_id=EMB_VOCAB)
    evalf = tdata.create_frappe_record_file(
        os.path.join(root, "recsys_eval.rec"), SPARSE_EVAL_RECORDS,
        seed=SEED + 1, input_length=EMB_IDS, max_id=EMB_VOCAB)
    runs = {}
    for mode in ("always", "never"):
        zoo = write_zoo(root, f"recsys_{mode}", RECSYS_ZOO.format(mode=mode))
        args = tdata.make_local_args(
            zoo, f"recsys_{mode}.rec.custom_model", train,
            validation_data=evalf, minibatch_size=EMB_BATCH,
            num_epochs=SPARSE_EPOCHS, extra=["--random_seed", str(SEED)])
        record, snap = step_recorder(torch), table_snapshot(torch)
        executor = LocalExecutor(args, callbacks=[record, snap])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        pe.reset_launches()                   # the main path starts here
        result = executor.run()
        counts = {"lookup_combine": pe.lookup_launches,   # ... and ends
                  "lookup_combine_aligned": pe.aligned_launches,
                  "row_update": pe.row_update_launches,
                  "row_update_adagrad":
                      pe.row_update_rule_launches["adagrad"],
                  "fused_row_update": pe.fused_launches}
        state = executor.state
        runs[mode] = dict(
            result=result, counts=counts, record=record,
            peak=torch.cuda.max_memory_allocated(),
            initial=snap.initial[RECSYS_TABLE],
            final=state.tables[RECSYS_TABLE],
            accumulator=state.slot_tables[RECSYS_TABLE]["accumulator"])
        del executor, state
    steps = runs["always"]["result"]["steps"]
    eval_batches = -(-SPARSE_EVAL_RECORDS // EMB_BATCH)
    touched = touched_rows(torch, frappe_ids(SPARSE_RECORDS, EMB_IDS,
                                             EMB_VOCAB, SEED), EMB_VOCAB)
    untouched = ~touched
    losses = {m: [float(x) for x in r["record"].loss]
              for m, r in runs.items()}
    per_epoch = steps // SPARSE_EPOCHS
    epoch_loss = [float(np.mean(losses["always"][i:i + per_epoch]))
                  for i in range(0, steps, per_epoch)]
    a, n = runs["always"], runs["never"]
    delta_a = (a["final"][touched] - a["initial"][touched]).cpu().numpy()
    delta_n = (n["final"][touched] - n["initial"][touched]).cpu().numpy()
    acc_a = a["accumulator"][touched].cpu().numpy()
    acc_n = n["accumulator"][touched].cpu().numpy()
    untouched_equal = {m: bool(
        torch.equal(r["final"][untouched], r["initial"][untouched])
        and bool((r["accumulator"][untouched] == 0.1).all()))
        for m, r in runs.items()}
    loss_rel = max(abs(x - y) / abs(y) for x, y in zip(losses["always"],
                                                       losses["never"]))
    step_ms, issue_ms = window_ms(a["record"], warm=per_epoch,
                                  window=per_epoch)
    median = float(np.median(step_ms))
    out = {
        "model": "recsys ranker twin (model_zoo/recsys/recsys_sparse.py: "
                 "1,000,000 x 256 f32 table, 32 ids an example, Adagrad "
                 "rows lr 0.05, MLP 256-256-128-1 bf16, Adam 1e-3), "
                 f"random weights, seed {SEED}",
        "batch": EMB_BATCH, "steps": steps, "eval_batches": eval_batches,
        "launches": a["counts"], "launches_never": n["counts"],
        "losses_always": losses["always"], "losses_never": losses["never"],
        "epoch_mean_loss": epoch_loss,
        "loss_max_rel_diff": loss_rel,
        "table_delta_l2": rel_err(delta_a, delta_n),
        "table_delta_max_abs_err": float(np.abs(delta_a - delta_n).max()),
        "accumulator_l2": rel_err(acc_a, acc_n),
        "touched_rows": int(touched.sum()),
        "untouched_bit_equal": untouched_equal,
        "same_initial_table": bool(torch.equal(a["initial"], n["initial"])),
        "eval_accuracy": {m: r["result"]["eval_metrics"]["accuracy"]
                          for m, r in runs.items()},
        "step_ms": spread(step_ms), "issue_ms": spread(issue_ms),
        "examples_per_s": EMB_BATCH / (median / 1e3),
        "max_memory_allocated_bytes": a["peak"],
        "tol": SPARSE_TOL,
        "clocks_after": smi("clocks.sm,clocks.max.sm,power.draw,"
                            "temperature.gpu"),
    }
    print("sparse training", json.dumps(out), flush=True)
    check(steps == SPARSE_EPOCHS * SPARSE_RECORDS // EMB_BATCH,
          f"{steps} sparse steps")
    check(a["counts"]["lookup_combine"] == steps + eval_batches,
          f"lookup kernel launches {a['counts']} for {steps} steps and "
          f"{eval_batches} eval batches")
    check(a["counts"]["row_update"] == steps
          and a["counts"]["row_update_adagrad"] == steps,
          f"row kernel launches {a['counts']} for {steps} steps")
    check(not any(n["counts"].values()),
          f"the library route launched kernels: {n['counts']}")
    check(out["same_initial_table"], "the two runs start from other tables")
    check(all(untouched_equal.values()),
          f"an untouched row or accumulator moved: {untouched_equal}")
    check(all(np.isfinite(losses["always"])), "non-finite loss")
    check(epoch_loss[-1] < epoch_loss[0],
          f"the loss did not fall: {epoch_loss}")
    check(loss_rel <= SPARSE_TOL["loss"], f"losses always vs never {out}")
    check(out["table_delta_l2"] <= SPARSE_TOL["delta_l2"]
          and out["accumulator_l2"] <= SPARSE_TOL["delta_l2"],
          f"touched rows always vs never {out}")
    runs.clear()
    torch.cuda.empty_cache()
    return out


def small_twin_phase(torch, pe, root):
    """The twin at a small width (100,000 x 64), 5 Local steps with
    use_pallas="always" on the card and on the CPU (plain versions) from
    the same seed: losses, the changed rows and every dense parameter's
    change agree."""
    from elasticdl_tpu_torch.api.local_executor import LocalExecutor
    from elasticdl_tpu_torch.testing import data as tdata

    records = tdata.create_frappe_record_file(
        os.path.join(root, "small.rec"), 5 * 256, seed=SEED + 2,
        input_length=EMB_IDS, max_id=SMALL_VOCAB)
    zoo = write_zoo(root, "small", SMALL_ZOO)
    runs = {}
    for dev in ("cuda", "cpu"):
        args = tdata.make_local_args(
            zoo, "small.rec.custom_model", records, minibatch_size=256,
            extra=["--device", dev, "--random_seed", str(SEED)])
        record, snap = step_recorder(torch), table_snapshot(torch)
        executor = LocalExecutor(args, callbacks=[record, snap])
        pe.reset_launches()
        executor.run()
        counts = (pe.lookup_launches, pe.row_update_launches)
        state = executor.state
        runs[dev] = dict(
            counts=counts, loss=[float(x) for x in record.loss],
            initial=record.initial,
            final={k: p.detach().float().cpu()
                   for k, p in state.model.named_parameters()},
            table0=snap.initial[RECSYS_TABLE].cpu(),
            table=state.tables[RECSYS_TABLE].cpu())
    card, cpu = runs["cuda"], runs["cpu"]
    rel = [abs(x - y) / abs(y) for x, y in zip(card["loss"], cpu["loss"])]
    delta_l2 = {k: rel_err((card["final"][k] - card["initial"][k]).numpy(),
                           (cpu["final"][k] - cpu["initial"][k]).numpy())
                for k in cpu["final"]}
    table_l2 = rel_err((card["table"] - card["table0"]).numpy(),
                       (cpu["table"] - cpu["table0"]).numpy())
    out = {"vocab": SMALL_VOCAB, "dim": SMALL_DIM, "steps": len(rel),
           "launches_card": card["counts"], "launches_cpu": cpu["counts"],
           "losses_card": card["loss"], "losses_cpu": cpu["loss"],
           "loss_max_rel_diff": max(rel), "table_delta_l2": table_l2,
           "param_delta_l2": delta_l2, "tol": SMALL_TOL}
    print("recsys twin card vs cpu", json.dumps(out), flush=True)
    check(len(rel) == 5, f"{len(rel)} small-twin steps")
    check(torch.equal(card["table0"], cpu["table0"]),
          "card and CPU start from other tables")
    check(card["counts"] == (5, 5) and cpu["counts"] == (0, 0),
          f"launches card {card['counts']} cpu {cpu['counts']}")
    check(max(rel) <= SMALL_TOL["loss"], f"card vs CPU losses {out}")
    check(table_l2 <= SMALL_TOL["delta_l2"]
          and max(delta_l2.values()) <= SMALL_TOL["delta_l2"],
          f"card vs CPU changes {out}")
    return out


def fused_path_phase(torch, pe):
    """DeviceSparseRunner(recsys TABLE_SPECS, Momentum(lr 0.05, Nesterov),
    use_pallas="fused") on the twin for FUSED_STEPS steps, against the
    library route ("never") from the same seed: kernel #8 once a step."""
    from elasticdl_tpu_torch.embedding.device_sparse import (
        DeviceSparseRunner,
    )
    from elasticdl_tpu_torch.embedding.optimizer import Momentum
    from elasticdl_tpu_torch.model_zoo.recsys import recsys_sparse as twin

    rng = np.random.default_rng(SEED + 30)
    batches = []
    for _ in range(FUSED_STEPS):
        ids = rng.integers(0, EMB_VOCAB, (EMB_BATCH, EMB_IDS))
        batches.append({"features": {"ids": ids},
                        "labels": (ids.sum(axis=1) % 2).astype(np.int32),
                        "mask": np.ones(EMB_BATCH, np.float32)})
    runs = {}
    for mode in ("fused", "never"):
        torch.manual_seed(SEED)
        runner = DeviceSparseRunner(
            twin.TABLE_SPECS, Momentum(lr=0.05, nesterov=True),
            use_pallas=mode)
        state = runner.init_state(twin.custom_model(device="cuda"),
                                  twin.optimizer(), batches[0], seed=SEED)
        step = runner.train_step(twin.loss)
        initial = state.tables[RECSYS_TABLE].clone()
        pe.reset_launches()                   # the fused path starts here
        losses = [step(state, b)[1]["loss"] for b in batches]
        counts = {"fused_row_update": pe.fused_launches,   # ... and ends
                  "row_update": pe.row_update_launches,
                  "lookup_combine": pe.lookup_launches}
        runs[mode] = dict(losses=[float(x) for x in losses], counts=counts,
                          initial=initial, final=state.tables[RECSYS_TABLE],
                          velocity=state.slot_tables[RECSYS_TABLE][
                              "momentum"])
        del state, runner, step
    touched = touched_rows(torch, np.stack(
        [b["features"]["ids"] for b in batches]), EMB_VOCAB)
    f, n = runs["fused"], runs["never"]
    rel = [abs(x - y) / abs(y) for x, y in zip(f["losses"], n["losses"])]
    out = {
        "steps": FUSED_STEPS, "launches": f["counts"],
        "launches_never": n["counts"], "loss_max_rel_diff": max(rel),
        "table_delta_l2": rel_err(
            (f["final"][touched] - f["initial"][touched]).cpu().numpy(),
            (n["final"][touched] - n["initial"][touched]).cpu().numpy()),
        "velocity_l2": rel_err(f["velocity"][touched].cpu().numpy(),
                               n["velocity"][touched].cpu().numpy()),
        "untouched_bit_equal": bool(
            torch.equal(f["final"][~touched], f["initial"][~touched])
            and bool((f["velocity"][~touched] == 0).all())),
        "tol": SPARSE_TOL,
    }
    print("fused path", json.dumps(out), flush=True)
    check(f["counts"] == {"fused_row_update": FUSED_STEPS, "row_update": 0,
                          "lookup_combine": 0},
          f"fused path launches {f['counts']}")
    check(not any(n["counts"].values()), f"never launched {n['counts']}")
    check(out["untouched_bit_equal"], "fused path moved an untouched row")
    check(max(rel) <= SPARSE_TOL["loss"], f"fused vs never losses {out}")
    check(out["table_delta_l2"] <= SPARSE_TOL["delta_l2"]
          and out["velocity_l2"] <= SPARSE_TOL["delta_l2"],
          f"fused vs never rows {out}")
    runs.clear()
    torch.cuda.empty_cache()
    return out


def sweep_phase(torch, pe):
    """The ported sweep tool's tiers; the lookup tiers are the path on
    which kernel #5 runs (its launches are counted here)."""
    from elasticdl_tpu_torch.tools import bench_kernel_device_sweep as tool

    pe.reset_launches()                       # the sweep path starts here
    result = tool.sweep(seed=SEED)            # prints a JSON line a tier
    counts = {"lookup_combine_aligned": pe.aligned_launches,   # ... ends
              "lookup_combine": pe.lookup_launches,
              "row_update": pe.row_update_launches,
              "fused_row_update": pe.fused_launches}
    print("sparse sweep", json.dumps({"launches": counts}), flush=True)
    check(all(counts.values()), f"a kernel missed the sweep: {counts}")
    return result, counts


def embedding_times(torch, pe):
    """Each embedding kernel at the recsys step's shape (B 512, L 32,
    D 256 over 1M rows; the step's ~16,250 distinct ids), its plain
    version, the library call or route, and the bound."""
    from elasticdl_tpu_torch.embedding.optimizer import Adagrad, Momentum
    from elasticdl_tpu_torch.embedding.optimizer import sparse_apply
    from elasticdl_tpu_torch.tools import bench_kernel_device_sweep as tool

    gen = torch.Generator(device="cuda").manual_seed(SEED + 40)
    rng = np.random.RandomState(SEED + 40)
    table = uniform_table(torch, EMB_VOCAB, EMB_DIM, EMB_DIM ** -0.5, gen)
    sets, distinct = tool.lookup_inputs(EMB_BATCH, EMB_IDS, EMB_DIM, gen)

    def lookup_ms(fn, iters=50):
        return tool.device_ms(tool.cycling(fn, sets), iters)[0]

    lookup = {
        "lookup_combine": lookup_ms(
            lambda i, w: pe.lookup_combine_pallas(table, i, w, "sum")),
        "lookup_combine_aligned": lookup_ms(
            lambda i, w: pe.lookup_combine_aligned(table, i, w, "sum")),
        "plain_ms": lookup_ms(lambda i, w: pe.lookup_combine_reference(
            table, i, w, "sum"), iters=5),
        "library_ms": lookup_ms(lambda i, w: torch.nn.functional
                                .embedding_bag(i, table,
                                               per_sample_weights=w,
                                               mode="sum")),
        "route_ms": lookup_ms(lambda i, w: pe.lookup_combine(
            table, i, w, "sum", force_xla=True)),
        "bound": tool.lookup_bound(EMB_BATCH, EMB_IDS, EMB_DIM, distinct),
        "distinct_rows": distinct,
    }
    del table, sets
    torch.cuda.empty_cache()
    n = EMB_BATCH * EMB_IDS
    usets, real = tool.apply_inputs(n, EMB_DIM, rng)

    def rows_ms(rule, fused=False, iters=20):
        slots = pe.RULE_SLOTS[rule]
        tables = [uniform_table(torch, EMB_VOCAB, EMB_DIM, EMB_DIM ** -0.5,
                                gen)] + [
            torch.full((EMB_VOCAB, EMB_DIM), 0.1, device="cuda")
            for _ in range(slots)]
        ms = tool.device_ms(tool.cycling(lambda i, g: pe.row_update(
            rule, i, g, tables, fused=fused, step=1,
            **dict(RULE_HYPER[rule], nesterov=True)), usets), iters)[0]
        bound = tool.row_update_bound(real, n + 1, EMB_DIM, slots)
        return {"rule": rule, "ms": ms, "bound_ms": bound[0],
                "bound_by": bound[1]}

    def other_ms(fn, opt):
        table = uniform_table(torch, EMB_VOCAB, EMB_DIM, EMB_DIM ** -0.5, gen)
        slots = {name: torch.full((EMB_VOCAB, EMB_DIM), 0.1, device="cuda")
                 for name in opt.slot_names}
        return tool.device_ms(tool.cycling(
            lambda i, g: fn(opt, table, slots, i, g), usets), 5)[0]

    def plain(opt, table, slots, i, g):
        rule = "adagrad" if isinstance(opt, Adagrad) else "momentum"
        return pe.row_update_reference(
            rule, i, g, [table] + list(slots.values()),
            **dict(RULE_HYPER[rule], nesterov=True))

    def route(opt, table, slots, i, g):
        return sparse_apply(opt, table, slots, i, g, step=1,
                            use_pallas="never")

    adagrad = Adagrad(lr=0.05)
    momentum = Momentum(lr=0.05, nesterov=True)
    rows = {
        "rules": [rows_ms(rule) for rule in pe.RULES],
        "fused": [rows_ms(rule, fused=True) for rule in ("sgd", "momentum")],
        "adagrad_plain_ms": other_ms(plain, adagrad),
        "adagrad_route_ms": other_ms(route, adagrad),
        "momentum_plain_ms": other_ms(plain, momentum),
        "momentum_route_ms": other_ms(route, momentum),
        "rows": real, "n": n + 1,
    }
    torch.cuda.empty_cache()
    return lookup, rows


def embedding_kernel_rows(checks, times, counts, sweep_counts):
    """The kernels-line entries of the four embedding kernels."""
    lookup, rows = times
    source = "elasticdl_tpu_torch/ops/csrc/"
    err = {}
    for c in checks:
        reading = max(c.get(k, {}).get("max_abs_err", 0.0)
                      for k in ("table", "slot0", "slot1", "slot2")) \
            if "table" in c else c["max_abs_err"]
        err[c["kernel"]] = max(err.get(c["kernel"], 0.0), reading)
    bound_ms, bound_by = lookup["bound"]
    shape = {"vocab": EMB_VOCAB, "dim": EMB_DIM, "batch": EMB_BATCH,
             "num_ids": EMB_IDS, "combiner": "sum"}
    out = []
    for name, replaces, launches, path in (
            ("lookup_combine", "elasticdl_tpu/ops/pallas_embedding.py:286",
             counts["lookup_combine"], "sparse training (train steps + "
             "eval batches)"),
            ("lookup_combine_aligned",
             "elasticdl_tpu/ops/pallas_embedding.py:242",
             sweep_counts["lookup_combine_aligned"], "sparse sweep")):
        out.append({
            "name": name, "route": "cuda",
            "source": source + "embedding_lookup.cu", "replaces": replaces,
            **shape, "distinct_rows": lookup["distinct_rows"],
            "launches": launches, "launches_path": path,
            "max_abs_err": err[name], "ms": lookup[name],
            "plain_ms": lookup["plain_ms"], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": lookup["library_ms"],
            "library_call": "torch.nn.functional.embedding_bag(mode='sum', "
                            "per_sample_weights)",
            "route_ms": lookup["route_ms"],
        })
    by_rule = {r["rule"]: r for r in rows["rules"]}
    fused = {r["rule"]: r for r in rows["fused"]}
    route_note = ("sparse_apply(use_pallas='never'): gather, apply_rows, "
                  "scatter; a route of several PyTorch calls, not one call")
    for name, replaces, rule, launches, path, sub, plain, route in (
            ("row_update", "elasticdl_tpu/ops/pallas_embedding.py:566",
             "adagrad", counts["row_update"], "sparse training (train "
             "steps, Adagrad)", rows["rules"], rows["adagrad_plain_ms"],
             rows["adagrad_route_ms"]),
            ("fused_row_update", "elasticdl_tpu/ops/pallas_embedding.py:859",
             "momentum", counts["fused_row_update"], "fused path (train "
             "steps, Momentum with Nesterov)", rows["fused"],
             rows["momentum_plain_ms"], rows["momentum_route_ms"])):
        row = (by_rule if name == "row_update" else fused)[rule]
        out.append({
            "name": name, "route": "cuda",
            "source": source + "embedding_row_update.cu",
            "replaces": replaces, "rule": rule, "vocab": EMB_VOCAB,
            "dim": EMB_DIM, "rows": rows["rows"], "n": rows["n"],
            "launches": launches, "launches_path": path,
            "max_abs_err": err[name], "ms": row["ms"], "plain_ms": plain,
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": route, "library_call": route_note,
            "rules": sub,
        })
    return out


def step_recorder(torch):
    """A Callback for LocalExecutor that keeps, per train step, the loss
    tensor, CUDA events around the step (on the card) and the host's ms
    to issue it; and, on the CPU in f32, every parameter before the
    first step and its gradient from the first step."""
    from elasticdl_tpu_torch.callbacks import Callback

    def on_cpu(named):
        return {name: t.detach().float().cpu().clone() for name, t in named}

    class StepRecorder(Callback):
        def __init__(self):
            self.loss, self.events, self.issue_ms = [], [], []
            self.initial = self.first_grads = None

        def on_train_batch_begin(self, owner=None):
            model = owner.state.model
            if self.initial is None:
                self.initial = on_cpu(model.named_parameters())
            self._start = None
            self._t0 = time.perf_counter()
            if owner.device.type == "cuda":
                self._start = torch.cuda.Event(enable_timing=True)
                self._start.record()

        def on_train_batch_end(self, owner=None, metrics=None):
            if self._start is not None:
                end = torch.cuda.Event(enable_timing=True)
                end.record()
                self.events.append((self._start, end))
            self.issue_ms.append((time.perf_counter() - self._t0) * 1e3)
            self.loss.append(metrics["loss"])
            if self.first_grads is None:
                self.first_grads = on_cpu(
                    (name, p.grad)
                    for name, p in owner.state.model.named_parameters()
                    if p.grad is not None)

    return StepRecorder()


def twin_training_phase(torch, fa, root):
    """The zoo twin, 5 Local steps on the card and on the CPU from the
    same seed: the losses, the first step's gradients and the change of
    every parameter agree; the card's --output bundle served on the
    card."""
    from elasticdl_tpu_torch.api.local_executor import LocalExecutor
    from elasticdl_tpu_torch.serving.export import load_predictor
    from elasticdl_tpu_torch.testing import data as tdata

    records = tdata.create_lm_record_file(os.path.join(root, "twin.rec"),
                                          40, seed=SEED, seq_len=127)
    runs, models = {}, {}
    for dev in ("cuda", "cpu"):
        out = os.path.join(root, f"twin_{dev}")
        args = tdata.make_local_args(
            tdata.model_zoo_dir(), "transformer.transformer_lm.custom_model",
            records, minibatch_size=8, extra=[
                "--device", dev, "--max_steps", "5", "--output", out])
        record = step_recorder(torch)
        executor = LocalExecutor(args, callbacks=[record])
        executor.run()
        models[dev] = executor.state.model
        record.final = {name: p.detach().float().cpu()
                        for name, p in models[dev].named_parameters()}
        runs[dev] = record
    card, cpu = runs["cuda"], runs["cpu"]
    losses = {dev: [float(x) for x in run.loss] for dev, run in runs.items()}
    rel = [abs(a - b) / abs(b) for a, b in zip(losses["cuda"], losses["cpu"])]
    # The key biases' gradients are noise on both sides (TRAJ_TOL).
    names = [name for name in cpu.initial
             if not name.endswith("attn.key.bias")]
    grad_l2 = {name: rel_err(card.first_grads[name].numpy(),
                             cpu.first_grads[name].numpy())
               for name in names}
    delta_l2 = {name: rel_err((card.final[name] - card.initial[name]).numpy(),
                              (cpu.final[name] - cpu.initial[name]).numpy())
                for name in names}
    same_start = all(torch.equal(card.initial[n], cpu.initial[n])
                     for n in cpu.initial)
    bundle = os.path.join(root, "twin_cuda")
    predict = load_predictor(bundle, device=DEVICE)
    tokens = np.random.default_rng(SEED + 3).integers(
        0, 256, (2, RAGGED_TOKENS)).astype(np.int32)
    before = fa.launches
    served = predict(tokens)
    served_launches = fa.launches - before
    model = models["cuda"].eval()
    with torch.inference_mode():
        want = model(torch.from_numpy(tokens).to(DEVICE)).cpu().numpy()
    served_err = rel_err(served, want)
    result = {"losses_cuda": losses["cuda"], "losses_cpu": losses["cpu"],
              "loss_max_rel_diff": max(rel),
              "grad_l2_worst": max(grad_l2.items(), key=lambda kv: kv[1]),
              "grad_l2_median": float(np.median(list(grad_l2.values()))),
              "delta_l2_worst": max(delta_l2.items(), key=lambda kv: kv[1]),
              "delta_l2_median": float(np.median(list(delta_l2.values()))),
              "tol": TRAJ_TOL, "served_rel_err": served_err,
              "served_flash_launches": served_launches}
    print("zoo twin training", json.dumps(result), flush=True)
    check(same_start, "twin: card and CPU runs start from other weights")
    check(len(rel) == 5, f"twin steps: {len(rel)}")
    check(max(rel) <= TRAJ_TOL["loss"], f"twin card vs CPU losses: {result}")
    check(max(grad_l2.values()) <= TRAJ_TOL["grad_l2"],
          f"twin card vs CPU first-step gradients: {grad_l2}")
    check(max(delta_l2.values()) <= TRAJ_TOL["delta_l2"],
          f"twin card vs CPU parameter changes: {delta_l2}")
    check(losses["cuda"][-1] < losses["cuda"][0], "twin loss did not fall")
    check(served_launches == model.cfg.n_layers,
          f"served bundle made {served_launches} flash launches")
    check(served_err <= LOGITS_REL_TOL, f"served bundle: {served_err}")
    return result


def training_phase(torch, fa, root):
    """The flagship trained through LocalExecutor on the card."""
    from elasticdl_tpu_torch.api.local_executor import LocalExecutor
    from elasticdl_tpu_torch.testing import data as tdata

    zoo = os.path.join(root, "zoo")
    os.makedirs(os.path.join(zoo, "flagship"))
    with open(os.path.join(zoo, "flagship", "lm.py"), "w") as f:
        f.write(FLAGSHIP_ZOO)
    seq, vocab = FLAGSHIP["max_len"], FLAGSHIP["vocab_size"]
    records = tdata.create_lm_record_file(
        os.path.join(root, "flagship.rec"), TRAIN_STEPS * TRAIN_BATCH,
        seed=SEED, seq_len=seq, vocab=vocab)
    args = tdata.make_local_args(zoo, "flagship.lm.custom_model", records,
                                 minibatch_size=TRAIN_BATCH,
                                 extra=["--random_seed", str(SEED)])
    record = step_recorder(torch)
    executor = LocalExecutor(args, callbacks=[record])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.launches = fa.dq_launches = fa.dkv_launches = 0   # the main path
    result = executor.run()
    counts = {"flash_attention_fwd": fa.launches,                # ... ends
              "flash_attention_bwd_dq": fa.dq_launches,
              "flash_attention_bwd_dkv": fa.dkv_launches}
    peak = torch.cuda.max_memory_allocated()
    clocks = smi("clocks.sm,clocks.max.sm,power.draw,temperature.gpu")
    steps = result["steps"]
    layers = FLAGSHIP["n_layers"]
    losses = [float(x) for x in record.loss]
    finite = all(bool(torch.isfinite(p).all())
                 for p in executor.state.model.parameters())
    warm = 5
    window = 5
    step_ms, issue_ms = [], []
    for i in range(warm, steps - window + 1, window):
        start = record.events[i][0]
        end = record.events[i + window - 1][1]
        step_ms.append(start.elapsed_time(end) / window)
        issue_ms.append(float(np.mean(record.issue_ms[i:i + window])))
    median = float(np.median(step_ms))
    out = {
        "model": "transformer flagship (bench_suite.py _TRANSFORMER_SIZES"
                 "['transformer'], remat off, dropout 0), random weights, "
                 f"seed {SEED}, Adam 1e-3",
        "batch": TRAIN_BATCH, "seq": seq, "steps": steps,
        "launches": counts, "launches_per_step": {
            k: v / steps for k, v in counts.items()},
        "step_ms": spread(step_ms), "issue_ms": spread(issue_ms),
        "tokens_per_s": TRAIN_BATCH * seq / (median / 1e3),
        "max_memory_allocated_bytes": peak,
        "first_loss": losses[0], "last_loss": losses[-1],
        "losses": losses, "params_finite": finite,
        "clocks_after": clocks,
    }
    check(steps == TRAIN_STEPS, f"{steps} steps, not {TRAIN_STEPS}")
    for name, n in counts.items():
        check(n == layers * steps,
              f"{name}: {n} launches in {steps} steps of {layers} layers")
    check(finite, "a parameter is not finite after training")
    check(all(np.isfinite(losses)), "non-finite loss")
    check(losses[-1] < 0.9 * losses[0],
          f"loss did not fall: {losses[0]} -> {losses[-1]}")
    return out, counts


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    from elasticdl_tpu_torch.ops import _build
    from elasticdl_tpu_torch.ops import flash_attention as fa
    from elasticdl_tpu_torch.ops import pallas_embedding as pe

    print(smi("name,power.limit"), flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python "
          f"{sys.version.split()[0]}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.monotonic()
    logs = _build.build_all()
    print(f"built {sorted(logs)} in {time.monotonic() - t0:.1f}s",
          flush=True)
    for name, log in logs.items():
        for kernel_name, line in ptxas_lines(log):
            print(f"  {name}: {kernel_name}: {line}", flush=True)

    kernel = kernel_phase(torch, fa)
    bwd_rows, _ = bwd_kernel_phase(torch, fa)
    zoo_phase(torch, fa)
    emb_checks = embedding_kernel_phase(torch, pe)
    with tempfile.TemporaryDirectory() as root:
        serving = serving_phase(torch, fa, root)
        twin_training_phase(torch, fa, root)
        training, counts = training_phase(torch, fa, root)
        sparse = sparse_training_phase(torch, pe, root)
        small_twin_phase(torch, pe, root)
    fused = fused_path_phase(torch, pe)
    _, sweep_counts = sweep_phase(torch, pe)
    emb_times = embedding_times(torch, pe)
    kernel["launches"] = counts["flash_attention_fwd"]
    kernel["launches_serving"] = serving["flash_launches"]
    for row in bwd_rows:
        row["launches"] = counts[row["name"]]
    emb_rows = embedding_kernel_rows(
        emb_checks, emb_times,
        {**sparse["launches"],
         "fused_row_update": fused["launches"]["fused_row_update"]},
        sweep_counts)
    print(json.dumps({"serving": serving}))
    print(json.dumps({"training": training}))
    print(json.dumps({"sparse_training": sparse}))
    print(json.dumps({"kernels": [kernel] + bwd_rows + emb_rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
