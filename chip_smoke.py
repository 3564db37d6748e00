#!/usr/bin/env python3
"""GPU smoke of the PyTorch port (``elasticdl_tpu_torch``) on one card.

    python3 chip_smoke.py                # every phase below
    python3 chip_smoke.py --phase fwd    # kernel #1 alone: build, check, time
    python3 chip_smoke.py --phase bwd    # kernels #3 and #4 alone
    python3 chip_smoke.py --phase chunk  # kernel #2 alone
    python3 chip_smoke.py --phase lookup # kernels #5 and #6 alone
    python3 chip_smoke.py --phase host   # the host tier alone, no kernel build
    python3 chip_smoke.py --phase vision # the vision zoo alone, no build
    python3 chip_smoke.py --phase tabular # the tabular zoo alone, no build
    python3 chip_smoke.py --phase checkpoint # checkpoints and the jobs
                                             # alone (embedding kernels)

1. Prints the card (``nvidia-smi`` name and power limit) and versions.
2. Builds every CUDA kernel of the port from ``elasticdl_tpu_torch/ops/csrc``.
3. Holds each kernel against its plain PyTorch version on the card:
   flash-attention forward (#1) folded over the kernel's own key tiles
   and, beside it, over the whole score matrix, at the flagship
   forward's shape (B 8, H 4, S 1024, D 128, causal, bf16), at the
   served requests' (S 128 and a ragged S 100), at BH 4 x S 8192, and at
   further shapes that reach every instance of the kernel (bf16 and
   f32, head dim 16, 32, 64 and 128, causal and not, ragged last tiles,
   scores below -1e30); bf16 cases also read the plain version without
   p's rounding, which must fail. Times the kernel's device time (a CUDA
   graph of 50 launches) beside the CUDA-event window of 50 calls and
   its issue time, the plain version and the PyTorch library call that
   computes the same function (SDPA, a yardstick only, its device time
   measured the same way) at B 8 x S 1024 and BH 4 x S 8192. The zoo
   twin (head dim 16) runs a ragged forward on the card through the
   kernel.
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
   against their plain version on the card, launched through their C
   entry points into outputs filled with NaN: the flagship's shape (BH
   32, S 1024, D 128) bf16 causal and not and f32 causal, ragged lengths
   and every head dim, a ring chunk (Sq 512 of Sk 1024 at q_offset 512),
   the zoo twin's training shape, keys beyond every causal query (their
   k tiles must store zeros), q rows before every key (k_offset 128:
   their dq rows must be zeros, at D 128 and 32, both dq routes), the
   ring's wholly future pair (every gradient zero), and the ring's local
   block (BH 4, 2048, D 128) as a past and as the diagonal chunk; then
   gradients through ``flash_attention`` against the CPU plain path.
   Each check prints its readings (largest error, median and largest
   |w|, relative L2) and, for bf16, the same readings of the plain
   version without its bf16 roundings, which must fall outside the
   limits. Prints the dq kernels' ptxas lines (registers, spills, shared
   memory, wgmma serialization). Times each kernel's device time (a CUDA
   graph of 50 launches) beside its bound and SDPA's flash backward op
   on the same work, measured the same way (a yardstick only), and the
   pair's sum, at the flagship shape and the ring's two chunks, and the
   plain version at the flagship shape.
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
   mean and sqrtn and ids outside the table, and cases that reach #5's
   ring and grid (ids outside the table on reused ring slots at L 96,
   rows split into column strips at B 1 and 64, D 4, and a table viewed
   at a 4-byte offset, #5's 4-byte instance; #5's lines name its
   instance and ring), each launched again through its C entry point
   into a NaN-filled output that must equal the wrapper's bit for bit
   (``--phase lookup`` runs these cases alone, then times #5, #6,
   ``embedding_bag`` and the bound at the sweep's four tiers, and prints
   the two lookup kernels' rows); the row kernel (#7) under
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
11b. ``host training`` (the host tier; ``--phase host`` runs it alone):
   2048 frappe records (10 ids in [0, 5500)), the deepfm_host twin
   through ``LocalExecutor`` at B 512 for 4 epochs, once on the card and
   once on the CPU from the same seed, through a zoo module written to a
   temp dir whose runner applies rows synchronously: per-step losses and
   the touched rows' change agree, the table holds exactly the touched
   ids, untouched ids read their lazy initial rows, the loss falls, the
   table is the native store (``g++``-built at first use; its build
   seconds printed), and no kernel launches. Then the zoo's own runner
   (async apply) on the card for 8 epochs: finite parameters, a falling
   loss, step ms (CUDA events) beside issue ms and examples/s. Then the
   host engine alone at the recsys shape (a native 1,000,000 x 256 f32
   table, lazily materialised, 16,384 ids a batch, Adagrad rows): median
   ms of dedup, row pull, pad, the whole prepare, device placement and
   apply. Then deepfm_functional (BASELINE #4) for 5 Local steps on the
   card and on the CPU: losses, first-step gradients and every
   parameter's change within the zoo twin's limits, no kernel launches.
11c. ``vision`` (BatchNorm and the vision zoo; ``--phase vision`` runs
   it alone): mnist_functional through ``LocalExecutor`` at B 512 for 5
   steps on the learnable mnist records, on the card and on the CPU from
   the same seed: losses, first-step gradients, every parameter's
   change (TRAJ_TOL) and the running statistics agree; the card's
   ``--output`` bundle served on the card (``load_served_model``)
   answers as the trained model's eval forward; on the card a full batch
   moves the statistics and a batch with padded rows leaves them
   bit-equal, from a host mask and from a batch already on the card.
   Then the resnet50 twin (``custom_model()``: s2d stem, 10 classes) at
   B 128 x 224 x 224 through the executor's train step on bench_suite's
   synthetic batches, 3 untimed and 10 timed steps: step ms (CUDA
   events) beside issue ms, examples/s, peak memory; a finite loss and
   every statistic moved. Every kernel counter reads 0 on these paths.
11d. ``tabular`` (the preprocessing package and the tabular zoo;
   ``--phase tabular`` runs it alone): census_wide_deep (BASELINE #5),
   census_dnn, census_feature_columns, census_sqlflow and heart on
   their generators' records, iris from a CSV, each through
   ``LocalExecutor`` at B 512 for 5 steps on the card and on the CPU
   from the same seed: losses, first-step gradients and every
   parameter's change (TRAJ_TOL). Then census_wide_deep on 4096 records
   for 3 epochs on the card, evaluated on 1024 at the end: step ms (CUDA
   events) beside issue ms, examples/s, peak memory, and its
   ``dataset_fn`` on one batch on the host; its card run's ``--output``
   bundle served by ``InferenceServer`` on the card answers a JSON
   predict of dict features as the trained model's eval forward. Every
   kernel counter is zeroed before the phase and reads 0 after it.
11e. ``checkpoint`` (checkpoints, resume and the evaluate/predict
   jobs; ``--phase checkpoint`` runs it alone and builds only the
   embedding kernels): (a) the recsys twin at full width with the
   kernels pinned, a straight run of 8 steps over records A then B
   against a split run, A with ``--checkpoint_steps 4`` and a new
   executor restored by ``--checkpoint_dir_for_init`` over B, each run
   evaluated on one batch: the restored state (table, accumulator,
   dense parameters, Adam slots, step, generator, table steps) equals
   the saved one bit for bit; the resumed losses, the touched rows'
   change and accumulator within SPARSE_TOL of the straight run;
   untouched rows bit-equal; launches exactly lookup = steps + eval
   batches and Adagrad row updates = steps on each run; the save's
   stall, seconds, bytes and GB/s and the restore's seconds from the
   port's registry, the card's peak memory and the host's RSS. (b)
   deepfm_host, a base and two deltas (``--checkpoint_delta_chain 2``)
   resumed from the chain: host rows and slots bit-equal after the
   restore, losses and rows within HOST_TOL of a straight run, no
   kernel launch. (c) census_wide_deep with its schedule compressed in
   versions: the split run's learning rate at each version equals the
   straight run's; ``python -m elasticdl_tpu_torch evaluate`` and
   ``predict`` in subprocesses on the card from the checkpoint: metrics
   equal to the training executor's final eval, predictions (the zoo
   module's ``PredictionOutputsProcessor``) bit-equal to its eval
   forward; TensorBoard's scalars carry the eval metrics.
12. ``fused path``: ``DeviceSparseRunner`` over the recsys table with
   Momentum (Nesterov) and ``use_pallas="fused"`` for 10 steps against
   "never": one fused-kernel launch a step.
13. ``sparse sweep``: ``tools/bench_kernel_device_sweep.py``'s tiers
   (kernel, library and bound ms, a JSON line each), the path on which
   kernel #5's launches are counted.
14. ``chunk kernel check`` (after the backward checks): the ring's
   chunk-update kernel (#2, ``flash_chunk_update``) against its plain
   version folded in the kernel's own order (64-key tiles; on the wgmma
   route even tiles into the carry, odd ones into an empty state, then
   merged), and in one call over the whole chunk: f32 and bf16, head
   dims 16-128 (both bf16 routes), causal and not, a diagonal, a past
   and a wholly future chunk, one that masks only the first rows, one
   key tile and an odd number of them, Sq != Sk and ragged lengths, an
   initial carry and one folded from an earlier chunk; bf16 cases also
   read the plain version without the rounding of p, which must fail.
   Each case launches again through the C entry point into outputs
   filled with NaN and with the outputs aliasing a copy of the carry:
   both must equal the wrapper's bit for bit. Prints the kernels' ptxas
   lines. Times the kernel's device time (a CUDA graph of 50 launches)
   beside its event windows and issue time at the ring's local block
   (BH 4, 2048, bf16) for a past and a diagonal chunk at D 128 and 64,
   each beside its bound, the plain version and SDPA's flash forward
   with logsumexp over the same chunk (a yardstick: the chunk's products
   without the carry).
15. ``ring check``: ``ring_attention`` over ``make_mesh((4,), ("sp",),
   [cuda:0] * 4)`` against kernel #1 (and #3/#4) on the whole sequence,
   output and dq, dk, dv, at B 1 x S 8192 and B 8 x S 1024 (bf16), and
   f32 against the CPU plain ring; the whole ring forward at S 8192
   timed beside #1 and SDPA.
16. ``ring training``: the flagship's widths at max_len 8192 with remat,
   B 1 x S 8192, 10 Adam steps through ``MeshRunner`` on the (4,) sp
   mesh, and the same steps through ``core.step.build_train_step``
   (#1) from the same weights and batches: losses agree; exact launch
   counts (per step 256 chunk updates, 128 dq, 128 dk/dv; 128 chunk
   updates an eval batch); step ms beside issue ms, tokens/s, peak
   memory.
17. Prints a ``serving``, a ``training``, a ``sparse_training``, a
   ``ring_training``, a ``host_training``, a ``vision``, a ``tabular``,
   a ``checkpoint`` and a ``kernels`` JSON line (the four flash kernels
   and the four embedding kernels with their ms, plain ms, library ms,
   bound ms and launches, and their launches on the host, vision,
   tabular and checkpoint paths, ``launches_host_training``,
   ``launches_vision``, ``launches_tabular``, ``launches_checkpoint``
   (the straight, first and resumed recsys runs); #5 with its times at
   the sweep's tiers, the row kernels with a per-rule list) and, last,
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
# The forward (#1) against its plain version folded over the kernel's
# own key-tile width (fa.forward_block_k: 128 for the wgmma kernel, 64
# for the others), so that both round p to bf16 against the same running
# max: o per case, |g - w| <= elem * (|w| + median|w|) at every element
# and ||g - w|| / ||w|| <= l2; lse |g - w| <= lse * (1 + |w|). bf16: only
# an exp or a product sum that differs in its last f32 bit flips a
# rounding of p or of o; the plain version without p's rounding (the
# "unrounded" reading, o still rounded to bf16) must fail. f32: sums over
# 64 keys in another order. On an H100 (80GB HBM3, 700 W) sound bf16
# readings reach elem 1.4e-2, L2 1.6e-4, lse 2.9e-7 and the unrounded
# version L2 1.8e-3 or more; the limits sit between the sound readings
# and those of the mutants in tools/flash_fwd_mutants.py (PERF.md).
FWD_TOL = {"bfloat16": dict(elem=3e-2, l2=5e-4, lse=1e-5),
           "float32": dict(elem=2e-5, l2=1e-6, lse=1e-5)}
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
# The host tier: the deepfm_host twin at its widths (a
# 5500-id table of 16, 10 ids an example, bf16 MLP 64-32-1, SGD rows at
# 0.05, Adam 1e-3) through LocalExecutor at bench_suite's deepfm batch,
# card against CPU with a synchronous runner; then the zoo's own
# (asynchronous) runner on the card, timed over HOST_TIMED_EPOCHS.
HOST_RECORDS, HOST_BATCH, HOST_EPOCHS, HOST_TIMED_EPOCHS = 2048, 512, 4, 8
HOST_IDS, HOST_MAX_ID = 10, 5500
# Card vs CPU: per-step losses (relative) and the change of the touched
# rows (relative L2). The MLP computes in bf16 on both, with other
# summation orders (cuBLAS against the CPU's GEMM), so bf16 roundings
# flip; the rows' SGD steps follow d_emb through that MLP.
HOST_TOL = dict(loss=2e-2, delta_l2=2e-2)
# The sync runner's zoo module: the twin with async_apply off, so the
# card and CPU runs apply every step's rows before the next pull.
HOST_ZOO = """
from elasticdl_tpu_torch.embedding.host_engine import HostStepRunner
from elasticdl_tpu_torch.model_zoo.deepfm import deepfm_host as twin
from elasticdl_tpu_torch.model_zoo.deepfm.deepfm_host import (  # noqa
    custom_model, dataset_fn, eval_metrics_fn, loss, optimizer)


def make_host_runner():
    return HostStepRunner(twin.make_host_runner().engine, async_apply=False)
"""
# The zoo's asynchronous runner on the card against a synchronous one,
# over HOST_DISJOINT_BATCHES batches each drawing its ids from a span of
# the id range of its own: no pull reads a row that an apply still in
# flight writes, so losses and the table must be bit-equal. This holds
# the paths that run only on the card: the row gradients' copy on a side
# stream into pinned memory, and the pull-ahead's pinned placement.
HOST_DISJOINT_BATCHES = 8
# The host engine alone at the recsys table's shape: a native
# EMB_VOCAB x EMB_DIM f32 table, materialised lazily, EMB_IDS ids an
# example at EMB_BATCH, uniform ids as the recsys records draw them,
# Adagrad rows (the recsys rule). Cold: HOST_ENGINE_BATCHES fresh
# batches, nearly every id a first touch. Warm: the same batches again,
# every row resident. The first HOST_ENGINE_SKIP batches of each pass
# are not counted.
HOST_ENGINE_BATCHES, HOST_ENGINE_SKIP = 12, 2
# deepfm_functional (BASELINE #4), card vs CPU for this many Local steps
# at HOST_BATCH, held to TRAJ_TOL as the transformer twin is.
DEEPFM_STEPS = 5
# The vision zoo (bench_suite.py CONFIGS: mnist at B 512, resnet50 at
# B 128 x 224 x 224). mnist_functional runs VISION_STEPS Local steps on
# the card and on the CPU from the same seed, on the learnable mnist
# records (testing.data: the label's block of pixels brightened), held
# to TRAJ_TOL: the loss, the first step's gradients and each parameter's
# change; the running statistics after the run at VISION_STATS_TOL
# (relative L2): they average bf16 activations that cuDNN's and
# oneDNN's convolutions sum in other orders, as the gradients do. Then
# the padded-batch guard on the card, and the --output bundle served on
# the card against the trained model's eval forward (LOGITS_REL_TOL).
# resnet50 (the zoo's custom_model(): s2d stem, 10 classes) takes
# VISION_WARM untimed and VISION_TIMED timed steps at RESNET_BATCH on
# bench_suite's synthetic batches (uniform [0, 1) images).
VISION_BATCH, VISION_STEPS = 512, 5
VISION_STATS_TOL = 2e-2
RESNET_BATCH, RESNET_HW = 128, 224
VISION_WARM, VISION_TIMED = 3, 10
# The tabular zoo (bench_suite.py CONFIGS["census"] at B 512).
# Each twin runs TABULAR_STEPS Local steps on the card and on the CPU
# from the same seed, held to TRAJ_TOL: census_wide_deep (BASELINE #5),
# census_dnn, census_feature_columns and census_sqlflow on
# CENSUS_RECORDS census records, heart on its records, iris from a CSV.
# Then census_wide_deep through the executor on the card for
# TABULAR_TIMED_EPOCHS over the census records, the first TABULAR_WARM
# steps untimed, evaluated on CENSUS_EVAL_RECORDS at the end; its
# dataset_fn alone on one batch of records on the host, TABULAR_DECODES
# times; and the card run's --output bundle served by InferenceServer
# on the card: one JSON predict of dict features ({"ids", "dense"})
# against the trained model's eval forward (LOGITS_REL_TOL).
TABULAR_BATCH, TABULAR_STEPS = 512, 5
CENSUS_RECORDS, CENSUS_EVAL_RECORDS, TABULAR_RECORDS = 4096, 1024, 2560
TABULAR_TIMED_EPOCHS, TABULAR_WARM, TABULAR_DECODES = 3, 4, 10
TABULAR_SERVED_ROWS = 8
# (model_def, records: "census", "heart" or "iris")
TABULAR_TWINS = (
    ("census.census_wide_deep.custom_model", "census"),
    ("census.census_dnn.custom_model", "census"),
    ("census.census_feature_columns.custom_model", "census"),
    ("census.census_sqlflow.custom_model", "census"),
    ("heart.heart.custom_model", "heart"),
    ("iris.iris_dnn.custom_model", "iris"),
)
# Checkpoints, resume and the evaluate/predict jobs (slice 14; ``--phase
# checkpoint`` runs it alone). (a) The recsys twin at full width, its
# kernels pinned (RECSYS_ZOO "always"): a straight run over records A
# then B (CKPT_RECORDS each: 4 steps at EMB_BATCH), against a split run:
# A with --checkpoint_steps CKPT_STEPS, then a new executor restored
# from it over B; each run evaluated on CKPT_EVAL_RECORDS (one batch).
# The restored state equals the saved one bit for bit; the resumed
# losses and the touched rows' change and accumulator follow the
# straight run within SPARSE_TOL (the row gradients' index_add uses
# atomics on the card, so two runs differ by rounding).
CKPT_RECORDS, CKPT_EVAL_RECORDS, CKPT_STEPS = 2048, 512, 4
# (b) deepfm_host (HOST_ZOO, synchronous rows) at HOST_BATCH: A of
# HOST_CKPT_A records (6 steps) saved every 2 versions as a base and two
# deltas (--checkpoint_delta_chain 2), resumed over B (HOST_CKPT_B, 2
# steps), against a straight run, within HOST_TOL.
HOST_CKPT_A, HOST_CKPT_B = 3072, 1024
# (c) census_wide_deep (BASELINE #5) with its schedule read at
# CENSUS_LR_SCALE times the version, so the schedule's steps (versions
# 5000 and 12000) fall at versions 2 and 5 of a run of 8 steps at
# TABULAR_BATCH (records A and B, CKPT_RECORDS each); split at
# CKPT_STEPS. Then `python -m elasticdl_tpu_torch evaluate` and
# `predict` in subprocesses on the card from the straight run's
# checkpoint, on CENSUS_EVAL_RECORDS: the metrics equal the training
# executor's final eval and the predictions its eval forward, bit for
# bit (the same card, kernels and shapes).
CENSUS_LR_SCALE = 2500
CKPT_ZOO_CENSUS = f"""
import os

import numpy as np

from elasticdl_tpu_torch.callbacks import LearningRateScheduler
from elasticdl_tpu_torch.model_zoo.census import census_wide_deep as twin
from elasticdl_tpu_torch.model_zoo.census.census_wide_deep import (  # noqa
    custom_model, dataset_fn, eval_metrics_fn, loss, optimizer)


def callbacks():
    return [LearningRateScheduler(
        lambda v: twin.lr_multiplier({CENSUS_LR_SCALE} * v))]


class PredictionOutputsProcessor:
    \"\"\"Saves each batch of predictions beside this module.\"\"\"

    def __init__(self):
        self.batches = 0

    def process(self, predictions, worker_id):
        path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            f"predictions-{{self.batches:04d}}.npy")
        np.save(path, predictions)
        self.batches += 1
"""
# Ring attention over an sp mesh of one card (slice 4): the long-context
# row of tools/bench_long_context.py, (S 8192, B 1, remat), on the
# flagship's widths, the sequence cut over RING_SP ranks (chunks of 2048).
RING_SP = 4
RING_SEQ = 8192
RING_TRAIN_STEPS = 10
# The chunk-update kernel (#2) against its plain version on the same
# inputs, folded over the kernel's 64-key tiles (so both take p against
# the same running maximum and round it to bf16 at the same points) and,
# read beside it, in one call over the whole chunk. Per output (m, l,
# acc): |g - w| <= elem * (|w| + median|w|) at every element and
# ||g - w|| / ||w|| <= l2, as the backward checks. bf16: only an exp or
# a product sum that differs in its last f32 bit flips a rounding, and
# the plain version without the rounding of p (the "unrounded" reading)
# must fail. f32: sums over 64 keys in another order.
CHUNK_TOL = {"bfloat16": dict(elem=3e-2, l2=2e-4),
             "float32": dict(elem=2e-5, l2=1e-6)}
# The whole-chunk plain version rounds p against the chunk's final
# maximum, the kernel against each tile's running one: a different bf16
# rounding of every p (2^-9 relative) that passes through the sums.
CHUNK_WHOLE_TOL = {"bfloat16": dict(elem=6e-2, l2=5e-3),
                   "float32": dict(elem=2e-5, l2=1e-6)}
# The ring on the card against kernel #1 (and #3/#4) over the whole
# sequence, bf16: p rounded against other maxima (as CHUNK_WHOLE_TOL),
# dq summed over the ring's chunks in f32 before its bf16 rounding. #1
# rounds p against 128-key tiles' running maxima (the wgmma kernel), the
# ring's #2 against 64-key tiles' in its own chunk order, so o and with
# it delta = rowsum(dO o o) differ by a rounding at many rows; where
# dp - delta cancels, that moves an element of dk by up to 7.8e-2 of
# (|w| + median|w|) on an H100 (80GB HBM3, 700 W), at L2 1.2e-3. The
# mutants of #2 that the ring check sees (tools/chunk_kernel_mutants.py:
# alpha dropped, carry ignored, k_offset ignored) read elem 6.6 or more
# there (PERF.md).
RING_TOL = {"bfloat16": dict(elem=1e-1, l2=5e-3),
            "float32": dict(elem=2e-5, l2=2e-6)}
# The flagship trained on the ring against the same steps through kernel
# #1 on the whole sequence, from the same weights and batches: per-step
# loss, relative. bf16 attention outputs that differ in their last bits
# read 2.7e-5 over 4 steps on an H100 (80GB HBM3, 700 W); a ring that
# folds a chunk at the wrong offset changes the attention of whole rows.
RING_TRAIN_TOL = dict(loss=1e-3)
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
    kernel in an nvcc -Xptxas -v log, and each warning (ptxas says so
    where it must serialize wgmma instructions)."""
    import re

    name, out = "?", []
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(_Z\w*)'", line)
        # The mangled name's kernel is the <length><name> pair whose
        # length matches (an anonymous namespace's hash may precede it).
        found = entry and next(
            (m for m in re.finditer(r"(?=(\d+)([a-z][a-z0-9_]*?_kernel)I"
                                    r"(\w*?)EE)", entry.group(1))
             if int(m.group(1)) == len(m.group(2))), None)
        if entry:
            targs = re.findall(r"Li(\d+)|Lb(\d)|(float4|float)",
                               found.group(3)) if found else []
            name = (f"{found.group(2)}<{','.join(''.join(t) for t in targs)}>"
                    if found else "?")
        elif any(word in line for word in ("spill", "registers", "error",
                                           "warning", "Performance")):
            out.append((name, line.split(":", 1)[-1].strip()))
    return out


def graph_ms(torch, fn, iters=50, replays=5):
    """Device ms per call with no host issue inside the window: ``iters``
    calls captured in one CUDA graph, each replay timed with CUDA events
    (one entry per replay)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):   # warm up off the capture
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    out = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end) / iters)
    return out


# Kernel #1's cases: (name, b, h, s, d, dtype, causal). "flagship" (the
# B 8 x S 1024 forward) and "long" (BH 4 x S 8192, the ring's
# single-device comparison) are timed. "saturated" sets q = 2^50 and
# k = -2^50 everywhere, so every score (exact in f32) lies below -1e30,
# the running max's start: every p underflows to 0 and o = 0, lse =
# -1e30 + log(1e-30), unless a masked key's p, exp(-1e30 - -1e30) = 1,
# is left unzeroed or the mask or the start is -inf. p is exactly 0 or
# 1 (no rounding to see), and the whole-matrix version takes each row's
# max from its scores alone (its last row, with no masked key, then
# differs), so the case is held to the tiled version only.
FWD_CASES = [
    ("flagship", 8, 4, 1024, 128, "bfloat16", True),
    ("served", 2, 4, SERVE_TOKENS, 128, "bfloat16", True),
    ("ragged", 1, 4, RAGGED_TOKENS, 128, "bfloat16", True),
    ("long", 1, 4, RING_SEQ, 128, "bfloat16", True),
    ("ragged", 2, 4, 1000, 128, "bfloat16", False),
    ("full", 8, 4, 512, 64, "bfloat16", False),
    ("causal", 2, 4, 256, 64, "bfloat16", True),
    ("ragged", 2, 4, 300, 64, "bfloat16", True),
    ("twin", 2, 8, RAGGED_TOKENS, 16, "bfloat16", True),
    ("ragged", 2, 4, 200, 32, "bfloat16", False),
    ("saturated", 1, 4, 384, 128, "bfloat16", True),
    ("saturated", 1, 4, 200, 16, "bfloat16", True),
    ("causal", 2, 4, 256, 128, "float32", True),
    ("full", 2, 4, 256, 64, "float32", False),
    ("ragged", 2, 4, 130, 16, "float32", True),
    ("ragged", 2, 4, 37, 32, "float32", False),
]
FWD_TIMED = ("flagship", "long")


def fwd_kernel(torch, fa, d, dtype):
    """The kernel #1 takes at a (head dim, dtype): the dispatch by head
    dim in flash_attention_fwd.cu, read through its key-tile width."""
    if dtype != torch.bfloat16:
        return "f32 scalar, 64-key tiles"
    if fa.forward_block_k(d, dtype) == 128:
        return "wgmma: TMA ring, 128 q rows, 128-key tiles"
    return "mma.sync: cp.async ring, 64 q rows, 64-key tiles"


def fwd_inputs(torch, rng, name, bh, s, d, dtype):
    q, k, v = (torch.from_numpy(rng.standard_normal((bh, s, d),
                                                    dtype=np.float32))
               .to(DEVICE, dtype) for _ in range(3))
    if name == "saturated":
        q, k = torch.full_like(q, 2.0 ** 50), torch.full_like(k, -2.0 ** 50)
    return q, k, v


def lse_reading(got, want):
    """The largest |got - want| / (1 + |want|)."""
    return ((got - want).abs() / (1 + want.abs())).max().item()


def kernel_phase(torch, fa, check=check, timed=True):
    """Kernel #1 against its plain version on the card over FWD_CASES:
    folded over the kernel's own key tiles (FWD_TOL) and, read beside
    it, over the whole score matrix (TOL); then its device time at the
    timed shapes. ``check`` may record instead of raise
    (tools/flash_fwd_mutants.py); each case's "ok" says whether it
    passed."""
    lib = fa._library()
    rng = np.random.default_rng(SEED)
    checks, timing = [], {}
    for name, b, h, s, d, dtype_name, causal in FWD_CASES:
        dtype = getattr(torch, dtype_name)
        q, k, v = fwd_inputs(torch, rng, name, b * h, s, d, dtype)
        scale = d ** -0.5
        block_k = fa.forward_block_k(d, dtype)
        o, lse = fa.flash_forward_cuda(q, k, v, causal, scale)
        torch.cuda.synchronize()
        o_tiled, lse_tiled = fa.flash_forward_reference(q, k, v, causal,
                                                        scale, block_k)
        o_whole, lse_whole = fa.flash_forward_reference(q, k, v, causal,
                                                        scale)
        rounds = dtype_name == "bfloat16" and name != "saturated"
        if rounds:   # p unrounded, o still rounded to bf16
            o_unrounded = fa.flash_forward_reference(
                q.float(), k.float(), v.float(), causal, scale,
                block_k)[0].to(dtype)
        torch.cuda.synchronize()
        tol, whole_tol = FWD_TOL[dtype_name], TOL[dtype_name]
        label = (f"{name}/{dtype_name}/D{d}/S{s}/"
                 f"{'causal' if causal else 'full'}")
        res = {"case": label, "shape": [b * h, s, d], "kernel":
               fwd_kernel(torch, fa, d, dtype), "block_k": block_k, "tol": tol,
               "o": grad_readings(o, o_tiled),
               "lse": lse_reading(lse, lse_tiled)}
        o_err = (o.float() - o_whole.float()).abs()
        res["whole"] = {
            "max_abs_err": o_err.max().item(),
            "o_ok": bool((o_err <= whole_tol["o"]
                          * (1 + o_whole.float().abs())).all()),
            "lse_max_abs_err": (lse - lse_whole).abs().max().item(),
            "lse_ok": (lse - lse_whole).abs().max().item()
            <= whole_tol["lse"] * (1 + lse_whole.abs().max().item()),
            "tol": whole_tol, "held": name != "saturated"}
        ok = (bool(torch.isfinite(o.float()).all())
              and within(res["o"], tol) and res["lse"] <= tol["lse"])
        if res["whole"]["held"]:
            ok = ok and res["whole"]["o_ok"] and res["whole"]["lse_ok"]
        if rounds:
            res["o_unrounded"] = grad_readings(o_unrounded, o_tiled)
        res["ok"] = ok
        print("kernel check", json.dumps(res), flush=True)
        check(ok, f"kernel {label}: outside tolerance {res}")
        if rounds:
            check(not within(res["o_unrounded"], tol),
                  f"kernel {label}: the unrounded plain version passes "
                  f"the limits, which could not see a rounding fault {res}")
        checks.append(res)
        if timed and name in FWD_TIMED:
            timing[name] = (q, k, v, causal, scale, b, h)
    if not timed:
        return None, checks
    times = {name: fwd_times(torch, fa, lib, *args)
             for name, args in timing.items()}
    flagship = times["flagship"]
    return {
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "elasticdl_tpu_torch/ops/csrc/flash_attention_fwd.cu",
        "replaces": "elasticdl_tpu/ops/flash_attention.py:156",
        "kernels": {f"bfloat16 D{d}": fwd_kernel(torch, fa, d, torch.bfloat16)
                    for d in fa.HEAD_DIMS},
        "shape": flagship["shape"], "dtype": "bfloat16", "causal": True,
        "max_abs_err": max(c["o"]["max_abs_err"] for c in checks),
        "lse_max_abs_err": max(c["whole"]["lse_max_abs_err"]
                               for c in checks if c["whole"]["held"]),
        "checks": checks,
        **{key: flagship[key] for key in (
            "ms", "ms_replays", "event_ms", "issue_ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms", "library_event_ms")},
        "kernel_ms": flagship["ms"],
        "ms_source": "CUDA graph of 50 launches, replayed, CUDA events",
        "long": times["long"],
    }, checks


def fwd_times(torch, fa, lib, q, k, v, causal, scale, b, h):
    """Kernel #1's device time (a graph of raw launches: these are not
    counted) beside the CUDA-event window of 50 wrapper calls and its
    issue time, SDPA's device time measured the same way, the plain
    version and the bound."""
    bh, s, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((bh, s), dtype=torch.float32, device=DEVICE)
    ptrs = [t.data_ptr() for t in (q, k, v, o, lse)]

    def launch():
        err = lib.edl_flash_attention_fwd(
            *ptrs, bh, s, d, 1, scale, int(causal),
            torch.cuda.current_stream().cuda_stream)
        check(err == 0, f"flash forward launch: CUDA error {err}")

    q4, k4, v4 = (x.view(b, h, s, d) for x in (q, k, v))

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            q4, k4, v4, is_causal=causal, scale=scale)

    device_ms = graph_ms(torch, launch)
    event_ms, issue_ms = cuda_windows(
        lambda: fa.flash_forward_cuda(q, k, v, causal, scale), 50, 5)
    library_ms = graph_ms(torch, sdpa)
    bound_ms, bound_by = flash_bound(bh, s, d, "bfloat16", causal)
    return {
        "shape": [bh, s, d], "ms": float(np.median(device_ms)),
        "ms_replays": device_ms, "event_ms": float(np.median(event_ms)),
        "issue_ms": float(np.median(issue_ms)),
        "plain_ms": cuda_ms(lambda: fa.flash_forward_reference(
            q, k, v, causal, scale), iters=5),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": float(np.median(library_ms)),
        "library_event_ms": cuda_ms(sdpa, iters=50),
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


def bwd_bound(bh, sq, sk, d, dtype, causal, products, outputs,
              q_offset=0, k_offset=0):
    """Least time for one backward kernel on an H100: q, dO (BH, Sq, D),
    k, v (BH, Sk, D), lse and delta read once, ``outputs`` f32 gradients
    written once (dq: (BH, Sq, D); dk, dv: (BH, Sk, D)), over the memory
    rate; against ``products`` products over the pairs the mask leaves at
    these offsets, at the peak rate."""
    elt = 2 if dtype == "bfloat16" else 4
    rows = sq if outputs == 1 else sk
    nbytes = (2 * bh * sq * d + 2 * bh * sk * d) * elt + 2 * bh * sq * 4 \
        + outputs * bh * rows * d * 4
    pairs = unmasked_pairs(sq, sk, q_offset, k_offset, causal)
    ops = 2 * products * bh * pairs * d
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def chunk_inputs(torch, rng, bh, sq, sk, d, dtype, causal, q_offset,
                 k_offset=0):
    """q, k, v, dO on the card and lse (the scores' logsumexp under the
    mask at these global offsets) and delta = rowsum(dO o o) as the
    forward would give them. A row that no key reaches has lse -1e30."""
    q, do = (torch.from_numpy(rng.standard_normal((bh, sq, d),
                                                  dtype=np.float32))
             .to("cuda", dtype) for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((bh, sk, d),
                                                 dtype=np.float32))
            .to("cuda", dtype) for _ in range(2))
    s = torch.matmul(q.float(), k.float().transpose(1, 2)) * d ** -0.5
    if causal:
        qpos = q_offset + torch.arange(sq, device="cuda")
        kpos = k_offset + torch.arange(sk, device="cuda")
        s = s.masked_fill(qpos[:, None] < kpos[None, :], -1e30)
    lse = torch.logsumexp(s, dim=-1, keepdim=True)
    p = torch.exp(s - lse)
    o = torch.matmul(p, v.float())
    delta = (do.float() * o).sum(dim=-1, keepdim=True)
    return q, k, v, do, lse.contiguous(), delta.contiguous()


# The backward kernels' cases: (name, bh, sq, sk, d, dtype, causal,
# q_offset, k_offset). The C entry points' outputs are filled with NaN
# before each launch, so a row left unstored shows. "beyond": keys
# 384-511 come after every query, so their k tiles meet no query and
# must store exact zeros; fewer than half the rows are zero, so that
# median |w|, elem's floor, is not 0. "before": keys start at 128, so
# the first 128 q rows (two q tiles) reach no key and their dq rows must
# be exact zeros, again fewer than half; at D 128 and 32, both dq
# routes. "future" is the ring's wholly future pair at sp 4: no query
# reaches any key, and dq, dk and dv must be exact zeros. Every gradient
# there is 0 (the plain version without its roundings too), so elem and
# L2 say nothing, and elem's floor would be 0: the case is held by its
# zeros alone. "ring_past" and "ring_diagonal" are the ring's local
# block at sp 4 (BH 4, 2048, D 128): a past chunk, every pair unmasked,
# and the diagonal chunk; they and "flagship" are timed. The bf16 D 64
# "ragged" case holds both wgmma kernels' D 64 instances. The cases draw
# their inputs in turn from one seeded generator, so new cases are
# appended: each earlier case keeps its inputs.
BWD_CASES = [
    ("flagship", 32, 1024, 1024, 128, "bfloat16", True, 0, 0),
    ("full", 32, 1024, 1024, 128, "bfloat16", False, 0, 0),
    ("flagship", 32, 1024, 1024, 128, "float32", True, 0, 0),
    ("ragged", 8, 100, 100, 128, "bfloat16", True, 0, 0),
    ("ragged", 8, 37, 37, 16, "bfloat16", False, 0, 0),
    ("ragged", 8, 130, 130, 32, "float32", True, 0, 0),
    ("ragged", 8, 200, 200, 64, "float32", False, 0, 0),
    ("chunk", 8, 512, 1024, 128, "bfloat16", True, 512, 0),
    ("twin", 64, 127, 127, 16, "bfloat16", True, 0, 0),
    ("beyond", 8, 384, 512, 128, "bfloat16", True, 0, 0),
    ("beyond", 8, 384, 512, 32, "bfloat16", True, 0, 0),
    ("beyond", 8, 384, 512, 64, "float32", True, 0, 0),
    ("ring_past", 4, 2048, 2048, 128, "bfloat16", True, 2048, 0),
    ("ring_diagonal", 4, 2048, 2048, 128, "bfloat16", True, 0, 0),
    ("ragged", 8, 200, 200, 64, "bfloat16", True, 0, 0),
    ("before", 8, 384, 256, 128, "bfloat16", True, 0, 128),
    ("before", 8, 384, 256, 32, "bfloat16", True, 0, 128),
    ("future", 4, 2048, 2048, 128, "bfloat16", True, 0, 2048),
]
BWD_TIMED = ("flagship", "ring_past", "ring_diagonal")


def bwd_launcher(fa, lib, args, outs, q_offset, causal, k_offset=0):
    """Launches of the dq and dk/dv kernels of ``lib`` through their C
    entry points (not counted), writing into ``outs`` = (dq, dk, dv)."""
    scale = args[0].shape[-1] ** -0.5

    def launch(name):
        targets = outs[:1] if name == "dq" else outs[1:]
        err = fa._bwd_launch(lib, name, args, targets, q_offset, k_offset,
                             causal, scale)
        check(err == 0, f"{name} launch: CUDA error {err}")

    return launch


def kernel_ptxas(log, prefix):
    """ptxas's lines about the kernels whose names start with ``prefix``
    in a build log: registers, spills and shared memory of each
    instance, and any warning that names one (C7512/C7518: wgmma
    serialized)."""
    lines = [f"{kernel}: {line}" for kernel, line in ptxas_lines(log)
             if kernel.startswith(prefix) and "Performance" not in line]
    lines += [line.strip() for line in log.splitlines()
              if prefix in line and ("warning" in line or "C75" in line)]
    return lines


def bwd_kernel_phase(torch, fa, check=check, timed=True):
    """The backward kernels against their plain version over BWD_CASES,
    through the wrapper every caller uses (flash_chunk_grads_cuda), and
    launched again through their C entry points into outputs filled with
    NaN (a row left unstored shows), which must equal the wrapper's bit
    for bit (the kernels sum in a fixed order); rows that no key or no
    query reaches must be exact zeros there. Then the dq kernels' ptxas
    lines and the device times. ``check`` may record instead of raise
    (tools/flash_bwd_mutants.py); each case's "ok" says whether it
    passed."""
    lib = fa._bwd_library()
    rng = np.random.default_rng(SEED + 10)
    checks, timing = [], {}
    for (name, bh, sq, sk, d, dtype_name, causal, q_offset,
         k_offset) in BWD_CASES:
        dtype = getattr(torch, dtype_name)
        args = chunk_inputs(torch, rng, bh, sq, sk, d, dtype, causal,
                            q_offset, k_offset)
        got = fa.flash_chunk_grads_cuda(*args, q_offset, k_offset, causal,
                                        d ** -0.5)
        raw = tuple(torch.full((bh, rows, d), float("nan"), device=DEVICE)
                    for rows in (sq, sk, sk))
        launch = bwd_launcher(fa, lib, args, raw, q_offset, causal,
                              k_offset)
        launch("dq")
        launch("dkv")
        torch.cuda.synchronize()
        want = fa.flash_chunk_grads_reference(*args, q_offset, k_offset,
                                              causal, d ** -0.5)
        zeros_only = name == "future"   # held by its zeros alone (above)
        unrounded = None
        if dtype_name == "bfloat16" and not zeros_only:
            # the same sums without the roundings
            unrounded = fa.flash_chunk_grads_reference(
                *(x.float() for x in args[:4]), *args[4:], q_offset,
                k_offset, causal, d ** -0.5)
        torch.cuda.synchronize()
        tol = BWD_TOL[dtype_name]
        res = {"case": name, "shape": [bh, sq, sk, d], "dtype": dtype_name,
               "causal": causal, "q_offset": q_offset,
               "k_offset": k_offset, "tol": tol,
               "c_entry_bit_equal": all(bool(torch.equal(g, r))
                                        for g, r in zip(got, raw))}
        ok = res["c_entry_bit_equal"]
        for i, (grad, g, w) in enumerate(zip(("dq", "dk", "dv"), got,
                                             want)):
            reading = grad_readings(g, w)
            res[f"{grad}_max_abs_err"] = reading["max_abs_err"]
            res[grad] = reading
            ok = ok and bool(torch.isfinite(g).all())
            if not zeros_only:
                ok = ok and within(reading, tol)
            if unrounded is not None:
                res[f"{grad}_unrounded"] = grad_readings(unrounded[i], w)
        if causal:
            # q rows before the first key reach none; keys after the last
            # query meet none: exact zeros in the NaN-filled launch.
            no_key = min(max(k_offset - q_offset, 0), sq)
            no_query = min(max(q_offset + sq - k_offset, 0), sk)
            if no_key:
                res["no_key_rows_zero"] = bool((raw[0][:, :no_key] == 0)
                                               .all())
                ok = ok and res["no_key_rows_zero"]
            if no_query < sk:
                res["beyond_zero"] = all(bool((g[:, no_query:] == 0).all())
                                         for g in raw[1:])
                ok = ok and res["beyond_zero"]
        if zeros_only:
            res["all_zero"] = all(bool((g == 0).all()) for g in got + raw)
            ok = ok and res["all_zero"]
        res["ok"] = ok
        print("bwd kernel check", json.dumps(res), flush=True)
        label = f"{name}/{dtype_name}/D{d}/Sq{sq}/Sk{sk}"
        check(ok, f"bwd kernel {label}: non-finite, outside tolerance or "
                  f"not zero where nothing is reached {res}")
        if unrounded is not None:
            for grad in ("dq", "dk", "dv"):
                check(not within(res[f"{grad}_unrounded"], tol),
                      f"bwd kernel {label}: {grad}'s unrounded plain "
                      f"version passes the limits, which could not see a "
                      f"rounding fault {res}")
        checks.append(res)
        if timed and name in BWD_TIMED and dtype_name == "bfloat16":
            timing[name] = (args, q_offset, causal)
    if not timed:
        return None, checks
    from elasticdl_tpu_torch.ops import _build

    ptxas = kernel_ptxas(_build.build_all([fa._BWD_SOURCE])[fa._BWD_SOURCE],
                         "flash_bwd_dq_")
    for line in ptxas:
        print(f"dq ptxas: {line}", flush=True)
    times = {name: bwd_times(torch, fa, lib, *value)
             for name, value in timing.items()}
    errs = {"dq": max(c["dq_max_abs_err"] for c in checks),
            "dkv": max(max(c["dk_max_abs_err"], c["dv_max_abs_err"])
                       for c in checks)}
    rows = []
    for name, replaces in (
            ("flash_attention_bwd_dq",
             "elasticdl_tpu/ops/flash_attention.py:493"),
            ("flash_attention_bwd_dkv",
             "elasticdl_tpu/ops/flash_attention.py:528")):
        kind = name.rsplit("_", 1)[1]
        flagship = times["flagship"]
        rows.append({
            "name": name, "route": "cuda",
            "source": "elasticdl_tpu_torch/ops/csrc/flash_attention_bwd.cu",
            "replaces": replaces, "shape": flagship["shape"],
            "dtype": "bfloat16", "causal": True, "max_abs_err": errs[kind],
            "ms": flagship[kind]["ms"],
            "ms_replays": flagship[kind]["ms_replays"],
            "ms_source": "CUDA graph of 50 launches, replayed, CUDA events",
            "plain_ms": flagship["plain_ms"],
            "plain_computes": "dq, dk and dv",
            "bound_ms": flagship[kind]["bound_ms"],
            "bound_by": flagship[kind]["bound_by"],
            "library_ms": flagship["library_ms"],
            "pair_ms": flagship["pair_ms"],
            "library_call": "SDPA's flash backward op (dq, dk and dv "
                            "together), device time the same way; "
                            "pair_ms: dq + dk/dv, the same function",
            "ring": {shape: {key: times[shape][kind][key]
                             for key in ("ms", "bound_ms", "bound_by")}
                     | {key: times[shape][key]
                        for key in ("library_ms", "library_causal",
                                    "pair_ms")}
                     for shape in ("ring_past", "ring_diagonal")},
        })
    rows[0]["ptxas"] = ptxas
    return rows, checks


def sdpa_backward(torch, q, k, v, do, causal, heads):
    """SDPA's flash backward op alone (no autograd), given its forward's
    saved outputs, on (B, H, S, D) views of the (BH, S, D) inputs."""
    b = q.shape[0] // heads
    q4, k4, v4, do4 = (x.view(b, heads, *x.shape[1:])
                       for x in (q, k, v, do))
    scale = q.shape[-1] ** -0.5
    fwd = torch.ops.aten._scaled_dot_product_flash_attention(
        q4, k4, v4, 0.0, causal, False, scale=scale)
    out, lse, cum_q, cum_k, max_q, max_k, seed, offset = fwd[:8]

    def backward():
        return torch.ops.aten._scaled_dot_product_flash_attention_backward(
            do4, q4, k4, v4, out, lse, cum_q, cum_k, max_q, max_k, 0.0,
            causal, seed, offset, scale=scale)

    return backward


def bwd_times(torch, fa, lib, args, q_offset, causal):
    """#3's and #4's device times (CUDA graphs of 50 launches through
    the C entry points: not counted), each beside its bound, and SDPA's
    backward op on the same work measured the same way (a past ring
    chunk, all pairs unmasked, against a non-causal SDPA backward); the
    plain version at the flagship shape."""
    q, k, v, do = args[:4]
    bh, sq, d = q.shape
    sk = k.shape[1]
    outs = tuple(torch.empty((bh, rows, d), device=DEVICE)
                 for rows in (sq, sk, sk))
    launch = bwd_launcher(fa, lib, args, outs, q_offset, causal)
    out = {"shape": [bh, sq, sk, d], "q_offset": q_offset}
    for kind, products, outputs in (("dq", 3, 1), ("dkv", 4, 2)):
        replays = graph_ms(torch, lambda: launch(kind))
        bound_ms, bound_by = bwd_bound(bh, sq, sk, d, "bfloat16", causal,
                                       products, outputs, q_offset)
        out[kind] = {"ms": float(np.median(replays)), "ms_replays": replays,
                     "bound_ms": bound_ms, "bound_by": bound_by}
    out["pair_ms"] = out["dq"]["ms"] + out["dkv"]["ms"]
    # SDPA has no offsets: its causal mask is the diagonal chunk's, and a
    # chunk with every pair unmasked is its non-causal backward.
    lib_causal = causal and unmasked_pairs(sq, sk, q_offset, 0, True) \
        < sq * sk
    heads = FLAGSHIP["n_heads"]
    library = graph_ms(torch, sdpa_backward(torch, q, k, v, do, lib_causal,
                                            heads))
    out["library_ms"] = float(np.median(library))
    out["library_ms_replays"] = library
    out["library_causal"] = lib_causal
    if (bh, sq) == (32, 1024):
        out["plain_ms"] = cuda_ms(lambda: fa.flash_chunk_grads_reference(
            *args, q_offset, 0, causal, d ** -0.5), iters=5)
    return out


def bwd_autograd_phase(torch, fa):
    """Gradients through flash_attention: card (kernels) vs CPU (plain)."""
    rng = np.random.default_rng(SEED + 11)
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


def unmasked_pairs(sq, sk, q_offset, k_offset, causal):
    """The (query, key) pairs a chunk update must fold: keys at or before
    each query's global position when causal."""
    if not causal:
        return sq * sk
    rows = q_offset + np.arange(sq) - k_offset + 1
    return int(np.clip(rows, 0, sk).sum())


def chunk_bound(bh, sq, sk, d, dtype, causal, q_offset, k_offset):
    """Least time for one chunk update on an H100: q, k, v read once,
    the f32 carry (m, l, acc) read and written once, over the memory
    rate; against both products over this chunk's unmasked pairs at the
    peak rate."""
    elt = 2 if dtype == "bfloat16" else 4
    nbytes = (bh * sq * d + 2 * bh * sk * d) * elt \
        + 2 * (2 * bh * sq + bh * sq * d) * 4
    ops = 2 * 2 * bh * unmasked_pairs(sq, sk, q_offset, k_offset,
                                      causal) * d
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def chunk_tiled_reference(fa, q, k, v, m, l, acc, q_offset, k_offset,
                          causal, scale, dtype=None):
    """The plain version folded in the kernel's own order: over the key
    tiles of the route that ``dtype`` (q's by default) takes, into one
    running state or, on the wgmma route, into two merged at the end."""
    d = q.shape[-1]
    dtype = dtype or q.dtype
    return fa.flash_chunk_update_reference(
        q, k, v, m, l, acc, q_offset, k_offset, causal, scale,
        block_k=fa.chunk_block_k(d, dtype),
        consumers=fa.chunk_consumers(d, dtype))


# (name, bh, sq, sk, d, dtype, causal, q_offset, k_offset, carry). The
# first two are the ring's local block at the slice's shape (BH 4, 2048,
# D 128): its diagonal chunk and a past chunk. bf16 D 64 and 128 take the
# wgmma kernel, bf16 D 16 and 32 the mma.sync one. Every case also
# launches through the C entry point into NaN-filled outputs and with the
# outputs aliasing the carry (a copy of it), which must equal the
# wrapper's launch bit for bit. The cases draw their inputs in turn from
# one seeded generator, so new cases are appended: each earlier case
# keeps its inputs.
CHUNK_CASES = [
    ("diagonal", 4, 2048, 2048, 128, "bfloat16", True, 2048, 2048,
     "initial"),
    ("past", 4, 2048, 2048, 128, "bfloat16", True, 4096, 0, "folded"),
    # Every key after every query; Sq is ragged so that the last q tile
    # is not skipped whole and its rows meet the mask.
    ("future", 4, 200, 256, 128, "bfloat16", True, 0, 200, "initial"),
    ("future", 4, 200, 256, 64, "float32", True, 0, 200, "folded"),
    # Rows 0-43 (global 256-299) see no key of the chunk (keys from 300).
    ("first_rows", 4, 256, 256, 64, "bfloat16", True, 256, 300, "initial"),
    ("first_rows", 4, 256, 256, 32, "float32", True, 256, 300, "initial"),
    ("full", 4, 256, 384, 16, "bfloat16", False, 0, 0, "initial"),
    ("full", 4, 256, 384, 64, "float32", False, 0, 0, "folded"),
    ("ragged", 4, 200, 333, 16, "bfloat16", True, 500, 100, "folded"),
    ("ragged", 4, 130, 37, 32, "bfloat16", True, 37, 0, "initial"),
    ("ragged", 4, 200, 333, 128, "float32", True, 300, 100, "initial"),
    ("diagonal", 4, 512, 512, 64, "float32", True, 512, 512, "folded"),
    ("diagonal", 4, 512, 512, 32, "bfloat16", True, 512, 512, "folded"),
    ("past", 4, 512, 512, 16, "float32", True, 1024, 0, "initial"),
    # The wgmma kernel's edges: one key tile (the second consumer has
    # none), an odd number of them, a ragged Sk (333) and Sq (200) across
    # the diagonal, rows that see no key, and the ring's chunks at D 64.
    ("one_tile", 4, 256, 64, 128, "bfloat16", True, 1024, 0, "folded"),
    ("odd_tiles", 4, 256, 320, 128, "bfloat16", True, 1024, 0, "folded"),
    ("ragged", 4, 200, 333, 128, "bfloat16", True, 300, 100, "folded"),
    ("first_rows", 4, 256, 256, 128, "bfloat16", True, 256, 300, "initial"),
    ("past", 4, 2048, 2048, 64, "bfloat16", True, 4096, 0, "folded"),
    ("diagonal", 4, 2048, 2048, 64, "bfloat16", True, 2048, 2048,
     "initial"),
    # Rows that see no key on the mma.sync route (D 64 went to wgmma).
    ("first_rows", 4, 256, 256, 32, "bfloat16", True, 256, 300, "initial"),
]
# Timed: the ring's chunks (BH 4 x 2048 x 2048) at D 128 and 64.
CHUNK_TIMED = ("past", "diagonal")


def chunk_kernel_phase(torch, fa, check=check, timed=True):
    """Kernel #2 against its plain version on the card over CHUNK_CASES,
    through the wrapper every caller uses (flash_chunk_update_cuda), and
    launched again through its C entry point into outputs filled with
    NaN (a row left unstored shows) and with the outputs aliasing a copy
    of the carry: both must equal the wrapper's bit for bit (the kernel
    sums in a fixed order). Then its ptxas lines and its times at the
    slice's shape. ``check`` may record instead of raise
    (tools/chunk_kernel_mutants.py); each case's "ok" says whether it
    passed."""
    lib = fa._chunk_library()
    rng = np.random.default_rng(SEED + 50)
    checks = []
    timing = {}
    for (name, bh, sq, sk, d, dtype_name, causal, q_off, k_off,
         carry) in CHUNK_CASES:
        dtype = getattr(torch, dtype_name)

        def randn(*shape):
            return torch.from_numpy(rng.standard_normal(
                shape, dtype=np.float32)).to(DEVICE, dtype)

        q, k, v = randn(bh, sq, d), randn(bh, sk, d), randn(bh, sk, d)
        scale = d ** -0.5
        state = (torch.full((bh, sq, 1), -1e30, device=DEVICE),
                 torch.zeros((bh, sq, 1), device=DEVICE),
                 torch.zeros((bh, sq, d), device=DEVICE))
        if carry == "folded":   # the carry an earlier (past) chunk leaves
            state = fa.flash_chunk_update_reference(
                q, randn(bh, 256, d), randn(bh, 256, d), *state, q_off,
                -256, False, scale)
        got = fa.flash_chunk_update_cuda(q, k, v, *state, q_off, k_off,
                                         causal, scale)
        raw = tuple(torch.full_like(t, float("nan")) for t in state)
        aliased = tuple(t.clone() for t in state)
        for carry_in, outs in ((state, raw), (aliased, aliased)):
            err = fa._chunk_launch(lib, (q, k, v, *carry_in), outs, q_off,
                                   k_off, causal, scale)
            check(err == 0, f"chunk launch: CUDA error {err}")
        torch.cuda.synchronize()
        want = chunk_tiled_reference(fa, q, k, v, *state, q_off, k_off,
                                     causal, scale)
        whole = fa.flash_chunk_update_reference(q, k, v, *state, q_off,
                                                k_off, causal, scale)
        pairs = unmasked_pairs(sq, sk, q_off, k_off, causal)
        unrounded = None
        if dtype_name == "bfloat16" and pairs:
            unrounded = chunk_tiled_reference(
                fa, q.float(), k.float(), v.float(), *state, q_off, k_off,
                causal, scale, dtype)
        torch.cuda.synchronize()
        tol = CHUNK_TOL[dtype_name]
        res = {"case": name, "shape": [bh, sq, sk, d], "dtype": dtype_name,
               "causal": causal, "q_offset": q_off, "k_offset": k_off,
               "carry": carry, "pairs": pairs, "tol": tol,
               "whole_tol": CHUNK_WHOLE_TOL[dtype_name],
               "consumers": fa.chunk_consumers(d, dtype),
               "c_entry_bit_equal": all(bool(torch.equal(g, r))
                                        for g, r in zip(got, raw)),
               "aliased_bit_equal": all(bool(torch.equal(g, a))
                                        for g, a in zip(got, aliased))}
        ok = res["c_entry_bit_equal"] and res["aliased_bit_equal"]
        for i, out in enumerate(("m", "l", "acc")):
            res[out] = grad_readings(got[i], want[i])
            res[f"{out}_whole"] = grad_readings(got[i], whole[i])
            ok = ok and bool(torch.isfinite(got[i]).all()) \
                and within(res[out], tol) \
                and within(res[f"{out}_whole"],
                           CHUNK_WHOLE_TOL[dtype_name])
        if unrounded is not None:
            res["acc_unrounded"] = grad_readings(unrounded[2], want[2])
        if not pairs:          # nothing to fold: the carry comes back
            res["carry_unchanged"] = all(torch.equal(g, s)
                                         for g, s in zip(got, state))
            ok = ok and res["carry_unchanged"]
        res["ok"] = ok
        print("chunk kernel check", json.dumps(res), flush=True)
        label = f"{name}/{dtype_name}/D{d}/{carry}"
        check(ok, f"chunk kernel {label} outside tolerance or not "
                  f"bit-equal {res}")
        if unrounded is not None:
            check(not within(res["acc_unrounded"], tol),
                  f"chunk kernel {label}: the unrounded plain version "
                  f"passes the limits, which could not see a rounding "
                  f"fault {res}")
        checks.append(res)
        if timed and name in CHUNK_TIMED and (bh, sq, sk) == (4, 2048, 2048):
            timing[f"{name}_d{d}"] = (q, k, v, state, q_off, k_off, causal,
                                      scale)
    if not timed:
        return None, checks
    from elasticdl_tpu_torch.ops import _build

    ptxas = kernel_ptxas(
        _build.build_all([fa._CHUNK_SOURCE])[fa._CHUNK_SOURCE],
        "flash_chunk_")
    for line in ptxas:
        print(f"chunk ptxas: {line}", flush=True)
    row = chunk_times(torch, fa, lib, timing, checks)
    row["ptxas"] = ptxas
    return row, checks


def sdpa_forward(torch, q, k, v, causal, heads):
    """SDPA's flash forward op with its logsumexp on (B, H, S, D) views
    of (BH, S, D) inputs: the chunk's two products and softmax without
    the carry, a yardstick for #2."""
    b = q.shape[0] // heads
    q4, k4, v4 = (x.view(b, heads, *x.shape[1:]) for x in (q, k, v))
    scale = q.shape[-1] ** -0.5
    return lambda: torch.ops.aten._scaled_dot_product_flash_attention(
        q4, k4, v4, 0.0, causal, False, scale=scale)


def chunk_times(torch, fa, lib, timing, checks):
    """Kernel #2 at the slice's shape (past and diagonal chunks, D 128 and
    64) through its C entry point (these launches are not counted):
    device ms from a CUDA graph of 50 launches, beside the event windows
    of 50 calls and the host's issue time, the plain version, the bound
    and the yardstick (SDPA's forward over the same chunk: non-causal for
    a past chunk, causal for the diagonal)."""
    out = {}
    for key, (q, k, v, state, q_off, k_off, causal, scale) in \
            timing.items():
        bh, sq, d = q.shape
        outs = [torch.empty_like(t) for t in state]

        def launch():
            err = fa._chunk_launch(lib, (q, k, v, *state), outs, q_off,
                                   k_off, causal, scale)
            check(err == 0, f"chunk launch: CUDA error {err}")

        replays = graph_ms(torch, launch)
        window_ms, issue_ms = cuda_windows(launch, 50, 5)
        bound_ms, bound_by = chunk_bound(bh, sq, k.shape[1], d, "bfloat16",
                                         causal, q_off, k_off)
        lib_causal = causal and q_off == k_off
        yardstick = graph_ms(torch, sdpa_forward(
            torch, q, k, v, lib_causal, FLAGSHIP["n_heads"]))
        out[key] = {
            "shape": [bh, sq, k.shape[1], d], "q_offset": q_off,
            "k_offset": k_off,
            "ms": float(np.median(replays)), "ms_replays": replays,
            "window_ms": float(np.median(window_ms)),
            "issue_ms": float(np.median(issue_ms)),
            "plain_ms": cuda_ms(lambda: fa.flash_chunk_update_reference(
                q, k, v, *state, q_off, k_off, causal, scale), iters=5),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "yardstick_ms": float(np.median(yardstick)),
            "yardstick_causal": lib_causal,
            "pairs": unmasked_pairs(sq, k.shape[1], q_off, k_off, causal),
        }
    past = out["past_d128"]
    return {
        "name": "flash_chunk_update", "route": "cuda",
        "source": "elasticdl_tpu_torch/ops/csrc/flash_chunk_update.cu",
        "replaces": "elasticdl_tpu/ops/flash_attention.py:277",
        "shape": past["shape"], "dtype": "bfloat16",
        "chunk": "past (the ring's step t > 0), folded carry",
        "max_abs_err": max(max(c[o]["max_abs_err"] for o in ("m", "l",
                                                            "acc"))
                           for c in checks),
        "ms": past["ms"], "ms_replays": past["ms_replays"],
        "ms_source": "CUDA graph of 50 launches, replayed, CUDA events",
        "window_ms": past["window_ms"], "issue_ms": past["issue_ms"],
        "plain_ms": past["plain_ms"],
        "bound_ms": past["bound_ms"], "bound_by": past["bound_by"],
        "library_ms": None,
        "library_call": "none: no PyTorch call carries (m, l, acc)",
        "yardstick_ms": past["yardstick_ms"],
        "yardstick": "SDPA's flash forward with logsumexp over the same "
                     "chunk (non-causal past, causal diagonal), device "
                     "time the same way: the chunk's products without "
                     "the carry fold, not the same function",
        "chunks": out,
    }


def ring_mesh(torch, sp=RING_SP, device=None):
    from elasticdl_tpu_torch.parallel.mesh import make_mesh

    return make_mesh((sp,), ("sp",), [torch.device(device or DEVICE)] * sp)


def ring_check_phase(torch, fa, ra, check=check, timed=True):
    """ring_attention on an sp mesh of the card against kernel #1 (and
    #3/#4) over the whole sequence, output and gradients, at the slice's
    shape and the flagship's; f32 against the CPU plain ring; then the
    whole ring forward timed beside #1 and SDPA. ``check`` may record
    instead of raise (tools/chunk_kernel_mutants.py)."""
    mesh = ring_mesh(torch)
    rng = np.random.default_rng(SEED + 60)
    checks = []
    for b, s, dtype_name in ((1, RING_SEQ, "bfloat16"),
                             (8, 1024, "bfloat16"), (1, 512, "float32")):
        d = 128 if dtype_name == "bfloat16" else 64
        arrays = [rng.standard_normal((b, s, 4, d), dtype=np.float32)
                  for _ in range(4)]
        dtype = getattr(torch, dtype_name)
        runs = {}
        for label in ("ring", "flash" if dtype_name == "bfloat16"
                      else "cpu_ring"):
            dev = "cpu" if label == "cpu_ring" else DEVICE
            leaves = [torch.from_numpy(x).to(dev, dtype).requires_grad_()
                      for x in arrays[:3]]
            do = torch.from_numpy(arrays[3]).to(dev, dtype)
            before = (fa.chunk_launches, fa.dq_launches, fa.launches)
            if label == "flash":
                out = fa.flash_attention(*leaves)
            else:
                out = ra.ring_attention(
                    *leaves, mesh if dev == DEVICE else ring_mesh(
                        torch, device="cpu"))
            out.backward(do)
            torch.cuda.synchronize()
            runs[label] = [out.detach().float().cpu()] + [
                x.grad.float().cpu() for x in leaves]
            runs[label + "_launches"] = (fa.chunk_launches - before[0],
                                         fa.dq_launches - before[1],
                                         fa.launches - before[2])
        ref = "flash" if dtype_name == "bfloat16" else "cpu_ring"
        tol = RING_TOL[dtype_name]
        res = {"shape": [b, s, 4, d], "dtype": dtype_name, "sp": RING_SP,
               "against": ref, "tol": tol,
               "ring_launches": runs["ring_launches"]}
        for i, name in enumerate(("out", "dq", "dk", "dv")):
            res[name] = grad_readings(runs["ring"][i], runs[ref][i])
        print("ring check", json.dumps(res), flush=True)
        check(runs["ring_launches"] == (RING_SP ** 2, RING_SP ** 2, 0),
              f"ring launches (chunk, dq, fwd) {runs['ring_launches']}: "
              f"{RING_SP ** 2} chunk updates and dq kernels a ring")
        for name in ("out", "dq", "dk", "dv"):
            check(within(res[name], tol), f"ring {name} vs {ref}: {res}")
        checks.append(res)
    if not timed:
        return checks, None

    # The whole forward at S 8192: the ring against #1 and SDPA.
    q, k, v = (torch.from_numpy(rng.standard_normal(
        (1, RING_SEQ, 4, 128), dtype=np.float32)).to(DEVICE, torch.bfloat16)
        for _ in range(3))
    q4, k4, v4 = (x.transpose(1, 2) for x in (q, k, v))
    with torch.inference_mode():
        times = {
            "ring_forward_ms": cuda_ms(
                lambda: ra.ring_attention(q, k, v, mesh), iters=5),
            "flash_forward_ms": cuda_ms(
                lambda: fa.flash_attention(q, k, v), iters=10),
            "sdpa_ms": cuda_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    q4, k4, v4, is_causal=True), iters=10),
        }
    times["bound_ms"], times["bound_by"] = flash_bound(4, RING_SEQ, 128,
                                                       "bfloat16", True)
    times["shape"] = [1, RING_SEQ, 4, 128]
    print("ring forward times", json.dumps(times), flush=True)
    return checks, times


def ring_training_phase(torch, fa):
    """The flagship at S 8192 with remat trained on the ring: MeshRunner
    on an sp mesh of the card, against the same steps through
    core.step.build_train_step (kernel #1) from the same weights and
    batches."""
    from elasticdl_tpu_torch import bridge
    from elasticdl_tpu_torch.core.step import build_train_step
    from elasticdl_tpu_torch.core.train_state import init_train_state
    from elasticdl_tpu_torch.model_zoo.transformer import transformer_lm
    from elasticdl_tpu_torch.models.transformer import TransformerConfig
    from elasticdl_tpu_torch.parallel.mesh_runner import MeshRunner

    cfg = TransformerConfig(**dict(FLAGSHIP, max_len=RING_SEQ), remat=True,
                            compute_dtype=torch.bfloat16)
    weights = bridge.state_dict_from_flax(
        bridge.init_flax_params(cfg, seed=SEED))
    rng = np.random.default_rng(SEED + 70)
    batches = []
    for _ in range(RING_TRAIN_STEPS + 1):    # the last one is evaluated
        start = rng.integers(0, cfg.vocab_size, (1, 1))
        seq = (start + np.arange(RING_SEQ + 1)[None]) % cfg.vocab_size
        batches.append({"features": seq[:, :-1].astype(np.int32),
                        "labels": seq[:, 1:].astype(np.int32),
                        "mask": np.ones(1, np.float32)})
    layers = cfg.n_layers
    runs = {}
    for label in ("ring", "single"):
        mesh = ring_mesh(torch) if label == "ring" else None
        model = transformer_lm.custom_model(config=cfg, device=DEVICE,
                                            mesh=mesh)
        model.load_state_dict(weights)
        if mesh is not None:
            runner = MeshRunner(mesh)
            state = runner.init_state(model, transformer_lm.optimizer(),
                                      batches[0], seed=SEED)
            step = runner.train_step(transformer_lm.loss)
            eval_step = runner.eval_step()
        else:
            state = init_train_state(model, transformer_lm.optimizer(),
                                     seed=SEED)
            step = build_train_step(transformer_lm.loss)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        events, issue, losses = [], [], []
        fa.launches = fa.chunk_launches = 0     # the main path starts here
        fa.dq_launches = fa.dkv_launches = 0
        for batch in batches[:RING_TRAIN_STEPS]:
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            t0 = time.perf_counter()
            start.record()
            state, metrics = step(state, batch)
            end.record()
            issue.append((time.perf_counter() - t0) * 1e3)
            events.append((start, end))
            losses.append(metrics["loss"])
        counts = {"flash_chunk_update": fa.chunk_launches,  # ... ends here
                  "flash_attention_bwd_dq": fa.dq_launches,
                  "flash_attention_bwd_dkv": fa.dkv_launches,
                  "flash_attention_fwd": fa.launches}
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        step_ms, issue_ms = [], []
        for i in range(2, RING_TRAIN_STEPS - 1, 2):
            step_ms.append(events[i][0].elapsed_time(events[i + 1][1]) / 2)
            issue_ms.append(float(np.mean(issue[i:i + 2])))
        run = {"losses": [float(x) for x in losses],
               "launches": counts, "step_ms": spread(step_ms),
               "issue_ms": spread(issue_ms),
               "tokens_per_s": RING_SEQ / (np.median(step_ms) / 1e3),
               "max_memory_allocated_bytes": peak,
               "params_finite": all(bool(torch.isfinite(p).all())
                                    for p in state.model.parameters())}
        if mesh is not None:
            fa.chunk_launches = fa.dq_launches = 0   # one eval batch
            logits = eval_step(state, batches[-1])
            run["eval_launches"] = {"flash_chunk_update": fa.chunk_launches,
                                    "flash_attention_bwd_dq":
                                        fa.dq_launches}
            run["eval_logits_finite"] = bool(torch.isfinite(logits).all())
            run["eval_shape"] = list(logits.shape)
        runs[label] = run
        del state, step, model
        torch.cuda.empty_cache()
    ring, single = runs["ring"], runs["single"]
    rel = [abs(a - b) / abs(b) for a, b in zip(ring["losses"],
                                               single["losses"])]
    out = {
        "model": "transformer flagship widths (bench_suite.py "
                 "_TRANSFORMER_SIZES['transformer']) at max_len "
                 f"{RING_SEQ}, remat on, dropout 0, random weights "
                 f"seed {SEED}, the twin's Adam 1e-3",
        "batch": 1, "seq": RING_SEQ, "sp": RING_SP,
        "steps": RING_TRAIN_STEPS, "ring": ring, "single_device": single,
        "loss_max_rel_diff": max(rel), "tol": RING_TRAIN_TOL,
        "clocks_after": smi("clocks.sm,clocks.max.sm,power.draw,"
                            "temperature.gpu"),
    }
    print("ring training", json.dumps(out), flush=True)
    per_pair = RING_TRAIN_STEPS * layers * RING_SP ** 2
    check(ring["launches"] == {"flash_chunk_update": 2 * per_pair,
                               "flash_attention_bwd_dq": per_pair,
                               "flash_attention_bwd_dkv": per_pair,
                               "flash_attention_fwd": 0},
          f"ring launches {ring['launches']} in {RING_TRAIN_STEPS} steps: "
          f"{2 * per_pair} chunk updates (remat recomputes the forward), "
          f"{per_pair} dq and dk/dv, no #1")
    check(ring["eval_launches"] == {
        "flash_chunk_update": layers * RING_SP ** 2,
        "flash_attention_bwd_dq": 0},
        f"ring eval launches {ring['eval_launches']}")
    check(single["launches"]["flash_attention_fwd"]
          == 2 * RING_TRAIN_STEPS * layers
          and single["launches"]["flash_chunk_update"] == 0,
          f"single-device launches {single['launches']}")
    check(ring["eval_logits_finite"] and ring["eval_shape"] == [
        1, RING_SEQ, cfg.vocab_size], f"ring eval logits {ring}")
    for run in (ring, single):
        check(run["params_finite"] and all(np.isfinite(run["losses"])),
              "non-finite parameters or losses")
    check(max(rel) <= RING_TRAIN_TOL["loss"],
          f"ring vs single-device losses: {rel}")
    return out


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


# Cases of lookup_checks: (vocab, dim, batch, num_ids, combiner, weights,
# table). The first eight draw from the phase's generators; the rest,
# appended to reach kernel #5's ring and grid, from their own (SEED + 21),
# so the earlier cases' inputs and the row checks' after them stay as
# they were: ids outside the table late in L 96 (past the ring's 32
# slots, so they land on reused slots), B 1 and B 64 at D 256 (rows split
# into column strips), D 4 (one 16-byte strip) and a table viewed at a
# 4-byte offset (#5's 4-byte instance).
LOOKUP_CASES = [
    (EMB_VOCAB, EMB_DIM, EMB_BATCH, EMB_IDS, "sum", "ones", "plain"),
    (4096, 16, 37, 5, "mean", "zero_rows", "plain"),
    (4096, 128, 37, 9, "sqrtn", "zero_rows", "plain"),
    (4096, 256, 37, 32, "sqrtn", "random", "plain"),
    (4096, 512, 64, 64, "sum", "random", "plain"),
    (4096, 130, 37, 7, "mean", "zero_rows", "plain"),     # D % 4 != 0
    (4096, 2000, 9, 3, "sqrtn", "random", "plain"),       # two column tiles
    (4096, 64, 16, 6, "mean", "out_of_range", "plain"),
]
LOOKUP_CASES_LATER = [
    (4096, 256, 37, 96, "mean", "late_out_of_range", "plain"),
    (4096, 256, 1, 32, "sqrtn", "random", "plain"),
    (4096, 256, 64, 32, "sum", "random", "plain"),
    (4096, 4, 37, 40, "mean", "zero_rows", "plain"),
    (4096, 256, 37, 32, "sqrtn", "random", "offset4"),
]


def lookup_case_inputs(torch, rng, gen, case, tables):
    """A case's table (kept in ``tables`` while the next case shares its
    shape), ids and weights on the card."""
    vocab, dim, batch, num_ids, _, kind, layout = case
    key = (vocab, dim, layout)
    if key not in tables:
        tables.clear()
        if layout == "offset4":      # a view 4 bytes into its storage
            flat = torch.empty(vocab * dim + 1, device="cuda").uniform_(
                -dim ** -0.5, dim ** -0.5, generator=gen)
            tables[key] = flat[1:].view(vocab, dim)
        else:
            tables[key] = uniform_table(torch, vocab, dim, dim ** -0.5, gen)
    ids = rng.integers(0, vocab, (batch, num_ids)).astype(np.int32)
    w = (np.ones((batch, num_ids), np.float32) if kind == "ones"
         else rng.random((batch, num_ids), dtype=np.float32))
    if kind == "zero_rows":
        w[::3] = 0.0
        w[1, num_ids // 2:] = 0.0
    if kind == "out_of_range":
        ids[::2, 0] = vocab
        ids[1::2, -1] = -1
    if kind == "late_out_of_range":
        ids[::2, 70] = vocab
        ids[1::2, 90] = -1
        ids[::5, -1] = vocab
    return (tables[key], torch.from_numpy(ids).cuda(),
            torch.from_numpy(w).cuda())


def lookup_checks(torch, pe, rng, gen, check=check):
    """Both lookup kernels against the plain version (``LOOKUP_CASES``
    and ``LOOKUP_CASES_LATER``): the recsys step's shape and the edge
    cases. Each kernel launches through its wrapper and again through
    its C entry point into an output filled with NaN, which must equal
    the wrapper's bit for bit (a strip left unstored shows); #5's lines
    name its instance and ring (``pe.aligned_plan``)."""
    lib = pe._lookup_library()
    checks = []
    tables = {}
    later = (np.random.default_rng(SEED + 21),
             torch.Generator(device="cuda").manual_seed(SEED + 21))
    for case in LOOKUP_CASES + LOOKUP_CASES_LATER:
        vocab, dim, batch, num_ids, combiner, kind, layout = case
        draw = (rng, gen) if case in LOOKUP_CASES else later
        table, ids_t, w_t = lookup_case_inputs(torch, *draw, case, tables)
        want = pe.lookup_combine_reference(table, ids_t, w_t, combiner)
        for name, fn in (("lookup_combine", pe.lookup_combine_pallas),
                         ("lookup_combine_aligned",
                          pe.lookup_combine_aligned)):
            aligned = name == "lookup_combine_aligned"
            got = fn(table, ids_t, w_t, combiner)
            nan_out = torch.full_like(got, float("nan"))
            err = pe._lookup_launch(lib, aligned, table, ids_t, w_t,
                                    nan_out, combiner)
            check(err == 0, f"{name} C entry: CUDA error {err}")
            torch.cuda.synchronize()
            reading = grad_readings(got, want)
            res = {"kernel": name, "vocab": vocab, "dim": dim,
                   "batch": batch, "num_ids": num_ids,
                   "combiner": combiner, "weights": kind,
                   "table_layout": layout,
                   **reading, "tol": EMB_TOL["lookup"],
                   "c_entry_bit_equal": torch.equal(
                       nan_out.view(torch.int32), got.view(torch.int32))}
            if aligned:
                res["plan"] = pe.aligned_plan(table, ids_t, got)
            res["ok"] = (bool(torch.isfinite(got).all())
                         and emb_within(reading, EMB_TOL["lookup"])
                         and res["c_entry_bit_equal"])
            print("embedding kernel check", json.dumps(res), flush=True)
            check(bool(torch.isfinite(got).all()), f"non-finite {res}")
            check(emb_within(reading, EMB_TOL["lookup"]),
                  f"{name} outside tolerance {res}")
            check(res["c_entry_bit_equal"],
                  f"{name}: the C entry's launch differs {res}")
            checks.append(res)
    try:
        pe.lookup_combine_aligned(table[:4095], ids_t, w_t, "mean")
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


def kernel_launch_counts(fa, pe):
    """Every kernel's launch counter, by its ``kernels`` row name."""
    return {"flash_attention_fwd": fa.launches,
            "flash_chunk_update": fa.chunk_launches,
            "flash_attention_bwd_dq": fa.dq_launches,
            "flash_attention_bwd_dkv": fa.dkv_launches,
            "lookup_combine": pe.lookup_launches,
            "lookup_combine_aligned": pe.aligned_launches,
            "row_update": pe.row_update_launches,
            "fused_row_update": pe.fused_launches}


def reset_kernel_launches(fa, pe):
    fa.launches = fa.dq_launches = fa.dkv_launches = fa.chunk_launches = 0
    pe.reset_launches()


def launches_since(fa, pe, before):
    """Each kernel's launches since ``before`` (a kernel_launch_counts
    reading)."""
    return {k: v - before[k] for k, v in kernel_launch_counts(fa, pe).items()}


def host_twin_run(torch, fa, pe, zoo, model_def, records, device, epochs):
    """One LocalExecutor run of a deepfm_host zoo module; kernel launch
    counts are zeroed just before it and read just after."""
    from elasticdl_tpu_torch.api.local_executor import LocalExecutor
    from elasticdl_tpu_torch.testing import data as tdata

    args = tdata.make_local_args(
        zoo, model_def, records, minibatch_size=HOST_BATCH,
        num_epochs=epochs,
        extra=["--device", device, "--random_seed", str(SEED)])
    record = step_recorder(torch)
    executor = LocalExecutor(args, callbacks=[record])
    reset_kernel_launches(fa, pe)             # the host path starts here
    result = executor.run()
    counts = kernel_launch_counts(fa, pe)     # ... and ends
    return executor, record, result, counts


def host_training_phase(torch, fa, pe, root):
    """The deepfm_host twin through LocalExecutor: card against CPU with
    a synchronous runner (losses, touched rows, untouched rows, the
    native store), then the zoo's own runner on the card, timed, and
    against a synchronous runner on batches of disjoint ids; the host
    engine alone at the recsys shape, cold and warm; deepfm_functional
    card against CPU."""
    from elasticdl_tpu_torch import native
    from elasticdl_tpu_torch.model_zoo.deepfm import deepfm_host as twin
    from elasticdl_tpu_torch.native.row_store import NativeEmbeddingTable
    from elasticdl_tpu_torch.testing import data as tdata

    records = tdata.create_frappe_record_file(
        os.path.join(root, "host.rec"), HOST_RECORDS, seed=SEED,
        input_length=HOST_IDS, max_id=HOST_MAX_ID)
    zoo = write_zoo(root, "host_sync", HOST_ZOO)
    runs = {}
    for dev in ("cuda", "cpu"):
        executor, record, result, counts = host_twin_run(
            torch, fa, pe, zoo, "host_sync.rec.custom_model", records, dev,
            HOST_EPOCHS)
        table = executor._step_runner.engine.tables[twin.TABLE_NAME]
        ids, rows = table.to_arrays()
        runs[dev] = dict(loss=[float(x) for x in record.loss],
                         counts=counts, table=table, ids=ids, rows=rows,
                         initial=record.initial, steps=result["steps"])
    card, cpu = runs["cuda"], runs["cpu"]
    touched = np.unique(frappe_ids(HOST_RECORDS, HOST_IDS, HOST_MAX_ID,
                                   SEED))
    check(all(np.array_equal(r["ids"], touched) for r in runs.values()),
          "the host table's rows are not the ids the batches touched")
    lazy = NativeEmbeddingTable(twin.TABLE_NAME, twin.EMBEDDING_DIM)
    initial = lazy.get(touched)
    rel = [abs(x - y) / abs(y) for x, y in zip(card["loss"], cpu["loss"])]
    delta_l2 = rel_err(card["rows"] - initial, cpu["rows"] - initial)
    rows_l2 = rel_err(card["rows"], cpu["rows"])
    untouched = np.setdiff1d(np.arange(HOST_MAX_ID), touched)[:64]
    untouched_equal = all(
        np.array_equal(r["table"].get(untouched), lazy.get(untouched))
        for r in runs.values())
    per_epoch = HOST_RECORDS // HOST_BATCH
    epoch_loss = [float(np.mean(card["loss"][i:i + per_epoch]))
                  for i in range(0, card["steps"], per_epoch)]
    same_start = all(torch.equal(card["initial"][n], cpu["initial"][n])
                     for n in cpu["initial"])

    # The zoo's own runner (async apply) on the card, timed.
    executor, record, result, async_counts = host_twin_run(
        torch, fa, pe, tdata.model_zoo_dir(),
        "deepfm.deepfm_host.custom_model", records, "cuda",
        HOST_TIMED_EPOCHS)
    async_loss = [float(x) for x in record.loss]
    async_epochs = [float(np.mean(async_loss[i:i + per_epoch]))
                    for i in range(0, len(async_loss), per_epoch)]
    finite = all(bool(torch.isfinite(p).all())
                 for p in executor.state.model.parameters())
    step_ms, issue_ms = window_ms(record, warm=per_epoch, window=per_epoch)
    median = float(np.median(step_ms))
    async_check = host_async_check(torch, fa, pe)
    engine = host_engine_times(torch)
    functional = deepfm_functional_phase(torch, fa, pe, root)
    out = {
        "model": "deepfm_host twin (model_zoo/deepfm/deepfm_host.py: "
                 "5500 x 16 host table, 10 ids an example, SGD rows lr "
                 "0.05, MLP 160-64-32-1 bf16, Adam 1e-3), random weights, "
                 f"seed {SEED}",
        "batch": HOST_BATCH, "steps": card["steps"],
        "native_store": all(isinstance(r["table"], NativeEmbeddingTable)
                            for r in runs.values()),
        "native_library": os.path.relpath(native.library_path()),
        "native_build_s": native.build_seconds,
        "launches_card": card["counts"], "launches_cpu": cpu["counts"],
        "launches_async": async_counts,
        "losses_card": card["loss"], "losses_cpu": cpu["loss"],
        "loss_max_rel_diff": max(rel), "touched_rows": int(touched.size),
        "rows_delta_l2": delta_l2, "rows_l2": rows_l2,
        "untouched_bit_equal": untouched_equal,
        "epoch_mean_loss": epoch_loss, "same_initial_weights": same_start,
        "tol": HOST_TOL,
        "async": {"steps": result["steps"], "epoch_mean_loss": async_epochs,
                  "params_finite": finite,
                  "step_ms": spread(step_ms), "issue_ms": spread(issue_ms),
                  "examples_per_s": HOST_BATCH / (median / 1e3),
                  "clocks_after": smi("clocks.sm,clocks.max.sm,power.draw,"
                                      "temperature.gpu")},
        "async_vs_sync": async_check,
        "engine": engine, "deepfm_functional": functional,
    }
    print("host training", json.dumps(out), flush=True)
    check(out["native_store"], "the host table is not the native store")
    check(card["steps"] == HOST_EPOCHS * per_epoch
          and cpu["steps"] == card["steps"], f"{card['steps']} host steps")
    for name, counts in (("card", card["counts"]), ("cpu", cpu["counts"]),
                         ("async", async_counts)):
        check(not any(counts.values()),
              f"the host path ({name}) launched kernels: {counts}")
    check(same_start, "card and CPU start from other weights")
    check(untouched_equal, "an untouched row is not its lazy initial value")
    check(all(np.isfinite(card["loss"])), "non-finite loss")
    check(epoch_loss[-1] < epoch_loss[0],
          f"the loss did not fall: {epoch_loss}")
    check(max(rel) <= HOST_TOL["loss"], f"card vs CPU losses {out}")
    check(delta_l2 <= HOST_TOL["delta_l2"], f"card vs CPU rows {out}")
    check(result["steps"] == HOST_TIMED_EPOCHS * per_epoch and finite
          and async_epochs[-1] < async_epochs[0],
          f"async run: {result['steps']} steps, finite {finite}, "
          f"{async_epochs}")
    return out


def host_engine_times(torch):
    """Per-batch median ms of the host engine's phases at the recsys
    table's shape: dedup, row pull, pad (each as the engine calls it, on
    one batch), the whole ``prepare_batch`` (on a second batch), device
    placement (pinned copy + transfer, synchronised) and the Adagrad
    apply of that batch's row gradients; a cold pass over fresh batches
    (the pull and the apply materialise rows and accumulators), then a
    warm pass over the same batches."""
    from elasticdl_tpu_torch.embedding.host_engine import (
        HostEmbeddingEngine,
        PreparedBatch,
        dedup_ids,
        pad_rows,
    )
    from elasticdl_tpu_torch.embedding.optimizer import Adagrad
    from elasticdl_tpu_torch.native.row_store import (
        NativeEmbeddingTable,
        make_host_optimizer,
    )

    table = NativeEmbeddingTable(RECSYS_TABLE, EMB_DIM)
    engine = HostEmbeddingEngine(
        {RECSYS_TABLE: table}, make_host_optimizer(Adagrad(lr=0.05)),
        id_keys={RECSYS_TABLE: "ids"})
    rng = np.random.RandomState(SEED + 4)

    def fresh():
        return {"features": {"ids": rng.randint(
                    0, EMB_VOCAB, (EMB_BATCH, EMB_IDS)).astype(np.int64)},
                "labels": np.zeros((EMB_BATCH,), np.int32),
                "mask": np.ones((EMB_BATCH,), np.float32)}

    batches = [(fresh(), fresh()) for _ in range(HOST_ENGINE_BATCHES)]

    def run_pass():
        phases = {k: [] for k in ("dedup", "row_pull", "pad",
                                  "prepare_batch", "device_placement",
                                  "apply")}
        uniques = []

        def timed(name, fn, *args):
            t0 = time.perf_counter()
            out = fn(*args)
            phases[name].append((time.perf_counter() - t0) * 1e3)
            return out

        for first, batch in batches:
            uniq, _ = timed("dedup", dedup_ids, first["features"]["ids"])
            pulled = timed("row_pull", table.get, uniq)
            timed("pad", pad_rows, pulled, EMB_DIM)
            prepared = PreparedBatch(batch, *timed(
                "prepare_batch", engine.prepare_batch, batch))

            def place():
                placed = engine.place_on_device(prepared, "cuda")
                torch.cuda.synchronize()
                return placed

            timed("device_placement", place)
            u = prepared.uniques[RECSYS_TABLE][1]
            uniques.append(u)
            grads = {RECSYS_TABLE: rng.standard_normal(
                (u, EMB_DIM)).astype(np.float32) * 1e-3}
            timed("apply", engine.apply_row_grads, grads, prepared.uniques)
        return {"rows_resident_after": table.num_rows,
                "unique_ids_median": int(np.median(uniques)),
                "ms_median": {k: float(np.median(v[HOST_ENGINE_SKIP:]))
                              for k, v in phases.items()},
                "ms_range": {k: [float(min(v[HOST_ENGINE_SKIP:])),
                                 float(max(v[HOST_ENGINE_SKIP:]))]
                             for k, v in phases.items()}}

    cold = run_pass()
    warm = run_pass()
    return {"table": f"{EMB_VOCAB} x {EMB_DIM} f32, native, lazy",
            "batch": EMB_BATCH, "ids": EMB_BATCH * EMB_IDS,
            "batches": HOST_ENGINE_BATCHES, "skipped": HOST_ENGINE_SKIP,
            "cold": cold, "warm": warm}


def host_async_check(torch, fa, pe):
    """The zoo's deepfm_host runner (async apply) on the card, inline and
    with pull-ahead (``iter_prepared``: rows pulled on a thread and
    placed on the card from pinned memory), against a synchronous runner
    over the same HOST_DISJOINT_BATCHES batches of disjoint ids: losses
    and the host table bit-equal, no kernel launched. Losses stay on the
    card until the run ends, so no step waits for the one before."""
    from elasticdl_tpu_torch.embedding.host_engine import HostStepRunner
    from elasticdl_tpu_torch.model_zoo.deepfm import deepfm_host as twin

    span = HOST_MAX_ID // HOST_DISJOINT_BATCHES
    rng = np.random.RandomState(SEED + 6)
    batches = []
    for b in range(HOST_DISJOINT_BATCHES):
        ids = b * span + rng.randint(0, span, (HOST_BATCH, HOST_IDS))
        batches.append({"features": {twin.FEATURE_KEY: ids.astype(np.int64)},
                        "labels": (ids.sum(1) % 2).astype(np.int32),
                        "mask": np.ones((HOST_BATCH,), np.float32)})

    def run(mode):
        runner = twin.make_host_runner()
        if mode == "sync":
            runner = HostStepRunner(runner.engine, async_apply=False)
        torch.manual_seed(SEED)
        model = twin.custom_model("cuda")
        reset_kernel_launches(fa, pe)
        state = runner.init_state(model, twin.optimizer(), batches[0],
                                  seed=SEED)
        step = runner.train_step(twin.loss)
        losses = []
        if mode == "pull_ahead":
            with runner.iter_prepared(iter(batches)) as prepared:
                for pb in prepared:
                    state, metrics = step(state, pb)
                    losses.append(metrics["loss"])
        else:
            for batch in batches:
                state, metrics = step(state, batch)
                losses.append(metrics["loss"])
        runner.flush()
        counts = kernel_launch_counts(fa, pe)
        ids, rows = runner.engine.tables[twin.TABLE_NAME].to_arrays()
        return dict(losses=[float(x) for x in losses], ids=ids, rows=rows,
                    counts=counts)

    runs = {mode: run(mode) for mode in ("sync", "async", "pull_ahead")}
    sync = runs["sync"]
    out = {"batches": HOST_DISJOINT_BATCHES, "id_span": span,
           "rows": int(sync["ids"].size), "losses_sync": sync["losses"]}
    for mode in ("async", "pull_ahead"):
        r = runs[mode]
        out[mode] = {
            "losses_bit_equal": r["losses"] == sync["losses"],
            "ids_equal": bool(np.array_equal(r["ids"], sync["ids"])),
            "rows_bit_equal": bool(r["rows"].shape == sync["rows"].shape
                                   and np.array_equal(r["rows"],
                                                      sync["rows"])),
            "rows_max_abs_diff": (float(np.abs(r["rows"] - sync["rows"]).max())
                                  if r["rows"].shape == sync["rows"].shape
                                  else None),
            "launches": r["counts"]}
    print("host async vs sync", json.dumps(out), flush=True)
    for mode in ("sync", "async", "pull_ahead"):
        check(not any(runs[mode]["counts"].values()),
              f"the host path ({mode}) launched kernels: "
              f"{runs[mode]['counts']}")
    for mode in ("async", "pull_ahead"):
        check(out[mode]["losses_bit_equal"] and out[mode]["ids_equal"]
              and out[mode]["rows_bit_equal"],
              f"{mode} apply on the card is not the sync apply: {out}")
    return out


def deepfm_functional_phase(torch, fa, pe, root):
    """deepfm_functional, DEEPFM_STEPS Local steps on the card and on the
    CPU from the same seed: losses, first-step gradients and every
    parameter's change agree (TRAJ_TOL); no kernel launches."""
    from elasticdl_tpu_torch.api.local_executor import LocalExecutor
    from elasticdl_tpu_torch.testing import data as tdata

    records = tdata.create_frappe_record_file(
        os.path.join(root, "deepfm.rec"), DEEPFM_STEPS * HOST_BATCH,
        seed=SEED + 5, input_length=HOST_IDS, max_id=HOST_MAX_ID)
    runs = {}
    for dev in ("cuda", "cpu"):
        args = tdata.make_local_args(
            tdata.model_zoo_dir(), "deepfm.deepfm_functional.custom_model",
            records, minibatch_size=HOST_BATCH,
            extra=["--device", dev, "--random_seed", str(SEED)])
        record = step_recorder(torch)
        executor = LocalExecutor(args, callbacks=[record])
        reset_kernel_launches(fa, pe)
        executor.run()
        record.counts = kernel_launch_counts(fa, pe)
        record.final = {name: p.detach().float().cpu()
                        for name, p in executor.state.model.named_parameters()}
        runs[dev] = record
    card, cpu = runs["cuda"], runs["cpu"]
    losses = {dev: [float(x) for x in r.loss] for dev, r in runs.items()}
    rel = [abs(a - b) / abs(b) for a, b in zip(losses["cuda"],
                                               losses["cpu"])]
    grad_l2 = {n: rel_err(card.first_grads[n].numpy(),
                          cpu.first_grads[n].numpy()) for n in cpu.initial}
    delta_l2 = {n: rel_err((card.final[n] - card.initial[n]).numpy(),
                           (cpu.final[n] - cpu.initial[n]).numpy())
                for n in cpu.initial}
    out = {"steps": len(rel), "batch": HOST_BATCH,
           "losses_cuda": losses["cuda"], "losses_cpu": losses["cpu"],
           "loss_max_rel_diff": max(rel), "grad_l2": grad_l2,
           "delta_l2": delta_l2, "launches_card": card.counts,
           "launches_cpu": cpu.counts, "tol": TRAJ_TOL}
    print("deepfm_functional card vs cpu", json.dumps(out), flush=True)
    check(len(rel) == DEEPFM_STEPS, f"{len(rel)} deepfm_functional steps")
    check(all(torch.equal(card.initial[n], cpu.initial[n])
              for n in cpu.initial), "deepfm: other initial weights")
    check(not any(card.counts.values()) and not any(cpu.counts.values()),
          f"deepfm_functional launched kernels: {card.counts}")
    check(max(rel) <= TRAJ_TOL["loss"], f"deepfm card vs CPU losses {out}")
    check(max(grad_l2.values()) <= TRAJ_TOL["grad_l2"],
          f"deepfm card vs CPU first-step gradients {grad_l2}")
    check(max(delta_l2.values()) <= TRAJ_TOL["delta_l2"],
          f"deepfm card vs CPU parameter changes {delta_l2}")
    return out


def vision_phase(torch, fa, pe, root):
    """The vision zoo on the card: mnist_functional through
    LocalExecutor (card vs CPU, the padded-batch guard, the bundle
    served), resnet50 at full width timed; every kernel counter 0."""
    mnist = mnist_phase(torch, fa, pe, root)
    resnet = resnet50_phase(torch, fa, pe)
    out = {"mnist_functional": mnist, "resnet50": resnet}
    print("vision", json.dumps(out), flush=True)
    return out


def mnist_phase(torch, fa, pe, root):
    from elasticdl_tpu_torch.api.local_executor import LocalExecutor
    from elasticdl_tpu_torch.model_zoo.mnist import mnist_functional as twin
    from elasticdl_tpu_torch.serving.model_store import load_served_model
    from elasticdl_tpu_torch.testing import data as tdata

    records = tdata.create_mnist_record_file(
        os.path.join(root, "mnist.rec"), VISION_STEPS * VISION_BATCH,
        seed=SEED)
    runs = {}
    for dev in ("cuda", "cpu"):
        out = os.path.join(root, f"mnist_{dev}")
        args = tdata.make_local_args(
            tdata.model_zoo_dir(), "mnist.mnist_functional.custom_model",
            records, minibatch_size=VISION_BATCH,
            extra=["--device", dev, "--random_seed", str(SEED),
                   "--output", out])
        record = step_recorder(torch)
        executor = LocalExecutor(args, callbacks=[record])
        reset_kernel_launches(fa, pe)          # the vision path starts here
        executor.run()
        record.counts = kernel_launch_counts(fa, pe)    # ... and ends
        record.final = {name: p.detach().float().cpu()
                        for name, p in executor.state.model.named_parameters()}
        record.stats = {name: b.cpu().clone()
                        for name, b in executor.state.batch_stats.items()}
        record.executor, record.bundle = executor, out
        runs[dev] = record
    card, cpu = runs["cuda"], runs["cpu"]
    losses = {dev: [float(x) for x in r.loss] for dev, r in runs.items()}
    # After the first step the learnable records' loss reaches 0 on both.
    rel = [abs(a - b) / max(abs(b), 1e-30)
           for a, b in zip(losses["cuda"], losses["cpu"])]
    grad_l2 = {n: rel_err(card.first_grads[n].numpy(),
                          cpu.first_grads[n].numpy())
               for n in cpu.initial if np.any(cpu.first_grads[n].numpy())}
    delta_l2 = {n: rel_err((card.final[n] - card.initial[n]).numpy(),
                           (cpu.final[n] - cpu.initial[n]).numpy())
                for n in cpu.initial}
    stats_l2 = {n: rel_err(card.stats[n].numpy(), cpu.stats[n].numpy())
                for n in cpu.stats}
    # The card's bundle served on the card, against the trained model's
    # eval forward on the same batch; then the guard, which trains on.
    served = load_served_model(
        card.bundle, device="cuda",
        model_fn=lambda: twin.custom_model(device="cuda"))
    features = card.executor.last_batch["features"]
    with torch.no_grad():
        want = card.executor.state.model.eval()(
            torch.from_numpy(features).cuda()).cpu().numpy()
    reset_kernel_launches(fa, pe)
    got = served.predict(features)
    serve_counts = kernel_launch_counts(fa, pe)
    serve_l2 = rel_err(got, want)
    guard = padded_guard_check(torch, card.executor.state, twin)
    out = {"model": "mnist_functional twin (model_zoo/mnist/"
                    "mnist_functional.py, bf16, SGD 0.1 momentum 0.9), "
                    f"random weights, seed {SEED}",
           "batch": VISION_BATCH, "steps": len(rel),
           "losses_cuda": losses["cuda"], "losses_cpu": losses["cpu"],
           "loss_max_rel_diff": max(rel), "grad_l2": grad_l2,
           "delta_l2": delta_l2, "stats_l2": stats_l2,
           "launches_card": card.counts, "launches_cpu": cpu.counts,
           "launches_served": serve_counts, "padded_guard": guard,
           "served_vs_eval_l2": serve_l2,
           "tol": dict(TRAJ_TOL, stats_l2=VISION_STATS_TOL,
                       served=LOGITS_REL_TOL)}
    print("mnist_functional card vs cpu", json.dumps(out), flush=True)
    check(len(rel) == VISION_STEPS, f"{len(rel)} mnist steps")
    check(all(torch.equal(card.initial[n], cpu.initial[n])
              for n in cpu.initial), "mnist: other initial weights")
    for counts in (card.counts, cpu.counts, serve_counts):
        check(not any(counts.values()),
              f"the vision path launched kernels: {counts}")
    check(all(np.isfinite(losses["cuda"])), "mnist: non-finite loss")
    check(losses["cuda"][-1] < losses["cuda"][0],
          f"mnist: the loss did not fall: {losses['cuda']}")
    check(max(rel) <= TRAJ_TOL["loss"], f"mnist card vs CPU losses {out}")
    check(grad_l2 and max(grad_l2.values()) <= TRAJ_TOL["grad_l2"],
          f"mnist card vs CPU first-step gradients {grad_l2}")
    check(max(delta_l2.values()) <= TRAJ_TOL["delta_l2"],
          f"mnist card vs CPU parameter changes {delta_l2}")
    check(max(stats_l2.values()) <= VISION_STATS_TOL,
          f"mnist card vs CPU statistics {stats_l2}")
    check(all(guard.values()), f"the padded-batch guard on the card: {guard}")
    check(serve_l2 <= LOGITS_REL_TOL, f"served vs eval forward {serve_l2}")
    return out


def padded_guard_check(torch, state, twin):
    """On the card: a full batch moves the statistics; a batch with
    padded rows leaves them bit-equal, from a host mask and from a batch
    already on the card (torch.where, no read-back); the step still
    trains."""
    from elasticdl_tpu_torch.core.step import build_train_step
    from elasticdl_tpu_torch.data.batcher import pad_batch, tree_map

    rng = np.random.default_rng(SEED + 40)

    def batch(real, placed=False):
        b = pad_batch(rng.random((real, 28, 28), dtype=np.float32),
                      rng.integers(0, 10, real).astype(np.int32), real,
                      VISION_BATCH)
        return tree_map(lambda x: torch.from_numpy(x).cuda(), b) \
            if placed else b

    def stats():
        return [b.clone() for b in state.batch_stats.values()]

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b))

    step = build_train_step(twin.loss)
    out = {}
    before = stats()
    step(state, batch(VISION_BATCH))
    out["full_moves"] = not same(before, stats())
    for placed in (False, True):
        before = stats()
        weight = state.model.Dense_0.weight.detach().clone()
        step(state, batch(VISION_BATCH // 2, placed))
        key = "placed" if placed else "host"
        out[f"padded_{key}_bit_equal"] = same(before, stats())
        out[f"padded_{key}_trains"] = not torch.equal(
            weight, state.model.Dense_0.weight)
    torch.cuda.synchronize()
    return out


def resnet50_phase(torch, fa, pe):
    """The resnet50 zoo twin (custom_model(): s2d stem, 10 classes, bf16)
    at RESNET_BATCH x RESNET_HW^2 through the executor's train step,
    timed: step ms (CUDA events) beside issue ms, examples/s, peak
    memory; a finite loss and moved statistics; no kernel launches."""
    from elasticdl_tpu_torch.core.model_spec import get_model_spec
    from elasticdl_tpu_torch.core.step import build_train_step
    from elasticdl_tpu_torch.core.train_state import init_train_state
    from elasticdl_tpu_torch.testing import data as tdata

    torch.manual_seed(SEED)
    spec = get_model_spec(tdata.model_zoo_dir(),
                          "resnet50.resnet50.custom_model", device="cuda")
    state = init_train_state(spec.model, spec.make_optimizer(), seed=SEED)
    step = build_train_step(spec.loss)
    rng = np.random.RandomState(SEED)      # bench_suite._make_batch's
    batches = [{"features": rng.rand(RESNET_BATCH, RESNET_HW, RESNET_HW,
                                     3).astype(np.float32),
                "labels": rng.randint(0, 10, RESNET_BATCH).astype(np.int32),
                "mask": np.ones(RESNET_BATCH, np.float32)}
               for _ in range(2)]
    initial_stats = {k: v.clone() for k, v in state.batch_stats.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_kernel_launches(fa, pe)            # the resnet path starts here
    events, issue_ms, losses = [], [], []
    for i in range(VISION_WARM + VISION_TIMED):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        state, metrics = step(state, batches[i % 2])
        end.record()
        issue_ms.append((time.perf_counter() - t0) * 1e3)
        events.append((start, end))
        losses.append(metrics["loss"])
    torch.cuda.synchronize()
    counts = kernel_launch_counts(fa, pe)    # ... and ends
    peak = torch.cuda.max_memory_allocated()
    clocks = smi("clocks.sm,clocks.max.sm,power.draw,temperature.gpu")
    step_ms = [s.elapsed_time(e) for s, e in events[VISION_WARM:]]
    timed_issue = issue_ms[VISION_WARM:]
    losses = [float(x) for x in losses]
    moved = {k: not torch.equal(v, initial_stats[k])
             for k, v in state.batch_stats.items()}
    finite = all(bool(torch.isfinite(p).all())
                 for p in state.model.parameters())
    median = float(np.median(step_ms))
    out = {"model": "resnet50 twin (model_zoo/resnet50/resnet50.py "
                    "custom_model(): s2d stem, bottleneck v1.5 (3, 4, 6, "
                    "3), 10 classes, bf16, SGD 0.02 Nesterov), random "
                    f"weights, seed {SEED}",
           "batch": RESNET_BATCH, "image_hw": RESNET_HW,
           "warm_steps": VISION_WARM, "timed_steps": VISION_TIMED,
           "step_ms": spread(step_ms), "issue_ms": spread(timed_issue),
           "examples_per_s": RESNET_BATCH / (median / 1e3),
           "max_memory_allocated_bytes": peak, "losses": losses,
           "params_finite": finite, "statistics": len(moved),
           "statistics_moved": sum(moved.values()), "launches": counts,
           "card": smi("name,power.limit"), "clocks_after": clocks}
    print("resnet50 training", json.dumps(out), flush=True)
    check(all(np.isfinite(losses)) and finite,
          f"resnet50: non-finite loss or weights: {losses}")
    check(moved and all(moved.values()),
          f"resnet50: statistics that did not move: "
          f"{[k for k, v in moved.items() if not v]}")
    check(not any(counts.values()), f"resnet50 launched kernels: {counts}")
    return out


def tabular_records(root):
    """{kind: path} of the phase's records, from the port's generators
    (the JAX generators' bytes for the same seed)."""
    from elasticdl_tpu_torch.testing import data as tdata

    return {
        "census": tdata.create_census_record_file(
            os.path.join(root, "census.rec"), CENSUS_RECORDS, seed=SEED),
        "census_eval": tdata.create_census_record_file(
            os.path.join(root, "census_eval.rec"), CENSUS_EVAL_RECORDS,
            seed=SEED + 1),
        "heart": tdata.create_heart_record_file(
            os.path.join(root, "heart.rec"), TABULAR_RECORDS, seed=SEED),
        "iris": tdata.create_iris_csv(
            os.path.join(root, "iris.csv"), TABULAR_RECORDS, seed=SEED),
    }


def tabular_twin_phase(torch, fa, pe, root, model_def, records):
    """One tabular twin, TABULAR_STEPS Local steps at TABULAR_BATCH on
    the card and on the CPU from the same seed: losses, first-step
    gradients and every parameter's change within TRAJ_TOL; no kernel
    launches. The card run exports its --output bundle."""
    from elasticdl_tpu_torch.api.local_executor import LocalExecutor
    from elasticdl_tpu_torch.testing import data as tdata

    name = model_def.split(".")[1]
    runs = {}
    for dev in ("cuda", "cpu"):
        extra = ["--device", dev, "--random_seed", str(SEED),
                 "--max_steps", str(TABULAR_STEPS)]
        if dev == "cuda":
            extra += ["--output", os.path.join(root, f"{name}_bundles",
                                               "v1")]
        args = tdata.make_local_args(
            tdata.model_zoo_dir(), model_def, records,
            minibatch_size=TABULAR_BATCH, extra=extra)
        record = step_recorder(torch)
        executor = LocalExecutor(args, callbacks=[record])
        before = kernel_launch_counts(fa, pe)
        executor.run()
        record.counts = launches_since(fa, pe, before)
        record.final = {n: p.detach().float().cpu()
                        for n, p in executor.state.model.named_parameters()}
        record.executor = executor
        runs[dev] = record
    card, cpu = runs["cuda"], runs["cpu"]
    losses = {dev: [float(x) for x in r.loss] for dev, r in runs.items()}
    rel = [abs(a - b) / abs(b) for a, b in zip(losses["cuda"],
                                               losses["cpu"])]
    grad_l2 = {n: rel_err(card.first_grads[n].numpy(),
                          cpu.first_grads[n].numpy()) for n in cpu.initial}
    delta_l2 = {n: rel_err((card.final[n] - card.initial[n]).numpy(),
                           (cpu.final[n] - cpu.initial[n]).numpy())
                for n in cpu.initial}
    out = {"steps": len(rel), "batch": TABULAR_BATCH,
           "losses_cuda": losses["cuda"], "losses_cpu": losses["cpu"],
           "loss_max_rel_diff": max(rel), "grad_l2": grad_l2,
           "delta_l2": delta_l2, "launches_card": card.counts,
           "launches_cpu": cpu.counts, "tol": TRAJ_TOL}
    print(f"{name} card vs cpu", json.dumps(out), flush=True)
    check(len(rel) == TABULAR_STEPS, f"{len(rel)} {name} steps")
    check(all(torch.equal(card.initial[n], cpu.initial[n])
              for n in cpu.initial), f"{name}: other initial weights")
    check(not any(card.counts.values()) and not any(cpu.counts.values()),
          f"{name} launched kernels: {card.counts}")
    check(all(np.isfinite(losses["cuda"])), f"{name}: non-finite loss")
    check(max(rel) <= TRAJ_TOL["loss"], f"{name} card vs CPU losses {out}")
    check(max(grad_l2.values()) <= TRAJ_TOL["grad_l2"],
          f"{name} card vs CPU first-step gradients {grad_l2}")
    check(max(delta_l2.values()) <= TRAJ_TOL["delta_l2"],
          f"{name} card vs CPU parameter changes {delta_l2}")
    return out, card.executor


def census_timed_phase(torch, fa, pe, records, eval_records):
    """census_wide_deep through LocalExecutor on the card for
    TABULAR_TIMED_EPOCHS, evaluated at the end: step ms (CUDA events)
    beside issue ms, examples/s, peak memory; its dataset_fn on one
    batch on the host."""
    from elasticdl_tpu_torch.api.local_executor import LocalExecutor
    from elasticdl_tpu_torch.common.constants import Mode
    from elasticdl_tpu_torch.data.record_file import RecordFileScanner
    from elasticdl_tpu_torch.model_zoo.census import census_wide_deep as twin
    from elasticdl_tpu_torch.testing import data as tdata

    args = tdata.make_local_args(
        tdata.model_zoo_dir(), "census.census_wide_deep.custom_model",
        records, validation_data=eval_records,
        minibatch_size=TABULAR_BATCH, num_epochs=TABULAR_TIMED_EPOCHS,
        extra=["--device", "cuda", "--random_seed", str(SEED)])
    record = step_recorder(torch)
    executor = LocalExecutor(args, callbacks=[record])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = kernel_launch_counts(fa, pe)
    result = executor.run()
    counts = launches_since(fa, pe, before)
    peak = torch.cuda.max_memory_allocated()
    step_ms = [s.elapsed_time(e) for s, e in record.events[TABULAR_WARM:]]
    issue = record.issue_ms[TABULAR_WARM:]
    losses = [float(x) for x in record.loss]
    with RecordFileScanner(records, 0, TABULAR_BATCH) as scanner:
        batch = list(scanner)
    decode_ms = []
    for _ in range(TABULAR_DECODES):
        t0 = time.perf_counter()
        twin.dataset_fn(batch, Mode.TRAINING, None)
        decode_ms.append((time.perf_counter() - t0) * 1e3)
    median = float(np.median(step_ms))
    out = {"model": "census_wide_deep twin (model_zoo/census/"
                    "census_wide_deep.py: 22 x 1 wide and 22 x 8 deep "
                    "tables, bf16 MLP 34-16-8-1, Adam 1e-3 x 0.3), random "
                    f"weights, seed {SEED}",
           "batch": TABULAR_BATCH, "records": CENSUS_RECORDS,
           "steps": len(losses), "warm_steps": TABULAR_WARM,
           "step_ms": spread(step_ms), "issue_ms": spread(issue),
           "examples_per_s": TABULAR_BATCH / (median / 1e3),
           "executor_examples_per_s": result["examples_per_sec"],
           "dataset_fn_ms": spread(decode_ms),
           "max_memory_allocated_bytes": peak,
           "first_loss": losses[0], "last_loss": losses[-1],
           "eval_metrics": result["eval_metrics"], "launches": counts,
           "card": smi("name,power.limit"),
           "clocks_after": smi("clocks.sm,clocks.max.sm,power.draw,"
                               "temperature.gpu")}
    print("census_wide_deep timed", json.dumps(out), flush=True)
    check(all(np.isfinite(losses)), f"census timed: non-finite {losses}")
    check(result["eval_metrics"] is not None
          and 0.0 <= result["eval_metrics"]["accuracy"] <= 1.0,
          f"census timed: eval metrics {result['eval_metrics']}")
    check(not any(counts.values()), f"census timed launched {counts}")
    return out


def census_serving_check(torch, fa, pe, executor, bundles):
    """The card run's bundle (the one version under ``bundles``) through
    ModelStore and InferenceServer on the card: one JSON predict of dict
    features against the trained model's eval forward on the same
    rows."""
    from elasticdl_tpu_torch.model_zoo.census import census_wide_deep as twin
    from elasticdl_tpu_torch.serving.model_store import ModelStore
    from elasticdl_tpu_torch.serving.server import InferenceServer

    features = {k: v[:TABULAR_SERVED_ROWS]
                for k, v in executor.last_batch["features"].items()}
    with torch.no_grad():
        want = executor.state.model.eval()(
            {k: torch.from_numpy(v).cuda() for k, v in features.items()}
        ).cpu().numpy()
    store = ModelStore(bundles, device="cuda",
                       model_fn=lambda: twin.custom_model(device="cuda"))
    store.load_initial()
    server = InferenceServer(store, port=0, batch_deadline_ms=1).start()
    before = kernel_launch_counts(fa, pe)
    try:
        body = json.dumps({"features": {k: v.tolist()
                                        for k, v in features.items()}})
        request = urllib.request.Request(
            f"http://localhost:{server.port}/v1/predict",
            data=body.encode("utf-8"),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(request, timeout=600) as resp:
            status, reply = resp.status, json.loads(resp.read())
    finally:
        server.stop()
        store.stop()
    counts = launches_since(fa, pe, before)
    got = np.asarray(reply["predictions"], np.float32)
    out = {"status": status, "rows": TABULAR_SERVED_ROWS,
           "model_version": reply["model_version"],
           "served_vs_eval_l2": rel_err(got, want), "launches": counts,
           "tol": LOGITS_REL_TOL}
    print("census_wide_deep served", json.dumps(out), flush=True)
    check(status == 200 and got.shape == want.shape,
          f"census served: {status} {got.shape}")
    check(out["served_vs_eval_l2"] <= LOGITS_REL_TOL,
          f"census served vs eval forward {out}")
    check(not any(counts.values()), f"census serving launched {counts}")
    return out


def tabular_phase(torch, fa, pe, root):
    """The tabular zoo on the card: each twin card vs CPU, census wide &
    deep timed and served; every kernel counter 0 over the phase."""
    records = tabular_records(root)
    twins, executors = {}, {}
    reset_kernel_launches(fa, pe)              # the tabular path starts here
    for model_def, kind in TABULAR_TWINS:
        name = model_def.split(".")[1]
        twins[name], executors[name] = tabular_twin_phase(
            torch, fa, pe, root, model_def, records[kind])
    timed = census_timed_phase(torch, fa, pe, records["census"],
                               records["census_eval"])
    served = census_serving_check(
        torch, fa, pe, executors["census_wide_deep"],
        os.path.join(root, "census_wide_deep_bundles"))
    launches = kernel_launch_counts(fa, pe)    # ... and ends
    out = {"twins": twins, "census_wide_deep": timed, "served": served,
           "launches": launches, "card": smi("name,power.limit")}
    print("tabular", json.dumps({k: out[k] for k in
                                 ("census_wide_deep", "served",
                                  "launches")}), flush=True)
    check(not any(launches.values()),
          f"the tabular path launched kernels: {launches}")
    return out


def bit_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return (a.dtype == b.dtype and a.shape == b.shape
            and np.array_equal(a.reshape(-1).view(np.uint8),
                               b.reshape(-1).view(np.uint8)))


def unequal_leaves(got, want):
    """Names of the leaves of ``want`` that ``got`` lacks or holds with
    other bits."""
    return [n for n in want if n not in got or not bit_equal(got[n], want[n])]


def checkpoint_registry():
    """The port's registry's ``checkpoint_*`` series: histograms as
    (count, sum), counters and gauges as their value."""
    from elasticdl_tpu_torch.observability import default_registry

    out = {}
    for family in default_registry().snapshot()["families"]:
        if "_checkpoint_" not in family["name"]:
            continue
        name = family["name"].split("_checkpoint_", 1)[1]
        for series in family["series"]:
            key = name + "".join(f"[{v}]" for v in series["labels"])
            out[key] = ((series["count"], series["sum"])
                        if "count" in series else series["value"])
    return out


def registry_since(before):
    """Each checkpoint series' change since ``before``: histograms as
    {count, sum}, counters as their increase."""
    out = {}
    for key, value in checkpoint_registry().items():
        old = before.get(key)
        if isinstance(value, tuple):
            old = old or (0, 0.0)
            out[key] = {"count": value[0] - old[0], "sum": value[1] - old[1]}
        else:
            out[key] = value - (old or 0.0)
    return out


def host_rss():
    """(current, peak) resident bytes of this process."""
    import resource

    with open("/proc/self/statm") as f:
        pages = int(f.read().split()[1])
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    return pages * os.sysconf("SC_PAGE_SIZE"), peak


def dir_bytes(path):
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def ckpt_run(torch, fa, pe, zoo, model_def, data, batch, extra,
             callbacks=(), validation=""):
    """One LocalExecutor run on the card; every kernel counter is zeroed
    just before it and read just after."""
    from elasticdl_tpu_torch.api.local_executor import LocalExecutor
    from elasticdl_tpu_torch.testing import data as tdata

    args = tdata.make_local_args(
        zoo, model_def, data, validation_data=validation,
        minibatch_size=batch,
        extra=["--device", DEVICE, "--random_seed", str(SEED)] + extra)
    record = step_recorder(torch)
    executor = LocalExecutor(args, callbacks=[record, *callbacks])
    reset_kernel_launches(fa, pe)             # the path starts here
    result = executor.run()
    counts = kernel_launch_counts(fa, pe)     # ... and ends
    counts["row_update_adagrad"] = pe.row_update_rule_launches["adagrad"]
    return executor, [float(x) for x in record.loss], result, counts


def restored_check(torch, want_leaves, want_tables=None):
    """A Callback that, at the first batch of a resumed run (after the
    restore, before the first step), reads the state's leaves and the
    runner's host tables against the saved ones, bit for bit."""
    from elasticdl_tpu_torch.callbacks import Callback
    from elasticdl_tpu_torch.checkpoint import named_leaves_from_state

    class RestoredCheck(Callback):
        reading = None

        def on_train_batch_begin(self, owner=None):
            if self.reading is not None:
                return
            got = named_leaves_from_state(owner.state)
            bad = unequal_leaves(got, want_leaves)
            extra = sorted(set(got) - set(want_leaves))
            tables_bad = []
            for name, (ids, rows) in (want_tables or {}).items():
                got_ids, got_rows = \
                    owner._step_runner.host_tables[name].to_arrays()
                if not (bit_equal(got_ids, ids) and bit_equal(got_rows,
                                                              rows)):
                    tables_bad.append(name)
            self.reading = {"step": owner.state.step,
                            "leaves": len(want_leaves), "unequal": bad,
                            "unexpected": extra,
                            "host_tables": sorted(want_tables or {}),
                            "host_tables_unequal": tables_bad}

    return RestoredCheck()


def loss_rel(got, want):
    return max(abs(x - y) / abs(y) for x, y in zip(got, want))


def checkpoint_recsys_part(torch, fa, pe, root):
    """(a) The recsys twin at full width: straight against split, the
    restored state against the saved one, the save and restore read
    from the port's registry."""
    from elasticdl_tpu_torch.checkpoint import named_leaves_from_state
    from elasticdl_tpu_torch.testing import data as tdata

    both = os.path.join(root, "ckpt_recsys_ab")
    os.makedirs(both)
    files = [tdata.create_frappe_record_file(
        os.path.join(both, f"{part}.rec"), CKPT_RECORDS, seed=seed,
        input_length=EMB_IDS, max_id=EMB_VOCAB)
        for part, seed in (("a", SEED + 10), ("b", SEED + 11))]
    evalf = tdata.create_frappe_record_file(
        os.path.join(root, "ckpt_recsys_eval.rec"), CKPT_EVAL_RECORDS,
        seed=SEED + 12, input_length=EMB_IDS, max_id=EMB_VOCAB)
    zoo = write_zoo(root, "ckpt_recsys", RECSYS_ZOO.format(mode="always"))
    model_def = "ckpt_recsys.rec.custom_model"
    ckpt = os.path.join(root, "ckpt_recsys")

    def run(data, extra, callbacks=()):
        return ckpt_run(torch, fa, pe, zoo, model_def, data, EMB_BATCH,
                        extra, callbacks, validation=evalf)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rss_before = host_rss()[0]
    snap = table_snapshot(torch)
    straight, s_loss, _, s_counts = run(both, [], [snap])
    initial = snap.initial[RECSYS_TABLE]
    s_table = straight.state.tables[RECSYS_TABLE]
    s_acc = straight.state.slot_tables[RECSYS_TABLE]["accumulator"]
    del straight
    before = checkpoint_registry()
    first, f_loss, _, f_counts = run(files[0], [
        "--checkpoint_dir", ckpt, "--checkpoint_steps", str(CKPT_STEPS)])
    saved_registry = registry_since(before)
    saved_files = sorted(os.listdir(ckpt))
    saved_bytes = dir_bytes(ckpt)
    t0 = time.monotonic()
    saved = named_leaves_from_state(first.state)   # the state at the save
    host_copy_s = time.monotonic() - t0
    del first
    torch.cuda.empty_cache()
    before = checkpoint_registry()
    restored = restored_check(torch, saved)
    resumed, r_loss, _, r_counts = run(files[1], [
        "--checkpoint_dir_for_init", ckpt], [restored])
    restore_registry = registry_since(before)
    peak = torch.cuda.max_memory_allocated()
    rss_after, rss_peak = host_rss()
    del saved
    r_table = resumed.state.tables[RECSYS_TABLE]
    r_acc = resumed.state.slot_tables[RECSYS_TABLE]["accumulator"]
    ids = np.concatenate([frappe_ids(CKPT_RECORDS, EMB_IDS, EMB_VOCAB, s)
                          for s in (SEED + 10, SEED + 11)])
    touched = torch.zeros(initial.shape[0], dtype=torch.bool,
                          device=initial.device)
    touched[torch.from_numpy(np.unique(ids)).to(initial.device)] = True
    untouched = ~touched
    delta_r = (r_table[touched] - initial[touched]).cpu().numpy()
    delta_s = (s_table[touched] - initial[touched]).cpu().numpy()
    save_s = saved_registry["save_seconds"]["sum"]
    stall = saved_registry["stall_seconds"]
    restore_s = restore_registry["restore_seconds"]["sum"]
    eval_batches = -(-CKPT_EVAL_RECORDS // EMB_BATCH)
    out = {
        "model": "recsys ranker twin, 1,000,000 x 256 f32 table, Adagrad "
                 "rows, bf16 MLP, Adam; kernels pinned",
        "steps": {"straight": len(s_loss), "first": len(f_loss),
                  "resumed": len(r_loss)},
        "resumed_step": resumed.state.step,
        "launches": {"straight": s_counts, "first": f_counts,
                     "resumed": r_counts},
        "restored": restored.reading,
        "saved_files": saved_files, "saved_dir_bytes": saved_bytes,
        "losses_straight": s_loss, "losses_split": f_loss + r_loss,
        "loss_max_rel_diff": loss_rel(f_loss + r_loss, s_loss),
        "table_delta_l2": rel_err(delta_r, delta_s),
        "table_delta_max_abs_err": float(np.abs(delta_r - delta_s).max()),
        "accumulator_l2": rel_err(r_acc[touched].cpu().numpy(),
                                  s_acc[touched].cpu().numpy()),
        "touched_rows": int(touched.sum()),
        "untouched_bit_equal": bool(
            torch.equal(r_table[untouched], initial[untouched])
            and bool((r_acc[untouched] == 0.1).all())),
        "stall_s": stall, "save_s": save_s,
        "saved_bytes": saved_registry["saved_bytes_total"],
        "save_gb_per_s": saved_registry["saved_bytes_total"] / save_s / 1e9,
        "restore_s": restore_s,
        "restore_gb_per_s": saved_bytes / restore_s / 1e9,
        "host_copy_s": host_copy_s,
        "registry_save": saved_registry, "registry_restore": restore_registry,
        "max_memory_allocated_bytes": peak,
        "host_rss_bytes": {"before": rss_before, "after": rss_after,
                           "peak": rss_peak},
        "tol": SPARSE_TOL,
    }
    print("checkpoint recsys", json.dumps(out), flush=True)
    reading = restored.reading or {}
    check(reading.get("step") == CKPT_STEPS and not reading.get("unequal")
          and not reading.get("unexpected"),
          f"the restored state is not the saved one: {reading}")
    check(resumed.state.step == 2 * CKPT_STEPS,
          f"resumed at step {resumed.state.step}")
    for name, counts, steps in (("straight", s_counts, 2 * CKPT_STEPS),
                                ("first", f_counts, CKPT_STEPS),
                                ("resumed", r_counts, CKPT_STEPS)):
        want = {k: 0 for k in counts}
        want.update(lookup_combine=steps + eval_batches, row_update=steps,
                    row_update_adagrad=steps)
        check(counts == want, f"{name} run launches {counts}, not {want}")
    check(out["loss_max_rel_diff"] <= SPARSE_TOL["loss"],
          f"resumed vs straight losses {out}")
    check(out["table_delta_l2"] <= SPARSE_TOL["delta_l2"]
          and out["accumulator_l2"] <= SPARSE_TOL["delta_l2"],
          f"resumed vs straight rows {out}")
    check(out["untouched_bit_equal"], "an untouched row or accumulator moved")
    check(saved_files == [f"version-{CKPT_STEPS}"]
          and saved_registry["saves_total"] == 1
          and stall["count"] == 1
          and restore_registry["restore_seconds"]["count"] == 1,
          f"saves {saved_files}, registry {saved_registry}")
    return out


def checkpoint_host_part(torch, fa, pe, root):
    """(b) deepfm_host on the host tier: a base and two deltas, resumed
    from the chain against a straight run (synchronous rows)."""
    from elasticdl_tpu_torch.checkpoint import named_leaves_from_state
    from elasticdl_tpu_torch.model_zoo.deepfm import deepfm_host as twin
    from elasticdl_tpu_torch.native.row_store import NativeEmbeddingTable
    from elasticdl_tpu_torch.testing import data as tdata

    both = os.path.join(root, "ckpt_host_ab")
    os.makedirs(both)
    files = [tdata.create_frappe_record_file(
        os.path.join(both, f"{part}.rec"), n, seed=seed,
        input_length=HOST_IDS, max_id=HOST_MAX_ID)
        for part, n, seed in (("a", HOST_CKPT_A, SEED + 20),
                              ("b", HOST_CKPT_B, SEED + 21))]
    zoo = write_zoo(root, "ckpt_host", HOST_ZOO)
    model_def = "ckpt_host.rec.custom_model"
    ckpt = os.path.join(root, "ckpt_host")

    def run(data, extra, callbacks=()):
        return ckpt_run(torch, fa, pe, zoo, model_def, data, HOST_BATCH,
                        extra, callbacks)

    def main_rows(executor):
        return executor._step_runner.engine.tables[
            twin.TABLE_NAME].to_arrays()

    straight, s_loss, _, s_counts = run(both, [])
    s_ids, s_rows = main_rows(straight)
    first, f_loss, _, f_counts = run(files[0], [
        "--checkpoint_dir", ckpt, "--checkpoint_steps", "2",
        "--checkpoint_delta_chain", "2"])
    layout = sorted(os.listdir(ckpt))
    tables = {n: t.to_arrays()
              for n, t in first._step_runner.host_tables.items()}
    restored = restored_check(torch, named_leaves_from_state(first.state),
                              tables)
    resumed, r_loss, _, r_counts = run(files[1], [
        "--checkpoint_dir_for_init", ckpt], [restored])
    r_ids, r_rows = main_rows(resumed)
    initial = NativeEmbeddingTable(twin.TABLE_NAME,
                                   twin.EMBEDDING_DIM).get(s_ids)
    same_ids = bool(np.array_equal(r_ids, s_ids))
    out = {"model": "deepfm_host twin, 5500 x 16 host table, SGD rows, "
                    "synchronous runner",
           "layout": layout, "restored": restored.reading,
           "resumed_step": resumed.state.step,
           "launches": {"straight": s_counts, "first": f_counts,
                        "resumed": r_counts},
           "losses_straight": s_loss, "losses_split": f_loss + r_loss,
           "loss_max_rel_diff": loss_rel(f_loss + r_loss, s_loss),
           "same_ids": same_ids,
           "rows_delta_l2": (rel_err(r_rows - initial, s_rows - initial)
                             if same_ids else None),
           "tol": HOST_TOL}
    print("checkpoint host", json.dumps(out), flush=True)
    reading = restored.reading or {}
    check(layout == ["delta-4", "delta-6", "version-2"],
          f"host checkpoint layout {layout}")
    check(reading.get("step") == 6 and not reading.get("unequal")
          and not reading.get("host_tables_unequal")
          and len(reading.get("host_tables", [])) >= 2,
          f"the restored host state is not the saved one: {reading}")
    check(resumed.state.step == 8, f"resumed at {resumed.state.step}")
    for name, counts in (("straight", s_counts), ("first", f_counts),
                         ("resumed", r_counts)):
        check(not any(counts.values()),
              f"the host path ({name}) launched kernels: {counts}")
    check(out["loss_max_rel_diff"] <= HOST_TOL["loss"],
          f"resumed vs straight host losses {out}")
    check(same_ids and out["rows_delta_l2"] <= HOST_TOL["delta_l2"],
          f"resumed vs straight host rows {out}")
    return out


def lr_recorder():
    from elasticdl_tpu_torch.callbacks import Callback

    class LrRecorder(Callback):
        def __init__(self):
            self.lrs = []

        def on_train_batch_begin(self, owner=None):
            self.lrs.append(owner.state.optimizer.param_groups[0]["lr"])

    return LrRecorder()


def job_subprocess(role, zoo, model_def, data_flag, data, ckpt):
    """``python -m elasticdl_tpu_torch <role>`` on the card; its result
    from its log."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (here, env.get("PYTHONPATH", "")) if p)
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-m", "elasticdl_tpu_torch", role,
         "--model_zoo", zoo, "--model_def", model_def, data_flag, data,
         "--checkpoint_dir_for_init", ckpt,
         "--minibatch_size", str(TABULAR_BATCH), "--device", DEVICE],
        env=env, cwd=os.path.dirname(zoo), capture_output=True, text=True,
        timeout=600)
    seconds = time.monotonic() - t0
    check(proc.returncode == 0,
          f"{role} exited {proc.returncode}: {proc.stderr[-3000:]}")
    marker = f"{role} finished: "
    line = [x for x in proc.stderr.splitlines() if marker in x]
    check(len(line) == 1, f"{role}: no result line in {proc.stderr[-2000:]}")
    return json.loads(line[0].split(marker, 1)[1]), seconds


def checkpoint_jobs_part(torch, fa, pe, root):
    """(c) census_wide_deep: the schedule through a split run, then the
    evaluate and predict jobs in subprocesses from the checkpoint."""
    from elasticdl_tpu_torch.common.constants import Mode
    from elasticdl_tpu_torch.testing import data as tdata

    both = os.path.join(root, "ckpt_census_ab")
    os.makedirs(both)
    files = [tdata.create_census_record_file(
        os.path.join(both, f"{part}.rec"), CKPT_RECORDS, seed=seed)
        for part, seed in (("a", SEED + 30), ("b", SEED + 31))]
    evalf = tdata.create_census_record_file(
        os.path.join(root, "ckpt_census_eval.rec"), CENSUS_EVAL_RECORDS,
        seed=SEED + 32)
    zoo = write_zoo(root, "ckpt_census", CKPT_ZOO_CENSUS)
    model_def = "ckpt_census.rec.custom_model"
    ckpt, split_ckpt = (os.path.join(root, "ckpt_census"),
                        os.path.join(root, "ckpt_census_split"))
    tb = os.path.join(root, "ckpt_census_tb")

    def run(data, extra, validation=""):
        lrs = lr_recorder()
        executor, losses, result, counts = ckpt_run(
            torch, fa, pe, zoo, model_def, data, TABULAR_BATCH, extra,
            [lrs], validation=validation)
        return executor, losses, result, counts, lrs.lrs

    straight, s_loss, s_res, s_counts, s_lrs = run(
        both, ["--checkpoint_dir", ckpt, "--tensorboard_log_dir", tb],
        validation=evalf)
    _, f_loss, _, f_counts, f_lrs = run(files[0], [
        "--checkpoint_dir", split_ckpt, "--checkpoint_steps",
        str(CKPT_STEPS)])
    resumed, r_loss, _, r_counts, r_lrs = run(files[1], [
        "--checkpoint_dir_for_init", split_ckpt])
    metrics, eval_s = job_subprocess("evaluate", zoo, model_def,
                                     "--validation_data", evalf, ckpt)
    summary, predict_s = job_subprocess("predict", zoo, model_def,
                                        "--prediction_data", evalf, ckpt)
    pred_dir = os.path.join(zoo, "ckpt_census")
    preds = np.concatenate([
        np.load(os.path.join(pred_dir, name))
        for name in sorted(os.listdir(pred_dir)) if name.endswith(".npy")])
    want = []
    with torch.no_grad():
        for batch in straight._task_batches_raw(straight._eval_reader,
                                                Mode.PREDICTION):
            real = int(np.sum(batch["mask"]))
            out_b = straight._eval_step(straight.state, batch)
            want.append(out_b.float().cpu().numpy()[:real])
    want = np.concatenate(want)
    with open(os.path.join(tb, "scalars.jsonl")) as f:
        summaries = [json.loads(line) for line in f]
    out = {"model": "census_wide_deep twin, its schedule at "
                    f"{CENSUS_LR_SCALE}x the version",
           "lrs_straight": s_lrs, "lrs_split": f_lrs + r_lrs,
           "losses_straight": s_loss, "losses_split": f_loss + r_loss,
           "loss_max_rel_diff": loss_rel(f_loss + r_loss, s_loss),
           "resumed_step": resumed.state.step,
           "eval_metrics_training": s_res["eval_metrics"],
           "eval_metrics_job": metrics, "predict_job": summary,
           "predictions": list(preds.shape),
           "predictions_bit_equal": bit_equal(preds, want),
           "predictions_max_abs_err": float(np.abs(preds - want).max()),
           "job_seconds": {"evaluate": eval_s, "predict": predict_s},
           "tensorboard": summaries,
           "launches": {"straight": s_counts, "first": f_counts,
                        "resumed": r_counts}}
    print("checkpoint jobs", json.dumps(out), flush=True)
    check(f_lrs + r_lrs == s_lrs and len(set(s_lrs)) == 3,
          f"split run's learning rates {f_lrs + r_lrs} vs {s_lrs}")
    check(resumed.state.step == 2 * CKPT_STEPS,
          f"census resumed at {resumed.state.step}")
    check(out["loss_max_rel_diff"] <= TRAJ_TOL["loss"],
          f"census resumed vs straight losses {out}")
    check(metrics == s_res["eval_metrics"],
          f"evaluate job {metrics} vs training {s_res['eval_metrics']}")
    check(summary == {"batches": -(-CENSUS_EVAL_RECORDS // TABULAR_BATCH)}
          and out["predictions_bit_equal"],
          f"predict job vs eval forward {out}")
    check(summaries and summaries[-1].get("eval/accuracy")
          == s_res["eval_metrics"]["accuracy"],
          f"TensorBoard scalars {summaries}")
    for name, counts in out["launches"].items():
        counts = {k: v for k, v in counts.items()}
        check(not any(counts.values()),
              f"census ({name}) launched kernels: {counts}")
    return out


def checkpoint_phase(torch, fa, pe, root):
    """Checkpoints and resume on the card: the recsys twin at full width,
    deepfm_host's delta chain, census and the evaluate/predict jobs."""
    t0 = time.monotonic()
    out = {"recsys": checkpoint_recsys_part(torch, fa, pe, root)}
    torch.cuda.empty_cache()
    out["host"] = checkpoint_host_part(torch, fa, pe, root)
    out["jobs"] = checkpoint_jobs_part(torch, fa, pe, root)
    out["seconds"] = time.monotonic() - t0
    out["card"] = smi("name,power.limit")
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


def lookup_phase(torch, pe):
    """Kernel #5 alone (``--phase lookup``): every lookup check case of
    #5 and #6, then #5, #6, ``embedding_bag`` and the bound at the sweep
    tool's four tiers (its inputs, from the same seed), and the two
    lookup kernels' rows of the kernels line, launches counted over the
    tiers."""
    from elasticdl_tpu_torch.tools import bench_kernel_device_sweep as tool

    checks = lookup_checks(
        torch, pe, np.random.default_rng(SEED + 20),
        torch.Generator(device="cuda").manual_seed(SEED + 20))
    pe.reset_launches()
    tiers = tool.lookup_rows(
        pe, torch.Generator(device="cuda").manual_seed(SEED), iters=20,
        windows=5)
    launches = {"lookup_combine": (pe.lookup_launches, "lookup tiers"),
                "lookup_combine_aligned": (pe.aligned_launches,
                                           "lookup tiers")}
    lookup = lookup_times(
        torch, pe, torch.Generator(device="cuda").manual_seed(SEED + 40))
    return lookup_kernel_rows(checks, lookup, launches, tiers)


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


def lookup_times(torch, pe, gen):
    """Both lookup kernels at the recsys step's shape (B 512, L 32, D 256
    over 1M rows; the step's ~16,250 distinct ids), their plain version,
    the library call and route, and the bound."""
    from elasticdl_tpu_torch.tools import bench_kernel_device_sweep as tool

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
    return lookup


def embedding_times(torch, pe):
    """Each embedding kernel at the recsys step's shape (``lookup_times``;
    the row kernels at the step's 16,384 ids), its plain version, the
    library call or route, and the bound."""
    from elasticdl_tpu_torch.embedding.optimizer import Adagrad, Momentum
    from elasticdl_tpu_torch.embedding.optimizer import sparse_apply
    from elasticdl_tpu_torch.tools import bench_kernel_device_sweep as tool

    gen = torch.Generator(device="cuda").manual_seed(SEED + 40)
    rng = np.random.RandomState(SEED + 40)
    lookup = lookup_times(torch, pe, gen)
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


def kernel_errors(checks):
    """The largest error of each kernel's check cases."""
    err = {}
    for c in checks:
        reading = max(c.get(k, {}).get("max_abs_err", 0.0)
                      for k in ("table", "slot0", "slot1", "slot2")) \
            if "table" in c else c["max_abs_err"]
        err[c["kernel"]] = max(err.get(c["kernel"], 0.0), reading)
    return err


def lookup_kernel_rows(checks, lookup, launches, tiers):
    """The kernels-line entries of the two lookup kernels; ``launches``
    maps each to (count, the path it was counted on); ``tiers`` are the
    sweep tool's lookup rows (#5's times at each tier)."""
    err = kernel_errors(checks)
    bound_ms, bound_by = lookup["bound"]
    shape = {"vocab": EMB_VOCAB, "dim": EMB_DIM, "batch": EMB_BATCH,
             "num_ids": EMB_IDS, "combiner": "sum"}
    out = []
    for name, replaces in (
            ("lookup_combine", "elasticdl_tpu/ops/pallas_embedding.py:286"),
            ("lookup_combine_aligned",
             "elasticdl_tpu/ops/pallas_embedding.py:242")):
        row = {
            "name": name, "route": "cuda",
            "source": "elasticdl_tpu_torch/ops/csrc/embedding_lookup.cu",
            "replaces": replaces, **shape,
            "distinct_rows": lookup["distinct_rows"],
            "launches": launches[name][0], "launches_path": launches[name][1],
            "max_abs_err": err[name], "ms": lookup[name],
            "plain_ms": lookup["plain_ms"], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": lookup["library_ms"],
            "library_call": "torch.nn.functional.embedding_bag(mode='sum', "
                            "per_sample_weights)",
            "route_ms": lookup["route_ms"],
        }
        if name == "lookup_combine_aligned":
            row["tiers"] = [
                {k: t[k] for k in ("dim", "L", "batch", "aligned_ms",
                                   "kernel_ms", "embedding_bag_ms",
                                   "bound_ms", "aligned_plan")}
                for t in tiers]
        out.append(row)
    return out


def embedding_kernel_rows(checks, times, counts, sweep_counts, tiers):
    """The kernels-line entries of the four embedding kernels."""
    lookup, rows = times
    source = "elasticdl_tpu_torch/ops/csrc/"
    err = kernel_errors(checks)
    out = lookup_kernel_rows(checks, lookup, {
        "lookup_combine": (counts["lookup_combine"], "sparse training "
                           "(train steps + eval batches)"),
        "lookup_combine_aligned": (sweep_counts["lookup_combine_aligned"],
                                   "sparse sweep")}, tiers)
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


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument(
        "--phase", choices=("all", "fwd", "bwd", "chunk", "lookup", "host",
                            "vision", "tabular", "checkpoint"),
        default="all",
        help="fwd: build flash_attention_fwd.cu alone, then run kernel "
             "#1's checks and times and print its kernels row; bwd: the "
             "same for flash_attention_bwd.cu (#3 and #4); chunk: the "
             "same for flash_chunk_update.cu (#2); lookup: the same for "
             "embedding_lookup.cu (#5 and #6, timed at the sweep's tiers); "
             "host: the host training phase alone (no kernel build); "
             "vision: the vision phase alone (no kernel build); "
             "tabular: the tabular phase alone (no kernel build); "
             "checkpoint: the checkpoint phase alone (the embedding "
             "kernels only)")
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    from elasticdl_tpu_torch.ops import _build
    from elasticdl_tpu_torch.ops import flash_attention as fa
    from elasticdl_tpu_torch.ops import pallas_embedding as pe
    from elasticdl_tpu_torch.ops import ring_attention as ra

    print(smi("name,power.limit"), flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python "
          f"{sys.version.split()[0]}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    if args.phase in ("host", "vision", "tabular"):
        with tempfile.TemporaryDirectory() as root:
            if args.phase == "host":
                line = {"host_training": host_training_phase(torch, fa, pe,
                                                             root)}
            elif args.phase == "vision":
                line = {"vision": vision_phase(torch, fa, pe, root)}
            else:
                line = {"tabular": tabular_phase(torch, fa, pe, root)}
        print(json.dumps(line))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    t0 = time.monotonic()
    alone = {"fwd": [fa._SOURCE], "bwd": [fa._BWD_SOURCE],
             "chunk": [fa._CHUNK_SOURCE], "lookup": [pe._LOOKUP_SOURCE],
             "checkpoint": [pe._LOOKUP_SOURCE, pe._UPDATE_SOURCE]}
    logs = _build.build_all(alone.get(args.phase))
    print(f"built {sorted(logs)} in {time.monotonic() - t0:.1f}s",
          flush=True)
    for name, log in logs.items():
        for kernel_name, line in ptxas_lines(log):
            print(f"  {name}: {kernel_name}: {line}", flush=True)

    if args.phase == "bwd":
        bwd_rows, _ = bwd_kernel_phase(torch, fa)
        print(json.dumps({"kernels": bwd_rows}))
        return 0
    if args.phase == "chunk":
        chunk_row, _ = chunk_kernel_phase(torch, fa)
        print(json.dumps({"kernels": [chunk_row]}))
        return 0
    if args.phase == "lookup":
        print(json.dumps({"kernels": lookup_phase(torch, pe)}))
        return 0
    if args.phase == "checkpoint":
        with tempfile.TemporaryDirectory() as root:
            line = {"checkpoint": checkpoint_phase(torch, fa, pe, root)}
        print(json.dumps(line))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    kernel, _ = kernel_phase(torch, fa)
    if args.phase == "fwd":
        print(json.dumps({"kernels": [kernel]}))
        return 0
    bwd_rows, _ = bwd_kernel_phase(torch, fa)
    bwd_autograd_phase(torch, fa)
    chunk_row, _ = chunk_kernel_phase(torch, fa)
    _, ring_times = ring_check_phase(torch, fa, ra)
    zoo_phase(torch, fa)
    emb_checks = embedding_kernel_phase(torch, pe)
    with tempfile.TemporaryDirectory() as root:
        serving = serving_phase(torch, fa, root)
        twin_training_phase(torch, fa, root)
        training, counts = training_phase(torch, fa, root)
        ring_training = ring_training_phase(torch, fa)
        sparse = sparse_training_phase(torch, pe, root)
        small_twin_phase(torch, pe, root)
        host = host_training_phase(torch, fa, pe, root)
        vision = vision_phase(torch, fa, pe, root)
        tabular = tabular_phase(torch, fa, pe, root)
        checkpoint = checkpoint_phase(torch, fa, pe, root)
    fused = fused_path_phase(torch, pe)
    sweep, sweep_counts = sweep_phase(torch, pe)
    emb_times = embedding_times(torch, pe)
    kernel["launches"] = counts["flash_attention_fwd"]
    kernel["launches_serving"] = serving["flash_launches"]
    for row in bwd_rows:
        row["launches"] = counts[row["name"]]
    chunk_row["launches"] = ring_training["ring"]["launches"][
        "flash_chunk_update"]
    chunk_row["launches_path"] = (f"ring training ({RING_TRAIN_STEPS} "
                                  "train steps, remat)")
    chunk_row["ring_forward_s8192"] = ring_times
    emb_rows = embedding_kernel_rows(
        emb_checks, emb_times,
        {**sparse["launches"],
         "fused_row_update": fused["launches"]["fused_row_update"]},
        sweep_counts, sweep["lookup"])
    for row in [kernel, chunk_row] + bwd_rows + emb_rows:
        row["launches_host_training"] = host["launches_card"][row["name"]]
        row["launches_vision"] = (
            vision["mnist_functional"]["launches_card"][row["name"]]
            + vision["resnet50"]["launches"][row["name"]])
        row["launches_tabular"] = tabular["launches"][row["name"]]
        row["launches_checkpoint"] = {
            run: counts[row["name"]] for run, counts in
            checkpoint["recsys"]["launches"].items()}
    print(json.dumps({"serving": serving}))
    print(json.dumps({"training": training}))
    print(json.dumps({"sparse_training": sparse}))
    print(json.dumps({"ring_training": ring_training}))
    print(json.dumps({"host_training": host}))
    print(json.dumps({"vision": vision}))
    print(json.dumps({"tabular": tabular}))
    print(json.dumps({"checkpoint": checkpoint}))
    print(json.dumps({"kernels": [kernel, chunk_row] + bwd_rows
                      + emb_rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
