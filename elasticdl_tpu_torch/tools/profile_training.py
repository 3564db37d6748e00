"""Where a Local train step spends its device time, on one GPU.

    python -m elasticdl_tpu_torch.tools.profile_training [--batch 8]
        [--seq 1024] [--iters 5] [--sp N] [--remat]
    python -m elasticdl_tpu_torch.tools.profile_training --model recsys
        [--batch 512] [--iters 5]
    python -m elasticdl_tpu_torch.tools.profile_training --model resnet50
        [--batch 128] [--iters 5]
    python -m elasticdl_tpu_torch.tools.profile_training --model census
        [--batch 512] [--iters 5]
    python -m elasticdl_tpu_torch.tools.profile_training --model pipeline
        [--batch 16] [--microbatches 4] [--iters 5]

``--model transformer`` (the default) builds the transformer-LM
flagship (bench_suite.py ``_TRANSFORMER_SIZES["transformer"]``, vocab
32768, bf16, remat off, dropout 0) with seeded random weights and the
zoo twin's Adam 1e-3 and runs ``core.step.build_train_step`` on seeded
random token batches. With ``--sp N`` (N > 1) the model is built on an
``sp`` mesh of N entries of the card and the step is
``parallel.mesh_runner.MeshRunner``'s: attention is the ring over
chunk-update kernel #2 (chunks of seq / N). ``--remat`` recomputes
each block in the backward; ``max_len`` grows to ``--seq`` when it is
longer. ``--model recsys`` builds the recsys ranker twin
at full width (1,000,000 x 256 table, 32 ids an example) and runs its
sparse runner's step with the kernels pinned (``use_pallas="always"``)
on seeded random id batches. ``--model resnet50`` builds the resnet50
zoo twin (``custom_model()``: s2d stem, 10 classes, bf16) with seeded
random weights and runs ``core.step.build_train_step`` on bench_suite's
synthetic batches (uniform [0, 1) images, 224 x 224 x 3). ``--model
census`` builds census_wide_deep (BASELINE #5, bench_suite.py's
``census`` config) with seeded random weights and its Adam under the
zoo's schedule, and runs ``core.step.build_train_step`` on batches its
``dataset_fn`` makes of ``testing.data.create_census_record_file``'s
records (seed 0, written to a temporary directory); it also prints the
host's ms for ``dataset_fn`` on one batch (the median of ``--iters``
calls), the decode the executor's prefetch thread runs beside the step.
``--model pipeline`` builds ``PipelineLM`` at the flagship's widths
(dropout 0) on a one-card (pp 2, dp 2) mesh, 4 layers a stage, with its
own seeded weights, and runs its ``make_train_step`` (the zoo twin's
loss and Adam 1e-3) with ``--microbatches`` microbatches on seeded
random token batches.

Either way it times ``--iters`` steps with CUDA events beside the
host's time to issue them, then runs ``--iters`` steps under
``torch.profiler`` and prints one JSON line: the device time per step
(the union of kernel intervals; user annotations such as
``Optimizer.step`` are not kernels and are left out), its share of the
unprofiled step time (the profiler slows the host, so its own window
would understate the share), and the device time per step summed by
kernel name (largest first), with the attention kernels (#1 forward,
#2 chunk update, #3/#4 backward) also listed by name, and the device
time per step by family (``FAMILIES``: matrix products and
convolutions, reductions, elementwise passes, copies, the rest).
"""

import argparse
import json
import time

import numpy as np
import torch

from elasticdl_tpu_torch import bridge
from elasticdl_tpu_torch.core.step import build_train_step
from elasticdl_tpu_torch.core.train_state import init_train_state
from elasticdl_tpu_torch.model_zoo.transformer import transformer_lm
from elasticdl_tpu_torch.models.transformer import (
    TransformerConfig,
    TransformerLM,
)
from elasticdl_tpu_torch.parallel.mesh import make_mesh
from elasticdl_tpu_torch.parallel.mesh_runner import MeshRunner
from elasticdl_tpu_torch.tools.profile_serving import FLAGSHIP, _union_us

# Name stems of the attention kernels, as they appear in the profiler's
# (demangled) kernel names.
ATTENTION_KERNELS = {
    "flash_fwd": "#1 flash_attention_fwd",
    "flash_chunk": "#2 flash_chunk_update",
    "flash_bwd_dq": "#3 flash_attention_bwd_dq",
    "flash_bwd_dkv": "#4 flash_attention_bwd_dkv",
}


# (family, name stems) in the order a kernel name is tested against them.
FAMILIES = (
    ("products and convolutions", ("gemm", "conv", "xmma", "cutlass",
                                   "cudnn", "wgrad", "dgrad", "flash")),
    ("reductions", ("reduce",)),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
    ("copies", ("copy", "memcpy", "memset", "cat")),
)


def family(name: str) -> str:
    lower = name.lower()
    for label, stems in FAMILIES:
        if any(stem in lower for stem in stems):
            return label
    return "other"


def _resnet50(batch):
    from elasticdl_tpu_torch.model_zoo.resnet50 import resnet50

    torch.manual_seed(0)
    model = resnet50.custom_model(device="cuda")
    state = init_train_state(model, resnet50.optimizer(), seed=0)
    rng = np.random.RandomState(0)
    batches = [{"features": rng.rand(batch, 224, 224, 3).astype(np.float32),
                "labels": rng.randint(0, 10, batch).astype(np.int32),
                "mask": np.ones(batch, np.float32)} for _ in range(2)]
    return state, build_train_step(resnet50.loss), batches


def _census(batch, iters):
    """(state, step, batches, dataset_fn ms: the median of ``iters``
    decodes of one batch)."""
    import os
    import tempfile

    from elasticdl_tpu_torch.callbacks import apply_callbacks_to_optimizer
    from elasticdl_tpu_torch.common.constants import Mode
    from elasticdl_tpu_torch.data.record_file import RecordFileScanner
    from elasticdl_tpu_torch.model_zoo.census import census_wide_deep as twin
    from elasticdl_tpu_torch.testing.data import create_census_record_file

    torch.manual_seed(0)
    make_optimizer = apply_callbacks_to_optimizer(twin.optimizer(),
                                                  twin.callbacks())
    state = init_train_state(twin.custom_model(device="cuda"),
                             make_optimizer, seed=0)
    with tempfile.TemporaryDirectory() as root:
        path = create_census_record_file(os.path.join(root, "census.rec"),
                                         2 * batch, seed=0)
        with RecordFileScanner(path, 0, 2 * batch) as scanner:
            records = list(scanner)

    def decode(i):
        features, labels = twin.dataset_fn(
            records[i * batch:(i + 1) * batch], Mode.TRAINING, None)
        return {"features": features, "labels": labels,
                "mask": np.ones(batch, np.float32)}

    decode_ms = []
    for _ in range(iters):
        t0 = time.perf_counter()
        decode(0)
        decode_ms.append((time.perf_counter() - t0) * 1e3)
    return (state, build_train_step(twin.loss), [decode(0), decode(1)],
            float(np.median(decode_ms)))


def _transformer(batch, seq, sp=1, remat=False):
    cfg = TransformerConfig(**dict(FLAGSHIP, max_len=max(
        seq, FLAGSHIP["max_len"])), remat=remat,
        compute_dtype=torch.bfloat16)
    mesh = None
    if sp > 1:
        mesh = make_mesh((sp,), ("sp",), [torch.device("cuda:0")] * sp)
    model = TransformerLM(cfg, mesh=mesh)
    model.load_state_dict(bridge.state_dict_from_flax(
        bridge.init_flax_params(cfg, seed=0)))
    if mesh is not None:
        runner = MeshRunner(mesh)
        state = runner.init_state(model, transformer_lm.optimizer(), seed=0)
        step = runner.train_step(transformer_lm.loss)
    else:
        state = init_train_state(model.cuda(), transformer_lm.optimizer(),
                                 seed=0)
        step = build_train_step(transformer_lm.loss)
    return state, step, _token_batches(cfg, batch, seq)


def _recsys(batch):
    from elasticdl_tpu_torch.model_zoo.recsys import recsys_sparse

    torch.manual_seed(0)
    runner = recsys_sparse.make_sparse_runner(use_pallas="always")
    rng = np.random.default_rng(0)
    batches = []
    for _ in range(8):   # fresh ids each step, as a training stream has
        ids = rng.integers(0, recsys_sparse.VOCAB,
                           (batch, recsys_sparse.INPUT_LENGTH))
        batches.append({"features": {recsys_sparse.FEATURE_KEY: ids},
                        "labels": (ids.sum(axis=1) % 2).astype(np.int32),
                        "mask": np.ones(batch, np.float32)})
    state = runner.init_state(recsys_sparse.custom_model(device="cuda"),
                              recsys_sparse.optimizer(), batches[0], seed=0)
    return state, runner.train_step(recsys_sparse.loss), batches


def _pipeline(batch, seq, microbatches):
    from elasticdl_tpu_torch.models.pipeline_lm import PipelineLM

    cfg = TransformerConfig(**dict(FLAGSHIP, max_len=max(
        seq, FLAGSHIP["max_len"])), compute_dtype=torch.bfloat16)
    mesh = make_mesh((2, 2), ("pp", "dp"), [torch.device("cuda:0")] * 4)
    torch.manual_seed(0)
    model = PipelineLM(cfg, mesh, num_microbatches=microbatches,
                       layers_per_stage=cfg.n_layers // 2).cuda()
    train_step = model.make_train_step(transformer_lm.loss,
                                       transformer_lm.optimizer())
    return None, lambda state, b: train_step(b), _token_batches(
        cfg, batch, seq)


def _token_batches(cfg, batch, seq):
    rng = np.random.default_rng(0)
    batches = []
    for _ in range(2):
        tokens = rng.integers(0, cfg.vocab_size,
                              (batch, seq + 1)).astype(np.int32)
        batches.append({"features": tokens[:, :-1],
                        "labels": tokens[:, 1:],
                        "mask": np.ones(batch, np.float32)})
    return batches


def main(argv=None) -> int:
    parser = argparse.ArgumentParser("profile_training")
    parser.add_argument("--model",
                        choices=("transformer", "recsys", "resnet50",
                                 "census", "pipeline"),
                        default="transformer")
    parser.add_argument("--batch", type=int, default=None,
                        help="8 (transformer), 16 (pipeline), 512 "
                             "(recsys, census) or 128 (resnet50)")
    parser.add_argument("--microbatches", type=int, default=4,
                        help="pipeline: microbatches a step")
    parser.add_argument("--seq", type=int, default=1024)
    parser.add_argument("--iters", type=int, default=5)
    parser.add_argument("--top", type=int, default=16)
    parser.add_argument("--sp", type=int, default=1,
                        help="transformer: ring attention over an sp mesh "
                             "of this many entries of the card")
    parser.add_argument("--remat", action="store_true",
                        help="transformer: recompute each block in the "
                             "backward")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_training needs a CUDA device")
    extra = {}
    if args.model == "census":
        args.batch = args.batch or 512
        state, step, batches, decode_ms = _census(args.batch, args.iters)
        shape = [args.batch, 4]
        extra["dataset_fn_ms"] = decode_ms
    elif args.model == "recsys":
        args.batch = args.batch or 512
        state, step, batches = _recsys(args.batch)
        shape = [args.batch, 32]
    elif args.model == "resnet50":
        args.batch = args.batch or 128
        state, step, batches = _resnet50(args.batch)
        shape = [args.batch, 224, 224, 3]
    elif args.model == "pipeline":
        args.batch = args.batch or 16
        state, step, batches = _pipeline(args.batch, args.seq,
                                         args.microbatches)
        shape = [args.batch, args.seq]
        extra["microbatches"] = args.microbatches
    else:
        args.batch = args.batch or 8
        state, step, batches = _transformer(args.batch, args.seq, args.sp,
                                            args.remat)
        shape = [args.batch, args.seq]

    def run(n):
        for i in range(n):
            step(state, batches[i % len(batches)])

    run(3)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    run(args.iters)
    end.record()
    issue_ms = (time.perf_counter() - t0) * 1e3 / args.iters
    torch.cuda.synchronize()
    step_ms = start.elapsed_time(end) / args.iters

    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        run(args.iters)
        torch.cuda.synchronize()

    kernels, families = {}, {}
    intervals = []
    for evt in prof.events():
        if (evt.device_type != torch.autograd.DeviceType.CUDA
                or getattr(evt, "is_user_annotation", False)):
            continue
        span = (evt.time_range.start, evt.time_range.end)
        intervals.append(span)
        kernels[evt.name] = kernels.get(evt.name, 0.0) + span[1] - span[0]
        label = family(evt.name)
        families[label] = families.get(label, 0.0) + span[1] - span[0]
    busy_us = _union_us(intervals)
    ranked = sorted(kernels.items(), key=lambda kv: -kv[1])
    attention = {}
    for name, us in kernels.items():
        for stem, label in ATTENTION_KERNELS.items():
            if stem in name:
                attention[label] = attention.get(label, 0.0) + us
    print(json.dumps({
        "device": torch.cuda.get_device_name(0),
        "model": args.model, "shape": shape, "sp": args.sp,
        "remat": args.remat, "step_ms": step_ms,
        "issue_ms": issue_ms,
        "device_events_per_step": len(intervals) / args.iters,
        "device_ms_per_step": busy_us / args.iters / 1e3,
        "device_share_of_step": busy_us / args.iters / 1e3 / step_ms,
        "kernels_ms_per_step": [
            {"name": name[:120], "ms": us / args.iters / 1e3,
             "share": us / busy_us if busy_us else None}
            for name, us in ranked[:args.top]
        ],
        "families_ms_per_step": {
            label: us / args.iters / 1e3
            for label, us in sorted(families.items(), key=lambda kv: -kv[1])},
        "attention_kernels_ms_per_step": {
            label: us / args.iters / 1e3
            for label, us in sorted(attention.items())},
        **extra,
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
