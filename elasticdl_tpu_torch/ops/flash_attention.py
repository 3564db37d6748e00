"""Flash attention on the H100: hand-written CUDA forward and backward.

Port of elasticdl_tpu/ops/flash_attention.py:

- forward: ``flash_attention`` → ``_flash_forward`` → ``_fwd_kernel``,
  here ``flash_forward`` over ``csrc/flash_attention_fwd.cu``;
- backward: ``_flash_bwd`` → ``flash_chunk_grads`` → ``_dq_kernel`` and
  ``_dkv_kernel``, here ``flash_chunk_grads`` over the two kernels of
  ``csrc/flash_attention_bwd.cu``.

The kernels are built by ``_build`` at first use and called through
``ctypes``. Beside each wrapper is the plain PyTorch version with the
same contract (``flash_forward_reference``,
``flash_chunk_grads_reference``: materialized f32 scores). A wrapper
takes the plain version for a tensor on the CPU and launches its kernel
for a CUDA tensor, or raises: there is no fallback from one to the
other.

Numerics follow the TPU kernels: products take the input dtype with f32
accumulation, the scale is applied in f32 after the product, softmax
state is f32; p is cast to v's dtype before PV (forward) and to dO's
before PᵀdO, ds to k's dtype before dS·K and to q's before dSᵀ·Q
(backward).
"""

import ctypes
from typing import Optional, Tuple

import torch

_NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128)   # the kernel's template instances
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_SOURCE = "flash_attention_fwd.cu"
_BWD_SOURCE = "flash_attention_bwd.cu"

# Kernel launches since the last reset: ``launches`` counts the forward
# (one per transformer layer per forward), ``dq_launches`` and
# ``dkv_launches`` the two backward kernels (one each per layer per
# backward).
launches = 0
dq_launches = 0
dkv_launches = 0


def supports(q_shape, dtype=torch.bfloat16) -> bool:
    """Static gate over a (B, S, H, D) query: the shapes and dtypes the
    kernel takes (any S: a ragged last tile is masked in the kernel).
    Independent of the device, so the CPU takes the same path as the
    card."""
    s_len, d = q_shape[1], q_shape[-1]
    return s_len > 0 and d in HEAD_DIMS and dtype in _DTYPE_CODES


def flash_forward_reference(q, k, v, causal: bool = True,
                            scale: Optional[float] = None):
    """Plain version: q, k, v (BH, S, D) → (o (BH, S, D) in q's dtype,
    lse (BH, S) f32), with the whole score matrix in f32."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = torch.matmul(q.float(), k.float().transpose(1, 2)) * scale
    if causal:
        s_len = q.shape[1]
        mask = torch.ones(s_len, s_len, dtype=torch.bool,
                          device=q.device).tril()
        s = s.masked_fill(~mask, _NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    if causal:
        p = p.masked_fill(~mask, 0.0)
    l_safe = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.matmul(p.to(v.dtype).float(), v.float()) / l_safe
    return o.to(q.dtype), (m + torch.log(l_safe)).squeeze(-1)


def _check(q, k, v):
    if not (q.device == k.device == v.device):
        raise ValueError("flash_forward: q, k, v on different devices")
    if q.dtype not in _DTYPE_CODES or not (q.dtype == k.dtype == v.dtype):
        raise ValueError(
            f"flash_forward: dtypes {q.dtype}/{k.dtype}/{v.dtype}; the "
            "kernel takes matching bfloat16 or float32"
        )
    if q.dim() != 3 or not (q.shape == k.shape == v.shape):
        raise ValueError(
            f"flash_forward: shapes {tuple(q.shape)}/{tuple(k.shape)}/"
            f"{tuple(v.shape)}; the kernel takes equal (BH, S, D)"
        )
    bh, s_len, d = q.shape
    if d not in HEAD_DIMS or s_len == 0 or bh > 65535:
        raise ValueError(
            f"flash_forward: (BH, S, D) = {tuple(q.shape)}; the kernel "
            f"takes D in {HEAD_DIMS}, S >= 1, BH <= 65535 (gate callers "
            "with supports())"
        )
    if not (q.is_contiguous() and k.is_contiguous()
            and v.is_contiguous()):
        raise ValueError("flash_forward: q, k, v must be contiguous")


def _library():
    from elasticdl_tpu_torch.ops import _build

    lib = _build.load(_SOURCE)
    fn = lib.edl_flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        lib.edl_cuda_error_string.argtypes = [ctypes.c_int]
        lib.edl_cuda_error_string.restype = ctypes.c_char_p
    return lib


def flash_forward_cuda(q, k, v, causal: bool, scale: float):
    """Launch the CUDA kernel on q's current stream; returns (o, lse)."""
    global launches
    _check(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"flash_forward_cuda: tensors on {q.device}")
    lib = _library()
    bh, s_len, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((bh, s_len), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.edl_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), bh, s_len, d, _DTYPE_CODES[q.dtype],
            float(scale), int(bool(causal)), stream,
        )
    if err != 0:
        raise RuntimeError(
            "flash attention kernel launch failed: CUDA error "
            f"{err} ({lib.edl_cuda_error_string(err).decode()})"
        )
    launches += 1
    return o, lse


def flash_forward(q, k, v, causal: bool = True,
                  scale: Optional[float] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q, k, v (BH, S, D) → (o, lse). A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel or raises."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        _check(q, k, v)
        return flash_forward_reference(q, k, v, causal, scale)
    return flash_forward_cuda(q, k, v, causal, scale)


def flash_chunk_grads_reference(q, k, v, do, lse, delta, q_offset: int = 0,
                                k_offset: int = 0, causal: bool = True,
                                scale: Optional[float] = None):
    """Plain version of ``flash_chunk_grads``: the whole (Sq, Sk) score
    matrix in f32. Returns (dq, dk, dv), f32."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = torch.matmul(q.float(), k.float().transpose(1, 2)) * scale
    p = torch.exp(s - lse)
    if causal:
        qpos = q_offset + torch.arange(q.shape[1], device=q.device)
        kpos = k_offset + torch.arange(k.shape[1], device=q.device)
        p = torch.where(qpos[:, None] >= kpos[None, :], p, 0.0)
    dp = torch.matmul(do.float(), v.float().transpose(1, 2))
    ds = p * (dp - delta)
    dq = torch.matmul(ds.to(k.dtype).float(), k.float()) * scale
    dk = torch.matmul(ds.to(q.dtype).float().transpose(1, 2),
                      q.float()) * scale
    dv = torch.matmul(p.to(do.dtype).float().transpose(1, 2), do.float())
    return dq, dk, dv


def _check_grads(q, k, v, do, lse, delta):
    tensors = (q, k, v, do, lse, delta)
    if len({t.device for t in tensors}) != 1:
        raise ValueError("flash_chunk_grads: inputs on different devices")
    if q.dtype not in _DTYPE_CODES or not (
            q.dtype == k.dtype == v.dtype == do.dtype):
        raise ValueError(
            f"flash_chunk_grads: dtypes {q.dtype}/{k.dtype}/{v.dtype}/"
            f"{do.dtype}; the kernels take matching bfloat16 or float32"
        )
    if lse.dtype != torch.float32 or delta.dtype != torch.float32:
        raise ValueError("flash_chunk_grads: lse and delta must be float32")
    if q.dim() != 3 or k.dim() != 3:
        raise ValueError("flash_chunk_grads: q, k must be (BH, S, D)")
    bh, sq, d = q.shape
    sk = k.shape[1]
    if not (do.shape == q.shape and v.shape == k.shape
            and k.shape[0] == bh and k.shape[2] == d
            and lse.shape == delta.shape == (bh, sq, 1)):
        raise ValueError(
            f"flash_chunk_grads: shapes q {tuple(q.shape)}, k "
            f"{tuple(k.shape)}, v {tuple(v.shape)}, do {tuple(do.shape)}, "
            f"lse {tuple(lse.shape)}, delta {tuple(delta.shape)}; the "
            "kernels take q/do (BH, Sq, D), k/v (BH, Sk, D), lse/delta "
            "(BH, Sq, 1)"
        )
    if d not in HEAD_DIMS or sq == 0 or sk == 0 or bh > 65535:
        raise ValueError(
            f"flash_chunk_grads: (BH, Sq, Sk, D) = {(bh, sq, sk, d)}; the "
            f"kernels take D in {HEAD_DIMS}, Sq, Sk >= 1, BH <= 65535"
        )
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("flash_chunk_grads: inputs must be contiguous")


def _bwd_library():
    from elasticdl_tpu_torch.ops import _build

    lib = _build.load(_BWD_SOURCE)
    if lib.edl_flash_attention_bwd_dq.argtypes is None:
        tail = [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_int,
                                     ctypes.c_void_p]
        lib.edl_flash_attention_bwd_dq.argtypes = (
            [ctypes.c_void_p] * 7 + tail)
        lib.edl_flash_attention_bwd_dkv.argtypes = (
            [ctypes.c_void_p] * 8 + tail)
        for fn in (lib.edl_flash_attention_bwd_dq,
                   lib.edl_flash_attention_bwd_dkv):
            fn.restype = ctypes.c_int
        lib.edl_cuda_error_string.argtypes = [ctypes.c_int]
        lib.edl_cuda_error_string.restype = ctypes.c_char_p
    return lib


def flash_chunk_grads_cuda(q, k, v, do, lse, delta, q_offset: int,
                           k_offset: int, causal: bool, scale: float):
    """Launch the dq and the dk/dv kernels on q's current stream;
    returns (dq, dk, dv), f32."""
    global dq_launches, dkv_launches
    _check_grads(q, k, v, do, lse, delta)
    if q.device.type != "cuda":
        raise ValueError(f"flash_chunk_grads_cuda: tensors on {q.device}")
    lib = _bwd_library()
    bh, sq, d = q.shape
    sk = k.shape[1]
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.empty(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.empty(k.shape, dtype=torch.float32, device=q.device)
    inputs = [t.data_ptr() for t in (q, k, v, do, lse, delta)]
    tail = (bh, sq, sk, d, _DTYPE_CODES[q.dtype], int(q_offset),
            int(k_offset), float(scale), int(bool(causal)))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        for name, outputs in (("dq", (dq,)), ("dkv", (dk, dv))):
            fn = getattr(lib, f"edl_flash_attention_bwd_{name}")
            err = fn(*inputs, *(t.data_ptr() for t in outputs), *tail,
                     stream)
            if err != 0:
                raise RuntimeError(
                    f"flash attention {name} kernel launch failed: CUDA "
                    f"error {err} ({lib.edl_cuda_error_string(err).decode()})"
                )
            if name == "dq":
                dq_launches += 1
            else:
                dkv_launches += 1
    return dq, dk, dv


def flash_chunk_grads(q, k, v, do, lse, delta, q_offset: int = 0,
                      k_offset: int = 0, causal: bool = True,
                      scale: Optional[float] = None):
    """Backward of one attention chunk pairing.

    q/do: (BH, Sq, D); k/v: (BH, Sk, D); lse/delta: (BH, Sq, 1) f32;
    q_offset/k_offset: global positions of q[:, 0] and k[:, 0] (causal
    keeps q_offset + i >= k_offset + j). Returns (dq, dk, dv) in f32. A
    CPU tensor takes the plain version; a CUDA tensor launches both
    kernels or raises."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        _check_grads(q, k, v, do, lse, delta)
        return flash_chunk_grads_reference(q, k, v, do, lse, delta,
                                           q_offset, k_offset, causal,
                                           scale)
    return flash_chunk_grads_cuda(q, k, v, do, lse, delta, q_offset,
                                  k_offset, causal, scale)


class _Flash(torch.autograd.Function):
    """Forward kernel with the backward of ``_flash_bwd``: the forward
    saves q, k, v, o and lse (nothing when no input needs a gradient,
    as under ``torch.inference_mode``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        o, lse = flash_forward(q, k, v, causal, scale)
        if any(ctx.needs_input_grad[:3]):
            ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, grad):
        q, k, v, o, lse = ctx.saved_tensors
        do = grad.contiguous()
        # delta = rowsum(dO o O) in f32, outside the kernels (as the JAX
        # package computes it outside Pallas).
        delta = (do.float() * o.float()).sum(dim=-1, keepdim=True)
        dq, dk, dv = flash_chunk_grads(q, k, v, do, lse.unsqueeze(-1),
                                       delta, 0, 0, ctx.causal, ctx.scale)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None


def flash_attention(q, k, v, causal: bool = True,
                    scale: Optional[float] = None):
    """Fused attention. q, k, v: (B, S, H, D); returns (B, S, H, D)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    b, s_len, h, d = q.shape

    def to_bh(x):
        return x.transpose(1, 2).reshape(b * h, s_len, d).contiguous()

    o = _Flash.apply(to_bh(q), to_bh(k), to_bh(v), causal, float(scale))
    return o.reshape(b, h, s_len, d).transpose(1, 2)
