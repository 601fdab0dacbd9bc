"""Flash attention over ``[B, H, T, hd]``, the JAX package's layout.

Counterpart of the TPU kernel ``theanompi_tpu/models/layers.py`` calls for
``attn_impl='flash'`` (JAX's packaged ``pallas.ops.tpu.flash_attention``).
Math, with ``s = q kᵀ · scale`` plus the additive mask ``MASK_VALUE`` above
the diagonal when causal (the TPU kernel's ``DEFAULT_MASK_VALUE``):

    forward   o = softmax(s) v,  lse = m + log l  (per row; p rounded to
              the input type before the p v product, as the TPU kernel)
    backward  p = exp(s − lse),  di = Σ o·dO (per row)
              dV = pᵀ dO,  dP = dO vᵀ,  dS = p (dP − di) · scale,
              dK = dSᵀ q,  dQ = dS k

Two implementations of the same function:

* :func:`flash_fwd_plain` / :func:`flash_bwd_plain` — the formula in torch
  ops on whole ``[T, T]`` score matrices (f32 math, outputs in the input
  type).  A CPU tensor runs them; ``chip_smoke.py`` and the card tests hold
  the kernels against them.
* :func:`flash_fwd_cuda` (B10), :func:`flash_bwd_dkv_cuda` (B11) and
  :func:`flash_bwd_dq_cuda` (B12) — the hand-written Hopper kernels of
  ``csrc/flash_attention.cu``: bfloat16, head dim 32, 64 or 128, T a
  multiple of 64; anything else raises.

:class:`FlashAttentionFunction` joins a forward and a backward: the kernels
for a CUDA tensor, the plain versions for a CPU one (``_kernel_build.route``),
with ``q, k, v, o, lse`` as residuals.  :func:`flash_attention` is the public
op.  Nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from . import _kernel_build

MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
TILE = 64                  # the kernels' q and k/v tile rows
HEAD_DIMS = (32, 64, 128)


def _scale(q: torch.Tensor, sm_scale: Optional[float]) -> float:
    return q.shape[-1] ** -0.5 if sm_scale is None else float(sm_scale)


def _scores(q, k, causal: bool, scale: float) -> torch.Tensor:
    """s = q kᵀ · scale in f32, plus MASK_VALUE where a key follows its
    query (causal), added as the TPU kernel adds it."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        t = q.shape[-2]
        above = torch.ones(t, t, dtype=torch.bool, device=q.device).triu(1)
        s = s + torch.where(above, MASK_VALUE, 0.0)
    return s


def attention_di(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """di = Σ_d o·dO per row, f32 ``[B, H, T]`` (outside the kernels, as
    XLA computes it for the TPU kernel)."""
    return (o.float() * do.float()).sum(-1)


def flash_fwd_plain(q, k, v, causal: bool = True,
                    sm_scale: Optional[float] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(o, lse)``: o in q's dtype, lse f32 ``[B, H, T]``."""
    s = _scores(q, k, causal, _scale(q, sm_scale))
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    o = torch.matmul(p.to(v.dtype).float(), v.float()) / l
    return o.to(q.dtype), (m + torch.log(l)).squeeze(-1)


def flash_bwd_plain(q, k, v, o, lse, do, causal: bool = True,
                    sm_scale: Optional[float] = None):
    """``(dq, dk, dv)`` from the forward's ``o`` and ``lse``; p and dS are
    rounded to the input type before their products, as in the kernels."""
    scale = _scale(q, sm_scale)
    p = torch.exp(_scores(q, k, causal, scale) - lse[..., None])
    dof = do.float()
    dv = torch.matmul(p.to(do.dtype).float().transpose(-1, -2), dof)
    dp = torch.matmul(dof, v.float().transpose(-1, -2))
    ds = p * (dp - attention_di(o, do)[..., None]) * scale
    ds = ds.to(q.dtype).float()
    dk = torch.matmul(ds.transpose(-1, -2), q.float())
    dq = torch.matmul(ds, k.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _lib():
    lib = _kernel_build.load("flash_attention")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    strides = ctypes.POINTER(ctypes.c_longlong)
    lib.flash_fwd.argtypes = [p, p, p, p, p, strides, i, i, i, i, f, i, p]
    lib.flash_bwd_dkv.argtypes = [p, p, p, p, p, p, p, p, strides,
                                  i, i, i, i, f, i, p]
    lib.flash_bwd_dq.argtypes = [p, p, p, p, p, p, p, strides,
                                 i, i, i, i, f, i, p]
    for fn in (lib.flash_fwd, lib.flash_bwd_dkv, lib.flash_bwd_dq):
        fn.restype = ctypes.c_int
    return lib


def _check(name: str, *ts: torch.Tensor) -> None:
    """q-shaped bf16 CUDA tensors ``[B, H, T, hd]`` the kernels take."""
    for t in ts:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: tensor on {t.device}, the kernel takes "
                             f"CUDA tensors (flash_*_plain is the CPU path)")
    check_layout(name, *ts)


def check_layout(name: str, *ts: torch.Tensor) -> None:
    """The dtype and shape checks of the kernels (any device)."""
    x = ts[0]
    for t in ts:
        if t.device != x.device:
            raise ValueError(f"{name}: tensors on {x.device} and {t.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name}: dtype {t.dtype}; the kernels take "
                            f"bfloat16 (flash_*_plain computes other types)")
        if t.shape != x.shape:
            raise ValueError(f"{name}: shapes differ: "
                             f"{[tuple(u.shape) for u in ts]}")
    if x.dim() != 4 or x.shape[-1] not in HEAD_DIMS or \
            x.shape[2] % TILE or x.shape[2] == 0:
        raise ValueError(f"{name}: shape {tuple(x.shape)}; the kernels take "
                         f"[B, H, T, hd] with hd in {HEAD_DIMS} and T a "
                         f"positive multiple of {TILE}")


def _strided(t: torch.Tensor) -> torch.Tensor:
    """``t`` if the kernels can read it in place (last dim contiguous, the
    B/H/T strides multiples of 8, 16-byte aligned), else a contiguous
    copy."""
    if t.stride(-1) == 1 and all(s % 8 == 0 for s in t.stride()[:3]) and \
            t.data_ptr() % 16 == 0:
        return t
    return t.contiguous()


def _stat(name: str, t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    if t.dtype != torch.float32 or tuple(t.shape) != tuple(like.shape[:3]) \
            or t.device != like.device:
        raise ValueError(f"{name}: row stats must be float32 {tuple(like.shape[:3])} "
                         f"on {like.device}; got {t.dtype} {tuple(t.shape)} "
                         f"on {t.device}")
    return t.contiguous()


def _strides(*ts: torch.Tensor):
    vals = [s for t in ts for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(vals))(*vals)


def _dims(q: torch.Tensor, sm_scale: Optional[float]):
    b, h, t, d = q.shape
    return b, h, t, d, _scale(q, sm_scale)


def flash_fwd_cuda(q, k, v, causal: bool = True,
                   sm_scale: Optional[float] = None):
    """Kernel B10: ``(o, lse)``; o is laid out like q (a transposed view in,
    a transposed view out)."""
    _check("flash_fwd_cuda", q, k, v)
    q, k, v = _strided(q), _strided(k), _strided(v)
    b, h, t, d, scale = _dims(q, sm_scale)
    o = torch.empty_like(q)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    _kernel_build.launch(
        "flash_fwd_cuda", q.device, _lib().flash_fwd, q.data_ptr(),
        k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        _strides(q, k, v, o), b, h, t, d, scale, int(causal))
    flash_fwd_cuda.launches += 1
    return o, lse


def flash_bwd_dkv_cuda(q, k, v, do, lse, di, causal: bool = True,
                       sm_scale: Optional[float] = None):
    """Kernel B11: ``(dk, dv)`` from q, k, v, dO and the row stats."""
    _check("flash_bwd_dkv_cuda", q, k, v, do)
    lse, di = _stat("flash_bwd_dkv_cuda", lse, q), \
        _stat("flash_bwd_dkv_cuda", di, q)
    q, k, v, do = _strided(q), _strided(k), _strided(v), _strided(do)
    b, h, t, d, scale = _dims(q, sm_scale)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _kernel_build.launch(
        "flash_bwd_dkv_cuda", q.device, _lib().flash_bwd_dkv, q.data_ptr(),
        k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        di.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        _strides(q, k, v, do, dk, dv), b, h, t, d, scale, int(causal))
    flash_bwd_dkv_cuda.launches += 1
    return dk, dv


def flash_bwd_dq_cuda(q, k, v, do, lse, di, causal: bool = True,
                      sm_scale: Optional[float] = None):
    """Kernel B12: dq from q, k, v, dO and the row stats."""
    _check("flash_bwd_dq_cuda", q, k, v, do)
    lse, di = _stat("flash_bwd_dq_cuda", lse, q), \
        _stat("flash_bwd_dq_cuda", di, q)
    q, k, v, do = _strided(q), _strided(k), _strided(v), _strided(do)
    b, h, t, d, scale = _dims(q, sm_scale)
    dq = torch.empty_like(q)
    _kernel_build.launch(
        "flash_bwd_dq_cuda", q.device, _lib().flash_bwd_dq, q.data_ptr(),
        k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        di.data_ptr(), dq.data_ptr(), _strides(q, k, v, do, dq), b, h, t, d,
        scale, int(causal))
    flash_bwd_dq_cuda.launches += 1
    return dq


# launch counts: each wrapper adds one where it launches its kernel
flash_fwd_cuda.launches = 0
flash_bwd_dkv_cuda.launches = 0
flash_bwd_dq_cuda.launches = 0

KERNELS = (flash_fwd_cuda, flash_bwd_dkv_cuda, flash_bwd_dq_cuda)


def _bwd_cuda(q, k, v, o, lse, do, causal, sm_scale):
    di = attention_di(o, do)
    dk, dv = flash_bwd_dkv_cuda(q, k, v, do, lse, di, causal, sm_scale)
    return flash_bwd_dq_cuda(q, k, v, do, lse, di, causal, sm_scale), dk, dv


class FlashAttentionFunction(torch.autograd.Function):
    """B10 forward; di, then B11 and B12 backward (the plain versions on
    the CPU).  Residuals: q, k, v, o and lse."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale):
        fwd = _kernel_build.route("flash_attention", q, flash_fwd_plain,
                                  flash_fwd_cuda)
        o, lse = fwd(q, k, v, causal, sm_scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.hyper = (causal, sm_scale)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        bwd = _kernel_build.route("flash_attention", do, flash_bwd_plain,
                                  _bwd_cuda)
        dq, dk, dv = bwd(q, k, v, o, lse, do, *ctx.hyper)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True,
                    sm_scale: Optional[float] = None) -> torch.Tensor:
    """Softmax attention of ``[B, H, T, hd]`` q, k, v (self-attention: one
    T), differentiable: the kernels B10–B12 for CUDA tensors, the plain
    versions for CPU ones."""
    if not q.shape == k.shape == v.shape:
        raise ValueError(f"flash_attention: q, k, v shapes "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)} differ")
    return FlashAttentionFunction.apply(q, k, v, bool(causal),
                                        None if sm_scale is None
                                        else float(sm_scale))
