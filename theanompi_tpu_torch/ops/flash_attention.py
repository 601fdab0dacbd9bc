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
  ``csrc/flash_attention.cu``, bfloat16 — and their float32 instantiation,
  :func:`flash_fwd_f32_cuda`, :func:`flash_bwd_dkv_f32_cuda` and
  :func:`flash_bwd_dq_f32_cuda` (``csrc/flash_attention_f32.cu``: true
  float32 products, nothing rounded below float32, as the TPU kernel in
  float32).  Head dim 32, 64 or 128, T a multiple of 64; anything else
  raises.

:class:`FlashAttentionFunction` joins a forward and a backward: the kernels
for a CUDA tensor (the instantiation of its dtype), the plain versions for a
CPU one (``_kernel_build.route``), with ``q, k, v, o, lse`` as residuals.
:func:`flash_attention` is the public op.  Nothing falls back.
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
DTYPES = (torch.bfloat16, torch.float32)   # the kernels' instantiations


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
def _lib(dtype: torch.dtype = torch.bfloat16):
    """The library of ``dtype``'s instantiation, its entry points typed
    (``flash_fwd``, ``flash_bwd_dkv``, ``flash_bwd_dq``)."""
    f32 = dtype == torch.float32
    lib = _kernel_build.load("flash_attention_f32" if f32
                             else "flash_attention")
    sfx = "_f32" if f32 else ""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    strides = ctypes.POINTER(ctypes.c_longlong)
    fns = {n: getattr(lib, n + sfx)
           for n in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")}
    fns["flash_fwd"].argtypes = [p, p, p, p, p, strides, i, i, i, i, f, i, p]
    fns["flash_bwd_dkv"].argtypes = [p, p, p, p, p, p, p, p, strides,
                                     i, i, i, i, f, i, p]
    fns["flash_bwd_dq"].argtypes = [p, p, p, p, p, p, p, strides,
                                    i, i, i, i, f, i, p]
    for fn in fns.values():
        fn.restype = ctypes.c_int
    return fns


def _check(name: str, dtype: torch.dtype, *ts: torch.Tensor) -> None:
    """q-shaped CUDA tensors ``[B, H, T, hd]`` of the kernel's ``dtype``."""
    for t in ts:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: tensor on {t.device}, the kernel takes "
                             f"CUDA tensors (flash_*_plain is the CPU path)")
    check_layout(name, *ts)
    if ts[0].dtype != dtype:
        raise TypeError(f"{name}: dtype {ts[0].dtype}; this kernel takes "
                        f"{dtype}")


def check_layout(name: str, *ts: torch.Tensor) -> None:
    """The dtype and shape checks of the kernels (any device): one dtype
    of :data:`DTYPES` for all, one shape."""
    x = ts[0]
    for t in ts:
        if t.device != x.device:
            raise ValueError(f"{name}: tensors on {x.device} and {t.device}")
        if t.dtype not in DTYPES or t.dtype != x.dtype:
            raise TypeError(f"{name}: dtypes {[u.dtype for u in ts]}; the "
                            f"kernels take bfloat16 or float32, one for all "
                            f"(flash_*_plain computes other types)")
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


def _fwd(name, dtype, q, k, v, causal, sm_scale):
    _check(name, dtype, q, k, v)
    q, k, v = _strided(q), _strided(k), _strided(v)
    b, h, t, d, scale = _dims(q, sm_scale)
    o = torch.empty_like(q)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    _kernel_build.launch(
        name, q.device, _lib(dtype)["flash_fwd"], q.data_ptr(),
        k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        _strides(q, k, v, o), b, h, t, d, scale, int(causal))
    return o, lse


def _dkv(name, dtype, q, k, v, do, lse, di, causal, sm_scale):
    _check(name, dtype, q, k, v, do)
    lse, di = _stat(name, lse, q), _stat(name, di, q)
    q, k, v, do = _strided(q), _strided(k), _strided(v), _strided(do)
    b, h, t, d, scale = _dims(q, sm_scale)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _kernel_build.launch(
        name, q.device, _lib(dtype)["flash_bwd_dkv"], q.data_ptr(),
        k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        di.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        _strides(q, k, v, do, dk, dv), b, h, t, d, scale, int(causal))
    return dk, dv


def _dq(name, dtype, q, k, v, do, lse, di, causal, sm_scale):
    _check(name, dtype, q, k, v, do)
    lse, di = _stat(name, lse, q), _stat(name, di, q)
    q, k, v, do = _strided(q), _strided(k), _strided(v), _strided(do)
    b, h, t, d, scale = _dims(q, sm_scale)
    dq = torch.empty_like(q)
    _kernel_build.launch(
        name, q.device, _lib(dtype)["flash_bwd_dq"], q.data_ptr(),
        k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        di.data_ptr(), dq.data_ptr(), _strides(q, k, v, do, dq), b, h, t, d,
        scale, int(causal))
    return dq


def flash_fwd_cuda(q, k, v, causal: bool = True,
                   sm_scale: Optional[float] = None):
    """Kernel B10, bfloat16: ``(o, lse)``; o is laid out like q (a
    transposed view in, a transposed view out)."""
    out = _fwd("flash_fwd_cuda", torch.bfloat16, q, k, v, causal, sm_scale)
    flash_fwd_cuda.launches += 1
    return out


def flash_bwd_dkv_cuda(q, k, v, do, lse, di, causal: bool = True,
                       sm_scale: Optional[float] = None):
    """Kernel B11, bfloat16: ``(dk, dv)`` from q, k, v, dO and the row
    stats."""
    out = _dkv("flash_bwd_dkv_cuda", torch.bfloat16, q, k, v, do, lse, di,
               causal, sm_scale)
    flash_bwd_dkv_cuda.launches += 1
    return out


def flash_bwd_dq_cuda(q, k, v, do, lse, di, causal: bool = True,
                      sm_scale: Optional[float] = None):
    """Kernel B12, bfloat16: dq from q, k, v, dO and the row stats."""
    out = _dq("flash_bwd_dq_cuda", torch.bfloat16, q, k, v, do, lse, di,
              causal, sm_scale)
    flash_bwd_dq_cuda.launches += 1
    return out


def flash_fwd_f32_cuda(q, k, v, causal: bool = True,
                       sm_scale: Optional[float] = None):
    """Kernel B10, float32: ``(o, lse)`` as :func:`flash_fwd_cuda`."""
    out = _fwd("flash_fwd_f32_cuda", torch.float32, q, k, v, causal,
               sm_scale)
    flash_fwd_f32_cuda.launches += 1
    return out


def flash_bwd_dkv_f32_cuda(q, k, v, do, lse, di, causal: bool = True,
                           sm_scale: Optional[float] = None):
    """Kernel B11, float32: ``(dk, dv)`` as :func:`flash_bwd_dkv_cuda`."""
    out = _dkv("flash_bwd_dkv_f32_cuda", torch.float32, q, k, v, do, lse, di,
               causal, sm_scale)
    flash_bwd_dkv_f32_cuda.launches += 1
    return out


def flash_bwd_dq_f32_cuda(q, k, v, do, lse, di, causal: bool = True,
                          sm_scale: Optional[float] = None):
    """Kernel B12, float32: dq as :func:`flash_bwd_dq_cuda`."""
    out = _dq("flash_bwd_dq_f32_cuda", torch.float32, q, k, v, do, lse, di,
              causal, sm_scale)
    flash_bwd_dq_f32_cuda.launches += 1
    return out


# launch counts: each wrapper adds one where it launches its kernel
flash_fwd_cuda.launches = 0
flash_bwd_dkv_cuda.launches = 0
flash_bwd_dq_cuda.launches = 0
flash_fwd_f32_cuda.launches = 0
flash_bwd_dkv_f32_cuda.launches = 0
flash_bwd_dq_f32_cuda.launches = 0

KERNELS = (flash_fwd_cuda, flash_bwd_dkv_cuda, flash_bwd_dq_cuda,
           flash_fwd_f32_cuda, flash_bwd_dkv_f32_cuda, flash_bwd_dq_f32_cuda)
# each dtype's (B10, B11, B12)
BY_DTYPE = {torch.bfloat16: KERNELS[:3], torch.float32: KERNELS[3:]}


def _kernels(t: torch.Tensor):
    """The (B10, B11, B12) wrappers of ``t``'s dtype (the bf16 ones for any
    other dtype: they refuse it, naming the dtypes the kernels take)."""
    return BY_DTYPE.get(t.dtype, BY_DTYPE[torch.bfloat16])


def _fwd_cuda(q, k, v, causal, sm_scale):
    return _kernels(q)[0](q, k, v, causal, sm_scale)


def _bwd_cuda(q, k, v, o, lse, do, causal, sm_scale):
    _, dkv, dq = _kernels(q)
    di = attention_di(o, do)
    dk, dv = dkv(q, k, v, do, lse, di, causal, sm_scale)
    return dq(q, k, v, do, lse, di, causal, sm_scale), dk, dv


class FlashAttentionFunction(torch.autograd.Function):
    """B10 forward; di, then B11 and B12 backward, each the instantiation
    of q's dtype (the plain versions on the CPU).  Residuals: q, k, v, o
    and lse."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale):
        fwd = _kernel_build.route("flash_attention", q, flash_fwd_plain,
                                  _fwd_cuda)
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
    T), differentiable: the kernels B10–B12 (bfloat16 or float32) for CUDA
    tensors, the plain versions for CPU ones."""
    if not q.shape == k.shape == v.shape:
        raise ValueError(f"flash_attention: q, k, v shapes "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)} differ")
    return FlashAttentionFunction.apply(q, k, v, bool(causal),
                                        None if sm_scale is None
                                        else float(sm_scale))
