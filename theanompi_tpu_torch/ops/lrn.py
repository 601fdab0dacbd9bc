"""Cross-channel LRN (local response normalization) over NHWC rows.

Counterpart of ``theanompi_tpu/ops/lrn.py``.  Math (β defaults to AlexNet's
0.75; the band window covers channels ``c-n//2 .. c+n//2``, truncated at the
edges):

    d = k + (α/n)·BandSum(x²)         s = d^(−β)         y = x·s
    t = dy·x·s/d
    dx = s·dy − 2·(α/n)·β · x · BandSum(t)

Two implementations of the same function:

* :func:`lrn_plain` — the JAX package's ``lrn_jnp`` in torch ops (f32 math,
  band sum as a product with the 0/1 band matrix), autograd supplying its
  backward.  It is what a CPU tensor runs, and what ``chip_smoke.py`` and the
  card tests hold the kernels against.  :func:`lrn_bwd_plain` writes that
  backward out in closed form with B2's division-free ``t``.
* :func:`lrn_fwd_cuda` / :func:`lrn_bwd_cuda` — the hand-written Hopper
  kernels B1/B2 of ``csrc/lrn.cu``, joined by :class:`LRNFunction`, whose
  only residual is ``x``.

:func:`lrn` chooses by the tensor's device alone: CPU → plain, CUDA → the
kernels (or an error), anything else → an error.  Nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _kernel_build

MAX_CHANNELS = 2048        # one pixel row must fit the kernels' tiles
MAX_HALF = 4               # the kernels unroll windows of n//2 = 0..4


@functools.lru_cache(maxsize=None)
def _band(c: int, n: int) -> torch.Tensor:
    """The C×C 0/1 band matrix of ``_band_np``: column i sums channels
    ``max(0, i-n//2) .. i+n//2``."""
    half = n // 2
    band = torch.zeros((c, c), dtype=torch.float32)
    for i in range(c):
        band[max(0, i - half):i + half + 1, i] = 1.0
    return band


def _scale_of(d: torch.Tensor, beta: float) -> torch.Tensor:
    """d^(−β); the rsqrt composition for β = 0.75, as the JAX package."""
    if beta == 0.75:
        inv = torch.rsqrt(d)
        return inv * torch.sqrt(inv)
    return torch.exp(-beta * torch.log(d))


def lrn_plain(x: torch.Tensor, n: int = 5, k: float = 2.0,
              alpha: float = 1e-4, beta: float = 0.75) -> torch.Tensor:
    """Reference formula in torch ops on any device (f32 math, output in
    ``x``'s dtype); autograd provides the gradient."""
    xf = x.float()
    band = _band(x.shape[-1], n).to(x.device)
    d = k + (alpha / n) * torch.matmul(xf * xf, band)
    return (xf * _scale_of(d, beta)).to(x.dtype)


def lrn_bwd_plain(x: torch.Tensor, dy: torch.Tensor, n: int = 5,
                  k: float = 2.0, alpha: float = 1e-4,
                  beta: float = 0.75) -> torch.Tensor:
    """The input gradient of :func:`lrn_plain` in closed form, as B2
    computes it (f32 math, output in ``x``'s dtype): ``t = dy·x·s/d`` with
    ``s/d = s·inv²`` (``inv = d^(−1/2)``) for β = 0.75 and ``s·(1/d)``
    otherwise.  The band matrix is symmetric, so ``BandSum(t)`` is
    ``t @ band``."""
    xf, g = x.float(), dy.float()
    band = _band(x.shape[-1], n).to(x.device)
    d = k + (alpha / n) * torch.matmul(xf * xf, band)
    if beta == 0.75:
        inv = torch.rsqrt(d)
        s = inv * torch.sqrt(inv)
        s_over_d = s * (inv * inv)
    else:
        s = torch.exp(-beta * torch.log(d))
        s_over_d = s * torch.reciprocal(d)
    t = g * xf * s_over_d
    dx = s * g - (2.0 * (alpha / n) * beta) * xf * torch.matmul(t, band)
    return dx.to(x.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _kernel_build.load("lrn")
    p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
        ctypes.c_longlong
    lib.lrn_fwd.argtypes = [p, p, ll, i, i, i, f, f, f, i, p]
    lib.lrn_fwd.restype = ctypes.c_int
    lib.lrn_bwd.argtypes = [p, p, p, ll, i, i, i, f, f, f, f, i, p]
    lib.lrn_bwd.restype = ctypes.c_int
    return lib


def _check(name: str, *ts: torch.Tensor) -> None:
    x = ts[0]
    for t in ts:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: tensor on {t.device}, the kernel "
                             f"takes CUDA tensors (lrn_plain is the CPU path)")
        if t.dtype not in _DTYPES:
            raise TypeError(f"{name}: dtype {t.dtype}; the kernel takes "
                            f"float32 or bfloat16")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensor of strides {t.stride()} is not "
                             f"contiguous; channel rows must be")
        if t.shape != x.shape or t.dtype != x.dtype or t.device != x.device:
            raise ValueError(f"{name}: tensors differ in shape, dtype or "
                             f"device: {[(u.shape, u.dtype, u.device) for u in ts]}")
    if x.dim() == 0 or not 0 < x.shape[-1] <= MAX_CHANNELS:
        raise ValueError(f"{name}: last dim of {tuple(x.shape)} must be the "
                         f"channel count C, 1 ≤ C ≤ {MAX_CHANNELS}")


def _check_n(name: str, n: int) -> None:
    if not 0 <= n // 2 <= MAX_HALF:
        raise ValueError(f"{name}: window n={n}; the kernel takes n//2 in "
                         f"0..{MAX_HALF}")


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


def lrn_fwd_cuda(x: torch.Tensor, n: int = 5, k: float = 2.0,
                 alpha: float = 1e-4, beta: float = 0.75) -> torch.Tensor:
    """Kernel B1: LRN forward of a contiguous CUDA tensor ``[..., C]``."""
    _check("lrn_fwd_cuda", x)
    _check_n("lrn_fwd_cuda", n)
    c = x.shape[-1]
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _lib().lrn_fwd(x.data_ptr(), y.data_ptr(), x.numel() // c, c,
                            _DTYPES[x.dtype], n // 2, float(k),
                            float(alpha / n), float(beta),
                            int(beta == 0.75), stream)
    _raise_on(rc, "lrn_fwd_cuda")
    lrn_fwd_cuda.launches += 1
    return y


def lrn_bwd_cuda(x: torch.Tensor, dy: torch.Tensor, n: int = 5,
                 k: float = 2.0, alpha: float = 1e-4,
                 beta: float = 0.75) -> torch.Tensor:
    """Kernel B2: LRN input gradient from ``x`` and ``dy`` alone."""
    _check("lrn_bwd_cuda", x, dy)
    _check_n("lrn_bwd_cuda", n)
    c = x.shape[-1]
    dx = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _lib().lrn_bwd(x.data_ptr(), dy.data_ptr(), dx.data_ptr(),
                            x.numel() // c, c, _DTYPES[x.dtype], n // 2,
                            float(k), float(alpha / n),
                            float(2.0 * (alpha / n) * beta), float(beta),
                            int(beta == 0.75), stream)
    _raise_on(rc, "lrn_bwd_cuda")
    lrn_bwd_cuda.launches += 1
    return dx


# launch counts: each wrapper adds one where it launches its kernel
lrn_fwd_cuda.launches = 0
lrn_bwd_cuda.launches = 0

KERNELS = (lrn_fwd_cuda, lrn_bwd_cuda)

#: each kernel wrapper's plain version (the CPU path, and what the card's
#: output is held to)
CUDA_PLAINS = {"lrn_fwd_cuda": "lrn_plain", "lrn_bwd_cuda": "lrn_bwd_plain"}


class LRNFunction(torch.autograd.Function):
    """B1 forward, B2 backward; saves ``x`` only."""

    @staticmethod
    def forward(ctx, x, n, k, alpha, beta):
        ctx.save_for_backward(x)
        ctx.hyper = (n, k, alpha, beta)
        return lrn_fwd_cuda(x, n, k, alpha, beta)

    @staticmethod
    def backward(ctx, dy):
        (x,) = ctx.saved_tensors
        # autograd may hand a strided gradient (e.g. through a permute);
        # the kernel takes contiguous rows, made so here explicitly
        return (lrn_bwd_cuda(x, dy.contiguous(), *ctx.hyper),
                None, None, None, None)


def lrn(x: torch.Tensor, n: int = 5, k: float = 2.0, alpha: float = 1e-4,
        beta: float = 0.75) -> torch.Tensor:
    """Cross-channel LRN over NHWC: the kernels for a CUDA tensor, the plain
    version for a CPU tensor."""
    if x.device.type == "cuda":
        return LRNFunction.apply(x, n, float(k), float(alpha), float(beta))
    if x.device.type == "cpu":
        return lrn_plain(x, n, k, alpha, beta)
    raise ValueError(f"lrn: no implementation for device {x.device}")
