"""Compression for the onebit and topk exchange wires.

Counterpart of ``theanompi_tpu/ops/compress.py``.  Onebit: the sign pack
and its inverse, the fused error-feedback encode, the residual, and the
decode with a weighted accumulate over workers.  Topk: the chunk-row encode
(k largest |·| per row, bf16 values, int16 offsets, the bf16 rounding
residual written back) and the decode that scatter-adds every worker's
rows into the dense vector.

**Wire layout** (the JAX package's, unchanged): a float32 vector ``c`` of
length ``n`` (``n % PACK_ALIGN == 0``) is viewed as blocks of
``BLOCK_ROWS × LANES`` = 256 × 128.  Within a block, bit ``b`` of packed
word ``[r, l]`` (``r < 8``) is the sign bit of row ``8b + r``, lane ``l``:
``1`` where ``c >= 0`` (``+0.0`` and ``-0.0`` alike), ``0`` where ``c < 0``
or NaN.  The packed shape is ``[n // 4096, 128]``, n/8 bytes.

**Words are ``torch.int32``** holding the uint32 words' bits (two's
complement): PyTorch has no ``<<`` for uint32 on the CPU, and gloo's
collectives refuse uint32.  ``.numpy().view(np.uint32)`` reads them as the
JAX package's words.

Each function has two implementations:

* ``*_plain`` — the JAX package's jnp oracles in torch ops, line for line
  (words computed in int64, stored as int32).  What a CPU tensor runs, and
  what ``chip_smoke.py`` and the card tests hold the kernels against.
* ``*_cuda`` — the hand-written Hopper kernels of ``csrc/compress.cu``:
  B3 :func:`pack_signs_cuda`, B4 :func:`unpack_signs_wsum_cuda`,
  B5 :func:`pack_signs_encode_cuda`, B6 :func:`signed_residual_cuda`,
  B7 :func:`topk_encode_cuda`, B8 :func:`topk_decode_cuda`.
  Each counts its launches in ``.launches``.

The public functions (the JAX names) choose by the tensors' device alone:
CPU → plain, CUDA → the kernel (or an error), anything else → an error.
Nothing falls back.  Scales stay tensors on the device: no wrapper reads a
value back to the host.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _kernel_build
from ._kernel_build import launch as _launch
from ._kernel_build import on_card as _on_card
from ._kernel_build import route as _route

BLOCK_ROWS = 256
LANES = 128
PACK_ALIGN = BLOCK_ROWS * LANES          # 32768 elements per block
_WORDS_PER_BLOCK = 8                     # packed rows per block
TOPK_MAX_CHUNK = 1 << 15                 # int16 offsets: 0 .. 32767


def _check_flat(name: str, *ts: torch.Tensor) -> int:
    """1-D float32 vectors of one length, a multiple of PACK_ALIGN."""
    n = ts[0].shape[0] if ts[0].dim() == 1 else -1
    for t in ts:
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: dtype {t.dtype}; takes float32")
        if t.dim() != 1 or t.shape[0] != n:
            raise ValueError(f"{name}: takes 1-D vectors of one length, got "
                             f"{[tuple(u.shape) for u in ts]}")
    if n % PACK_ALIGN:
        raise ValueError(f"{name}: length {n} is not a multiple of "
                         f"{PACK_ALIGN} (flatten_tree(pad_to_multiple_of="
                         f"PACK_ALIGN) upstream)")
    return n


def _check_words(name: str, packed: torch.Tensor, rank: int) -> None:
    """int32 words of ``rank`` dims ending in [m, LANES], m % 8 == 0."""
    if packed.dtype != torch.int32:
        raise TypeError(f"{name}: packed words of dtype {packed.dtype}; "
                        f"takes int32")
    if packed.dim() != rank or packed.shape[-1] != LANES or \
            packed.shape[-2] % _WORDS_PER_BLOCK:
        raise ValueError(f"{name}: packed shape {tuple(packed.shape)}; takes "
                         f"{'[W, ' if rank == 3 else '['}m, {LANES}] with "
                         f"m % {_WORDS_PER_BLOCK} == 0")


def _out_vec(name: str, out, n: int, device):
    """``out`` checked to be a contiguous float32 vector of ``n`` elements
    on ``device`` (a decode's slice of a longer mean), or None."""
    if out is not None and (out.dtype != torch.float32 or out.dim() != 1
                            or out.shape[0] != n or out.device != device
                            or not out.is_contiguous()):
        raise ValueError(f"{name}: out {tuple(out.shape)} {out.dtype} on "
                         f"{out.device}; takes a contiguous float32 [{n}] on "
                         f"{device}")
    return out


# ---------------------------------------------------------------------------
# plain versions (the jnp oracles in torch ops)
# ---------------------------------------------------------------------------

def _shifts(device) -> torch.Tensor:
    return torch.arange(32, dtype=torch.int64, device=device).reshape(
        1, 32, 1, 1)


def pack_signs_plain(c: torch.Tensor) -> torch.Tensor:
    """f32 [n] → int32 [n // 4096, 128] in the wire layout
    (``pack_signs_jnp``)."""
    n = _check_flat("pack_signs_plain", c)
    nb = n // PACK_ALIGN
    bits = (c >= 0).to(torch.int64).reshape(nb, 32, _WORDS_PER_BLOCK, LANES)
    # bit positions are disjoint across the reduced axis, so sum == OR
    words = torch.sum(bits << _shifts(c.device), dim=1)
    words = torch.where(words >= 2 ** 31, words - 2 ** 32, words)
    return words.to(torch.int32).reshape(nb * _WORDS_PER_BLOCK, LANES)


def unpack_signs_plain(packed: torch.Tensor) -> torch.Tensor:
    """int32 [m, 128] → f32 [32·m·128] of ±1 (``unpack_signs_jnp``)."""
    _check_words("unpack_signs_plain", packed, 2)
    nb = packed.shape[0] // _WORDS_PER_BLOCK
    p = packed.to(torch.int64).reshape(nb, 1, _WORDS_PER_BLOCK, LANES)
    bits = (p >> _shifts(packed.device)) & 1
    return (bits.to(torch.float32) * 2.0 - 1.0).reshape(-1)


def unpack_signs_weighted_sum_plain(all_packed: torch.Tensor,
                                    scales: torch.Tensor,
                                    out=None) -> torch.Tensor:
    """[W, m, 128] words, f32 [W] scales → Σ_w scales[w]·signs[w]
    (``unpack_signs_weighted_sum_jnp``); into ``out`` when given."""
    _check_words("unpack_signs_weighted_sum_plain", all_packed, 3)
    w, m, _ = all_packed.shape
    out = _out_vec("unpack_signs_weighted_sum_plain", out, 32 * m * LANES,
                   all_packed.device)
    decoded = torch.stack([unpack_signs_plain(p) for p in all_packed])
    res = torch.sum(decoded * scales.reshape(w, 1), dim=0)
    return res if out is None else out.copy_(res)


def decode_tol(w: int, scales: torch.Tensor):
    """(rtol, atol) of the weighted decode B4 against the plain version at
    ``w`` workers: the kernel's Σ 2·s·bit − Σ s and the plain Σ ±s each
    round ``w`` times, every rounding at most half an ulp of a partial sum
    ≤ Σ 2s: atol 4·w·2⁻²⁴·Σ s, rtol one ulp.  Exactly equal at w = 1."""
    return 2.0 ** -23, 4 * w * 2.0 ** -24 * float(scales.sum())


def pack_signs_encode_plain(flat: torch.Tensor, state: torch.Tensor):
    """``c = flat + state`` → (packed signs of c, |c|)
    (``pack_signs_encode_jnp``)."""
    _check_flat("pack_signs_encode_plain", flat, state)
    c = flat + state
    return pack_signs_plain(c), torch.abs(c)


def signed_residual_plain(absc: torch.Tensor, packed: torch.Tensor,
                          scale: torch.Tensor, out=None) -> torch.Tensor:
    """New error state ``c − scale·sign(c)`` as
    ``where(bit, |c| − scale, scale − |c|)`` (``signed_residual_jnp``; bit
    for bit the unfused formula, c == 0 giving bit 1); into ``out`` when
    given."""
    _check_flat("signed_residual_plain", absc)
    sign_pos = unpack_signs_plain(packed) > 0
    res = torch.where(sign_pos, absc - scale, scale - absc)
    return res if out is None else out.copy_(res)


def _check_topk_rows(name: str, c2: torch.Tensor, k: int) -> None:
    """float32 [rows, chunk], chunk ≤ TOPK_MAX_CHUNK, 1 ≤ k ≤ chunk."""
    if c2.dtype != torch.float32:
        raise TypeError(f"{name}: dtype {c2.dtype}; takes float32")
    if c2.dim() != 2 or not 0 < c2.shape[1] <= TOPK_MAX_CHUNK:
        raise ValueError(f"{name}: takes [rows, chunk] with chunk ≤ "
                         f"{TOPK_MAX_CHUNK} (int16 offsets), got "
                         f"{tuple(c2.shape)}")
    if not 1 <= k <= c2.shape[1]:
        raise ValueError(f"{name}: k = {k} for chunk {c2.shape[1]}")


def _check_topk_wire(name: str, all_vals: torch.Tensor,
                     all_idx: torch.Tensor, chunk: int) -> None:
    """bf16 values and int16 offsets of one shape [W, rows, k]."""
    if all_vals.dtype != torch.bfloat16 or all_idx.dtype != torch.int16:
        raise TypeError(f"{name}: takes bfloat16 values and int16 offsets, "
                        f"got {all_vals.dtype} and {all_idx.dtype}")
    if all_vals.dim() != 3 or all_vals.shape != all_idx.shape:
        raise ValueError(f"{name}: takes values and offsets of one shape "
                         f"[W, rows, k], got {tuple(all_vals.shape)} and "
                         f"{tuple(all_idx.shape)}")
    if not 0 < chunk <= TOPK_MAX_CHUNK or all_vals.shape[2] > chunk:
        raise ValueError(f"{name}: chunk {chunk} for k = "
                         f"{all_vals.shape[2]} (chunk ≤ {TOPK_MAX_CHUNK})")


def topk_encode_plain(c2: torch.Tensor, k: int, out=None):
    """Per chunk row of ``c2`` [rows, chunk]: the k largest |·| as (bf16
    values, int16 offsets), and the new state, ``c2`` with the bf16
    rounding residual written at the selected offsets
    (``topk_encode_jnp``).  Slots are in descending |·|, the lower offset
    first on ties, as ``lax.top_k``: a stable descending sort, since
    ``torch.topk`` promises no order among ties (|−0.0| == |+0.0| is a
    tie)."""
    _check_topk_rows("topk_encode_plain", c2, k)
    idx = torch.sort(c2.abs(), dim=1, descending=True,
                     stable=True).indices[:, :k]
    vals = torch.gather(c2, 1, idx)
    wire_vals = vals.to(torch.bfloat16)
    residual = vals - wire_vals.float()
    state = c2.scatter(1, idx, residual)
    return wire_vals, idx.to(torch.int16), \
        state if out is None else out.copy_(state)


def topk_decode_plain(all_vals: torch.Tensor, all_idx: torch.Tensor,
                      chunk: int, size: int = 1, out=None) -> torch.Tensor:
    """Every worker's rows scatter-added into the dense f32 [rows·chunk],
    worker by worker (a worker's offsets in a row are distinct), then
    divided by ``size`` when it is not 1 (``topk_decode_jnp``: the same
    per-element order of adds, and a division, not a product with
    1/size); into ``out`` when given."""
    _check_topk_wire("topk_decode_plain", all_vals, all_idx, chunk)
    w, rows, k = all_vals.shape
    out = _out_vec("topk_decode_plain", out, rows * chunk, all_vals.device)
    base = (torch.arange(rows, dtype=torch.int64, device=all_vals.device)
            * chunk).reshape(rows, 1)
    dense = torch.zeros(rows * chunk, dtype=torch.float32,
                        device=all_vals.device)
    for i in range(w):
        dense.index_add_(0, (all_idx[i].long() + base).reshape(-1),
                         all_vals[i].float().reshape(-1))
    res = dense / size if size != 1 else dense
    return res if out is None else out.copy_(res)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _lib():
    lib = _kernel_build.load("compress")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.pack_signs.argtypes = [p, p, ll, p]
    lib.pack_signs_encode.argtypes = [p, p, p, p, ll, p]
    lib.signed_residual.argtypes = [p, p, p, p, ll, p]
    lib.unpack_signs_wsum.argtypes = [p, p, p, i, ll, p]
    lib.topk_encode.argtypes = [p, p, p, p, ll, i, i, p]
    lib.topk_decode.argtypes = [p, p, p, i, ll, i, i, i, p]
    for f in (lib.pack_signs, lib.pack_signs_encode, lib.signed_residual,
              lib.unpack_signs_wsum, lib.topk_encode, lib.topk_decode):
        f.restype = ctypes.c_int
    return lib


def _check_scales(name: str, scale: torch.Tensor, count: int) -> None:
    if scale.dtype != torch.float32 or scale.numel() != count:
        raise ValueError(f"{name}: takes {count} float32 scale(s), got "
                         f"{scale.dtype} {tuple(scale.shape)}")


def _out_like(name: str, out, x: torch.Tensor) -> torch.Tensor:
    """``out`` checked to be a contiguous tensor of ``x``'s shape, dtype
    and device that does not share its storage (the kernels read ``x``
    while they write), or a new one."""
    if out is None:
        return torch.empty_like(x)
    if out.shape != x.shape or out.dtype != x.dtype or \
            out.device != x.device or not out.is_contiguous():
        raise ValueError(f"{name}: out {tuple(out.shape)} {out.dtype} on "
                         f"{out.device} for {tuple(x.shape)} {x.dtype} on "
                         f"{x.device}")
    if out.untyped_storage().data_ptr() == x.untyped_storage().data_ptr():
        raise ValueError(f"{name}: out shares the input's storage")
    return out


def pack_signs_cuda(c: torch.Tensor) -> torch.Tensor:
    """Kernel B3: sign pack of a CUDA f32 vector."""
    n = _check_flat("pack_signs_cuda", c)
    dev = _on_card("pack_signs_cuda", c)
    words = torch.empty((n // (32 * LANES), LANES), dtype=torch.int32,
                        device=dev)
    _launch("pack_signs_cuda", dev, _lib().pack_signs, c.data_ptr(),
            words.data_ptr(), n)
    pack_signs_cuda.launches += 1
    return words


def pack_signs_encode_cuda(flat: torch.Tensor, state: torch.Tensor):
    """Kernel B5: ``c = flat + state`` → (packed signs of c, |c|), c kept in
    registers."""
    n = _check_flat("pack_signs_encode_cuda", flat, state)
    dev = _on_card("pack_signs_encode_cuda", flat, state)
    words = torch.empty((n // (32 * LANES), LANES), dtype=torch.int32,
                        device=dev)
    absc = torch.empty_like(flat)
    _launch("pack_signs_encode_cuda", dev, _lib().pack_signs_encode,
            flat.data_ptr(), state.data_ptr(), words.data_ptr(),
            absc.data_ptr(), n)
    pack_signs_encode_cuda.launches += 1
    return words, absc


def signed_residual_cuda(absc: torch.Tensor, packed: torch.Tensor,
                         scale: torch.Tensor, out=None) -> torch.Tensor:
    """Kernel B6: new error state from |c|, the packed bits and the scalar
    scale, read on the device; written into ``out`` (a tensor like
    ``absc`` that is not one of the inputs) when given."""
    n = _check_flat("signed_residual_cuda", absc)
    _check_words("signed_residual_cuda", packed, 2)
    if packed.shape[0] * 32 * LANES != n:
        raise ValueError(f"signed_residual_cuda: {tuple(packed.shape)} words "
                         f"for {n} elements")
    _check_scales("signed_residual_cuda", scale, 1)
    dev = _on_card("signed_residual_cuda", absc, packed, scale)
    out = _out_like("signed_residual_cuda", out, absc)
    _launch("signed_residual_cuda", dev, _lib().signed_residual,
            absc.data_ptr(), packed.data_ptr(), scale.data_ptr(),
            out.data_ptr(), n)
    signed_residual_cuda.launches += 1
    return out


def unpack_signs_wsum_cuda(all_packed: torch.Tensor, scales: torch.Tensor,
                           out=None) -> torch.Tensor:
    """Kernel B4: [W, m, 128] words and f32 [W] scales →
    Σ_w 2·scale_w·bit_w − Σ_w scale_w, f32 [32·m·128]; into ``out`` (a
    contiguous slice of a longer mean: a bucket's) when given."""
    _check_words("unpack_signs_wsum_cuda", all_packed, 3)
    w, m, _ = all_packed.shape
    _check_scales("unpack_signs_wsum_cuda", scales, w)
    dev = _on_card("unpack_signs_wsum_cuda", all_packed, scales)
    out = _out_vec("unpack_signs_wsum_cuda", out, 32 * m * LANES, dev)
    if out is None:
        out = torch.empty(32 * m * LANES, dtype=torch.float32, device=dev)
    _launch("unpack_signs_wsum_cuda", dev, _lib().unpack_signs_wsum,
            all_packed.data_ptr(), scales.data_ptr(), out.data_ptr(), w, m)
    unpack_signs_wsum_cuda.launches += 1
    return out


def topk_encode_cuda(c2: torch.Tensor, k: int, out=None):
    """Kernel B7: per chunk row, a radix select on the bits of |c| over the
    row held in shared memory, the lowest offsets taken on the threshold's
    ties, the winners put in slot order → (bf16 values, int16 offsets, new
    state; into ``out``, a tensor like ``c2`` that is not ``c2``, when
    given).  NaN ranks above +inf, as in the plain version."""
    _check_topk_rows("topk_encode_cuda", c2, k)
    dev = _on_card("topk_encode_cuda", c2)
    rows, chunk = c2.shape
    vals = torch.empty((rows, k), dtype=torch.bfloat16, device=dev)
    idx = torch.empty((rows, k), dtype=torch.int16, device=dev)
    state = _out_like("topk_encode_cuda", out, c2)
    _launch("topk_encode_cuda", dev, _lib().topk_encode, c2.data_ptr(),
            vals.data_ptr(), idx.data_ptr(), state.data_ptr(), rows, chunk, k)
    topk_encode_cuda.launches += 1
    return vals, idx, state


def topk_decode_cuda(all_vals: torch.Tensor, all_idx: torch.Tensor,
                     chunk: int, size: int = 1, out=None) -> torch.Tensor:
    """Kernel B8: each row accumulated in shared memory worker by worker,
    then stored once (÷ size when size ≠ 1); into ``out`` (a contiguous
    slice of a longer mean: a bucket's rows) when given."""
    _check_topk_wire("topk_decode_cuda", all_vals, all_idx, chunk)
    dev = _on_card("topk_decode_cuda", all_vals, all_idx)
    w, rows, k = all_vals.shape
    out = _out_vec("topk_decode_cuda", out, rows * chunk, dev)
    if out is None:
        out = torch.empty(rows * chunk, dtype=torch.float32, device=dev)
    _launch("topk_decode_cuda", dev, _lib().topk_decode, all_vals.data_ptr(),
            all_idx.data_ptr(), out.data_ptr(), w, rows, k, chunk, int(size))
    topk_decode_cuda.launches += 1
    return out


# launch counts: each wrapper adds one where it launches its kernel
pack_signs_cuda.launches = 0
pack_signs_encode_cuda.launches = 0
signed_residual_cuda.launches = 0
unpack_signs_wsum_cuda.launches = 0
topk_encode_cuda.launches = 0
topk_decode_cuda.launches = 0

KERNELS = (pack_signs_cuda, unpack_signs_wsum_cuda, pack_signs_encode_cuda,
           signed_residual_cuda, topk_encode_cuda, topk_decode_cuda)


# ---------------------------------------------------------------------------
# public API: by device
# ---------------------------------------------------------------------------

def pack_signs(c: torch.Tensor) -> torch.Tensor:
    """Sign bits of ``c`` (>= 0 → 1), 32 per int32 word:
    f32 [n] → [n // 4096, 128], n % PACK_ALIGN == 0."""
    return _route("pack_signs", c, pack_signs_plain, pack_signs_cuda)(c)


def unpack_signs_weighted_sum(all_packed: torch.Tensor,
                              scales: torch.Tensor,
                              out=None) -> torch.Tensor:
    """Decode [W, m, 128] packed buffers into Σ_w scales[w]·signs[w],
    f32 [32·m·128]; into ``out`` when given."""
    return _route("unpack_signs_weighted_sum", all_packed,
                  unpack_signs_weighted_sum_plain,
                  unpack_signs_wsum_cuda)(all_packed, scales.float(), out)


def unpack_signs(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_signs`: [m, 128] → f32 ±1 [32·m·128]; on the
    card B4 with one worker of scale 1, as the JAX package."""
    if packed.device.type == "cpu":
        return unpack_signs_plain(packed)
    one = torch.ones(1, dtype=torch.float32, device=packed.device)
    return unpack_signs_weighted_sum(packed[None], one)


def unpack_signs_weighted_mean(all_packed: torch.Tensor, scales: torch.Tensor,
                               size: int, out=None) -> torch.Tensor:
    """The worker mean Σ_w (scales[w]/size)·signs[w], the ``/size`` folded
    into the [W] scales; into ``out`` when given."""
    return unpack_signs_weighted_sum(all_packed, scales.float() / size, out)


def pack_signs_encode(flat: torch.Tensor, state: torch.Tensor):
    """Fused onebit encode: ``c = flat + state`` → (packed signs of c,
    |c|)."""
    return _route("pack_signs_encode", flat, pack_signs_encode_plain,
                  pack_signs_encode_cuda)(flat, state)


def signed_residual(absc: torch.Tensor, packed: torch.Tensor,
                    scale: torch.Tensor, out=None) -> torch.Tensor:
    """New onebit error state ``c − scale·sign(c)`` from |c|, the packed
    sign bits and the scalar ``scale`` (a tensor); into ``out`` when
    given (the strategy's state, rewritten in place)."""
    return _route("signed_residual", absc, signed_residual_plain,
                  signed_residual_cuda)(absc, packed, scale, out)


def topk_encode(c2: torch.Tensor, k: int, out=None):
    """Fused topk encode of ``c2`` [rows, chunk]: per chunk row the k
    largest |·| as (bf16 values, int16 offsets), and the new error state
    with the bf16 rounding residual written at the selected offsets (into
    ``out`` when given: the strategy's state, rewritten in place)."""
    return _route("topk_encode", c2, topk_encode_plain,
                  topk_encode_cuda)(c2, k, out)


def topk_decode(all_vals: torch.Tensor, all_idx: torch.Tensor, chunk: int,
                size: int = 1, out=None) -> torch.Tensor:
    """Fused topk decode: every worker's [W, rows, k] wire rows summed into
    the dense f32 [rows·chunk], ÷ size; into ``out`` when given."""
    return _route("topk_decode", all_vals, topk_decode_plain,
                  topk_decode_cuda)(all_vals, all_idx, chunk, size, out)
