"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --flash-times   # the flash kernels' times alone
    python3 chip_smoke.py --topk-times    # B7's time alone
    python3 chip_smoke.py --factor-times  # B9's PowerSGD passes alone
    python3 chip_smoke.py --flash-times --topk-times --factor-times

1. Fails (exit 2, no result) without CUDA; prints the card's name and power
   limit as ``nvidia-smi`` reports them.
2. Builds every hand-written kernel of ``theanompi_tpu_torch/csrc`` with
   ``nvcc`` into ``build/kernels/`` (one compiler per source, in parallel).
3. LRN (B1/B2): holds each kernel against its plain PyTorch version at
   AlexNet's shapes, in float32 (TF32 off) and bfloat16, and times the
   kernel, the plain version, and the one PyTorch call that computes the
   same function (``F.local_response_norm``; timed here only, the port
   never calls it).
4. Compress (B3–B6): on a random float32 vector of VGG-16's padded length
   (planted ±0.0), holds the sign pack, the encode and the residual against
   their plain versions bit for bit, and the weighted decode at 1 worker bit
   for bit and at 4 and 8 stacked workers within its stated bound; times
   each beside its plain version and its byte bound.  No single PyTorch
   call computes any of the four, so their ``library_ms`` is null.
5. Holds full-width AlexNet's logits on the card (kernels) against the same
   weights on the CPU (plain versions), float32, batch 2.
6. Drives the AlexNet main path: ``BSP().init(devices=1, modelfile=
   'theanompi_tpu_torch.models.alex_net', modelclass='AlexNet', ...)`` at
   batch 128, full width, bf16, a few steps, and checks the cost is finite,
   the params sit on the card and which kernels were launched how often.
7. Profiles a few more AlexNet steps: host wall and host buckets per step,
   device busy time, the device's idle share, the kernels by device time.
8. Drives the VGG-16 onebit main path: ``BSP().init(devices=1, modelfile=
   'theanompi_tpu_torch.models.vggnet_16', modelclass='VGGNet_16',
   exch_strategy='onebit', batch_size=32, ...)``, full width and depth,
   8 steps and a validation batch; checks the costs, the params' device,
   the error-feedback state, and that B5, B6 and B4 ran once per step.
9. Profiles VGG-16 onebit steps the same way, with the per-step device time
   of B4+B5+B6 and of the flatten copy, and checks that one exchange reads
   nothing back to the host (CUDA sync debug mode).
10. Topk (B7/B8): at VGG-16's padded shape, c2 [16890, 8192] with k = 82
    (all-zero rows, planted ties, ±0.0, and the radix select's stress rows:
    |c| sharing their top 16 bits, more than k ties at the threshold after
    the larger entries, subnormals, ±inf), holds the encode and the decode
    (1, 4 and 8 workers) against their plain versions bit for bit; times
    each beside its plain version, its byte bound and a library yardstick
    (``torch.topk`` for the selection alone; one accumulating
    ``index_put_`` for the scatter alone); prints B7 beside its first,
    argmax-pass version.
11. Factor pack (B9): both passes of a PowerSGD step over VGG-16's 16
    compressible weights (``Aᵀ q``, then ``A p``, rank 2), each one
    grouped launch as the main path makes it, against the plain version
    within the float32 dot-product bound, pad rows exactly +0, a rerun bit
    for bit the same and each tile bit for bit the one-leaf entry's; times
    each pass beside the sum of its 16 one-leaf launches, its bound, the
    plain group and ``torch.matmul`` over its products (TF32 off).
12. Drives VGG-16 under ``exch_strategy='topk'`` and ``'powersgd'`` the
    way step 8 drives onebit (8 steps, a validation batch, launch counts:
    8 B7 + 8 B8, and 2 × 8 = 16 grouped B9, nothing else), profiles each,
    and runs one exchange of each under CUDA's sync debug mode: the topk
    exchange must make the host wait on nothing; PowerSGD's waits (its
    ``torch.linalg.qr`` might read back) are counted and printed.
13. Flash attention (B10–B12): checks with ``cuobjdump -sass`` that every
    build of B10, B11 and B12 holds wgmma (``HGMMA``) and TMA loads
    (``UTMALDG``); at the LM's shape [16, 8, 512, 64] bf16, causal, on q,
    k, v and dO laid out as the model hands them (views of [B, T, H, hd]),
    holds the forward and both backward kernels against their plain
    versions; times each beside its plain version, its bound and the
    library yardstick (``F.scaled_dot_product_attention(...,
    is_causal=True)`` for B10, its autograd backward, dQ, dK and dV in one,
    for B11 and B12; timed here only, the port never calls it), and the
    host µs of each wrapper call; prints B10–B12 beside their first, WMMA
    versions, and B11 + B12 beside SDPA's backward.
14. The LM at full width (d512, 8 heads, 8 layers, T512, vocab 32768) at
    batch 2 on the card: loss and gradients of ``attn_impl='flash'``
    (kernels, bf16) and ``'reference'`` (torch attention, bf16) from the
    same parameters, each against the same model in float32; flash must
    be as close to float32 as the bf16 reference, within a stated factor.
15. Drives the LM main path: ``BSP().init(devices=1, modelfile=
    'theanompi_tpu_torch.models.transformer_lm', modelclass='TransformerLM',
    attn_impl='flash', batch_size=16, ...)``, Adam, 8 steps and a validation
    batch; checks the costs, the params' device and the launch counts
    (8·(8+1) B10, 8·8 B11, 8·8 B12, nothing else); profiles its steps
    (tokens/s, host buckets, device busy, idle share, the flash kernels'
    device time).
16. Prints ``{"kernels": [...]}`` (B1–B12), then the card, then the last
    line ``{"ok": true, "device": {...}}``.

Any failed check raises: the script exits non-zero and prints no result.
TF32 is off for the whole run (float32 comparisons need it off; the main
paths compute in bfloat16 and are unaffected).
"""

import gc
import json
import os
import shutil
import subprocess
import sys
import time
import warnings

import torch

if not torch.cuda.is_available():
    print("chip_smoke: CUDA is not available", file=sys.stderr)
    sys.exit(2)

import numpy as np  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from theanompi_tpu_torch import BSP  # noqa: E402
from theanompi_tpu_torch.ops import _kernel_build  # noqa: E402
from theanompi_tpu_torch.ops import compress as cmp_ops  # noqa: E402
from theanompi_tpu_torch.ops import factor_pack as fp_ops  # noqa: E402
from theanompi_tpu_torch.ops import flash_attention as fa_ops  # noqa: E402
from theanompi_tpu_torch.ops import lrn as lrn_ops  # noqa: E402
from theanompi_tpu_torch.utils.helper_funcs import (  # noqa: E402
    tree_leaves, tree_map)

# H100 SXM peaks (NVIDIA data sheet, at its 700 W limit): device memory
# rate, and float32 outside the tensor cores (the kernels' math is f32)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12        # dense, tensor cores

BATCH = 128
STEPS = 8
VAL_BATCHES = 1
PROFILE_STEPS = 6
LRN_N = 5
# main-path LRN inputs of AlexNet at batch 128, NHWC
SHAPES = {"lrn1": (BATCH, 55, 55, 96), "lrn2": (BATCH, 27, 27, 256)}
# flops per element counted from the formula in csrc/lrn.cu: the window
# (2 per tap), then d, s and the products
FLOPS_PER_ELEM = {"fwd": 2 * LRN_N + 7, "bwd": 4 * LRN_N + 14}
TOL = {  # (rtol, atol as a fraction of max|plain|)
    # f32: the 5-tap window sums in another order than the band product
    "float32": {"fwd": (2e-6, 2e-6), "bwd": (2e-5, 2e-5)},
    # bf16: one bf16 rounding of f32 results on each side, one ulp = 2^-8
    "bfloat16": {"fwd": (2.0 ** -7, 2.0 ** -12), "bwd": (2.0 ** -7, 2.0 ** -12)},
}

VGG_BATCH = 32
VGG_STEPS = 8
# VGG-16 at its own learning rate (0.01) reaches NaN within 8 steps under
# allreduce and onebit alike (He init on mean-subtracted, unscaled pixels:
# the initial cost is ~90); the smoke trains at 0.001, where it descends
VGG_LR = 0.001
# decode widths held against the plain version: the main path's (1 rank)
# and stacked buffers of 4 and 8 ranks
DECODE_WORKERS = (1, 4, 8)
# the topk wire of VGG-16: TopK's chunk and k = round(0.01 · chunk)
TOPK_CHUNK, TOPK_K = 8192, 82
POWERSGD_RANK = 2

# the LM of scripts/perf_matrix_r5.sh's transformer_lm-b16-flash row
# (LM_CFG of scripts/_bench_row.sh): d512, 8 heads, 8 layers, T512, vocab
# 32768, batch 16, Adam at the model's lr 3e-3
LM_CFG = dict(attn_impl="flash", d_model=512, n_head=8, n_layer=8,
              seq_len=512, vocab=32768)
LM_BATCH = 16
LM_STEPS = 8
LM_CHECK_BATCH = 2
# the flash kernels against their plain versions: both round their f32
# sums to bf16 once (summed in another order) and round p and dS to bf16
# at the same points: one or two bf16 ulps (2^-8) of the outputs' scale
FLASH_TOL = (2.0 ** -7, 2.0 ** -7)          # (rtol, atol / max|plain|)
# the whole LM in bf16 against the same LM in float32, batch 2: at random
# init every gradient leaf of the bf16 model is ~8% (relative L2) from the
# float32 one whatever the attention (bf16 activations through 8 layers);
# flash must be as close as the bf16 reference attention, within a factor
# (it rounds p and dS to bf16 and takes di from the bf16 o, where the
# reference attends in f32): its gradients no further than LM_GRAD_RATIO
# times the reference's distance, its loss within LM_LOSS_RTOL (on an
# H100 the bf16 losses are 1.1e-5 (flash) and 3.7e-6 (reference) from it)
LM_LOSS_RTOL = 1e-4
LM_GRAD_RATIO = 2.0
# B10–B12 before their Hopper redesign (the first, nvcuda::wmma kernels),
# at the flash phase's shape: device ms from this script's flash phase on
# that tree; host µs per wrapper call, for B10 and B11 the least of two
# `chip_smoke.py --flash-times` runs on it (host times of one call spread
# by ±15 µs), for B12 this script's flash phase; all on an NVIDIA H100
# 80GB HBM3 at 700 W
WMMA_FLASH = {"flash_fwd_cuda": {"ms": 0.0978, "host_us": 43.4},
             "flash_bwd_dkv_cuda": {"ms": 0.1372, "host_us": 52.6},
             "flash_bwd_dq_cuda": {"ms": 0.1091, "host_us": 60.9}}
# B7 before its radix select (k block-wide argmax passes a row), at the
# topk phase's shape: device ms from this script's topk phase on that tree,
# on the same card and limit
ARGMAX_TOPK = {"topk_encode_cuda": {"ms": 3.8553}}
# B9 before its grouped redesign (one rowdot or coldot launch per leaf and
# product), per PowerSGD step: device ms from this script's factor pack
# phase on that tree, on the same card and limit
ROWCOL_FACTOR = {"ms": 0.8050}
# instructions the redesigned B10–B12 must hold in every instantiation:
# wgmma and TMA loads
FLASH_SASS = {"flash_fwd_kernel": ("HGMMA", "UTMALDG"),
              "flash_bwd_dkv_kernel": ("HGMMA", "UTMALDG"),
              "flash_bwd_dq_kernel": ("HGMMA", "UTMALDG")}
# what each redesigned kernel is now, for the kernels line
DESIGN = {"topk_encode": "radix select on the bits of |c|, lowest offsets on "
                         "the threshold's ties, slots by rank count (k <= "
                         "256) or bitonic sort",
          "flash_fwd": "TMA ring, wgmma, softmax in registers, pipelined",
          "flash_bwd_dkv": "TMA ring, wgmma, p and dS in registers",
          "flash_bwd_dq": "TMA ring, wgmma, dS in registers",
          "matmul_pack": "one launch per factor pass over every leaf; each "
                         "work item a cluster of 8 CTAs splitting its sums, "
                         "added through distributed shared memory in rank "
                         "order; float4 loads, 4 rows in flight"}

ALL_KERNELS = ((lrn_ops.lrn_fwd_cuda, lrn_ops.lrn_bwd_cuda) + cmp_ops.KERNELS
               + fp_ops.KERNELS + fa_ops.KERNELS)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 10, inner: int = 10, warmup: int = 3) -> float:
    """Device time of one call: CUDA events around ``inner`` calls in a row,
    divided by ``inner``; the median of ``reps`` such runs, after warm-up.
    Each run first queues a ~5 ms device sleep, so the host has enqueued
    all ``inner`` calls before the card reaches the first: the stream
    never waits on the host between them, and a kernel shorter than its
    launch's host cost is still timed on the device."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(10_000_000)         # cycles: ~5 ms at 1.98 GHz
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return float(np.median(times))


def check_close(name, got, want, rtol, atol_frac):
    got, want = got.detach().float(), want.detach().float()
    err = float((got - want).abs().max())
    atol = atol_frac * float(want.abs().max())
    bad = (got - want).abs() > atol + rtol * want.abs()
    if not torch.isfinite(got).all() or bool(bad.any()):
        raise AssertionError(f"{name}: kernel disagrees with the plain "
                             f"version, max |diff| {err:.3e} "
                             f"(rtol {rtol}, atol {atol:.3e})")
    return err


def check_bits(name, got, want) -> float:
    """Bit for bit (float tensors compared as their int32 bit patterns),
    except that a NaN may carry another payload where both sides hold a
    NaN (inf − inf in a residual, a sum of ±inf)."""
    g = got.view(torch.int32) if got.is_floating_point() else got
    w = want.view(torch.int32) if want.is_floating_point() else want
    if g.shape != w.shape:
        raise AssertionError(f"{name}: shapes {tuple(g.shape)} and "
                             f"{tuple(w.shape)}")
    same = g == w
    if got.is_floating_point():
        same |= torch.isnan(got) & torch.isnan(want)
    if not bool(same.all()):
        raise AssertionError(f"{name}: kernel differs from the plain version "
                             f"in {int((~same).sum())} elements")
    return 0.0


def bound(nbytes: float, flops: float,
          flops_per_s: float = F32_FLOPS_PER_S) -> dict:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bytes_ms": t_bytes,
            "ops_ms": t_ops,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def zero_launches() -> None:
    for k in ALL_KERNELS:
        k.launches = 0


def launch_counts() -> dict:
    return {k.__name__: k.launches for k in ALL_KERNELS}


def expect(**launches) -> dict:
    """Launch counts of a main path: those named, 0 for every other
    kernel."""
    return dict({k.__name__: 0 for k in ALL_KERNELS}, **launches)


def lrn_phase():
    """B1/B2 against the plain version and the library call, per shape."""
    g = torch.Generator(device="cuda").manual_seed(0)
    out = {"fwd": [], "bwd": []}
    for label, shape in SHAPES.items():
        for dtype in (torch.float32, torch.bfloat16):
            dn = str(dtype).split(".")[1]
            x = (torch.randn(shape, generator=g, device="cuda") * 3).to(dtype)
            dy = torch.randn(shape, generator=g, device="cuda").to(dtype)
            y = lrn_ops.lrn_fwd_cuda(x)
            dx = lrn_ops.lrn_bwd_cuda(x, dy)
            xp = x.detach().clone().requires_grad_(True)
            yp = lrn_ops.lrn_plain(xp)
            (dxp,) = torch.autograd.grad(yp, xp, dy)
            torch.cuda.synchronize()
            e_f = check_close(f"B1 {label} {dn}", y, yp, *TOL[dn]["fwd"])
            e_b = check_close(f"B2 {label} {dn}", dx, dxp, *TOL[dn]["bwd"])
            if dtype != torch.bfloat16:       # the main path's type is timed
                out["fwd"].append({"shape": label, "dtype": dn,
                                   "max_abs_err": e_f})
                out["bwd"].append({"shape": label, "dtype": dn,
                                   "max_abs_err": e_b})
                continue
            nchw = x.permute(0, 3, 1, 2)      # the library's channel dim is 1
            xl = nchw.detach().clone().requires_grad_(True)
            dyl = dy.permute(0, 3, 1, 2)

            def lib_fwd():
                return F.local_response_norm(nchw, LRN_N, 1e-4, 0.75, 2.0)

            def lib_fwd_bwd():
                return torch.autograd.grad(
                    F.local_response_norm(xl, LRN_N, 1e-4, 0.75, 2.0), xl,
                    dyl)

            def plain_bwd():
                return torch.autograd.grad(lrn_ops.lrn_plain(xp), xp, dy)

            numel = x.numel()
            isz = x.element_size()
            for kind, kern, plain, lib, nbytes in (
                    ("fwd", lambda: lrn_ops.lrn_fwd_cuda(x),
                     lambda: lrn_ops.lrn_plain(x), lib_fwd, 2 * numel * isz),
                    ("bwd", lambda: lrn_ops.lrn_bwd_cuda(x, dy), plain_bwd,
                     lib_fwd_bwd, 3 * numel * isz)):
                out[kind].append({
                    "shape": label, "dims": list(shape), "dtype": dn,
                    "max_abs_err": e_f if kind == "fwd" else e_b,
                    "ms": time_ms(kern), "plain_ms": time_ms(plain),
                    "library_ms": time_ms(lib),
                    **bound(nbytes, FLOPS_PER_ELEM[kind] * numel)})
            del x, dy, xp, yp, dxp, xl, nchw, dyl
            torch.cuda.empty_cache()
    return out


def vgg16_sizes():
    """VGG-16's parameter count at 1000 classes and its length padded to
    PACK_ALIGN (what the onebit wire packs), from the layer shapes."""
    from theanompi_tpu_torch.models.vggnet_16 import _VGG16_BLOCKS, _vgg_stack
    n = 0
    for layer in _vgg_stack(_VGG16_BLOCKS, "bfloat16", 1000).layers:
        if hasattr(layer, "kernel"):
            n += layer.in_ch * layer.out_ch * 9 + layer.out_ch
        elif hasattr(layer, "n_in"):
            n += layer.n_in * layer.n_out + layer.n_out
    return n, n + (-n) % cmp_ops.PACK_ALIGN


def compress_phase():
    """B3–B6 at VGG-16's padded length: bit for bit against the plain
    versions (B4 within its bound at W > 1), times, bounds."""
    n_true, n = vgg16_sizes()
    g = torch.Generator(device="cuda").manual_seed(1)
    flat = torch.randn(n, generator=g, device="cuda")
    state = torch.randn(n, generator=g, device="cuda") * 0.1
    flat[::9973] = 0.0                      # c = +0.0 + +0.0
    state[::9973] = 0.0
    flat[1::10007] = -0.0                   # c = −0.0 + −0.0 = −0.0
    state[1::10007] = -0.0
    flat[n_true:] = 0.0                     # the pad, as the wire has it
    state[n_true:] = 0.0
    zero_launches()
    words = cmp_ops.pack_signs_cuda(flat)
    kp, ka = cmp_ops.pack_signs_encode_cuda(flat, state)
    scale = ka[:n_true].mean() + 1e-12
    kr = cmp_ops.signed_residual_cuda(ka, kp, scale)
    torch.cuda.synchronize()
    checked = launch_counts()
    err = {"pack_signs_cuda": check_bits("B3", words,
                                         cmp_ops.pack_signs_plain(flat))}
    pp, pa = cmp_ops.pack_signs_encode_plain(flat, state)
    check_bits("B5 words", kp, pp)
    err["pack_signs_encode_cuda"] = check_bits("B5 |c|", ka, pa)
    err["signed_residual_cuda"] = check_bits(
        "B6", kr, cmp_ops.signed_residual_plain(pa, pp, scale))
    del pp, pa, words
    m = kp.shape[0]

    decode = []
    for w in DECODE_WORKERS:
        allp = kp[None] if w == 1 else torch.randint(
            -2 ** 31, 2 ** 31, (w, m, cmp_ops.LANES), generator=g,
            device="cuda", dtype=torch.int32)
        scales = (scale / w).reshape(1) if w == 1 else \
            torch.rand(w, generator=g, device="cuda") + 0.1
        got = cmp_ops.unpack_signs_wsum_cuda(allp, scales)
        want = cmp_ops.unpack_signs_weighted_sum_plain(allp, scales)
        torch.cuda.synchronize()
        if w == 1:
            e = check_bits("B4 W=1", got, want)
        else:
            rtol, atol = cmp_ops.decode_tol(w, scales)
            e = check_close(f"B4 W={w}", got, want, rtol,
                            atol / float(want.abs().max()))
        del got, want
        decode.append({
            "workers": w, "max_abs_err": e,
            "ms": time_ms(lambda: cmp_ops.unpack_signs_wsum_cuda(allp,
                                                                 scales)),
            "plain_ms": time_ms(lambda: cmp_ops.unpack_signs_weighted_sum_plain(
                allp, scales), reps=5, inner=2, warmup=1),
            # read W·n/8 bytes of words and W scales, write 4n
            **bound(w * n / 8 + 4 * w + 4 * n, (2 * w + 1) * n)})
        del allp
        torch.cuda.empty_cache()

    # bytes: each input read once, each output written once; flops: the
    # float32 operations per element of csrc/compress.cu
    rows = {
        "pack_signs_cuda": (lambda: cmp_ops.pack_signs_cuda(flat),
                            lambda: cmp_ops.pack_signs_plain(flat),
                            4 * n + n / 8, n),
        "pack_signs_encode_cuda": (
            lambda: cmp_ops.pack_signs_encode_cuda(flat, state),
            lambda: cmp_ops.pack_signs_encode_plain(flat, state),
            8 * n + 4 * n + n / 8, 3 * n),
        "signed_residual_cuda": (
            lambda: cmp_ops.signed_residual_cuda(ka, kp, scale),
            lambda: cmp_ops.signed_residual_plain(ka, kp, scale),
            4 * n + n / 8 + 4 + 4 * n, n),
    }
    out = {"n": n, "n_true": n_true, "checked_launches": checked,
           "decode": decode}
    for name, (kern, plain, nbytes, flops) in rows.items():
        out[name] = {"max_abs_err": err[name], "ms": time_ms(kern),
                     "plain_ms": time_ms(plain, reps=5, inner=2, warmup=1),
                     **bound(nbytes, flops)}
    out["unpack_signs_wsum_cuda"] = dict(decode[0], max_abs_err=max(
        d["max_abs_err"] for d in decode))
    del flat, state, kp, ka, kr
    torch.cuda.empty_cache()
    return out


def topk_inputs(n_true: int) -> torch.Tensor:
    """c2 [16890, 8192] of VGG-16's padded length, random with planted rows
    every 997th row: all-zero rows (+0.0 and −0.0), equal magnitudes, pairs
    of equal |c|, −0.0 inside a row; and the radix select's stress rows:
    |c| sharing their top 16 bits, more than k entries equal to the
    threshold after (at higher offsets than) the strictly larger ones,
    subnormals (with zeros), and ±inf among normal values."""
    rows = -(-n_true // TOPK_CHUNK)
    g = torch.Generator(device="cuda").manual_seed(2)
    c2 = torch.randn(rows, TOPK_CHUNK, generator=g, device="cuda")
    c2.view(-1)[n_true:] = 0.0              # the pad, as the wire has it
    c2[::997] = 0.0                         # all-zero rows (+0.0 and −0.0)
    c2[::997, 1::3] = -0.0
    c2[1::997, ::4] = 0.5                   # planted equal magnitudes
    c2[1::997, 2::8] = -0.5
    c2[2::997, ::2] = -c2[2::997, 1::2]     # pairs of equal |c|
    c2[3::997, 5::7] = -0.0                 # −0.0 inside a row

    def bits(lo, hi, n):                    # random bits with random signs
        b = torch.randint(lo, hi, (n, TOPK_CHUNK), generator=g,
                          device="cuda", dtype=torch.int32)
        neg = torch.rand(n, TOPK_CHUNK, generator=g, device="cuda") < 0.5
        return torch.where(neg, b | torch.iinfo(torch.int32).min,
                           b).view(torch.float32)

    n = c2[4::997].shape[0]
    c2[4::997] = bits(0x3f800000, 0x3f810000, n)    # one top 16 bits
    ties = TOPK_K // 2
    c2[5::997] = torch.randn(n, TOPK_CHUNK, generator=g, device="cuda") * 0.01
    c2[5::997, :ties] = 10.0 + torch.arange(ties, device="cuda")
    c2[5::997, ties::2] = bits(0x40a00000, 0x40a00001, n)[:, ties::2]   # ±5
    c2[6::997] = bits(1, 1 << 23, n)                # subnormals
    c2[6::997, ::9] = 0.0
    c2[7::997, 3::TOPK_CHUNK // 3] = float("inf")
    c2[7::997, 5::TOPK_CHUNK // 4] = float("-inf")
    return c2


def topk_phase(n_true: int):
    """B7/B8 at VGG-16's padded shape [16890, 8192], k = 82, on
    :func:`topk_inputs`: bit for bit against the plain versions (B8 at 1, 4
    and 8 stacked workers, with the /size mean), times, byte bounds,
    library yardsticks."""
    c2 = topk_inputs(n_true)
    rows = c2.shape[0]
    n, k = rows * TOPK_CHUNK, TOPK_K
    zero_launches()
    kv, ki, ks = cmp_ops.topk_encode_cuda(c2, k)
    torch.cuda.synchronize()
    checked = launch_counts()
    pv, pi, ps = cmp_ops.topk_encode_plain(c2, k)
    check_bits("B7 values", kv.view(torch.int16), pv.view(torch.int16))
    check_bits("B7 offsets", ki, pi)
    err7 = check_bits("B7 state", ks, ps)
    del pv, pi, ps
    torch.cuda.empty_cache()

    base = (torch.arange(rows, device="cuda") * TOPK_CHUNK).reshape(rows, 1)
    dense = torch.empty(n, device="cuda")
    decode = []
    for w in DECODE_WORKERS:
        # w ranks' rows (row-rolled copies: a rank's offsets in a row stay
        # distinct), decoded into their mean (÷ w; no division at w = 1)
        av = torch.stack([kv.roll(i, 0) for i in range(w)])
        ai = torch.stack([ki.roll(i, 0) for i in range(w)])
        # against the plain decode on the CPU: on the card its index_add_
        # adds with float atomics, which flush subnormal values to zero
        # (the subnormal stress rows send some); B8 keeps them, as the jnp
        # oracle does
        got = cmp_ops.topk_decode_cuda(av, ai, TOPK_CHUNK, w)
        want = cmp_ops.topk_decode_plain(av.cpu(), ai.cpu(), TOPK_CHUNK, w)
        torch.cuda.synchronize()
        e = check_bits(f"B8 W={w}", got.cpu(), want)
        del got, want
        gidx = (ai.long() + base).reshape(-1)
        fv = av.float().reshape(-1)
        decode.append({
            "workers": w, "max_abs_err": e,
            "ms": time_ms(lambda: cmp_ops.topk_decode_cuda(av, ai, TOPK_CHUNK,
                                                           w)),
            "plain_ms": time_ms(lambda: cmp_ops.topk_decode_plain(
                av, ai, TOPK_CHUNK, w), reps=5, inner=2, warmup=1),
            # the scatter alone: no bf16 cast, no global-index arithmetic,
            # no ÷ w, atomics' order of adds
            "library_ms": time_ms(lambda: dense.zero_().index_put_(
                (gidx,), fv, accumulate=True)),
            # read w·rows·k (bf16 + int16), write 4n; one add per slot and
            # one division per element when w > 1
            **bound(4 * w * rows * k + 4 * n,
                    w * rows * k + (n if w > 1 else 0))})
        del av, ai, gidx, fv
        torch.cuda.empty_cache()
    out = {"rows": rows, "chunk": TOPK_CHUNK, "k": k, "n": n,
           "checked_launches": checked, "decode": decode,
           "topk_decode_cuda": dict(decode[0], max_abs_err=max(
               d["max_abs_err"] for d in decode)),
           "topk_encode_cuda": {
               "max_abs_err": err7, "ms": time_ms(
                   lambda: cmp_ops.topk_encode_cuda(c2, k)),
               "plain_ms": time_ms(lambda: cmp_ops.topk_encode_plain(c2, k),
                                   reps=5, inner=2, warmup=1),
               # the selection alone (an |c| pass, then k largest in
               # torch's tie order): no bf16 values, no int16 offsets, no
               # residual state
               "library_ms": time_ms(lambda: torch.topk(c2.abs(), k, dim=1)),
               # read 4n, write the state 4n and 4 bytes a slot; an abs and
               # a compare per element select the row's k largest
               **bound(8 * n + 4 * rows * k, 2 * n)}}
    del c2, kv, ki, ks, dense, base
    torch.cuda.empty_cache()
    return out


def vgg16_factor_shapes():
    """``A = leaf.reshape(shape[0], -1)`` of each VGG-16 weight PowerSGD
    compresses at rank 2 (min(rows, cols) > 8: all 13 convs and 3 FCs)."""
    from theanompi_tpu_torch.models.vggnet_16 import _VGG16_BLOCKS, _vgg_stack
    out = []
    for layer in _vgg_stack(_VGG16_BLOCKS, "bfloat16", 1000).layers:
        if hasattr(layer, "kernel"):
            kh, kw = layer.kernel
            out.append((layer.out_ch, layer.in_ch * kh * kw))
        elif hasattr(layer, "n_in"):
            out.append((layer.n_out, layer.n_in))
    assert len(out) == 16 and all(min(s) > 4 * POWERSGD_RANK for s in out)
    return out


def factor_inputs():
    """A of each of VGG-16's 16 compressible weights (``* 0.01``, about a
    gradient's scale) and, per pass, the factor it is multiplied with at
    rank 2: q [out_ch, r] for P = Aᵀ q (transpose) and p [in, r] for
    Q' = A p."""
    g = torch.Generator(device="cuda").manual_seed(3)
    r = POWERSGD_RANK
    mats = [torch.randn(co, rest, generator=g, device="cuda") * 0.01
            for co, rest in vgg16_factor_shapes()]
    return mats, {t: [torch.randn(a.shape[0] if t else a.shape[1], r,
                                  generator=g, device="cuda") for a in mats]
                  for t in (True, False)}


def factor_pass_check(mats, qs, t) -> list:
    """One B9 pass against the plain version: each leaf's tile within the
    float32 dot-product bound 2·γ_n·(|m| @ |q|), γ_n = n·u/(1 − n·u),
    u = 2⁻²⁴ (each side's sum of n products in its own order), its pad
    rows exactly +0.  The grouped pass is also run twice, bit for bit the
    same, and each of its tiles is bit for bit the one-leaf entry's (a
    tree from before the grouped kernel has only the one-leaf entry).  Per
    leaf: (max |diff|, max diff/bound)."""
    u = 2.0 ** -24
    group = getattr(fp_ops, "matmul_pack_group_cuda", None)
    ones = [fp_ops.matmul_pack_cuda(a, q, transpose=t)
            for a, q in zip(mats, qs)]
    if group:
        ts = [t] * len(mats)
        got = group(mats, qs, ts)
        check_bits("B9 pass rerun", group(mats, qs, ts), got)
        check_bits("B9 one leaf vs group", torch.cat(ones), got)
    out = []
    for a, q, tile in zip(mats, qs, ones):
        m = a.t() if t else a
        rows, inner = m.shape
        want = fp_ops.matmul_pack_plain(a, q, transpose=t)
        tol = 2 * inner * u / (1 - inner * u) * (m.abs() @ q.abs())
        err = (tile[:rows] - want[:rows]).abs()
        pad = tile[rows:]
        if not bool(torch.isfinite(tile).all()) or \
                bool((err > tol).any()) or bool(pad.any()) or \
                bool(torch.signbit(pad).any()):
            raise AssertionError(
                f"B9 {tuple(a.shape)} transpose={t}: max |diff| "
                f"{float(err.max()):.3e}, max diff/bound "
                f"{float((err / tol).max()):.3f}, pad "
                f"{pad.abs().max() if pad.numel() else 0}")
        out.append((float(err.max()), float((err / tol).max())))
    return out


def factor_pack_phase():
    """B9 over VGG-16's 16 compressible weights, both passes of a PowerSGD
    step at rank 2 (P = Aᵀ q, then Q' = A p) as the main path makes them,
    one grouped launch each, checked by ``factor_pass_check``.  Times each
    grouped pass beside the sum of its 16 one-leaf launches, the plain
    group, the sum of ``torch.matmul`` over its products, and its bound
    (each product reads A and its factor once and writes its tile)."""
    mats, factors = factor_inputs()
    r = POWERSGD_RANK
    passes, products = [], []
    for t in (True, False):
        qs, ts = factors[t], [t] * len(mats)
        checks = factor_pass_check(mats, qs, t)
        rows = []
        for a, q, (err, over) in zip(mats, qs, checks):
            m = a.t() if t else a
            rows_pad = fp_ops.pad_rows(m.shape[0])
            rows.append({
                "shape": list(a.shape), "transpose": t, "rows_pad": rows_pad,
                "max_abs_err": err, "err_over_bound": over,
                "ms": time_ms(lambda: fp_ops.matmul_pack_cuda(
                    a, q, transpose=t)),
                "library_ms": time_ms(lambda: m @ q),
                **bound(4 * (a.numel() + q.numel() + rows_pad * r),
                        2 * r * a.numel())})
        products += rows
        tot = lambda k: sum(p[k] for p in rows)
        passes.append({
            "transpose": t,
            "ctas": len(fp_ops.tile_table(tuple(
                (a.shape[0], a.shape[1], p["rows_pad"], t)
                for a, p in zip(mats, rows)))),
            "ms": time_ms(lambda: fp_ops.matmul_pack_group_cuda(mats, qs, ts)),
            "plain_ms": time_ms(lambda: fp_ops.matmul_pack_group_plain(
                mats, qs, ts)),
            "per_leaf_ms": tot("ms"), "library_ms": tot("library_ms"),
            "bound_ms": tot("bound_ms"), "bytes_ms": tot("bytes_ms"),
            "ops_ms": tot("ops_ms")})
    step = {k: sum(p[k] for p in passes)
            for k in ("ms", "per_leaf_ms", "plain_ms", "library_ms",
                      "bound_ms", "bytes_ms", "ops_ms")}
    step["bound_by"] = "bytes" if step["bytes_ms"] >= step["ops_ms"] \
        else "operations"
    del mats, factors
    torch.cuda.empty_cache()
    return {"rank": r, "per_step": step, "passes": passes,
            "products": products,
            "max_abs_err": max(p["max_abs_err"] for p in products),
            "max_err_over_bound": max(p["err_over_bound"] for p in products)}


def alexnet_reference_phase():
    """Full-width AlexNet, float32, batch 2: logits through the kernels on
    the card against the same weights through the plain versions on the
    CPU.  rtol 1e-4 / atol 1e-4·max|logit|: cuDNN's float32 algorithms and
    oneDNN's round and sum differently across eight layers."""
    from theanompi_tpu_torch.models.alex_net import AlexNet
    cfg = {"batch_size": 2, "n_class": 10, "compute_dtype": "float32",
           "synthetic_batches": 1, "synthetic_val_batches": 1}
    gpu = AlexNet(dict(cfg, device="cuda"))
    cpu = AlexNet(dict(cfg, device="cpu"))
    cpu.load_params(gpu.host_params())
    x = torch.from_numpy(
        (np.random.RandomState(0).randn(2, 227, 227, 3) * 50).astype(
            np.float32))
    with torch.no_grad():
        want = cpu.apply_model(cpu.params, x, train=False, gen=None)
        got = gpu.apply_model(gpu.params, x.cuda(), train=False,
                              gen=None).cpu()
    if got.shape != (2, 10):
        raise AssertionError(f"AlexNet logits shape {tuple(got.shape)}")
    return check_close("AlexNet f32 logits, card vs CPU", got, want, 1e-4,
                       1e-4)


def flash_bytes_flops(b, h, t, d):
    """Per kernel (B10, B11, B12): the bytes it must move (each input read
    once, each output written once: bf16 [B, H, T, hd] tensors, f32 [B, H,
    T] row stats) and the flops of its products over the causal pairs
    t(t+1)/2 of each head (2·hd per pair and product: B10 q kᵀ and p v;
    B11 q kᵀ, dO vᵀ, pᵀ dO and dSᵀ q; B12 q kᵀ, dO vᵀ and dS k)."""
    x, stat = 2 * b * h * t * d, 4 * b * h * t
    pair_flops = 2 * d * b * h * t * (t + 1) // 2
    return {"flash_fwd_cuda": (4 * x + stat, 2 * pair_flops),
            "flash_bwd_dkv_cuda": (6 * x + 2 * stat, 4 * pair_flops),
            "flash_bwd_dq_cuda": (5 * x + 2 * stat, 3 * pair_flops)}


def flash_sass_check(lib_path: str) -> dict:
    """``cuobjdump -sass`` of the built flash library: every instantiation
    (head dims 32, 64, 128) of ``flash_fwd_kernel`` and
    ``flash_bwd_dkv_kernel`` must hold wgmma (``HGMMA``) and TMA load
    (``UTMALDG``) instructions.  Raises if the tool is missing or an
    instruction is absent; returns the counts per kernel."""
    tool = os.path.join(os.path.dirname(_kernel_build.nvcc_path()),
                        "cuobjdump")
    if not os.path.exists(tool):
        tool = shutil.which("cuobjdump")
    if tool is None:
        raise AssertionError("cuobjdump not found: the flash SASS check "
                             "cannot run")
    sass = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                          text=True, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            counts[fn] = {}
        elif fn is not None:
            for ins in ("HGMMA", "UTMALDG", "UTMASTG"):
                if ins in line:
                    counts[fn][ins] = counts[fn].get(ins, 0) + 1
    out = {}
    for kern, need in FLASH_SASS.items():
        found = [c for f, c in counts.items() if kern in f]
        if len(found) != len(fa_ops.HEAD_DIMS) or \
                not all(c.get(ins) for c in found for ins in need):
            raise AssertionError(f"{kern}: {len(found)} instantiations, "
                                 f"SASS counts {found}; each needs {need}")
        out[kern] = {ins: [c.get(ins, 0) for c in found]
                     for ins in ("HGMMA", "UTMALDG", "UTMASTG")}
    return out


def host_us(fn, calls: int = 200, reps: int = 9) -> float:
    """Host µs of one call of ``fn`` (a kernel wrapper: checks, tensor
    maps, launch): ``calls`` calls in a row without a synchronize, the card
    running behind; the least of ``reps`` runs (the host's cores are shared,
    and other work only ever adds time)."""
    for _ in range(5):
        fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - t0) * 1e6 / calls)
    torch.cuda.synchronize()
    return float(min(times))


def flash_inputs():
    """q, k, v and dO at the LM's main-path shape, bf16, laid out as the
    model hands them (transposed views of [B, T, H, hd])."""
    b, t = LM_BATCH, LM_CFG["seq_len"]
    h = LM_CFG["n_head"]
    d = LM_CFG["d_model"] // h
    g = torch.Generator(device="cuda").manual_seed(4)

    def mk():
        return torch.randn(b, t, h, d, generator=g, device="cuda").to(
            torch.bfloat16).transpose(1, 2)

    return mk(), mk(), mk(), mk()


def flash_calls(q, k, v, do, lse, di) -> dict:
    return {"flash_fwd_cuda": lambda: fa_ops.flash_fwd_cuda(q, k, v),
            "flash_bwd_dkv_cuda": lambda: fa_ops.flash_bwd_dkv_cuda(
                q, k, v, do, lse, di),
            "flash_bwd_dq_cuda": lambda: fa_ops.flash_bwd_dq_cuda(
                q, k, v, do, lse, di)}


def times_main(flags) -> int:
    """``python3 chip_smoke.py --flash-times``, ``--topk-times`` and/or
    ``--factor-times``: the flash kernels' device ms and host µs per
    wrapper call at the flash phase's shape; B7's device ms at the topk
    phase's on three kinds of rows, each first checked bit for bit against
    the plain version; B9's device ms for each PowerSGD pass over VGG-16's
    16 leaves as the tree's main path makes it (one grouped launch, or on
    a tree from before the grouped kernel, 16 one-leaf launches), beside
    the sum of the one-leaf launches, after ``factor_pass_check``; nothing
    else (for setting two trees' kernels side by side in one call)."""
    card = card_line()
    out = {"card": card}
    if "--flash-times" in flags:
        _kernel_build.build(["flash_attention"])
        q, k, v, do = flash_inputs()
        o, lse = fa_ops.flash_fwd_cuda(q, k, v)
        di = fa_ops.attention_di(o, do)
        out["flash_times"] = {
            name: {"ms": time_ms(fn), "host_us": host_us(fn)}
            for name, fn in flash_calls(q, k, v, do, lse, di).items()}
        del q, k, v, do, o, lse, di
    if "--topk-times" in flags:
        _kernel_build.build(["compress"])
        c2 = topk_inputs(vgg16_sizes()[0])
        # beside the topk phase's rows, two that crowd the select's
        # histogram: all zero (one bin), and |c| sharing their top 16 bits
        top16 = torch.randint(0x3f800000, 0x3f810000, c2.shape,
                              generator=torch.Generator(
                                  device="cuda").manual_seed(3),
                              device="cuda", dtype=torch.int32)
        by_rows = {}
        for kind, x in (("planted", c2), ("zero", torch.zeros_like(c2)),
                        ("top16", top16.view(torch.float32))):
            kv, ki, ks = cmp_ops.topk_encode_cuda(x, TOPK_K)
            pv, pi, ps = cmp_ops.topk_encode_plain(x, TOPK_K)
            check_bits(f"B7 {kind} values", kv.view(torch.int16),
                       pv.view(torch.int16))
            check_bits(f"B7 {kind} offsets", ki, pi)
            check_bits(f"B7 {kind} state", ks, ps)
            del kv, ki, ks, pv, pi, ps
            by_rows[kind] = time_ms(lambda: cmp_ops.topk_encode_cuda(
                x, TOPK_K))
        out["topk_times"] = {"topk_encode_cuda": {
            "ms": by_rows.pop("planted"), "by_rows": by_rows}}
    if "--factor-times" in flags:
        _kernel_build.build(["factor_pack"])
        mats, factors = factor_inputs()
        group = getattr(fp_ops, "matmul_pack_group_cuda", None)
        passes = []
        for t in (True, False):
            qs = factors[t]
            factor_pass_check(mats, qs, t)
            ones = lambda: [fp_ops.matmul_pack_cuda(a, q, transpose=t)
                            for a, q in zip(mats, qs)]
            per_leaf = [time_ms(lambda: fp_ops.matmul_pack_cuda(
                a, q, transpose=t)) for a, q in zip(mats, qs)]
            passes.append({
                "transpose": t, "grouped": group is not None,
                "ms": time_ms((lambda: group(mats, qs, [t] * len(mats)))
                              if group else ones),
                "per_leaf_ms": sum(per_leaf), "per_leaf": per_leaf})
        out["factor_times"] = {"step_ms": sum(p["ms"] for p in passes),
                               "passes": passes}
        del mats, factors
    print(json.dumps(out))
    return 0


def flash_phase(lib_path: str):
    """B10–B12 at the LM's main-path shape, bf16, causal, on q, k, v and dO
    laid out as the model hands them (transposed views of [B, T, H, hd]):
    the SASS check of B10 and B11; each kernel against its plain version
    within FLASH_TOL; times, host µs per wrapper call, bounds, and the
    library yardsticks."""
    sass = flash_sass_check(lib_path)
    q, k, v, do = flash_inputs()
    b, h, t, d = q.shape
    zero_launches()
    o, lse = fa_ops.flash_fwd_cuda(q, k, v)
    di = fa_ops.attention_di(o, do)
    dk, dv = fa_ops.flash_bwd_dkv_cuda(q, k, v, do, lse, di)
    dq = fa_ops.flash_bwd_dq_cuda(q, k, v, do, lse, di)
    torch.cuda.synchronize()
    checked = launch_counts()
    po, plse = fa_ops.flash_fwd_plain(q, k, v)
    pdq, pdk, pdv = fa_ops.flash_bwd_plain(q, k, v, o, lse, do)
    err = {"flash_fwd_cuda": check_close("B10 o", o, po, *FLASH_TOL),
           "flash_bwd_dkv_cuda": max(check_close("B11 dk", dk, pdk, *FLASH_TOL),
                                     check_close("B11 dv", dv, pdv,
                                                 *FLASH_TOL)),
           "flash_bwd_dq_cuda": check_close("B12 dq", dq, pdq, *FLASH_TOL)}
    # lse: f32 on both sides, the row max and sum taken in another order
    lse_err = check_close("B10 lse", lse, plse, 1e-5, 1e-6)
    if o.stride() != q.stride():
        raise AssertionError(f"B10 o strides {o.stride()}, q {q.stride()}")
    del po, plse, pdq, pdk, pdv

    ql, kl, vl = (x.detach().clone().requires_grad_(True) for x in (q, k, v))
    lib_out = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True)

    def lib_fwd():
        return F.scaled_dot_product_attention(q, k, v, is_causal=True)

    def lib_bwd():
        return torch.autograd.grad(lib_out, (ql, kl, vl), do,
                                   retain_graph=True)

    def plain_bwd():
        return fa_ops.flash_bwd_plain(q, k, v, o, lse, do)

    bwd_plain_ms = time_ms(plain_bwd, reps=5, inner=2, warmup=1)
    lib_bwd_ms = time_ms(lib_bwd)
    sizes = flash_bytes_flops(b, h, t, d)
    plain_lib = {
        "flash_fwd_cuda": (time_ms(lambda: fa_ops.flash_fwd_plain(q, k, v),
                                   reps=5, inner=2, warmup=1),
                           time_ms(lib_fwd)),
        "flash_bwd_dkv_cuda": (bwd_plain_ms, lib_bwd_ms),
        "flash_bwd_dq_cuda": (bwd_plain_ms, lib_bwd_ms),
    }
    out = {"shape": [b, h, t, d], "checked_launches": checked,
           "lse_max_abs_err": lse_err, "sass": sass,
           "di_ms": time_ms(lambda: fa_ops.attention_di(o, do))}
    for name, kern in flash_calls(q, k, v, do, lse, di).items():
        plain_ms, lib_ms = plain_lib[name]
        out[name] = {"max_abs_err": err[name], "ms": time_ms(kern),
                     "host_us": host_us(kern), "plain_ms": plain_ms,
                     "library_ms": lib_ms,
                     **bound(*sizes[name], BF16_FLOPS_PER_S)}
    del q, k, v, do, o, lse, di, dk, dv, dq, ql, kl, vl, lib_out
    torch.cuda.empty_cache()
    return out


def lm_check_phase():
    """The LM at full width, batch 2, on the card: the loss and every
    gradient leaf of ``attn_impl='flash'`` (kernels B10–B12, bf16) and of
    ``'reference'`` (torch attention, bf16), from the same parameters and
    batch, each against the same model in float32 (reference attention,
    TF32 off).  Flash must be within LM_LOSS_RTOL of the float32 loss and,
    leaf by leaf, no further from the float32 gradient than LM_GRAD_RATIO
    times the bf16 reference's own distance."""
    from theanompi_tpu_torch.models.transformer_lm import TransformerLM
    cfg = dict(LM_CFG, batch_size=LM_CHECK_BATCH, synthetic_train=2,
               synthetic_val=2, seed=0, verbose=False, device="cuda")
    models = {"flash": TransformerLM(cfg),
              "reference": TransformerLM(dict(cfg, attn_impl="reference")),
              "float32": TransformerLM(dict(cfg, attn_impl="reference",
                                            compute_dtype="float32"))}
    src = tree_leaves(models["flash"].params)
    with torch.no_grad():
        for m in models.values():
            for a, c in zip(tree_leaves(m.params), src):
                a.copy_(c)
    batch = {k: torch.from_numpy(v).cuda() for k, v in
             models["flash"].data.next_train_batch(1).items()}
    res = {}
    for name, m in models.items():
        cost, _ = m.loss_and_metrics(m.params, batch, None, True)
        grads = torch.autograd.grad(cost, tree_leaves(m.params))
        res[name] = (float(cost.detach()), [g.float() for g in grads])
    del models, src
    c32, g32 = res["float32"]

    def rel(gs):
        return [float((a - c).norm() / c.norm().clamp_min(1e-30))
                for a, c in zip(gs, g32)]

    (cf, gf), (cr, gr) = res["flash"], res["reference"]
    rf, rr = rel(gf), rel(gr)
    ratio = max(a / max(b, 1e-12) for a, b in zip(rf, rr))
    del res, gf, gr, g32
    gc.collect()
    torch.cuda.empty_cache()
    out = {"loss_flash": cf, "loss_reference": cr, "loss_float32": c32,
           "loss_rel_err": abs(cf - c32) / abs(c32),
           "loss_rel_err_reference": abs(cr - c32) / abs(c32),
           "grad_rel_l2_max": max(rf),
           "grad_rel_l2_median": float(np.median(rf)),
           "grad_rel_l2_max_reference": max(rr), "grad_ratio_max": ratio}
    if not np.isfinite(cf) or out["loss_rel_err"] > LM_LOSS_RTOL or \
            ratio > LM_GRAD_RATIO:
        raise AssertionError(f"LM flash vs float32: {out}")
    return out


def run_main_path(modelfile, modelclass, want_launches, **cfg):
    """``BSP().init(devices=1, ...).wait()`` with every launch count set to
    0 just before and read just after; checks the costs, the params'
    device and the launch counts against ``want_launches``."""
    zero_launches()
    rule = BSP()
    rule.init(devices=1, modelfile=modelfile, modelclass=modelclass,
              epochs=1, synthetic_val_batches=VAL_BATCHES, seed=0, **cfg)
    t0 = time.time()
    rec = rule.wait()
    torch.cuda.synchronize()
    secs = time.time() - t0
    launches = launch_counts()
    costs = [r["cost"] for r in rec.train_records]
    if not costs or not all(np.isfinite(costs)):
        raise AssertionError(f"{modelclass} cost not finite: {costs}")
    if not all(np.isfinite(r["val_cost"]) for r in rec.epoch_records):
        raise AssertionError(f"validation cost: {rec.epoch_records}")
    devs = {p.device.type for p in tree_leaves(rule.model.params)}
    if devs != {"cuda"}:
        raise AssertionError(f"params on {devs}")
    if launches != want_launches:
        raise AssertionError(f"{modelclass} launches {launches}, expected "
                             f"{want_launches}")
    return rule.model, {"launches": launches, "costs": costs, "secs": secs,
                        "img_per_s": rec.train_records[-1]["images_per_sec"],
                        "val": rec.epoch_records[-1]}


def alexnet_main_path_phase():
    # two LRNs per forward (train steps + validation batches), per backward
    want = expect(lrn_fwd_cuda=2 * (STEPS + VAL_BATCHES),
                  lrn_bwd_cuda=2 * STEPS)
    _, out = run_main_path("theanompi_tpu_torch.models.alex_net", "AlexNet",
                           want, batch_size=BATCH, synthetic_batches=STEPS,
                           printFreq=STEPS // 2)
    return out


def lm_main_path_phase():
    """The LM under BSP: 8 Adam steps and a validation batch, launches
    counted.  Every layer's attention runs B10 forward (train and
    validation) and B11 + B12 backward."""
    n = LM_CFG["n_layer"]
    want = expect(flash_fwd_cuda=n * (LM_STEPS + VAL_BATCHES),
                  flash_bwd_dkv_cuda=n * LM_STEPS,
                  flash_bwd_dq_cuda=n * LM_STEPS)
    model, out = run_main_path(
        "theanompi_tpu_torch.models.transformer_lm", "TransformerLM", want,
        batch_size=LM_BATCH, synthetic_train=LM_BATCH * LM_STEPS,
        synthetic_val=LM_BATCH * VAL_BATCHES, printFreq=LM_STEPS // 2,
        **LM_CFG)
    out["n_params"] = sum(p.numel() for p in tree_leaves(model.params))
    out["tokens_per_s"] = out["img_per_s"] * LM_CFG["seq_len"]
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return out


# each VGG-16 main path's kernels, per training step: the onebit exchange
# runs B5, B6, B4; topk B7, B8; PowerSGD B9 once per factor pass, over all
# 16 compressible leaves; no path runs LRN or B3
VGG_PATHS = {
    "onebit": dict(pack_signs_encode_cuda=1, signed_residual_cuda=1,
                   unpack_signs_wsum_cuda=1),
    "topk": dict(topk_encode_cuda=1, topk_decode_cuda=1),
    "powersgd": dict(matmul_pack_group_cuda=2),
}


def state_tensors(state) -> list:
    """A strategy state's tensors (a flat tensor, or a per-leaf list)."""
    if isinstance(state, torch.Tensor):
        return [state]
    return [t for d in state for t in d.values()]


def vgg_main_path_phase(strategy: str, state_shape):
    """VGG-16 under ``strategy`` for VGG_STEPS steps: launch counts, and
    the strategy's state finite, on the card and nonzero (``state_shape``:
    the flat state's shape, or the number of leaves of a per-leaf one)."""
    want = expect(**{k: n * VGG_STEPS for k, n in VGG_PATHS[strategy].items()})
    model, out = run_main_path(
        "theanompi_tpu_torch.models.vggnet_16", "VGGNet_16", want,
        exch_strategy=strategy, batch_size=VGG_BATCH, learning_rate=VGG_LR,
        synthetic_batches=VGG_STEPS, printFreq=VGG_STEPS // 2)
    st = model.extra["strat"]
    ts = state_tensors(st)
    shape = tuple(st.shape) if isinstance(st, torch.Tensor) else len(st)
    if shape != state_shape or {t.device.type for t in ts} != {"cuda"} or \
            not all(bool(torch.isfinite(t).all()) for t in ts) or \
            not any(bool(t.any()) for t in ts):
        raise AssertionError(f"{strategy} state {shape} on "
                             f"{ {t.device.type for t in ts} }, finite "
                             f"{[bool(torch.isfinite(t).all()) for t in ts]}")
    out["state_abs_mean"] = float(sum(t.abs().sum() for t in ts)
                                  / sum(t.numel() for t in ts))
    del model, st, ts
    gc.collect()                 # the model and its exchanger refer to each other
    torch.cuda.empty_cache()
    return out


def exchange_sync_check(model) -> list:
    """One exchange of the model's strategy on a gradient-shaped tree under
    CUDA's sync debug mode: the warnings of every operation that made the
    host wait for the card (an ``.item()``, a copy to the host)."""
    grads = tree_map(torch.randn_like, model.params)
    strat = model.exchanger.strategy
    state = tree_map(torch.clone, model.extra["strat"])
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            strat(grads, state, size=1)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    # the warning each synchronizing operation raises in "warn" mode (the
    # mode's own notice that it is a prototype is not one)
    return [str(w.message)[:200] for w in caught
            if "called a synchronizing CUDA operation" in str(w.message)]


def step_profile_phase(modelfile, modelclass, batch, groups, steps, warmup=2,
                       after=None, **cfg):
    """Where a main-path step's time goes, after warm-up: host wall time per
    step (the step ends in a synchronize) and the recorder's host buckets,
    unprofiled; then the same steps under ``torch.profiler`` for device busy
    time per step, the device's idle share, the kernels by device time, and
    the per-step device time of each group of kernels (``groups``: label →
    name substrings).  ``after(model)`` runs at the end, its result kept."""
    from torch.profiler import ProfilerActivity, profile
    from theanompi_tpu_torch.utils.recorder import Recorder
    from theanompi_tpu_torch.worker import BSP_Worker
    worker = BSP_Worker(dict({"n_workers": 1, "batch_size": batch, "seed": 0,
                              "verbose": False}, **cfg))
    try:
        model = worker.build_model(modelfile, modelclass)
        model.compile_iter_fns(worker.exchanger)
        count = 0

        def run(n, rec=None):
            nonlocal count
            for _ in range(n):
                count += 1
                model.train_iter(count, rec)
            torch.cuda.synchronize()

        run(warmup)
        rec = Recorder({"verbose": False})
        t0 = time.time()
        run(steps, rec)
        wall_ms = (time.time() - t0) * 1e3 / steps
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run(steps)
        extra = after(model) if after else None
        del model
    finally:
        worker.close()
        gc.collect()
        torch.cuda.empty_cache()
    by_kernel = []
    for e in prof.key_averages():
        # device-side events only (kernels, copies): the CPU ops that
        # launched them carry the same time again
        t = getattr(e, "self_device_time_total", 0)
        if t > 0 and str(e.device_type).endswith("CUDA") and \
                not e.key.startswith("Activity Buffer"):
            by_kernel.append({"name": e.key[:240], "key": e.key,
                              "ms_per_step": t / 1e3 / steps,
                              "calls_per_step": e.count / steps})
    by_kernel.sort(key=lambda r: -r["ms_per_step"])
    busy = sum(r["ms_per_step"] for r in by_kernel)
    host = {s: rec.t_sec_total[s] * 1e3 / steps
            for s in ("load", "stage", "train")}
    out = {"model": modelclass, "batch": batch, "steps": steps,
           "wall_ms_per_step": wall_ms, "img_per_s": batch * 1e3 / wall_ms,
           "host_ms_per_step": host, "device_busy_ms_per_step": busy,
           "device_idle_share": max(0.0, 1.0 - busy / wall_ms),
           "top_kernels": [{k: v for k, v in r.items() if k != "key"}
                           for r in by_kernel[:15]]}
    for label, subs in groups.items():
        # matched on the whole kernel name (a template's tail included)
        out[f"{label}_ms_per_step"] = sum(
            r["ms_per_step"] for r in by_kernel
            if any(s in r["key"] for s in subs))
    if after:
        out["after"] = extra
    return out


def print_profile(p: dict, card: str, groups) -> None:
    print(f"{p['model']} step: {p['wall_ms_per_step']:.2f} ms wall "
          f"({p['img_per_s']:.1f} img/s), host "
          + ", ".join(f"{k} {v:.2f} ms" for k, v in
                      p["host_ms_per_step"].items())
          + f"; device busy {p['device_busy_ms_per_step']:.2f} ms, idle "
          f"share {p['device_idle_share']:.3f}; "
          + ", ".join(f"{g} {p[g + '_ms_per_step']:.3f} ms" for g in groups)
          + f" on {card}", flush=True)


# what each library yardstick computes, and what of the kernel's work it
# leaves out (B3–B6 have none: no single PyTorch call computes them)
LIBRARY = {
    "lrn_fwd": "F.local_response_norm on the NCHW view",
    "lrn_bwd": "autograd of F.local_response_norm (forward included)",
    "topk_encode": "torch.topk(c2.abs(), 82, dim=1): the selection alone, in "
                   "torch's tie order; no bf16 values, int16 offsets or "
                   "residual state",
    "topk_decode": "zero_() + one index_put_(accumulate=True) over all "
                   "workers' global indices: the scatter alone, atomics' "
                   "order; no bf16 cast, no index arithmetic, no / size",
    "matmul_pack": "torch.matmul (TF32 off) of the same operands, the "
                   "transposed one as a view: no zero-padded tile",
    "flash_fwd": "F.scaled_dot_product_attention(q, k, v, is_causal=True) "
                 "on the same views: o only, no lse",
    "flash_bwd_dkv": "autograd of F.scaled_dot_product_attention: dQ, dK and "
                     "dV in one call (di included), to set against B11 + B12",
    "flash_bwd_dq": "the same call as flash_bwd_dkv's: dQ, dK and dV in one",
}

FLASH_SRC = "theanompi_tpu_torch/csrc/flash_attention.cu"
FLASH_TPU = "jax/experimental/pallas/ops/tpu/flash_attention.py (jax 0.9.0)"


def kernel_rows():
    """(label, wrapper, source, TPU kernel it replaces) of B1–B12 (built
    at use: ``--factor-times`` also runs on trees from before
    ``matmul_pack_group_cuda``)."""
    return (
        ("lrn_fwd", lrn_ops.lrn_fwd_cuda, "theanompi_tpu_torch/csrc/lrn.cu",
         "theanompi_tpu/ops/lrn.py:130 _lrn_fwd_pallas"),
        ("lrn_bwd", lrn_ops.lrn_bwd_cuda, "theanompi_tpu_torch/csrc/lrn.cu",
         "theanompi_tpu/ops/lrn.py:152 _lrn_bwd_pallas"),
        ("pack_signs", cmp_ops.pack_signs_cuda,
         "theanompi_tpu_torch/csrc/compress.cu",
         "theanompi_tpu/ops/compress.py:200 _pack_pallas"),
        ("unpack_signs_wsum", cmp_ops.unpack_signs_wsum_cuda,
         "theanompi_tpu_torch/csrc/compress.cu",
         "theanompi_tpu/ops/compress.py:234 _unpack_wsum_pallas"),
        ("pack_signs_encode", cmp_ops.pack_signs_encode_cuda,
         "theanompi_tpu_torch/csrc/compress.cu",
         "theanompi_tpu/ops/compress.py:268 _encode_pallas"),
        ("signed_residual", cmp_ops.signed_residual_cuda,
         "theanompi_tpu_torch/csrc/compress.cu",
         "theanompi_tpu/ops/compress.py:307 _residual_pallas"),
        ("topk_encode", cmp_ops.topk_encode_cuda,
         "theanompi_tpu_torch/csrc/compress.cu",
         "theanompi_tpu/ops/compress.py:362 _topk_encode_pallas"),
        ("topk_decode", cmp_ops.topk_decode_cuda,
         "theanompi_tpu_torch/csrc/compress.cu",
         "theanompi_tpu/ops/compress.py:402 _topk_decode_pallas"),
        ("matmul_pack", fp_ops.matmul_pack_group_cuda,
         "theanompi_tpu_torch/csrc/factor_pack.cu",
         "theanompi_tpu/ops/factor_pack.py:66 _matmul_pack_pallas"),
        # JAX's packaged kernel, which theanompi_tpu/models/layers.py:459-464
        # calls for attn_impl='flash'
        ("flash_fwd", fa_ops.flash_fwd_cuda, FLASH_SRC,
         f"{FLASH_TPU}:589 _flash_attention_impl (pallas_call :758)"),
        ("flash_bwd_dkv", fa_ops.flash_bwd_dkv_cuda, FLASH_SRC,
         f"{FLASH_TPU}:941 _flash_attention_bwd_dkv (pallas_call :1121)"),
        ("flash_bwd_dq", fa_ops.flash_bwd_dq_cuda, FLASH_SRC,
         f"{FLASH_TPU}:1287 _flash_attention_bwd_dq (pallas_call :1456)"),
    )


TIMED = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
         "library_ms")


def kernel_entries(lrn, comp, topk, fpack, flash, alex, vggs, lm) -> list:
    out = []
    for label, fn, source, replaces in kernel_rows():
        name = fn.__name__
        e = {"name": label, "route": "cuda", "source": source,
             "replaces": replaces, "library": LIBRARY.get(label)}
        if label in DESIGN:
            e["design"] = DESIGN[label]
        if label.startswith("lrn_"):
            kind = label[4:]
            timed = [r for r in lrn[kind] if "ms" in r]
            tot = lambda k: sum(r[k] for r in timed)  # one step: lrn1 + lrn2
            e.update(launches=alex["launches"][name],
                     max_abs_err=max(r["max_abs_err"] for r in lrn[kind]),
                     ms=tot("ms"), plain_ms=tot("plain_ms"),
                     bound_ms=tot("bound_ms"),
                     bound_by="bytes" if tot("bytes_ms") >= tot("ops_ms")
                     else "operations",
                     library_ms=tot("library_ms"), shapes=lrn[kind])
        elif label == "matmul_pack":
            # per PowerSGD step: two grouped passes over the 16 leaves
            e.update(launches=vggs["powersgd"]["launches"][name],
                     launches_from="VGG-16 powersgd main path",
                     max_abs_err=fpack["max_abs_err"],
                     max_err_over_bound=fpack["max_err_over_bound"],
                     per="one step: 2 grouped launches, 32 products",
                     per_leaf_ms=fpack["per_step"]["per_leaf_ms"],
                     **{k: fpack["per_step"][k] for k in TIMED[1:]})
        elif label.startswith("flash_"):
            e.update(launches=lm["launches"][name],
                     launches_from="LM main path", shape=flash["shape"],
                     host_us=flash[name]["host_us"],
                     **{k: flash[name][k] for k in TIMED})
        elif label.startswith("topk_"):
            e.update(launches=vggs["topk"]["launches"][name],
                     launches_from="VGG-16 topk main path",
                     rows=topk["rows"], chunk=topk["chunk"], k=topk["k"],
                     **{k: topk[name][k] for k in TIMED})
            if label == "topk_decode":
                e["by_workers"] = topk["decode"]
        else:
            r = comp[name]
            if label == "pack_signs":
                # on no training path: the compress phase's check launch
                e.update(launches=comp["checked_launches"][name],
                         launches_from="compress phase")
            else:
                e.update(launches=vggs["onebit"]["launches"][name],
                         launches_from="VGG-16 onebit main path")
            e.update({k: r[k] for k in TIMED[:-1]}, library_ms=None,
                     n=comp["n"])
            if label == "unpack_signs_wsum":
                e["by_workers"] = comp["decode"]
        out.append(e)
    return out


def main() -> int:
    card = card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_all = time.time()
    libs = _kernel_build.build()
    build_s = time.time() - t_all
    print(f"built {sorted(libs)} in {build_s:.1f}s", flush=True)

    lrn = lrn_phase()
    comp = compress_phase()
    print("compress (n=%d): " % comp["n"] + ", ".join(
        f"{k[:-5]} {comp[k]['ms']:.4f} ms (bound {comp[k]['bound_ms']:.4f}, "
        f"plain {comp[k]['plain_ms']:.3f})" for k in
        ("pack_signs_cuda", "pack_signs_encode_cuda", "signed_residual_cuda",
         "unpack_signs_wsum_cuda")) + "; decode by W: " + ", ".join(
        f"{d['workers']}: {d['ms']:.4f} ms" for d in comp["decode"]),
        flush=True)
    topk = topk_phase(comp["n_true"])
    print(f"topk [{topk['rows']}, {topk['chunk']}] k={topk['k']}: encode "
          f"{topk['topk_encode_cuda']['ms']:.4f} ms (bound "
          f"{topk['topk_encode_cuda']['bound_ms']:.4f}, plain "
          f"{topk['topk_encode_cuda']['plain_ms']:.3f}, torch.topk "
          f"{topk['topk_encode_cuda']['library_ms']:.3f}); decode by W: "
          + ", ".join(f"{d['workers']}: {d['ms']:.4f} ms (bound "
                      f"{d['bound_ms']:.4f}, index_put_ "
                      f"{d['library_ms']:.4f})" for d in topk["decode"])
          + "; B7 radix select %.4f ms (the argmax passes, an earlier tree's "
            "run: %.4f ms)" % (
              topk["topk_encode_cuda"]["ms"],
              ARGMAX_TOPK["topk_encode_cuda"]["ms"]), flush=True)
    fpack = factor_pack_phase()
    st = fpack["per_step"]
    print(f"factor pack, one PowerSGD step (2 grouped launches, 32 "
          f"products): {st['ms']:.4f} ms (passes "
          + " + ".join(f"{p['ms']:.4f}" for p in fpack["passes"])
          + f"; 32 one-leaf launches {st['per_leaf_ms']:.4f}; bound "
          f"{st['bound_ms']:.4f}, plain {st['plain_ms']:.4f}, torch.matmul "
          f"{st['library_ms']:.4f}); max diff/bound "
          f"{fpack['max_err_over_bound']:.3f}; the per-leaf rowdot/coldot "
          f"kernels, an earlier tree's run: {ROWCOL_FACTOR['ms']:.4f} ms",
          flush=True)
    ref_err = alexnet_reference_phase()
    print(f"AlexNet f32 logits card vs CPU: max |diff| {ref_err:.3e}",
          flush=True)

    alex = alexnet_main_path_phase()
    print(f"main path: AlexNet BSP batch {BATCH}, {STEPS} steps, costs "
          f"{[round(c, 4) for c in alex['costs']]}, "
          f"{alex['img_per_s']:.1f} img/s on {card}", flush=True)
    alex_groups = {"lrn": ("lrn_",)}
    alex_prof = step_profile_phase("theanompi_tpu_torch.models.alex_net",
                                   "AlexNet", BATCH, alex_groups,
                                   PROFILE_STEPS)
    print_profile(alex_prof, card, alex_groups)

    vggs, profs = {}, {"alexnet": alex_prof}
    for strategy, shape, groups in (
            ("onebit", (comp["n"],),
             {"onebit_kernels": ("encode_kernel", "residual_kernel",
                                 "unpack_wsum_kernel"),
              "flatten_copy": ("CatArrayBatchedCopy",)}),
            ("topk", (topk["n"],),
             {"topk_kernels": ("topk_encode_kernel", "topk_decode_kernel"),
              # the JAX-order flatten (a copy per leaf) and the wire's
              # small packing copies
              "flatten_copy": ("direct_copy_kernel", "CatArrayBatchedCopy")}),
            ("powersgd", 32,
             {"factor_pack": ("factor_pack_kernel",),
              "qr": ("geqr", "orgqr", "ormqr", "larf", "householder")})):
        vggs[strategy] = vgg = vgg_main_path_phase(strategy, shape)
        print(f"main path: VGG-16 BSP {strategy} batch {VGG_BATCH}, "
              f"{VGG_STEPS} steps, costs "
              f"{[round(c, 4) for c in vgg['costs']]}, "
              f"{vgg['img_per_s']:.1f} img/s, launches "
              f"{ {k: v for k, v in vgg['launches'].items() if v} }",
              flush=True)
        profs[strategy] = prof = step_profile_phase(
            "theanompi_tpu_torch.models.vggnet_16", "VGGNet_16", VGG_BATCH,
            groups, PROFILE_STEPS, after=exchange_sync_check,
            exch_strategy=strategy, learning_rate=VGG_LR)
        print_profile(prof, card, groups)
        if strategy == "powersgd":
            # torch.linalg.qr's waits are a finding, printed and kept
            print(f"powersgd exchange: the host waited {len(prof['after'])} "
                  f"times: {prof['after'][:4]}", flush=True)
        elif prof["after"]:
            raise AssertionError(f"the {strategy} exchange made the host "
                                 f"wait: {prof['after']}")

    flash = flash_phase(libs["flash_attention"])
    print("flash SASS (per head dim 32, 64, 128): " + "; ".join(
        f"{k} " + ", ".join(f"{i} {n}" for i, n in c.items())
        for k, c in flash["sass"].items()), flush=True)
    print("flash attention %s bf16 causal: " % flash["shape"] + ", ".join(
        f"{k[:-5]} {flash[k]['ms']:.4f} ms (bound {flash[k]['bound_ms']:.4f}, "
        f"plain {flash[k]['plain_ms']:.3f}, SDPA {flash[k]['library_ms']:.4f}, "
        f"max |diff| {flash[k]['max_abs_err']:.3e})" for k in
        ("flash_fwd_cuda", "flash_bwd_dkv_cuda", "flash_bwd_dq_cuda"))
        + f"; di {flash['di_ms']:.4f} ms", flush=True)
    print("flash redesigned vs WMMA (an earlier tree's run): " + ", ".join(
        f"{k[:-5]} {flash[k]['ms']:.4f} ms (WMMA {r['ms']:.4f}), host "
        f"{flash[k]['host_us']:.1f} us a call (WMMA {r['host_us']} us)"
        for k, r in WMMA_FLASH.items())
        + "; B11 + B12 %.4f ms, SDPA backward %.4f ms" % (
            flash["flash_bwd_dkv_cuda"]["ms"] + flash["flash_bwd_dq_cuda"]["ms"],
            flash["flash_bwd_dq_cuda"]["library_ms"]), flush=True)
    lm_check = lm_check_phase()
    print(f"LM bf16 vs float32, batch {LM_CHECK_BATCH}: loss flash "
          f"{lm_check['loss_flash']:.6f}, reference "
          f"{lm_check['loss_reference']:.6f}, float32 "
          f"{lm_check['loss_float32']:.6f}; gradient relative L2 flash max "
          f"{lm_check['grad_rel_l2_max']:.3e}, reference max "
          f"{lm_check['grad_rel_l2_max_reference']:.3e}, worst leaf ratio "
          f"{lm_check['grad_ratio_max']:.3f}", flush=True)
    lm = lm_main_path_phase()
    print(f"main path: TransformerLM BSP flash batch {LM_BATCH}, {LM_STEPS} "
          f"steps, {lm['n_params']} params, costs "
          f"{[round(c, 4) for c in lm['costs']]}, "
          f"{lm['tokens_per_s']:.0f} tokens/s, launches "
          f"{ {k: v for k, v in lm['launches'].items() if v} } on {card}",
          flush=True)
    lm_groups = {"flash": ("flash_fwd_kernel", "flash_bwd_dkv_kernel",
                           "flash_bwd_dq_kernel")}
    profs["lm"] = lm_prof = step_profile_phase(
        "theanompi_tpu_torch.models.transformer_lm", "TransformerLM",
        LM_BATCH, lm_groups, PROFILE_STEPS,
        synthetic_train=LM_BATCH * (2 + 2 * PROFILE_STEPS), **LM_CFG)
    lm_prof["tokens_per_s"] = lm_prof["img_per_s"] * LM_CFG["seq_len"]
    print_profile(lm_prof, card, lm_groups)
    print(f"LM step: {lm_prof['tokens_per_s']:.0f} tokens/s", flush=True)

    kernels = kernel_entries(lrn, comp, topk, fpack, flash, alex, vggs, lm)
    total_s = time.time() - t_all
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"kernels": kernels, "compress": comp, "topk": topk,
                   "factor_pack": fpack, "flash": flash, "lm_check": lm_check,
                   "main": dict({"alexnet": alex, "lm": lm},
                                **{f"vgg16_{k}": v for k, v in vggs.items()}),
                   "profile": profs, "card": card, "build_s": build_s, "total_s": total_s,
                   "alexnet_ref_err": ref_err}, f, indent=1)
    print(f"all phases passed in {total_s:.1f}s", flush=True)
    print(json.dumps({"kernels": [
        {k: v for k, v in e.items() if k not in ("shapes", "by_workers")}
        for e in kernels]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    _flags = set(sys.argv[1:])
    if not _flags <= {"--flash-times", "--topk-times", "--factor-times"}:
        sys.exit(f"chip_smoke: unknown arguments {sorted(_flags)}")
    sys.exit(times_main(_flags) if _flags else main())
