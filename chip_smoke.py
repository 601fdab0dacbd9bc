"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

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
10. Prints ``{"kernels": [...]}``, then the card, then the last line
    ``{"ok": true, "device": {...}}``.

Any failed check raises: the script exits non-zero and prints no result.
TF32 is off for the whole run (float32 comparisons need it off; the main
paths compute in bfloat16 and are unaffected).
"""

import gc
import json
import os
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
from theanompi_tpu_torch.ops import lrn as lrn_ops  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet, at its 700 W limit): device memory
# rate, and float32 outside the tensor cores (the kernels' math is f32)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

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


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 10, inner: int = 10, warmup: int = 3) -> float:
    """Device time of one call: CUDA events around ``inner`` calls in a row
    (so the stream never waits on the host between them), divided by
    ``inner``; the median of ``reps`` such runs, after warm-up."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
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
    """Bit for bit (float tensors compared as their int32 bit patterns)."""
    g = got.view(torch.int32) if got.is_floating_point() else got
    w = want.view(torch.int32) if want.is_floating_point() else want
    if g.shape != w.shape or not torch.equal(g, w):
        raise AssertionError(f"{name}: kernel differs from the plain version "
                             f"in {int((g != w).sum())} elements")
    return 0.0


def bound(nbytes: float, flops: float) -> dict:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bytes_ms": t_bytes,
            "ops_ms": t_ops,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def zero_launches() -> None:
    for k in (lrn_ops.lrn_fwd_cuda, lrn_ops.lrn_bwd_cuda) + cmp_ops.KERNELS:
        k.launches = 0


def launch_counts() -> dict:
    return {k.__name__: k.launches for k in
            (lrn_ops.lrn_fwd_cuda, lrn_ops.lrn_bwd_cuda) + cmp_ops.KERNELS}


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


def decode_tol(w: int, scales: torch.Tensor):
    """(rtol, atol) of B4 against the plain decode: the kernel's
    Σ 2·s·bit − Σ s and the plain Σ ±s each round W times, every rounding
    at most half an ulp of a partial sum ≤ Σ 2s: atol 4·W·2⁻²⁴·Σ s, rtol
    one ulp.  Exactly equal at W = 1."""
    return 2.0 ** -23, 4 * w * 2.0 ** -24 * float(scales.sum())


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
            rtol, atol = decode_tol(w, scales)
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
    devs = {p.device.type for d in rule.model.params.values()
            for p in d.values()}
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
    want = dict({k.__name__: 0 for k in cmp_ops.KERNELS},
                lrn_fwd_cuda=2 * (STEPS + VAL_BATCHES), lrn_bwd_cuda=2 * STEPS)
    _, out = run_main_path("theanompi_tpu_torch.models.alex_net", "AlexNet",
                           want, batch_size=BATCH, synthetic_batches=STEPS,
                           printFreq=STEPS // 2)
    return out


def vgg_main_path_phase(n_padded: int):
    # the onebit exchange: B5, B6, B4 once per training step; no LRN, no B3
    want = {"lrn_fwd_cuda": 0, "lrn_bwd_cuda": 0, "pack_signs_cuda": 0,
            "pack_signs_encode_cuda": VGG_STEPS,
            "signed_residual_cuda": VGG_STEPS,
            "unpack_signs_wsum_cuda": VGG_STEPS}
    model, out = run_main_path(
        "theanompi_tpu_torch.models.vggnet_16", "VGGNet_16", want,
        exch_strategy="onebit", batch_size=VGG_BATCH, learning_rate=VGG_LR,
        synthetic_batches=VGG_STEPS, printFreq=VGG_STEPS // 2)
    ef = model.extra["strat"]
    if ef.shape != (n_padded,) or ef.device.type != "cuda" or \
            not bool(torch.isfinite(ef).all()) or not bool(ef.any()):
        raise AssertionError(f"error-feedback state {tuple(ef.shape)} on "
                             f"{ef.device}, finite "
                             f"{bool(torch.isfinite(ef).all())}")
    out["ef_abs_mean"] = float(ef.abs().mean())
    del model, ef
    gc.collect()                 # the model and its exchanger refer to each other
    torch.cuda.empty_cache()
    return out


def exchange_sync_check(model) -> list:
    """One onebit exchange of a gradient-shaped tree under CUDA's sync
    debug mode: the warnings of every operation that made the host wait
    for the card (an ``.item()``, a copy to the host).  None expected."""
    grads = {k: {n: torch.randn_like(p) for n, p in d.items()}
             for k, d in model.params.items()}
    strat = model.exchanger.strategy
    state = model.extra["strat"].clone()
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
            by_kernel.append({"name": e.key[:90],
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
           "top_kernels": by_kernel[:15]}
    for label, subs in groups.items():
        out[f"{label}_ms_per_step"] = sum(
            r["ms_per_step"] for r in by_kernel
            if any(s in r["name"] for s in subs))
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


# (label, wrapper, TPU kernel it replaces)
KERNEL_ROWS = (
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
)


def kernel_entries(lrn, comp, alex, vgg) -> list:
    out = []
    for label, fn, source, replaces in KERNEL_ROWS:
        e = {"name": label, "route": "cuda", "source": source,
             "replaces": replaces}
        if label.startswith("lrn_"):
            kind = label[4:]
            timed = [r for r in lrn[kind] if "ms" in r]
            tot = lambda k: sum(r[k] for r in timed)  # one step: lrn1 + lrn2
            e.update(launches=alex["launches"][fn.__name__],
                     max_abs_err=max(r["max_abs_err"] for r in lrn[kind]),
                     ms=tot("ms"), plain_ms=tot("plain_ms"),
                     bound_ms=tot("bound_ms"),
                     bound_by="bytes" if tot("bytes_ms") >= tot("ops_ms")
                     else "operations",
                     library_ms=tot("library_ms"), shapes=lrn[kind])
        else:
            r = comp[fn.__name__]
            if label == "pack_signs":
                # on no training path: the compress phase's check launch
                e.update(launches=comp["checked_launches"][fn.__name__],
                         launches_from="compress phase")
            else:
                e.update(launches=vgg["launches"][fn.__name__],
                         launches_from="VGG-16 onebit main path")
            e.update({k: r[k] for k in ("max_abs_err", "ms", "plain_ms",
                                        "bound_ms", "bound_by")},
                     library_ms=None, n=comp["n"])
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

    vgg = vgg_main_path_phase(comp["n"])
    print(f"main path: VGG-16 BSP onebit batch {VGG_BATCH}, {VGG_STEPS} "
          f"steps, costs {[round(c, 4) for c in vgg['costs']]}, "
          f"{vgg['img_per_s']:.1f} img/s, launches {vgg['launches']}",
          flush=True)
    vgg_groups = {"onebit_kernels": ("encode_kernel", "residual_kernel",
                                     "unpack_wsum_kernel"),
                  "flatten_copy": ("CatArrayBatchedCopy",)}
    vgg_prof = step_profile_phase(
        "theanompi_tpu_torch.models.vggnet_16", "VGGNet_16", VGG_BATCH,
        vgg_groups, PROFILE_STEPS, after=exchange_sync_check,
        exch_strategy="onebit", learning_rate=VGG_LR)
    print_profile(vgg_prof, card, vgg_groups)
    if vgg_prof["after"]:
        raise AssertionError("the onebit exchange made the host wait: "
                             f"{vgg_prof['after']}")

    kernels = kernel_entries(lrn, comp, alex, vgg)
    total_s = time.time() - t_all
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"kernels": kernels, "compress": comp,
                   "main": {"alexnet": alex, "vgg16_onebit": vgg},
                   "profile": {"alexnet": alex_prof, "vgg16_onebit": vgg_prof},
                   "card": card, "build_s": build_s, "total_s": total_s,
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
    sys.exit(main())
