"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. Fails (exit 2, no result) without CUDA; prints the card's name and power
   limit as ``nvidia-smi`` reports them.
2. Builds every hand-written kernel of ``theanompi_tpu_torch/csrc`` with
   ``nvcc`` into ``build/kernels/`` (one compiler per source, in parallel).
3. Holds each kernel against its plain PyTorch version at the shapes the
   main path gives it, in float32 (TF32 off) and bfloat16, and times the
   kernel, the plain version, and the one PyTorch call that computes the
   same function (``F.local_response_norm``; timed here only, the port
   never calls it).
4. Holds full-width AlexNet's logits on the card (kernels) against the same
   weights on the CPU (plain versions), float32, batch 2.
5. Drives the main path: ``BSP().init(devices=1, modelfile=
   'theanompi_tpu_torch.models.alex_net', modelclass='AlexNet', ...)`` at
   batch 128, full width, bf16, a few steps, and checks the cost is finite,
   the params sit on the card and every kernel of the path was launched.
6. Profiles a few more steps: host wall and host buckets per step, device
   busy time, the device's idle share, the kernels by device time.
7. Prints ``{"kernels": [...]}``, then the card, then the last line
   ``{"ok": true, "device": {...}}``.

Any failed check raises: the script exits non-zero and prints no result.
TF32 is off for the whole run (float32 comparisons need it off; the main
path computes in bfloat16 and is unaffected).
"""

import json
import os
import subprocess
import sys
import time

import torch

if not torch.cuda.is_available():
    print("chip_smoke: CUDA is not available", file=sys.stderr)
    sys.exit(2)

import numpy as np  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from theanompi_tpu_torch import BSP  # noqa: E402
from theanompi_tpu_torch.ops import _kernel_build  # noqa: E402
from theanompi_tpu_torch.ops import lrn as lrn_ops  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet, at its 700 W limit): device memory
# rate, and float32 outside the tensor cores (the LRN math is f32 FMAs)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

BATCH = 128
STEPS = 8
VAL_BATCHES = 1
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
                t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
                t_ops = FLOPS_PER_ELEM[kind] * numel / F32_FLOPS_PER_S * 1e3
                out[kind].append({
                    "shape": label, "dims": list(shape), "dtype": dn,
                    "max_abs_err": e_f if kind == "fwd" else e_b,
                    "ms": time_ms(kern), "plain_ms": time_ms(plain),
                    "library_ms": time_ms(lib),
                    "bound_ms": max(t_bytes, t_ops),
                    "bytes_ms": t_bytes, "ops_ms": t_ops})
            del x, dy, xp, yp, dxp, xl, nchw, dyl
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


def main_path_phase():
    lrn_ops.lrn_fwd_cuda.launches = 0
    lrn_ops.lrn_bwd_cuda.launches = 0
    rule = BSP()
    rule.init(devices=1, modelfile="theanompi_tpu_torch.models.alex_net",
              modelclass="AlexNet", batch_size=BATCH, epochs=1,
              synthetic_batches=STEPS, synthetic_val_batches=VAL_BATCHES,
              printFreq=STEPS // 2, seed=0)
    t0 = time.time()
    rec = rule.wait()
    torch.cuda.synchronize()
    secs = time.time() - t0
    launches = {"fwd": lrn_ops.lrn_fwd_cuda.launches,
                "bwd": lrn_ops.lrn_bwd_cuda.launches}
    costs = [r["cost"] for r in rec.train_records]
    if not costs or not all(np.isfinite(costs)):
        raise AssertionError(f"main path cost not finite: {costs}")
    if not all(np.isfinite(r["val_cost"]) for r in rec.epoch_records):
        raise AssertionError(f"validation cost: {rec.epoch_records}")
    devs = {p.device.type for d in rule.model.params.values()
            for p in d.values()}
    if devs != {"cuda"}:
        raise AssertionError(f"params on {devs}")
    # two LRNs per forward (train steps + validation batches), per backward
    want = {"fwd": 2 * (STEPS + VAL_BATCHES), "bwd": 2 * STEPS}
    if launches != want:
        raise AssertionError(f"LRN launches {launches}, expected {want}")
    return {"launches": launches, "costs": costs, "secs": secs,
            "img_per_s": rec.train_records[-1]["images_per_sec"],
            "val": rec.epoch_records[-1]}


def step_profile_phase(steps: int = 6, warmup: int = 2):
    """Where a main-path step's time goes, after warm-up: host wall time per
    step (the step ends in a synchronize) and the recorder's host buckets,
    unprofiled; then the same steps under ``torch.profiler`` for device busy
    time per step, the device's idle share, and the kernels by device
    time."""
    from torch.profiler import ProfilerActivity, profile
    from theanompi_tpu_torch.utils.recorder import Recorder
    from theanompi_tpu_torch.worker import BSP_Worker
    worker = BSP_Worker({"n_workers": 1, "batch_size": BATCH, "seed": 0,
                         "verbose": False})
    try:
        model = worker.build_model("theanompi_tpu_torch.models.alex_net",
                                   "AlexNet")
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
    finally:
        worker.close()
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
    lrn = sum(r["ms_per_step"] for r in by_kernel if "lrn_" in r["name"])
    host = {s: rec.t_sec_total[s] * 1e3 / steps
            for s in ("load", "stage", "train")}
    return {"steps": steps, "wall_ms_per_step": wall_ms,
            "img_per_s": BATCH * 1e3 / wall_ms,
            "host_ms_per_step": host, "device_busy_ms_per_step": busy,
            "device_idle_share": max(0.0, 1.0 - busy / wall_ms),
            "lrn_ms_per_step": lrn, "top_kernels": by_kernel[:15]}


def main() -> int:
    card = card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.time()
    libs = _kernel_build.build()
    build_s = time.time() - t0
    print(f"built {sorted(libs)} in {build_s:.1f}s", flush=True)

    lrn = lrn_phase()
    ref_err = alexnet_reference_phase()
    print(f"AlexNet f32 logits card vs CPU: max |diff| {ref_err:.3e}",
          flush=True)
    main = main_path_phase()
    print(f"main path: AlexNet BSP batch {BATCH}, {STEPS} steps, costs "
          f"{[round(c, 4) for c in main['costs']]}, "
          f"{main['img_per_s']:.1f} img/s on {card}", flush=True)

    prof = step_profile_phase()
    print(f"step: {prof['wall_ms_per_step']:.2f} ms wall "
          f"({prof['img_per_s']:.1f} img/s), host "
          + ", ".join(f"{k} {v:.2f} ms" for k, v in
                      prof["host_ms_per_step"].items())
          + f"; device busy {prof['device_busy_ms_per_step']:.2f} ms, idle "
          f"share {prof['device_idle_share']:.3f}, LRN kernels "
          f"{prof['lrn_ms_per_step']:.3f} ms", flush=True)

    kernels = []
    for kind, name, fn, line in (
            ("fwd", "lrn_fwd", "_lrn_fwd_pallas", 130),
            ("bwd", "lrn_bwd", "_lrn_bwd_pallas", 152)):
        timed = [r for r in lrn[kind] if "ms" in r]
        tot = lambda k: sum(r[k] for r in timed)     # one step: lrn1 + lrn2
        kernels.append({
            "name": name, "route": "cuda",
            "source": "theanompi_tpu_torch/csrc/lrn.cu",
            "replaces": f"theanompi_tpu/ops/lrn.py:{line} {fn}",
            "launches": main["launches"][kind],
            "max_abs_err": max(r["max_abs_err"] for r in lrn[kind]),
            "ms": tot("ms"), "kernel_ms": tot("ms"),
            "plain_ms": tot("plain_ms"), "bound_ms": tot("bound_ms"),
            "bound_by": "bytes" if tot("bytes_ms") >= tot("ops_ms")
            else "operations",
            "library_ms": tot("library_ms"),
            "shapes": lrn[kind]})
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"kernels": kernels, "main": main, "profile": prof,
                   "card": card,
                   "build_s": build_s, "alexnet_ref_err": ref_err}, f,
                  indent=1)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
