"""The port's native augment pass (``theanompi_tpu_torch/native``) against
its NumPy path and against the JAX package's ``native.augment_batch``.

Both compute ``float32(uint8) - float32(mean)`` with no intermediate
rounding, a gather otherwise, so the comparisons are exact: bit for bit
(float32 compared as int32 bit patterns), no tolerance."""

import os

import numpy as np
import pytest

from theanompi_tpu import native as jnative
from theanompi_tpu_torch import native

N, H, W, C, CROP = 7, 20, 24, 3, 13


def _draws(rng, n, h, w, crop, per_image):
    m = n if per_image else 1
    oy = rng.randint(0, h - crop + 1, size=m).astype(np.int32)
    ox = rng.randint(0, w - crop + 1, size=m).astype(np.int32)
    flip = rng.randint(0, 2, size=m).astype(np.uint8)
    return oy, ox, flip


def _bits(a):
    return np.ascontiguousarray(a).view(np.int32)


@pytest.mark.parametrize("per_image", [False, True])
@pytest.mark.parametrize("layout", ["nhwc", "nchw"])
@pytest.mark.parametrize("mean_kind", ["image", "channel", "scalar"])
def test_native_bit_equal_to_numpy_and_to_jax(per_image, layout, mean_kind):
    rng = np.random.RandomState(0)
    x = rng.randint(0, 256, (N, H, W, C), dtype=np.uint8)
    if layout == "nchw":
        x = np.ascontiguousarray(x.transpose(0, 3, 1, 2))
    oy, ox, flip = _draws(rng, N, H, W, CROP, per_image)
    if mean_kind == "image":
        mean = rng.randn(CROP, CROP, C).astype(np.float32) * 10 + 120
    elif mean_kind == "channel":
        mean = np.broadcast_to(np.float32([123.68, 116.78, 103.94]),
                               (CROP, CROP, C))
    else:
        mean = None
    ms = 117.5 if mean is None else 0.0
    got = native.augment_batch(x, oy, ox, flip, CROP, mean=mean,
                               mean_scalar=ms)
    assert got.shape == (N, CROP, CROP, C) and got.dtype == np.float32
    bc = lambda a: np.broadcast_to(a, (N,))
    plain = native.augment_numpy(x, bc(oy), bc(ox), bc(flip), CROP,
                                 None if mean is None
                                 else np.ascontiguousarray(mean), ms)
    want = jnative.augment_batch(x, oy, ox, flip, CROP, mean=mean,
                                 mean_scalar=ms)
    np.testing.assert_array_equal(_bits(got), _bits(plain))
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_thread_counts_agree():
    rng = np.random.RandomState(1)
    x = rng.randint(0, 256, (16, 32, 32, C), dtype=np.uint8)
    oy, ox, flip = _draws(rng, 16, 32, 32, 27, True)
    runs = [native.augment_batch(x, oy, ox, flip, 27, n_threads=t)
            for t in (1, 3, 8, 64)]
    for r in runs[1:]:
        np.testing.assert_array_equal(_bits(r), _bits(runs[0]))


def test_library_lands_under_build_not_in_the_package():
    so = native.build()
    assert os.path.exists(so)
    assert os.sep + os.path.join("build", "native") + os.sep in so
    assert not any(f.endswith(".so") for f in
                   os.listdir(os.path.dirname(native.__file__)))


def test_build_failure_raises_with_the_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "loader.cc"
    bad.write_text("this is not C++;\n")
    monkeypatch.setattr(native, "SRC", str(bad))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.delenv("TMPI_NO_NATIVE", raising=False)
    with pytest.raises(RuntimeError, match="loader.cc failed"):
        native.get_lib()
    assert native._lib is None
    # no half-built library or temporary is left behind
    assert not list((tmp_path / "build").glob("*"))


def test_missing_compiler_raises(monkeypatch):
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    monkeypatch.delenv("CXX", raising=False)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.build()


def test_no_native_env_takes_the_numpy_path(monkeypatch):
    calls = []
    real = native.augment_numpy

    def spy(*a):
        calls.append(1)
        return real(*a)

    monkeypatch.setenv("TMPI_NO_NATIVE", "1")
    monkeypatch.setattr(native, "augment_numpy", spy)
    assert native.get_lib() is None
    rng = np.random.RandomState(2)
    x = rng.randint(0, 256, (3, 16, 16, C), dtype=np.uint8)
    out = native.augment_batch(x, 1, 2, 1, 9, mean_scalar=3.0)
    assert calls == [1]
    monkeypatch.delenv("TMPI_NO_NATIVE")
    np.testing.assert_array_equal(
        _bits(out), _bits(native.augment_batch(x, 1, 2, 1, 9,
                                               mean_scalar=3.0)))


@pytest.mark.parametrize("bad", ["dtype", "window", "mean"])
def test_bad_inputs_raise(bad):
    x = np.zeros((2, 16, 16, C), np.uint8)
    with pytest.raises(ValueError):
        if bad == "dtype":
            native.augment_batch(x.astype(np.float32), 0, 0, 0, 9)
        elif bad == "window":
            native.augment_batch(x, 8, 0, 0, 9)
        else:
            native.augment_batch(x, 0, 0, 0, 9,
                                 mean=np.zeros((8, 8, C), np.float32))
