"""The port's ImageNet batch-file reader against the JAX package's
``ImageNet_data`` on files the test writes: ``.hkl`` (h5py), ``.npy`` and
``.npz`` batches in bc01, c01b and NHWC layouts, CHW / HWC / per-channel /
scalar means.  Both streams are made by the same draws and the same
float32 arithmetic (or the same uint8 gather under ``aug_wire_u8``), so
they are compared bit for bit, no tolerance."""

import os
import subprocess
import sys

import numpy as np
import pytest

from theanompi_tpu.models.data.imagenet import ImageNet_data as JImageNet
from theanompi_tpu_torch.models.data.imagenet import \
    ImageNet_data as TImageNet

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import torch_port_helper as helper  # noqa: E402

BS, HW, CROP = 4, 16, 13


def _pair(d, size=1, rank=0, **cfg):
    c = dict(data_dir=str(d), seed=5, **cfg)
    j = JImageNet(dict(c, size=size, process_count=1, process_index=0), BS,
                  crop=CROP)
    t = TImageNet(dict(c, size=size, rank=rank), BS, crop=CROP)
    return j, t


def _same(got, want, what):
    assert got.dtype == want.dtype and got.shape == want.shape, what
    if got.dtype == np.float32:
        got, want = got.view(np.int32), want.view(np.int32)
    np.testing.assert_array_equal(got, want, err_msg=what)


@pytest.mark.parametrize("fmt,layout", [("hkl", "bc01"), ("npy", "c01b"),
                                        ("npz", "nhwc"), ("npy", "bc01")])
@pytest.mark.parametrize("per_image", [False, True])
@pytest.mark.parametrize("wire_u8", [False, True])
def test_stream_bit_equal_to_jax_over_two_epochs(tmp_path, fmt, layout,
                                                 per_image, wire_u8):
    d = helper.write_imagenet_dir(tmp_path, hw=HW, layout=layout, fmt=fmt)
    j, t = _pair(d, aug_per_image=per_image, aug_wire_u8=wire_u8)
    assert not t.synthetic and t.n_batch_train == j.n_batch_train == 6
    for epoch in range(2):
        j.shuffle_data(epoch + 5)
        t.shuffle_data(epoch + 5)
        for i in range(t.n_batch_train):
            jb, tb = j.next_train_batch(i), t.next_train_batch(i)
            for k in ("x", "y"):
                _same(tb[k], jb[k], f"epoch {epoch} step {i} {k}")
        for i in range(t.n_batch_val):
            jb, tb = j.next_val_batch(i), t.next_val_batch(i)
            for k in ("x", "y"):
                _same(tb[k], jb[k], f"epoch {epoch} val {i} {k}")
    want_dtype = np.uint8 if wire_u8 else np.float32
    assert tb["x"].dtype == want_dtype and tb["x"].shape == (BS, CROP, CROP, 3)


@pytest.mark.parametrize("mean", ["chw", "hwc", "channel", "none"])
@pytest.mark.parametrize("per_image", [False, True])
def test_mean_kinds_bit_equal_to_jax(tmp_path, mean, per_image):
    d = helper.write_imagenet_dir(tmp_path, hw=HW, mean=mean)
    j, t = _pair(d, aug_per_image=per_image)
    if mean == "none":
        assert float(t.img_mean) == 122.0
    j.shuffle_data(9)
    t.shuffle_data(9)
    for i in range(3):
        _same(t.next_train_batch(i)["x"], j.next_train_batch(i)["x"],
              f"step {i}")
    _same(t.next_val_batch(0)["x"], j.next_val_batch(0)["x"], "val")


@pytest.mark.parametrize("per_image", [False, True])
@pytest.mark.parametrize("wire_u8", [False, True])
def test_rank_r_of_two_sees_block_r_of_the_jax_global_batch(
        tmp_path, per_image, wire_u8):
    d = helper.write_imagenet_dir(tmp_path, n_train=8, n_val=4, hw=HW)
    cfg = dict(aug_per_image=per_image, aug_wire_u8=wire_u8)
    j, t0 = _pair(d, size=2, rank=0, **cfg)
    _, t1 = _pair(d, size=2, rank=1, **cfg)
    assert t0.n_batch_train == j.n_batch_train == 4
    for o in (j, t0, t1):
        o.shuffle_data(3)
    for i in range(4):
        jb = j.next_train_batch(i)
        assert jb["y"].shape == (2 * BS,)
        for r, t in enumerate((t0, t1)):
            tb = t.next_train_batch(i)
            for k in ("x", "y"):
                _same(tb[k], jb[k][r * BS:(r + 1) * BS], f"{i} rank {r} {k}")
    jb = j.next_val_batch(0)
    for r, t in enumerate((t0, t1)):
        tb = t.next_val_batch(0)
        _same(tb["x"], jb["x"][r * BS:(r + 1) * BS], f"val rank {r}")


def test_validation_trims_its_short_last_batch(tmp_path):
    """Three ranks, two val files of four images: the JAX package trims the
    8-image global batch to 6 rows; rank r takes rows 2r, 2r + 1."""
    d = helper.write_imagenet_dir(tmp_path, n_train=3, n_val=2, hw=HW)
    j, _ = _pair(d, size=3)
    jb = j.next_val_batch(0)
    assert jb["y"].shape == (6,)
    for r in range(3):
        _, t = _pair(d, size=3, rank=r)
        assert t.n_batch_val == 1
        tb = t.next_val_batch(0)
        for k in ("x", "y"):
            _same(tb[k], jb[k][2 * r:2 * r + 2], f"rank {r} {k}")


@pytest.mark.parametrize("per_image", [False, True])
def test_cursor_round_trips_mid_epoch(tmp_path, per_image):
    d = helper.write_imagenet_dir(tmp_path, hw=HW)
    _, t = _pair(d, aug_per_image=per_image)
    t.shuffle_data(4)
    t.next_train_batch(1)
    t.next_train_batch(2)
    t.next_val_batch(2)
    cur = t.get_cursor()
    assert cur["train_ptr"] == 2 and cur["val_ptr"] == 1
    want = [t.next_train_batch(c) for c in (3, 4)]
    _, t2 = _pair(d, aug_per_image=per_image)
    t2.set_cursor(cur)
    assert t2.get_cursor()["train_ptr"] == 2
    for c, w in zip((3, 4), want):
        _same(t2.next_train_batch(c)["x"], w["x"], f"step {c}")
    # the JAX package resumes from the port's cursor to the same stream
    j, _ = _pair(d, aug_per_image=per_image)
    j.set_cursor(cur)
    _same(j.next_train_batch(3)["x"], want[0]["x"], "jax from port cursor")


def test_plan_and_materialize_split_the_serial_stream(tmp_path):
    d = helper.write_imagenet_dir(tmp_path, hw=HW)
    _, a = _pair(d, aug_per_image=True)
    _, b = _pair(d, aug_per_image=True)
    a.shuffle_data(1)
    b.shuffle_data(1)
    plans = [a.plan_train_batch(i) for i in range(4)]
    for p in reversed(plans):          # materialize in any order
        p["batch"] = a.materialize(p)
    for i, p in enumerate(plans):
        _same(p["batch"]["x"], b.next_train_batch(i)["x"], f"step {i}")


def test_synthetic_source_unchanged_without_batch_files(tmp_path):
    j, t = _pair(tmp_path, synthetic_batches=2, n_class=10)
    assert t.synthetic and j.synthetic
    _same(t.next_train_batch(0)["x"], j.next_train_batch(0)["x"], "train")
    _same(t.next_val_batch(0)["x"], j.next_val_batch(0)["x"], "val")


def test_npy_batches_need_no_h5py(tmp_path):
    """The card's machine has no h5py: reading ``.npy`` batch files must not
    import it (a fresh interpreter in which ``import h5py`` fails)."""
    d = helper.write_imagenet_dir(tmp_path, hw=HW)
    code = (
        "import sys; sys.modules['h5py'] = None\n"
        "from theanompi_tpu_torch.models.data.imagenet import ImageNet_data\n"
        f"t = ImageNet_data({{'data_dir': {str(d)!r}}}, {BS}, crop={CROP})\n"
        "t.shuffle_data(0); b = t.next_train_batch(0); t.next_val_batch(0)\n"
        "print(b['x'].shape)\n")
    repo = os.path.dirname(HERE)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120,
                       env=dict(os.environ, PYTHONPATH=repo))
    assert r.returncode == 0, r.stderr
    assert "(4, 13, 13, 3)" in r.stdout
