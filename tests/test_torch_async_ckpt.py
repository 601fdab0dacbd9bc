"""``async_ckpt`` (``ModelBase.save`` / ``wait_pending_ckpt`` / ``load``,
the worker's join on the way out), as the JAX package has it
(``theanompi_tpu/models/model_base.py:1112-1147``,
``theanompi_tpu/worker.py:321-335``).

* The file an async save writes equals a synchronous save of the same
  count, array for array and in its ``.npy`` snapshot, although the CPU
  steps taken while the write is held back update the state in place
  (the host copies are made before the write's thread starts); it loads
  bit for bit.
* A failed write surfaces at the next join (``wait_pending_ckpt``, the
  next ``save``), as "async checkpoint write failed" from the write's
  error.  ``load`` waits for the write in flight.
* The worker's ``finally``: a pending write lands while a failing step
  unwinds the loop, its own failure then printed and never hiding the
  step's; on a clean exit a failed write raises.
"""

import os
import sys
import threading

import numpy as np
import pytest

from theanompi_tpu_torch.models import model_base as MB
from theanompi_tpu_torch.utils import checkpoint as ckpt

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import torch_port_helper as helper  # noqa: E402
from test_torch_alexnet_bsp import cpu_group  # noqa: E402,F401

SAVE = ckpt.save_checkpoint


def _held_writer(monkeypatch, gate: threading.Event, fail=None):
    """The checkpoint writer held until ``gate`` is set (then failing with
    ``fail`` if given)."""
    def write(*a, **k):
        assert gate.wait(60)
        if fail is not None:
            raise fail
        return SAVE(*a, **k)

    monkeypatch.setattr(MB.ckpt_lib, "save_checkpoint", write)


def _model(**cfg):
    m = helper.TinyLRNNet(dict({"device": "cpu", "verbose": False}, **cfg))
    m.compile_iter_fns()
    m.data.shuffle_data(0)
    return m


def _files(d, epoch=0):
    with np.load(os.path.join(d, f"ckpt_epoch{epoch}.npz")) as z:
        arrays = {k: z[k] for k in z.files}
    snap = os.path.join(d, f"params_epoch{epoch}")
    arrays.update({f"npy/{f}": np.load(os.path.join(snap, f))
                   for f in os.listdir(snap)})
    return arrays


def test_async_file_equals_a_sync_save_despite_later_steps(
        cpu_group, tmp_path, monkeypatch):
    sync_d, async_d = str(tmp_path / "sync"), str(tmp_path / "async")
    m = _model(async_ckpt=True)
    for c in (1, 2, 3):
        m.train_iter(c)
    want = helper.state_arrays(m)
    gate = threading.Event()
    m.config["async_ckpt"] = False
    m.save(sync_d, epoch=0, count=3)
    m.config["async_ckpt"] = True
    _held_writer(monkeypatch, gate)
    m.save(async_d, epoch=0, count=3)
    assert not os.path.exists(os.path.join(async_d, "ckpt_epoch0.npz"))
    for c in (4, 5):                     # in place, while the write waits
        m.train_iter(c)
    moved = helper.state_arrays(m)
    assert not np.array_equal(moved["params/conv/w"], want["params/conv/w"])
    gate.set()
    m.wait_pending_ckpt()
    a, b = _files(async_d), _files(sync_d)
    assert sorted(a) == sorted(b) and any(k.startswith("npy/") for k in a)
    for k in b:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    back = _model()
    assert back.load(async_d) == 0
    got = helper.state_arrays(back)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_a_failed_write_surfaces_at_the_next_join(cpu_group, tmp_path,
                                                  monkeypatch):
    m = _model(async_ckpt=True)
    m.train_iter(1)
    gate = threading.Event()
    gate.set()
    _held_writer(monkeypatch, gate, fail=OSError("disk full"))
    m.save(str(tmp_path), epoch=0, count=1)
    with pytest.raises(RuntimeError, match="async checkpoint write failed") \
            as e:
        m.wait_pending_ckpt()
    assert isinstance(e.value.__cause__, OSError)
    m.wait_pending_ckpt()                  # reported once
    m.save(str(tmp_path), epoch=0, count=1)
    with pytest.raises(RuntimeError, match="async checkpoint write failed"):
        m.save(str(tmp_path), epoch=1, count=1)     # the next save joins


def test_load_waits_for_the_write_in_flight(cpu_group, tmp_path,
                                            monkeypatch):
    m = _model(async_ckpt=True)
    for c in (1, 2):
        m.train_iter(c)
    want = helper.state_arrays(m)
    gate = threading.Event()
    _held_writer(monkeypatch, gate)
    m.save(str(tmp_path), epoch=0, count=2)
    m.train_iter(3)
    threading.Timer(0.3, gate.set).start()
    assert m.load(str(tmp_path)) == 0       # joins first, then reads
    got = helper.state_arrays(m)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _session(tmp_path, **cfg):
    return helper.run_session("FailingNet", 2, modelfile="torch_elastic_helper",
                              ckpt_dir=str(tmp_path / "ck"), async_ckpt=True,
                              **cfg)


def test_the_worker_lets_a_pending_write_land_while_unwinding(
        tmp_path, monkeypatch, capfd):
    gate = threading.Event()
    threading.Timer(0.5, gate.set).start()
    _held_writer(monkeypatch, gate)
    with pytest.raises(RuntimeError, match="a step failed"):
        _session(tmp_path)
    # the write of epoch 0 landed before the error left the worker
    assert ckpt.checkpoint_valid(str(tmp_path / "ck"), 0)
    gate = threading.Event()
    gate.set()
    _held_writer(monkeypatch, gate, fail=OSError("disk full"))
    with pytest.raises(RuntimeError, match="a step failed"):
        _session(tmp_path / "b")
    assert "async checkpoint ALSO failed during unwind" in \
        capfd.readouterr().err


def test_the_worker_raises_a_failed_write_on_a_clean_exit(tmp_path,
                                                          monkeypatch):
    gate = threading.Event()
    gate.set()
    _held_writer(monkeypatch, gate, fail=OSError("disk full"))
    with pytest.raises(RuntimeError, match="async checkpoint write failed"):
        helper.run_session("TinyLRNNet", 1, ckpt_dir=str(tmp_path / "ck"),
                           async_ckpt=True)
