"""The port's parallel loader (``models/data/prefetch.py``) and the
``para_load`` wiring, on the CPU: the serial and the pooled producers
yield the bare source's stream bit for bit, the checkpoint cursor is the
CONSUMED one, producer errors reach the consumer, ``shuffle_data``
restarts cleanly, and BSP training with ``para_load=True`` is bit-equal to
``para_load=False``.  No assert depends on timing: where the producer must
have run ahead, the test waits for it (up to a minute) and then asserts."""

import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from theanompi_tpu_torch.models.data.imagenet import ImageNet_data
from theanompi_tpu_torch.models.data.prefetch import PrefetchLoader
from theanompi_tpu_torch.parallel import steps

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import torch_port_helper as helper  # noqa: E402

BS, CROP = 4, 13


def _data(d, **cfg):
    return ImageNet_data(dict(data_dir=str(d), seed=2, **cfg), BS, crop=CROP)


def _wait_for(cond, secs=60.0):
    t0 = time.time()
    while not cond() and time.time() - t0 < secs:
        time.sleep(0.01)
    return cond()


@pytest.mark.parametrize("n_workers", [1, 3])
@pytest.mark.parametrize("per_image", [False, True])
def test_streams_bit_equal_to_the_bare_source(tmp_path, n_workers,
                                              per_image):
    d = helper.write_imagenet_dir(tmp_path, n_train=7)
    bare = _data(d, aug_per_image=per_image)
    loader = PrefetchLoader(_data(d, aug_per_image=per_image),
                            n_workers=n_workers)
    try:
        for epoch in range(2):
            bare.shuffle_data(epoch)
            loader.shuffle_data(epoch)
            for i in range(bare.n_batch_train):
                a = loader.next_train_batch(i + 1)
                b = bare.next_train_batch(i + 1)
                for k in ("x", "y"):
                    np.testing.assert_array_equal(a[k], b[k])
            np.testing.assert_array_equal(loader.next_val_batch(0)["x"],
                                          bare.next_val_batch(0)["x"])
    finally:
        loader.close()


def test_serves_synchronously_before_the_first_shuffle(tmp_path):
    d = helper.write_imagenet_dir(tmp_path)
    bare, loader = _data(d), PrefetchLoader(_data(d), n_workers=2)
    np.testing.assert_array_equal(loader.next_train_batch(1)["x"],
                                  bare.next_train_batch(1)["x"])
    assert loader._thread is None


@pytest.mark.parametrize("n_workers", [1, 2])
def test_consumed_cursor_trails_the_producer(tmp_path, n_workers):
    d = helper.write_imagenet_dir(tmp_path, n_train=8)
    inner = _data(d)
    loader = PrefetchLoader(inner, depth=2, n_workers=n_workers)
    try:
        loader.shuffle_data(0)
        loader.next_train_batch(1)
        loader.next_train_batch(2)
        # the producer runs ahead until the queue is full
        assert _wait_for(lambda: inner._train_ptr >= 4)
        assert loader.get_cursor()["train_ptr"] == 2
        cur = loader.get_cursor()
        want = [loader.next_train_batch(c)["x"] for c in (3, 4)]
        other = PrefetchLoader(_data(d), n_workers=n_workers)
        other.set_cursor(cur)
        for c, w in zip((3, 4), want):
            np.testing.assert_array_equal(other.next_train_batch(c)["x"], w)
        other.close()
    finally:
        loader.close()


class _Flaky:
    """A DataBase-shaped source whose batch ``bad`` (1-based, within the
    epoch) raises while ``fail`` is set."""

    n_batch_train, n_batch_val, batch_size, global_batch = 5, 1, 2, 2

    def __init__(self, bad, split):
        self.bad, self.fail, self.ptr = bad, True, 0
        if split:
            self.plan_train_batch = self._plan
            self.materialize = self._materialize

    def shuffle_data(self, seed):
        self.ptr = 0

    def get_cursor(self):
        return {"train_ptr": self.ptr}

    def set_cursor(self, c):
        self.ptr = int(c["train_ptr"])

    def _plan(self, count):
        self.ptr += 1
        return self.ptr

    def _materialize(self, i):
        if self.fail and i == self.bad:
            raise IOError(f"batch {i} unreadable")
        return {"x": np.full((2, 1), i, np.float32),
                "y": np.zeros(2, np.int32)}

    def next_train_batch(self, count):
        return self._materialize(self._plan(count))

    def next_val_batch(self, count):
        return self._materialize(0)


@pytest.mark.parametrize("split,n_workers", [(False, 1), (True, 3)])
def test_errors_surface_in_the_consumer_and_a_restart_recovers(split,
                                                               n_workers):
    src = _Flaky(bad=3, split=split)
    loader = PrefetchLoader(src, n_workers=n_workers)
    try:
        loader.shuffle_data(0)
        assert loader.next_train_batch(1)["x"][0, 0] == 1
        assert loader.next_train_batch(2)["x"][0, 0] == 2
        with pytest.raises(IOError, match="batch 3 unreadable"):
            loader.next_train_batch(3)
        # the failed batch is not counted as consumed
        assert loader.get_cursor()["train_ptr"] == 2
        src.fail = False
        loader.shuffle_data(1)
        got = [loader.next_train_batch(i)["x"][0, 0] for i in range(1, 6)]
        assert got == [1, 2, 3, 4, 5]
    finally:
        loader.close()
    assert loader._thread is None


def test_a_stale_producer_never_feeds_the_restarted_queue():
    """A producer blocked in a slow load when ``shuffle_data`` restarts the
    pipeline finishes its load after the restart and drops it."""
    gate = threading.Event()

    class Slow(_Flaky):
        def next_train_batch(self, count):
            gate.wait(30)
            return super().next_train_batch(count)

    src = Slow(bad=0, split=False)
    loader = PrefetchLoader(src, n_workers=1)
    loader.shuffle_data(0)
    old_q, old_thread = loader._q, loader._thread
    threading.Timer(0.2, gate.set).start()
    loader.shuffle_data(1)             # joins the old producer (≤ 5 s)
    old_thread.join(30)
    assert not old_thread.is_alive()
    assert old_q is not loader._q
    xs = [loader.next_train_batch(i)["x"][0, 0] for i in range(1, 6)]
    assert len(xs) == 5
    loader.close()


def test_window_mode_is_refused():
    """While window mode is on the queue holds whole windows: a per-batch
    draw is refused, not served from the middle of one; ``set_window(1)``
    returns the loader to single batches from the last consumed
    position."""
    loader = PrefetchLoader(_Flaky(bad=0, split=False))
    loader.set_window(1)
    assert loader.window == 0
    loader.set_window(2)
    loader.shuffle_data(0)
    w = loader.next_train_window(2)
    assert w["x"].shape == (2, 2, 1)
    assert w["x"][:, 0, 0].tolist() == [1.0, 2.0]
    with pytest.raises(RuntimeError, match="next_train_window"):
        loader.next_train_batch(3)
    loader.set_window(1)
    assert loader.next_train_batch(3)["x"][0, 0] == 3.0
    loader.close()


def test_cpu_staging_hands_the_step_tensors(tmp_path):
    d = helper.write_imagenet_dir(tmp_path)
    dev = torch.device("cpu")
    loader = PrefetchLoader(_data(d), n_workers=2,
                            device_put_fn=lambda b: steps.put_batch(b, dev))
    bare = _data(d)
    loader.shuffle_data(0)
    bare.shuffle_data(0)
    b = loader.next_train_batch(1)
    assert steps.is_device_batch(b)
    got = steps.claim(b, dev)
    assert isinstance(got["x"], torch.Tensor)
    np.testing.assert_array_equal(got["x"].numpy(),
                                  bare.next_train_batch(1)["x"])
    loader.close()


def test_put_batch_refuses_nothing_and_copies_nothing_on_the_cpu():
    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    b = steps.put_batch({"x": x}, torch.device("cpu"))
    assert steps.is_device_batch(b) and b.ready is None
    assert b["x"].data_ptr() == x.ctypes.data


@pytest.mark.parametrize("model,cfg", [
    ("TinyLRNNet", {}),
    ("TinyFileNet", {"aug_per_image": True}),
    ("TinyFileNet", {"aug_wire_u8": True, "para_load_workers": 2}),
])
def test_bsp_para_load_trajectory_bit_equal(tmp_path, model, cfg):
    """Two epochs of BSP at world 1 with and without ``para_load``: the
    same batches in the same order, so the same parameters, bit for bit."""
    if model == "TinyFileNet":
        cfg = dict(cfg, data_dir=helper.write_imagenet_dir(
            str(tmp_path), n_train=5, hw=16))
    runs = [helper.run_session(model, 2, para_load=p, **cfg).model
            for p in (False, True)]
    assert runs[1].data.__class__.__name__ == "PrefetchLoader"
    a, b = (helper.state_arrays(m) for m in runs)
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.cuda
def test_pinned_ring_stagings_arrive_bit_equal_on_card():
    """32 consecutive stagings from a producer thread through a ring of 3
    pinned slots, each copy queued behind a ~1 ms device sleep on the
    staging stream so the host writes far ahead of the copies: every batch
    reaches the card bit for bit (a slot rewritten before its copy ran
    would deliver another batch's bytes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import queue
    dev = torch.device("cuda", torch.cuda.current_device())
    stager = steps.PinnedStager(dev, slots=3)
    rng = np.random.default_rng(0)
    batches = [{"x": rng.standard_normal((256, 1024), np.float32),
                "y": np.full(256, i, np.int32)} for i in range(32)]
    q: "queue.Queue" = queue.Queue()

    def producer():
        for b in batches:
            with torch.cuda.device(dev), torch.cuda.stream(stager.stream):
                torch.cuda._sleep(2_000_000)
            q.put(stager.stage(b))

    t = threading.Thread(target=producer)
    t.start()
    got = []
    for _ in batches:
        staged = steps.claim(q.get(timeout=60), dev)
        got.append({k: v.clone() for k, v in staged.items()})
    t.join(60)
    assert not t.is_alive()
    torch.cuda.synchronize()
    for i, (g, b) in enumerate(zip(got, batches)):
        for k in b:
            np.testing.assert_array_equal(g[k].cpu().numpy(), b[k],
                                          err_msg=f"batch {i} {k}")
