"""Background prefetch pipeline: the parallel loader (config ``para_load``).

Counterpart of ``theanompi_tpu/models/data/prefetch.py``.  The reference
spawned a loader child per worker that loaded and augmented the next batch
and wrote it into the trainer's GPU buffer over CUDA IPC.  Here a producer
thread runs the host load + augment of the NEXT batches while the card
computes, and stages each onto the card itself (``device_put_fn``: a pinned
buffer and an asynchronous copy on a side stream, ``steps.put_batch``), so
the step takes a device-resident batch.  The handshake is a bounded queue:
depth 2 is double buffering.

Wrap any data object: ``data = PrefetchLoader(ImageNet_data(cfg))``; the
wrapper has the same surface (``next_train_batch``, ``next_val_batch``,
``shuffle_data``, ``n_batch_train``, ``n_batch_val``, the cursor).

``n_workers > 1``: when the wrapped object splits ``plan_train_batch`` /
``materialize`` (``ImageNet_data``), the producer draws the plans in order
(cursor and augmentation RNG stay exact) and a thread pool materializes
several at once (file reads and the native augment release the GIL).  The
queue holds the futures in plan order, so the stream is the serial one bit
for bit whatever the pool size.

Window mode (``set_window(k, stage_fn)``, wired by
``ModelBase.compile_iter_fns`` when ``steps_per_call = k > 1``): the
producer takes k sequential draws, stacks them on the host into one
``[k, ...]`` window (``steps.stack_host``) and stages it once, so the
queue holds whole windows and the step's thread only dequeues
(:meth:`next_train_window`).  The consumed cursor and the restarts then
count in windows, and an epoch drops its last ``n_batch_train % k``
batches, as the JAX package does.
"""

from __future__ import annotations

import queue
import threading
from typing import Optional

from ...parallel.steps import stack_host


class PrefetchLoader:
    """Double-buffered background loader over any DataBase-shaped object."""

    def __init__(self, data, depth: int = 2, device_put_fn=None,
                 n_workers: int = 1):
        self._data = data
        self.depth = depth
        self.n_workers = max(1, int(n_workers))
        self._device_put_fn = device_put_fn  # optional: stage onto the card
        self.window = 0                      # set_window: steps per window
        self._stage_window_fn = None
        self._q: Optional[queue.Queue] = None
        self._thread: Optional[threading.Thread] = None
        # per-producer stop event: a producer that outlives its join timeout
        # keeps seeing ITS flag set after a restart (a shared event cleared
        # for the new producer would revive it against the new queue)
        self._stop: Optional[threading.Event] = None
        self._consumed_cursor: dict = {}

    def set_window(self, k: int, stage_fn=None) -> None:
        """Produce whole windows of ``k`` steps (``k <= 1``: single batches
        again): k sequential draws (the cursor and the augmentation draws
        stay the serial stream's), one host stack, one
        ``stage_fn(window)`` (``None``: the window stays on the host).  The
        per-batch ``device_put_fn`` is not used while windows are on.  A
        running producer restarts from the last consumed position, so
        nothing it ran ahead with is lost or skipped."""
        k = int(k)
        was = (self.window, self._stage_window_fn)
        self.window = k if k > 1 else 0
        self._stage_window_fn = stage_fn if self.window else None
        if self._thread is not None and \
                (self.window, self._stage_window_fn) != was:
            self._shutdown()
            if self._consumed_cursor and hasattr(self._data, "set_cursor"):
                self._data.set_cursor(self.get_cursor())
            self._restart_producer()

    # -- passthrough surface -------------------------------------------------
    @property
    def n_batch_train(self):
        return self._data.n_batch_train

    @property
    def n_batch_val(self):
        return self._data.n_batch_val

    @property
    def batch_size(self):
        return self._data.batch_size

    @property
    def global_batch(self):
        return self._data.global_batch

    def __getattr__(self, name):
        # anything the wrapper does not define (img_mean and crop for the
        # u8 wire's mean, synthetic, ...); private names raise, which also
        # stops a recursion before __init__ has set _data
        if name.startswith("_"):
            raise AttributeError(name)
        return getattr(self._data, name)

    def shuffle_data(self, seed: int) -> None:
        """Called at each epoch's start: (re)starts the producer for the
        epoch's train batches."""
        self._shutdown()
        self._data.shuffle_data(seed)
        self._restart_producer()

    # -- checkpoint cursor ---------------------------------------------------
    # The producer runs ahead of training, so the wrapped object's cursor is
    # up to depth (+ n_workers) batches past what the step has taken.  Each
    # queue item carries the wrapped cursor as of just after its batch was
    # drawn; get_cursor reports the last one consumed.

    def get_cursor(self):
        c = dict(self._consumed_cursor)
        # validation is served on the consumer's thread: the wrapped
        # object's val_ptr is live
        if hasattr(self._data, "get_cursor"):
            c["val_ptr"] = self._data.get_cursor().get("val_ptr", 0)
        return c

    def set_cursor(self, cursor) -> None:
        """Reposition the stream.  A running producer restarts from the
        cursor; a loader whose producer has not started (a resume, before
        its ``shuffle_data``) stays synchronous, so no batch is drawn ahead
        (and no augmentation draw spent) that the next ``shuffle_data``
        would throw away."""
        running = self._q is not None
        self._shutdown()
        if hasattr(self._data, "set_cursor"):
            self._data.set_cursor(cursor)
        if running:
            self._restart_producer()
        else:
            self._consumed_cursor = self._data.get_cursor() \
                if hasattr(self._data, "get_cursor") else {}

    def _restart_producer(self) -> None:
        self._consumed_cursor = self._data.get_cursor() \
            if hasattr(self._data, "get_cursor") else {}
        n = self._data.n_batch_train
        # batches left in the epoch (ptr % n == 0: a fresh epoch)
        remaining = n - int(self._consumed_cursor.get("train_ptr", 0)) % n
        # the pooled producer's queue holds one future per batch in flight,
        # or its put would block the submit loop at depth + 1
        pooled = self.n_workers > 1 and hasattr(self._data,
                                                "plan_train_batch") \
            and not self.window
        self._q = queue.Queue(
            maxsize=self.depth + (self.n_workers if pooled else 0))
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._producer, args=(remaining, self._q, self._stop),
            name="para_load", daemon=True)
        self._thread.start()

    def next_train_batch(self, count: int):
        if self.window and self._q is not None:
            raise RuntimeError(
                f"window mode is on: the queue holds whole [{self.window}, "
                f"...] windows; take them with next_train_window (or "
                f"set_window(0) first)")
        if self._q is None:          # before the first shuffle_data
            batch = self._maybe_put(self._data.next_train_batch(count))
            if hasattr(self._data, "get_cursor"):
                self._consumed_cursor = self._data.get_cursor()
            return batch
        item = self._q.get()
        if isinstance(item, BaseException):
            raise item
        batch, cursor = item
        if hasattr(batch, "result"):     # pooled producer: an ordered future
            batch = batch.result()       # (raises materialize's error)
        # the cursor moves only once the batch is in hand: a failed
        # materialize does not count as consumed
        self._consumed_cursor = cursor
        return batch

    def next_train_window(self, count: int):
        """One whole window of ``window`` steps, staged when ``set_window``
        got a ``stage_fn``; ``count`` names its LAST step, as in
        ``train_iter``.  The consumed cursor moves by the window."""
        if not self.window:
            raise RuntimeError("set_window(k) with k > 1 first")
        if self._q is None:          # before the first shuffle_data
            k = self.window
            window = self._stage(stack_host(
                [self._data.next_train_batch(count - k + 1 + j)
                 for j in range(k)]))
            if hasattr(self._data, "get_cursor"):
                self._consumed_cursor = self._data.get_cursor()
            return window
        item = self._q.get()
        if isinstance(item, BaseException):
            raise item
        window, cursor = item
        self._consumed_cursor = cursor
        return window

    def next_val_batch(self, count: int):
        """Validation is served synchronously, on the caller's thread."""
        return self._maybe_put(self._data.next_val_batch(count))

    # -- producer ------------------------------------------------------------
    def _producer(self, n_batches: int, q: queue.Queue,
                  stop: threading.Event) -> None:
        # q and stop are THIS producer's own: a restart swaps self._q and
        # self._stop, and a slow old producer must not feed the new queue
        try:
            if self.window:
                self._producer_windows(n_batches, q, stop)
                return
            if self.n_workers > 1 and hasattr(self._data,
                                              "plan_train_batch"):
                self._producer_pooled(n_batches, q, stop)
                return
            for i in range(n_batches):
                if stop.is_set():
                    return
                batch = self._maybe_put(self._data.next_train_batch(i + 1))
                cursor = self._data.get_cursor() \
                    if hasattr(self._data, "get_cursor") else {}
                if stop.is_set():     # a restart raced the load: drop it
                    return
                q.put((batch, cursor))
        except BaseException as e:    # surfaced in the consumer
            q.put(e)

    def _producer_pooled(self, n_batches: int, q: queue.Queue,
                         stop: threading.Event) -> None:
        """Sequential plans, pooled materialization (and staging): at most
        ``depth`` queued + ``n_workers`` running batches in flight."""
        from concurrent.futures import ThreadPoolExecutor
        failed = []                   # a failed materialize ends the epoch,

        def on_done(f):               # as in the serial producer
            if not f.cancelled() and f.exception() is not None:
                failed.append(f)

        with ThreadPoolExecutor(self.n_workers,
                                thread_name_prefix="para_load") as pool:
            for i in range(n_batches):
                if stop.is_set() or failed:
                    return            # the consumer meets it at .result()
                plan = self._data.plan_train_batch(i + 1)
                cursor = self._data.get_cursor() \
                    if hasattr(self._data, "get_cursor") else {}
                fut = pool.submit(
                    lambda p: self._maybe_put(self._data.materialize(p)),
                    plan)
                fut.add_done_callback(on_done)
                if stop.is_set():
                    return
                q.put((fut, cursor))  # blocks at depth + n_workers

    def _producer_windows(self, n_batches: int, q: queue.Queue,
                          stop: threading.Event) -> None:
        """Whole windows: k sequential draws (plans, then a pooled
        materialize when the data object splits them and ``n_workers >
        1``), one host stack, one staging; the ``n_batches % k`` left over
        roll to the next epoch's shuffle."""
        from concurrent.futures import ThreadPoolExecutor
        k = self.window
        pooled = self.n_workers > 1 and hasattr(self._data,
                                                "plan_train_batch")
        pool = ThreadPoolExecutor(self.n_workers,
                                  thread_name_prefix="para_load") \
            if pooled else None
        try:
            for w in range(n_batches // k):
                if stop.is_set():
                    return
                if pooled:
                    plans = [self._data.plan_train_batch(w * k + j + 1)
                             for j in range(k)]
                    futs = [pool.submit(self._data.materialize, p)
                            for p in plans]
                    batches = [f.result() for f in futs]   # in order; raises
                else:
                    batches = [self._data.next_train_batch(w * k + j + 1)
                               for j in range(k)]
                cursor = self._data.get_cursor() \
                    if hasattr(self._data, "get_cursor") else {}
                window = self._stage(stack_host(batches))
                if stop.is_set():     # a restart raced the staging: drop it
                    return
                q.put((window, cursor))
        finally:
            if pool is not None:
                pool.shutdown(wait=False)

    def _stage(self, window):
        return self._stage_window_fn(window) if self._stage_window_fn \
            else window

    def _maybe_put(self, batch):
        return self._device_put_fn(batch) if self._device_put_fn else batch

    def _shutdown(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            self._stop.set()
            try:                      # drain, so the producer sees stop
                while True:
                    self._q.get_nowait()
            except queue.Empty:
                pass
            # a producer stuck longer in one load stays orphaned, but its
            # own stop event is set and it holds the OLD queue
            self._thread.join(timeout=5)
        self._thread = None
        self._q = None

    def close(self) -> None:
        """Stop the producer."""
        self._shutdown()

    def __del__(self):
        try:
            self._shutdown()
        except Exception:
            pass
