"""The model contract.

Counterpart of ``theanompi_tpu/models/model_base.py``: a model exposes
``params``, ``data``, ``compile_iter_fns()``, ``train_iter(count,
recorder)``, ``val_iter(count, recorder)``, ``adjust_hyperp(epoch)``,
``scale_lr(size)``, ``epochs`` and ``n_subb``, and the worker loop drives any
object of that shape; ``kept_layout_paths()`` names the leaves its layers
keep in the JAX layout (the exchanger hands them to the wires).  Concrete
models define their layer stack, data object and hyperparameters; a
composite model (GoogLeNet's stages and aux heads, ResNet-50's trunk and
FC) names its parts in ``layers()`` and composes them in ``apply_model``.

``bn_state`` is the BatchNorm running state (``{}`` for a model without
BatchNorm): a tree of float32 tensors on the model's device, which
``apply_model``, ``loss_and_metrics`` and ``val_metrics`` take as the JAX
signatures do.  A training forward writes it in place; the step averages
it over the ranks after every update (``Exchanger.sync_bn``); validation
and checkpoints read it.

A model lives on ONE device, ``config['device']``: ``cuda`` unless the
caller asks for ``cpu``.  Without a card, a model that did not ask for the
CPU raises.  On the card the train step is a CUDA graph replay
(``parallel/steps.py``); ``steps_per_call = k`` runs k steps a call over a
``[k, ...]`` window, as the JAX package's scanned dispatch.
``para_load`` wraps the data object in the background loader
(``data/prefetch.py``), whose producer stages each batch, or each whole
window, onto the card; ``save``/``load`` checkpoint the state.

Under an async rule (EASGD, ASGD, GoSGD) every rank's replica, optimizer
state and BatchNorm stats are its own: the exchanger's exchange mixes the
params (after the step through the worker's hook at ``steps_per_call =
1``, ``exchange_fn``; inside the step's window otherwise), validation
scores the rule's canonical params (the center, or GoSGD's α-weighted
consensus) with the replica-mean running stats, and checkpoints keep
every rank's state.  ``ema_decay`` (BSP only) keeps an EMA shadow of the
params in the optimizer state, which validation and the ``.npy``
snapshot read.

Under BSP grads mode the update-plane state can be sharded over the ranks
(``compile_iter_fns`` wraps the optimizer in the JAX package's order, EMA
first): ``zero_opt`` keeps one flat chunk of the optimizer state per rank
(``parallel/zero.py``), ``update_sharding`` a chunk of each large leaf's
(``parallel/update_sharding.py``; also the EASGD and ASGD centers, in the
exchanger), and ``fsdp`` the parameters themselves as a flat chunk
(``parallel/fsdp.py``; ``params`` are then views of a buffer every step
gathers, and the ``params`` part of the state is the chunk).  Each is
bit-equal to the unsharded update; a sharded part is saved per rank, as
``BSP_Exchanger.identical_parts`` says.  The numerics plane of the JAX
package is not ported yet.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from ..base import resolve_device
from ..parallel import steps
from ..utils import checkpoint as ckpt_lib
from ..utils.helper_funcs import (tree_leaves, tree_map, tree_size,
                                  unflatten_like)
from ..utils import opt as opt_lib
from ..utils.opt import get_optimizer
from . import layers as L


class ModelBase:
    """Implements the model contract over a per-rank eager step."""

    batch_size: int = 128          # per rank, as in the reference
    epochs: int = 60
    n_subb: int = 1                # micro-batches per step (grad accum)
    learning_rate: float = 0.01
    momentum: float = 0.9
    weight_decay: float = 0.0001
    optimizer: str = "momentum"
    lr_adjust_epochs: tuple = ()   # epochs at which lr /= 10 (step schedule)
    seed: int = 42
    steps_per_call: int = 1        # training steps per train_iter call

    def __init__(self, config: Optional[dict] = None):
        self.config = dict(config or {})
        self.verbose = self.config.get("verbose", True)
        self.rank = int(self.config.get("rank", 0))
        self.size = int(self.config.get("size", 1))
        self.config.setdefault("rank", self.rank)
        self.config["size"] = self.size
        self.device = resolve_device(self.config)
        for k in ("batch_size", "epochs", "n_subb", "learning_rate", "seed",
                  "optimizer", "momentum", "weight_decay", "steps_per_call"):
            if k in self.config:
                setattr(self, k, self.config[k])
        if self.config.get("numerics"):
            raise NotImplementedError("config 'numerics' is not ported yet")
        self._refuse_sharding_keys()
        self.seed = int(self.config.get("seed", self.seed))
        self.current_lr = float(self.learning_rate)

        self.seq: L.Sequential = None
        self.data = None
        self.build_model()            # subclass hook: set self.seq, self.data
        if self.config.get("para_load", False) and self.data is not None:
            self._wrap_para_load()
        # the base of every step's dropout stream (steps.step_seed):
        # the role of the JAX package's step key; a checkpoint carries it
        self.step_seed = self.seed + 2

        gen = torch.Generator().manual_seed(self.seed)
        self.params = tree_map(
            lambda p: p.to(self.device).requires_grad_(True),
            self.init_params(gen))
        self.bn_state = tree_map(lambda s: s.to(self.device),
                                 self.init_bn_state())
        self.opt = get_optimizer(self.optimizer, mu=self.momentum,
                                 weight_decay=self.weight_decay) \
            if self.optimizer in ("momentum", "nesterov") \
            else get_optimizer(self.optimizer, weight_decay=self.weight_decay)
        if self.config.get("ema_decay"):
            self.opt = opt_lib.ema_wrap(self.opt,
                                        float(self.config["ema_decay"]))
        # the optimizer before any sharding wrapper, which compile_iter_fns
        # puts around it once the world size is known
        self._base_opt = self.opt
        self._zero_layout = None       # ZeRO-1's layout facts
        self._ushard_plan = None       # update_sharding's plan of the params
        self._fsdp = None              # FSDP's layout and storage
        self.opt_state = None
        self.extra = {}
        self.train_fn = None
        self.val_fn = None
        self.exchange_fn = None
        self.exchanger = None
        self._val = None
        self.current_info: Dict[str, Any] = {}

    def _refuse_sharding_keys(self) -> None:
        """The key combinations the JAX package refuses when it builds a
        model: ``update_sharding`` (under BSP) beside ``zero_opt``, ``fsdp``
        or ``ema_decay``, and ``fsdp`` beside ``zero_opt``."""
        c = self.config
        if c.get("update_sharding") and \
                str(c.get("rule", "bsp")).lower() == "bsp":
            for k, why in (
                    ("zero_opt", "update_sharding is the leaf-wise form of "
                                 "zero_opt: enable one, not both"),
                    ("fsdp", "fsdp already keeps the optimizer state on the "
                             "parameter chunk: drop update_sharding"),
                    ("ema_decay", "update_sharding does not carry the EMA "
                                  "shadow's chunked read: use zero_opt with "
                                  "ema_decay, or drop one")):
                if c.get(k):
                    raise ValueError(f"update_sharding with {k}: {why}")
        if c.get("fsdp") and c.get("zero_opt"):
            raise ValueError("fsdp with zero_opt: fsdp already keeps the "
                             "optimizer state on the parameter chunk; drop "
                             "zero_opt")

    def _plan_update(self, size: int):
        """``update_sharding``'s plan of the params under BSP at ``size``
        ranks, or None where it shards nothing (world 1, every leaf under
        ``ushard_min_bytes``, another rule: the async rules' moments are
        their own, and only their centers shard, in the exchanger)."""
        if not self.config.get("update_sharding") or size <= 1 or \
                str(self.config.get("rule", "bsp")).lower() != "bsp":
            return None
        from ..parallel import update_sharding as us
        plan = us.plan_tree(self.params, size, min_bytes=int(
            self.config.get("ushard_min_bytes", us.DEFAULT_MIN_BYTES)))
        return plan if plan.any_sharded else None

    def _shard_layouts(self, size: int, rank: int) -> None:
        """The optimizer wrapped for ``size`` ranks, this one ``rank``, in
        the JAX package's order (``ema_wrap`` already inside): ZeRO-1's
        flat chunk, or ``update_sharding``'s per-leaf chunks, or FSDP's
        parameter chunk (whose storage, on the first compile, replaces the
        params by views of its gathered buffer)."""
        self.opt, self._zero_layout = self._base_opt, None
        if self.config.get("zero_opt"):
            from ..parallel.zero import zero1
            self.opt = zero1(self.opt, size, self.params, rank)
            self._zero_layout = {"n": size, "shards": 1,
                                 "local_total": tree_size(self.params)}
        elif self._ushard_plan is not None:
            from ..parallel.update_sharding import shard_opt
            self.opt = shard_opt(self.opt, self._ushard_plan, rank)
        if self.config.get("fsdp"):
            from ..parallel.fsdp import FsdpLayout
            if self._fsdp is None:
                layout = FsdpLayout(self.params, size, rank)
                layout.attach(self.params, self.device)
                self._fsdp, self.params = layout, layout.params
            elif (self._fsdp.n_workers, self._fsdp.rank) != (size, rank):
                raise NotImplementedError(
                    f"fsdp laid out for rank {self._fsdp.rank} of "
                    f"{self._fsdp.n_workers}, compiled for rank {rank} of "
                    f"{size}: a refit onto another world is not ported yet "
                    f"(A10)")

    def _wrap_para_load(self) -> None:
        """The reference's ``para_load=True``: a background loader whose
        producer (``para_load_workers`` threads for file-based data, 4 by
        default) loads, augments and stages each batch onto the card ahead
        of the step, through a ring of pinned buffers on a side stream; the
        step takes the batch on the device."""
        from .data.prefetch import PrefetchLoader
        workers = int(self.config.get("para_load_workers", 4))
        depth = 2
        cuda = self.device.type == "cuda"
        stager = steps.PinnedStager(self.device, slots=depth + workers + 1) \
            if cuda else None
        # whole windows are staged one at a time: the queued ones, the one
        # being staged and the one the step copies from
        window_stager = steps.PinnedStager(self.device, slots=depth + 2) \
            if cuda else None
        self._stage_window = lambda w: steps.put_batch(w, self.device,
                                                       window_stager)
        self.data = PrefetchLoader(
            self.data, depth=depth, n_workers=workers,
            device_put_fn=lambda b: steps.put_batch(b, self.device, stager))

    # -- subclass hooks ----------------------------------------------------

    def build_model(self) -> None:
        raise NotImplementedError

    def layers(self) -> Dict[str, L.Layer]:
        """The top-level layers by their key in ``params``: ``self.seq``'s,
        or a composite model's parts."""
        assert self.seq is not None, "build_model() must set self.seq or " \
                                     "override layers() and apply_model()"
        return self.seq.sublayers()

    def init_params(self, gen: torch.Generator):
        return L.init_parts(self.layers(), gen)

    def init_bn_state(self):
        """The running state of the model's BatchNorm layers (``{}`` if it
        has none), float32, on the CPU."""
        return L.init_state_parts(self.layers())

    def kept_layout_paths(self) -> frozenset:
        """Paths of the parameter leaves that the JAX package stores in the
        port's layout (each ``Layer`` names its own, ``kept_layout``): the
        set ``convert.py`` and the topk and PowerSGD wires take, where every
        other 2-D weight is the JAX one transposed."""
        return frozenset((k,) + p for k, layer in self.layers().items()
                         for p in layer.kept_layout_paths())

    def apply_model(self, params, x, *, train: bool, gen, state):
        """Returns logits; a training forward updates ``state`` (the BN
        running stats) in place."""
        return self.seq.apply(params, x, train=train, gen=gen, state=state)

    def _label_smoothing(self, train: bool) -> float:
        return float(self.config.get("label_smoothing", 0.0)) if train \
            else 0.0

    def _u8_input_mean(self, device: torch.device) -> torch.Tensor:
        """The mean a uint8 batch loses on the card: the mean image's
        centre window, or the scalar (per-channel) mean, float32, made once
        per device.  For a shared crop window with a full mean image this
        is the JAX package's documented deviation from the host pass, which
        subtracts the window's own mean (``data/imagenet.py``)."""
        cache = self.__dict__.setdefault("_u8_mean", {})
        m = cache.get(device)
        if m is None:
            mi = getattr(self.data, "img_mean", np.float32(122.0))
            if isinstance(mi, np.ndarray) and mi.ndim == 3:
                c = int(getattr(self.data, "crop", mi.shape[0]))
                cy, cx = (mi.shape[0] - c) // 2, (mi.shape[1] - c) // 2
                mi = mi[cy:cy + c, cx:cx + c, :]
            m = cache[device] = torch.as_tensor(
                np.ascontiguousarray(mi, np.float32), device=device)
        return m

    def stage_input(self, x: torch.Tensor) -> torch.Tensor:
        """Input staging shared by every loss and metrics path: a uint8
        batch (``aug_wire_u8``) is cast and has the mean subtracted here,
        in float32, the host pass's arithmetic; other inputs pass as they
        are."""
        if x.dtype == torch.uint8:
            return x.to(torch.float32) - self._u8_input_mean(x.device)
        return x

    def loss_and_metrics(self, params, bn_state, batch, gen, train: bool):
        """Default head: softmax cross-entropy + top-1 error."""
        logits = self.apply_model(params, self.stage_input(batch["x"]),
                                  train=train, gen=gen, state=bn_state)
        cost = L.softmax_cross_entropy(logits, batch["y"],
                                       self._label_smoothing(train))
        return cost, L.errors(logits, batch["y"])

    def val_metrics(self, params, bn_state, batch):
        logits = self.apply_model(params, self.stage_input(batch["x"]),
                                  train=False, gen=None, state=bn_state)
        cost = L.softmax_cross_entropy(logits, batch["y"])
        return cost, (L.errors(logits, batch["y"]),
                      L.errors_top_x(logits, batch["y"], 5))

    def load_params(self, tree) -> None:
        """Overwrite the parameters from a tree of arrays in the port's
        layout (numpy or tensors; ``convert.py`` makes one from JAX)."""
        with torch.no_grad():
            tree_map(lambda p, v: p.copy_(torch.as_tensor(np.asarray(v))),
                     self.params, tree)
        if self._fsdp is not None:
            self._fsdp.load_full()

    def live_params(self):
        """The parameters as the step last left them: ``params``, or under
        FSDP every rank's chunk gathered (a collective: every rank
        calls)."""
        if self._fsdp is None:
            return self.params
        return self._full_of(self._fsdp.shard)

    def _full_of(self, chunk):
        """A params-shaped tree of every rank's ``chunk`` of the flat layout
        (ZeRO-1's or FSDP's), gathered into a new buffer: a collective, a
        copy at world 1 (also once the session's group is gone)."""
        fs = self._fsdp
        n = fs.n_workers if fs is not None else self._zero_layout["n"]
        full = chunk.new_empty(chunk.numel() * n)
        if n == 1:
            full.copy_(chunk)
        else:
            from ..parallel.update_sharding import all_gather_into
            all_gather_into(full, chunk)
        return fs._tree(fs.views(full)) if fs is not None \
            else unflatten_like(self.params, full)

    def host_params(self):
        """The parameters as a tree of float32 numpy arrays
        (:meth:`live_params`)."""
        return tree_map(lambda p: p.detach().cpu().numpy(),
                        self.live_params())

    def unsharded_opt_state(self):
        """The optimizer state in the unsharded layout (a collective under
        a sharded one): ZeRO-1's and FSDP's ``[chunk]`` leaves gathered into
        params-shaped trees, ``update_sharding``'s chunks rebuilt into their
        leaves, scalars (step counts) as they are; the state itself when
        nothing is sharded."""
        st = self.opt_state
        if self._ushard_plan is not None:
            from ..parallel.update_sharding import unshard_tree
            plan, like = self._ushard_plan, self.params

            def rebuild(sub):
                if isinstance(sub, dict) and set(sub) == set(like) and all(
                        l.dim() for l in tree_leaves(sub)):
                    return unshard_tree(sub, plan)
                if isinstance(sub, dict):
                    return {k: rebuild(v) for k, v in sub.items()}
                return sub

            return rebuild(st["opt"])
        if self._zero_layout is None and self._fsdp is None:
            return st
        if self._zero_layout is not None:
            st = st["opt"]
        return tree_map(lambda x: self._full_of(x) if x.dim() else x, st)

    def load_bn_state(self, tree) -> None:
        """Overwrite the BN running state in place from a tree of arrays
        (``convert.bn_state_from_jax`` makes one from JAX)."""
        with torch.no_grad():
            tree_map(lambda s, v: s.copy_(torch.as_tensor(np.asarray(v))),
                     self.bn_state, tree)

    def host_bn_state(self):
        """The BN running state as a tree of float32 numpy arrays (copies:
        the next training forward rewrites the tensors)."""
        return tree_map(lambda s: s.to("cpu", copy=True).numpy(),
                        self.bn_state)

    # -- contract: compile -------------------------------------------------

    def compile_iter_fns(self, exchanger=None,
                         capture: Optional[bool] = None) -> None:
        """Build the train and val steps.  Needs the process group that
        ``base.MeshProcess`` sets up (world size 1 included), unless the
        exchanger is an async island's, which runs no collective.  The train
        step takes ``steps_per_call`` steps a call; on the card it is
        captured into a CUDA graph, unless ``capture=False`` asks for the
        eager step (a comparison or a debugging run: no config key selects
        it, and nothing falls back to it).  Under ``para_load`` with
        ``steps_per_call > 1`` the loader's producer stages whole windows
        (``para_load_window``, default true, as in the JAX package)."""
        import torch.distributed as dist
        from ..parallel.exchanger import BSP_Exchanger
        exchanger = exchanger or BSP_Exchanger(self.config)
        if exchanger.collective and not dist.is_initialized():
            raise RuntimeError("no torch.distributed process group: build the "
                               "model through a Worker or "
                               "base.MeshProcess.get_internode_comm()")
        self.exchanger = exchanger
        size, rank = (dist.get_world_size(), dist.get_rank()) \
            if exchanger.collective else (1, 0)
        self._ushard_plan = self._plan_update(size)
        grads_mode = isinstance(self.exchanger, BSP_Exchanger) and \
            self.exchanger.mode == "grads"
        strategy = getattr(self.exchanger, "strategy", None)
        got = (f"got {type(self.exchanger).__name__} mode="
               f"{getattr(self.exchanger, 'mode', '-')} strategy="
               f"{getattr(strategy, 'name', '-')}")
        if self.config.get("fsdp"):
            # the gradient's reduction IS the reduce-scatter: any other
            # strategy, and a bucketed wire, would be ignored silently
            if not (grads_mode and strategy.name == "allreduce"):
                raise ValueError("fsdp requires BSP grads mode with the "
                                 f"'allreduce' strategy; {got}")
            if self.exchanger.bucket_bytes:
                raise ValueError("fsdp has no exchanger wire to bucket (the "
                                 "gradient arrives by its reduce-scatter): "
                                 "drop bucket_bytes")
        which = "zero_opt" if self.config.get("zero_opt") else (
            "ema_decay" if self.config.get("ema_decay") else (
                "update_sharding" if self._ushard_plan is not None else None))
        if which and not (grads_mode and strategy.name != "none"):
            # a chunk, or the shadow of one replica, only means something
            # when every rank applies the same reduced gradient
            raise ValueError(f"{which} requires BSP grads mode with a "
                             f"gradient collective; {got}")
        self._shard_layouts(size, rank)
        self.exchanger.prepare(self, size)
        self.opt_state = self.opt.init(
            self.params if self._fsdp is None else
            torch.zeros(self._fsdp.chunk, dtype=torch.float32,
                        device=self.device))
        self.extra = self.exchanger.extra_state_template()
        spc = int(self.steps_per_call)
        if spc < 1:
            raise ValueError(f"steps_per_call={spc} must be at least 1")
        # the exchange cadence runs inside the window at spc > 1; set on
        # every compile, so a recompile back to one step a call clears it
        self.exchanger.fused = spc > 1 and self.exchanger.has_exchange()
        if spc > 1 and self.data is not None and \
                spc > self.data.n_batch_train:
            raise ValueError(f"steps_per_call={spc} exceeds n_batch_train="
                             f"{self.data.n_batch_train}: every epoch would "
                             f"train zero steps")
        if hasattr(self.data, "set_window"):
            # re-wired on every compile, so a recompile back to one step a
            # call returns the loader to per-batch production
            if spc > 1 and self.config.get("para_load_window", True):
                self.data.set_window(spc, self._stage_window)
            else:
                self.data.set_window(0)
        self.train_fn = steps.build_train_step(self, self.exchanger,
                                               n_steps=spc, capture=capture)
        self.exchange_fn = \
            steps.ExchangeStep(self, self.exchanger, capture) \
            if self.exchanger.has_exchange() and spc == 1 else None
        self.val_fn = steps.build_val_step(self)

    # -- contract: iteration -----------------------------------------------

    def train_iter(self, count: int, recorder=None) -> None:
        """One call of the train step: one training step, or
        ``steps_per_call`` of them (``count`` then names the LAST step of
        the call).  Recorder buckets, as the JAX package defines them:
        ``load`` = waiting on the data source (under ``para_load`` the wait
        at the dequeue alone), ``stage`` = host → device on the step's
        thread (under ``para_load`` the compute stream's wait on the
        producer's copy and, for a captured step, the copy into its static
        buffers on the card), ``train`` = enqueueing the step (one graph
        replay on the card; metrics stay on the device until printed);
        with ``sync_each_iter`` the blocking read of the metrics lands in
        ``wait``, so the buckets add up to the wall time."""
        k = int(self.steps_per_call)
        window = k > 1 and getattr(self.data, "window", 0) == k
        if recorder:
            recorder.start()
        if k == 1:
            batch = self.data.next_train_batch(count)
        elif window:
            batch = self.data.next_train_window(count)
        else:
            batch = [self.data.next_train_batch(count - k + 1 + j)
                     for j in range(k)]
        if recorder:
            recorder.end("load")
            recorder.start()
        inputs = self.train_fn.take(batch)
        if recorder:
            recorder.end("stage")
            recorder.start()
        cost, err = self.train_fn(inputs, self.current_lr, count)
        cost, err = (cost[0], err[0]) if k == 1 else (cost.mean(), err.mean())
        if recorder:
            recorder.end("train")
        if self.config.get("sync_each_iter", False):
            # the reference's blocking loop: the device's remainder of the
            # step lands in ``wait``
            if recorder:
                recorder.start()
            cost, err = float(cost), float(err)
            if recorder:
                recorder.end("wait")
        if recorder:
            # images of the global batch: every rank steps in lockstep
            y = batch[0]["y"] if isinstance(batch, list) else batch["y"]
            rows = int(y.shape[1] if window else y.shape[0])
            recorder.train_error(count, cost, err, rows * k * self.size)
        self.current_info.update(cost=cost, error=err)

    def _take(self, batch):
        """A batch as the step's tensors: a staged one claimed for the
        compute stream, a host one copied."""
        if steps.is_device_batch(batch):
            return steps.claim(batch, self.device)
        return steps.put_batch(batch, self.device)

    def canonical_params(self):
        """The parameters validation, inference and the ``.npy`` snapshot
        use: an async rule's canonical params (the center; GoSGD's
        α-weighted consensus, a collective), the EMA shadow (the live
        params before its first update), or the replica itself."""
        if self.exchanger is not None and self.exchanger.has_exchange():
            return self.exchanger.canonical_params()
        if self.config.get("ema_decay") and self.opt_state is not None:
            return self._ema_params()
        return self.live_params()

    def _ema_params(self):
        """The EMA shadow as a params-shaped tree (the live params before
        its first update): under ZeRO-1 and FSDP the shadow is a chunk, and
        every rank's is gathered here (a collective)."""
        st = self.opt_state
        if self._zero_layout is not None:
            st = st["opt"]
        elif self._fsdp is None:
            return opt_lib.ema_params(st, self.params)
        if int(st["t"]) == 0:
            return self.live_params()
        return self._full_of(st["ema"])

    def canonical_host_params(self):
        """:meth:`canonical_params` as a tree of float32 numpy arrays."""
        return tree_map(lambda p: p.detach().cpu().numpy(),
                        self.canonical_params())

    def begin_val(self) -> None:
        """Choose what validation scores: :meth:`canonical_params`, with,
        under an async rule, the running stats' mean over the ranks (new
        tensors: the training replicas are never written)."""
        bn = self.bn_state
        if self.exchanger is not None and self.exchanger.has_exchange() \
                and tree_leaves(bn):
            from ..parallel.exchanger import summed
            mean = summed(tree_leaves(bn))
            torch._foreach_div_(mean, float(self.size))
            it = iter(mean)
            bn = tree_map(lambda _: next(it), bn)
        self._val = (self.canonical_params(), bn)

    def val_params(self):
        """``(params, bn_state)`` the validation step scores: what
        :meth:`begin_val` chose, else the replica's own."""
        if self._val is None:
            self.begin_val()
        return self._val

    def val_iter(self, count: int, recorder=None) -> None:
        if recorder:
            recorder.start()
        batch = self._take(self.data.next_val_batch(count))
        cost, err, err5 = (float(v) for v in self.val_fn(batch))
        if recorder:
            recorder.end("val")
            recorder.val_error(count, cost, err, err5)

    def end_val(self) -> None:
        self._val = None

    # -- contract: hyperparameters ----------------------------------------

    def adjust_hyperp(self, epoch: int) -> None:
        """LR schedule per epoch: ``lr_schedule='step'`` (÷10 at the epochs
        in ``lr_adjust_epochs``) or ``'cosine'`` (base → ``min_lr_frac``·base
        over ``epochs``), times the ``scale_lr`` factor, ramped linearly over
        ``warmup_epochs`` when that is set."""
        base = float(self.learning_rate)
        sched = str(self.config.get("lr_schedule", "step"))
        if sched == "cosine":
            import math
            frac = float(self.config.get("min_lr_frac", 0.1))
            total = max(1, int(self.config.get("epochs", self.epochs)))
            t = min(epoch, total) / total
            lr = base * (frac + (1.0 - frac) * 0.5
                         * (1.0 + math.cos(math.pi * t)))
        elif sched == "step":
            lr = base
            for e in self.lr_adjust_epochs:
                if epoch >= e:
                    lr /= 10.0
        else:
            raise ValueError(f"unknown lr_schedule {sched!r}; "
                             f"have 'step', 'cosine'")
        scale = self._lr_scale
        warmup = int(self.config.get("warmup_epochs", 0))
        if warmup > 0 and epoch < warmup and scale > 1.0:
            scale = 1.0 + (scale - 1.0) * (epoch + 1) / warmup
        self.current_lr = lr * scale

    _lr_scale: float = 1.0

    def scale_lr(self, size: int) -> None:
        """Linear LR scaling by worker count."""
        self._lr_scale = float(size)
        self.current_lr = self.current_lr * size

    # -- contract: persistence ---------------------------------------------

    def _state_parts(self) -> Dict[str, Any]:
        """The state a step carries: params, the optimizer's state, the BN
        running state and the exchanger's per-rank ``extra``."""
        params = self.params if self._fsdp is None else self._fsdp.shard
        return {"params": params, "opt_state": self.opt_state,
                "bn_state": self.bn_state, "extra": self.extra}

    def _per_rank_parts(self) -> tuple:
        """Parts that differ between ranks: every part the exchanger does
        not call identical (``Exchanger.identical_parts``: under BSP grads
        mode with a stateless reducing strategy the replicas are identical,
        except the chunks ZeRO-1, ``update_sharding`` and FSDP keep; under
        every other rule, mode or strategy all of them differ)."""
        ident = set(self.exchanger.identical_parts())
        return tuple(k for k in self._state_parts() if k not in ident)

    def _refuse_ckpt_layouts(self) -> None:
        if self.config.get("async_ckpt"):
            raise NotImplementedError("async_ckpt is not ported yet")
        if self.opt_state is None:
            raise RuntimeError("save/load need compile_iter_fns() first")

    def save(self, ckpt_dir: str, epoch: int, count: int = 0) -> str:
        """Checkpoint the state: the parts identical on every rank once
        (rank 0's), the per-rank parts stacked over the ranks (gathered to
        rank 0; :meth:`_per_rank_parts`), the dropout stream's generator,
        and the data loader's consumed cursor; plus the reference-style
        per-leaf ``.npy`` snapshot of :meth:`canonical_params` (the center,
        the consensus, the EMA shadow or the params).  Rank 0 writes; every
        rank must call (the gather is collective).  Returns the ``.npz``
        path."""
        import os

        import torch.distributed as dist
        self._refuse_ckpt_layouts()
        per_rank = self._per_rank_parts()
        snapshot = self.canonical_host_params()
        state = {}
        for k, tree in self._state_parts().items():
            if k in per_rank:
                tree = tree_map(self._gather_ranks, tree)
            elif self.rank == 0:
                tree = tree_map(
                    lambda l: l.detach().cpu().numpy()
                    if isinstance(l, torch.Tensor) else np.int32(l), tree)
            state[k] = tree
        path = os.path.join(ckpt_dir, f"ckpt_epoch{epoch}.npz")
        if self.rank == 0:
            cursor = self.data.get_cursor() \
                if hasattr(self.data, "get_cursor") else None
            gen = torch.Generator().manual_seed(self.step_seed)
            ckpt_lib.save_checkpoint(
                ckpt_dir, state, epoch, count,
                rng_states={"step": gen.get_state()}, cursor=cursor,
                params_npy=snapshot,
                extra_meta=self._layout_meta(per_rank))
        if dist.is_initialized() and dist.get_world_size() > 1:
            dist.barrier()            # the files exist before anyone reads
        return path

    def _layout_meta(self, per_rank) -> dict:
        """The checkpoint's layout facts, as the JAX package writes them:
        the boxed parts, the worker count, and ZeRO-1's or FSDP's chunk
        layout (FSDP's ``chunk`` is the port's, over its aligned flat
        layout; ``total`` counts the parameters)."""
        meta = {"boxed_parts": sorted(per_rank), "n_workers": self.size}
        if self._zero_layout is not None:
            meta["zero"] = dict(self._zero_layout)
        if self._fsdp is not None:
            meta["fsdp"] = {"n": self._fsdp.n_workers,
                            "chunk": self._fsdp.chunk,
                            "total": self._fsdp.n_total}
        return meta

    def _gather_ranks(self, t):
        """``[size, ...]`` on the host: every rank's ``t``, in rank order."""
        import torch.distributed as dist
        if self.size == 1:
            return t.detach().cpu().numpy()[None]
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t.detach().contiguous())
        return torch.stack(parts).cpu().numpy()

    def load(self, ckpt_dir: str, epoch: Optional[int] = None) -> Optional[int]:
        """Restore what :meth:`save` wrote (call after ``compile_iter_fns``):
        params, optimizer state, BN state, this rank's row of the per-rank
        parts, the dropout stream's seed and the data cursor, so training
        replays bit-identically from the save point.  Returns the epoch
        restored from, or None when there is no checkpoint."""
        self._refuse_ckpt_layouts()
        meta = ckpt_lib.peek_meta(ckpt_dir, epoch)
        if meta is None:
            return None
        if int(meta.get("n_workers", self.size)) != self.size:
            raise NotImplementedError(
                f"the checkpoint was written by {meta['n_workers']} workers; "
                f"resuming on {self.size} (elastic or worker-count refit) is "
                f"not ported yet")
        boxed = set(meta.get("boxed_parts", ()))

        def shape_of(k):
            return lambda l: (self.size,) + tuple(l.shape) \
                if k in boxed else tuple(getattr(l, "shape", ()))

        template = {k: tree_map(lambda l, f=shape_of(k): _Shaped(f(l)), tree)
                    for k, tree in self._state_parts().items()}
        restored = ckpt_lib.load_checkpoint(ckpt_dir, template,
                                            int(meta["epoch"]))
        if restored is None:
            return None

        # every tensor is written in place, so a captured step keeps
        # reading it (the optimizer's own load keeps Adam's count groups;
        # a tensor it must replace makes the step capture again)
        for k, tree in self._state_parts().items():
            host = tree_map(lambda a: a[self.rank], restored[k]) \
                if k in boxed else restored[k]
            if k == "opt_state":
                self.opt_state = opt_lib.load_state(tree, host)
            else:
                opt_lib.load_state(tree, host)
        rng = restored.get("_rng_states", {})
        if "step" in rng:
            gen = torch.Generator()
            gen.set_state(rng["step"])
            self.step_seed = gen.initial_seed()
        cursor = restored.get("_cursor")
        if cursor and hasattr(self.data, "set_cursor"):
            self.data.set_cursor(cursor)
        if self._fsdp is not None:
            self._fsdp.gather_params()     # the views read the loaded chunks
        return int(meta["epoch"])


class _Shaped:
    """A checkpoint template leaf: only its shape."""

    def __init__(self, shape):
        self.shape = shape
