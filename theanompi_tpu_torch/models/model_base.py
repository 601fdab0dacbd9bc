"""The model contract.

Counterpart of ``theanompi_tpu/models/model_base.py``: a model exposes
``params``, ``data``, ``compile_iter_fns()``, ``train_iter(count,
recorder)``, ``val_iter(count, recorder)``, ``adjust_hyperp(epoch)``,
``scale_lr(size)``, ``epochs`` and ``n_subb``, and the worker loop drives any
object of that shape.  Concrete models define their layer stack, data object
and hyperparameters.

A model lives on ONE device, ``config['device']``: ``cuda`` unless the
caller asks for ``cpu``.  Without a card, a model that did not ask for the
CPU raises.  ZeRO, FSDP, update sharding, EMA and the numerics plane of the
JAX package are not ported yet.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from ..base import resolve_device
from ..parallel import steps
from ..utils.helper_funcs import tree_map
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

    def __init__(self, config: Optional[dict] = None):
        self.config = dict(config or {})
        self.verbose = self.config.get("verbose", True)
        self.rank = int(self.config.get("rank", 0))
        self.size = int(self.config.get("size", 1))
        self.config.setdefault("rank", self.rank)
        self.config["size"] = self.size
        self.device = resolve_device(self.config)
        for k in ("batch_size", "epochs", "n_subb", "learning_rate", "seed",
                  "optimizer", "momentum", "weight_decay"):
            if k in self.config:
                setattr(self, k, self.config[k])
        for k in ("zero_opt", "fsdp", "update_sharding", "ema_decay",
                  "numerics", "para_load"):
            if self.config.get(k):
                raise NotImplementedError(f"config {k!r} is not ported yet")
        if int(self.config.get("steps_per_call", 1)) != 1:
            raise NotImplementedError("steps_per_call > 1 is not ported yet")
        self.seed = int(self.config.get("seed", self.seed))
        self.current_lr = float(self.learning_rate)

        self.seq: L.Sequential = None
        self.data = None
        self.build_model()            # subclass hook: set self.seq, self.data

        gen = torch.Generator().manual_seed(self.seed)
        self.params = tree_map(
            lambda p: p.to(self.device).requires_grad_(True),
            self.init_params(gen))
        self.opt = get_optimizer(self.optimizer, mu=self.momentum,
                                 weight_decay=self.weight_decay) \
            if self.optimizer == "momentum" \
            else get_optimizer(self.optimizer, weight_decay=self.weight_decay)
        self.opt_state = None
        self.extra = {}
        self.train_fn = None
        self.val_fn = None
        self.exchanger = None
        self.current_info: Dict[str, Any] = {}

    # -- subclass hooks ----------------------------------------------------

    def build_model(self) -> None:
        raise NotImplementedError

    def init_params(self, gen: torch.Generator):
        assert self.seq is not None, "build_model() must set self.seq or " \
                                     "override init_params/apply_model"
        return self.seq.init(gen)

    def apply_model(self, params, x, *, train: bool, gen):
        """Returns logits."""
        return self.seq.apply(params, x, train=train, gen=gen)

    def _label_smoothing(self, train: bool) -> float:
        return float(self.config.get("label_smoothing", 0.0)) if train \
            else 0.0

    def loss_and_metrics(self, params, batch, gen, train: bool):
        """Default head: softmax cross-entropy + top-1 error."""
        logits = self.apply_model(params, batch["x"], train=train, gen=gen)
        cost = L.softmax_cross_entropy(logits, batch["y"],
                                       self._label_smoothing(train))
        return cost, L.errors(logits, batch["y"])

    def val_metrics(self, params, batch):
        logits = self.apply_model(params, batch["x"], train=False, gen=None)
        cost = L.softmax_cross_entropy(logits, batch["y"])
        return cost, (L.errors(logits, batch["y"]),
                      L.errors_top_x(logits, batch["y"], 5))

    def load_params(self, tree) -> None:
        """Overwrite the parameters from a tree of arrays in the port's
        layout (numpy or tensors; ``convert.py`` makes one from JAX)."""
        with torch.no_grad():
            tree_map(lambda p, v: p.copy_(torch.as_tensor(np.asarray(v))),
                     self.params, tree)

    def host_params(self):
        """The parameters as a tree of float32 numpy arrays."""
        return tree_map(lambda p: p.detach().cpu().numpy(), self.params)

    # -- contract: compile -------------------------------------------------

    def compile_iter_fns(self, exchanger=None) -> None:
        """Build the train and val steps.  Needs the process group that
        ``base.MeshProcess`` sets up (world size 1 included)."""
        import torch.distributed as dist
        from ..parallel.exchanger import BSP_Exchanger
        if not dist.is_initialized():
            raise RuntimeError("no torch.distributed process group: build the "
                               "model through a Worker or "
                               "base.MeshProcess.get_internode_comm()")
        self.exchanger = exchanger or BSP_Exchanger(self.config)
        self.exchanger.prepare(self, dist.get_world_size())
        self.opt_state = self.opt.init(self.params)
        self.extra = self.exchanger.extra_state_template()
        self.train_fn = steps.build_train_step(self, self.exchanger)
        self.val_fn = steps.build_val_step(self)

    # -- contract: iteration -----------------------------------------------

    def train_iter(self, count: int, recorder=None) -> None:
        """One training step.  Recorder buckets: ``load`` = drawing the
        host batch, ``stage`` = host → device, ``train`` = enqueueing the
        step (the card runs behind; metrics stay on it until printed)."""
        if recorder:
            recorder.start()
        batch = self.data.next_train_batch(count)
        if recorder:
            recorder.end("load")
            recorder.start()
        dev_batch = steps.put_batch(batch, self.device)
        if recorder:
            recorder.end("stage")
            recorder.start()
        cost, err = self.train_fn(dev_batch, self.current_lr, count)
        if recorder:
            recorder.end("train")
            # images of the global batch: every rank steps in lockstep
            recorder.train_error(count, cost, err,
                                 int(batch["y"].shape[0]) * self.size)
        self.current_info.update(cost=cost, error=err)

    def begin_val(self) -> None:
        """BSP replicas are identical: validation scores them as they are."""

    def val_iter(self, count: int, recorder=None) -> None:
        if recorder:
            recorder.start()
        batch = steps.put_batch(self.data.next_val_batch(count), self.device)
        cost, err, err5 = (float(v) for v in self.val_fn(batch))
        if recorder:
            recorder.end("val")
            recorder.val_error(count, cost, err, err5)

    def end_val(self) -> None:
        pass

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
