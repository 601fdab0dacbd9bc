"""Train and validation steps.

Counterpart of ``theanompi_tpu/parallel/steps.py``.  The JAX package traced
the whole step — micro-batch scan, backward, exchange, update — into one XLA
program over the worker mesh.  The port runs one process per rank and the
same sequence eagerly: forward and backward for each of ``n_subb``
micro-batches, the exchanger's gradient collective, the optimizer update in
place.  Nothing in a step reads a device value back to the host, so the
card's queue stays full; the per-step metrics stay on the device until the
recorder prints them.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch
import torch.distributed as dist

from ..utils.helper_funcs import tree_leaves, tree_map


def step_generator(seed: int, rank: int, count: int,
                   device: torch.device) -> torch.Generator:
    """The dropout stream of one step on one rank, seeded from
    ``(seed, rank, count)`` — the role of the JAX step's
    ``fold_in(fold_in(key, rank), count)``.  The bits differ from JAX's."""
    s = np.random.SeedSequence([int(seed), int(rank), int(count)])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(s.generate_state(1, np.uint64)[0] >> np.uint64(1)))
    return gen


def _like(tree, leaves):
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def _accumulate_grads(loss_and_metrics: Callable, params, batch,
                      gen, n_subb: int):
    """Gradient accumulation over ``n_subb`` micro-batches, in order.

    ``loss_and_metrics(params, batch, gen, train=True)`` returns
    ``(cost, err)``.  Returns the mean cost, mean error and mean gradient
    tree (detached)."""
    leaves = tree_leaves(params)
    if n_subb == 1:
        cost, err = loss_and_metrics(params, batch, gen, True)
        grads = torch.autograd.grad(cost, leaves)
        return cost.detach(), err.detach(), _like(params, grads)

    def micro(x, i):
        if x.shape[0] % n_subb:
            raise ValueError(f"batch dim {x.shape[0]} not divisible by "
                             f"n_subb={n_subb}")
        m = x.shape[0] // n_subb
        return x[i * m:(i + 1) * m]

    acc = [torch.zeros_like(p, requires_grad=False) for p in leaves]
    acc_c = acc_e = 0.0
    for i in range(n_subb):
        mb = {k: micro(v, i) for k, v in batch.items()}
        cost, err = loss_and_metrics(params, mb, gen, True)
        for a, g in zip(acc, torch.autograd.grad(cost, leaves)):
            a.add_(g)
        acc_c = acc_c + cost.detach()
        acc_e = acc_e + err.detach()
    inv = 1.0 / n_subb
    for a in acc:
        a.mul_(inv)
    return acc_c * inv, acc_e * inv, _like(params, acc)


def _mean_over_ranks(t: torch.Tensor, size: int) -> torch.Tensor:
    dist.all_reduce(t)
    return t / size


def build_train_step(model, exchanger) -> Callable:
    """``train_fn(batch, lr, count) -> (cost, err)``: one step of this rank,
    updating ``model.params``, ``model.opt_state`` and ``model.extra`` (the
    exchanger's per-rank state).  The returned metrics are means over the
    ranks, device scalars."""
    n_subb = int(getattr(model, "n_subb", 1))
    size = exchanger.size

    def train_fn(batch: Dict[str, torch.Tensor], lr: float, count: int):
        gen = step_generator(model.seed + 2, model.rank, count, model.device)
        cost, err, grads = _accumulate_grads(
            model.loss_and_metrics, model.params, batch, gen, n_subb)
        model.params, model.opt_state, model.extra = exchanger.step_update(
            model.params, model.opt_state, grads, model.extra, lr)
        m = _mean_over_ranks(torch.stack([cost, err]), size)
        return m[0], m[1]

    return train_fn


def build_val_step(model) -> Callable:
    """``val_fn(batch) -> (cost, err, err_top5)``: this rank's rows scored
    with its replica, averaged over the ranks."""
    size = dist.get_world_size()

    @torch.no_grad()
    def val_fn(batch: Dict[str, torch.Tensor]):
        cost, (err, err5) = model.val_metrics(model.params, batch)
        m = _mean_over_ranks(torch.stack([cost, err, err5]), size)
        return m[0], m[1], m[2]

    return val_fn


def put_batch(batch: Dict[str, np.ndarray], device: torch.device):
    """Host batch → tensors on ``device``."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}
