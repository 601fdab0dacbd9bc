"""Optimizer updates.

Counterpart of ``theanompi_tpu/utils/opt.py`` for ``sgd``, ``momentum`` and
``adam``.  Each builder returns an ``(init, update)`` pair over parameter
trees and follows the JAX formulas exactly:

  sgd:       p' = p - lr*(g + wd*p)
  momentum:  v' = mu*v - lr*(g + wd*p);  p' = p + v'
  adam:      t' = t + 1;  m' = b1*m + (1-b1)*g;  v' = b2*v + (1-b2)*g*g
             p' = p - lr*((m'/(1-b1^t')) / (sqrt(v'/(1-b2^t')) + eps) + wd*p)

``torch.optim.SGD`` is not used: its momentum buffer accumulates the raw
gradient and applies lr afterwards, which differs from this form as soon as
the learning rate changes.

The port updates IN PLACE (the JAX package returns new arrays): params,
velocity, Adam's moments and Adam's step counts are rewritten where they
lie, so a step allocates no second copy of the model and a captured step
(``parallel/graph.py``) replays on the same storage.  ``update`` returns
the same tree objects it was given.

``lr`` may be a Python float or a 0-d float32 tensor on the params'
device: the train step passes a tensor that it refills when the schedule
moves, so a captured step reads the current rate, as the JAX step takes
``lr`` as a traced input.  Adam's step counts are 0-d int32 tensors on
the device and its bias corrections are computed there, in float32 as
the JAX package raises ``b1`` to a float32 count.  Leaves whose counts are
equal share one count tensor (one increment, one correction for the
group); :func:`load_state` keeps that grouping when a checkpoint writes
the counts.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from .helper_funcs import tree_leaves, tree_map


class OptPair(NamedTuple):
    init: Callable
    update: Callable  # (grads, opt_state, params, lr) -> (params, opt_state)


def sgd(weight_decay: float = 0.0) -> OptPair:
    """Vanilla SGD: p' = p - lr*(g + wd*p)."""

    def init(params):
        return ()

    @torch.no_grad()
    def update(grads, opt_state, params, lr):
        for p, g in zip(tree_leaves(params), tree_leaves(grads)):
            p.sub_(lr * (g + weight_decay * p))
        return params, opt_state

    return OptPair(init, update)


def momentum(mu: float = 0.9, weight_decay: float = 0.0001) -> OptPair:
    """Classical momentum SGD — the model zoo's default."""

    def init(params):
        return tree_map(lambda p: torch.zeros_like(p, requires_grad=False),
                        params)

    @torch.no_grad()
    def update(grads, vel, params, lr):
        for p, g, v in zip(tree_leaves(params), tree_leaves(grads),
                           tree_leaves(vel)):
            v.mul_(mu).sub_(lr * (g + weight_decay * p))
            p.add_(v)
        return params, vel

    return OptPair(init, update)


def adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         weight_decay: float = 0.0) -> OptPair:
    """Adam with bias correction and one step count per leaf, as the JAX
    package keeps them.  Leaves that share a count update together through
    ``torch._foreach_*`` ops."""

    def init(params):
        zeros = lambda p: torch.zeros_like(p, requires_grad=False)
        count = torch.zeros((), dtype=torch.int32,
                            device=tree_leaves(params)[0].device)
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
                "t": tree_map(lambda p: count, params)}

    @torch.no_grad()
    def update(grads, st, params, lr):
        ps, gs = tree_leaves(params), tree_leaves(grads)
        ms, vs = tree_leaves(st["m"]), tree_leaves(st["v"])
        torch._foreach_mul_(ms, b1)
        torch._foreach_add_(ms, gs, alpha=1 - b1)
        torch._foreach_mul_(vs, b2)
        torch._foreach_addcmul_(vs, gs, gs, value=1 - b2)
        for c, idx in _count_groups(st["t"]):
            c.add_(1)
            tf = c.float()
            bc1, bc2 = 1 - b1 ** tf, 1 - b2 ** tf
            p = [ps[i] for i in idx]
            step = torch._foreach_div([ms[i] for i in idx], bc1)
            denom = torch._foreach_div([vs[i] for i in idx], bc2)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, eps)
            torch._foreach_div_(step, denom)
            if weight_decay:
                torch._foreach_add_(step, p, alpha=weight_decay)
            torch._foreach_mul_(step, lr)
            torch._foreach_sub_(p, step)
        return params, st

    return OptPair(init, update)


def _count_groups(t_tree) -> list:
    """Adam's count tensors with the indices of the leaves that share
    each, in leaf order: ``[(count, [i, ...]), ...]``."""
    groups = {}
    for i, c in enumerate(tree_leaves(t_tree)):
        groups.setdefault(id(c), (c, []))[1].append(i)
    return list(groups.values())


def _place_counts(t_tree, values):
    """Adam's counts set to ``values`` (a tree of ints or 0-d arrays): in
    place where the leaves that share a count tensor are exactly those of
    equal value, else in new shared tensors, one per value."""
    vals = [int(np.asarray(v)) for v in tree_leaves(values)]
    groups = _count_groups(t_tree)
    if all(len({vals[i] for i in idx}) == 1 for _, idx in groups) and \
            len({vals[idx[0]] for _, idx in groups}) == len(groups):
        for c, idx in groups:
            c.fill_(vals[idx[0]])
        return t_tree
    dev = groups[0][0].device
    shared = {v: torch.tensor(v, dtype=torch.int32, device=dev)
              for v in sorted(set(vals))}
    it = iter(vals)
    return tree_map(lambda _: shared[next(it)], t_tree)


@torch.no_grad()
def load_state(cur, host):
    """Write ``host`` (the same tree as ``cur``, of arrays, tensors or
    ints) into the optimizer state ``cur`` in place, so that a captured
    step keeps reading it; returns the state.  Adam's counts go through
    :func:`_place_counts`: only a checkpoint whose leaves' counts group
    otherwise than the current ones makes new count tensors."""
    def put(c, h):
        c.copy_(torch.as_tensor(np.asarray(h)))
        return c

    if isinstance(cur, dict) and set(cur) == {"m", "v", "t"}:
        for k in ("m", "v"):
            tree_map(put, cur[k], host[k])
        cur["t"] = _place_counts(cur["t"], host["t"])
        return cur
    return tree_map(put, cur, host)


OPTIMIZERS = {
    "sgd": sgd,
    "momentum": momentum,
    "adam": adam,
}


def get_optimizer(name: str, **kwargs) -> OptPair:
    try:
        return OPTIMIZERS[name](**kwargs)
    except KeyError:
        raise ValueError(f"unknown optimizer {name!r}; have {sorted(OPTIMIZERS)}"
                         " (the others are not ported yet)")
