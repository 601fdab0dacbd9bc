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
velocity and Adam's moments are rewritten where they lie, so a step
allocates no second copy of the model.  ``update`` returns the same tree
objects it was given (Adam's per-leaf step counts, Python ints, in a new
tree).
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
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
                "t": tree_map(lambda p: 0, params)}

    def corrections(t: int):
        # float32, as the JAX package raises b1 to a float32 count
        tf = np.float32(t)
        return (float(np.float32(1) - np.float32(b1) ** tf),
                float(np.float32(1) - np.float32(b2) ** tf))

    @torch.no_grad()
    def update(grads, st, params, lr):
        t = tree_map(lambda c: c + 1, st["t"])
        ps, gs = tree_leaves(params), tree_leaves(grads)
        ms, vs = tree_leaves(st["m"]), tree_leaves(st["v"])
        torch._foreach_mul_(ms, b1)
        torch._foreach_add_(ms, gs, alpha=1 - b1)
        torch._foreach_mul_(vs, b2)
        torch._foreach_addcmul_(vs, gs, gs, value=1 - b2)
        groups = {}
        for i, c in enumerate(tree_leaves(t)):
            groups.setdefault(c, []).append(i)
        for c, idx in groups.items():
            bc1, bc2 = corrections(c)
            p = [ps[i] for i in idx]
            step = torch._foreach_div([ms[i] for i in idx], bc1)
            denom = torch._foreach_div([vs[i] for i in idx], bc2)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, eps)
            torch._foreach_div_(step, denom)
            if weight_decay:
                torch._foreach_add_(step, p, alpha=weight_decay)
            torch._foreach_add_(p, step, alpha=-lr)
        return params, {"m": st["m"], "v": st["v"], "t": t}

    return OptPair(init, update)


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
