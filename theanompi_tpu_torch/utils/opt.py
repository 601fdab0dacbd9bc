"""Optimizer updates.

Counterpart of ``theanompi_tpu/utils/opt.py`` for ``sgd`` and ``momentum``.
Each builder returns an ``(init, update)`` pair over parameter trees and
follows the JAX formulas exactly:

  sgd:       p' = p - lr*(g + wd*p)
  momentum:  v' = mu*v - lr*(g + wd*p);  p' = p + v'

``torch.optim.SGD`` is not used: its momentum buffer accumulates the raw
gradient and applies lr afterwards, which differs from this form as soon as
the learning rate changes.

The port updates IN PLACE (the JAX package returns new arrays): params and
velocity are rewritten where they lie, so a step allocates no second copy
of the model.  ``update`` returns the same tree objects it was given.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

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


OPTIMIZERS = {
    "sgd": sgd,
    "momentum": momentum,
}


def get_optimizer(name: str, **kwargs) -> OptPair:
    try:
        return OPTIMIZERS[name](**kwargs)
    except KeyError:
        raise ValueError(f"unknown optimizer {name!r}; have {sorted(OPTIMIZERS)}"
                         " (the others are not ported yet)")
