"""Optimizer updates.

Counterpart of ``theanompi_tpu/utils/opt.py``: ``sgd``, ``momentum``,
``nesterov``, ``rmsprop``, ``adam`` and the EMA wrapper ``ema_wrap``.
Each builder returns an ``(init, update)`` pair over parameter trees and
follows the JAX formulas exactly:

  sgd:       p' = p - lr*(g + wd*p)
  momentum:  v' = mu*v - lr*(g + wd*p);  p' = p + v'
  nesterov:  s = lr*(g + wd*p);  v' = mu*v - s;  p' = p + mu*v' - s
  rmsprop:   s' = d*s + (1-d)*g*g;  p' = p - lr*(g/(sqrt(s') + eps) + wd*p)
  adam:      t' = t + 1;  m' = b1*m + (1-b1)*g;  v' = b2*v + (1-b2)*g*g
             p' = p - lr*((m'/(1-b1^t')) / (sqrt(v'/(1-b2^t')) + eps) + wd*p)
  ema_wrap:  e' = decay*(p if t == 0 else e) + (1-decay)*p';  t' = t + 1

``torch.optim.SGD`` is not used: its momentum buffer accumulates the raw
gradient and applies lr afterwards, which differs from this form as soon as
the learning rate changes.

Every update is a short sequence of ``torch._foreach_*`` passes over all
leaves at once (a few multi-tensor launches on the card where a loop over
the leaves made several per leaf), each op the one the JAX formula names,
in its order, so the per-leaf results are unchanged bit for bit.

The port updates IN PLACE (the JAX package returns new arrays): params,
velocity, the moments, the EMA shadow and the step counts are rewritten
where they lie, so a step allocates no second copy of the model's state
and a captured step (``parallel/graph.py``) replays on the same storage.
``update`` returns the same tree objects it was given.

``lr`` may be a Python float or a 0-d float32 tensor on the params'
device: the train step passes a tensor that it refills when the schedule
moves, so a captured step reads the current rate, as the JAX step takes
``lr`` as a traced input.  Adam's step counts and the EMA's ``t`` are 0-d
int32 tensors on the device, and what depends on them (Adam's bias
corrections, in float32 as the JAX package raises ``b1`` to a float32
count; the EMA's seeding of its shadow at ``t == 0``) is computed there.
Adam's leaves whose counts are equal share one count tensor (one
increment, one correction for the group); :func:`load_state` keeps that
grouping when a checkpoint writes the counts.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from .helper_funcs import tree_leaves, tree_map


class OptPair(NamedTuple):
    init: Callable
    update: Callable  # (grads, opt_state, params, lr) -> (params, opt_state)


def _decayed_step(ps, gs, weight_decay, lr) -> list:
    """``lr*(g + wd*p)`` for every leaf, as new tensors: ``wd*p``, plus
    ``g``, times ``lr``, one pass each."""
    step = torch._foreach_mul(ps, weight_decay)
    torch._foreach_add_(step, gs)
    torch._foreach_mul_(step, lr)
    return step


def _zeros(params):
    return tree_map(lambda p: torch.zeros_like(p, requires_grad=False),
                    params)


def sgd(weight_decay: float = 0.0) -> OptPair:
    """Vanilla SGD: p' = p - lr*(g + wd*p)."""

    def init(params):
        return ()

    @torch.no_grad()
    def update(grads, opt_state, params, lr):
        ps = tree_leaves(params)
        torch._foreach_sub_(ps, _decayed_step(ps, tree_leaves(grads),
                                              weight_decay, lr))
        return params, opt_state

    return OptPair(init, update)


def momentum(mu: float = 0.9, weight_decay: float = 0.0001) -> OptPair:
    """Classical momentum SGD — the model zoo's default."""

    @torch.no_grad()
    def update(grads, vel, params, lr):
        ps, vs = tree_leaves(params), tree_leaves(vel)
        step = _decayed_step(ps, tree_leaves(grads), weight_decay, lr)
        torch._foreach_mul_(vs, mu)
        torch._foreach_sub_(vs, step)
        torch._foreach_add_(ps, vs)
        return params, vel

    return OptPair(_zeros, update)


def nesterov(mu: float = 0.9, weight_decay: float = 0.0001) -> OptPair:
    """Nesterov accelerated gradient, in the form Theano/Lasagne used."""

    @torch.no_grad()
    def update(grads, vel, params, lr):
        ps, vs = tree_leaves(params), tree_leaves(vel)
        step = _decayed_step(ps, tree_leaves(grads), weight_decay, lr)
        torch._foreach_mul_(vs, mu)
        torch._foreach_sub_(vs, step)
        torch._foreach_add_(ps, torch._foreach_mul(vs, mu))
        torch._foreach_sub_(ps, step)
        return params, vel

    return OptPair(_zeros, update)


def rmsprop(decay: float = 0.9, eps: float = 1e-8,
            weight_decay: float = 0.0) -> OptPair:
    """RMSprop, its weight decay decoupled (outside the adaptive division),
    as the JAX package writes it."""

    @torch.no_grad()
    def update(grads, sq, params, lr):
        ps, gs, ss = tree_leaves(params), tree_leaves(grads), tree_leaves(sq)
        torch._foreach_mul_(ss, decay)
        torch._foreach_addcmul_(ss, gs, gs, value=1 - decay)
        denom = torch._foreach_sqrt(ss)
        torch._foreach_add_(denom, eps)
        step = torch._foreach_div(gs, denom)
        torch._foreach_add_(step, torch._foreach_mul(ps, weight_decay))
        torch._foreach_mul_(step, lr)
        torch._foreach_sub_(ps, step)
        return params, sq

    return OptPair(_zeros, update)


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


def ema_wrap(opt: OptPair, decay: float) -> OptPair:
    """Polyak/EMA parameter averaging around ``opt`` (config
    ``ema_decay``): a shadow tracks ``decay*ema + (1-decay)*params`` after
    every update; validation and the ``.npy`` snapshot read it.  The state
    is ``{"inner", "ema", "t"}``, ``t`` a 0-d int32 tensor on the device.
    The shadow starts as a copy of the params, and the first update
    (``t == 0``) seeds it again from the live params on the device, as the
    JAX package's ``where(t == 0, p, e)`` does: a load of the params after
    ``init`` is tracked, and nothing reads ``t`` back to the host."""
    decay = float(decay)
    if not 0.0 < decay < 1.0:
        raise ValueError(f"ema_decay must be in (0, 1); got {decay}")

    def init(params):
        ema = tree_map(lambda p: p.detach().clone(), params)
        t = torch.zeros((), dtype=torch.int32,
                        device=tree_leaves(params)[0].device)
        return {"inner": opt.init(params), "ema": ema, "t": t}

    @torch.no_grad()
    def update(grads, st, params, lr):
        ps, es = tree_leaves(params), tree_leaves(st["ema"])
        # e = where(t == 0, p, e) before the update, as exact products
        # (x*1 and x*0 + y are exact for finite values)
        seed = (st["t"] == 0).to(torch.float32)
        torch._foreach_mul_(es, 1 - seed)
        torch._foreach_add_(es, torch._foreach_mul(ps, seed))
        params, st["inner"] = opt.update(grads, st["inner"], params, lr)
        torch._foreach_mul_(es, decay)
        torch._foreach_add_(es, torch._foreach_mul(ps, 1.0 - decay))
        st["t"].add_(1)
        return params, st

    return OptPair(init, update)


def ema_params(st, params):
    """What an EMA-wrapped optimizer's state says inference should use: the
    shadow, or ``params`` before the first update (``t == 0``, the shadow
    not yet seeded).  Reads ``t`` on the host: for validation and
    checkpoints, never inside a step."""
    return params if int(st["t"]) == 0 else st["ema"]


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

    if isinstance(cur, dict) and set(cur) == {"inner", "ema", "t"}:
        cur["inner"] = load_state(cur["inner"], host["inner"])
        tree_map(put, cur["ema"], host["ema"])
        put(cur["t"], host["t"])
        return cur
    if isinstance(cur, dict) and set(cur) == {"m", "v", "t"}:
        for k in ("m", "v"):
            tree_map(put, cur[k], host[k])
        cur["t"] = _place_counts(cur["t"], host["t"])
        return cur
    return tree_map(put, cur, host)


OPTIMIZERS = {
    "sgd": sgd,
    "momentum": momentum,
    "nesterov": nesterov,
    "rmsprop": rmsprop,
    "adam": adam,
}


def get_optimizer(name: str, **kwargs) -> OptPair:
    try:
        return OPTIMIZERS[name](**kwargs)
    except KeyError:
        raise ValueError(f"unknown optimizer {name!r}; "
                         f"have {sorted(OPTIMIZERS)}")
