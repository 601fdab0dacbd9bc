"""Exchangers.

Counterpart of ``theanompi_tpu/parallel/exchanger.py`` for the local
``Exchanger`` and ``BSP_Exchanger`` in ``exch_mode='grads'``: the selected
strategy averages the gradients over the ranks inside the step, then every
rank applies the same update — N ranks train as one rank on the N-fold
batch.  A stateful strategy's per-rank state rides in the model's
``extra["strat"]``, as in the JAX package: a flat tensor (the error
feedback of onebit and topk) or a per-leaf list of ``{"q", "e"}``
(PowerSGD).  ``exch_mode='params'``, the bucketed wire and the async rules
are not ported yet.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from .strategies import Strategy, get_strategy


class Exchanger:
    """Base: a purely local optimizer step (the async rules train locally
    between exchanges)."""

    name = "exchanger"

    def __init__(self, config: Optional[dict] = None):
        self.config = dict(config or {})
        self.model = None
        self.size = 1

    def prepare(self, model, size: int) -> None:
        self.model = model
        self.size = int(size)

    def extra_state_template(self) -> Dict[str, Any]:
        """The per-rank state the step carries besides params and optimizer
        state."""
        return {}

    def step_update(self, params, opt_state, grads, extra, lr):
        """``(params, opt_state, extra)`` after one update."""
        params, opt_state = self.model.opt.update(grads, opt_state, params, lr)
        return params, opt_state, extra


class BSP_Exchanger(Exchanger):
    """Bulk-synchronous exchange of gradients (``exch_mode='grads'``)."""

    name = "bsp"

    def __init__(self, config: Optional[dict] = None):
        super().__init__(config)
        self.mode = self.config.get("exch_mode", "grads")
        if self.mode != "grads":
            raise NotImplementedError(
                f"exch_mode={self.mode!r} is not ported yet; use 'grads'")
        if int(self.config.get("bucket_bytes", 0) or 0) > 0:
            raise NotImplementedError(
                "bucket_bytes > 0 (the bucketed wire) is not ported yet")
        self.strategy: Strategy = get_strategy(
            self.config.get("exch_strategy", "allreduce"))

    def prepare(self, model, size: int) -> None:
        """Also hands the strategy the paths of the model's leaves kept in
        the JAX layout (``ModelBase.kept_layout_paths``)."""
        super().prepare(model, size)
        self.strategy.kept_layout = frozenset(model.kept_layout_paths())

    def extra_state_template(self) -> Dict[str, Any]:
        """``{"strat": state}`` on the model's device for a stateful
        strategy (whatever structure its ``init_state`` makes: a tensor or
        a per-leaf list), else ``{}``."""
        if self.strategy.stateful:
            return {"strat": self.strategy.init_state(self.model.params)}
        return {}

    def step_update(self, params, opt_state, grads, extra, lr):
        """The strategy's mean of ``grads`` (its state in and out of
        ``extra["strat"]`` as the strategy returns it), then the optimizer
        update."""
        grads, strat = self.strategy(grads, extra.get("strat", ()),
                                     size=self.size)
        if "strat" in extra:
            extra = dict(extra, strat=strat)
        params, opt_state = self.model.opt.update(grads, opt_state, params, lr)
        return params, opt_state, extra


EXCHANGERS = {"bsp": BSP_Exchanger}


def get_exchanger(name: str, config: Optional[dict] = None) -> Exchanger:
    try:
        return EXCHANGERS[name.lower()](config)
    except KeyError:
        raise ValueError(f"unknown or not yet ported exchanger {name!r}; "
                         f"have {sorted(EXCHANGERS)}")
