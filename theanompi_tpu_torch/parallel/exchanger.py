"""Exchangers.

Counterpart of ``theanompi_tpu/parallel/exchanger.py`` for the local
``Exchanger`` and ``BSP_Exchanger`` in ``exch_mode='grads'``: the selected
strategy averages the gradients over the ranks inside the step, then every
rank applies the same update — N ranks train as one rank on the N-fold
batch.  ``exch_mode='params'`` and the async rules are not ported yet.
"""

from __future__ import annotations

from typing import Optional

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

    def step_update(self, params, opt_state, grads, lr):
        return self.model.opt.update(grads, opt_state, params, lr)


class BSP_Exchanger(Exchanger):
    """Bulk-synchronous exchange of gradients (``exch_mode='grads'``)."""

    name = "bsp"

    def __init__(self, config: Optional[dict] = None):
        super().__init__(config)
        self.mode = self.config.get("exch_mode", "grads")
        if self.mode != "grads":
            raise NotImplementedError(
                f"exch_mode={self.mode!r} is not ported yet; use 'grads'")
        self.strategy: Strategy = get_strategy(
            self.config.get("exch_strategy", "allreduce"))

    def step_update(self, params, opt_state, grads, lr):
        grads = self.strategy(grads, size=self.size)
        return self.model.opt.update(grads, opt_state, params, lr)


EXCHANGERS = {"bsp": BSP_Exchanger}


def get_exchanger(name: str, config: Optional[dict] = None) -> Exchanger:
    try:
        return EXCHANGERS[name.lower()](config)
    except KeyError:
        raise ValueError(f"unknown or not yet ported exchanger {name!r}; "
                         f"have {sorted(EXCHANGERS)}")
