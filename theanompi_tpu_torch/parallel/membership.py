"""Elastic membership: the part the wire needs.

Counterpart of ``theanompi_tpu/parallel/membership.py``, of which only
:class:`Backoff` is ported, a copy: the wire client's retries sleep by it.
Worker leases, the crash-loop breaker and the elastic supervisor are not
ported yet (ROADMAP A10).
"""

from __future__ import annotations

import random


class Backoff:
    """Bounded exponential backoff + jitter: ``base·factor^attempt`` capped
    at ``cap``, scaled by a uniform ``1 ± jitter`` draw so clients retrying
    against the same dead center don't retry in lockstep.

    ``seed`` makes this instance's draws deterministic on its own; ``rng``
    injects a shared ``random.Random``.  Default (neither): a fresh
    unseeded stream."""

    def __init__(self, base: float = 1.0, factor: float = 2.0,
                 cap: float = 30.0, jitter: float = 0.25, seed=None,
                 rng=None):
        self.base = float(base)
        self.factor = float(factor)
        self.cap = float(cap)
        self.jitter = float(jitter)
        assert rng is None or seed is None, \
            "Backoff takes seed= OR rng=, not both"
        self._rng = rng if rng is not None else random.Random(seed)

    def delay(self, attempt: int) -> float:
        d = min(self.base * (self.factor ** max(0, int(attempt))), self.cap)
        return d * (1.0 - self.jitter + 2.0 * self.jitter * self._rng.random())
