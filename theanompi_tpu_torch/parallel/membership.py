"""Elastic membership: the parts the wire and the launcher need.

Counterpart of ``theanompi_tpu/parallel/membership.py``, of which
:class:`Backoff` (the wire client's retries and the launcher's supervised
restarts sleep by it), :class:`CrashLoopBreaker` (the launcher's
``--crash-limit``) and :func:`flight_tail_lines` (what the supervisor
prints of a dead world's flight recording) are ported, copies.  Worker
leases and the elastic supervisor are not ported yet (ROADMAP A10).
"""

from __future__ import annotations

import glob
import json
import os
import random
from collections import deque
from typing import List, Optional

from ..utils.clock import WALL


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


class CrashLoopBreaker:
    """``limit`` failures inside a trailing ``window_s`` window mean the
    failure is systemic (bad config, poisoned checkpoint, dead backend):
    retrying forever just hides it.  ``record_failure()`` returns True when
    the breaker trips; the launcher then exits nonzero."""

    def __init__(self, limit: int = 5, window_s: float = 300.0,
                 clock=None):
        self.limit = int(limit)
        self.window_s = float(window_s)
        self.clock = clock or WALL
        self._times: deque = deque()

    def record_failure(self, now: Optional[float] = None) -> bool:
        now = self.clock.now() if now is None else now
        self._times.append(now)
        while self._times and now - self._times[0] > self.window_s:
            self._times.popleft()
        return len(self._times) >= self.limit


def flight_tail_lines(record_dir: str, n: int = 12) -> List[str]:
    """The last ``n`` events of the NEWEST flight recording under
    ``record_dir`` (crash sweeps included), one per line: what a crash-loop
    exit prints so the death isn't silent."""
    paths = (glob.glob(os.path.join(record_dir, "flight_rank*.jsonl")) +
             glob.glob(os.path.join(record_dir, "crash_*",
                                    "flight_rank*.jsonl")))
    if not paths:
        return []
    newest = max(paths, key=os.path.getmtime)
    lines: List[str] = [f"flight tail ({newest}):"]
    try:
        with open(newest) as f:
            raw = [ln.strip() for ln in f if ln.strip()]
    except OSError:
        return []
    for ln in raw[-n:]:
        try:
            ev = json.loads(ln)
        except ValueError:
            continue
        detail = {k: v for k, v in ev.items()
                  if k not in ("ts", "run", "rank", "ev")}
        lines.append(f"  ts={ev.get('ts')} rank={ev.get('rank')} "
                     f"{ev.get('ev')} {detail}")
    return lines
