"""The clock seam: every host-side *decision* clock behind one interface.

A copy of ``theanompi_tpu/utils/clock.py`` (the port imports nothing of
the JAX package).  The wire's retry deadlines, backoff sleeps and the
seed of its request sequence numbers compare times; they read them
through a :class:`Clock`, so a simulator can drive the same logic in
virtual time (the JAX package's simfleet, not ported).

* :class:`Clock` — the two-method contract (``now()``/``sleep()``).
* :class:`WallClock` / :data:`WALL` — the default: ``now()`` is
  ``time.time()``, ``sleep()`` is ``time.sleep()``.

Decision logic only: log lines and measured durations stay on wall time.
"""

from __future__ import annotations

import time


class Clock:
    """The injectable time source.  ``now()`` returns seconds (an opaque,
    monotonically comparable epoch); ``sleep(dt)`` blocks the caller for
    ``dt`` of those seconds."""

    def now(self) -> float:
        raise NotImplementedError

    def sleep(self, dt: float) -> None:
        raise NotImplementedError


class WallClock(Clock):
    """Real time (``now`` IS ``time.time``)."""

    def now(self) -> float:
        return time.time()

    def sleep(self, dt: float) -> None:
        if dt > 0:
            time.sleep(dt)


#: The process-wide default.  ``clock or WALL`` is the idiom every
#: seam-carrying constructor uses.
WALL = WallClock()
