"""The virtual clock: the simulator's half of the ``utils/clock.py`` seam.

Counterpart of ``theanompi_tpu/simfleet/clock.py``.  The default
:class:`~theanompi_tpu_torch.utils.clock.WallClock` reads real time; this
clock is *advanced by the event loop*: ``now()`` returns whatever the last
processed event said it is.  Nothing in a simulation sleeps: a ``sleep()``
here is a programming error (the component should have scheduled an event
instead), and raising loudly is what keeps a 1,000-worker rehearsal inside
seconds of CPU.
"""

from __future__ import annotations

from ..utils.clock import Clock


class VirtualClock(Clock):
    """Manually-advanced time.  The event loop owns ``advance_to``;
    everything else only reads ``now()``."""

    def __init__(self, start: float = 0.0):
        self._now = float(start)

    def now(self) -> float:
        return self._now

    def advance_to(self, t: float) -> None:
        assert t >= self._now, \
            f"virtual time went backwards: {t} < {self._now}"
        self._now = float(t)

    def sleep(self, dt: float) -> None:
        raise RuntimeError(
            "VirtualClock.sleep(): a simulated component tried to block — "
            "schedule an event instead (nothing sleeps in virtual time)")
