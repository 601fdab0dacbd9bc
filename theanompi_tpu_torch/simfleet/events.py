"""Discrete-event core: the queue the fleet runs on and the log it
proves itself with.

Counterpart of ``theanompi_tpu/simfleet/events.py``, the same
serialization byte for byte: the port's event log hashes equal to the JAX
package's for the same run.

**Queue.**  A heap of ``(time, seq, fn)``; ``seq`` is a monotonically
increasing tiebreaker, so two events at the same virtual instant fire in
scheduling order — the property that makes the whole simulation a total
order and therefore replayable.  Handlers take no arguments (bind state
via closure/partial) and schedule follow-ups through ``push``.

**Log.**  Append-only structured records with virtual timestamps,
serialized canonically (sorted keys, fixed separators, timestamps
rounded to µs) so *same seed ⇒ byte-identical bytes* is a meaningful
claim; :meth:`EventLog.sha256` is the determinism gate's whole
comparison.  The log records decisions (transitions, faults, windows,
respawns), not traffic — a 10⁷-round run logs thousands of lines, not
millions.
"""

from __future__ import annotations

import hashlib
import heapq
import json
from typing import Callable, List, Optional


class EventQueue:
    """Deterministic min-heap event queue over virtual seconds."""

    def __init__(self, clock):
        self.clock = clock
        self._heap: list = []
        self._seq = 0
        self.processed = 0

    def push(self, t: float, fn: Callable[[], None]) -> None:
        assert t >= self.clock.now() - 1e-9, \
            f"scheduling into the past: {t} < {self.clock.now()}"
        self._seq += 1
        heapq.heappush(self._heap, (float(t), self._seq, fn))

    def run(self, until: Optional[float] = None,
            max_events: Optional[int] = None) -> int:
        """Drain events (advancing the clock to each) until the queue is
        empty, virtual ``until`` is reached, or ``max_events`` fired.
        Returns the number of events processed by THIS call."""
        n = 0
        while self._heap:
            if until is not None and self._heap[0][0] > until:
                break
            if max_events is not None and n >= max_events:
                break
            t, _, fn = heapq.heappop(self._heap)
            self.clock.advance_to(t)
            fn()
            n += 1
        self.processed += n
        return n

    def __len__(self) -> int:
        return len(self._heap)


class EventLog:
    """Canonical, hashable record of what the simulation decided."""

    def __init__(self):
        self.records: List[dict] = []

    def append(self, t: float, ev: str, **fields) -> None:
        rec = {"t": round(float(t), 6), "ev": str(ev)}
        rec.update(fields)
        self.records.append(rec)

    # -- canonical serialization --------------------------------------------

    @staticmethod
    def _line(rec: dict) -> str:
        return json.dumps(rec, sort_keys=True, separators=(",", ":"))

    def to_jsonl(self) -> str:
        return "".join(self._line(r) + "\n" for r in self.records)

    def sha256(self) -> str:
        h = hashlib.sha256()
        for r in self.records:
            h.update(self._line(r).encode())
            h.update(b"\n")
        return h.hexdigest()

    def write(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_jsonl())

    def select(self, *kinds: str) -> List[dict]:
        return [r for r in self.records if r["ev"] in kinds]
