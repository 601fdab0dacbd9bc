"""simfleet: a deterministic virtual-time fleet simulator.

Counterpart of ``theanompi_tpu/simfleet/``, driving the port's own
survivability code.  The elastic plane is real code exercised small on
the card: a few processes, wall-clock minutes.  simfleet rehearses the SAME
code at production width — hundreds to thousands of workers, tens of
thousands of exchange rounds, seconds of CPU — by replacing processes,
sockets and sleeps with a seeded discrete-event loop over a virtual clock:

* the **real** :class:`~theanompi_tpu_torch.parallel.membership
  .MembershipController` state machine (lease folding, dead-ts
  resurrection guard, straggler demotion with the cumulative base),
* the **real** reactors (:class:`~...membership.CenterReactor` island
  demote/readmit, :class:`~...membership.MeshReactor` GoSGD derangement
  regeneration via ``parallel/topology.py``),
* the **real** :class:`~theanompi_tpu_torch.parallel.wire.DedupWindow`
  claim/record/HWM semantics and :class:`~...membership.Backoff`,
* the **real** chaos grammar: ``chaos.parse_schedule`` /
  ``chaos.seeded_schedule`` faults applied by the proxy's own
  window-membership rule (``chaos.fault_window_active``),
* the **real** fleet-health collector and rules (``utils/fleetmon.py``).

Same seed ⇒ byte-identical event log (``EventLog.sha256``), and the same
bytes as the JAX package's FleetSim for the same arguments.  The fidelity
mode exports the realized simulated schedule and replays it through the
live ChaosProxy/ChaosMonkey at small scale, asserting the same
membership-event sequence modulo timing (``simfleet.fidelity``).

Entry points: ``python -m theanompi_tpu_torch.tools.simfleet_run`` (CLI,
determinism gate, fidelity cross-check) and :class:`simfleet.fleet.FleetSim`.
The package imports the stdlib, numpy and the port's host-side modules;
only ``drill`` (the live islands' default model) imports torch.
"""

from .clock import VirtualClock                              # noqa: F401
from .events import EventLog, EventQueue                     # noqa: F401
from .fleet import FleetSim                                  # noqa: F401
from .health import HealthPlane                              # noqa: F401
from .invariants import check_invariants                     # noqa: F401
