"""The checks of the port's lint; importing this package registers them.

The host-concurrency pass (shared-state-race, lock-ordering,
signal-safety, daemon-discipline) runs on the engine's thread roles; the
protocol pass (wire-contract, retry-safety, state-machine) on the
endpoint model of ``analysis/protocol.py``; telemetry-hot-path is a
per-file walk; schema-drift probes live objects; oracle-pair reads the
kernel modules, the tests and ``chip_smoke.py`` from disk.
"""

from . import (  # noqa: F401
    host_concurrency,
    oracle_pair,
    protocol_conformance,
    schema_drift,
    telemetry_hot_path,
)

#: ``--only``/``--disable`` aliases, expanded before the names are
#: checked (so the cache keys on the real names)
CHECK_GROUPS = {
    "concurrency": ("daemon-discipline", "lock-ordering",
                    "shared-state-race", "signal-safety"),
    "protocol": ("wire-contract", "retry-safety", "state-machine"),
}
