"""The checks of the port's lint; importing this package registers them.

The host-concurrency pass (shared-state-race, lock-ordering,
signal-safety, daemon-discipline) runs on the engine's thread roles; the
protocol pass (wire-contract, retry-safety, state-machine) on the
endpoint model of ``analysis/protocol.py``; telemetry-hot-path is a
per-file walk; schema-drift probes live objects; oracle-pair reads the
kernel modules, the tests and ``chip_smoke.py`` from disk.

The dataflow half of the engine (its summaries) carries the checks of
what runs on the card and across ranks: the SPMD pass
(collective-discipline, exchange-symmetry, group-schema,
shard-rebuild-dominance), the capture pass (capture-purity, graph-key,
static-alias), rng-discipline, and the compile surface (cache-key,
graph-key, dtype-flow); package-boundary is a per-file walk.
"""

from . import (  # noqa: F401
    capture_purity,
    collective_discipline,
    compile_surface,
    donation_safety,
    exchange_symmetry,
    host_concurrency,
    oracle_pair,
    package_boundary,
    protocol_conformance,
    rng_discipline,
    schema_drift,
    telemetry_hot_path,
)

#: ``--only``/``--disable`` aliases, expanded before the names are
#: checked (so the cache keys on the real names)
CHECK_GROUPS = {
    "compile-surface": ("cache-key", "dtype-flow", "graph-key"),
    "concurrency": ("daemon-discipline", "lock-ordering",
                    "shared-state-race", "signal-safety"),
    "protocol": ("wire-contract", "retry-safety", "state-machine"),
    "spmd": ("collective-discipline", "exchange-symmetry", "group-schema",
             "shard-rebuild-dominance"),
}

#: The JAX lint's checks whose port counterpart has another name (each
#: redesigned for torch; the module docstrings say how).  Every other JAX
#: check keeps its name in the port.  ``--only``/``--disable`` take these
#: names as aliases.
JAX_COUNTERPARTS = {
    "trace-purity": "capture-purity",
    "retrace-hazard": "graph-key",
    "donation-safety": "static-alias",
    "sharding-schema": "group-schema",
    "compat-boundary": "package-boundary",
}
