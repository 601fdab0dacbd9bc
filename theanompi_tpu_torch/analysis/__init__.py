"""The port's lint: whole-program checks of ``theanompi_tpu_torch`` and of
``chip_smoke.py``.

21 checks, the JAX lint's each redesigned for the port: the
host-concurrency pass (shared-state-race, lock-ordering, signal-safety,
daemon-discipline) over the engine's call graph and thread roles
(``engine.py``); the wire's contracts (wire-contract, retry-safety,
state-machine) over the endpoint model (``protocol.py``);
telemetry-hot-path; schema-drift, which probes live objects; oracle-pair,
which holds every CUDA kernel to its plain version, its CPU test and its
card comparison; and, on the engine's dataflow half (summaries of
collectives, point-to-point and seeds closed over the call graph), the
SPMD checks (collective-discipline, exchange-symmetry, group-schema,
shard-rebuild-dominance), the capture checks (capture-purity, graph-key,
static-alias), rng-discipline, the compile surface (cache-key, graph-key,
dtype-flow) and package-boundary.  ``python -m
theanompi_tpu_torch.tools.lint`` runs them (``cli.py``).

The package is stdlib; schema-drift's probes import the port's modules
they probe.  Nothing here imports ``jax`` or the JAX package.

A finding is silenced on its line (or the line after a comment of its
own) by ``# tpulint: disable=<check>[,<check>...]``.  Findings kept on
purpose live in ``tpulint_torch_baseline.json``, one justification each.
"""

from . import checkers as _checkers  # noqa: F401  (registers the checks)
from .core import (CHECKERS, Checker, Finding, SourceFile,  # noqa: F401
                   collect_files, compare_baseline, load_baseline, run_lint,
                   save_baseline)

__all__ = ["CHECKERS", "Checker", "Finding", "SourceFile", "collect_files",
           "compare_baseline", "load_baseline", "run_lint", "save_baseline"]
