"""Numerics health plane.

Counterpart of ``theanompi_tpu/utils/numerics.py``.  Three pieces:

* **In-step tensor statistics**: grad, param and update global L2 norms,
  grad max-abs, the nonfinite count and the update-to-param ratio,
  computed inside the train step (inside the captured CUDA graph on the
  card) at a ``numerics_every`` cadence and kept on the device as one
  ``[n_workers, len(SAMPLE_KEYS)]`` float32 buffer.  The host reads it at
  print cadence, when it already reads the cost.
* **Cross-rank consistency beacons**: a dtype-stable float digest
  (per-leaf weighted float32 sums) of the tree the exchange rule keeps
  bit-identical on every rank (``Exchanger.numerics_extra``: the params
  under BSP grads mode with a reducing strategy, the center under
  EASGD/ASGD).  One ``all_gather`` of the sample over the workers group
  is the JAX package's boxed ``[n_workers]`` aux: the host compares the
  ranks' digests, and a desync shows as ``divergence > 0``.  Rules with
  no replicated tree (GoSGD, BSP params mode, ``none``) mark the beacon
  invalid.
* **The EASGD/ASGD distance** ``‖w_i − c‖`` and the compressed wires'
  error-state norm (``ef_norm``).

Where the JAX package's ``lax.cond`` picks the sampled branch inside the
program, the port's step picks WHICH graph it replays (the host's
predicate, ``steps.TrainStep._numerics_step``): a call with no sampled
step runs the very graph the plane-off step runs, and its report is the
template (``iter = -1``), held on the host.  A sampled step keeps a
float32 copy of the params before the update (the update is in place)
and subtracts it after.  Every statistic reads values the step already
holds and writes none of them, so the params, the optimizer state, the
extra state and the costs are bit-equal with the plane on and off.

The module imports torch inside :class:`GraphPlan`'s methods only: the
host half (:func:`host_report`, :func:`record`) is stdlib.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

# -- schema -----------------------------------------------------------------

# Aux-pytree keys every sampled step carries out of the dispatch (per-worker
# f32 scalars; the host sees [n_workers] per key).  Fixed across rules —
# concepts a rule lacks read 0.0 with the matching validity flag down.
SAMPLE_KEYS = ("iter", "grad_norm", "grad_max_abs", "nonfinite",
               "param_norm", "update_norm", "update_ratio",
               "digest", "beacon", "dist_center", "ef_norm")

# Telemetry gauge vocabulary `record` emits under the one-`enabled`-check
# contract.
NUMERICS_GAUGES = ("numerics.grad_norm", "numerics.grad_max_abs",
                   "numerics.nonfinite", "numerics.param_norm",
                   "numerics.update_norm", "numerics.update_ratio",
                   "numerics.divergence", "numerics.dist_center",
                   "numerics.ef_norm")

# Histograms (distributions across reports, p95/p99 in telemetry_report)
NUMERICS_HISTOGRAMS = ("numerics.grad_norm", "numerics.update_ratio")

# The event kind one report emits (telemetry_report TRACKED_EVENTS member;
# its numeric fields become Perfetto counter tracks)
NUMERICS_EVENT = "numerics"

# Sentry anomaly kinds the numerics detectors raise (a subset of
# sentry.ANOMALY_KINDS)
SENTRY_KINDS = ("grad_overflow", "update_ratio_collapse",
                "replica_divergence")

DEFAULT_EVERY = 1


def enabled(config) -> bool:
    """The ONE config gate: ``numerics=true``."""
    return bool((config or {}).get("numerics", False))


def cadence(config) -> int:
    return max(1, int((config or {}).get("numerics_every", DEFAULT_EVERY)))


def _leaf_weight(i: int) -> float:
    """Deterministic per-leaf digest weight in [0.5, 1.5): a Knuth-hash LCG
    on the leaf index.  Distinct weights keep two
    leaves' corruptions from cancelling in the digest sum.  The index is
    the leaf's position in the JAX package's flatten order."""
    return 0.5 + ((i * 2654435761) % 65536) / 65536.0


# -- the in-step plane (torch imported when a step samples) -------------------

class GraphPlan:
    """The numerics sampler of one train step (``steps.TrainStep``), made
    only when the plane is on (:func:`graph_plan`).

    Per leaf, every statistic is a float32 sum (or max) on the device; under
    a model-parallel grid the sums of the leaves a grid axis splits are
    all-reduced over that axis's group (a replicated leaf counted once) and
    the max is all-reduced over every grid group, the JAX ``_tree_sq`` /
    ``_tree_max_abs`` / ``_digest`` algebra on ``split_axes_leaves``.
    """

    def __init__(self, model, exchanger):
        self.model = model
        self.exchanger = exchanger
        self.every = cadence(model.config)
        self._old = None          # float32 copies of the params (lazy)
        self._weights = {}        # device -> digest weights, JAX order
        self._split = None

    def template(self) -> List[float]:
        """The not-yet-sampled value: zeros with ``iter = -1`` (the host
        report treats a negative iter as 'no sample yet')."""
        out = [0.0] * len(SAMPLE_KEYS)
        out[SAMPLE_KEYS.index("iter")] = -1.0
        return out

    def sampled_step(self, first: int, n_steps: int) -> int:
        """The last step ``j`` of a call of ``n_steps`` steps from count
        ``first`` whose count is due (``count % every == 0``), or -1: the
        JAX carry keeps the latest sample of a window, and a call starts
        from the template."""
        for j in range(n_steps - 1, -1, -1):
            if (first + j) % self.every == 0:
                return j
        return -1

    # -- the grid algebra -----------------------------------------------------

    def _axes(self) -> list:
        if self._split is None:
            fn = getattr(self.model, "split_axes_leaves", None)
            self._split = list(fn()) if fn is not None else []
        return self._split

    def _groups(self):
        grid = getattr(self.model, "grid", None)
        if grid is None:
            return []
        return [grid.group(a) for a in grid.AXES if grid.size(a) > 1]

    def _global_sum(self, per_leaf):
        """Σ over the leaves of ``per_leaf`` (a ``[L]`` float32 tensor), each
        leaf's term summed over the groups of the axes that split it."""
        import torch
        split = self._axes()
        if not any(split):
            return per_leaf.sum()
        from ..parallel.tp import all_reduce
        grid = self.model.grid
        total = None
        for axes in sorted(set(split), key=lambda a: (len(a), a)):
            # picked by index: views of ``per_leaf``, no host → device
            # copy (a captured step refuses one)
            part = torch.stack([per_leaf[i] for i, a in enumerate(split)
                                if a == axes]).sum()
            for axis in reversed(axes):
                part = all_reduce(part, grid.group(axis))
            total = part if total is None else total + part
        return total

    def _all_groups(self, x, op=None):
        """``x`` reduced (SUM, or ``op``) over every grid group."""
        from ..parallel.tp import all_reduce
        for g in self._groups():
            x = all_reduce(x, g, op)
        return x

    @staticmethod
    def _sq(leaves):
        """``[L]`` float32: each leaf's Σx² (its float32 L2 norm, squared)."""
        import torch
        return torch.stack(torch._foreach_norm(
            [x.detach().float() for x in leaves])).square()

    def _digest_weights(self, like):
        w = self._weights.get(like.device)
        if w is None:
            import torch

            from .helper_funcs import jax_leaf_paths, leaf_paths
            pos = {p: i for i, p in enumerate(jax_leaf_paths(
                self.model.params))}
            w = self._weights[like.device] = torch.tensor(
                [_leaf_weight(pos[p]) for p in leaf_paths(self.model.params)],
                dtype=torch.float32, device=like.device)
        return w

    # -- the sample -----------------------------------------------------------

    def grad_stats(self, grads):
        """The gradient's statistics, taken before the update (a wire
        reduces the gradient in place): ``(Σg² per leaf, max|g|, the
        nonfinite count)``, device tensors."""
        import torch
        leaves = [g.detach() for g in grads]
        sq = self._sq(leaves)
        mx = torch.stack(torch._foreach_norm(
            [g.float() for g in leaves], float("inf"))).max()
        # g·0 is 0 where g is finite and NaN where it is not
        nf = torch.stack([z.isnan().sum(dtype=torch.float32)
                          for z in torch._foreach_mul(leaves, 0.0)])
        return sq, mx, nf

    def keep_old(self, params) -> list:
        """Float32 copies of the params before the update (buffers made
        once, refilled at every sampled step)."""
        import torch
        if self._old is None:
            self._old = [torch.empty_like(p, dtype=torch.float32)
                         for p in params]
        torch._foreach_copy_(self._old, [p.detach() for p in params])
        return self._old

    def compute(self, old, params, gstats, extra, it, out) -> None:
        """One sample into ``out`` (``[len(SAMPLE_KEYS)]`` float32): the
        statistics of the step that moved the params from ``old`` to
        ``params`` (``it``, a 0-d float32 tensor, its count).  Pure reads
        of values the step holds."""
        import torch
        import torch.distributed as dist
        gsq, gmax, gnf = gstats
        new = [p.detach().float() for p in params]
        grad_norm = self._global_sum(gsq).sqrt()
        param_norm = self._global_sum(self._sq(new)).sqrt()
        update_norm = self._global_sum(
            self._sq(torch._foreach_sub(new, old))).sqrt()
        zero = torch.zeros((), dtype=torch.float32, device=out.device)
        vals = {
            "iter": it,
            "grad_norm": grad_norm,
            "grad_max_abs": self._all_groups(gmax, dist.ReduceOp.MAX),
            "nonfinite": self._global_sum(gnf),
            "param_norm": param_norm,
            "update_norm": update_norm,
            "update_ratio": update_norm / torch.clamp(param_norm, min=1e-30),
            "digest": zero, "beacon": zero, "dist_center": zero,
            "ef_norm": zero,
        }
        nx = self.exchanger.numerics_extra(self.model.params, extra)
        beacon = nx.get("beacon_tree")
        if beacon is not None:
            sums = torch.stack([x.detach().sum(dtype=torch.float32)
                                for x in beacon])
            vals["digest"] = self._global_sum(
                self._digest_weights(out) * sums)
            vals["beacon"] = torch.ones((), dtype=torch.float32,
                                        device=out.device)
        center = nx.get("center")
        if center is not None:
            vals["dist_center"] = self._global_sum(self._sq(
                torch._foreach_sub(new, [c.detach().float()
                                         for c in center]))).sqrt()
        ef = nx.get("ef_state")
        if ef is not None:
            # error feedback differs per rank: every rank's local Σx²
            # summed over every grid group
            vals["ef_norm"] = self._all_groups(self._sq(ef).sum()).sqrt()
        out.copy_(torch.stack([vals[k].reshape(()) for k in SAMPLE_KEYS]))


def graph_plan(model, exchanger) -> Optional[GraphPlan]:
    """The step's sampler when the plane is on, else None (the step then
    never touches numerics).  FSDP's params are views of a buffer each step
    gathers, with no params-shaped replica to sample: the plane stays off
    there, as in the JAX package."""
    if not enabled(getattr(model, "config", None)):
        return None
    if getattr(model, "_fsdp", None) is not None:
        return None
    return GraphPlan(model, exchanger)


def aux_dict(buf) -> Dict[str, Any]:
    """The ``[n_workers, len(SAMPLE_KEYS)]`` sample buffer as the JAX
    package's aux: a dict of ``[n_workers]`` columns."""
    return {k: buf[:, i] for i, k in enumerate(SAMPLE_KEYS)}


def to_host(aux) -> Optional[Dict[str, List[float]]]:
    """The aux as host lists (a read back of the device buffer)."""
    if aux is None:
        return None
    return {k: [float(x) for x in (v.tolist() if hasattr(v, "tolist")
                                   else v)] for k, v in aux.items()}


# -- host plane (stdlib only) -----------------------------------------------

def host_report(aux) -> Optional[Dict[str, Any]]:
    """Fold the device aux (dict of ``[n_workers]`` arrays, already
    ``device_get``'d) into one host report dict, or None while no sample
    has landed yet (``iter < 0``).

    Aggregation is worst-rank: max norms/ratios, summed nonfinite counts;
    ``divergence`` is ``max_i |digest_i − digest_0|`` over ranks whose
    beacon is valid (None when the rule declares no beacon)."""
    if aux is None:
        return None
    vals = {k: [float(x) for x in aux[k]] for k in SAMPLE_KEYS if k in aux}
    iters = vals.get("iter", [])
    if not iters or max(iters) < 0:
        return None
    n = len(iters)
    report: Dict[str, Any] = {
        "iter": int(max(iters)),
        "n_workers": n,
        "per_rank": vals,
        "grad_norm": max(vals["grad_norm"]),
        "grad_max_abs": max(vals["grad_max_abs"]),
        "nonfinite": sum(vals["nonfinite"]),
        "param_norm": max(vals["param_norm"]),
        "update_norm": max(vals["update_norm"]),
        "update_ratio": min(vals["update_ratio"]),
        "dist_center": max(vals["dist_center"]),
        "ef_norm": max(vals["ef_norm"]),
    }
    beacon = vals.get("beacon", [0.0] * n)
    digests = vals.get("digest", [0.0] * n)
    valid = [d for d, b in zip(digests, beacon) if b > 0]
    if len(valid) >= 2:
        # bitwise-equal replicas give exactly-equal digests; compare
        # against rank 0's so a single desynced rank shows as > 0.  A
        # non-finite digest is itself a divergence signal (a corrupted
        # replica whose params went inf/nan still must trip the beacon —
        # nan diffs would slip through a bare max()'s comparisons).
        ref = valid[0]
        diffs = [abs(d - ref) for d in valid]
        report["divergence"] = float("inf") if any(
            not math.isfinite(x) for x in diffs) else max(diffs)
    else:
        report["divergence"] = None
    return report


def example_report(n: int = 2) -> Dict[str, Any]:
    """A schema-complete healthy report (checker probes, tests)."""
    aux = {k: [0.0] * n for k in SAMPLE_KEYS}
    aux["iter"] = [1.0] * n
    aux["beacon"] = [1.0] * n
    aux["param_norm"] = [1.0] * n
    aux["grad_norm"] = [0.5] * n
    aux["update_norm"] = [0.01] * n
    aux["update_ratio"] = [0.01] * n
    return host_report(aux)


def record(tm, report, *, rank: Optional[int] = None) -> None:
    """Emit one report into telemetry: every NUMERICS_GAUGES gauge, the
    NUMERICS_HISTOGRAMS distributions, and one NUMERICS_EVENT carrying the
    numeric fields (the Perfetto counter tracks + flight-ring context).
    ONE ``enabled`` check guards the whole emission (§11 contract)."""
    if not tm.enabled or report is None:
        return
    div = report.get("divergence")
    gauges = {
        "numerics.grad_norm": report["grad_norm"],
        "numerics.grad_max_abs": report["grad_max_abs"],
        "numerics.nonfinite": report["nonfinite"],
        "numerics.param_norm": report["param_norm"],
        "numerics.update_norm": report["update_norm"],
        "numerics.update_ratio": report["update_ratio"],
        "numerics.divergence": 0.0 if div is None else div,
        "numerics.dist_center": report["dist_center"],
        "numerics.ef_norm": report["ef_norm"],
    }
    for name, value in gauges.items():
        tm.gauge(name, value)
    for name in NUMERICS_HISTOGRAMS:
        tm.observe(name, gauges[name])
    fields = {k: report[k] for k in ("iter", "grad_norm", "grad_max_abs",
                                     "nonfinite", "param_norm",
                                     "update_norm", "update_ratio",
                                     "dist_center", "ef_norm")}
    fields["divergence"] = div
    fields["beacon"] = int(div is not None)
    if rank is not None:
        fields["rank"] = rank
    tm.event(NUMERICS_EVENT, **fields)
