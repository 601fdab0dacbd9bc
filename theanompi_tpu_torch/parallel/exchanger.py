"""Exchangers: the four parallelism rules.

Counterpart of ``theanompi_tpu/parallel/exchanger.py``:

* ``BSP_Exchanger``: ``exch_mode='grads'`` (default): the selected
  strategy averages the gradients over the ranks inside the step, then
  every rank applies the same update — N ranks train as one rank on the
  N-fold batch.  ``exch_mode='params'``: the reference's own cadence —
  each rank applies its LOCAL gradient (its momentum its own), and the
  exchange after the step averages the parameters through the strategy.
  A stateful strategy's per-rank state rides in the model's
  ``extra["strat"]``, as in the JAX package: a flat tensor (the error
  feedback of onebit and topk) or a per-leaf list of ``{"q", "e"}``
  (PowerSGD).  ``sync_bn`` averages the BatchNorm running stats after each
  update in both modes.
* ``EASGD_Exchanger``, ``ASGD_Exchanger`` and ``GOSGD_Exchanger``: each
  rank trains locally (its own gradient, its own BatchNorm stats) and,
  every ``exchange_freq`` steps, the rule's exchange mixes the replicas —
  the JAX package's synchronous-cadence forms, with the same algebra:
  EASGD's elastic pull toward a center every rank keeps a copy of, ASGD's
  downpour sum into the center and reset to it, GoSGD's gossip of
  ``(α·params, α)`` halves between random peers.

``grad_clip`` (global L2 norm, off by default) scales the gradient the
optimizer consumes: BSP's reduced one, an async rule's local one.

The exchange has two dispatch shapes, as in the JAX package: at
``steps_per_call = 1`` the worker calls :meth:`Exchanger.exchange` after
each train step (``parallel/steps.ExchangeStep``, a CUDA graph of its own
on the card); at ``steps_per_call > 1`` the train step's window runs it
after each due step itself (``fused``) and the worker's hook stands down.
Every update is in place: the step and the exchange never rebind the
model's params, optimizer state or ``extra``, so a captured step replays
on the tensors it was captured with.  An async island's step (the
islands around a center, ``parallel/async_easgd.py``) runs under
:class:`LocalExchanger`, with no collective at all.

``bucket_bytes > 0`` is the bucketed wire (``parallel/buckets.py``): BSP
hands it to its strategy, EASGD and ASGD sum their deltas by the
planner's buckets, and GoSGD sends its message as one point-to-point
message a bucket.

Elastic membership (``parallel/membership.py``'s ``MeshReactor``):
:meth:`Exchanger.set_active_ranks` shrinks the set of ranks the async
rules mix without stopping the run.  A demoted rank trains locally and
keeps issuing every collective of the exchange, in the same order, with
zeros as its share (each rank is a process of its own, and a skipped
all-reduce would hang the group); its replica, and GoSGD's α, stay bit
for bit as they were, while its copy of a center takes the same update
as every other rank's.  BSP refuses: its reaction is the supervised
world restart (``launcher --supervise``).

``update_sharding=true`` at world > 1 shards the extra state a rule keeps
identical on every rank (``shardable_extra``: the EASGD and ASGD centers)
by the leaf-wise plan of ``parallel/update_sharding.py``: each rank keeps
its ``[chunk]`` of every large center leaf, and the exchange gathers the
full center (one all-gather per dtype), runs the unchanged algebra, and
stores its windows back.  GoSGD's α and the strategies' error feedback
differ per rank and are never planned.  :meth:`Exchanger.identical_parts`
names the state parts a checkpoint may keep once for all ranks.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.profiler import record_function

from ..utils import devprof, telemetry, tracing
from ..utils.helper_funcs import tree_leaves, tree_map
from . import buckets, topology
from . import update_sharding as ushard
from .steps import _like, step_seed
from .strategies import Strategy, get_strategy

# GoSGD's draws: the send gate from (gosgd_seed, rank, count), the route
# from (gosgd_seed, count); tags that keep them apart from each other and
# from the dropout streams (``steps.step_seed`` of three keys)
_GATE_TAG, _ROUTE_TAG = 0x605, 0x1d1


def summed(leaves) -> list:
    """The SUM over the ranks of ``leaves``: one all-reduce of their
    concatenation (new tensors), returned as views shaped like the
    leaves."""
    flat = torch.cat([t.reshape(-1) for t in leaves])
    dist.all_reduce(flat)
    return [v.view_as(t) for v, t in
            zip(flat.split([t.numel() for t in leaves]), leaves)]


class Exchanger:
    """Base: a purely local optimizer step (the async rules train locally
    between exchanges) and no exchange."""

    name = "exchanger"
    # True when the exchange draws random numbers (GoSGD's send gate)
    uses_draws = False
    # True when the step reduces over the ranks of a process group (its
    # metrics' all-reduce at least); False for an async island's step
    collective = True

    def __init__(self, config: Optional[dict] = None):
        self.config = dict(config or {})
        self.model = None
        self.size = 1
        self.exchange_freq = 1
        # set by ``compile_iter_fns``: the train step's window runs the
        # exchange (steps_per_call > 1), so :meth:`exchange` stands down
        self.fused = False
        self.clip = float(self.config.get("grad_clip", 0.0) or 0.0)
        # the bucketed wire: > 0 splits the exchange's collectives into
        # ~bucket_bytes slices; a schedule only (bucketed ≡ monolithic)
        self.bucket_bytes = int(self.config.get("bucket_bytes", 0) or 0)
        self.plan: Optional[buckets.BucketPlan] = None
        self.rank = 0
        # update_sharding's plan over shardable_extra (None: inactive)
        self._ushard_plan: Optional[ushard.UpdatePlan] = None
        self._ushard_keys: tuple = ()
        # elastic membership: None, every rank mixes; else the sorted
        # tuple of the active ranks (set_active_ranks)
        self._active_ranks: Optional[tuple] = None

    def prepare(self, model, size: int) -> None:
        self.model = model
        self.size = int(size)
        # this rank's place in the update plan (one rank: no plan)
        self.rank = int(model.rank) if self.size > 1 else 0
        self.plan = buckets.plan_buckets(model.params, self.bucket_bytes) \
            if self.bucket_bytes > 0 else None
        self._build_update_plan()

    def identical_parts(self) -> tuple:
        """State parts identical on every rank, which a checkpoint keeps
        once (a part at a time): none here; see
        :meth:`BSP_Exchanger.identical_parts`."""
        return ()

    # -- update-plane sharding of the extra state ----------------------------

    def shardable_extra(self) -> tuple:
        """Extra-state keys whose leaves are identical on every rank, the
        only extra state ``update_sharding`` may chunk."""
        return ()

    def _build_update_plan(self) -> None:
        """The plan over :meth:`shardable_extra` under ``update_sharding``;
        inactive (None) when nothing is shardable, at world 1, or when no
        leaf reaches ``ushard_min_bytes``."""
        self._ushard_plan, self._ushard_keys = None, ()
        keys = tuple(sorted(self.shardable_extra()))
        if not self.config.get("update_sharding") or not keys or \
                self.size <= 1:
            return
        full = self._extra_full_template()
        plan = ushard.plan_tree({k: full[k] for k in keys}, self.size,
                                min_bytes=int(self.config.get(
                                    "ushard_min_bytes",
                                    ushard.DEFAULT_MIN_BYTES)))
        if plan.any_sharded:
            self._ushard_plan, self._ushard_keys = plan, keys

    def update_plan(self) -> Optional[ushard.UpdatePlan]:
        """The active plan of the shardable extra keys, or None."""
        return self._ushard_plan

    def unshard_extra(self, extra) -> dict:
        """``extra`` with the plan's keys rebuilt to their full values from
        every rank's chunks (one all-gather per dtype; new tensors for the
        sharded leaves); ``extra`` itself when the plan is inactive."""
        plan = self.update_plan()
        if plan is None:
            return extra
        full = ushard.unshard_tree({k: extra[k] for k in self._ushard_keys},
                                   plan)
        return dict(extra, **full)

    def reshard_extra(self, full_sub, extra) -> None:
        """This rank's windows of the updated full values ``full_sub`` (the
        plan's keys) stored back into ``extra``'s chunks, in place; nothing
        when the plan is inactive."""
        plan = self.update_plan()
        if plan is not None:
            ushard.reshard_into({k: extra[k] for k in self._ushard_keys},
                                {k: full_sub[k] for k in self._ushard_keys},
                                plan, self.rank)

    def extra_host_boxed(self, n: int) -> dict:
        """The extra state's initial values as host ``[n, ...]`` rows while
        the plan is active: a plan key's rows are the ranks' chunks, every
        other key's a copy for each rank."""
        plan = self.update_plan()
        if plan is None:
            raise ValueError("extra_host_boxed needs an active plan")
        full = tree_map(lambda t: t.detach().cpu().numpy(),
                        self._extra_full_template())
        out = ushard.shard_host_boxed(
            {k: full[k] for k in self._ushard_keys}, plan)
        for k, v in full.items():
            if k not in self._ushard_keys:
                out[k] = tree_map(lambda x: np.broadcast_to(
                    x[None], (n,) + x.shape).copy(), v)
        return out

    def _extra_full_template(self) -> Dict[str, Any]:
        """The per-rank extra state at its full shapes, initial values: a
        rule overrides this, not :meth:`extra_state_template`."""
        return {}

    def n_buckets(self) -> Optional[int]:
        """Collectives one exchange issues under ``bucket_bytes`` (None on
        the monolithic wire): the planner's buckets of the params."""
        return None if self.plan is None else self.plan.n_buckets

    def _sum_tree(self, tree) -> None:
        """Each leaf of the params-shaped ``tree`` replaced by its SUM over
        the ranks, in place: one all-reduce a leaf, or one a bucket."""
        buckets.bucketed_all_reduce(tree, self.bucket_bytes, self.plan)

    def extra_state_template(self) -> Dict[str, Any]:
        """The per-rank state the step carries besides params and optimizer
        state: the full template, with the plan's keys cut to this rank's
        ``[chunk]`` windows while ``update_sharding`` is active."""
        full = self._extra_full_template()
        plan = self.update_plan()
        if plan is None:
            return full
        sub = ushard.shard_tree({k: full[k] for k in self._ushard_keys},
                                plan, self.rank)
        return dict(full, **sub)

    # -- in the step ---------------------------------------------------------

    def _clip_grads(self, grads):
        """Global-L2-norm clipping (config ``grad_clip``; off at 0): every
        leaf times ``min(1, clip / max(‖g‖, 1e-12))``, the norm the square
        root of the float32 sum of every leaf's squares.  The scale stays a
        device tensor (no read back, no branch on it), and each leaf keeps
        its dtype; returns new tensors."""
        if self.clip <= 0.0:
            return grads
        leaves = tree_leaves(grads)
        norms = torch._foreach_norm([g.float() for g in leaves])
        split = self._split_axes()
        if any(split):
            # model parallelism: a split leaf's squares summed over the
            # groups that split it, a replicated one counted once, so every
            # rank clips by the same global norm (exchanger.py:378-400
            # there); the leaves split alike summed together, in a fixed
            # order of their axes
            from .tp import all_reduce
            sq = torch.stack(norms).square()
            grid = self.model.grid
            total = None
            for axes in sorted(set(split), key=lambda a: (len(a), a)):
                # the leaves split alike, picked by index: views of ``sq``,
                # no host → device copy (a captured step refuses one)
                part = torch.stack([sq[i] for i, a in enumerate(split)
                                    if a == axes]).sum()
                for axis in reversed(axes):
                    part = all_reduce(part, grid.group(axis))
                total = part if total is None else total + part
            norm = total.sqrt()
        else:
            norm = torch.stack(norms).square().sum().sqrt()
        scale = torch.clamp(self.clip / torch.clamp(norm, min=1e-12),
                            max=1.0)
        it = iter(torch._foreach_mul(leaves, scale))
        return tree_map(lambda _: next(it), grads)

    def _split_axes(self) -> list:
        """Per gradient leaf: the grid axes (``pipe``, ``model``, ``seq``)
        that split it; all empty for a model without model parallelism."""
        fn = getattr(self.model, "split_axes_leaves", None)
        return fn() if fn is not None else [()]

    def step_update(self, params, opt_state, grads, extra, lr):
        """One local update of the clipped local gradient, in place;
        returns ``(params, opt_state, extra)``, the objects it was given."""
        params, opt_state = self.model.opt.update(self._clip_grads(grads),
                                                  opt_state, params, lr)
        return params, opt_state, extra

    def sync_bn(self, bn_state) -> None:
        """How the BatchNorm running stats relate across ranks: the async
        rules keep them local, part of each rank's divergent replica."""

    # -- the exchange --------------------------------------------------------

    def has_exchange(self) -> bool:
        """True when the rule exchanges after its steps (the async rules);
        BSP's whole rule lives inside the train step."""
        return False

    def due(self, count: int) -> bool:
        return self.has_exchange() and count % self.exchange_freq == 0

    def exchange_body(self, count: int, gen=None) -> None:
        """The rule's exchange after step ``count``, in place on the
        model's params and ``extra``; ``gen`` is the generator its draws
        come from (seeded by :meth:`seed_draws`)."""
        raise NotImplementedError(f"{type(self).__name__} has no exchange")

    def seed_draws(self, gen: torch.Generator, count: int) -> None:
        """Seed ``gen`` for the exchange after step ``count``; a rule that
        draws nothing leaves it alone."""

    def check_capture(self) -> None:
        """Raise when the exchange cannot be captured in a CUDA graph."""

    def numerics_extra(self, params, extra) -> Dict[str, list]:
        """What the numerics plane (``utils/numerics.py``) reads of the
        rule, as leaf lists, all optional: ``beacon_tree``, a params-shaped
        tree the rule keeps bit-identical on every rank (its digest is the
        beacon); ``center``, the center the replica's distance is taken
        to; ``ef_state``, a wire's error state.  The base rule trains
        locally: nothing is replicated, nothing is a center."""
        return {}

    def exchange(self, recorder=None, count: int = 0) -> None:
        """The worker's hook after each train step: the exchange when due
        (the model's ``exchange_fn``, :class:`steps.ExchangeStep`), timed
        into the recorder's ``comm`` bucket — its enqueueing, and with
        ``sync_each_iter`` its wait.  A no-op when the cadence is fused
        into the train step's window.  With tracing on it is an
        ``exchange`` span; with telemetry on it feeds the
        ``exchange.dispatch_secs`` histogram (the host's enqueueing) and
        the ``exchange.count`` counters."""
        if self.fused or not self.due(count):
            return
        tm = telemetry.active()
        tr = tracing.active()
        sp = tr.begin("exchange", count=count,
                      rule=self.name) if tr.enabled else None
        if recorder:
            recorder.start()
        t0 = time.time() if tm.enabled else 0.0
        # devprof's dispatch anchor: a profiler window sees one named span
        # a standalone exchange (the JAX package's TraceAnnotation)
        with record_function(devprof.EXCHANGE_SPAN):
            self.model.exchange_fn(count)
        if tm.enabled:
            tm.observe("exchange.dispatch_secs", time.time() - t0)
            tm.counter("exchange.count")
            tm.counter(f"exchange.count.{self.name}")
        if recorder:
            if self.config.get("sync_each_iter", False) and \
                    self.model.device.type == "cuda":
                torch.cuda.synchronize(self.model.device)
            recorder.end("comm")
        if sp is not None:
            sp.end()

    def canonical_params(self):
        """The parameters validation and the ``.npy`` snapshot read: the
        replica itself."""
        return self.model.params

    # -- elastic membership (parallel/membership.py) -------------------------

    def supports_elastic(self) -> bool:
        """True when the rule's exchange tolerates a change of membership
        (the async rules: per-rank push-pull or gossip); BSP's reaction to
        a lost rank is a supervised world restart."""
        return False

    def set_active_ranks(self, active) -> None:
        """Shrink or re-grow the set of ranks the exchange mixes, without
        stopping the run: ``active`` a collection of rank ids, or None (or
        every rank) for full membership.  :meth:`prepare` runs again, so
        GoSGD's tables are drawn over the new set.  A demoted rank keeps
        training locally; a readmitted one re-enters the mixing with what
        it has.  A step captured for another set is captured again
        (``steps._Captured`` keys its graphs by :meth:`active_key`); a
        fused cadence also rebuilds its step (``MeshReactor``)."""
        if not self.supports_elastic():
            raise NotImplementedError(
                f"{type(self).__name__} ({self.name}) cannot shrink its "
                f"membership: BSP-family rules react to host loss via "
                f"`launcher --supervise` world restart (docs/design.md "
                f"§14 reaction matrix)")
        if self.model is None:
            raise RuntimeError("set_active_ranks before prepare()")
        n = self.size
        if active is None:
            self._active_ranks = None
        else:
            act = tuple(sorted({int(a) for a in active}))
            if not act or not all(0 <= a < n for a in act):
                raise ValueError(
                    f"active ranks {act} outside the {n}-rank world (or "
                    f"empty): at least one rank must remain active")
            self._active_ranks = None if len(act) == n else act
        self.prepare(self.model, n)

    def active_mask(self) -> np.ndarray:
        """``[size]`` float32 participation mask (1 = active)."""
        mask = np.ones(self.size, np.float32)
        if self._active_ranks is not None:
            mask[:] = 0.0
            mask[list(self._active_ranks)] = 1.0
        return mask

    def active_key(self) -> Optional[tuple]:
        """The active set as a captured graph's key (None: every rank)."""
        return self._active_ranks

    def _is_active(self) -> bool:
        """Whether this rank mixes in the exchange."""
        act = self._active_ranks
        return act is None or self.rank in act


class LocalExchanger(Exchanger):
    """An async island's (``parallel/async_easgd.py``): the local update
    and nothing across processes.  Its step issues no collective, so it
    needs no process group, and islands that are threads of one process
    never share a communicator."""

    name = "local"
    collective = False


class BSP_Exchanger(Exchanger):
    """Bulk-synchronous exchange: of the gradients inside the step
    (``exch_mode='grads'``), or of the parameters after it
    (``exch_mode='params'``, the reference's cadence: a local update, then
    the parameters averaged; its exchange is timed into the recorder's
    ``comm`` bucket, a CUDA graph of its own on the card)."""

    name = "bsp"

    def __init__(self, config: Optional[dict] = None):
        super().__init__(config)
        self.mode = self.config.get("exch_mode", "grads")
        if self.mode not in ("grads", "params"):
            raise ValueError(f"unknown exch_mode={self.mode!r}; have "
                             f"'grads', 'params'")
        self.strategy: Strategy = get_strategy(
            self.config.get("exch_strategy", "allreduce"))
        # the strategy owns BSP's collectives, in either mode, and buckets
        # its own wire format
        self.strategy.bucket_bytes = self.bucket_bytes

    def n_buckets(self) -> Optional[int]:
        """The strategy's slices of one exchange (None: monolithic, or a
        wire that does not bucket)."""
        if self.bucket_bytes <= 0 or self.model is None:
            return None
        return self.strategy.n_buckets(self.model.params, self.bucket_bytes)

    def prepare(self, model, size: int) -> None:
        """Also hands the strategy the paths of the model's leaves kept in
        the JAX layout (``ModelBase.kept_layout_paths``)."""
        super().prepare(model, size)
        self.strategy.kept_layout = frozenset(model.kept_layout_paths())

    def identical_parts(self) -> tuple:
        """Grads mode with a stateless strategy that reduces: every rank
        applies the same mean gradient, so every part is identical, except
        the chunks ZeRO-1 and ``update_sharding`` keep of the optimizer
        state and FSDP of the params and the optimizer state.  Params mode
        keeps each rank's momentum; a stateful strategy each rank's error
        feedback; ``none`` reduces nothing: all of them per rank."""
        if not (self.mode == "grads" and not self.strategy.stateful
                and self.strategy.name != "none"):
            return ()
        parts = {"params", "opt_state", "bn_state", "extra"}
        if self.config.get("zero_opt") or self.config.get("update_sharding"):
            parts.discard("opt_state")
        if self.config.get("fsdp"):
            parts -= {"params", "opt_state"}
        return tuple(sorted(parts))

    def _extra_full_template(self) -> Dict[str, Any]:
        """``{"strat": state}`` on the model's device for a stateful
        strategy (whatever structure its ``init_state`` makes: a tensor or
        a per-leaf list), else ``{}``: each rank's own error feedback,
        never sharded."""
        if self.strategy.stateful:
            return {"strat": self.strategy.init_state(self.model.params)}
        return {}

    def step_update(self, params, opt_state, grads, extra, lr):
        """Grads mode: the strategy's mean of ``grads`` (its state in
        ``extra["strat"]``, rewritten in place); params mode: the local
        ``grads``.  Clipped, then the optimizer update, in place; returns
        the objects it was given."""
        if self.mode == "grads":
            grads, _ = self.strategy(grads, extra.get("strat", ()),
                                     size=self.size)
            grads = self._restore_replication(grads)
        params, opt_state = self.model.opt.update(self._clip_grads(grads),
                                                  opt_state, params, lr)
        return params, opt_state, extra

    def _restore_replication(self, grads):
        """Under tensor or pipeline parallelism, a strategy that flattens
        the tree or keeps per-leaf state (``leafwise_state``) compresses
        each rank's shards and its copy of the leaves its grid axes do not
        split together: their decoded means can differ between the ranks of
        those axes.  Each such leaf is replaced by its mean over the model
        and pipe groups that do not split it (``exchanger.py:639-656``
        there, ``_restore_replication``), and over the seq group where that
        splits some leaf (the MoE's experts; otherwise the seq ranks hold
        the same bits already)."""
        split = self._split_axes()
        per_shard = self.strategy.flattens or self.strategy.leafwise_state
        if not per_shard or not any(split):
            return grads
        from .tp import all_reduce
        grid = self.model.grid
        active = [a for a in ("pipe", "model", "seq")
                  if any(a in s for s in split)]
        leaves = tree_leaves(grads)
        missing = [tuple(a for a in active if a not in s) for s in split]
        out = list(leaves)
        for miss in sorted(set(missing) - {()}, key=lambda a: (len(a), a)):
            idx = [i for i, m in enumerate(missing) if m == miss]
            flat, n = torch.cat([leaves[i].reshape(-1) for i in idx]), 1
            for axis in reversed(miss):
                flat = all_reduce(flat, grid.group(axis))
                n *= grid.size(axis)
            for i, m in zip(idx, flat.split([leaves[i].numel()
                                             for i in idx])):
                out[i] = (m / n).view_as(leaves[i])
        return _like(grads, out)

    def has_exchange(self) -> bool:
        return self.mode == "params"

    def numerics_extra(self, params, extra) -> Dict[str, list]:
        """Grads mode with a reducing strategy: every rank applied the same
        reduced gradient, so the params are the beacon (a stateful wire
        too: its decoded mean is the same on every rank).  Params mode is
        sampled before its exchange, and ``none`` reduces nothing: no
        beacon.  A stateful wire's error state is ``ef_state``."""
        out = {}
        if self.mode == "grads" and self.strategy.name != "none":
            out["beacon_tree"] = tree_leaves(params)
        if self.strategy.stateful and "strat" in extra:
            out["ef_state"] = tree_leaves(extra["strat"])
        return out

    @torch.no_grad()
    def exchange_body(self, count: int, gen=None) -> None:
        """Params mode: the parameters replaced by the strategy's mean of
        them, in place (its state in ``extra["strat"]``)."""
        params = self.model.params
        mean, _ = self.strategy(params, self.model.extra.get("strat", ()),
                                size=self.size)
        buckets.copy_into(params, mean)

    def sync_bn(self, bn_state) -> None:
        """The running stats replaced by their mean over the ranks, in
        place: one all-reduce (SUM) of all of them packed together, then
        ÷ size, as the JAX package's ``pmean``."""
        leaves = tree_leaves(bn_state)
        if not leaves:
            return
        mean = summed(leaves)
        torch._foreach_div_(mean, float(self.size))
        torch._foreach_copy_(leaves, mean)


class _CenterExchanger(Exchanger):
    """EASGD and ASGD: a center, a params-shaped copy in ``extra["center"]``
    that every rank keeps identical (each applies the same summed delta);
    validation and the ``.npy`` snapshot read it.  Under
    ``update_sharding`` each rank keeps its chunks of the large center
    leaves, and the exchange runs on the gathered center."""

    def _extra_full_template(self) -> Dict[str, Any]:
        return {"center": tree_map(lambda p: p.detach().clone(),
                                   self.model.params)}

    def shardable_extra(self) -> tuple:
        return ("center",)

    def has_exchange(self) -> bool:
        return True

    def supports_elastic(self) -> bool:
        return True

    def numerics_extra(self, params, extra) -> Dict[str, list]:
        """The center, identical on every rank (each applies the same
        summed delta): the beacon, and what ``‖w − c‖`` is taken to (the
        full center under ``update_sharding``: a gather)."""
        center = tree_leaves(self.unshard_extra(extra)["center"])
        return {"beacon_tree": center, "center": center}

    @torch.no_grad()
    def canonical_params(self):
        """The center; under the plan rebuilt from every rank's chunks (new
        tensors, a collective)."""
        return self.unshard_extra(self.model.extra)["center"]

    def _center_body(self, algebra) -> None:
        """``algebra(params leaves, center leaves)`` on the full center, in
        place, then this rank's windows stored back (under the plan)."""
        extra = self.model.extra
        center = self.unshard_extra(extra)["center"]
        algebra(tree_leaves(self.model.params), tree_leaves(center))
        self.reshard_extra({"center": center}, extra)


class EASGD_Exchanger(_CenterExchanger):
    """Elastic averaging, the EASGD paper's synchronous form: every
    ``sync_freq`` steps (default 4), with ``delta = p − c``,

        c ← c + α · mean_ranks(delta);   p ← p − α · delta

    (``alpha`` default 0.5): every rank's delta summed over the ranks in
    place.  Three passes over the params' size, each reading two trees
    and writing one: the delta, the pull of ``p`` as a lerp toward ``c``,
    and ``c += (α / size) · Σ delta`` (the JAX package rounds ``/ size``
    and ``α ·`` apart; these differ from its bits by an ulp, not in
    law).  Under a shrunk membership the mean is over the active ranks:
    a demoted rank's delta is zeros and it skips the pull."""

    name = "easgd"

    def __init__(self, config: Optional[dict] = None):
        super().__init__(config)
        self.alpha = float(self.config.get("alpha", 0.5))
        self.exchange_freq = int(self.config.get("sync_freq", 4))

    @torch.no_grad()
    def exchange_body(self, count: int, gen=None) -> None:
        act = self._active_ranks
        n_act = self.size if act is None else len(act)
        mine = self._is_active()

        def algebra(ps, cs):
            delta = torch._foreach_sub(ps, cs)
            if mine:
                torch._foreach_lerp_(ps, cs, self.alpha)
            else:
                torch._foreach_zero_(delta)
            self._sum_tree(_like(self.model.params, delta))
            torch._foreach_add_(cs, delta, alpha=self.alpha / n_act)

        self._center_body(algebra)


class ASGD_Exchanger(_CenterExchanger):
    """Downpour push-pull: every ``sync_freq`` steps (default 1) the
    center absorbs the SUM of the ranks' deltas ``p − c`` and every rank
    restarts from the new center.  Under a shrunk membership only the
    active ranks' deltas are summed and only they restart; a demoted rank
    keeps its replica."""

    name = "asgd"

    def __init__(self, config: Optional[dict] = None):
        super().__init__(config)
        self.exchange_freq = int(self.config.get("sync_freq", 1))

    @torch.no_grad()
    def exchange_body(self, count: int, gen=None) -> None:
        mine = self._is_active()

        def algebra(ps, cs):
            delta = torch._foreach_sub(ps, cs)
            if not mine:
                torch._foreach_zero_(delta)
            self._sum_tree(_like(self.model.params, delta))
            torch._foreach_add_(cs, delta)
            if mine:
                torch._foreach_copy_(ps, cs)

        self._center_body(algebra)


class GOSGD_Exchanger(Exchanger):
    """Gossip SGD: after every step each rank draws a send gate,
    Bernoulli(``exch_prob``, default 0.25); a sender ships ``(α/2 · params,
    α/2)`` to a peer and keeps the other half of its weight, and every
    rank merges what it receives, ``p ← (α_keep · p + Σ msg) / α'`` with
    ``α' = α_keep + Σ α_recv``.  Σα over the ranks is conserved; α starts
    at 1 in ``extra["alpha"]``.  The peers (``gosgd_peers``):

    * ``'perm'`` (default): one of ``gosgd_n_perms`` (16) seeded random
      derangements of the ranks;
    * ``'shift'``: every sender sends to ``rank + s`` for one random
      ``s`` in ``1 .. size-1``;
    * ``'iid'``: one of ``gosgd_n_perms`` seeded maps where each sender's
      peer is uniform over the others, so two may hit one receiver: the
      map is routed in collision rounds and a receiver sums what arrives.

    The tables are the JAX package's (``topology.py``, family seeds
    ``0x605`` / ``0x1d1`` plus ``gosgd_seed``); messages travel by
    point-to-point sends over the pairs, and a rank with no inbound
    message receives zeros.  The JAX package draws the gate and the pick
    from ``fold_in(key, count)``, which torch cannot reproduce: here the
    gate comes from a generator on the device seeded from ``(gosgd_seed,
    rank, count)``, and the pick is drawn on the host from ``(gosgd_seed,
    count)``, so every rank picks the same table.  At world 1 the route
    is the identity.

    Under a shrunk membership the tables are drawn over the ``m`` active
    ranks and lifted to full width (``topology.embed_active``: a demoted
    rank is a fixed point), ``shift`` routes on the active sub-ring with
    ``s`` in ``1 .. m-1``, a demoted rank's send gate is off, and its
    ``p`` and α stay as they were.  A fixed point is a local delivery: the
    rank takes its own buffer back, with no send or receive (one active
    rank gets its own α/2 back, so Σα is conserved)."""

    name = "gosgd"
    uses_draws = True

    def __init__(self, config: Optional[dict] = None):
        super().__init__(config)
        self.p_share = float(self.config.get("exch_prob", 0.25))
        self.peers_mode = str(self.config.get("gosgd_peers", "perm"))
        if self.peers_mode not in ("perm", "shift", "iid"):
            raise ValueError(f"unknown gosgd_peers={self.peers_mode!r}; "
                             f"have 'perm', 'shift', 'iid'")
        self.n_perms = int(self.config.get("gosgd_n_perms", 16))
        self.family_seed = int(self.config.get("gosgd_seed", 0))
        self._tables = None

    def prepare(self, model, size: int) -> None:
        super().prepare(model, size)
        self.rank = int(model.rank)
        active = self._active()
        m, n = len(active), self.size
        if self.peers_mode == "perm":
            self._tables = topology.embed_active(topology.derangements(
                m, self.n_perms, seed=0x605 + self.family_seed), active, n)
        elif self.peers_mode == "iid":
            self._tables = topology.embed_active(topology.iid_maps(
                m, self.n_perms, seed=0x1d1 + self.family_seed), active, n)

    def _active(self) -> list:
        act = self._active_ranks
        return list(range(self.size)) if act is None else list(act)

    def supports_elastic(self) -> bool:
        return True

    def _extra_full_template(self) -> Dict[str, Any]:
        return {"alpha": torch.ones((), dtype=torch.float32,
                                    device=self.model.device)}

    def has_exchange(self) -> bool:
        return True

    def seed_draws(self, gen: torch.Generator, count: int) -> None:
        gen.manual_seed(step_seed(_GATE_TAG, self.family_seed, self.rank,
                                  count))

    def check_capture(self) -> None:
        if self.size > 1:
            raise NotImplementedError(
                "GoSGD at world > 1 on the card: its route is picked on the "
                "host at every exchange, which a captured graph would "
                "freeze; gossip between cards comes with A6")

    def rounds(self, count: int) -> list:
        """The routing of the exchange after step ``count``: a list of
        rounds, each a list of ``(sender, receiver)`` pairs with distinct
        senders and distinct receivers (a demoted rank's pair is ``(d,
        d)``, or absent under ``shift``); ``[]`` at world 1."""
        n = self.size
        if n == 1:
            return []
        r = np.random.RandomState(step_seed(_ROUTE_TAG, self.family_seed,
                                            count) % 2 ** 32)
        if self.peers_mode == "shift":
            act = self._active()
            m = len(act)
            s = int(r.randint(1, m)) if m > 1 else 1
            return [[(act[j], act[(j + s) % m]) for j in range(m)]]
        dest = self._tables[int(r.randint(len(self._tables)))]
        if self.peers_mode == "perm":
            return [[(i, int(dest[i])) for i in range(n)]]
        return topology.collision_rounds(dest)

    def _route(self, bufs: list, count: int) -> list:
        """What this rank receives of each message buffer: the sum of the
        buffers sent to it (zeros if none), ``bufs`` themselves at world
        1.  In each round every buffer travels as a message of its own,
        all of the round's sends and receives in flight at once; a pair
        ``(d, d)`` is delivered locally."""
        rounds = self.rounds(count)
        if not rounds:
            return bufs
        acc = None
        for pairs in rounds:
            ops, got = [], None
            for s, d in pairs:
                if s == d == self.rank:
                    got = [b.clone() for b in bufs]
                    continue
                if s == self.rank:
                    ops += [dist.P2POp(dist.isend, b, d) for b in bufs]
                if d == self.rank:
                    got = [torch.empty_like(b) for b in bufs]
                    ops += [dist.P2POp(dist.irecv, g, s) for g in got]
            if ops:
                for req in dist.batch_isend_irecv(ops):
                    req.wait()
            if got is not None:
                acc = got if acc is None else [a.add_(g)
                                               for a, g in zip(acc, got)]
        return [torch.zeros_like(b) for b in bufs] if acc is None else acc

    @torch.no_grad()
    def exchange_body(self, count: int, gen=None) -> None:
        ps = tree_leaves(self.model.params)
        alpha = self.model.extra["alpha"]
        send = torch.rand((), generator=gen, device=alpha.device) \
            < self.p_share
        mine = self._is_active()
        if not mine:
            send = torch.zeros_like(send)
        w_send = torch.where(send, alpha * 0.5, torch.zeros_like(alpha))
        w_keep = alpha - w_send
        if self.plan is None:
            # the message, packed: α_send·params, then α_send
            sizes = [p.numel() for p in ps]
            n = sum(sizes)
            buf = torch.empty(n + 1, dtype=torch.float32, device=alpha.device)
            views = [v.view_as(p) for v, p in zip(buf[:n].split(sizes), ps)]
            torch._foreach_copy_(views, ps)
            buf[:n].mul_(w_send)
            buf[n:].copy_(w_send.reshape(1))
            recv = self._route([buf], count)[0]
            w_recv = recv[n]
            got = [v.view_as(p) for v, p in zip(recv[:n].split(sizes), ps)]
        else:
            # one message a bucket of α_send·params, and α_send alone
            msg = buckets.pack(self.model.params, self.plan)
            msg = [torch.mul(m, w_send) for m in msg] + [w_send.reshape(1)]
            recv = self._route(msg, count)
            w_recv = recv[-1][0]
            got = tree_leaves(buckets.unpack(recv[:-1], self.model.params,
                                             self.plan))
        if not mine:
            return                  # p and α verbatim off the active set
        new_alpha = w_keep + w_recv
        torch._foreach_mul_(ps, w_keep)
        torch._foreach_add_(ps, got)
        torch._foreach_div_(ps, new_alpha)
        alpha.copy_(new_alpha)

    @torch.no_grad()
    def canonical_params(self):
        """The consensus: the α-weighted mean of the replicas, one
        all-reduce of ``α·params`` and one of α (a new tree)."""
        ps = tree_leaves(self.model.params)
        alpha = self.model.extra["alpha"]
        mean = summed(torch._foreach_mul(ps, alpha))
        total = alpha.clone()
        dist.all_reduce(total)
        torch._foreach_div_(mean, total)
        it = iter(mean)
        return tree_map(lambda _: next(it), self.model.params)


EXCHANGERS = {
    "bsp": BSP_Exchanger,
    "easgd": EASGD_Exchanger,
    "asgd": ASGD_Exchanger,
    "gosgd": GOSGD_Exchanger,
}


def get_exchanger(name: str, config: Optional[dict] = None) -> Exchanger:
    try:
        return EXCHANGERS[name.lower()](config)
    except KeyError:
        raise ValueError(f"unknown exchanger {name!r}; "
                         f"have {sorted(EXCHANGERS)}")
