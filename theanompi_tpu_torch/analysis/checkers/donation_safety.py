"""static-alias and shard-rebuild-dominance.

Counterpart of the JAX lint's donation-safety module.  torch has no
buffer donation; what takes its place in the port is the CUDA graph's
static output: a captured graph writes its outputs into the same tensors
at every replay, so a graph's output that is kept is rewritten under its
holder by the next replay.

``static-alias`` (JAX donation-safety)
    A name bound to a captured graph's output — the return of
    ``StepGraph.capture``, a name assigned inside a ``with
    torch.cuda.graph(...)`` block, or one unpacked beside a graph
    (``self._graph, out, state = entry``) — that is returned or stored
    after a ``.replay()`` in the same scope without ``.clone()`` is a
    finding.  ``steps._Captured._run_captured`` (replay, then
    ``out.clone()``) is the good shape.  A torch twin of the JAX fixtures
    cannot exist (nothing is donated); the port has its own.

``shard-rebuild-dominance`` (JAX shard-rebuild-dominance)
    The update-plane sharding (``parallel/update_sharding.py``) cuts a
    rank's chunk out of a full buffer: ``shard_tree``, and the windows of
    ``window``/``_flat_window`` (a slice cut by a window's bounds is a
    chunk).  A function that returns such a chunk — through arithmetic,
    containers, subscripts — without a rebuild (``unshard_tree``,
    ``all_gather_into``, ``reshard_into``, ``FsdpLayout.gather_params``)
    dominating the return hands a 1/N-sized local shard to a caller that
    expects the full buffer.  A rebuild inside one arm of an ``if`` does
    not dominate.  The schema's own producers (``shard_*``, ``reshard_*``,
    ``slice_*``, ``chunk_*``, and the producers themselves) return chunks
    by design.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Set, Tuple

from ..core import Checker, Finding, ImportResolver, SourceFile, register
from ..engine import body_walk

CUDA_GRAPH = "torch.cuda.graph"


# ---------------------------------------------------------------------------
# static-alias
# ---------------------------------------------------------------------------

def _is_capture(call: ast.AST, sf: SourceFile, ctors: Dict[str, str]) -> bool:
    """``<StepGraph>.capture(...)``: the receiver built in place or a local
    built from a ``StepGraph``."""
    if not (isinstance(call, ast.Call) and
            isinstance(call.func, ast.Attribute) and
            call.func.attr == "capture"):
        return False
    recv = call.func.value
    if isinstance(recv, ast.Call):
        name = ImportResolver.dotted(recv.func) or ""
    elif isinstance(recv, ast.Name):
        name = ctors.get(recv.id, "")
    else:
        name = ImportResolver.dotted(recv) or ""
    return name.rsplit(".", 1)[-1] in ("StepGraph", "graph", "_graph")


@register
class StaticAliasChecker(Checker):
    name = "static-alias"
    description = ("a captured graph's output kept past a later replay() "
                   "without .clone() (the replay rewrites it in place)")

    def check_file(self, sf: SourceFile):
        findings: List[Finding] = []
        if "replay" not in sf.text:
            return findings            # nothing is replayed here
        for fn in sf.nodes:
            if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                findings.extend(self._function(sf, fn))
        return findings

    def _function(self, sf: SourceFile, fn) -> List[Finding]:
        ctors: Dict[str, str] = {}
        outs: Set[str] = set()
        for st in body_walk(fn):
            if isinstance(st, ast.Assign) and isinstance(st.value, ast.Call):
                name = ImportResolver.dotted(st.value.func) or ""
                for t in st.targets:
                    if isinstance(t, ast.Name):
                        ctors[t.id] = name
        for st in body_walk(fn):
            if isinstance(st, ast.Assign):
                if _is_capture(st.value, sf, ctors):
                    outs |= {t.id for t in st.targets
                             if isinstance(t, ast.Name)}
                for t in st.targets:
                    if isinstance(t, ast.Tuple) and any(
                            "graph" in (ImportResolver.dotted(e) or "")
                            for e in t.elts):
                        outs |= {e.id for e in t.elts
                                 if isinstance(e, ast.Name) and
                                 "graph" not in e.id and "state" not in e.id}
            if isinstance(st, (ast.With, ast.AsyncWith)) and any(
                    isinstance(it.context_expr, ast.Call) and
                    sf.resolver.resolve(it.context_expr.func) == CUDA_GRAPH
                    for it in st.items):
                for b in st.body:
                    for n in ast.walk(b):
                        if isinstance(n, ast.Name) and \
                                isinstance(n.ctx, ast.Store):
                            outs.add(n.id)
        if not outs:
            return []
        findings: List[Finding] = []
        self._block(sf, fn.body, outs, None, findings)
        return findings

    def _block(self, sf, stmts, outs: Set[str], replayed, findings) -> None:
        """Statements in order; a replay in a nested block counts for the
        rest of that block only (it may not run)."""
        for st in stmts:
            if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef)):
                continue
            nested = [getattr(st, f) for f in ("body", "orelse", "finalbody")
                      if isinstance(getattr(st, f, None), list)]
            nested += [h.body for h in getattr(st, "handlers", [])]
            if nested:
                for blk in nested:
                    self._block(sf, blk, outs, replayed, findings)
                continue
            kept = None
            if isinstance(st, ast.Return) and st.value is not None:
                kept = st.value
            elif isinstance(st, ast.Assign) and any(
                    isinstance(t, (ast.Attribute, ast.Subscript))
                    for t in st.targets):
                kept = st.value
            elif isinstance(st, ast.Expr) and isinstance(st.value, ast.Call) \
                    and isinstance(st.value.func, ast.Attribute) and \
                    st.value.func.attr in ("append", "extend", "insert"):
                kept = st.value.args[-1] if st.value.args else None
            if replayed is not None and kept is not None:
                for name in _kept_outputs(kept, outs):
                    findings.append(Finding(
                        self.name, sf.path, name.lineno, name.col_offset,
                        f"`{name.id}`, a captured graph's output, is kept "
                        f"past the replay of line {replayed.lineno} without "
                        f".clone() — the next replay rewrites it under its "
                        f"holder"))
            for n in ast.walk(st):
                if isinstance(n, ast.Call) and \
                        isinstance(n.func, ast.Attribute) and \
                        n.func.attr == "replay":
                    replayed = n


#: methods whose result is a view of (or the very) tensor they are called on
_VIEWS = {"view", "view_as", "reshape", "squeeze", "unsqueeze", "t",
          "transpose", "expand", "narrow", "split", "unbind", "chunk",
          "flatten", "permute", "contiguous", "detach", "requires_grad_"}


def _kept_outputs(expr: ast.AST, outs: Set[str]) -> List[ast.Name]:
    """The output names a kept expression holds itself, or a view of:
    through conditionals' arms, containers, subscripts and view methods;
    not through a copy (``.clone()``) or any other call's result."""
    if isinstance(expr, ast.Name):
        return [expr] if expr.id in outs else []
    if isinstance(expr, ast.IfExp):
        return _kept_outputs(expr.body, outs) + \
            _kept_outputs(expr.orelse, outs)
    if isinstance(expr, (ast.Tuple, ast.List, ast.Set)):
        return [n for e in expr.elts for n in _kept_outputs(e, outs)]
    if isinstance(expr, ast.Dict):
        return [n for v in expr.values if v is not None
                for n in _kept_outputs(v, outs)]
    if isinstance(expr, (ast.Subscript, ast.Starred)):
        return _kept_outputs(expr.value, outs)
    if isinstance(expr, ast.BoolOp):
        return [n for v in expr.values for n in _kept_outputs(v, outs)]
    if isinstance(expr, ast.Call) and isinstance(expr.func, ast.Attribute) \
            and expr.func.attr in _VIEWS:
        return _kept_outputs(expr.func.value, outs)
    return []


# ---------------------------------------------------------------------------
# shard-rebuild-dominance
# ---------------------------------------------------------------------------

#: what cuts a rank's chunk (or a chunk's bounds) out of a full buffer
SHARD_PRODUCERS = {"shard_tree", "window", "_flat_window"}
#: what rebuilds the full buffer from every rank's chunk
SHARD_REBUILDS = {"unshard_tree", "all_gather_into", "reshard_into",
                  "gather_params"}
#: the schema's own producers: returning a chunk is their job
_EXEMPT_FN = re.compile(r"^(shard|reshard|slice|chunk)_")


def _last_segment(func: ast.AST) -> Optional[str]:
    name = ImportResolver.dotted(func)
    return name.rsplit(".", 1)[-1] if name else None


@register
class ShardRebuildDominanceChecker(Checker):
    name = "shard-rebuild-dominance"
    description = ("a rank's chunk (shard_tree/window) escaping a function "
                   "without its rebuild (unshard_tree/all_gather_into/"
                   "reshard_into/gather_params) dominating the return")

    def check_file(self, sf: SourceFile):
        findings: List[Finding] = []
        if not any(p in sf.text for p in SHARD_PRODUCERS):
            return findings            # cuts no chunk
        for fn in sf.nodes:
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if _EXEMPT_FN.match(fn.name) or fn.name in SHARD_PRODUCERS:
                continue
            self._scan(sf, fn, fn.body, {}, findings, top=True)
        return findings

    def _scan(self, sf, fn, stmts, tainted: Dict[str, int],
              findings: List[Finding], top: bool) -> None:
        """Linear scan; ``tainted`` maps a name to its producer's line.  In
        a nested block a rebuild does not clear (it does not dominate)."""
        for st in stmts:
            if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef)):
                continue
            if isinstance(st, ast.Return) and st.value is not None:
                hit = self._expr_taint(st.value, tainted)
                if hit is not None:
                    name, line = hit
                    findings.append(Finding(
                        self.name, sf.path, st.lineno, st.col_offset,
                        f"`{name}` holds a rank's chunk (cut on line "
                        f"{line}) escaping `{fn.name}` without its rebuild "
                        f"(unshard_tree/all_gather_into must dominate the "
                        f"return)"))
                continue
            if isinstance(st, (ast.If, ast.For, ast.AsyncFor, ast.While,
                               ast.Try, ast.With, ast.AsyncWith)):
                for fieldname in ("body", "orelse", "finalbody"):
                    sub = getattr(st, fieldname, None)
                    if sub:
                        self._scan(sf, fn, sub, tainted, findings, top=False)
                for h in getattr(st, "handlers", []):
                    self._scan(sf, fn, h.body, tainted, findings, top=False)
                continue
            if isinstance(st, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
                if st.value is None:
                    continue
                hit = self._expr_taint(st.value, tainted)
                targets = st.targets if isinstance(st, ast.Assign) \
                    else [st.target]
                names = [n for t in targets for n in self._target_names(t)]
                if hit is not None:
                    for n in names:
                        tainted[n] = hit[1]
                elif top:
                    for n in names:
                        tainted.pop(n, None)

    def _expr_taint(self, node, tainted: Dict[str, int]
                    ) -> Optional[Tuple[str, int]]:
        """``(name, producer line)`` when the expression carries a chunk: a
        producer's call, a tainted name, either through arithmetic,
        containers and subscripts, or a slice cut by tainted bounds.  Other
        calls stop it (their result is a new value)."""
        if isinstance(node, ast.Call):
            last = _last_segment(node.func)
            if last in SHARD_REBUILDS:
                return None
            if last in SHARD_PRODUCERS:
                return (f"{last}(...)", node.lineno)
            return None
        if isinstance(node, (ast.Name, ast.Attribute)):
            name = ImportResolver.dotted(node)
            if name in tainted:
                return (name, tainted[name])
            return None
        if isinstance(node, ast.BinOp):
            return (self._expr_taint(node.left, tainted)
                    or self._expr_taint(node.right, tainted))
        if isinstance(node, ast.UnaryOp):
            return self._expr_taint(node.operand, tainted)
        if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
            for e in node.elts:
                hit = self._expr_taint(e, tainted)
                if hit:
                    return hit
            return None
        if isinstance(node, ast.Dict):
            for v in node.values:
                if v is not None:
                    hit = self._expr_taint(v, tainted)
                    if hit:
                        return hit
            return None
        if isinstance(node, ast.Subscript):
            return self._expr_taint(node.value, tainted) or \
                self._slice_taint(node.slice, tainted)
        if isinstance(node, ast.Starred):
            return self._expr_taint(node.value, tainted)
        if isinstance(node, ast.IfExp):
            return (self._expr_taint(node.body, tainted)
                    or self._expr_taint(node.orelse, tainted))
        return None

    def _slice_taint(self, node, tainted):
        if isinstance(node, ast.Slice):
            for b in (node.lower, node.upper):
                if b is not None:
                    for n in ast.walk(b):
                        if isinstance(n, ast.Name) and n.id in tainted:
                            return (n.id, tainted[n.id])
        return None

    @staticmethod
    def _target_names(t) -> List[str]:
        if isinstance(t, (ast.Tuple, ast.List)):
            return [n for e in t.elts
                    for n in ShardRebuildDominanceChecker._target_names(e)]
        if isinstance(t, ast.Starred):
            return ShardRebuildDominanceChecker._target_names(t.value)
        name = ImportResolver.dotted(t)
        return [name] if name else []
