"""collective-discipline and group-schema: collectives that every rank of
a process group issues alike, over groups the grid builds.

Counterpart of the JAX lint's collective-discipline and sharding-schema.
The JAX checks read ``lax`` collectives over named mesh axes; the port
runs one process per rank over ``torch.distributed``, so each invariant
is restated in its terms:

1. **No collective under a rank-dependent branch.**  A collective
   (``torch.distributed``'s, a process group's own method, or a call
   whose transitive summary issues one — the engine's dataflow half,
   through ``autograd.Function.apply`` too) lexically inside a Python
   ``if``/``while``/conditional expression whose test dataflows from a
   rank: ``dist.get_rank()``, a group's ``.rank()``, the names
   ``rank``/``local_rank``/``world_rank``, and the attributes a class
   assigns from them (``self.lead = ... dist.get_rank() == 0``) or
   computes from them in a property (``base.Grid.lead``).  A rank that
   skips it hangs the others in theirs.  Point-to-point calls are paired
   by construction and differ by rank on purpose: never counted.  The
   sanctioned shape is ``async_easgd._CenterLink._lead``: rank 0 acts
   alone, then every rank takes part in the broadcast of how it went.

2. **Groups are the grid's.**  ``grid.group("<axis>")`` and
   ``grid.<axis>_group`` name an axis of ``base.Grid.AXES`` (read from the
   parsed ``base.py``; a class of the same file declaring ``AXES`` adds
   its own), and a ``group=`` argument is never a string.  Axes that are
   not literal (after constant propagation) are skipped, never guessed.
   This takes the place of the JAX axis-name check.

3. **``async_op=True`` pairs.**  A ``Work`` a collective returns must
   reach ``.wait()``: discarded (a bare expression statement), or bound
   and never waited in its scope, is a finding; so is a read of the
   collective's tensor between the call and the wait.  A function that
   hands its ``Work`` to its caller (``buckets.all_reduce_start``
   returns ``(vec, work)``) is a *start*; one that waits on what its
   parameter carries (``buckets.all_reduce_done``) a *done*; a scope
   that calls or passes a start must call or pass a done.

group-schema (the counterpart of sharding-schema; PartitionSpec and
shard_map arity have no port counterpart: the port's layouts are tables
of axis names) holds the layout tables to the same vocabulary: the
keywords of the LM's ``Split(...)`` specs, the ``AXES`` tuples of the
layouts, and axis literals passed to a grid's ``group``/``size`` are
each an axis of ``Grid.AXES`` or ``"workers"``.  It shares rule 2's
vocabulary and lives here.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from ..core import Checker, Finding, ImportResolver, SourceFile, register
from ..engine import (P2P, RANK_CALLS, RANK_NAMES, ClassKey, FuncRecord,
                      ProgramIndex, call_collective, exec_calls, group_axis,
                      is_grid, module_str_constants, scope_stmts,
                      stmt_exprs)

GRID_CLASS = "theanompi_tpu_torch.base.Grid"
#: ``base.Grid.AXES`` when ``base.py`` is not in the run (a fixture)
DEFAULT_AXES = ("pipe", "model", "seq")
#: the data-parallel axis: the default group, a layout's name for it
WORKERS = "workers"
_BUCKETS = "theanompi_tpu_torch.parallel.buckets."
#: builtins a rank flows through
_PURE = {"int", "bool", "float", "divmod", "min", "max", "abs", "round"}


def grid_axes(index: ProgramIndex, sf: Optional[SourceFile] = None
              ) -> Set[str]:
    """``base.Grid.AXES``, plus any ``AXES`` tuple a class of ``sf``
    declares."""
    axes: Set[str] = set()
    base = index.class_key(GRID_CLASS)
    path = GRID_CLASS.rsplit(".", 1)[0].replace(".", "/") + ".py"
    if base is not None and path in index.file_index:
        axes |= _class_axes(index.file_index[path].classes.get(base[1]))
    if not axes:
        axes = set(DEFAULT_AXES)
    if sf is not None:
        for cls in index.file_index[sf.path].classes.values():
            axes |= _class_axes(cls)
    return axes


def _class_axes(cls: Optional[ast.ClassDef]) -> Set[str]:
    out: Set[str] = set()
    for st in (cls.body if cls is not None else ()):
        if isinstance(st, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "AXES"
                for t in st.targets):
            out |= {e.value for e in ast.walk(st.value)
                    if isinstance(e, ast.Constant)
                    and isinstance(e.value, str)}
    return out


# ---------------------------------------------------------------------------
# rank taint
# ---------------------------------------------------------------------------

class RankTaint:
    """What dataflows from a rank, program-wide: per class, the attributes
    it assigns from a rank and the methods and properties that return
    one; and the attribute names every defining class taints."""

    def __init__(self, index: ProgramIndex):
        self.index = index
        self.attrs: Dict[ClassKey, Set[str]] = {}
        self.returns: Dict[ClassKey, Set[str]] = {}
        self.foreign: Set[str] = set(RANK_NAMES)
        self._compute()

    def _family(self, key: Optional[ClassKey]) -> List[ClassKey]:
        if key is None:
            return []
        out, frontier = [key], [key]
        while frontier:
            for b in self.index.class_bases.get(frontier.pop(), []):
                bk = self.index.class_key(b)
                if bk is not None and bk not in out:
                    out.append(bk)
                    frontier.append(bk)
        return out

    def class_attr(self, key, attr: str) -> bool:
        return any(attr in self.attrs.get(k, ()) for k in self._family(key))

    def class_return(self, key, name: str) -> bool:
        return any(name in self.returns.get(k, ()) for k in self._family(key))

    def _compute(self) -> None:
        methods = [r for recs in self.index.methods.values() for r in recs]
        defined: Dict[str, Set[ClassKey]] = {}
        for rec in methods:
            for sub in self.index.body(rec.node):
                for t in _assign_targets(sub):
                    if _self_attr(t):
                        defined.setdefault(t.attr, set()).add(rec.class_key)
            if _is_property(rec.node):
                defined.setdefault(rec.name, set()).add(rec.class_key)
        changed = True
        while changed:
            changed = False
            for rec in methods:
                tainted = self.local_names(rec.sf, rec.node, rec.class_key)
                key = rec.class_key
                for sub in self.index.body(rec.node):
                    if isinstance(sub, ast.Return) and sub.value is not None \
                            and self.expr(rec.sf, sub.value, tainted, key):
                        if rec.name not in self.returns.setdefault(key, set()):
                            self.returns[key].add(rec.name)
                            changed = True
                    value = getattr(sub, "value", None)
                    if not isinstance(sub, (ast.Assign, ast.AugAssign,
                                            ast.AnnAssign)) or value is None:
                        continue
                    for t, v in _pairs(sub):
                        if not self.expr(rec.sf, v, tainted, key):
                            continue
                        for n in ast.walk(t):
                            if _self_attr(n) and n.attr not in \
                                    self.attrs.setdefault(key, set()):
                                self.attrs[key].add(n.attr)
                                changed = True
        # an attribute read off another object is a rank when every class
        # that defines it makes it one
        self.foreign = set(RANK_NAMES)
        for attr, keys in defined.items():
            if all(attr in self.attrs.get(k, ()) or
                   attr in self.returns.get(k, ()) for k in keys):
                self.foreign.add(attr)

    def expr(self, sf: SourceFile, expr: ast.AST, names: Set[str],
             cls: Optional[ClassKey]) -> bool:
        """True when ``expr`` carries a rank: through arithmetic,
        comparisons, subscripts, conditionals and the numeric builtins,
        never through another call's arguments (an object built from a
        rank is not a rank)."""
        stack = [expr]
        while stack:
            sub = stack.pop()
            if isinstance(sub, ast.Call):
                resolved = sf.resolver.resolve(sub.func)
                if resolved in RANK_CALLS:
                    return True
                f = sub.func
                if resolved is None and isinstance(f, ast.Attribute):
                    if f.attr == "rank" and not sub.args:
                        return True           # a process group's .rank()
                    if isinstance(f.value, ast.Name) and \
                            f.value.id == "self" and \
                            self.class_return(cls, f.attr):
                        return True
                if isinstance(f, ast.Name) and f.id in _PURE:
                    stack.extend(sub.args)
                continue
            if isinstance(sub, (ast.Lambda, ast.ListComp, ast.DictComp,
                                ast.SetComp, ast.GeneratorExp)):
                continue
            if isinstance(sub, ast.Name) and isinstance(sub.ctx, ast.Load):
                if sub.id in names or sub.id in RANK_NAMES:
                    return True
            elif isinstance(sub, ast.Attribute) and \
                    isinstance(sub.ctx, ast.Load):
                if _self_attr(sub):
                    if self.class_attr(cls, sub.attr) or \
                            self.class_return(cls, sub.attr):
                        return True
                elif sub.attr in self.foreign:
                    return True
                continue
            stack.extend(ast.iter_child_nodes(sub))
        return False

    def local_names(self, sf: SourceFile, fn: ast.AST,
                    cls: Optional[ClassKey]) -> Set[str]:
        """Locals of ``fn`` that carry a rank (assignments to a
        fixpoint)."""
        tainted: Set[str] = set()
        body = fn.body if isinstance(getattr(fn, "body", None), list) \
            else [ast.Expr(fn.body)] if isinstance(fn, ast.Lambda) else []
        stmts = list(scope_stmts(body))
        for _ in range(10):
            grown = False
            for st in stmts:
                value = getattr(st, "value", None)
                if not isinstance(st, (ast.Assign, ast.AugAssign,
                                       ast.AnnAssign)) or value is None:
                    continue
                for t, v in _pairs(st):
                    if not self.expr(sf, v, tainted, cls):
                        continue
                    for n in ast.walk(t):
                        if isinstance(n, ast.Name) and n.id not in tainted:
                            tainted.add(n.id)
                            grown = True
            if not grown:
                break
        return tainted


def _assign_targets(st: ast.AST) -> List[ast.AST]:
    if isinstance(st, ast.Assign):
        return list(st.targets)
    if isinstance(st, (ast.AugAssign, ast.AnnAssign)):
        return [st.target]
    return []


def _pairs(st: ast.AST):
    """``(target, value)`` of an assignment, a tuple unpacked element by
    element where both sides are tuples of one length."""
    value = getattr(st, "value", None)
    for t in _assign_targets(st):
        if isinstance(t, ast.Tuple) and isinstance(value, ast.Tuple) and \
                len(t.elts) == len(value.elts):
            yield from zip(t.elts, value.elts)
        elif value is not None:
            yield t, value


def _self_attr(n: ast.AST) -> bool:
    return isinstance(n, ast.Attribute) and isinstance(n.value, ast.Name) \
        and n.value.id == "self"


def _is_property(fn: ast.AST) -> bool:
    return any(isinstance(d, ast.Name) and d.id == "property"
               for d in getattr(fn, "decorator_list", ()))


# ---------------------------------------------------------------------------
# the checks
# ---------------------------------------------------------------------------

def _async_op(call: ast.Call) -> bool:
    return any(kw.arg == "async_op" and isinstance(kw.value, ast.Constant)
               and kw.value.value is True for kw in call.keywords)


class _Pairs:
    """The port's start and done functions (rule 3), program-wide."""

    def __init__(self, index: ProgramIndex):
        self.index = index
        self.starts: Set[int] = set()
        self.dones: Set[int] = set()
        # module-level aliases (``all_gather_done = all_reduce_done``)
        self.alias: Dict[str, str] = {}
        for sf in index.files:
            for st in sf.tree.body:
                if isinstance(st, ast.Assign) and \
                        isinstance(st.value, ast.Name):
                    for t in st.targets:
                        if isinstance(t, ast.Name):
                            self.alias[f"{sf.resolver.module}.{t.id}"] = \
                                f"{sf.resolver.module}.{st.value.id}"
        # per function, once: the callees its returns call, whether it
        # returns an async Work itself, whether it waits on what a
        # parameter carries, and the callees it hands a parameter to
        facts = []
        for rec in index.records.values():
            if isinstance(rec.node, ast.Lambda):
                continue
            ret_funcs, direct = [], False
            for sub in self.index.body(rec.node):
                if isinstance(sub, ast.Return) and sub.value is not None:
                    for call in exec_calls(sub.value):
                        if call_collective(call, rec.sf.resolver) and \
                                _async_op(call):
                            direct = True
                        ret_funcs.append(call.func)
            waits, passes = self._done_facts(rec)
            if direct or ret_funcs or waits or passes:
                facts.append((rec, direct, ret_funcs, waits, passes))
        changed = True
        while changed:
            changed = False
            for rec, direct, ret_funcs, waits, passes in facts:
                if id(rec.node) not in self.starts and (direct or any(
                        id(t.node) in self.starts for f in ret_funcs
                        for t in self._targets(rec, f))):
                    self.starts.add(id(rec.node))
                    changed = True
                if id(rec.node) not in self.dones and (waits or any(
                        id(t.node) in self.dones for f in passes
                        for t in self._targets(rec, f))):
                    self.dones.add(id(rec.node))
                    changed = True
        self.names = {r.name for r in index.records.values()
                      if id(r.node) in self.starts | self.dones}
        self.names |= {a.rsplit(".", 1)[-1] for a in self.alias}

    def _done_facts(self, rec: FuncRecord):
        """Whether ``rec`` waits on what a parameter carries, and the
        callees it passes such a value to."""
        params = set(rec.params())
        if not params:
            return False, []
        carried = set(params)
        for sub in self.index.body(rec.node):
            if isinstance(sub, ast.Assign) and any(
                    isinstance(n, ast.Name) and n.id in params
                    for n in ast.walk(sub.value)):
                for t in sub.targets:
                    carried |= {n.id for n in ast.walk(t)
                                if isinstance(n, ast.Name)}
        waits, passes = False, []
        for sub in self.index.body(rec.node):
            if not isinstance(sub, ast.Call):
                continue
            if isinstance(sub.func, ast.Attribute) and \
                    sub.func.attr == "wait" and \
                    isinstance(sub.func.value, ast.Name) and \
                    sub.func.value.id in carried:
                waits = True
            elif any(isinstance(a, ast.Name) and a.id in carried
                     for a in sub.args):
                passes.append(sub.func)
        return waits, passes

    def resolve(self, sf: SourceFile, expr: ast.AST, enclosing
                ) -> Tuple[Optional[str], List[FuncRecord]]:
        """A function reference's dotted name (through module-level
        aliases) and its records."""
        resolved = sf.resolver.resolve(expr)
        if resolved is None and isinstance(expr, ast.Name):
            resolved = f"{sf.resolver.module}.{expr.id}"
        resolved = self.alias.get(resolved or "", resolved)
        targets = self.index.by_qualname.get(resolved or "", [])
        if not targets:
            targets = self.index.resolve_call(sf, expr, enclosing)
        return resolved, targets

    def _targets(self, rec: FuncRecord, expr: ast.AST) -> List[FuncRecord]:
        idx = self.index.file_index[rec.sf.path]
        return self.resolve(rec.sf, expr,
                            idx.enclosing.get(id(expr), rec.node))[1]

    def kind(self, sf: SourceFile, expr: ast.AST, enclosing) -> Optional[str]:
        """``start``, ``done`` or None for a reference to a function."""
        if not isinstance(expr, (ast.Name, ast.Attribute)):
            return None
        simple = expr.id if isinstance(expr, ast.Name) else expr.attr
        if simple not in self.names and not (
                simple.endswith("_start") or simple.endswith("_done")):
            return None
        resolved, targets = self.resolve(sf, expr, enclosing)
        if any(id(t.node) in self.starts for t in targets):
            return "start"
        if any(id(t.node) in self.dones for t in targets):
            return "done"
        if not targets and resolved and resolved.startswith(_BUCKETS):
            # the port's wire API, outside the run (a fixture)
            for kind in ("start", "done"):
                if resolved.endswith("_" + kind):
                    return kind
        return None


@register
class CollectiveDisciplineChecker(Checker):
    name = "collective-discipline"
    description = ("no collective under a rank-dependent branch; group= "
                   "names a group the grid builds; every async_op=True "
                   "Work reaches .wait() before its tensor is read")
    needs_engine = True

    def check_program(self, index: ProgramIndex):
        taint = RankTaint(index)
        pairs = _Pairs(index)
        findings: List[Finding] = []
        for sf in index.files:
            axes = grid_axes(index, sf)
            consts = module_str_constants(index, sf.resolver.module)
            fidx = index.file_index[sf.path]
            # what each part can find at all, by the file's text
            has_groups = "group" in sf.text
            has_async = "async_op" in sf.text
            has_pairs = "_start" in sf.text or "_done" in sf.text or \
                any(n in sf.text for n in pairs.names)
            scopes: List[Optional[ast.AST]] = [None] + [
                n for n in sf.nodes
                if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda))]
            for scope in scopes:
                if scope is None:
                    body = sf.tree.body
                elif isinstance(scope, ast.Lambda):
                    body = [ast.Expr(scope.body)]
                else:
                    body = scope.body
                stmts = list(scope_stmts(body))
                cls = None
                owner = fidx.owner_class(scope)
                if owner is not None:
                    cls = (sf.resolver.module, owner.name)
                if has_groups:
                    self._groups(sf, stmts, axes,
                                 self._consts(stmts, consts), findings)
                self._branches(index, taint, sf, scope, stmts, cls, findings)
                if not isinstance(scope, ast.Lambda):
                    if has_async:
                        self._works(sf, scope, stmts, findings)
                    if has_pairs:
                        self._start_done(pairs, sf, scope, stmts, findings)
        return findings

    # -- 2: groups -----------------------------------------------------------

    @staticmethod
    def _consts(stmts, consts: Dict[str, str]) -> Dict[str, str]:
        out = dict(consts)
        for st in stmts:
            if isinstance(st, ast.Assign):
                for t in st.targets:
                    pairs = zip(t.elts, st.value.elts) \
                        if isinstance(t, ast.Tuple) and \
                        isinstance(st.value, ast.Tuple) and \
                        len(t.elts) == len(st.value.elts) \
                        else [(t, st.value)]
                    for tt, v in pairs:
                        if isinstance(tt, ast.Name) and \
                                isinstance(v, ast.Constant) and \
                                isinstance(v.value, str):
                            out[tt.id] = v.value
        return out

    def _groups(self, sf, stmts, axes, consts, findings) -> None:
        for st in stmts:
            for expr in stmt_exprs(st):
                for node in ast.walk(expr):
                    hit = group_axis(node, consts)
                    if hit is not None and hit[0] not in axes:
                        findings.append(Finding(
                            self.name, sf.path, node.lineno, node.col_offset,
                            f"group of undeclared grid axis '{hit[0]}' "
                            f"({hit[1]}; the grid builds: "
                            f"{', '.join(sorted(axes))})"))
                    if isinstance(node, ast.Call):
                        for kw in node.keywords:
                            if kw.arg == "group" and \
                                    isinstance(kw.value, ast.Constant) and \
                                    isinstance(kw.value.value, str):
                                findings.append(Finding(
                                    self.name, sf.path, kw.value.lineno,
                                    kw.value.col_offset,
                                    f"`group='{kw.value.value}'` names no "
                                    f"process group: pass "
                                    f"grid.group('{kw.value.value}')"))

    # -- 1: rank-dependent branches --------------------------------------------

    def _branches(self, index, taint: RankTaint, sf, scope, stmts, cls,
                  findings) -> None:
        tainted = taint.local_names(sf, scope, cls) if scope is not None \
            else set()
        seen: Set[Tuple[int, int]] = set()
        for st in stmts:
            if isinstance(st, (ast.If, ast.While)) and \
                    taint.expr(sf, st.test, tainted, cls):
                for arm in (st.body, st.orelse):
                    for n in arm:
                        self._flag_under(index, sf, scope, n, st, seen,
                                         findings)
            for expr in stmt_exprs(st):
                for node in ast.walk(expr):
                    if isinstance(node, ast.IfExp) and \
                            taint.expr(sf, node.test, tainted, cls):
                        for n in (node.body, node.orelse):
                            self._flag_under(index, sf, scope, n, node, seen,
                                             findings)

    def _flag_under(self, index, sf, scope, node, branch, seen,
                    findings) -> None:
        fidx = index.file_index[sf.path]
        for call in exec_calls(node):
            if (call.lineno, call.col_offset) in seen:
                continue
            cname = call_collective(call, sf.resolver)
            via = None
            if cname is None:
                if (sf.resolver.resolve(call.func) or "").rsplit(
                        ".", 1)[-1] in P2P:
                    continue
                enc = fidx.enclosing.get(id(call.func), scope)
                for tgt in index.resolve_df_call(sf, call.func, enc):
                    ts = index.transitive_summary(tgt)
                    if ts.issues_collective:
                        cname = "/".join(sorted(ts.collective_names))
                        via = tgt.name
                        break
            if cname is None:
                continue
            seen.add((call.lineno, call.col_offset))
            what = f"call to `{via}` (issues `{cname}`)" if via else \
                f"collective `{cname}`"
            findings.append(Finding(
                self.name, sf.path, call.lineno, call.col_offset,
                f"divergence hazard: {what} under a branch whose condition "
                f"derives from the rank (line {branch.lineno}) — the ranks "
                f"that skip it hang the others in theirs"))

    # -- 3: async_op pairing -----------------------------------------------------

    def _works(self, sf, scope, stmts, findings) -> None:
        """Each ``async_op=True`` collective of the scope: its Work waited,
        its tensor not read before."""
        calls = [(st, c) for st in stmts for e in stmt_exprs(st)
                 for c in exec_calls(e)
                 if call_collective(c, sf.resolver) and _async_op(c)]
        if not calls:
            return
        body = scope.body if scope is not None else sf.tree.body
        order = sorted((n for st in body for n in ast.walk(st)
                        if hasattr(n, "lineno")),
                       key=lambda n: (n.lineno, n.col_offset))
        for st, call in calls:
            if isinstance(st, ast.Expr) and st.value is call:
                findings.append(Finding(
                    self.name, sf.path, call.lineno, call.col_offset,
                    "Work discarded: an async_op=True collective whose "
                    "handle is a bare expression statement can never "
                    "reach .wait()"))
                continue
            holder = self._holder(st, call)
            if holder is None:
                continue          # handed on (returned, passed along)
            wait = self._first_wait(order, holder, call)
            if wait is None:
                if not self._escapes(scope, holder, call):
                    findings.append(Finding(
                        self.name, sf.path, call.lineno, call.col_offset,
                        f"Work `{holder}` of an async_op=True collective "
                        f"never reaches .wait() in its scope — the "
                        f"collective is left in flight"))
                continue
            for name in _operand_names(call):
                for n in order:
                    if (n.lineno, n.col_offset) <= (call.end_lineno,
                                                    call.end_col_offset):
                        continue
                    if (n.lineno, n.col_offset) >= (wait.lineno,
                                                    wait.col_offset):
                        break
                    if isinstance(n, ast.Name) and n.id == name and \
                            isinstance(n.ctx, ast.Load):
                        findings.append(Finding(
                            self.name, sf.path, n.lineno, n.col_offset,
                            f"`{name}` read before its collective's "
                            f"Work `{holder}` is waited on (line "
                            f"{wait.lineno}) — it holds no result yet"))
                        break

    @staticmethod
    def _holder(st, call) -> Optional[str]:
        """The name a Work is bound to: ``w = dist.x(...)``, or a list
        comprehension of them; None when it is handed on."""
        if isinstance(st, ast.Assign) and len(st.targets) == 1 and \
                isinstance(st.targets[0], ast.Name):
            v = st.value
            if v is call:
                return st.targets[0].id
            if isinstance(v, (ast.ListComp, ast.GeneratorExp)) and \
                    v.elt is call:
                return st.targets[0].id
        return None

    @staticmethod
    def _first_wait(order, holder: str, call) -> Optional[ast.AST]:
        """The first ``holder.wait()`` (or ``x.wait()`` over a loop of
        ``holder``) after the call."""
        loop_vars: Set[str] = set()
        for n in order:
            if (n.lineno, n.col_offset) <= (call.lineno, call.col_offset):
                continue
            if isinstance(n, (ast.For, ast.comprehension)) and any(
                    isinstance(x, ast.Name) and x.id == holder
                    for x in ast.walk(n.iter)):
                loop_vars |= {x.id for x in ast.walk(n.target)
                              if isinstance(x, ast.Name)}
            if isinstance(n, (ast.ListComp, ast.GeneratorExp, ast.SetComp)):
                for g in n.generators:
                    if any(isinstance(x, ast.Name) and x.id == holder
                           for x in ast.walk(g.iter)):
                        loop_vars |= {x.id for x in ast.walk(g.target)
                                      if isinstance(x, ast.Name)}
            if isinstance(n, ast.Call) and \
                    isinstance(n.func, ast.Attribute) and \
                    n.func.attr == "wait" and \
                    isinstance(n.func.value, ast.Name) and \
                    n.func.value.id in loop_vars | {holder}:
                return n
        return None

    @staticmethod
    def _escapes(scope, holder: str, call) -> bool:
        """The Work leaves the scope: returned, or passed to a call."""
        if scope is None:
            return False
        for n in ast.walk(scope):
            if isinstance(n, ast.Return) and n.value is not None and any(
                    isinstance(x, ast.Name) and x.id == holder
                    for x in ast.walk(n.value)):
                return True
            if isinstance(n, ast.Call) and n is not call and any(
                    isinstance(a, ast.Name) and a.id == holder
                    for a in list(n.args) + [k.value for k in n.keywords]):
                return True
        return False

    def _start_done(self, pairs: _Pairs, sf, scope, stmts, findings) -> None:
        if id(scope) in pairs.starts:
            return                      # a start hands its Work on
        fidx = pairs.index.file_index[sf.path]
        starts, dones = [], []
        for st in stmts:
            for expr in stmt_exprs(st):
                for node in ast.walk(expr):
                    if isinstance(node, (ast.Name, ast.Attribute)) and \
                            isinstance(getattr(node, "ctx", None), ast.Load):
                        kind = pairs.kind(sf, node,
                                          fidx.enclosing.get(id(node), scope))
                        if kind == "start":
                            starts.append(node)
                        elif kind == "done":
                            dones.append(node)
        if starts and not dones:
            n = starts[0]
            findings.append(Finding(
                self.name, sf.path, n.lineno, n.col_offset,
                f"`{ImportResolver.dotted(n)}` starts an async collective "
                f"and hands back its Work, but this scope calls no done "
                f"function to wait on it — the collective is left in "
                f"flight"))


def _operand_names(call: ast.Call) -> List[str]:
    return [a.id for a in call.args[:1] if isinstance(a, ast.Name)]


# ---------------------------------------------------------------------------
# group-schema
# ---------------------------------------------------------------------------

@register
class GroupSchemaChecker(Checker):
    name = "group-schema"
    description = ("axis names in the layout tables (Split specs, AXES, "
                   "grid.size/group literals) are Grid.AXES or 'workers'")
    needs_engine = True

    def check_program(self, index: ProgramIndex):
        valid = grid_axes(index) | {WORKERS}
        findings: List[Finding] = []
        for sf in index.files:
            for node in ast.walk(sf.tree):
                for lit, how in self._axis_literals(sf, node):
                    if lit.value not in valid:
                        findings.append(Finding(
                            self.name, sf.path, lit.lineno, lit.col_offset,
                            f"layout names undeclared grid axis "
                            f"'{lit.value}' ({how}; declared: "
                            f"{', '.join(sorted(valid))})"))
        return findings

    @staticmethod
    def _axis_literals(sf: SourceFile, node: ast.AST):
        if isinstance(node, ast.Call):
            f = node.func
            name = f.attr if isinstance(f, ast.Attribute) else \
                getattr(f, "id", None)
            if name == "Split":
                for kw in node.keywords:
                    if kw.arg is not None:
                        yield ast.Constant(kw.arg, lineno=kw.value.lineno,
                                           col_offset=kw.value.col_offset), \
                            f"`Split({kw.arg}=…)`"
            elif isinstance(f, ast.Attribute) and f.attr in ("size", "group") \
                    and is_grid(f.value) and node.args and \
                    isinstance(node.args[0], ast.Constant) and \
                    isinstance(node.args[0].value, str):
                yield node.args[0], f"`grid.{f.attr}('…')`"
        elif isinstance(node, ast.ClassDef):
            for st in node.body:
                if isinstance(st, ast.Assign) and any(
                        isinstance(t, ast.Name) and t.id == "AXES"
                        for t in st.targets):
                    for e in ast.walk(st.value):
                        if isinstance(e, ast.Constant) and \
                                isinstance(e.value, str):
                            yield e, f"`{node.name}.AXES`"
