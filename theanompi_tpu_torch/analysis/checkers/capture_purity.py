"""capture-purity: nothing of the host inside what a CUDA graph records.

Counterpart of the JAX lint's trace-purity.  JAX traces a step once and
runs the compiled program; the port records the step once into a CUDA
graph (``parallel/graph.StepGraph``) and replays it.  A capture records
device work only: whatever the host does while it runs happens once, at
capture, and never again, or refuses capture outright.

Seeds: every callable handed to ``StepGraph.capture`` (``graph.py``), the
``static`` argument of ``_Captured._run_captured`` (``steps.py``: the
train step's ``_body`` and the exchange's ``body``), and the statements
of every ``with torch.cuda.graph(...)`` block.  The engine closes them
over the call graph (``autograd.Function`` edges and the callable
objects an instance holds included): the step's body, the model's
forward and loss, ``exchange_body`` and the strategies, the numerics
sampler.  Inside that reach, a finding is:

* a host clock (it stamps the capture, not the step);
* ``print``, ``logging`` or a telemetry emit (once, at capture);
* a sync to the host: ``.item()``, ``.cpu()``, ``.tolist()``,
  ``.numpy()``, ``torch.cuda.synchronize``, a stream's or an event's
  ``.synchronize()`` (capture refuses it);
* a NumPy or Python ``random`` draw (one draw, frozen into every replay);
* a torch draw without ``generator=`` (the graph registers only the
  generators it is given);
* a Python ``if``/``while`` on a tensor, and ``bool``/``int``/``float``
  of one (a read back, then one branch frozen);
* ``torch.tensor``/``as_tensor``/``from_numpy`` of host data (a fresh
  host → device copy, its value frozen at capture).

Two shapes are read out of the reach from the code, not suppressed.  A
class whose ``check_capture`` raises under ``if self.size > 1`` is
captured only at world 1 (GoSGD, whose route is drawn on the host): in
its methods, what follows ``if <size> == 1: return`` (``<size>`` being
``self.size`` or a local copy of it) never runs under capture.  And a
memo's fill (``m = cache.get(k)``, then ``if m is None: ...``, or ``if m
is not None: return m``) runs in the eager call that precedes every
capture, never under it: a kernel library's load, a per-device
constant's copy (``memo_skips``).
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from ..core import Checker, Finding, SourceFile, register
from ..engine import (HOST_CLOCKS, META_ATTRS, META_METHODS, FuncRecord,
                      ProgramIndex, draw_name, has_generator, sync_name)

#: The capture entry points.
CAPTURE_METHOD = "capture"
CAPTURE_CLASS = "StepGraph"
RUN_CAPTURED = "_run_captured"
RUN_CAPTURED_STATIC = 2          # (key, eager, static, gens)
CUDA_GRAPH = "torch.cuda.graph"

#: Host → device copies of host data.
HOST_COPIES = {"torch.tensor", "torch.as_tensor", "torch.from_numpy"}
#: Telemetry's recording calls on its receivers.
EMIT_METHODS = {"event", "counter", "observe", "gauge", "emit"}
EMIT_RECEIVERS = {"tm", "telemetry", "_tm"}
#: Tensor methods whose result is a tensor (for the branch-on-tensor
#: rule).
TENSOR_METHODS = {"sum", "mean", "max", "min", "any", "all", "norm", "abs",
                  "sqrt", "float", "to", "clone", "detach", "isfinite",
                  "isnan", "eq", "ne", "lt", "gt", "le", "ge", "square",
                  "amax", "amin", "prod", "count_nonzero", "nonzero"}
_NOT_TENSOR = ("torch.cuda.", "torch.device", "torch.Generator",
               "torch.dtype", "torch.Size", "torch.is_", "torch.get_",
               "torch.no_grad", "torch.profiler.", "torch.distributed.")


def _tensor_call(call: ast.Call, sf: SourceFile) -> bool:
    resolved = sf.resolver.resolve(call.func)
    if resolved is not None:
        return resolved.startswith("torch.") and \
            not resolved.startswith(_NOT_TENSOR)
    return isinstance(call.func, ast.Attribute) and \
        call.func.attr in TENSOR_METHODS


def _tensor_names(sf: SourceFile, body: List[ast.AST]) -> Set[str]:
    """Locals bound from a tensor-valued expression (a torch call, a
    tensor method, arithmetic over either)."""
    out: Set[str] = set()
    for _ in range(3):
        for sub in body:
            if isinstance(sub, ast.Assign) and \
                    _tensor_valued(sf, sub.value, out):
                for t in sub.targets:
                    if isinstance(t, ast.Name):
                        out.add(t.id)
    return out


def _tensor_valued(sf: SourceFile, expr: ast.AST, names: Set[str]) -> bool:
    stack = [expr]
    while stack:
        n = stack.pop()
        if isinstance(n, ast.Attribute) and n.attr in META_ATTRS:
            continue
        if isinstance(n, ast.Compare) and all(
                isinstance(op, (ast.Is, ast.IsNot)) for op in n.ops):
            continue
        if isinstance(n, (ast.Lambda, ast.ListComp, ast.GeneratorExp,
                          ast.DictComp, ast.SetComp)):
            continue
        if isinstance(n, ast.Call):
            if isinstance(n.func, ast.Attribute) and \
                    n.func.attr in META_METHODS:
                continue
            if _tensor_call(n, sf):
                return True
            continue
        if isinstance(n, ast.Name) and n.id in names and \
                isinstance(n.ctx, ast.Load):
            return True
        stack.extend(ast.iter_child_nodes(n))
    return False


@register
class CapturePurityChecker(Checker):
    name = "capture-purity"
    description = ("host clocks, prints and telemetry, syncs to the host, "
                   "host draws, draws without generator=, branches on "
                   "tensors and host→device copies inside what a CUDA "
                   "graph captures — closed over the call graph")
    needs_engine = True

    def check_program(self, index: ProgramIndex):
        seeds, blocks = capture_seeds(index)
        findings: List[Finding] = []
        seen: Set[Tuple[str, int, str]] = set()

        def emit(sf, node, msg):
            key = (sf.path, node.lineno, msg)
            if key not in seen:
                seen.add(key)
                findings.append(Finding(self.name, sf.path, node.lineno,
                                        node.col_offset, msg))

        for sf, body, where in blocks:
            nodes = [n for st in body for n in _walk_no_defs(st)]
            self._scan(sf, nodes, where, emit)
        for rec in capture_reach(index, seeds):
            self._scan(rec.sf, live_body(index, rec), f"`{rec.name}`", emit)
        return findings

    def _scan(self, sf: SourceFile, nodes: List[ast.AST], where: str,
              emit) -> None:
        tensors = _tensor_names(sf, nodes)
        for sub in nodes:
            if isinstance(sub, (ast.If, ast.While)) and \
                    _tensor_valued(sf, sub.test, tensors):
                kind = "while" if isinstance(sub, ast.While) else "if"
                emit(sf, sub, f"Python `{kind}` on a tensor in {where} "
                              f"under capture (a read back, then one "
                              f"branch frozen into every replay; use "
                              f"torch.where)")
            if not isinstance(sub, ast.Call):
                continue
            resolved = sf.resolver.resolve(sub.func)
            f = sub.func
            if resolved in HOST_CLOCKS:
                emit(sf, sub, f"host clock `{resolved}()` in {where} under "
                              f"capture (it stamps the capture, not the "
                              f"step)")
            elif resolved is not None and (
                    resolved.startswith("numpy.random.") or
                    resolved.startswith("random.")):
                emit(sf, sub, f"host draw `{resolved}()` in {where} under "
                              f"capture (one draw, frozen into every "
                              f"replay)")
            elif resolved in HOST_COPIES:
                emit(sf, sub, f"`{resolved}()` of host data in {where} "
                              f"under capture (a fresh host → device "
                              f"copy, its value frozen at capture)")
            elif isinstance(f, ast.Name) and resolved is None and \
                    f.id == "print":
                emit(sf, sub, f"host `print()` in {where} under capture "
                              f"(fires once, at capture)")
            elif (resolved or "").startswith("logging.") or (
                    isinstance(f, ast.Attribute) and
                    f.attr in EMIT_METHODS and
                    isinstance(f.value, ast.Name) and
                    f.value.id in EMIT_RECEIVERS) or \
                    (resolved or "").startswith(
                        "theanompi_tpu_torch.utils.telemetry."):
                emit(sf, sub, f"host logging or telemetry "
                              f"`{(resolved or ast.unparse(f))}()` in "
                              f"{where} under capture (fires once, at "
                              f"capture)")
            elif isinstance(f, ast.Name) and resolved is None and \
                    f.id in ("bool", "int", "float") and sub.args and \
                    _tensor_valued(sf, sub.args[0], tensors):
                emit(sf, sub, f"`{f.id}()` of a tensor in {where} under "
                              f"capture (a sync to the host)")
            else:
                sync = sync_name(sub, sf.resolver)
                if sync is not None:
                    emit(sf, sub, f"`{sync}` in {where} under capture (a "
                                  f"sync to the host, which capture "
                                  f"refuses)")
                d = draw_name(sub, sf.resolver)
                if d is not None and not has_generator(sub):
                    emit(sf, sub, f"draw `{d}` without generator= in "
                                  f"{where} under capture (the graph "
                                  f"replays only the generators it is "
                                  f"given)")


def _walk_no_defs(node: ast.AST):
    stack = [node]
    while stack:
        n = stack.pop()
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.ClassDef)):
            continue
        yield n
        stack.extend(ast.iter_child_nodes(n))


def capture_seeds(index: ProgramIndex):
    """``(seed records, with-blocks)``: the callables handed to a capture,
    and each ``with torch.cuda.graph(...)`` block as ``(sf, statements,
    description)``."""
    seeds: List[FuncRecord] = []
    blocks = []
    for sf in index.files:
        fidx = index.file_index[sf.path]
        ctor_cache: Dict[int, dict] = {}
        for node in ast.walk(sf.tree):
            if isinstance(node, (ast.With, ast.AsyncWith)):
                if any(isinstance(it.context_expr, ast.Call) and
                       sf.resolver.resolve(it.context_expr.func) == CUDA_GRAPH
                       for it in node.items):
                    blocks.append((sf, node.body,
                                   f"the `torch.cuda.graph` block of line "
                                   f"{node.lineno}"))
                    for st in node.body:
                        for call in _walk_no_defs(st):
                            if isinstance(call, ast.Call):
                                enc = fidx.enclosing.get(id(call.func))
                                seeds.extend(index.resolve_df_call(
                                    sf, call.func, enc))
                continue
            if not isinstance(node, ast.Call) or \
                    not isinstance(node.func, ast.Attribute):
                continue
            attr = node.func.attr
            arg = None
            if attr == CAPTURE_METHOD and _is_step_graph(
                    index, sf, node.func, fidx, ctor_cache):
                arg = node.args[0] if node.args else None
                for kw in node.keywords:
                    if kw.arg == "fn":
                        arg = kw.value
            elif attr == RUN_CAPTURED:
                arg = node.args[RUN_CAPTURED_STATIC] \
                    if len(node.args) > RUN_CAPTURED_STATIC else None
                for kw in node.keywords:
                    if kw.arg == "static":
                        arg = kw.value
            if arg is None:
                continue
            enc = fidx.enclosing.get(id(arg))
            rec = index.record_for(enc) if enc is not None else None
            ctor = index.local_ctor_types(rec) if rec is not None else None
            seeds.extend(index.resolve_callable(sf, arg, enc, ctor))
    return seeds, blocks


def _is_step_graph(index, sf, func: ast.Attribute, fidx, cache) -> bool:
    """``<x>.capture`` where ``<x>`` is a ``StepGraph``: built in place,
    a local built from one, or resolved to its method."""
    recv = func.value
    if isinstance(recv, ast.Call):
        dotted = sf.resolver.resolve(recv.func) or \
            (getattr(recv.func, "id", None) or
             getattr(recv.func, "attr", ""))
        return dotted.rsplit(".", 1)[-1] == CAPTURE_CLASS
    enc = fidx.enclosing.get(id(func))
    rec = index.record_for(enc) if enc is not None else None
    if rec is None:
        return False
    types = cache.get(id(enc))
    if types is None:
        types = cache[id(enc)] = index.local_ctor_types(rec)
    if isinstance(recv, ast.Name) and recv.id in types:
        return types[recv.id][1] == CAPTURE_CLASS
    return any(t.qualname.endswith(f"{CAPTURE_CLASS}.{CAPTURE_METHOD}")
               for t in index.resolve_call(sf, func, enc, types))


def live_body(index: ProgramIndex, rec: FuncRecord) -> List[ast.AST]:
    """The nodes of ``rec``'s body that can run under capture: all but a
    memo's fill (see :func:`memo_skips`) and, in a class captured only
    at world 1, what follows a world-1 early return."""
    body = index.body(rec.node)
    skip = memo_skips(rec.node)
    cut = world1_return(rec.node) if rec.class_key is not None and \
        world1_only(index, rec.class_key) else None
    if not skip and cut is None:
        return body
    return [n for n in body if id(n) not in skip and
            (cut is None or getattr(n, "lineno", 0) <= cut.lineno)]


def memo_skips(fn: ast.AST) -> Set[int]:
    """Node ids of a memo's fill: the block of ``if m is None:`` where
    ``m`` was read from a cache (``m = cache.get(k)``), and what follows
    ``if m is not None: return m``.  The eager call that precedes every
    capture (``steps._Captured._run_captured``) fills each memo the step
    reads, so under capture the read hits and the fill never runs (a
    kernel library's load and build, a per-device constant's host →
    device copy)."""
    memos: Set[str] = set()
    for sub in ast.walk(fn):
        if isinstance(sub, ast.Assign) and len(sub.targets) == 1 and \
                isinstance(sub.targets[0], ast.Name) and \
                isinstance(sub.value, ast.Call) and \
                isinstance(sub.value.func, ast.Attribute) and \
                sub.value.func.attr == "get":
            memos.add(sub.targets[0].id)
    if not memos:
        return set()
    out: Set[int] = set()

    def memo_test(test, op) -> bool:
        return isinstance(test, ast.Compare) and len(test.ops) == 1 and \
            isinstance(test.ops[0], op) and \
            isinstance(test.left, ast.Name) and test.left.id in memos and \
            isinstance(test.comparators[0], ast.Constant) and \
            test.comparators[0].value is None

    def block(stmts) -> None:
        for i, st in enumerate(stmts):
            if isinstance(st, ast.If) and memo_test(st.test, ast.Is):
                out.update(id(n) for b in st.body for n in ast.walk(b))
            elif isinstance(st, ast.If) and \
                    memo_test(st.test, ast.IsNot) and st.body and \
                    isinstance(st.body[-1], ast.Return):
                out.update(id(n) for b in stmts[i + 1:] for n in ast.walk(b))
                return
            for f in ("body", "orelse", "finalbody"):
                inner = getattr(st, f, None)
                if isinstance(inner, list) and not isinstance(
                        st, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
                    block(inner)

    block(getattr(fn, "body", []))
    return out


def capture_reach(index: ProgramIndex, seeds) -> List[FuncRecord]:
    """The seeds' closure, leaving out what a world-1 class's early return
    cuts off: the callees called only after it."""
    out: List[FuncRecord] = []
    seen: Set[int] = set()
    frontier = list(seeds)
    while frontier:
        rec = frontier.pop()
        if id(rec.node) in seen:
            continue
        seen.add(id(rec.node))
        out.append(rec)
        callees = index.df_callees(rec)
        live = live_body(index, rec)
        if len(live) != len(index.body(rec.node)):
            keep = {id(c) for c in _callee_nodes(index, rec, live)}
            callees = [c for c in callees if id(c.node) in keep]
        frontier.extend(callees)
    return out


def _callee_nodes(index, rec, nodes) -> List[ast.AST]:
    """The function nodes that the calls among ``nodes``, and the
    callables they pass, resolve to."""
    idx = index.file_index[rec.sf.path]
    live = {id(n) for n in nodes}
    out: List[ast.AST] = []
    for sub in nodes:
        if not isinstance(sub, ast.Call):
            continue
        out += [t.node for t in index.resolve_df_call(
            rec.sf, sub.func, idx.enclosing.get(id(sub.func), rec.node))]
        for a in list(sub.args) + [k.value for k in sub.keywords]:
            if id(a) not in live:
                continue
            if isinstance(a, ast.Lambda):
                out.append(a)
            elif isinstance(a, (ast.Name, ast.Attribute)):
                out += [t.node for t in index.resolve_call(
                    rec.sf, a, idx.enclosing.get(id(a), rec.node))]
    return out


def world1_only(index: ProgramIndex, key) -> bool:
    """True when the class's ``check_capture`` raises under
    ``if self.size > 1`` (or ``!= 1``, ``>= 2``): it is captured only at
    world 1 (cached on the index)."""
    cache = index.__dict__.setdefault("_world1_only", {})
    if key in cache:
        return cache[key]
    hit = False
    for rec in index.method_records(key, "check_capture", False):
        if rec.class_key != key:
            continue
        for st in rec.node.body:
            if isinstance(st, ast.If) and _size_test(st.test, {}, (
                    (ast.Gt, 1), (ast.NotEq, 1), (ast.GtE, 2))) and \
                    any(isinstance(s, ast.Raise) for s in st.body):
                hit = True
    cache[key] = hit
    return hit


def world1_return(fn: ast.AST) -> Optional[ast.If]:
    """The first top-level ``if <size> == 1: return ...`` of a body."""
    aliases: Dict[str, bool] = {}
    for st in getattr(fn, "body", []):
        if isinstance(st, ast.Assign) and len(st.targets) == 1 and \
                isinstance(st.targets[0], ast.Name) and \
                _is_self_size(st.value):
            aliases[st.targets[0].id] = True
        if isinstance(st, ast.If) and _size_test(
                st.test, aliases, ((ast.Eq, 1), (ast.LtE, 1))) and \
                st.body and isinstance(st.body[-1], ast.Return):
            return st
    return None


def _is_self_size(e: ast.AST) -> bool:
    return isinstance(e, ast.Attribute) and e.attr == "size" and \
        isinstance(e.value, ast.Name) and e.value.id == "self"


def _size_test(test: ast.AST, aliases, ops) -> bool:
    if not (isinstance(test, ast.Compare) and len(test.ops) == 1):
        return False
    left, right = test.left, test.comparators[0]
    is_size = _is_self_size(left) or (isinstance(left, ast.Name) and
                                      left.id in aliases)
    return is_size and isinstance(right, ast.Constant) and any(
        isinstance(test.ops[0], op) and right.value == v for op, v in ops)
