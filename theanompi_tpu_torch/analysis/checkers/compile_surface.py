"""Compile-surface discipline: cache-key, graph-key, dtype-flow.

Counterpart of the JAX lint's compile-surface checks.  The JAX package
compiles XLA programs and keys its AOT cache by the config knobs that
shape them; the port builds CUDA kernel libraries with ``nvcc`` and keys
them by source, flags and toolkit (``ops/_kernel_build.library_key`` →
``utils/compile_cache.library_key``), and it captures each step into a
CUDA graph it keys by what shapes the recording
(``steps._Captured._run_captured``).  Three checks:

``cache-key`` (JAX cache-key)
    Every input of the ``nvcc`` command ``_kernel_build._nvcc`` runs must
    reach ``library_key``: each element of the command (a flag written
    there, a name, a call, an environment value that picks the compiler
    or its flags) must be read somewhere in ``library_key``'s reach, and
    a local ``#include "…"`` of a source must be hashed too.  The output
    (``-o <path>``) is exempt.  A flag appended in ``_nvcc`` but missing
    from ``NVCC_FLAGS`` builds a different library under the old key: a
    cache hit then loads a stale build.

``graph-key`` (JAX retrace-hazard)
    Inside what a capture records (capture-purity's reach), a host value
    that shapes the recording — a Python branch's test, a loop count, a
    size, a slice bound — must be fixed for the graph's life or part of
    the graph's key.  An attribute is fixed when every assignment to it
    lies in set-up: ``__init__``, a function that (re)builds the steps
    (its graphs are made after), one that changes a key attribute (every
    graph is keyed out), or a method only set-up calls.  It is keyed when
    the ``key`` handed to ``_run_captured`` reads it (through the methods
    the key expression calls) or the replay's guard compares it (the
    state tensors, ``_Captured._state_current``).  A config knob read
    there (``config.get("x")``: the dict stays mutable), a host clock,
    ``os.environ`` or a host draw is always a finding: read the knob once
    at set-up.  Otherwise a changed
    value replays a stale graph: a wrong result, not a slow one.

``dtype-flow`` (JAX dtype-flow)
    The bf16 wire of the in-place collectives: after ``w = g.to(<low>)``
    and ``dist.all_reduce(w)``, ``w`` is cast back up (``w.to(g.dtype)``,
    ``.float()``, a ``copy_`` into the float32 leaf) before any
    arithmetic — ``strategies.AllReduce`` is the good shape.  A low
    dtype is a static ``torch.bfloat16``/``float16``/float8 or a wire
    dtype (a name or attribute called ``wire_dtype``, or a local bound
    from one).  A cast applied to the packed vector before bucketing
    breaks the per-bucket contract.  A deliberate round trip
    (``x.to(a).to(b)``, ``x.copy_(x.to(a))``) is registered in its
    module's pure-literal ``NONBITEXACT = {"Class.method": "reason"}``;
    unregistered round trips and stale entries are findings.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Dict, Iterable, List, Optional, Set, Tuple

from ..core import Checker, Finding, ImportResolver, SourceFile, register
from ..engine import (HOST_CLOCKS, LOW_PRECISION_DTYPES, META_ATTRS,
                      META_METHODS, FuncRecord, ProgramIndex, bare_names,
                      body_walk, call_collective, config_knob, static_dtype)
from .capture_purity import capture_reach, capture_seeds, live_body

KERNEL_BUILD_PATH = "theanompi_tpu_torch/ops/_kernel_build.py"
CSRC_GLOB = "theanompi_tpu_torch/csrc/*.cu"
#: the function that runs nvcc, and the one that keys its library
NVCC_FN, KEY_FN = "_nvcc", "library_key"
_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)

NONBITEXACT_NAME = "NONBITEXACT"

#: what (re)builds the captured steps: a function calling one of these
#: makes its graphs after whatever it assigned
STEP_MAKERS = {"rebuild_steps", "build_train_step", "TrainStep",
                 "ExchangeStep"}
RUN_CAPTURED = "_run_captured"


# ---------------------------------------------------------------------------
# cache-key
# ---------------------------------------------------------------------------

def _env_key(node: ast.AST, resolver: ImportResolver) -> Optional[str]:
    """The variable of ``os.environ.get("X")``, ``os.environ["X"]``,
    ``os.getenv("X")``, or None."""
    if isinstance(node, ast.Call):
        r = resolver.resolve(node.func)
        if r in ("os.environ.get", "os.getenv") and node.args and \
                isinstance(node.args[0], ast.Constant):
            return str(node.args[0].value)
    if isinstance(node, ast.Subscript) and \
            resolver.resolve(node.value) == "os.environ" and \
            isinstance(node.slice, ast.Constant):
        return str(node.slice.value)
    return None


def _atoms(expr: ast.AST, resolver: ImportResolver,
           locals_: Dict[str, List[ast.AST]], _seen=None
           ) -> List[Tuple[str, ast.AST]]:
    """``(atom, node)`` for what an expression reads: string literals,
    names, dotted calls, environment variables; a local is read through
    its assignments."""
    seen = set(_seen or ())
    out: List[Tuple[str, ast.AST]] = []
    for n in ast.walk(expr):
        env = _env_key(n, resolver)
        if env is not None:
            out.append((f"env:{env}", n))
        if isinstance(n, ast.Constant) and isinstance(n.value, str):
            out.append((f"lit:{n.value}", n))
        elif isinstance(n, ast.Call):
            dotted = resolver.resolve(n.func) or \
                ImportResolver.dotted(n.func)
            if dotted:
                out.append((f"call:{dotted.rsplit('.', 1)[-1]}", n))
        elif isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load):
            if n.id in locals_ and n.id not in seen:
                seen.add(n.id)
                for v in locals_[n.id]:
                    out.extend(_atoms(v, resolver, locals_, seen))
            else:
                out.append((f"name:{n.id}", n))
    return out


def _locals(fn: ast.AST) -> Dict[str, List[ast.AST]]:
    out: Dict[str, List[ast.AST]] = {}
    for st in body_walk(fn):
        if isinstance(st, ast.Assign):
            for t in st.targets:
                if isinstance(t, ast.Name):
                    out.setdefault(t.id, []).append(st.value)
    return out


def _command_elements(fn: ast.AST) -> List[ast.AST]:
    """The elements of the nvcc command lists of ``fn``: each list display
    whose first element names nvcc, and what is appended to its name."""
    out: List[ast.AST] = []
    names: Set[str] = set()
    for st in body_walk(fn):
        if isinstance(st, ast.List) and st.elts:
            head = ast.unparse(st.elts[0])
            if "nvcc" in head:
                out.extend(e.value if isinstance(e, ast.Starred) else e
                           for e in st.elts)
        if isinstance(st, ast.Assign) and isinstance(st.value, ast.List) \
                and st.value.elts and "nvcc" in ast.unparse(
                    st.value.elts[0]):
            names |= {t.id for t in st.targets if isinstance(t, ast.Name)}
    for st in body_walk(fn):
        if isinstance(st, ast.Call) and isinstance(st.func, ast.Attribute) \
                and st.func.attr in ("append", "extend", "insert") and \
                isinstance(st.func.value, ast.Name) and \
                st.func.value.id in names:
            out.extend(st.args[-1:])
        if isinstance(st, ast.AugAssign) and isinstance(st.target, ast.Name) \
                and st.target.id in names:
            out.append(st.value)
    # the output: ``-o`` and the path after it
    drop: Set[int] = set()
    for i, e in enumerate(out):
        if isinstance(e, ast.Constant) and e.value == "-o":
            drop |= {i, i + 1}
    return [e for i, e in enumerate(out) if i not in drop]


@register
class CacheKeyChecker(Checker):
    name = "cache-key"
    description = ("every input of the nvcc command (_kernel_build._nvcc) "
                   "reaches library_key: flags, sources, local includes, "
                   "the environment that picks the compiler")
    needs_engine = True
    disk_scoped = (KERNEL_BUILD_PATH, CSRC_GLOB)

    def check_program(self, index: ProgramIndex) -> Iterable[Finding]:
        findings: List[Finding] = []
        for nvcc_fn in index.records.values():
            if nvcc_fn.name != NVCC_FN or nvcc_fn.class_key is not None:
                continue
            keys = [r for r in index.records.values()
                    if r.name == KEY_FN and r.sf is nvcc_fn.sf]
            if not keys:
                continue
            findings.extend(self._check(index, nvcc_fn, keys))
        return findings

    def _check(self, index, nvcc_fn: FuncRecord, keys) -> List[Finding]:
        sf = nvcc_fn.sf
        hashed: Set[str] = set()
        reach = index.df_reachable(keys)
        for rec in reach:
            hashed |= {a for a, _ in _atoms(rec.node, rec.sf.resolver, {})}
            hashed.add(f"call:{rec.name}")
        out: List[Finding] = []
        locals_ = _locals(nvcc_fn.node)
        for e in _command_elements(nvcc_fn.node):
            for atom, node in _atoms(e, sf.resolver, locals_):
                if atom in hashed or atom == "lit:nvcc":
                    continue
                what = atom.split(":", 1)
                out.append(Finding(
                    self.name, sf.path, node.lineno, node.col_offset,
                    f"nvcc input {what[0]} `{what[1]}` of `{NVCC_FN}` never "
                    f"reaches `{KEY_FN}` — a cache hit could load a library "
                    f"built without it; add it to the key (NVCC_FLAGS, the "
                    f"hashed source) or justify with `# tpulint: "
                    f"disable=cache-key`"))
                break                       # one finding an element
        # a local #include of a source the key does not hash
        if not any(a.startswith("lit:") and "#include" in a for a in hashed):
            root = sf.root
            csrc = os.path.join(root, os.path.dirname(CSRC_GLOB))
            for fn in sorted(os.listdir(csrc)) if os.path.isdir(csrc) else ():
                if not fn.endswith((".cu", ".cuh", ".h")):
                    continue
                try:
                    with open(os.path.join(csrc, fn), encoding="utf-8",
                              errors="replace") as f:
                        text = f.read()
                except OSError:
                    continue
                for inc in _INCLUDE.findall(text):
                    out.append(Finding(
                        self.name, sf.path, nvcc_fn.node.lineno, 0,
                        f"csrc/{fn} includes \"{inc}\", which `{KEY_FN}` "
                        f"does not hash — an edit of it keeps the old key"))
        return out


# ---------------------------------------------------------------------------
# graph-key
# ---------------------------------------------------------------------------

def _host_value(node: ast.AST, resolver: ImportResolver) -> Optional[str]:
    knob = config_knob(node)
    if knob is not None:
        return f"config knob '{knob}'"
    if isinstance(node, ast.Call):
        r = resolver.resolve(node.func)
        if r in HOST_CLOCKS or (r or "").startswith(("numpy.random.",
                                                     "random.")):
            return f"`{r}()`"
    dotted = ImportResolver.dotted(node)
    if dotted and (dotted == "os.environ" or dotted.startswith("os.environ.")):
        return "`os.environ`"
    return None


def _attr_reads(expr: ast.AST) -> List[ast.Attribute]:
    """Attribute loads of ``expr`` (not host metadata, not a method being
    called)."""
    called = {id(n.func) for n in ast.walk(expr) if isinstance(n, ast.Call)}
    return [n for n in bare_attr_walk(expr)
            if isinstance(n, ast.Attribute) and isinstance(n.ctx, ast.Load)
            and id(n) not in called]


def bare_attr_walk(expr: ast.AST):
    """The nodes of ``expr`` past host metadata and nested scopes."""
    stack = [expr]
    while stack:
        n = stack.pop()
        if isinstance(n, ast.Attribute) and n.attr in META_ATTRS:
            continue
        if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute) \
                and n.func.attr in META_METHODS:
            continue
        if isinstance(n, (ast.Lambda, ast.ListComp, ast.GeneratorExp,
                          ast.DictComp, ast.SetComp)):
            continue
        yield n
        stack.extend(ast.iter_child_nodes(n))


class _Stores:
    """Where each attribute is assigned — through ``self`` by class, or
    on another object — and which functions are set-up."""

    def __init__(self, index: ProgramIndex, key_attrs: Set[str]):
        self.index = index
        self.own: Dict[Tuple[tuple, str], List[FuncRecord]] = {}
        self.foreign: Dict[str, List[FuncRecord]] = {}
        for rec in index.records.values():
            for sub in index.body(rec.node):
                targets = sub.targets if isinstance(sub, ast.Assign) else \
                    [sub.target] if isinstance(
                        sub, (ast.AugAssign, ast.AnnAssign)) else []
                for t in targets:
                    for n in ast.walk(t):
                        if isinstance(n, ast.Attribute) and \
                                isinstance(n.ctx, ast.Store):
                            self._add(rec, n.value, n.attr)
                if isinstance(sub, ast.Call) and \
                        isinstance(sub.func, ast.Name) and \
                        sub.func.id == "setattr" and len(sub.args) > 1 and \
                        isinstance(sub.args[1], ast.Constant):
                    self._add(rec, sub.args[0], str(sub.args[1].value))
        self.setup = self._setup(key_attrs)

    def _add(self, rec, recv, attr) -> None:
        """A store of ``attr`` on ``recv``: the class family's own when the
        receiver's class is known (``self``, ``self.x`` held from a
        constructor or an annotation); else on an object of unknown class.
        A store on a local built in place is its construction."""
        key = None
        if isinstance(recv, ast.Name) and recv.id == "self":
            key = rec.class_key
        elif isinstance(recv, ast.Attribute) and \
                isinstance(recv.value, ast.Name) and \
                recv.value.id == "self" and rec.class_key is not None:
            key = self.index.attr_classes(rec.class_key).get(recv.attr)
        elif isinstance(recv, ast.Name) and \
                recv.id in self.index.local_ctor_types(rec):
            return          # a fresh object's construction: nothing saw it
        if key is not None:
            self.own.setdefault((key, attr), []).append(rec)
        else:
            self.foreign.setdefault(attr, []).append(rec)

    def stored_in(self, rec: FuncRecord, attrs: Set[str]) -> bool:
        return any(rec in v for (k, a), v in self.own.items()
                   if a in attrs) or \
            any(rec in self.foreign.get(a, ()) for a in attrs)

    def _setup(self, key_attrs: Set[str]) -> Set[int]:
        idx = self.index
        callers: Dict[int, List[FuncRecord]] = {}
        for rec in idx.records.values():
            for c in idx.df_callees(rec):
                callers.setdefault(id(c.node), []).append(rec)
        setup: Set[int] = set()
        for rec in idx.records.values():
            makes = any(
                isinstance(s, ast.Call) and (
                    getattr(s.func, "attr", None) in STEP_MAKERS or
                    getattr(s.func, "id", None) in STEP_MAKERS)
                for s in idx.body(rec.node))
            if rec.name == "__init__" or makes or \
                    self.stored_in(rec, key_attrs):
                setup.add(id(rec.node))
        # the greatest set closed under "called only from set-up" (the
        # overrides of one method call each other through ``super()``)
        cand = {id(r.node) for r in idx.records.values()
                if id(r.node) in setup or callers.get(id(r.node))}
        changed = True
        while changed:
            changed = False
            for rec in idx.records.values():
                i = id(rec.node)
                if i in cand and i not in setup and not all(
                        id(c.node) in cand for c in callers[i]):
                    cand.discard(i)
                    changed = True
        return cand

    def fixed(self, rec: FuncRecord, a: ast.Attribute) -> bool:
        """Every assignment an attribute read can see lies in set-up: of
        ``self.X``, the stores of X in the reading class's family and on
        other objects; of ``obj.X``, every store of X."""
        own = [v for (k, attr), v in self.own.items() if attr == a.attr]
        # a store on an object of unknown class counts only for an
        # attribute no class is seen to keep
        recs = [] if own else list(self.foreign.get(a.attr, ()))
        if isinstance(a.value, ast.Name) and a.value.id == "self" and \
                rec.class_key is not None:
            fam = set(self.index.subclasses_of(
                f"{rec.class_key[0]}.{rec.class_key[1]}"))
            fam |= set(_ancestors(self.index, rec.class_key))
            for (k, attr), v in self.own.items():
                if attr == a.attr and k in fam:
                    recs += v
        else:
            for (k, attr), v in self.own.items():
                if attr == a.attr:
                    recs += v
        return all(id(r.node) in self.setup for r in recs)


def _ancestors(index: ProgramIndex, key) -> List[tuple]:
    out, frontier = [key], [key]
    while frontier:
        for b in index.class_bases.get(frontier.pop(), []):
            bk = index.class_key(b)
            if bk is not None and bk not in out:
                out.append(bk)
                frontier.append(bk)
    return out


def key_attrs(index: ProgramIndex) -> Set[str]:
    """Attribute names the ``key`` of every ``_run_captured`` call reads,
    through the methods its expression calls."""
    out: Set[str] = set()
    for sf in index.files:
        fidx = index.file_index[sf.path]
        for node in ast.walk(sf.tree):
            if not (isinstance(node, ast.Call) and
                    isinstance(node.func, ast.Attribute) and
                    node.func.attr == RUN_CAPTURED):
                continue
            key = node.args[0] if node.args else None
            for kw in node.keywords:
                if kw.arg == "key":
                    key = kw.value
            if key is None:
                continue
            enc = fidx.enclosing.get(id(node))
            exprs = [key]
            if isinstance(key, ast.Name) and enc is not None:
                exprs += [st.value for st in body_walk(enc)
                          if isinstance(st, ast.Assign) and any(
                              isinstance(t, ast.Name) and t.id == key.id
                              for t in st.targets)]
            seeds = []
            for e in exprs:
                out |= {n.attr for n in ast.walk(e)
                        if isinstance(n, ast.Attribute)}
                for c in ast.walk(e):
                    if isinstance(c, ast.Call):
                        seeds += index.resolve_df_call(
                            sf, c.func, fidx.enclosing.get(id(c.func), enc))
            for rec in index.df_reachable(seeds):
                out |= {n.attr for n in index.body(rec.node)
                        if isinstance(n, ast.Attribute)
                        and isinstance(n.ctx, ast.Load)}
    # and what the replay's own guard compares (the state tensors a graph
    # was captured with: ``_Captured._state_current``)
    for rec in index.records.values():
        if rec.name != RUN_CAPTURED:
            continue
        fidx = index.file_index[rec.sf.path]
        for st in index.body(rec.node):
            if isinstance(st, ast.If) and any(
                    isinstance(c, ast.Call) and
                    isinstance(c.func, ast.Attribute) and
                    c.func.attr == "replay" for b in st.body
                    for c in ast.walk(b)):
                seeds = [t for c in ast.walk(st.test)
                         if isinstance(c, ast.Call)
                         for t in index.resolve_df_call(
                             rec.sf, c.func,
                             fidx.enclosing.get(id(c.func), rec.node))]
                for r in index.df_reachable(seeds):
                    out |= {n.attr for n in index.body(r.node)
                            if isinstance(n, ast.Attribute)}
    return out


@register
class GraphKeyChecker(Checker):
    name = "graph-key"
    description = ("a host value that shapes what a capture records is "
                   "fixed at set-up or part of the graph's key")
    needs_engine = True

    def check_program(self, index: ProgramIndex) -> Iterable[Finding]:
        keyed = key_attrs(index)
        stores = _Stores(index, keyed)
        seeds, blocks = capture_seeds(index)
        findings: List[Finding] = []
        seen: Set[Tuple[str, int, str]] = set()

        def emit(sf, node, msg):
            k = (sf.path, node.lineno, msg)
            if k not in seen:
                seen.add(k)
                findings.append(Finding(self.name, sf.path, node.lineno,
                                        node.col_offset, msg))

        for rec in capture_reach(index, seeds):
            live = {id(n) for n in live_body(index, rec)}
            locals_ = _locals(rec.node)
            for expr, why in index.shaping_use_sites(rec):
                if id(expr) not in live:
                    continue
                self._judge(rec, expr, why, locals_, keyed, stores, emit)
        return findings

    def _judge(self, rec, expr, why, locals_, keyed, stores, emit) -> None:
        sf = rec.sf
        exprs, seen = [expr], set()
        for nm in bare_names(expr):
            if nm.id in locals_ and nm.id not in seen:
                seen.add(nm.id)
                exprs += locals_[nm.id]
        for e in exprs:
            for n in ast.walk(e):
                host = _host_value(n, sf.resolver)
                if host is not None:
                    emit(sf, n, f"host value {host} shapes what the capture "
                                f"records ({why} in `{rec.name}`) — every "
                                f"replay keeps the value of the capture")
            for a in _attr_reads(e):
                if a.attr in keyed or stores.fixed(rec, a):
                    continue
                emit(sf, a, f"`{ImportResolver.dotted(a) or a.attr}` shapes "
                            f"what the capture records ({why} in "
                            f"`{rec.name}`) but is reassigned after set-up "
                            f"and is not in the graph's key — a changed "
                            f"value replays a stale graph")


# ---------------------------------------------------------------------------
# dtype-flow
# ---------------------------------------------------------------------------

#: in-place and out-of-place arithmetic on a tensor
ARITH_METHODS = {"add", "add_", "sub", "sub_", "mul", "mul_", "div", "div_",
                 "sum", "mean", "cumsum", "addcmul_", "addcdiv_", "lerp_",
                 "pow", "pow_", "square", "sqrt", "neg", "neg_"}
ARITH_FUNCS = {"torch.add", "torch.sub", "torch.mul", "torch.div",
               "torch.sum", "torch.mean", "torch.cumsum", "torch.lerp"}
UPCASTS = {"float", "double"}


def _is_cast(call: ast.AST) -> bool:
    return isinstance(call, ast.Call) and isinstance(call.func, ast.Attribute) \
        and (call.func.attr == "to" or call.func.attr in UPCASTS or
             call.func.attr in ("bfloat16", "half"))


def _wire_dtype(node: ast.AST, resolver: ImportResolver,
                wire_names: Set[str]) -> Optional[str]:
    """The low dtype a ``.to(<node>)`` casts to, or None: a static low
    dtype, or a wire dtype by name."""
    dt = static_dtype(node, resolver)
    if dt in LOW_PRECISION_DTYPES:
        return dt
    dotted = ImportResolver.dotted(node) or ""
    if dotted.rsplit(".", 1)[-1] == "wire_dtype" or dotted in wire_names:
        return "wire dtype"
    return None


def _low_cast(call: ast.AST, resolver, wire_names) -> Optional[str]:
    if not isinstance(call, ast.Call) or \
            not isinstance(call.func, ast.Attribute):
        return None
    if call.func.attr in ("bfloat16", "half"):
        return call.func.attr
    if call.func.attr == "to" and call.args:
        return _wire_dtype(call.args[0], resolver, wire_names)
    return None


def nonbitexact_registry(sf: SourceFile):
    """``(entries, line, problem)`` of a module's ``NONBITEXACT``."""
    for node in sf.tree.body:
        targets = node.targets if isinstance(node, ast.Assign) else \
            [node.target] if isinstance(node, ast.AnnAssign) and \
            node.value is not None else []
        if not any(isinstance(t, ast.Name) and t.id == NONBITEXACT_NAME
                   for t in targets):
            continue
        try:
            val = ast.literal_eval(node.value)
        except (ValueError, SyntaxError):
            val = None
        if not isinstance(val, dict) or not all(
                isinstance(k, str) and isinstance(v, str) and v.strip()
                for k, v in val.items()):
            return {}, node.lineno, (
                f"{NONBITEXACT_NAME} must be a pure literal "
                f"{{\"Class.method\": \"reason\"}} dict — computed "
                f"registries cannot be audited statically")
        return val, node.lineno, None
    return {}, 0, None


def _sites(sf: SourceFile) -> Dict[int, str]:
    """Node id -> its top-level site: ``Class.method`` or ``function``."""
    out: Dict[int, str] = {}
    for top in sf.tree.body:
        if isinstance(top, ast.ClassDef):
            for m in top.body:
                if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    for n in ast.walk(m):
                        out[id(n)] = f"{top.name}.{m.name}"
        elif isinstance(top, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for n in ast.walk(top):
                out[id(n)] = top.name
    return out


def _round_trip(node: ast.AST) -> bool:
    """``x.to(a).to(b)`` (any two casts in a row), or ``x.copy_(x.to(a))``."""
    if _is_cast(node) and _is_cast(node.func.value):
        return True
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
            and node.func.attr == "copy_" and node.args and \
            _is_cast(node.args[0]):
        base = ImportResolver.dotted(node.func.value)
        src = ImportResolver.dotted(node.args[0].func.value)
        return base is not None and base == src
    return False


@register
class DtypeFlowChecker(Checker):
    name = "dtype-flow"
    description = ("a bf16/f16 in-place collective's tensor is cast back up "
                   "before arithmetic; wire casts are per bucket; "
                   "deliberate round trips are registered in NONBITEXACT")

    def applies_to(self, path: str) -> bool:
        return not path.startswith("tests/")

    def check_file(self, sf: SourceFile) -> Iterable[Finding]:
        findings: List[Finding] = []
        registry, reg_line, problem = nonbitexact_registry(sf)
        if problem:
            findings.append(Finding(self.name, sf.path, reg_line, 0,
                                    problem))
        sites: Set[str] = set()
        trips = [n for n in sf.nodes if _round_trip(n)]
        if trips:
            site_of = _sites(sf)
            for node in trips:
                site = site_of.get(id(node)) or "<module>"
                sites.add(site)
                if site not in registry:
                    findings.append(Finding(
                        self.name, sf.path, node.lineno, node.col_offset,
                        f"non-bit-exact cast round-trip in `{site}` — "
                        f"deliberate wire rounding must be registered in "
                        f"this module's {NONBITEXACT_NAME} registry with a "
                        f"one-line reason"))
        for key in sorted(set(registry) - sites):
            findings.append(Finding(
                self.name, sf.path, reg_line, 0,
                f"stale {NONBITEXACT_NAME} entry '{key}': no cast "
                f"round-trip remains at that site — drop the entry so the "
                f"registry keeps matching reality"))
        if ".to(" in sf.text or ".half(" in sf.text or \
                ".bfloat16(" in sf.text:
            for node in sf.nodes:
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    findings.extend(self._function(sf, node))
        return findings

    def _function(self, sf: SourceFile, fn: ast.AST) -> List[Finding]:
        resolver = sf.resolver
        body = list(body_walk(fn))
        if not any(isinstance(n, ast.Call) and
                   isinstance(n.func, ast.Attribute) and
                   n.func.attr in ("to", "half", "bfloat16") for n in body):
            return []
        nodes = sorted((n for n in body if hasattr(n, "lineno")),
                       key=lambda n: (n.lineno, n.col_offset))
        parents: Dict[int, ast.AST] = {}
        for n in body:
            for c in ast.iter_child_nodes(n):
                parents[id(c)] = n
        wire_names: Set[str] = set()
        for n in nodes:
            if isinstance(n, ast.Assign) and _wire_dtype(
                    n.value, resolver, wire_names):
                wire_names |= {t.id for t in n.targets
                               if isinstance(t, ast.Name)}
        cast: Dict[str, Tuple[str, int]] = {}     # name -> (dtype, line)
        for n in nodes:
            if isinstance(n, ast.Assign) and len(n.targets) == 1 and \
                    isinstance(n.targets[0], ast.Name):
                dt = _low_cast(n.value, resolver, wire_names)
                if dt is not None:
                    cast[n.targets[0].id] = (dt, n.lineno)
        findings: List[Finding] = []
        if not cast:
            return findings
        # the in-place collective, then arithmetic before the upcast
        low: Dict[str, str] = {}
        for n in nodes:
            if isinstance(n, ast.Call) and call_collective(n, resolver) and \
                    n.args and isinstance(n.args[0], ast.Name) and \
                    n.args[0].id in cast:
                low[n.args[0].id] = cast[n.args[0].id][0]
                continue
            if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Store):
                low.pop(n.id, None)
                continue
            if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load) and \
                    n.id in low:
                how = self._arith_use(n, parents, resolver)
                if how is not None:
                    findings.append(Finding(
                        self.name, sf.path, n.lineno, n.col_offset,
                        f"{low[n.id]} collective result `{n.id}` used in "
                        f"{how} before it is cast back up — low-precision "
                        f"arithmetic compounds the wire's rounding; cast it "
                        f"up first (`{n.id}.to(g.dtype)`, the strategies.py "
                        f"shape)"))
                    low.pop(n.id)
        # the wire cast per bucket, not on the packed vector
        for n in nodes:
            loops = []
            if isinstance(n, (ast.For, ast.AsyncFor)):
                loops.append((n.iter, n.body))
            elif isinstance(n, (ast.ListComp, ast.SetComp, ast.GeneratorExp)):
                loops += [(g.iter, [n.elt]) for g in n.generators]
            for it, body in loops:
                base = it
                while isinstance(base, ast.Call) and \
                        isinstance(base.func, ast.Attribute):
                    base = base.func.value
                if not (isinstance(base, ast.Name) and base.id in cast):
                    continue
                hit = next((c for b in body for c in ast.walk(b)
                            if isinstance(c, ast.Call) and
                            call_collective(c, resolver)), None)
                if hit is not None:
                    findings.append(Finding(
                        self.name, sf.path, hit.lineno, hit.col_offset,
                        f"collective over buckets of `{base.id}`, which was "
                        f"wire-cast BEFORE bucketing — cast each bucket, so "
                        f"the monolithic and bucketed wires stay "
                        f"bit-identical"))
        return findings

    @staticmethod
    def _arith_use(name: ast.Name, parents, resolver) -> Optional[str]:
        p = parents.get(id(name))
        if isinstance(p, ast.BinOp):
            return f"`{type(p.op).__name__}`"
        if isinstance(p, ast.AugAssign):
            return "an augmented assignment"
        if isinstance(p, ast.Attribute) and p.value is name and \
                p.attr in ARITH_METHODS and \
                isinstance(parents.get(id(p)), ast.Call):
            return f"`.{p.attr}()`"
        if isinstance(p, ast.Call) and name in p.args:
            r = resolver.resolve(p.func) or ""
            if r in ARITH_FUNCS or r.startswith("torch._foreach_"):
                return f"`{r}`"
            if isinstance(p.func, ast.Attribute) and \
                    p.func.attr in ARITH_METHODS:
                return f"`.{p.func.attr}()`"
        return None
