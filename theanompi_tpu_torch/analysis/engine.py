"""The lint's whole-program engine: the call graph and the thread roles.

One :class:`ProgramIndex` per run, over the files the run parsed:

* a **call graph** over every function and method in scope.  A module
  function resolves through the file's :class:`~.core.ImportResolver`
  (relative imports too); ``self.m``/``cls.m`` through the enclosing
  class, its ancestors and every subclass override; ``obj.m`` where
  ``obj`` was assigned from a constructor the index sees, where
  ``self.attr`` was, or where ``m`` is defined in exactly one class
  hierarchy in scope (the unique-family rule).  A callable passed as an
  argument is an edge too.
* **reachability** (:meth:`ProgramIndex.reachable`), the closure of that
  graph over a seed set.
* **thread roles**: every place concurrency starts — ``threading.Thread``
  and ``Timer`` targets, ``run`` of a ``Thread`` subclass, ``signal``
  handlers, ``atexit`` hooks, ``socketserver`` request handlers, and
  callables handed to an executor's ``submit`` or a future's
  ``add_done_callback`` (the port's pooled kernel-library loads and the
  prefetch producer's callbacks) — is a :class:`ThreadRole` whose members
  are the functions its entry reaches.  Everything else reachable from a
  function nothing calls is the ``main`` role.  A role's closure cuts the
  spawn edges: ``Thread(target=self._producer)`` hands the producer to a
  new thread and does not call it on this one.

* **summaries** (:class:`FuncSummary`, :meth:`ProgramIndex.summary`):
  what one body does directly — the collectives every rank of a group
  must issue, the point-to-point sends and receives (paired, not
  uniform), and the parameters it spends as seeds.  :meth:`ProgramIndex.transitive_summary` unions
  them over everything a function reaches; :meth:`~ProgramIndex.seed_params`
  and :meth:`~ProgramIndex.shaping_params` close a parameter fact over
  the call graph to a fixpoint.  The closures of this half also follow
  ``Function.apply`` of an ``autograd.Function`` into its ``forward`` and
  ``backward`` (the model-parallel layers' collectives).

Resolution is static (stdlib ``ast``): what would need type inference
resolves to nothing rather than to a guess, so a checker under-reports
rather than invents.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import (Dict, FrozenSet, Iterable, List, Optional, Sequence,
                    Set, Tuple)

from .core import ImportResolver, SourceFile

_FuncDef = (ast.FunctionDef, ast.AsyncFunctionDef)
_FuncLike = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)

ClassKey = Tuple[str, str]          # (module, ClassName)

#: The role of every function that runs on the thread that calls it.
MAIN_ROLE = "main"

# resolved callable -> (role kind, positional slot of the entry, keywords)
_SPAWN_CTORS = {
    "threading.Thread": ("thread", 1, ("target",)),
    "threading.Timer": ("timer", 1, ("function",)),
}
_SPAWN_REGISTRARS = {
    "signal.signal": ("signal", 1, ("handler",)),
    "atexit.register": ("atexit", 0, ()),
}
# methods on any receiver that hand a callable to another thread
_SPAWN_METHODS = {"submit": ("executor", 0), "add_done_callback": ("executor", 0)}
_NON_HANDLERS = {"signal.SIG_DFL", "signal.SIG_IGN", "signal.default_int_handler"}

#: Method names common on stdlib objects (threads, locks, sockets, files,
#: processes): the unique-family rule does not resolve them while closing
#: a role, or ``t.join()`` would pull the one in-scope class defining
#: ``join`` into the joining thread's role.
GENERIC_METHOD_NAMES = {
    "join", "start", "stop", "run", "close", "wait", "get", "put",
    "set", "clear", "pop", "read", "write", "flush", "send", "recv",
    "sendall", "accept", "connect", "acquire", "release", "poll",
    "kill", "terminate", "shutdown", "submit", "result", "cancel",
    "items", "keys", "values", "update", "copy", "append", "add",
    "remove", "beat",
}

#: Bases whose subclasses' ``run`` (threads) or ``handle`` (request
#: handlers) run on a thread of their own.
THREAD_BASES = ("threading.Thread", "threading.Timer")
HANDLER_BASES = ("socketserver.BaseRequestHandler",
                 "socketserver.StreamRequestHandler",
                 "socketserver.DatagramRequestHandler")


# ---------------------------------------------------------------------------
# the dataflow half's vocabulary (the checkers import these)
# ---------------------------------------------------------------------------

HOST_CLOCKS = {"time.time", "time.perf_counter", "time.monotonic",
               "time.process_time", "time.sleep", "time.time_ns",
               "time.perf_counter_ns", "time.monotonic_ns"}

#: Calls that read a device value back to the host or wait for the card:
#: a capture refuses them (or records nothing of them).
SYNC_CALLS = {"torch.cuda.synchronize", "torch.cuda.Stream.synchronize",
              "torch.cuda.Event.synchronize"}
#: Tensor (and stream or event) methods with the same effect, no argument.
SYNC_METHODS = {"item", "cpu", "tolist", "numpy", "synchronize"}

#: ``torch.distributed``'s collectives: every rank of the group issues
#: each one, in the same order.
COLLECTIVES = {"all_reduce", "all_gather", "all_gather_into_tensor",
               "reduce_scatter_tensor", "broadcast", "reduce",
               "all_to_all_single", "barrier", "all_to_all",
               "reduce_scatter", "gather", "scatter", "all_gather_object",
               "broadcast_object_list"}
#: A process group's own methods (the model-parallel layers call them on
#: ``base.Grid``'s groups): collectives too.
GROUP_COLLECTIVE_METHODS = {"allreduce", "allgather", "alltoall_base",
                            "alltoall", "reduce_scatter", "barrier",
                            "broadcast", "_allgather_base",
                            "_reduce_scatter_base", "allreduce_coalesced"}
#: Point-to-point: paired between two ranks, not uniform across them, so
#: no uniform-sequence check counts them.
P2P = {"send", "recv", "isend", "irecv", "batch_isend_irecv"}
_DIST = "torch.distributed."

#: Draws (functions): each takes ``generator=`` (a stateful
#: ``torch.Generator``), or draws from the process's global one.
DRAW_FUNCS = {"torch.rand", "torch.randn", "torch.randint", "torch.randperm",
              "torch.normal", "torch.bernoulli", "torch.multinomial",
              "torch.poisson", "torch.rand_like", "torch.randn_like",
              "torch.randint_like", "torch.dropout",
              "torch.nn.functional.dropout", "torch.nn.functional.dropout1d",
              "torch.nn.functional.dropout2d",
              "torch.nn.functional.dropout3d",
              "torch.nn.functional.alpha_dropout"}
#: Draws (tensor methods).
DRAW_METHODS = {"normal_", "uniform_", "bernoulli_", "random_",
                "exponential_", "geometric_", "cauchy_", "log_normal_"}
#: Seeding the process's global generators.
GLOBAL_SEEDS = {"torch.manual_seed", "torch.seed", "torch.cuda.manual_seed",
                "torch.cuda.manual_seed_all", "numpy.random.seed",
                "random.seed"}

#: Where a rank comes from: ``dist.get_rank()`` (and a group's
#: ``.rank()``), and the names and attributes conventionally holding it.
RANK_CALLS = {"torch.distributed.get_rank",
              "torch.distributed.get_node_local_rank"}
RANK_NAMES = {"rank", "local_rank", "world_rank"}

#: Dtypes the dtype-flow pass treats as low-precision wire formats.
LOW_PRECISION_DTYPES = {"bfloat16", "float16", "half", "float8_e4m3fn",
                        "float8_e5m2", "float8_e4m3fnuz", "float8_e5m2fnuz"}

#: Tensor attributes that are host metadata, never a device value: a
#: branch or a size over them is not a read of the card.
META_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda", "layout",
              "requires_grad"}
META_METHODS = {"size", "dim", "numel", "element_size", "stride",
                "data_ptr", "is_contiguous", "nelement"}

#: Calls whose size arguments shape what a capture records.
SHAPE_FUNCS = {"torch.zeros", "torch.ones", "torch.empty", "torch.full",
               "torch.arange", "torch.eye", "torch.randn", "torch.rand",
               "torch.randint", "torch.linspace", "numpy.arange",
               "numpy.zeros", "numpy.ones"}
#: Methods whose arguments are sizes on any receiver.
SHAPE_METHODS = {"reshape", "view", "expand", "repeat", "new_zeros",
                 "new_empty", "new_ones", "new_full", "narrow", "split",
                 "chunk", "unflatten"}

_AUTOGRAD_FUNCTION = "torch.autograd.Function"


def collective_name(resolved: Optional[str]) -> Optional[str]:
    """The simple name of a ``torch.distributed`` collective, or None."""
    if resolved and resolved.startswith(_DIST):
        simple = resolved[len(_DIST):]
        if simple in COLLECTIVES:
            return simple
    return None


def p2p_name(resolved: Optional[str]) -> Optional[str]:
    if resolved and resolved.startswith(_DIST):
        simple = resolved[len(_DIST):]
        if simple in P2P:
            return simple
    return None


def call_collective(call: ast.Call, resolver: ImportResolver
                    ) -> Optional[str]:
    """The collective one call issues: a ``torch.distributed`` function,
    or a process group's method (``group.allreduce([y], opts)``)."""
    resolved = resolver.resolve(call.func)
    name = collective_name(resolved)
    if name is not None:
        return name
    if resolved is None and isinstance(call.func, ast.Attribute) and \
            call.func.attr in GROUP_COLLECTIVE_METHODS:
        return call.func.attr
    return None


#: Receivers whose subscripts and ``.get`` reads are config knobs: the
#: dotted receiver's last segment.
CONFIG_RECEIVERS = {"config", "cfg"}


def config_knob(node: ast.AST) -> Optional[str]:
    """The knob of a config read (``config["x"]``, ``cfg.get("x", d)``,
    ``self.model.config.get("x")``), or None."""
    recv = key = None
    if isinstance(node, ast.Subscript):
        recv = node.value
        if isinstance(node.slice, ast.Constant) and \
                isinstance(node.slice.value, str):
            key = node.slice.value
    elif isinstance(node, ast.Call) and \
            isinstance(node.func, ast.Attribute) and \
            node.func.attr == "get" and node.args and \
            isinstance(node.args[0], ast.Constant) and \
            isinstance(node.args[0].value, str):
        recv, key = node.func.value, node.args[0].value
    dotted = ImportResolver.dotted(recv) if recv is not None else None
    if key is None or dotted is None:
        return None
    return key if dotted.rsplit(".", 1)[-1] in CONFIG_RECEIVERS else None


def has_generator(call: ast.Call) -> bool:
    return any(kw.arg == "generator" for kw in call.keywords)


def draw_name(call: ast.Call, resolver: ImportResolver) -> Optional[str]:
    """The draw one call makes (``torch.rand``, ``.normal_``), or None."""
    resolved = resolver.resolve(call.func)
    if resolved in DRAW_FUNCS:
        return resolved
    if resolved is None and isinstance(call.func, ast.Attribute) and \
            call.func.attr in DRAW_METHODS:
        return f".{call.func.attr}"
    return None


def sync_name(call: ast.Call, resolver: ImportResolver) -> Optional[str]:
    """The host sync one call makes: ``torch.cuda.synchronize``,
    ``.item()``, ``.cpu()``, ``.tolist()``, ``.numpy()``, a stream's or an
    event's ``.synchronize()``, ``.to("cpu")``."""
    resolved = resolver.resolve(call.func)
    if resolved in SYNC_CALLS:
        return f"{resolved}()"
    if resolved is None and isinstance(call.func, ast.Attribute):
        attr = call.func.attr
        if attr in SYNC_METHODS and not call.args and not call.keywords:
            return f".{attr}()"
        if attr == "to" and call.args and \
                isinstance(call.args[0], ast.Constant) and \
                call.args[0].value == "cpu":
            return '.to("cpu")'
    return None


def seed_call_arg(call: ast.Call, resolver: ImportResolver
                  ) -> Optional[ast.AST]:
    """The seed of a ``manual_seed`` call (a generator's or the global
    one's), or None."""
    if not isinstance(call.func, ast.Attribute) or \
            call.func.attr != "manual_seed":
        return None
    arg = call.args[0] if call.args else None
    for kw in call.keywords:
        if kw.arg == "seed":
            arg = kw.value
    return arg


def consumed_seed_name(call: ast.Call, resolver: ImportResolver
                       ) -> Optional[str]:
    """The Name a ``manual_seed(<name>)`` spends as a seed, or None: the
    counterpart of spending a JAX key.  A seed derived in the call
    (``step_seed(tag, seed, count)``) spends nothing, as ``fold_in``
    spends nothing."""
    arg = seed_call_arg(call, resolver)
    return arg.id if isinstance(arg, ast.Name) else None


def static_dtype(node: ast.AST, resolver: ImportResolver) -> Optional[str]:
    """The simple dtype name of a statically resolved dtype expression
    (``torch.bfloat16``, ``"bfloat16"``), else None."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    resolved = resolver.resolve(node)
    for mod in ("torch.", "numpy."):
        if resolved and resolved.startswith(mod):
            return resolved[len(mod):]
    return None


def bare_names(expr: ast.AST) -> List[ast.Name]:
    """Name loads in ``expr``, leaving out the bases of host-metadata
    chains (``x.shape[0]``, ``x.numel()``: the tensor's layout, fixed for
    the tensors a capture holds)."""
    out: List[ast.Name] = []

    def visit(n: ast.AST) -> None:
        if isinstance(n, ast.Attribute) and n.attr in META_ATTRS:
            return
        if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute) \
                and n.func.attr in META_METHODS:
            return
        if isinstance(n, ast.Name):
            out.append(n)
        for c in ast.iter_child_nodes(n):
            visit(c)

    visit(expr)
    return out


def shaping_slot_exprs(node: ast.AST, resolver: ImportResolver):
    """``(expr, slot)`` for each expression of ``node`` that shapes what a
    capture records: a Python branch's test, a loop's ``range`` bounds, a
    size argument, a slice bound."""
    out = []
    if isinstance(node, (ast.If, ast.While, ast.IfExp)):
        out.append((node.test, "a branch"))
    elif isinstance(node, ast.Call):
        resolved = resolver.resolve(node.func)
        if isinstance(node.func, ast.Name) and node.func.id == "range" and \
                resolved is None:
            out += [(a, "a loop count") for a in node.args]
        elif resolved in SHAPE_FUNCS:
            out += [(a, f"a size (`{resolved}`)") for a in node.args]
        elif resolved is None and isinstance(node.func, ast.Attribute) and \
                node.func.attr in SHAPE_METHODS:
            out += [(a, f"a size (`.{node.func.attr}`)") for a in node.args]
    elif isinstance(node, ast.Slice):
        out += [(b, "a slice bound") for b in (node.lower, node.upper,
                                               node.step) if b is not None]
    return out


@dataclass
class FuncSummary:
    """What one body does directly (not through its callees): the
    collectives it issues, its point-to-point calls, and the parameter
    positions it spends as seeds."""

    collectives: List[Tuple[ast.AST, str]] = field(default_factory=list)
    p2p: List[Tuple[ast.AST, str]] = field(default_factory=list)
    seed_params: Set[int] = field(default_factory=set)

    @property
    def issues_collective(self) -> bool:
        return bool(self.collectives)


@dataclass
class TransitiveSummary:
    issues_collective: bool = False
    collective_names: FrozenSet[str] = frozenset()
    issues_p2p: bool = False

@dataclass
class FuncRecord:
    """One function, method or lambda in scope."""

    sf: SourceFile
    node: ast.AST
    qualname: str                      # module.Class.method / module.func
    class_name: Optional[str] = None
    class_key: Optional[ClassKey] = None

    @property
    def name(self) -> str:
        return getattr(self.node, "name", "<lambda>")

    def params(self) -> List[str]:
        a = self.node.args
        return [p.arg for p in list(a.posonlyargs) + list(a.args)
                if p.arg not in ("self", "cls")]


@dataclass
class SpawnSite:
    """Where a concurrency entry point is introduced: a Thread or Timer
    construction, a handler registration, a submit, or a Thread-subclass
    or request-handler class."""

    sf: SourceFile
    node: ast.AST                 # the Call or the ClassDef
    kind: str                     # thread timer signal atexit executor
    #                               thread-subclass handler
    target_desc: str              # the entry expression as written
    entries: List[FuncRecord] = field(default_factory=list)

    @property
    def path(self) -> str:
        return self.sf.path

    @property
    def line(self) -> int:
        return getattr(self.node, "lineno", 1)


@dataclass
class ThreadRole:
    """A role: its name (``<kind>:<entry qualname>``), kind, the sites that
    start it and its entries."""

    name: str
    kind: str
    sites: List[SpawnSite] = field(default_factory=list)
    entries: List[FuncRecord] = field(default_factory=list)


class FileIndex:
    """Scopes of one file: defs by enclosing function, methods by name,
    classes, and the enclosing function of every node."""

    def __init__(self, sf: SourceFile):
        self.sf = sf
        self.by_scope: Dict[Optional[int], Dict[str, List[ast.AST]]] = {}
        self.methods: Dict[str, List[ast.AST]] = {}
        self.parent_func: Dict[int, Optional[ast.AST]] = {}
        self.enclosing: Dict[int, Optional[ast.AST]] = {}
        self.classes: Dict[str, ast.ClassDef] = {}
        self.class_of: Dict[int, ast.ClassDef] = {}
        self._walk(sf.tree, None, None)
        self._record_enclosing(sf.tree, None)

    def _walk(self, node, func, cls) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, _FuncDef):
                self.by_scope.setdefault(id(func) if func else None, {}) \
                    .setdefault(child.name, []).append(child)
                if cls is not None and isinstance(node, ast.ClassDef):
                    self.methods.setdefault(child.name, []).append(child)
                    self.class_of[id(child)] = cls
                self.parent_func[id(child)] = func
                self._walk(child, child, None)
            elif isinstance(child, ast.ClassDef):
                self.classes.setdefault(child.name, child)
                self._walk(child, func, child)
            elif isinstance(child, ast.Lambda):
                self.parent_func[id(child)] = func
                self._walk(child, child, None)
            else:
                self._walk(child, func, cls)

    def _record_enclosing(self, node, func) -> None:
        self.enclosing[id(node)] = func
        for child in ast.iter_child_nodes(node):
            self._record_enclosing(
                child, child if isinstance(child, _FuncLike) else func)

    def lookup(self, name: str, from_func: Optional[ast.AST]) -> List[ast.AST]:
        """Defs of ``name`` visible from ``from_func``: its locals, then the
        enclosing functions', then the module's."""
        f = from_func
        while True:
            scope = self.by_scope.get(id(f) if f else None, {})
            if name in scope:
                return list(scope[name])
            if f is None:
                return []
            f = self.parent_func.get(id(f))

    def owner_class(self, func: Optional[ast.AST]) -> Optional[ast.ClassDef]:
        """The class whose method encloses ``func`` (through nested defs)."""
        while func is not None:
            cls = self.class_of.get(id(func))
            if cls is not None:
                return cls
            func = self.parent_func.get(id(func))
        return None


class ProgramIndex:
    """The call graph and thread roles over a list of parsed files."""

    def __init__(self, files: Sequence[SourceFile]):
        self.files = list(files)
        self.by_path: Dict[str, SourceFile] = {sf.path: sf for sf in files}
        self.file_index: Dict[str, FileIndex] = {sf.path: FileIndex(sf)
                                                 for sf in files}
        self.by_qualname: Dict[str, List[FuncRecord]] = {}
        self.methods: Dict[str, List[FuncRecord]] = {}
        self.records: Dict[int, FuncRecord] = {}      # id(node) -> record
        self.class_bases: Dict[ClassKey, List[str]] = {}
        self._class_keys: Dict[str, ClassKey] = {}    # dotted class -> key
        self._module_constants: Dict[str, object] = {}
        for sf in files:
            self._index_file(sf)
        self._subclasses = self._compute_subclasses()
        self._callees: Dict[int, List[FuncRecord]] = {}
        self._role_callees_cache: Dict[int, List[FuncRecord]] = {}
        self._attr_ctors: Dict[ClassKey, Dict[str, str]] = {}
        self._spawn_sites: Optional[List[SpawnSite]] = None
        self._spawn_arg_ids: Set[int] = set()
        self._thread_roles: Optional[List[ThreadRole]] = None
        self._role_map: Optional[Dict[int, Set[str]]] = None
        self._df_callees: Dict[int, List[FuncRecord]] = {}
        self._bodies: Dict[int, List[ast.AST]] = {}
        self._ctor_cache: Dict[int, Dict[str, ClassKey]] = {}
        self._attr_class_cache: Dict[ClassKey, Dict[str, ClassKey]] = {}
        self._data_attrs: Optional[Set[str]] = None
        self._summary_cache: Dict[int, FuncSummary] = {}
        self._transitive_cache: Dict[int, TransitiveSummary] = {}
        self._seed_params_cache: Optional[Dict[int, Set[int]]] = None
        self._shaping_params_cache: Optional[Dict[int, Set[int]]] = None

    # -- construction --------------------------------------------------------

    def _index_file(self, sf: SourceFile) -> None:
        module = sf.resolver.module
        idx = self.file_index[sf.path]
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.Lambda):
                # unnamed: indexed so a lambda entry still has callees
                self.records[id(node)] = FuncRecord(
                    sf, node, f"{module}.<lambda>:{node.lineno}")
                continue
            if not isinstance(node, _FuncDef):
                continue
            cls = idx.class_of.get(id(node))
            if cls is not None:
                rec = FuncRecord(sf, node, f"{module}.{cls.name}.{node.name}",
                                 cls.name, (module, cls.name))
                self.methods.setdefault(node.name, []).append(rec)
            elif idx.parent_func.get(id(node)) is None:
                rec = FuncRecord(sf, node, f"{module}.{node.name}")
            else:
                rec = FuncRecord(sf, node, f"{module}.<locals>.{node.name}")
            self.records[id(node)] = rec
            self.by_qualname.setdefault(rec.qualname, []).append(rec)
        for name, cls in idx.classes.items():
            self._class_keys[f"{module}.{name}"] = (module, name)
            bases = []
            for b in cls.bases:
                resolved = sf.resolver.resolve(b)
                if resolved is None and isinstance(b, ast.Name) and \
                        b.id in idx.classes:
                    resolved = f"{module}.{b.id}"       # same-file base
                if resolved:
                    bases.append(resolved)
            self.class_bases[(module, name)] = bases
        # module-level constants: strings and tuples of constants (the
        # event vocabularies the protocol checkers read)
        for st in sf.tree.body:
            if not isinstance(st, ast.Assign):
                continue
            if isinstance(st.value, ast.Constant):
                value = st.value.value
            elif isinstance(st.value, (ast.Tuple, ast.List)) and \
                    all(isinstance(e, ast.Constant) for e in st.value.elts):
                value = tuple(e.value for e in st.value.elts)
            else:
                continue
            if value is None:
                continue
            for t in st.targets:
                if isinstance(t, ast.Name):
                    self._module_constants[f"{module}.{t.id}"] = value

    def _compute_subclasses(self) -> Dict[ClassKey, Set[ClassKey]]:
        """Transitive subclasses of every class, to a fixpoint (cycles
        cannot recurse)."""
        out: Dict[ClassKey, Set[ClassKey]] = {k: set() for k in self.class_bases}
        for key, bases in self.class_bases.items():
            for b in bases:
                bkey = self._class_keys.get(b)
                if bkey is not None:
                    out[bkey].add(key)
        changed = True
        while changed:
            changed = False
            for key, subs in out.items():
                grown = set(subs)
                for s in subs:
                    grown |= out.get(s, set())
                if grown != subs:
                    out[key] = grown
                    changed = True
        return out

    # -- classes --------------------------------------------------------------

    def module_constant(self, dotted: str):
        """The literal value of a module-level constant, or None."""
        return self._module_constants.get(dotted)

    def class_key(self, dotted_class: str) -> Optional[ClassKey]:
        return self._class_keys.get(dotted_class)

    def subclasses_of(self, dotted_class: str) -> List[ClassKey]:
        key = self._class_keys.get(dotted_class)
        if key is None:
            return []
        return sorted(self._subclasses.get(key, set()) | {key})

    def hierarchy_root(self, key: ClassKey) -> ClassKey:
        """The topmost in-scope ancestor (first in-scope base each step)."""
        seen = set()
        while key not in seen:
            seen.add(key)
            parent = next((self._class_keys[b]
                           for b in self.class_bases.get(key, [])
                           if b in self._class_keys), None)
            if parent is None:
                return key
            key = parent
        return key

    def method_records(self, class_key: ClassKey, name: str,
                       include_subclasses: bool = True) -> List[FuncRecord]:
        """``name`` on the class, its in-scope ancestors and (by default)
        every subclass override; a sibling's override is not reachable
        through this receiver."""
        keys = {class_key}
        frontier = [class_key]
        while frontier:
            for b in self.class_bases.get(frontier.pop(), []):
                bk = self._class_keys.get(b)
                if bk is not None and bk not in keys:
                    keys.add(bk)
                    frontier.append(bk)
        if include_subclasses:
            keys |= self._subclasses.get(class_key, set())
        out: List[FuncRecord] = []
        for k in keys:
            out.extend(self.by_qualname.get(f"{k[0]}.{k[1]}.{name}", []))
        return out

    def class_attr_ctors(self, class_key: ClassKey) -> Dict[str, str]:
        """``self.X = <call>`` anywhere in the class's own methods: attr ->
        the constructor's dotted path (first assignment wins).  It tells a
        ``threading.Lock`` from an ``RLock``, a queue from a list, and which
        class ``self.center`` is."""
        cached = self._attr_ctors.get(class_key)
        if cached is not None:
            return cached
        out: Dict[str, str] = {}
        module = class_key[0]
        for recs in self.methods.values():
            for rec in recs:
                if rec.class_key != class_key:
                    continue
                for sub in self.body(rec.node):
                    if not isinstance(sub, (ast.Assign, ast.AnnAssign)) or \
                            not isinstance(sub.value, ast.Call):
                        continue
                    fn = sub.value.func
                    resolved = rec.sf.resolver.resolve(fn)
                    if resolved is None and isinstance(fn, ast.Name) and \
                            fn.id in self.file_index[rec.sf.path].classes:
                        resolved = f"{module}.{fn.id}"
                    if resolved is None:
                        continue
                    targets = sub.targets if isinstance(sub, ast.Assign) \
                        else [sub.target]
                    for t in targets:
                        if isinstance(t, ast.Attribute) and \
                                isinstance(t.value, ast.Name) and \
                                t.value.id == "self":
                            out.setdefault(t.attr, resolved)
        self._attr_ctors[class_key] = out
        return out

    # -- call resolution -------------------------------------------------------

    def _unique_family(self, name: str) -> List[FuncRecord]:
        """Every method ``name`` when all belong to one class hierarchy;
        nothing for names several hierarchies define."""
        recs = self.methods.get(name, [])
        roots = {self.hierarchy_root(r.class_key) for r in recs
                 if r.class_key is not None}
        return list(recs) if len(roots) == 1 else []

    def local_ctor_types(self, rec: FuncRecord) -> Dict[str, ClassKey]:
        """Locals assigned from a constructor the index sees:
        ``exch = BSP_Exchanger(cfg)`` -> that class (cached)."""
        cached = self._ctor_cache.get(id(rec.node))
        if cached is not None:
            return cached
        out: Dict[str, ClassKey] = {}
        self._ctor_cache[id(rec.node)] = out
        classes = self.file_index[rec.sf.path].classes
        for sub in self.body(rec.node):
            if not isinstance(sub, ast.Assign) or \
                    not isinstance(sub.value, ast.Call):
                continue
            fn = sub.value.func
            if isinstance(fn, ast.Name) and fn.id in classes:
                key = (rec.sf.resolver.module, fn.id)
            else:
                key = self._class_keys.get(rec.sf.resolver.resolve(fn) or "")
            if key is None:
                continue
            for t in sub.targets:
                if isinstance(t, ast.Name):
                    out[t.id] = key
        return out

    def resolve_call(self, sf: SourceFile, func_expr: ast.AST,
                     enclosing: Optional[ast.AST],
                     ctor_types: Optional[Dict[str, ClassKey]] = None,
                     skip_generic_unique: bool = False) -> List[FuncRecord]:
        """The possible targets of a call through ``func_expr``.
        ``skip_generic_unique`` withholds the unique-family rule for
        :data:`GENERIC_METHOD_NAMES` (role closures)."""
        idx = self.file_index[sf.path]
        if isinstance(func_expr, ast.Name):
            local = idx.lookup(func_expr.id, enclosing)
            if local:
                return [self.records[id(n)] for n in local if id(n) in self.records]
            resolved = sf.resolver.resolve(func_expr)
            return list(self.by_qualname.get(resolved, [])) if resolved else []
        if not isinstance(func_expr, ast.Attribute):
            return []
        base = func_expr.value
        if isinstance(base, ast.Name) and base.id in ("self", "cls"):
            cls = idx.owner_class(enclosing)
            if cls is not None:
                recs = self.method_records((sf.resolver.module, cls.name),
                                           func_expr.attr)
                if recs:
                    return recs
            # self.m outside an indexed class: same-file methods by name
            return [self.records[id(n)]
                    for n in idx.methods.get(func_expr.attr, [])
                    if id(n) in self.records]
        resolved = sf.resolver.resolve(func_expr)
        if resolved and resolved in self.by_qualname:
            return list(self.by_qualname[resolved])
        if isinstance(base, ast.Name) and ctor_types and base.id in ctor_types:
            return self.method_records(ctor_types[base.id], func_expr.attr)
        if isinstance(base, ast.Attribute) and isinstance(base.value, ast.Name) \
                and base.value.id in ("self", "cls"):
            cls = idx.owner_class(enclosing)
            if cls is not None:
                ctor = self.class_attr_ctors(
                    (sf.resolver.module, cls.name)).get(base.attr)
                key = self._class_keys.get(ctor or "")
                if key is not None:
                    return self.method_records(key, func_expr.attr)
        if resolved is not None:
            # a function of an imported module the run does not hold
            # (``hashlib.sha256``): no method of the tree's classes
            return []
        if skip_generic_unique and func_expr.attr in GENERIC_METHOD_NAMES:
            return []
        return self._unique_family(func_expr.attr)

    def _edges(self, rec: FuncRecord, skip: Set[int],
               skip_generic_unique: bool) -> List[FuncRecord]:
        """Targets of the calls in ``rec``'s body and of the callables it
        passes as arguments (those whose node id is not in ``skip``)."""
        idx = self.file_index[rec.sf.path]
        ctor_types = self.local_ctor_types(rec)
        out: List[FuncRecord] = []
        seen: Set[int] = set()

        def add(targets: Iterable[FuncRecord]) -> None:
            for t in targets:
                if id(t.node) not in seen and t.node is not rec.node:
                    seen.add(id(t.node))
                    out.append(t)

        for sub in self.body(rec.node):
            if not isinstance(sub, ast.Call):
                continue
            add(self.resolve_call(rec.sf, sub.func,
                                  idx.enclosing.get(id(sub.func), rec.node),
                                  ctor_types, skip_generic_unique))
            for arg in list(sub.args) + [kw.value for kw in sub.keywords]:
                if id(arg) not in skip and \
                        isinstance(arg, (ast.Name, ast.Attribute)):
                    add(self.resolve_call(rec.sf, arg,
                                          idx.enclosing.get(id(arg), rec.node),
                                          ctor_types, skip_generic_unique))
        return out

    def callees(self, rec: FuncRecord) -> List[FuncRecord]:
        """Direct targets of one body (nested defs are reached when
        called)."""
        cached = self._callees.get(id(rec.node))
        if cached is None:
            cached = self._callees[id(rec.node)] = self._edges(rec, set(), False)
        return cached

    def reachable(self, seeds: Iterable[FuncRecord]) -> List[FuncRecord]:
        """The closure of :meth:`callees` over ``seeds`` (seeds included)."""
        return _closure(seeds, self.callees)

    def record_for(self, node: ast.AST) -> Optional[FuncRecord]:
        return self.records.get(id(node))

    # -- thread roles ------------------------------------------------------------

    def resolve_callable(self, sf: SourceFile, expr: ast.AST,
                         enclosing: Optional[ast.AST], ctor_types=None,
                         _seen_names: Optional[Set[str]] = None
                         ) -> List[FuncRecord]:
        """Targets of a callable-valued expression: :meth:`resolve_call`,
        an inline lambda, or a local name bound by an assignment or by a
        ``for`` over a literal tuple of callables (the proxy's pump pair).
        A cyclic rebind (``a = b; b = a``) resolves to nothing."""
        if isinstance(expr, ast.Lambda):
            rec = self.records.get(id(expr))
            return [rec] if rec is not None else []
        out = self.resolve_call(sf, expr, enclosing, ctor_types)
        if out or not isinstance(expr, ast.Name) or enclosing is None:
            return out
        seen_names = set(_seen_names or ())
        if expr.id in seen_names:
            return []
        seen_names.add(expr.id)
        found: List[FuncRecord] = []
        for sub in body_walk(enclosing):
            exprs: List[ast.AST] = []
            if isinstance(sub, ast.Assign) and any(
                    isinstance(t, ast.Name) and t.id == expr.id
                    for t in sub.targets):
                exprs = [sub.value]
            elif isinstance(sub, ast.For) and isinstance(sub.target, ast.Name) \
                    and sub.target.id == expr.id and \
                    isinstance(sub.iter, (ast.Tuple, ast.List)):
                exprs = list(sub.iter.elts)
            for e in exprs:
                if isinstance(e, (ast.Tuple, ast.List)):
                    exprs.extend(e.elts)
                else:
                    found.extend(self.resolve_callable(
                        sf, e, enclosing, ctor_types, _seen_names=seen_names))
        seen: Set[int] = set()
        return [r for r in found
                if id(r.node) not in seen and not seen.add(id(r.node))]

    def _inherits(self, class_key: ClassKey, dotted_bases) -> bool:
        seen = set()
        frontier = [class_key]
        while frontier:
            k = frontier.pop()
            if k in seen:
                continue
            seen.add(k)
            for b in self.class_bases.get(k, []):
                if b in dotted_bases:
                    return True
                bk = self._class_keys.get(b)
                if bk is not None:
                    frontier.append(bk)
        return False

    def is_thread_subclass(self, class_key: ClassKey) -> bool:
        return self._inherits(class_key, THREAD_BASES)

    def _own_methods(self, key: ClassKey, names) -> List[FuncRecord]:
        return [r for n in names
                for r in self.method_records(key, n, include_subclasses=False)
                if r.class_key == key]

    def spawn_sites(self) -> List[SpawnSite]:
        """Every concurrency entry point in scope (cached)."""
        if self._spawn_sites is not None:
            return self._spawn_sites
        sites: List[SpawnSite] = []
        for sf in self.files:
            idx = self.file_index[sf.path]
            for node in ast.walk(sf.tree):
                if isinstance(node, ast.ClassDef):
                    key = (sf.resolver.module, node.name)
                    if self.is_thread_subclass(key):
                        recs = self._own_methods(key, ("run",))
                        if recs:
                            sites.append(SpawnSite(sf, node, "thread-subclass",
                                                   f"{node.name}.run", recs))
                    elif self._inherits(key, HANDLER_BASES):
                        recs = self._own_methods(key, ("handle", "setup",
                                                       "finish"))
                        if recs:
                            sites.append(SpawnSite(sf, node, "handler",
                                                   f"{node.name}.handle", recs))
                    continue
                if not isinstance(node, ast.Call):
                    continue
                resolved = sf.resolver.resolve(node.func)
                if resolved in _SPAWN_CTORS:
                    kind, pos, kwnames = _SPAWN_CTORS[resolved]
                elif resolved in _SPAWN_REGISTRARS:
                    kind, pos, kwnames = _SPAWN_REGISTRARS[resolved]
                elif isinstance(node.func, ast.Attribute) and \
                        node.func.attr in _SPAWN_METHODS:
                    kind, pos = _SPAWN_METHODS[node.func.attr]
                    kwnames = ("fn",)
                else:
                    continue
                expr = node.args[pos] if len(node.args) > pos else None
                for kw in node.keywords:
                    if kw.arg in kwnames:
                        expr = kw.value
                if expr is None:
                    continue
                if kind == "signal" and sf.resolver.resolve(expr) in _NON_HANDLERS:
                    continue
                enc = idx.enclosing.get(id(expr))
                enc_rec = self.records.get(id(enc)) if enc is not None else None
                ctor_types = self.local_ctor_types(enc_rec) \
                    if enc_rec is not None else None
                entries = self.resolve_callable(sf, expr, enc, ctor_types)
                desc = ImportResolver.dotted(expr) or (
                    "<lambda>" if isinstance(expr, ast.Lambda)
                    else ast.dump(expr)[:40])
                sites.append(SpawnSite(sf, node, kind, desc, entries))
                self._spawn_arg_ids.add(id(expr))
        self._spawn_sites = sites
        return sites

    def _role_callees(self, rec: FuncRecord) -> List[FuncRecord]:
        """:meth:`callees` with the spawn edges cut and generic method
        names left unresolved."""
        cached = self._role_callees_cache.get(id(rec.node))
        if cached is None:
            self.spawn_sites()
            cached = self._role_callees_cache[id(rec.node)] = self._edges(
                rec, self._spawn_arg_ids, True)
        return cached

    def thread_roles(self) -> List[ThreadRole]:
        """One role per distinct ``<kind>:<first entry>``, sorted by name."""
        if self._thread_roles is not None:
            return self._thread_roles
        by_name: Dict[str, ThreadRole] = {}
        for site in self.spawn_sites():
            name = f"{site.kind}:{site.entries[0].qualname}" if site.entries \
                else f"{site.kind}:{site.sf.path}:{site.line}"
            role = by_name.setdefault(name, ThreadRole(name, site.kind))
            role.sites.append(site)
            known = {id(e.node) for e in role.entries}
            role.entries.extend(e for e in site.entries if id(e.node) not in known)
        self._thread_roles = [by_name[n] for n in sorted(by_name)]
        return self._thread_roles

    def role_members(self, role: ThreadRole) -> List[FuncRecord]:
        return _closure(role.entries, self._role_callees)

    def role_map(self) -> Dict[int, Set[str]]:
        """Function node id -> the roles it can run under.

        ``main`` is seeded by the functions nothing references (the public
        surface: CLI mains, methods reached through receivers the index
        cannot type, constructors) other than role entries, so a helper
        only a thread entry reaches stays out of ``main``.  The bias is to
        miss a conflict, never to invent one."""
        if self._role_map is not None:
            return self._role_map
        out: Dict[int, Set[str]] = {}
        entry_ids: Set[int] = set()
        for role in self.thread_roles():
            for rec in self.role_members(role):
                out.setdefault(id(rec.node), set()).add(role.name)
            entry_ids.update(id(e.node) for e in role.entries)
        referenced = {id(c.node) for rec in self.records.values()
                      for c in self._role_callees(rec)}
        seeds = [rec for rec in self.records.values()
                 if not isinstance(rec.node, ast.Lambda)
                 and id(rec.node) not in entry_ids
                 and id(rec.node) not in referenced
                 and self.file_index[rec.sf.path].parent_func.get(
                     id(rec.node)) is None]
        for rec in _closure(seeds, self._role_callees):
            out.setdefault(id(rec.node), set()).add(MAIN_ROLE)
        for rec in self.records.values():
            out.setdefault(id(rec.node), {MAIN_ROLE})
        self._role_map = out
        return out

    def roles_of(self, rec: FuncRecord) -> Set[str]:
        return self.role_map().get(id(rec.node), {MAIN_ROLE})


    # -- the dataflow half: summaries -----------------------------------------

    def body(self, fn: ast.AST) -> List[ast.AST]:
        """:func:`body_walk` of a function of the run, as a list (cached:
        the dataflow passes walk each body many times)."""
        out = self._bodies.get(id(fn))
        if out is None:
            out = self._bodies[id(fn)] = list(body_walk(fn))
        return out

    def function_class(self, sf: SourceFile, expr: ast.AST
                       ) -> Optional[ClassKey]:
        """The in-scope class an expression names (same file or
        imported), or None."""
        if isinstance(expr, ast.Name) and \
                expr.id in self.file_index[sf.path].classes:
            return (sf.resolver.module, expr.id)
        return self._class_keys.get(sf.resolver.resolve(expr) or "")

    def is_autograd_function(self, key: ClassKey) -> bool:
        return self._inherits(key, (_AUTOGRAD_FUNCTION,))

    def resolve_df_call(self, sf: SourceFile, func_expr: ast.AST,
                        enclosing: Optional[ast.AST],
                        ctor_types=None,
                        skip_generic_unique: bool = False
                        ) -> List[FuncRecord]:
        """:meth:`resolve_call`, plus ``F.apply`` of an in-scope
        ``autograd.Function`` resolved to its ``forward`` and
        ``backward``."""
        if isinstance(func_expr, ast.Attribute) and \
                func_expr.attr == "apply":
            key = self.function_class(sf, func_expr.value)
            if key is not None and self.is_autograd_function(key):
                return self.method_records(key, "forward", False) + \
                    self.method_records(key, "backward", False)
        out = self.resolve_call(sf, func_expr, enclosing, ctor_types,
                                skip_generic_unique)
        if not out and isinstance(func_expr, ast.Attribute) and \
                isinstance(func_expr.value, ast.Name) and \
                func_expr.value.id == "self":
            # a callable object held by the instance: its class's __call__
            cls = self.file_index[sf.path].owner_class(enclosing)
            if cls is not None:
                key = self.attr_classes((sf.resolver.module, cls.name)).get(
                    func_expr.attr)
                if key is not None:
                    out = self.method_records(key, "__call__")
        return out

    def attr_classes(self, class_key: ClassKey) -> Dict[str, ClassKey]:
        """``self.X`` of a class (and its in-scope ancestors) -> the
        in-scope class it holds: from its constructor, or from its
        annotation (``self.strategy: Strategy = get_strategy(...)``)."""
        cached = self._attr_class_cache.get(class_key)
        if cached is not None:
            return cached
        out: Dict[str, ClassKey] = {}
        self._attr_class_cache[class_key] = out
        keys = [class_key]
        for k in keys:
            for b in self.class_bases.get(k, []):
                bk = self._class_keys.get(b)
                if bk is not None and bk not in keys:
                    keys.append(bk)
        for k in keys:
            for attr, ctor in self.class_attr_ctors(k).items():
                ck = self._class_keys.get(ctor)
                if ck is not None:
                    out.setdefault(attr, ck)
            for recs in self.methods.values():
                for rec in recs:
                    if rec.class_key != k:
                        continue
                    for sub in self.body(rec.node):
                        if isinstance(sub, ast.AnnAssign) and \
                                isinstance(sub.target, ast.Attribute) and \
                                isinstance(sub.target.value, ast.Name) and \
                                sub.target.value.id == "self":
                            ck = self.function_class(rec.sf, sub.annotation)
                            if ck is not None:
                                out.setdefault(sub.target.attr, ck)
        return out

    def df_callees(self, rec: FuncRecord) -> List[FuncRecord]:
        """The dataflow half's edges: the targets of the calls in
        ``rec``'s body (the unique-family rule withheld for
        :data:`GENERIC_METHOD_NAMES`; ``autograd.Function.apply`` and the
        callable objects an instance holds resolved), and the functions
        it passes as arguments where they name one for certain (a def in
        scope, an import, a ``self`` method) — a data attribute passed
        along is no edge."""
        cached = self._df_callees.get(id(rec.node))
        if cached is not None:
            return cached
        out: List[FuncRecord] = []
        seen: Set[int] = set()
        idx = self.file_index[rec.sf.path]
        ctor_types = self.local_ctor_types(rec)

        def add(targets):
            for t in targets:
                if id(t.node) not in seen and t.node is not rec.node:
                    seen.add(id(t.node))
                    out.append(t)

        for sub in self.body(rec.node):
            if not isinstance(sub, ast.Call):
                continue
            enc = idx.enclosing.get(id(sub.func), rec.node)
            add(self.resolve_df_call(rec.sf, sub.func, enc, ctor_types,
                                     skip_generic_unique=True))
            for arg in list(sub.args) + [kw.value for kw in sub.keywords]:
                if isinstance(arg, ast.Lambda):
                    add([self.records[id(arg)]] if id(arg) in self.records
                        else [])
                elif isinstance(arg, ast.Name) or (
                        isinstance(arg, ast.Attribute) and
                        isinstance(arg.value, ast.Name) and
                        arg.value.id in ("self", "cls")):
                    add(self.resolve_call(
                        rec.sf, arg, idx.enclosing.get(id(arg), rec.node),
                        ctor_types, skip_generic_unique=True))
                elif isinstance(arg, ast.Attribute) and \
                        rec.sf.resolver.resolve(arg) in self.by_qualname:
                    add(self.by_qualname[rec.sf.resolver.resolve(arg)])
                elif isinstance(arg, ast.Attribute) and \
                        arg.attr not in self.data_attrs():
                    # ``m.loss_and_metrics``: a method no object holds as
                    # data, of one class family
                    add(self.resolve_call(
                        rec.sf, arg, idx.enclosing.get(id(arg), rec.node),
                        ctor_types, skip_generic_unique=True))
        self._df_callees[id(rec.node)] = out
        return out

    def data_attrs(self) -> Set[str]:
        """Attribute names some object is assigned (``x.params = ...``):
        a method of the same name elsewhere is no evidence of an edge."""
        if self._data_attrs is None:
            self._data_attrs = {
                t.attr for sf in self.files for n in sf.nodes
                if isinstance(n, (ast.Assign, ast.AnnAssign, ast.AugAssign))
                for t in (n.targets if isinstance(n, ast.Assign)
                          else [n.target])
                if isinstance(t, ast.Attribute)}
        return self._data_attrs

    def df_reachable(self, seeds: Iterable[FuncRecord]) -> List[FuncRecord]:
        """The closure of :meth:`df_callees` over ``seeds``."""
        return _closure(seeds, self.df_callees)

    def summary(self, rec: FuncRecord) -> FuncSummary:
        """Direct facts about one body (cached)."""
        cached = self._summary_cache.get(id(rec.node))
        if cached is not None:
            return cached
        s = FuncSummary()
        resolver = rec.sf.resolver
        params = rec.params()
        for sub in self.body(rec.node):
            if not isinstance(sub, ast.Call):
                continue
            cname = call_collective(sub, resolver)
            if cname is not None:
                s.collectives.append((sub, cname))
            pname = p2p_name(resolver.resolve(sub.func))
            if pname is not None:
                s.p2p.append((sub, pname))
            sn = consumed_seed_name(sub, resolver)
            if sn is not None and sn in params:
                s.seed_params.add(params.index(sn))
        self._summary_cache[id(rec.node)] = s
        return s

    def _param_fixpoint(self, direct: Dict[int, Set[int]], arg_ok
                        ) -> Dict[int, Set[int]]:
        """Close a per-parameter fact over the call graph: a parameter
        passed at a callee's marked position is marked too.  ``arg_ok``
        maps the argument expression to the caller's parameter names it
        carries."""
        out = {k: set(v) for k, v in direct.items()}
        calls = {id(r.node): [c for c in self.body(r.node)
                              if isinstance(c, ast.Call)]
                 for r in self.records.values() if r.params()}
        changed = True
        while changed:
            changed = False
            # only a call of a marked function's name can mark its caller
            names = {self.records[i].name for i in out if i in self.records}
            for rec in self.records.values():
                params = rec.params()
                if not params:
                    continue
                idx = self.file_index[rec.sf.path]
                ctor_types = None
                for sub in calls[id(rec.node)]:
                    f = sub.func
                    simple = f.attr if isinstance(f, ast.Attribute) else \
                        getattr(f, "id", None)
                    if simple not in names and not (
                            isinstance(f, ast.Attribute) and (
                                "__call__" in names or (
                                    simple == "apply" and
                                    names & {"forward", "backward"}))):
                        continue
                    if ctor_types is None:
                        ctor_types = self.local_ctor_types(rec)
                    enc = idx.enclosing.get(id(sub.func), rec.node)
                    for tgt in self.resolve_df_call(rec.sf, sub.func, enc,
                                                    ctor_types):
                        marked = out.get(id(tgt.node))
                        if not marked:
                            continue
                        for arg in _args_at(sub, tgt, marked):
                            for name in arg_ok(arg):
                                if name in params:
                                    j = params.index(name)
                                    cur = out.setdefault(id(rec.node), set())
                                    if j not in cur:
                                        cur.add(j)
                                        changed = True
        return out

    def seed_params(self, rec: FuncRecord) -> Set[int]:
        """Parameter positions this function spends as seeds
        (``manual_seed(p)``), directly or through a callee (fixpoint)."""
        if self._seed_params_cache is None:
            direct = {id(r.node): set(self.summary(r).seed_params)
                      for r in self.records.values()
                      if self.summary(r).seed_params}
            self._seed_params_cache = self._param_fixpoint(
                direct, lambda a: [a.id] if isinstance(a, ast.Name) else [])
        return self._seed_params_cache.get(id(rec.node), set())

    def shaping_params(self, rec: FuncRecord) -> Set[int]:
        """Parameter positions this function spends where they shape what
        a capture records (a branch, a loop count, a size, a slice bound),
        directly or through a callee (fixpoint)."""
        if self._shaping_params_cache is None:
            direct: Dict[int, Set[int]] = {}
            for r in self.records.values():
                params = r.params()
                if not params:
                    continue
                hit = set()
                for sub in self.body(r.node):
                    for expr, _why in shaping_slot_exprs(sub, r.sf.resolver):
                        hit.update(params.index(n.id) for n in bare_names(expr)
                                   if n.id in params)
                if hit:
                    direct[id(r.node)] = hit
            self._shaping_params_cache = self._param_fixpoint(
                direct, lambda a: [n.id for n in bare_names(a)])
        return self._shaping_params_cache.get(id(rec.node), set())

    def shaping_use_sites(self, rec: FuncRecord):
        """``(expr, why)`` for each expression of ``rec``'s body that shapes
        what a capture records: the direct slots, and the arguments it
        passes where a callee spends them so."""
        idx = self.file_index[rec.sf.path]
        ctor_types = None
        out = []
        for sub in self.body(rec.node):
            out.extend(shaping_slot_exprs(sub, rec.sf.resolver))
            if not isinstance(sub, ast.Call):
                continue
            if ctor_types is None:
                ctor_types = self.local_ctor_types(rec)
            enc = idx.enclosing.get(id(sub.func), rec.node)
            for tgt in self.resolve_df_call(rec.sf, sub.func, enc,
                                            ctor_types):
                sp = self.shaping_params(tgt)
                out.extend((arg, f"`{tgt.name}` spends it")
                           for arg in _args_at(sub, tgt, sp))
        return out

    def transitive_summary(self, rec: FuncRecord) -> TransitiveSummary:
        """:meth:`summary` unioned over everything ``rec`` reaches (with
        the ``autograd.Function`` edges; cached)."""
        cached = self._transitive_cache.get(id(rec.node))
        if cached is not None:
            return cached
        t = TransitiveSummary()
        names: Set[str] = set()
        for r in self.df_reachable([rec]):
            s = self.summary(r)
            t.issues_collective = t.issues_collective or s.issues_collective
            t.issues_p2p = t.issues_p2p or bool(s.p2p)
            names.update(n for _, n in s.collectives)
        t.collective_names = frozenset(names)
        self._transitive_cache[id(rec.node)] = t
        return t

def _closure(seeds: Iterable[FuncRecord], step) -> List[FuncRecord]:
    out: List[FuncRecord] = []
    seen: Set[int] = set()
    frontier = list(seeds)
    while frontier:
        rec = frontier.pop()
        if id(rec.node) in seen:
            continue
        seen.add(id(rec.node))
        out.append(rec)
        frontier.extend(step(rec))
    return out


def body_walk(fn: ast.AST):
    """The nodes of a function's body, not descending into nested defs
    (reached separately when called) but into inline lambdas."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        if isinstance(node, _FuncDef):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def _args_at(call: ast.Call, tgt: FuncRecord, positions) -> List[ast.AST]:
    """The arguments of ``call`` at ``tgt``'s parameter ``positions``
    (positional or by keyword), in position order; missing ones left
    out."""
    tparams = tgt.params()
    # a method called through its class (``C.m(self, x)``) is not told
    # apart: positions count after ``self`` either way
    out = []
    for i in sorted(positions):
        arg = call.args[i] if i < len(call.args) else None
        for kw in call.keywords:
            if i < len(tparams) and kw.arg == tparams[i]:
                arg = kw.value
        if arg is not None and not isinstance(arg, ast.Starred):
            out.append(arg)
    return out


def scope_stmts(body: Sequence[ast.stmt]):
    """The statements of a block and its nested blocks, not descending
    into nested defs or classes."""
    stack = list(body)
    while stack:
        st = stack.pop()
        if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                           ast.ClassDef)):
            continue
        yield st
        for fieldname in ("body", "orelse", "finalbody"):
            stack.extend(getattr(st, fieldname, []) or [])
        for h in getattr(st, "handlers", []):
            stack.extend(h.body)


def stmt_exprs(st: ast.stmt):
    """The expression roots of one statement (its nested statement blocks
    are separate items)."""
    for _, value in ast.iter_fields(st):
        if isinstance(value, ast.AST) and not isinstance(value, ast.stmt):
            yield value
        elif isinstance(value, list):
            for v in value:
                if isinstance(v, ast.AST) and \
                        not isinstance(v, (ast.stmt, ast.excepthandler)):
                    yield v


def exec_calls(node: ast.AST):
    """Calls executed when this subtree runs: into lambdas, not into
    nested definitions."""
    stack = [node]
    while stack:
        sub = stack.pop()
        if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if isinstance(sub, ast.Call):
            yield sub
        stack.extend(ast.iter_child_nodes(sub))


def module_str_constants(index: "ProgramIndex", module: str
                         ) -> Dict[str, str]:
    """A module's string constants by simple name."""
    return {name.rsplit(".", 1)[-1]: v
            for name, v in index._module_constants.items()
            if name.startswith(module + ".") and isinstance(v, str)
            and "." not in name[len(module) + 1:]}


def is_grid(expr: ast.AST) -> bool:
    """A receiver that is a ``base.Grid`` by name (``grid``,
    ``self.model.grid``, ``self._grid``)."""
    dotted = ImportResolver.dotted(expr) or ""
    return dotted.rsplit(".", 1)[-1] in ("grid", "_grid")


def group_axis(node: ast.AST, consts: Dict[str, str]
               ) -> Optional[Tuple[str, str]]:
    """``(axis, how)`` when ``node`` names a grid group by a literal axis:
    ``grid.group("x")`` or ``grid.x_group``."""
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
            and node.func.attr == "group" and is_grid(node.func.value) and \
            len(node.args) == 1:
        a = node.args[0]
        v = a.value if isinstance(a, ast.Constant) else \
            consts.get(a.id) if isinstance(a, ast.Name) else None
        if isinstance(v, str):
            return v, f"`{ImportResolver.dotted(node.func)}('{v}')`"
    if isinstance(node, ast.Attribute) and node.attr.endswith("_group") and \
            is_grid(node.value) and isinstance(node.ctx, ast.Load):
        return node.attr[:-len("_group")], f"`.{node.attr}`"
    return None
