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

Resolution is static (stdlib ``ast``): what would need type inference
resolves to nothing rather than to a guess, so a checker under-reports
rather than invents.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

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
                for sub in body_walk(rec.node):
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
        ``exch = BSP_Exchanger(cfg)`` -> that class."""
        out: Dict[str, ClassKey] = {}
        classes = self.file_index[rec.sf.path].classes
        for sub in body_walk(rec.node):
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

        for sub in body_walk(rec.node):
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
