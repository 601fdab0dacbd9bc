"""The host-concurrency pass: shared-state races, lock order, signal
safety and thread discipline, over the engine's thread roles.

The port runs many host threads: the prefetch producer and its augment
pool, the pooled kernel-library loads, the watchdog, the membership
heartbeats and supervisor, the center's and the fleet monitor's handler
threads, the chaos monkey and proxy pumps, the asynchronous checkpoint
writer.  Four checks hold them:

* **shared-state-race**: an instance attribute (or module global) written
  from two thread roles that can run at once on one instance, or a
  container mutated in one role while another iterates or copies it, with
  no common lock around both.  A lock guards an access when a ``with
  <lock>:`` encloses it or when it is held at every call site of the
  function that makes it (to a fixpoint).  Attributes built as
  synchronization objects (queues, events, locks, threads, deques,
  executors) and writes in ``__init__``/``__new__`` (before any
  ``start()``) are not race state.
* **lock-ordering**: the lock acquisition graph (nested ``with`` blocks,
  and calls made holding a lock into functions that take another) must
  have no cycle, and a ``threading.Lock`` must not be taken again by the
  thread that holds it.
* **signal-safety**: what a ``signal.signal`` handler reaches may not take
  a non-reentrant lock, block (sleeps, connects, queue, thread and event
  waits), start a thread, or record telemetry: the registry writes
  through a buffered file, and a signal landing mid-write on the same
  thread raises ``RuntimeError: reentrant call``.  Only
  ``utils/telemetry.py``'s fatal-signal hook records, because it is
  terminal (it dumps, then re-raises with ``SIG_DFL``).
* **daemon-discipline**: a non-daemon thread nobody joins blocks
  interpreter exit; a started thread stored on ``self`` (or appended to an
  attribute) that nothing joins can outlive its owner's ``stop()``; a
  ``threading.Thread`` subclass must be daemonic or join itself, and must
  not shadow Thread's own attributes (``self._stop``, which
  ``Thread.join`` calls).

Findings are reported for the runtime tree only: threads under
``tests/`` are started to provoke races, and seed no roles.  A call the
engine cannot resolve adds nothing, so the pass misses rather than
invents.
"""

from __future__ import annotations

import ast
from typing import Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

from ..core import Checker, Finding, ImportResolver, SourceFile, register
from ..engine import MAIN_ROLE, FuncRecord, ProgramIndex, body_walk

_FuncDef = (ast.FunctionDef, ast.AsyncFunctionDef)

#: lock constructors and how they re-enter
LOCK_CTORS = {
    "threading.Lock": "lock",            # not reentrant
    "threading.RLock": "rlock",
    "threading.Condition": "condition",
    "threading.Semaphore": "semaphore",
    "threading.BoundedSemaphore": "semaphore",
}

#: attributes built from these synchronize themselves: not race state
SYNC_CTORS = set(LOCK_CTORS) | {
    "threading.Event", "threading.Thread", "threading.Timer",
    "threading.local", "threading.Barrier",
    "queue.Queue", "queue.SimpleQueue", "queue.LifoQueue",
    "queue.PriorityQueue",
    "collections.deque",                 # append and popleft are atomic
    "concurrent.futures.ThreadPoolExecutor",
    "concurrent.futures.ProcessPoolExecutor",
}

#: a call of one of these on ``self.X`` writes X
MUTATORS = {"append", "appendleft", "add", "remove", "discard", "pop",
            "popitem", "popleft", "clear", "update", "setdefault",
            "extend", "insert"}

#: reads that walk the whole container
COPY_METHODS = {"items", "values", "keys", "copy"}
ITER_WRAPPERS = {"list", "dict", "set", "frozenset", "sorted", "tuple",
                 "sum", "max", "min", "any", "all"}

#: calls that block (resolved through the imports)
BLOCKING_RESOLVED = {
    "time.sleep", "select.select", "socket.create_connection",
    "subprocess.run", "subprocess.call", "subprocess.check_call",
    "subprocess.check_output",
}
#: blocking methods on receivers of a known constructor
BLOCKING_METHODS = {
    "queue.Queue": {"get", "put", "join"},
    "queue.LifoQueue": {"get", "put", "join"},
    "queue.PriorityQueue": {"get", "put", "join"},
    "queue.SimpleQueue": {"get", "put"},
    "threading.Thread": {"join"},
    "threading.Timer": {"join"},
    "threading.Event": {"wait"},
    "threading.Condition": {"wait", "wait_for", "acquire"},
    "threading.Lock": {"acquire"},
    "threading.Semaphore": {"acquire"},
    "subprocess.Popen": {"wait", "communicate"},
}
THREAD_CTORS = {"threading.Thread", "threading.Timer"}

#: the telemetry registry's recording calls (registry or file work)
TM_RECORDING = {"counter", "gauge", "observe", "phase", "event",
                "system_snapshot", "dump_flight", "summary", "close"}
TELEMETRY_MODULE = "theanompi_tpu_torch.utils.telemetry"
TM_HANDLE_SOURCES = {TELEMETRY_MODULE + ".active", TELEMETRY_MODULE + ".init"}
#: the one file whose signal hook may record: its fatal-signal hook dumps
#: the flight record and re-raises with SIG_DFL
TM_SANCTIONED_PATH = "theanompi_tpu_torch/utils/telemetry.py"

#: attributes of ``threading.Thread`` a subclass must not assign
THREAD_INTERNALS = {"_started", "_stop", "_target", "_args", "_kwargs",
                    "_name", "_daemonic", "_ident", "_native_id",
                    "_tstate_lock", "_invoke_excepthook", "_stderr",
                    "_initialized"}

_WRITE_KINDS = ("write", "augwrite", "mutwrite")


def _runtime_path(path: str) -> bool:
    return not path.startswith("tests/")


class Access:
    __slots__ = ("key", "kind", "node", "rec", "held")

    def __init__(self, key, kind, node, rec, held):
        self.key = key      # (owner, attr): owner 'module.Class' or 'module'
        self.kind = kind    # write augwrite mutwrite iterread
        self.node = node
        self.rec = rec
        self.held = held    # locks held by the enclosing ``with`` blocks


class FuncScan:
    """What one function body does that the four checks read."""

    __slots__ = ("accesses", "acquires", "calls", "tm_calls", "blocking",
                 "spawns")

    def __init__(self):
        self.accesses: List[Access] = []
        # (lock id, reentrancy or None, node, locks held before)
        self.acquires: List[Tuple[str, Optional[str], ast.AST,
                                  FrozenSet[str]]] = []
        # (node, target node ids, locks held)
        self.calls: List[Tuple[ast.AST, Tuple[int, ...], FrozenSet[str]]] = []
        self.tm_calls: List[Tuple[ast.AST, str]] = []
        self.blocking: List[Tuple[ast.AST, str]] = []
        self.spawns: List[ast.AST] = []


class ConcurrencyContext:
    """One scan of the runtime functions, shared by the four checks (kept
    on the index)."""

    @classmethod
    def get(cls, index: ProgramIndex) -> "ConcurrencyContext":
        ctx = getattr(index, "_host_concurrency_ctx", None)
        if ctx is None:
            ctx = index._host_concurrency_ctx = cls(index)
        return ctx

    def __init__(self, index: ProgramIndex):
        self.index = index
        self.roles = {r.name: r for r in index.thread_roles()}
        # only roles some runtime spawn site starts take part
        self.runtime_roles = {name for name, r in self.roles.items()
                              if any(_runtime_path(s.path) for s in r.sites)}
        self.recs = [r for r in index.records.values()
                     if _runtime_path(r.sf.path)]
        self._module_ctors: Dict[str, Dict[str, str]] = {}
        self._handles: Dict[str, Set[str]] = {}
        self._globals: Dict[str, Set[str]] = {}
        self._owner_keys: Dict[str, Tuple[str, str]] = {}
        self._shares: Dict[Tuple[str, str], bool] = {}
        self._lock_kinds: Optional[Dict[str, str]] = None
        self.scans: Dict[int, FuncScan] = {id(r.node): self._scan(r)
                                           for r in self.recs}
        self._held_entry = self._compute_held_at_entry()
        self._trans_acquires = self._compute_transitive_acquires()

    # -- roles ---------------------------------------------------------------

    def roles_of(self, rec: FuncRecord) -> Set[str]:
        roles = {r for r in self.index.roles_of(rec)
                 if r == MAIN_ROLE or r in self.runtime_roles}
        return roles or {MAIN_ROLE}

    def multi_instance(self, role_name: str) -> bool:
        """Roles that run many threads at once (a handler per connection,
        a worker per pool slot): two of them race with each other."""
        role = self.roles.get(role_name)
        return role is not None and role.kind in ("handler", "executor")

    def role_shares_owner(self, role_name: str, owner_id: str) -> bool:
        """Does the role touch instances of the owner class that other
        roles hold?  Yes when its entry is a method of the class, when a
        spawn site sits in one (``Thread(target=self._producer)`` hands
        ``self`` over), or when it is multi-instance.  ``main`` alone never
        does: a thread that builds its own instance shares nothing."""
        if role_name == MAIN_ROLE:
            return False
        if self.multi_instance(role_name):
            return True
        role = self.roles.get(role_name)
        if role is None:
            return False
        owner_key = self._owner_keys.get(owner_id)
        if owner_key is None:
            return True                 # a module global is shared
        hit = self._shares.get((role_name, owner_id))
        if hit is None:
            hit = any(e.class_key == owner_key for e in role.entries)
            for site in role.sites:
                if hit:
                    break
                idx = self.index.file_index[site.sf.path]
                cls = idx.owner_class(idx.enclosing.get(id(site.node)))
                hit = cls is not None and \
                    (site.sf.resolver.module, cls.name) == owner_key
            self._shares[(role_name, owner_id)] = hit
        return hit

    def conflicting_pair(self, owner_id: str, a: Access, b: Access
                         ) -> Optional[Tuple[str, str]]:
        """The first two roles under which ``a`` and ``b`` can touch one
        object from two live threads, or None."""
        for r1 in sorted(self.roles_of(a.rec)):
            for r2 in sorted(self.roles_of(b.rec)):
                if r1 == r2 and not self.multi_instance(r1):
                    continue
                if self.role_shares_owner(r1, owner_id) or \
                        self.role_shares_owner(r2, owner_id):
                    return (r1, r2)
        return None

    # -- identities ------------------------------------------------------------

    def module_ctors(self, sf: SourceFile) -> Dict[str, str]:
        """Module-level ``NAME = <ctor>()`` of one file."""
        out = self._module_ctors.get(sf.path)
        if out is None:
            out = self._module_ctors[sf.path] = {}
            for st in sf.tree.body:
                if isinstance(st, ast.Assign) and isinstance(st.value, ast.Call):
                    resolved = sf.resolver.resolve(st.value.func)
                    if resolved:
                        for t in st.targets:
                            if isinstance(t, ast.Name):
                                out.setdefault(t.id, resolved)
        return out

    def attr_ctor(self, class_key, attr) -> Optional[str]:
        return self.index.class_attr_ctors(class_key).get(attr)

    def _owner(self, key: Tuple[str, str]) -> str:
        owner = f"{key[0]}.{key[1]}"
        self._owner_keys.setdefault(owner, key)
        return owner

    def _attr_key(self, rec: FuncRecord, expr: ast.AST
                  ) -> Optional[Tuple[Tuple[str, str], Optional[str]]]:
        """``(key, ctor)`` of shared state: ``self.X`` is X on the
        enclosing class, ``self.A.B`` is B on A's class (when its
        constructor is known), a name some function declares ``global`` is
        a module global; None for locals and parameters."""
        if isinstance(expr, ast.Attribute):
            base = expr.value
            if isinstance(base, ast.Name) and base.id == "self":
                if rec.class_key is None:
                    return None
                return (self._owner(rec.class_key), expr.attr), \
                    self.attr_ctor(rec.class_key, expr.attr)
            if isinstance(base, ast.Attribute) and \
                    isinstance(base.value, ast.Name) and \
                    base.value.id == "self" and rec.class_key is not None:
                ckey = self.index.class_key(
                    self.attr_ctor(rec.class_key, base.attr) or "")
                if ckey is not None:
                    return (self._owner(ckey), expr.attr), \
                        self.attr_ctor(ckey, expr.attr)
            return None
        if isinstance(expr, ast.Name) and expr.id in self._global_names(rec.sf):
            return (rec.sf.resolver.module, expr.id), \
                self.module_ctors(rec.sf).get(expr.id)
        return None

    def _global_names(self, sf: SourceFile) -> Set[str]:
        out = self._globals.get(sf.path)
        if out is None:
            out = self._globals[sf.path] = {
                n for node in ast.walk(sf.tree) if isinstance(node, ast.Global)
                for n in node.names}
        return out

    def lock_id(self, rec: FuncRecord, expr: ast.AST
                ) -> Optional[Tuple[str, Optional[str]]]:
        """``(id, reentrancy or None)`` when ``expr`` is a lock being
        entered.  The id is the owning class and attribute (so
        ``self.center._lock`` and the center's own ``self._lock`` are one
        lock); an unresolved lock-named expression falls back to an id
        local to its file."""
        dotted = ImportResolver.dotted(expr)
        if dotted is None:
            return None
        keyed = self._attr_key(rec, expr)
        if keyed is not None:
            (owner, attr), ctor = keyed
            kind = LOCK_CTORS.get(ctor or "")
            if kind is not None or "lock" in attr.lower():
                return f"{owner}.{attr}", kind
            return None
        if isinstance(expr, ast.Name):
            kind = LOCK_CTORS.get(self.module_ctors(rec.sf).get(expr.id) or "")
            if kind is not None or "lock" in expr.id.lower():
                return f"{rec.sf.resolver.module}.{expr.id}", kind
            return None
        if "lock" in dotted.rsplit(".", 1)[-1].lower():
            return f"{rec.sf.path}:{dotted}", None
        return None

    def telemetry_handles(self, sf: SourceFile) -> Set[str]:
        """Dotted names bound to a telemetry registry in one file."""
        handles = self._handles.get(sf.path)
        if handles is not None:
            return handles
        handles = {"self.telemetry"}

        def is_src(v) -> bool:
            if isinstance(v, ast.Call):
                return sf.resolver.resolve(v.func) in TM_HANDLE_SOURCES
            if isinstance(v, (ast.Name, ast.Attribute)):
                return ImportResolver.dotted(v) in handles
            if isinstance(v, ast.IfExp):
                # ``tm = init(...) if record_dir else active()``
                return is_src(v.body) or is_src(v.orelse)
            return False

        changed = True
        while changed:
            changed = False
            for node in ast.walk(sf.tree):
                if isinstance(node, ast.Assign) and is_src(node.value):
                    for t in node.targets:
                        name = ImportResolver.dotted(t)
                        if name and name not in handles:
                            handles.add(name)
                            changed = True
        self._handles[sf.path] = handles
        return handles

    # -- the walk of one function ----------------------------------------------

    def _scan(self, rec: FuncRecord) -> FuncScan:
        scan = FuncScan()
        idx = self.index.file_index[rec.sf.path]
        ctor_types = self.index.local_ctor_types(rec)
        handles = self.telemetry_handles(rec.sf)

        def access(expr, kind, node, held):
            keyed = self._attr_key(rec, expr)
            if keyed is not None and keyed[1] not in SYNC_CTORS:
                scan.accesses.append(Access(keyed[0], kind, node, rec,
                                            frozenset(held)))

        def classify_call(node, held):
            func = node.func
            resolved = rec.sf.resolver.resolve(func)
            if resolved in BLOCKING_RESOLVED:
                scan.blocking.append((node, f"`{resolved}()`"))
            if resolved in THREAD_CTORS:
                scan.spawns.append(node)
            if isinstance(func, ast.Name) and func.id in ITER_WRAPPERS \
                    and len(node.args) == 1 and not node.keywords:
                access(node.args[0], "iterread", node, held)
            if isinstance(func, ast.Attribute):
                recv = func.value
                if func.attr in MUTATORS:
                    access(recv, "mutwrite", node, held)
                elif func.attr in COPY_METHODS:
                    access(recv, "iterread", node, held)
                # a blocking method on a receiver of known constructor (a
                # self attribute or module name; locals are not guessed)
                keyed = self._attr_key(rec, recv)
                if keyed is not None:
                    ctor = keyed[1]
                elif isinstance(recv, ast.Name):
                    ctor = self.module_ctors(rec.sf).get(recv.id)
                else:
                    ctor = None
                if func.attr in BLOCKING_METHODS.get(ctor, ()):
                    base = ImportResolver.dotted(recv) or "<recv>"
                    scan.blocking.append(
                        (node, f"`{base}.{func.attr}()` "
                               f"({ctor.rsplit('.', 1)[-1]})"))
                if func.attr in TM_RECORDING:
                    base = ImportResolver.dotted(recv)
                    if base in handles or \
                            rec.sf.resolver.resolve(recv) == TELEMETRY_MODULE:
                        scan.tm_calls.append((node, f"{base}.{func.attr}(...)"))
            # generic method names stay unresolved here too: a ``t.join()``
            # resolving to an unrelated ``join`` would add lock-free call
            # sites and foreign acquires
            targets = self.index.resolve_call(
                rec.sf, func, idx.enclosing.get(id(func), rec.node),
                ctor_types, skip_generic_unique=True)
            if targets:
                scan.calls.append((node, tuple(id(t.node) for t in targets),
                                   frozenset(held)))

        def walk(node, held):
            if isinstance(node, _FuncDef):
                return                      # its own record, its own locks
            if isinstance(node, (ast.With, ast.AsyncWith)):
                inner = set(held)
                for item in node.items:
                    walk(item.context_expr, held)
                    lid = self.lock_id(rec, item.context_expr)
                    if lid is not None:
                        scan.acquires.append((lid[0], lid[1], item.context_expr,
                                              frozenset(held)))
                        inner.add(lid[0])
                for st in node.body:
                    walk(st, inner)
                return
            if isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
                targets = node.targets if isinstance(node, ast.Assign) \
                    else [node.target]
                if isinstance(node, ast.AnnAssign) and node.value is None:
                    targets = []            # a bare annotation writes nothing
                kind = "augwrite" if isinstance(node, ast.AugAssign) else "write"
                for t in targets:
                    for el in (t.elts if isinstance(t, (ast.Tuple, ast.List))
                               else [t]):
                        if isinstance(el, ast.Subscript):
                            access(el.value, "mutwrite", node, held)
                        else:
                            access(el, kind, node, held)
            elif isinstance(node, ast.Call):
                classify_call(node, held)
            elif isinstance(node, ast.For):
                access(node.iter, "iterread", node, held)
            elif isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp,
                                   ast.GeneratorExp)):
                for gen in node.generators:
                    access(gen.iter, "iterread", node, held)
            elif isinstance(node, ast.Delete):
                for t in node.targets:
                    if isinstance(t, ast.Subscript):
                        access(t.value, "mutwrite", node, held)
            for child in ast.iter_child_nodes(node):
                walk(child, held)

        for child in ast.iter_child_nodes(rec.node):
            walk(child, set())
        return scan

    # -- locks across calls ----------------------------------------------------

    def _compute_held_at_entry(self) -> Dict[int, FrozenSet[str]]:
        """The locks held at every resolvable call site of each function:
        a decreasing fixpoint of H[f] = ∩ over sites (site locks ∪
        H[caller]).  Role entries and functions nothing calls hold none."""
        sites: Dict[int, List[Tuple[int, FrozenSet[str]]]] = {}
        in_scope = {id(r.node) for r in self.recs}
        for rec in self.recs:
            for _, targets, held in self.scans[id(rec.node)].calls:
                for t in targets:
                    if t in in_scope:
                        sites.setdefault(t, []).append((id(rec.node), held))
        entry_ids = {id(e.node) for role in self.roles.values()
                     for e in role.entries}
        top = None                      # the whole universe: ∩'s identity
        held: Dict[int, object] = {
            id(r.node): frozenset() if id(r.node) in entry_ids
            or id(r.node) not in sites else top for r in self.recs}
        for _ in range(len(self.recs) + 1):
            changed = False
            for nid, calls in sites.items():
                if nid in entry_ids:
                    continue
                acc = top
                for caller, site_held in calls:
                    ch = held.get(caller, frozenset())
                    if ch is top:
                        continue
                    eff = site_held | ch
                    acc = eff if acc is top else (acc & eff)
                if acc is not top and acc != held.get(nid):
                    held[nid] = acc
                    changed = True
            if not changed:
                break
        return {nid: (v if v is not top else frozenset())
                for nid, v in held.items()}

    def held_at_entry(self, rec: FuncRecord) -> FrozenSet[str]:
        return self._held_entry.get(id(rec.node), frozenset())

    def effective_locks(self, a: Access) -> FrozenSet[str]:
        return a.held | self.held_at_entry(a.rec)

    def _compute_transitive_acquires(self) -> Dict[int, Set[str]]:
        out: Dict[int, Set[str]] = {}
        for rec in self.recs:
            direct = {lid for lid, _, _, _ in self.scans[id(rec.node)].acquires}
            if direct:
                out[id(rec.node)] = direct
        changed = True
        while changed:
            changed = False
            for rec in self.recs:
                cur = out.setdefault(id(rec.node), set())
                for _, targets, _ in self.scans[id(rec.node)].calls:
                    for t in targets:
                        extra = out.get(t)
                        if extra and not extra <= cur:
                            cur |= extra
                            changed = True
        return out

    def transitive_acquires(self, rec: FuncRecord) -> Set[str]:
        return self._trans_acquires.get(id(rec.node), set())

    def lock_kind(self, lock_id: str) -> Optional[str]:
        """How the lock re-enters, when its constructor is known."""
        if self._lock_kinds is None:
            self._lock_kinds = {}
            for rec in self.recs:
                for lid, kind, _, _ in self.scans[id(rec.node)].acquires:
                    if kind is not None:
                        self._lock_kinds.setdefault(lid, kind)
        return self._lock_kinds.get(lock_id)


def _fmt_roles(roles: Sequence[str]) -> str:
    return ", ".join(sorted(roles))


@register
class SharedStateRaceChecker(Checker):
    name = "shared-state-race"
    description = ("instance attributes / module globals written from "
                   "multiple thread roles (or mutated under another "
                   "role's iteration) without a common lock")
    needs_engine = True

    def check_program(self, index: ProgramIndex):
        ctx = ConcurrencyContext.get(index)
        by_key: Dict[Tuple[str, str], List[Access]] = {}
        for rec in ctx.recs:
            for a in ctx.scans[id(rec.node)].accesses:
                if rec.name in ("__init__", "__new__") and a.kind in _WRITE_KINDS:
                    continue                # built before any start()
                by_key.setdefault(a.key, []).append(a)
        findings: List[Finding] = []
        for key in sorted(by_key):
            accesses = sorted(by_key[key], key=lambda a: (
                a.rec.sf.path, a.node.lineno, a.node.col_offset))
            findings.extend(self._check_attr(ctx, key, accesses))
        findings.sort(key=Finding.sort_key)
        return findings

    def _check_attr(self, ctx: ConcurrencyContext, key, accesses
                    ) -> List[Finding]:
        owner, attr = key
        writes = [a for a in accesses if a.kind in _WRITE_KINDS]
        # two writes from live threads on one object, no common lock
        for i, w1 in enumerate(writes):
            for w2 in writes[i:]:
                pair = ctx.conflicting_pair(owner, w1, w2)
                if pair is None or \
                        ctx.effective_locks(w1) & ctx.effective_locks(w2):
                    continue
                anchor = w1 if not ctx.effective_locks(w1) else w2
                return [Finding(
                    self.name, anchor.rec.sf.path, anchor.node.lineno,
                    anchor.node.col_offset,
                    f"`{attr}` on `{owner}` is written from thread roles "
                    f"{_fmt_roles(set(pair))} that can run concurrently on "
                    f"one instance, with no common lock — guard every write "
                    f"with the same `with <lock>:` or confine writes to one "
                    f"role")]
        # a container mutated in one role while another walks it
        out: List[Finding] = []
        mut_writes = [a for a in writes if a.kind == "mutwrite"]
        for r in (a for a in accesses if a.kind == "iterread"):
            r_locks = ctx.effective_locks(r)
            for w in mut_writes:
                if ctx.conflicting_pair(owner, w, r) is None or \
                        r_locks & ctx.effective_locks(w):
                    continue
                out.append(Finding(
                    self.name, r.rec.sf.path, r.node.lineno, r.node.col_offset,
                    f"unlocked iteration/copy of `{attr}` on `{owner}` while "
                    f"role(s) {_fmt_roles(ctx.roles_of(w.rec))} mutate it "
                    f"(write at {w.rec.sf.path}:{w.node.lineno}) — the "
                    f"stats_snapshot race class; take the same lock around "
                    f"both sides"))
                break                       # one finding per read site
        return out


@register
class LockOrderingChecker(Checker):
    name = "lock-ordering"
    description = ("cycles in the lock acquisition graph (nested `with` "
                   "blocks + calls made while holding a lock) and "
                   "non-reentrant self-acquisition")
    needs_engine = True

    def check_program(self, index: ProgramIndex):
        ctx = ConcurrencyContext.get(index)
        # edges[a][b]: (file, node) where b is taken holding a
        edges: Dict[str, Dict[str, Tuple]] = {}
        findings: List[Finding] = []

        def again(rec, node, lid, message):
            if ctx.lock_kind(lid) == "lock":
                findings.append(Finding(self.name, rec.sf.path, node.lineno,
                                        node.col_offset, message))

        for rec in ctx.recs:
            scan = ctx.scans[id(rec.node)]
            entry_held = ctx.held_at_entry(rec)
            for lid, _, node, held in scan.acquires:
                for a in sorted(held | entry_held):
                    if a == lid:
                        again(rec, node, lid,
                              f"non-reentrant lock `{lid}` re-acquired while "
                              f"already held — self-deadlock (use RLock or "
                              f"release first)")
                    else:
                        edges.setdefault(a, {}).setdefault(lid, (rec.sf, node))
            for node, targets, held in scan.calls:
                if not (held or entry_held):
                    continue
                acquired: Set[str] = set()
                for t in targets:
                    trec = index.records.get(t)
                    if trec is not None:
                        acquired |= ctx.transitive_acquires(trec)
                for a in sorted(held | entry_held):
                    for b in sorted(acquired):
                        if a == b:
                            again(rec, node, a,
                                  f"call while holding non-reentrant lock "
                                  f"`{a}` reaches a function that acquires "
                                  f"it again — self-deadlock")
                        else:
                            edges.setdefault(a, {}).setdefault(
                                b, (rec.sf, node))
        findings.extend(self._cycles(edges))
        findings.sort(key=Finding.sort_key)
        return findings

    def _cycles(self, edges) -> List[Finding]:
        out: List[Finding] = []
        reported: Set[FrozenSet[str]] = set()
        for start in sorted(edges):
            stack = [(start, [start])]
            while stack:
                node, path = stack.pop()
                for nxt in sorted(edges.get(node, ())):
                    if nxt == start:
                        cyc = frozenset(path)
                        if cyc in reported or len(path) < 2:
                            continue
                        reported.add(cyc)
                        sf, wnode = edges[path[-1]][start]
                        chain = " -> ".join(path + [start])
                        out.append(Finding(
                            self.name, sf.path, wnode.lineno, wnode.col_offset,
                            f"lock-order cycle: {chain} — two threads taking "
                            f"these locks in different orders can deadlock; "
                            f"impose one global order"))
                    elif nxt not in path and len(path) < 8:
                        stack.append((nxt, path + [nxt]))
        return out


@register
class SignalSafetyChecker(Checker):
    name = "signal-safety"
    description = ("functions reachable from signal handlers must not "
                   "acquire non-reentrant locks, block, spawn threads, "
                   "or record telemetry (reentrant-BufferedWriter "
                   "hazard; the terminal fatal-signal hook in "
                   "utils/telemetry.py is the one sanctioned recorder)")
    needs_engine = True

    def check_program(self, index: ProgramIndex):
        ctx = ConcurrencyContext.get(index)
        findings: List[Finding] = []
        seen: Set[int] = set()
        for role in index.thread_roles():
            if role.kind != "signal" or role.name not in ctx.runtime_roles:
                continue
            for rec in index.role_members(role):
                if id(rec.node) in seen:
                    continue
                seen.add(id(rec.node))
                scan = ctx.scans.get(id(rec.node))
                if scan is not None and _runtime_path(rec.sf.path):
                    findings.extend(self._check_member(ctx, index, rec, scan))
        findings.sort(key=Finding.sort_key)
        return findings

    def _check_member(self, ctx, index, rec: FuncRecord, scan: FuncScan
                      ) -> List[Finding]:
        out: List[Finding] = []

        def hit(node, message):
            out.append(Finding(self.name, rec.sf.path, node.lineno,
                               node.col_offset, message))

        where = f"signal-handler-reachable `{rec.qualname}`"
        for lid, kind, node, _ in scan.acquires:
            if kind == "lock":
                hit(node, f"{where} acquires NON-reentrant lock `{lid}` — a "
                          f"signal landing while the interrupted thread holds "
                          f"it deadlocks the process (use RLock or keep "
                          f"handlers lock-free)")
        for node, targets, _ in scan.calls:
            reached = set()
            for t in targets:
                trec = index.records.get(t)
                if trec is not None:
                    reached |= {lid for lid in ctx.transitive_acquires(trec)
                                if ctx.lock_kind(lid) == "lock"}
            for lid in sorted(reached):
                hit(node, f"{where} calls into code acquiring NON-reentrant "
                          f"lock `{lid}` — deadlock if the signal interrupts "
                          f"a holder")
        for node, desc in scan.blocking:
            hit(node, f"{where} blocks on {desc} — a signal handler must "
                      f"return promptly (it runs on the main thread "
                      f"mid-bytecode); set a flag/Event and handle it in the "
                      f"loop")
        for node in scan.spawns:
            hit(node, f"{where} spawns a thread — thread bootstrap takes "
                      f"interpreter-internal locks the interrupted thread may "
                      f"hold; defer the spawn to the main loop")
        if rec.sf.path != TM_SANCTIONED_PATH:
            for node, rendered in scan.tm_calls:
                hit(node, f"{where} records telemetry (`{rendered}`) — the "
                          f"registry does buffered-file I/O, and a signal "
                          f"landing mid-write on the same thread raises "
                          f"`RuntimeError: reentrant call` inside the "
                          f"BufferedWriter; only the terminal fatal-signal "
                          f"hook in utils/telemetry.py (dump + re-raise with "
                          f"SIG_DFL) is sanctioned")
        return out


@register
class DaemonDisciplineChecker(Checker):
    name = "daemon-discipline"
    description = ("non-daemon threads never joined; escaping started "
                   "threads without a bounded join; Thread subclasses "
                   "shadowing threading internals")
    needs_engine = True

    def check_program(self, index: ProgramIndex):
        findings: List[Finding] = []
        for site in index.spawn_sites():
            if not _runtime_path(site.path):
                continue
            if site.kind in ("thread", "timer"):
                findings.extend(self._check_ctor_site(index, site))
            elif site.kind == "thread-subclass":
                findings.extend(self._check_subclass(site))
        findings.sort(key=Finding.sort_key)
        return findings

    @staticmethod
    def _kw_true(call: ast.Call, name: str) -> bool:
        for kw in call.keywords:
            if kw.arg == name and isinstance(kw.value, ast.Constant):
                return bool(kw.value.value)
        return False

    @staticmethod
    def _sets_daemon(sub: ast.AST, target: str) -> bool:
        """``<target> = <truthy constant>``."""
        return isinstance(sub, ast.Assign) and sub.targets and \
            ImportResolver.dotted(sub.targets[0]) == target and \
            isinstance(sub.value, ast.Constant) and bool(sub.value.value)

    @staticmethod
    def _join_targets(tree: ast.AST) -> Tuple[Set[str], Set[str]]:
        """(receivers of ``.join(`` calls, containers whose loop variable is
        joined) within ``tree``."""
        joined: Set[str] = set()
        containers: Set[str] = set()
        loop_vars: Dict[str, str] = {}
        for node in ast.walk(tree):
            if isinstance(node, ast.For) and isinstance(node.target, ast.Name):
                it = ImportResolver.dotted(node.iter)
                if it:
                    loop_vars[node.target.id] = it
            if isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute) and \
                    node.func.attr == "join":
                recv = ImportResolver.dotted(node.func.value)
                if recv:
                    joined.add(recv)
                    if recv in loop_vars:
                        containers.add(loop_vars[recv])
        return joined, containers

    def _check_ctor_site(self, index, site) -> List[Finding]:
        call = site.node
        idx = index.file_index[site.sf.path]
        enc = idx.enclosing.get(id(call))
        parent = enc if enc is not None else site.sf.tree
        stored_attr = local_name = None
        for sub in ast.walk(parent):
            if isinstance(sub, ast.Assign) and sub.value is call:
                t = sub.targets[0]
                if isinstance(t, ast.Attribute):
                    stored_attr = ImportResolver.dotted(t)
                elif isinstance(t, ast.Name):
                    local_name = t.id
                break
        binding = local_name or stored_attr
        daemon = self._kw_true(call, "daemon")
        started = False
        appended_to = None
        if enc is not None and binding:
            for sub in body_walk(enc):
                # daemonized after construction: ``t.daemon = True``
                if not daemon and self._sets_daemon(sub, f"{binding}.daemon"):
                    daemon = True
            for sub in body_walk(enc):
                if not isinstance(sub, ast.Call) or \
                        not isinstance(sub.func, ast.Attribute):
                    continue
                recv = ImportResolver.dotted(sub.func.value)
                if recv in (local_name, stored_attr) and sub.func.attr == "start":
                    started = True
                if sub.func.attr == "append" and sub.args and \
                        local_name is not None and \
                        isinstance(sub.args[0], ast.Name) and \
                        sub.args[0].id == local_name:
                    appended_to = ImportResolver.dotted(sub.func.value)
        for sub in ast.walk(parent):        # Thread(...).start()
            if isinstance(sub, ast.Call) and \
                    isinstance(sub.func, ast.Attribute) and \
                    sub.func.attr == "start" and sub.func.value is call:
                started = True
        # the join scope: the class when spawned in a method, else the module
        cls = idx.owner_class(enc)
        joined, join_containers = self._join_targets(
            cls if cls is not None else site.sf.tree)
        if stored_attr is not None:
            escapes_as, is_joined = stored_attr, stored_attr in joined
        elif appended_to is not None:
            escapes_as, is_joined = appended_to, appended_to in join_containers
        else:
            escapes_as, is_joined = None, bool(local_name) and local_name in joined
        kind = "Timer" if site.kind == "timer" else "Thread"
        if not daemon and not is_joined:
            return [Finding(
                self.name, site.path, site.line, call.col_offset,
                f"non-daemon {kind} (target `{site.target_desc}`) with no "
                f"join() in scope — it blocks interpreter exit and outlives "
                f"its owner; pass daemon=True or join it on every shutdown "
                f"path")]
        if escapes_as is not None and started and not is_joined:
            return [Finding(
                self.name, site.path, site.line, call.col_offset,
                f"{kind} stored on `{escapes_as}` is start()ed but never "
                f"joined — it can outlive stop(); add a bounded join "
                f"(join(timeout=...)) on the shutdown path")]
        return []

    def _check_subclass(self, site) -> List[Finding]:
        cls = site.node
        out: List[Finding] = []
        daemonic = False
        for sub in ast.walk(cls):
            if isinstance(sub, ast.Call) and self._kw_true(sub, "daemon"):
                daemonic = True
            if not isinstance(sub, ast.Assign):
                continue
            for t in sub.targets:
                if isinstance(t, ast.Attribute) and \
                        isinstance(t.value, ast.Name) and t.value.id == "self":
                    if t.attr in THREAD_INTERNALS:
                        out.append(Finding(
                            self.name, site.path, sub.lineno, sub.col_offset,
                            f"Thread subclass `{cls.name}` assigns "
                            f"`self.{t.attr}`, shadowing a threading.Thread "
                            f"internal — the `_stop` collision class "
                            f"(Thread.join calls it); rename the attribute"))
                    if t.attr == "daemon" and \
                            isinstance(sub.value, ast.Constant) and \
                            sub.value.value:
                        daemonic = True
        joined, _ = self._join_targets(cls)
        self_joins = any(j == "self" or j.startswith("self.") for j in joined)
        if not daemonic and not self_joins:
            out.append(Finding(
                self.name, site.path, site.line, cls.col_offset,
                f"Thread subclass `{cls.name}` is non-daemon and never joins "
                f"itself — instances outlive their owners and block "
                f"interpreter exit; pass daemon=True to super().__init__ or "
                f"join in a stop() method"))
        return out
