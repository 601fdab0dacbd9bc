"""The port's wire contracts as data the protocol checkers read.

The port speaks the JAX package's wire: the center
(``parallel/center_server.py``), the fleet monitor
(``utils/fleetmon.py``) and the statusz endpoints (``utils/tracing.py``)
dispatch on a string ``op`` and their clients send literal headers.  This
module declares those endpoints and reads their tables out of the
sources, statically:

* :data:`ENDPOINTS`: per endpoint, the server's dispatch function, the
  client surfaces that send to it, the ops served to tools outside the
  tree, the ops idempotent by their algebra (no dedup claim needed), and
  the server attributes that hold the state and the dedup window;
* op tables: :func:`server_op_table` reads the ``op == "push"`` ladder
  (equality, tuple membership, module constants such as ``METRICS_OP``);
  :func:`client_op_table` the ``{"op": ...}`` literals handed to the
  request functions; :func:`statusz_query_ops` every literal op sent
  through ``tracing.statusz_query``;
* replies: :func:`reply_sites` the reply-header literals of each handler
  (and constant-key stores such as ``hdr["dedup"] = True``), dynamic
  ones marked; :data:`REPLY_VERDICT_KEYS` and :data:`EXCEPTION_VERDICTS`
  are the close taxonomy (what a reply's verdict tells the client to do);
* retries: :func:`mutating_methods` closes the state class's mutating
  methods over its own calls; :func:`state_aliases` finds the dispatch's
  local names for the state; :func:`fold_op_test` decides a dispatch
  ``if`` for one op;
* membership: :data:`STATUS_EVENTS` (the event each worker status write
  must emit), :data:`EVENT_HOOKS`/:data:`REACTOR_HOOKS` (the reactor
  fan-out) and :data:`HEADER_FIELDS` (each request-header field and the
  protocol version that introduced it; an optional v2 field is read with
  ``.get``, since a v1 peer leaves it out).

What cannot be resolved yields nothing: a partial tree skips the checks
that need files it lacks (:attr:`EndpointSpec.requires`) rather than
guessing.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

from .engine import FuncRecord, ProgramIndex, body_walk

PKG = "theanompi_tpu_torch"
CENTER_PATH = f"{PKG}/parallel/center_server.py"
FLEETMON_PATH = f"{PKG}/utils/fleetmon.py"
TRACING_PATH = f"{PKG}/utils/tracing.py"
WIRE_PATH = f"{PKG}/parallel/wire.py"
MEMBERSHIP_PATH = f"{PKG}/parallel/membership.py"
ASYNC_EASGD_PATH = f"{PKG}/parallel/async_easgd.py"

#: the one generic statusz dialer: its literal ops pool into the client
#: table of every statusz-compatible endpoint
STATUSZ_QUERY_FN = f"{PKG}.utils.tracing.statusz_query"
DEFAULT_STATUSZ_OP = "health"      # statusz_query's default op


@dataclass(frozen=True)
class ClientSurface:
    """Requests sent through ``request_fns`` within ``scope`` (a class or
    function name; "" is the whole module) of ``path``; the header dict is
    positional argument ``header_arg``."""

    path: str
    scope: str
    request_fns: Tuple[str, ...]
    header_arg: int = 0


@dataclass(frozen=True)
class ReadSurface:
    """Where a client reads reply headers: names bound from a call of
    ``request_fns`` (the first element of a tuple unpack when
    ``tuple_result``), read with ``.get("k")`` or ``["k"]``."""

    path: str
    scope: str
    request_fns: Tuple[str, ...]
    tuple_result: bool = True


@dataclass(frozen=True)
class EndpointSpec:
    name: str
    server_path: str
    dispatch: str                       # dotted suffix in the server file
    clients: Tuple[ClientSurface, ...] = ()
    reads: Tuple[ReadSurface, ...] = ()
    #: handler ops served to tools outside the tree: no in-tree client
    #: need send them
    external_ops: FrozenSet[str] = frozenset()
    #: mutating ops whose mutation is idempotent by algebra (seed once,
    #: set membership): exempt from the dedup claim
    idempotent_ops: FrozenSet[str] = frozenset()
    state_attrs: Tuple[str, ...] = ()   # server attrs holding the state
    state_classes: Tuple[str, ...] = () # dotted classes of that state
    dedup_attrs: Tuple[str, ...] = ("dedup",)
    #: one of the endpoints ``statusz_query`` dials (their sent ops pool)
    statusz_compat: bool = False
    #: served behind WireClient: the shared verdict vocabulary applies
    wire_verdicts: bool = False
    #: files the unsent-handler direction needs in scope
    requires: Tuple[str, ...] = ()


ENDPOINTS: Tuple[EndpointSpec, ...] = (
    EndpointSpec(
        name="center",
        server_path=CENTER_PATH,
        dispatch="CenterServer._dispatch",
        clients=(ClientSurface(CENTER_PATH, "RemoteCenter", ("request",)),),
        reads=(ReadSurface(CENTER_PATH, "RemoteCenter", ("request",)),),
        # init seeds once (a no-op when the leaves exist); demote and
        # readmit are set membership: a retry re-applies the same state
        idempotent_ops=frozenset({"init", "demote", "readmit"}),
        state_attrs=("center",),
        state_classes=(f"{PKG}.parallel.async_easgd.ElasticCenter",),
        wire_verdicts=True,
    ),
    EndpointSpec(
        name="fleetmon",
        server_path=FLEETMON_PATH,
        dispatch="Handler._dispatch",
        clients=(ClientSurface(FLEETMON_PATH, "MetricStreamer",
                               ("request",)),),
        # the query surface: the fleet dialer (scripts/fleetz.py, which
        # reads either package's monitor over the shared wire) sends
        # health, alerts and events; Prometheus scrapes exposition; the
        # tests read series and rollup
        external_ops=frozenset({"series", "rollup", "exposition", "alerts",
                                "health", "events"}),
        state_attrs=("collector",),
        state_classes=(f"{PKG}.utils.fleetmon.FleetCollector",),
        statusz_compat=True,
        wire_verdicts=True,
        requires=(TRACING_PATH,),
    ),
    EndpointSpec(
        name="statusz",
        server_path=TRACING_PATH,
        dispatch="Handler.handle",
        # served to the fleet dialer and to operators
        external_ops=frozenset({"health", "events"}),
        statusz_compat=True,
        requires=(FLEETMON_PATH,),
    ),
)

#: the shared wire client, which reads every wire endpoint's verdicts
WIRE_CLIENT_READS = ReadSurface(WIRE_PATH, "WireClient",
                                ("recv_msg", "_request_locked"))

#: reply keys that steer the client: ``retry`` re-sends the same token,
#: ``busy`` is an in-flight twin's retryable refusal, ``uninit`` a
#: structured terminal (the client re-seeds), ``dedup`` the replay marker
POLICY_KEYS = ("retry", "busy", "uninit", "dedup")
REPLY_VERDICT_KEYS = ("ok", "error", "srv") + POLICY_KEYS

#: the close taxonomy: the reply sent from these exception handlers
EXCEPTION_VERDICTS = {
    "CorruptPayload": "retryable",      # the bytes were bad, the stream aligned
    "VersionMismatch": "terminal",      # never retried
}

#: request-header field -> (protocol version, subscript read allowed)
HEADER_FIELDS = {
    "op": (1, True), "tok": (1, True), "crc": (1, True), "v": (1, True),
    "island": (1, True), "rank": (1, True), "role": (1, True),
    "status": (1, True), "series": (1, True), "n": (1, True),
    "reason": (1, True),
    "trace": (2, False), "srv": (2, False),
}

CONTROLLER_CLASS = (f"{PKG}.parallel.membership", "MembershipController")
REACTOR_ROOT = f"{PKG}.parallel.membership.Reactor"
MEMBERSHIP_VOCAB = f"{PKG}.parallel.membership.MEMBERSHIP_EVENTS"
CENTER_VOCAB = f"{PKG}.parallel.membership.CENTER_EVENTS"
ACTIONS_VOCAB = f"{PKG}.utils.fleetmon.RULE_ACTIONS"

#: worker status a controller method writes -> the event it must emit
STATUS_EVENTS = {
    "live": "worker_join",
    "demoted": "worker_demote",
    "dead": "worker_leave",
    "left": "worker_leave",
}
#: event -> the reactor hooks ``_emit`` may fan it out through
EVENT_HOOKS = {
    "worker_join": ("on_join", "on_readmit"),
    "worker_leave": ("on_leave",),
    "worker_demote": ("on_demote",),
}
#: every hook a Reactor subclass handles or ignores with ``pass``
REACTOR_HOOKS = ("on_join", "on_leave", "on_demote", "on_readmit")

#: where an alert's action is carried out: every fleetmon.RULE_ACTIONS
#: entry is compared in one of these (path, dotted suffix) functions
ACTION_HANDLERS = (
    (FLEETMON_PATH, "apply_alert"),
    (MEMBERSHIP_PATH, "ElasticSupervisor._tick_fleetmon"),
)

#: methods that mutate their receiver, beside plain ``self.X = ...``
CONTAINER_MUTATORS = frozenset({
    "append", "appendleft", "add", "discard", "remove", "update", "pop",
    "popitem", "setdefault", "extend", "insert", "clear",
})


def module_of(path: str) -> str:
    return (path[:-3] if path.endswith(".py") else path).replace("/", ".")


@dataclass
class OpSite:
    """Where an op string appears (a dispatch comparison or a send)."""

    path: str
    node: ast.AST

    @property
    def line(self) -> int:
        return getattr(self.node, "lineno", 1)

    @property
    def col(self) -> int:
        return getattr(self.node, "col_offset", 0)


def _call_name(fn: ast.AST) -> Optional[str]:
    if isinstance(fn, ast.Name):
        return fn.id
    return fn.attr if isinstance(fn, ast.Attribute) else None


def _const_key(node: ast.AST) -> Optional[str]:
    """``"k"`` of ``x.get("k")``'s argument or ``x["k"]``'s slice."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def const_str(node: ast.AST, sf, index: ProgramIndex) -> Optional[str]:
    """A string known statically: a literal, an imported module constant,
    or a constant of the same module."""
    if isinstance(node, ast.Constant):
        return node.value if isinstance(node.value, str) else None
    if isinstance(node, (ast.Name, ast.Attribute)):
        resolved = sf.resolver.resolve(node)
        if resolved is None and isinstance(node, ast.Name):
            resolved = f"{sf.resolver.module}.{node.id}"
        v = index.module_constant(resolved) if resolved else None
        if isinstance(v, str):
            return v
    return None


def dispatch_record(index: ProgramIndex,
                    spec: EndpointSpec) -> Optional[FuncRecord]:
    """The server's dispatch function, or None when the server file is in
    scope but the declared function is not."""
    qn = f"{module_of(spec.server_path)}.{spec.dispatch}"
    recs = [r for r in index.by_qualname.get(qn, [])
            if r.sf.path == spec.server_path]
    return recs[0] if recs else None


def op_var_names(fn_node: ast.AST) -> Set[str]:
    """Names assigned from ``<header>.get("op")``."""
    out: Set[str] = set()
    for sub in ast.walk(fn_node):
        if isinstance(sub, ast.Assign) and isinstance(sub.value, ast.Call) \
                and isinstance(sub.value.func, ast.Attribute) \
                and sub.value.func.attr == "get" and sub.value.args \
                and isinstance(sub.value.args[0], ast.Constant) \
                and sub.value.args[0].value == "op":
            out.update(t.id for t in sub.targets if isinstance(t, ast.Name))
    return out


def _comparison_ops(test: ast.AST, opvars: Set[str], sf,
                    index: ProgramIndex) -> List[Tuple[str, ast.AST]]:
    """(op, comparison) for each equality or membership test of an op
    variable inside ``test``."""
    out: List[Tuple[str, ast.AST]] = []
    for sub in ast.walk(test):
        if not isinstance(sub, ast.Compare) or \
                not isinstance(sub.left, ast.Name) or sub.left.id not in opvars:
            continue
        for cmp_op, comp in zip(sub.ops, sub.comparators):
            if isinstance(cmp_op, (ast.Eq, ast.NotEq)):
                values = [comp]
            elif isinstance(cmp_op, (ast.In, ast.NotIn)) and \
                    isinstance(comp, (ast.Tuple, ast.List, ast.Set)):
                values = comp.elts
            else:
                continue
            for e in values:
                v = const_str(e, sf, index)
                if v is not None:
                    out.append((v, sub))
    return out


def server_op_table(index: ProgramIndex, spec: EndpointSpec
                    ) -> Optional[Dict[str, OpSite]]:
    """Every op the dispatch function tests its op variable against (the
    first site of each), or None when the function is missing."""
    rec = dispatch_record(index, spec)
    if rec is None:
        return None
    opvars = op_var_names(rec.node) or {p for p in rec.params() if p == "op"}
    table: Dict[str, OpSite] = {}
    for sub in ast.walk(rec.node):
        if isinstance(sub, (ast.If, ast.IfExp, ast.While)):
            test = sub.test
        elif isinstance(sub, ast.Compare):
            test = sub
        else:
            continue
        for v, node in _comparison_ops(test, opvars, rec.sf, index):
            table.setdefault(v, OpSite(rec.sf.path, node))
    return table


def _scope_records(index: ProgramIndex, path: str,
                   scope: str) -> List[FuncRecord]:
    sf = index.by_path.get(path)
    if sf is None:
        return []
    module = sf.resolver.module
    return [rec for rec in index.records.values() if rec.sf.path == path and (
        not scope or rec.class_key == (module, scope)
        or rec.qualname == f"{module}.{scope}"
        or rec.qualname.startswith(f"{module}.{scope}."))]


def _local_dict(fn_node: ast.AST, name: str) -> Optional[ast.Dict]:
    """The dict literal a local name was assigned from."""
    for sub in ast.walk(fn_node):
        if isinstance(sub, ast.Assign) and isinstance(sub.value, ast.Dict) \
                and any(isinstance(t, ast.Name) and t.id == name
                        for t in sub.targets):
            return sub.value
    return None


def _dict_key_value(d: ast.Dict, key: str) -> Optional[ast.AST]:
    for k, v in zip(d.keys, d.values):
        if isinstance(k, ast.Constant) and k.value == key:
            return v
    return None


def client_op_table(index: ProgramIndex, spec: EndpointSpec
                    ) -> Dict[str, List[OpSite]]:
    """The ``"op"`` of every header literal (inline or bound to a local)
    the client surfaces hand to their request functions."""
    out: Dict[str, List[OpSite]] = {}
    for surf in spec.clients:
        for rec in _scope_records(index, surf.path, surf.scope):
            if isinstance(rec.node, ast.Lambda):
                continue
            for sub in ast.walk(rec.node):
                if not isinstance(sub, ast.Call) or \
                        _call_name(sub.func) not in surf.request_fns:
                    continue
                hdr = sub.args[surf.header_arg] \
                    if len(sub.args) > surf.header_arg else None
                for kw in sub.keywords:
                    if kw.arg == "header":
                        hdr = kw.value
                if isinstance(hdr, ast.Name):
                    hdr = _local_dict(rec.node, hdr.id)
                if not isinstance(hdr, ast.Dict):
                    continue
                v = _dict_key_value(hdr, "op")
                op = const_str(v, rec.sf, index) if v is not None else None
                if op is not None:
                    out.setdefault(op, []).append(OpSite(rec.sf.path, sub))
    return out


def statusz_query_ops(index: ProgramIndex) -> Dict[str, List[OpSite]]:
    """Every literal op sent through ``tracing.statusz_query`` outside
    ``tests/`` (a call without one sends ``health``)."""
    out: Dict[str, List[OpSite]] = {}
    for sf in index.files:
        if sf.path.startswith("tests/"):
            continue
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.Call) or \
                    sf.resolver.resolve(node.func) != STATUSZ_QUERY_FN:
                continue
            arg = node.args[1] if len(node.args) > 1 else None
            for kw in node.keywords:
                if kw.arg == "op":
                    arg = kw.value
            v = DEFAULT_STATUSZ_OP if arg is None else const_str(arg, sf, index)
            if v is not None:
                out.setdefault(v, []).append(OpSite(sf.path, node))
    return out


@dataclass
class ReplySite:
    path: str
    node: ast.AST
    keys: Optional[FrozenSet[str]]      # None: dynamic (a splat, computed)
    consts: Dict[str, object] = field(default_factory=dict)

    @property
    def line(self) -> int:
        return getattr(self.node, "lineno", 1)


def _server_class_records(index: ProgramIndex,
                          spec: EndpointSpec) -> List[FuncRecord]:
    """Every method of the dispatch function's class (all of it, or the
    function alone when it is not a method)."""
    rec = dispatch_record(index, spec)
    if rec is None:
        return []
    if rec.class_key is None:
        return [rec]
    return [r for r in index.records.values()
            if r.class_key == rec.class_key and not isinstance(r.node, ast.Lambda)]


def _reply_header_arg(call: ast.Call) -> Optional[ast.AST]:
    """The header of a call to the local ``reply(...)`` closure or to
    ``<x>.send_msg(sock, hdr)``, else None."""
    fn = call.func
    if isinstance(fn, ast.Name) and fn.id == "reply":
        return call.args[0] if call.args else None
    if isinstance(fn, ast.Attribute) and fn.attr == "send_msg":
        return call.args[1] if len(call.args) > 1 else None
    return None


def _literal_site(path: str, call: ast.Call, hdr: ast.Dict) -> ReplySite:
    keys = frozenset(k.value for k in hdr.keys if isinstance(k, ast.Constant))
    consts = {k.value: v.value for k, v in zip(hdr.keys, hdr.values)
              if isinstance(k, ast.Constant) and isinstance(v, ast.Constant)}
    return ReplySite(path, call, keys, consts)


def reply_sites(index: ProgramIndex, spec: EndpointSpec
                ) -> Tuple[List[ReplySite], Set[str]]:
    """(reply sites, extra keys).  The extra keys are constant-key stores
    (``hdr["dedup"] = True``) into names that flow into a reply somewhere
    in the handler class; a local dict that never reaches a reply adds
    nothing."""
    sites: List[ReplySite] = []
    extra: Set[str] = set()
    recs = _server_class_records(index, spec)
    header_names: Set[str] = set()
    for rec in recs:
        for sub in ast.walk(rec.node):
            if isinstance(sub, ast.Call):
                hdr = _reply_header_arg(sub)
                if isinstance(hdr, ast.Name):
                    header_names.add(hdr.id)
            elif isinstance(sub, _FuncDefs) and sub.name == "reply":
                header_names.update(a.arg for a in sub.args.args)
    # one hop of rebinding: ``h = dict(hdr)``
    for rec in recs:
        for sub in ast.walk(rec.node):
            if isinstance(sub, ast.Assign) and any(
                    isinstance(n, ast.Name) and n.id in header_names
                    for n in ast.walk(sub.value)):
                header_names.update(t.id for t in sub.targets
                                    if isinstance(t, ast.Name))
    for rec in recs:
        for sub in ast.walk(rec.node):
            if isinstance(sub, ast.Assign):
                for t in sub.targets:
                    if isinstance(t, ast.Subscript) and \
                            isinstance(t.value, ast.Name) and \
                            t.value.id in header_names and \
                            _const_key(t.slice) is not None:
                        extra.add(t.slice.value)
                continue
            if not isinstance(sub, ast.Call):
                continue
            hdr = _reply_header_arg(sub)
            if hdr is None:
                continue
            if isinstance(hdr, ast.Dict):
                site = _literal_site(rec.sf.path, sub, hdr)
                if any(k is None for k in hdr.keys):        # ** splat
                    site.keys = None
                sites.append(site)
            else:
                sites.append(ReplySite(rec.sf.path, sub, None))
    return sites, extra


_FuncDefs = (ast.FunctionDef, ast.AsyncFunctionDef)


def exception_reply_sites(index: ProgramIndex, spec: EndpointSpec,
                          exc_name: str) -> List[ReplySite]:
    """Literal replies inside ``except <...>.{exc_name}`` handlers of the
    server class."""
    out: List[ReplySite] = []
    for rec in _server_class_records(index, spec):
        for sub in ast.walk(rec.node):
            if not isinstance(sub, ast.ExceptHandler) or sub.type is None:
                continue
            types = sub.type.elts if isinstance(sub.type, ast.Tuple) \
                else [sub.type]
            names = {t.id if isinstance(t, ast.Name) else
                     t.attr if isinstance(t, ast.Attribute) else None
                     for t in types}
            if exc_name not in names:
                continue
            for call in ast.walk(ast.Module(body=sub.body, type_ignores=[])):
                if isinstance(call, ast.Call):
                    hdr = _reply_header_arg(call)
                    if isinstance(hdr, ast.Dict):
                        out.append(_literal_site(rec.sf.path, call, hdr))
    return out


def reply_reads(index: ProgramIndex, surf: ReadSurface) -> Dict[str, OpSite]:
    """Reply keys the surface reads from its request functions' results."""
    out: Dict[str, OpSite] = {}
    for rec in _scope_records(index, surf.path, surf.scope):
        if isinstance(rec.node, ast.Lambda):
            continue
        reply_vars: Set[str] = set()
        for sub in ast.walk(rec.node):
            if not isinstance(sub, ast.Assign) or \
                    not isinstance(sub.value, ast.Call) or \
                    _call_name(sub.value.func) not in surf.request_fns:
                continue
            for t in sub.targets:
                if surf.tuple_result and isinstance(t, ast.Tuple) and \
                        t.elts and isinstance(t.elts[0], ast.Name):
                    reply_vars.add(t.elts[0].id)
                elif not surf.tuple_result and isinstance(t, ast.Name):
                    reply_vars.add(t.id)
        if reply_vars:
            for key, site, _ in _key_reads(rec.node, reply_vars):
                out.setdefault(key, OpSite(rec.sf.path, site))
    return out


def _key_reads(fn_node: ast.AST, names: Set[str]):
    """(key, node) of every ``n.get("k")`` and load of ``n["k"]`` for a
    name ``n`` in ``names``."""
    for sub in ast.walk(fn_node):
        if isinstance(sub, ast.Call) and isinstance(sub.func, ast.Attribute) \
                and sub.func.attr == "get" \
                and isinstance(sub.func.value, ast.Name) \
                and sub.func.value.id in names and sub.args \
                and _const_key(sub.args[0]) is not None:
            yield sub.args[0].value, sub, False
        elif isinstance(sub, ast.Subscript) and \
                isinstance(sub.value, ast.Name) and sub.value.id in names \
                and isinstance(sub.ctx, ast.Load) \
                and _const_key(sub.slice) is not None:
            yield sub.slice.value, sub, True


@dataclass
class HeaderRead:
    path: str
    node: ast.AST
    fieldname: str
    subscript: bool

    @property
    def line(self) -> int:
        return getattr(self.node, "lineno", 1)


def header_reads(index: ProgramIndex, spec: EndpointSpec) -> List[HeaderRead]:
    """Request-header fields the dispatch function reads, through its
    ``header`` parameter or names unpacked from ``recv_msg``."""
    rec = dispatch_record(index, spec)
    if rec is None:
        return []
    hdr_vars: Set[str] = {p for p in rec.params() if p == "header"}
    for sub in ast.walk(rec.node):
        if isinstance(sub, ast.Assign) and isinstance(sub.value, ast.Call) \
                and isinstance(sub.value.func, (ast.Name, ast.Attribute)) \
                and _call_name(sub.value.func) == "recv_msg":
            for t in sub.targets:
                if isinstance(t, ast.Tuple) and t.elts and \
                        isinstance(t.elts[0], ast.Name):
                    hdr_vars.add(t.elts[0].id)
    return [HeaderRead(rec.sf.path, node, key, subscript)
            for key, node, subscript in _key_reads(rec.node, hdr_vars)]


def _attr_root(node: ast.AST) -> Tuple[Optional[str], List[str]]:
    """(root name, attribute chain) of ``name.a.b``; (None, []) when the
    chain is not rooted at a name."""
    chain: List[str] = []
    while isinstance(node, ast.Attribute):
        chain.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        return node.id, chain[::-1]
    return None, []


def _direct_self_mutation(rec: FuncRecord) -> bool:
    """Does the body store into ``self.X`` (assign, augassign, del,
    subscript) or call a container mutator on a ``self`` attribute?"""
    for sub in body_walk(rec.node):
        if isinstance(sub, ast.Assign):
            targets = sub.targets
        elif isinstance(sub, (ast.AugAssign, ast.AnnAssign)):
            targets = [sub.target]
        elif isinstance(sub, ast.Delete):
            targets = sub.targets
        else:
            targets = []
        for t in targets:
            root, chain = _attr_root(t.value if isinstance(t, ast.Subscript)
                                     else t)
            if root == "self" and chain:
                return True
        if isinstance(sub, ast.Call):
            root, chain = _attr_root(sub.func)
            if root == "self" and len(chain) >= 2 and \
                    chain[-1] in CONTAINER_MUTATORS:
                return True
    return False


def mutating_methods(index: ProgramIndex,
                     dotted_classes: Sequence[str]) -> Set[str]:
    """Names of the methods of the state classes (and their subclasses)
    that mutate ``self``, directly or through a same-class mutating call
    (a monotone fixpoint)."""
    keys: Set[Tuple[str, str]] = set()
    for dotted in dotted_classes:
        key = index.class_key(dotted)
        if key is not None:
            keys |= {key} | set(index.subclasses_of(dotted))
    if not keys:
        return set()
    recs = [r for r in index.records.values()
            if r.class_key in keys and not isinstance(r.node, ast.Lambda)]
    mut = {r.name for r in recs if _direct_self_mutation(r)}
    changed = True
    while changed:
        changed = False
        for r in recs:
            if r.name in mut:
                continue
            for sub in body_walk(r.node):
                if isinstance(sub, ast.Call):
                    root, chain = _attr_root(sub.func)
                    if root == "self" and len(chain) == 1 and chain[0] in mut:
                        mut.add(r.name)
                        changed = True
                        break
    return mut


def self_aliases(index: ProgramIndex, spec: EndpointSpec) -> Set[str]:
    """``self`` and the names the server file binds to a bare ``self``
    (``outer = self``), found rather than listed."""
    out: Set[str] = {"self"}
    sf = index.by_path.get(spec.server_path)
    if sf is not None:
        for sub in ast.walk(sf.tree):
            if isinstance(sub, ast.Assign) and \
                    isinstance(sub.value, ast.Name) and sub.value.id == "self":
                out.update(t.id for t in sub.targets if isinstance(t, ast.Name))
    return out


def state_aliases(index: ProgramIndex, spec: EndpointSpec,
                  attrs: Sequence[str]) -> Set[str]:
    """The attrs themselves and every name the server file binds to
    ``<self alias>.<attr>`` (``center = self.center``).  File-wide and
    coarse: an extra alias can only widen the scan."""
    sf = index.by_path.get(spec.server_path)
    if sf is None:
        return set()
    selves = self_aliases(index, spec)
    out: Set[str] = set(attrs)
    for sub in ast.walk(sf.tree):
        if isinstance(sub, ast.Assign):
            root, chain = _attr_root(sub.value)
            if root in selves and len(chain) == 1 and chain[0] in attrs:
                out.update(t.id for t in sub.targets if isinstance(t, ast.Name))
    return out


def fold_op_test(test: ast.AST, opvars: Set[str], value: str, sf,
                 index: ProgramIndex) -> Optional[bool]:
    """A dispatch ``if`` test decided for one op: True or False when the
    test is a function of the op variable alone, None otherwise."""
    if isinstance(test, ast.BoolOp):
        parts = [fold_op_test(v, opvars, value, sf, index) for v in test.values]
        decisive, other = (False, True) if isinstance(test.op, ast.And) \
            else (True, False)
        if any(p is decisive for p in parts):
            return decisive
        if all(p is other for p in parts):
            return other
        return None
    if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
        inner = fold_op_test(test.operand, opvars, value, sf, index)
        return None if inner is None else not inner
    if isinstance(test, ast.Compare) and isinstance(test.left, ast.Name) and \
            test.left.id in opvars and len(test.ops) == 1:
        cmp_op, comp = test.ops[0], test.comparators[0]
        if isinstance(cmp_op, (ast.Eq, ast.NotEq)):
            v = const_str(comp, sf, index)
            if v is None:
                return None
            return (v == value) == isinstance(cmp_op, ast.Eq)
        if isinstance(cmp_op, (ast.In, ast.NotIn)) and \
                isinstance(comp, (ast.Tuple, ast.List, ast.Set)):
            vals = [const_str(e, sf, index) for e in comp.elts]
            if any(v is None for v in vals):
                return None
            return (value in vals) == isinstance(cmp_op, ast.In)
    return None


def block_terminates(stmts: Sequence[ast.stmt]) -> bool:
    """Does every path through the block leave it (return, raise,
    continue, break, or an if whose arms both do)?"""
    if not stmts:
        return False
    last = stmts[-1]
    if isinstance(last, (ast.Return, ast.Raise, ast.Continue, ast.Break)):
        return True
    if isinstance(last, ast.If):
        return block_terminates(last.body) and block_terminates(last.orelse)
    return False
