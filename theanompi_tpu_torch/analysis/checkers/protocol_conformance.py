"""The wire's contracts, checked over the endpoint model of
``analysis/protocol.py``:

* **wire-contract**: each endpoint's dispatch table against the ops its
  clients send (a sent op with no handler arm; a handler arm no client
  in the tree sends and no tool is declared to); the reply verdicts the
  handlers set against those the shared ``WireClient`` reads; a reply
  with ``retry: true`` must be ``ok: false``; the close taxonomy (a
  ``CorruptPayload`` reply is retryable, a ``VersionMismatch`` one is
  not).
* **retry-safety**: for each mutating handler op, every path that
  reaches a mutation of the server's state (a ``self.X`` store, or a
  call of a state-class method that makes one) must come after a
  ``DedupWindow`` claim whose duplicate arm leaves, or a wire retry
  applies the op twice.  Ops idempotent by their algebra are declared
  and exempt.
* **state-machine**: each ``MembershipController`` status write emits
  its declared event, every emitted event and hook is declared (and
  every declared event is emitted), every ``Reactor`` subclass handles
  or ignores every hook (``CenterReactor``, ``MeshReactor``), every
  ``fleetmon.RULE_ACTIONS`` entry is carried out by a declared handler,
  and request-header reads stay within the versioned field vocabulary.

A direction that needs files the run does not have is skipped.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Sequence, Set, Tuple

from .. import protocol as P
from ..core import Checker, Finding, register
from ..engine import FuncRecord, ProgramIndex


@register
class WireContractChecker(Checker):
    name = "wire-contract"
    description = ("client sent-op tables must match server dispatch "
                   "tables per endpoint; reply verdicts must match the "
                   "wire client's retry policy (the close taxonomy)")
    needs_engine = True

    def check_program(self, index: ProgramIndex):
        findings: List[Finding] = []
        present = {s.name: s for s in P.ENDPOINTS
                   if s.server_path in index.by_path}
        tables: Dict[str, Dict[str, P.OpSite]] = {}
        for name, spec in sorted(present.items()):
            t = P.server_op_table(index, spec)
            if t is None:
                findings.append(Finding(
                    self.name, spec.server_path, 1, 0,
                    f"endpoint '{name}': declared dispatch function "
                    f"`{spec.dispatch}` not found — the protocol model "
                    f"(analysis/protocol.py) is out of date"))
            else:
                tables[name] = t

        # statusz_query dials every statusz-compatible endpoint: its ops
        # are held against the family's union
        family = [s for s in P.ENDPOINTS if s.statusz_compat]
        family_ready = all(s.name in tables for s in family)
        pool = P.statusz_query_ops(index) if family_ready else {}
        if family_ready and family:
            family_ops = set().union(*(tables[s.name] for s in family))
            for op, sites in sorted(pool.items()):
                if op not in family_ops:
                    findings.append(Finding(
                        self.name, sites[0].path, sites[0].line, sites[0].col,
                        f"statusz_query sends op '{op}' that no "
                        f"statusz-compatible endpoint "
                        f"({', '.join(s.name for s in family)}) handles"))

        for name, spec in sorted(present.items()):
            if name not in tables:
                continue
            table = tables[name]
            client = P.client_op_table(index, spec)
            for op, sites in sorted(client.items()):
                if op not in table:
                    findings.append(Finding(
                        self.name, sites[0].path, sites[0].line, sites[0].col,
                        f"client sends op '{op}' that endpoint '{name}' has "
                        f"no handler arm for"))
            if not all(p in index.by_path for p in spec.requires) or \
                    (spec.statusz_compat and not family_ready) or \
                    (not spec.clients and not spec.statusz_compat):
                continue
            sent = set(client) | (set(pool) if spec.statusz_compat else set())
            for op in sorted(table):
                if op not in sent and op not in spec.external_ops:
                    site = table[op]
                    findings.append(Finding(
                        self.name, site.path, site.line, site.col,
                        f"endpoint '{name}' handles op '{op}' that no "
                        f"in-repo client ever sends (declare it in "
                        f"external_ops if it is a query surface, or delete "
                        f"the dead arm)"))
        findings.extend(self._verdict_findings(index, tables))
        findings.extend(self._read_findings(index, present, tables))
        return findings

    def _verdict_findings(self, index, tables) -> List[Finding]:
        findings: List[Finding] = []
        wire_specs = [s for s in P.ENDPOINTS if s.wire_verdicts]
        wire_ready = P.WIRE_PATH in index.by_path and \
            all(s.name in tables for s in wire_specs)
        policy = set(P.POLICY_KEYS)
        union_emitted: Set[str] = set()
        wc_reads = set(P.reply_reads(index, P.WIRE_CLIENT_READS)) \
            if wire_ready else set()
        for spec in wire_specs:
            if spec.name not in tables:
                continue
            sites, emitted = P.reply_sites(index, spec)
            for site in sites:
                emitted |= site.keys or set()
                # the client reads ``retry`` only on a refusal
                if site.consts.get("retry") is True and \
                        site.consts.get("ok") is not False:
                    findings.append(Finding(
                        self.name, site.path, site.line, 0,
                        f"endpoint '{spec.name}': reply marks retry=true "
                        f"without ok=false — the wire client never consults "
                        f"retry on a success"))
            union_emitted |= emitted
            if wire_ready:
                for k in sorted((emitted & policy) - wc_reads):
                    anchor = next((s for s in sites if s.keys and k in s.keys),
                                  None)
                    findings.append(Finding(
                        self.name, spec.server_path,
                        anchor.line if anchor else 1, 0,
                        f"endpoint '{spec.name}' emits reply verdict '{k}' "
                        f"the wire client never inspects — a dead signal "
                        f"(retryability drift)"))
            for exc, verdict in sorted(P.EXCEPTION_VERDICTS.items()):
                for site in P.exception_reply_sites(index, spec, exc):
                    has_retry = site.consts.get("retry") is True
                    if verdict == "retryable" and not has_retry:
                        findings.append(Finding(
                            self.name, site.path, site.line, 0,
                            f"endpoint '{spec.name}': the {exc} reply must "
                            f"carry retry=true — a corrupt frame left the "
                            f"stream aligned, the client may retry the same "
                            f"token"))
                    elif verdict == "terminal" and has_retry:
                        findings.append(Finding(
                            self.name, site.path, site.line, 0,
                            f"endpoint '{spec.name}': the {exc} reply must "
                            f"NOT be retryable — a version mismatch is "
                            f"terminal by contract"))
        if wire_ready:
            for k in sorted((wc_reads & policy) - union_emitted):
                findings.append(Finding(
                    self.name, P.WIRE_PATH, 1, 0,
                    f"the wire client inspects reply verdict '{k}' that no "
                    f"handler path of any wire endpoint sets"))
        return findings

    def _read_findings(self, index, present, tables) -> List[Finding]:
        findings: List[Finding] = []
        for name, spec in sorted(present.items()):
            if name not in tables or not spec.reads:
                continue
            sites, emitted = P.reply_sites(index, spec)
            if any(s.keys is None for s in sites):
                continue                # a dynamic reply can set anything
            for s in sites:
                emitted |= s.keys
            reads: Dict[str, P.OpSite] = {}
            for surf in spec.reads:
                for k, site in P.reply_reads(index, surf).items():
                    reads.setdefault(k, site)
            for k, site in sorted(reads.items()):
                if k not in emitted and k not in P.REPLY_VERDICT_KEYS:
                    findings.append(Finding(
                        self.name, site.path, site.line, site.col,
                        f"client reads reply field '{k}' that no handler "
                        f"path of endpoint '{name}' sets"))
        return findings


@register
class RetrySafetyChecker(Checker):
    name = "retry-safety"
    description = ("every mutating handler path must be dominated by a "
                   "DedupWindow claim check — at-most-once application "
                   "under wire retries")
    needs_engine = True

    def check_program(self, index: ProgramIndex):
        findings: List[Finding] = []
        for spec in P.ENDPOINTS:
            if not spec.state_attrs or spec.server_path not in index.by_path:
                continue
            rec = P.dispatch_record(index, spec)
            if rec is None:
                continue                # wire-contract reports it
            walker = dict(
                index=index, spec=spec, rec=rec,
                opvars=P.op_var_names(rec.node),
                aliases=P.state_aliases(index, spec, spec.state_attrs),
                dedup_aliases=P.state_aliases(index, spec, spec.dedup_attrs),
                selves=P.self_aliases(index, spec),
                mut=P.mutating_methods(index, spec.state_classes))
            for op in sorted(P.server_op_table(index, spec) or {}):
                if op not in spec.idempotent_ops:
                    _ClaimWalker(self.name, op, findings, **walker).walk(
                        list(rec.node.body), claimed=False)
        return findings


class _ClaimWalker:
    """Walks one op's slice of a dispatch function, knowing whether the
    path is past a dedup claim whose duplicate arm leaves.  An ``if`` whose
    test is a function of the op variable alone is folded to its arm for
    this op; any other ``if`` is walked both ways."""

    def __init__(self, check, op, findings, *, index, spec, rec, opvars,
                 aliases, dedup_aliases, selves, mut):
        self.check, self.op, self.findings = check, op, findings
        self.index, self.spec, self.rec = index, spec, rec
        self.opvars, self.aliases = opvars, aliases
        self.dedup_aliases, self.selves, self.mut = dedup_aliases, selves, mut
        self.claim_vars: Set[str] = set()
        self._reported: Set[Tuple[int, str]] = set()

    def walk(self, stmts: Sequence[ast.stmt], claimed: bool) -> bool:
        for st in stmts:
            if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef)):
                continue                # runs when called
            if isinstance(st, ast.If):
                claimed = self._walk_if(st, claimed)
            elif isinstance(st, ast.Try):
                body = self.walk(st.body, claimed)
                for h in st.handlers:
                    # a handler may run from anywhere in the body: only a
                    # claim made before the try holds there
                    self.walk(h.body, claimed)
                claimed = self.walk(st.finalbody, self.walk(st.orelse, body))
            elif isinstance(st, (ast.For, ast.While, ast.With)):
                for expr in ([st.iter] if isinstance(st, ast.For) else
                             [st.test] if isinstance(st, ast.While) else
                             [i.context_expr for i in st.items]):
                    self._scan(expr, claimed)
                claimed = self.walk(getattr(st, "orelse", []),
                                    self.walk(st.body, claimed))
            elif not self._claim_assign(st):
                # the statement itself: ``center.x += 1`` is the AugAssign
                self._scan(st, claimed)
        return claimed

    def _walk_if(self, st: ast.If, claimed: bool) -> bool:
        fold = P.fold_op_test(st.test, self.opvars, self.op, self.rec.sf,
                              self.index)
        if fold is not None:
            self._scan(st.test, claimed)
            return self.walk(st.body if fold else st.orelse, claimed)
        if isinstance(st.test, ast.Name) and st.test.id in self.claim_vars:
            # the duplicate gate: past it, the op runs once
            self.walk(st.body, True)
            self.walk(st.orelse, claimed)
            return True if P.block_terminates(st.body) else claimed
        self._scan(st.test, claimed)
        cb = self.walk(st.body, claimed)
        co = self.walk(st.orelse, claimed)
        return claimed or ((cb or P.block_terminates(st.body)) and
                           (co or P.block_terminates(st.orelse)))

    def _claim_assign(self, st: ast.stmt) -> bool:
        """``dup, cached = <dedup>.check(...)``: note the claim variable."""
        if not isinstance(st, ast.Assign) or not isinstance(st.value, ast.Call):
            return False
        root, chain = P._attr_root(st.value.func)
        if not ((root in self.dedup_aliases and chain == ["check"]) or
                (root in self.selves and len(chain) == 2 and
                 chain[0] in self.spec.dedup_attrs and chain[1] == "check")):
            return False
        t = st.targets[0]
        if isinstance(t, ast.Tuple) and t.elts and isinstance(t.elts[0], ast.Name):
            self.claim_vars.add(t.elts[0].id)
        elif isinstance(t, ast.Name):
            self.claim_vars.add(t.id)
        return True

    def _state_chain(self, node: ast.AST):
        """(shown root, chain below the state) for an expression rooted at
        the server's state, through an alias (``center.x``) or through
        ``self`` or a capture of it (``self.center.x``)."""
        root, chain = P._attr_root(node)
        if root in self.aliases and chain:
            return root, chain
        if root in self.selves and len(chain) >= 2 and \
                chain[0] in self.spec.state_attrs:
            return f"{root}.{chain[0]}", chain[1:]
        return None, []

    def _scan(self, expr: ast.AST, claimed: bool) -> None:
        for node in ast.walk(expr):
            hit = None
            if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign,
                                 ast.Delete)):
                targets = node.targets if isinstance(
                    node, (ast.Assign, ast.Delete)) else [node.target]
                for t in targets:
                    root, chain = self._state_chain(
                        t.value if isinstance(t, ast.Subscript) else t)
                    if root is not None:
                        hit = f"writes `{root}.{'.'.join(chain)}`"
            elif isinstance(node, ast.Attribute):
                root, chain = self._state_chain(node)
                if root is not None:
                    if chain[-1] in self.mut:
                        hit = f"calls mutating `{root}.{'.'.join(chain)}`"
                    elif len(chain) >= 2 and chain[-1] in P.CONTAINER_MUTATORS:
                        hit = f"mutates container `{root}.{'.'.join(chain[:-1])}`"
            if hit is None or claimed:
                continue
            line = getattr(node, "lineno", 1)
            if (line, hit) in self._reported:
                continue
            self._reported.add((line, hit))
            self.findings.append(Finding(
                self.check, self.rec.sf.path, line,
                getattr(node, "col_offset", 0),
                f"endpoint '{self.spec.name}' op '{self.op}': handler path "
                f"{hit} without a dominating DedupWindow claim check — a "
                f"wire retry applies this op twice (at-most-once violation; "
                f"declare the op in idempotent_ops only if the mutation is "
                f"idempotent by algebra)"))


@register
class StateMachineChecker(Checker):
    name = "state-machine"
    description = ("membership transitions must emit exactly their "
                   "declared events, reactors must handle or ignore "
                   "every hook, alert actions must be dispatched, and "
                   "wire-header reads must stay in the versioned "
                   "vocabulary")
    needs_engine = True

    def check_program(self, index: ProgramIndex):
        findings: List[Finding] = []
        self._controller_findings(index, findings)
        self._reactor_findings(index, findings)
        self._action_findings(index, findings)
        self._header_findings(index, findings)
        return findings

    def _controller_findings(self, index, findings) -> None:
        recs = [r for r in index.records.values()
                if r.class_key == P.CONTROLLER_CLASS]
        if not recs:
            return
        path = recs[0].sf.path
        vocab = index.module_constant(P.MEMBERSHIP_VOCAB)
        center_vocab = index.module_constant(P.CENTER_VOCAB)
        center_vocab = center_vocab if isinstance(center_vocab, tuple) else ()
        if not isinstance(vocab, tuple):
            findings.append(Finding(
                self.name, path, 1, 0,
                "MEMBERSHIP_EVENTS vocabulary tuple not found next to "
                "MembershipController — the transition contract has no "
                "declared event set"))
            return

        def hit(node, message):
            findings.append(Finding(self.name, path, node.lineno,
                                    node.col_offset, message))

        all_emits: Set[str] = set()
        for rec in sorted(recs, key=lambda r: r.node.lineno):
            calls = self._emit_calls(rec)
            emits = {ev for ev, _, _ in calls if isinstance(ev, str)}
            all_emits |= emits
            for status, node in self._status_writes(rec):
                expected = P.STATUS_EVENTS.get(status)
                if expected is None:
                    hit(node, f"`{rec.name}` writes undeclared worker status "
                              f"{status!r} — the declared machine knows "
                              f"{sorted(P.STATUS_EVENTS)}")
                elif expected not in emits:
                    hit(node, f"`{rec.name}` transitions a worker to "
                              f"{status!r} without emitting its declared "
                              f"'{expected}' event — the reactors and the "
                              f"chaos audit never see this transition")
            for ev, hook, node in calls:
                if ev is not None and ev not in vocab:
                    hit(node, f"`{rec.name}` emits event {ev!r} outside the "
                              f"declared MEMBERSHIP_EVENTS vocabulary "
                              f"{sorted(vocab)}")
                if hook is not None and hook not in P.REACTOR_HOOKS:
                    hit(node, f"`{rec.name}` fans out through undeclared "
                              f"reactor hook {hook!r}")
                elif ev in P.EVENT_HOOKS and hook is not None and \
                        hook not in P.EVENT_HOOKS[ev]:
                    hit(node, f"event {ev!r} fans out through hook {hook!r} — "
                              f"declared hooks are {list(P.EVENT_HOOKS[ev])}")
            for ev in self._event_literals(rec):
                if ev not in vocab and ev not in center_vocab:
                    findings.append(Finding(
                        self.name, path, rec.node.lineno, 0,
                        f"`{rec.name}` streams telemetry event {ev!r} outside "
                        f"the declared membership/center vocabularies"))
        for ev in vocab:
            if ev not in all_emits:
                findings.append(Finding(
                    self.name, path, 1, 0,
                    f"declared MEMBERSHIP_EVENTS entry {ev!r} is never "
                    f"emitted by any MembershipController transition — dead "
                    f"vocabulary or a dropped emit"))

    @staticmethod
    def _status_writes(rec: FuncRecord):
        """(status literal, node) of every ``x["status"] = ...`` and
        ``x.update(status=...)``, both arms of a conditional included."""
        out = []
        for sub in ast.walk(rec.node):
            values: List[ast.AST] = []
            if isinstance(sub, ast.Assign):
                values = [sub.value for t in sub.targets
                          if isinstance(t, ast.Subscript)
                          and isinstance(t.slice, ast.Constant)
                          and t.slice.value == "status"]
            elif isinstance(sub, ast.Call) and \
                    isinstance(sub.func, ast.Attribute) and \
                    sub.func.attr == "update":
                values = [kw.value for kw in sub.keywords if kw.arg == "status"]
            for v in values:
                for arm in ((v.body, v.orelse) if isinstance(v, ast.IfExp)
                            else (v,)):
                    if isinstance(arm, ast.Constant) and \
                            isinstance(arm.value, str):
                        out.append((arm.value, arm))
        return out

    @staticmethod
    def _emit_calls(rec: FuncRecord):
        """(event literal, hook literal, node) of each ``self._emit``."""
        out = []
        for sub in ast.walk(rec.node):
            if isinstance(sub, ast.Call) and \
                    isinstance(sub.func, ast.Attribute) and \
                    sub.func.attr == "_emit":
                ev = sub.args[0].value if sub.args and \
                    isinstance(sub.args[0], ast.Constant) else None
                hook = sub.args[2].value if len(sub.args) > 2 and \
                    isinstance(sub.args[2], ast.Constant) else None
                out.append((ev, hook, sub))
        return out

    @staticmethod
    def _event_literals(rec: FuncRecord) -> Set[str]:
        """Literal ``<tm>.event("...")`` names: the transitions that stream
        without ``_emit`` (the center pair)."""
        return {sub.args[0].value for sub in ast.walk(rec.node)
                if isinstance(sub, ast.Call)
                and isinstance(sub.func, ast.Attribute)
                and sub.func.attr == "event" and sub.args
                and isinstance(sub.args[0], ast.Constant)
                and isinstance(sub.args[0].value, str)}

    def _reactor_findings(self, index, findings) -> None:
        root_key = index.class_key(P.REACTOR_ROOT)
        if root_key is None:
            return
        for module, cls in index.subclasses_of(P.REACTOR_ROOT):
            if (module, cls) == root_key:
                continue
            sf = next((f for f in index.files if f.resolver.module == module),
                      None)
            if sf is None or sf.path.startswith("tests/"):
                continue
            node = index.file_index[sf.path].classes.get(cls)
            for hook in P.REACTOR_HOOKS:
                if f"{module}.{cls}.{hook}" not in index.by_qualname:
                    findings.append(Finding(
                        self.name, sf.path,
                        node.lineno if node is not None else 1, 0,
                        f"reactor `{cls}` neither handles nor explicitly "
                        f"ignores `{hook}` — every reactor must decide every "
                        f"event in the vocabulary (override with `pass` to "
                        f"ignore)"))

    def _action_findings(self, index, findings) -> None:
        actions = index.module_constant(P.ACTIONS_VOCAB)
        if not isinstance(actions, tuple):
            return
        handlers = [r for path, suffix in P.ACTION_HANDLERS
                    for r in index.by_qualname.get(
                        f"{P.module_of(path)}.{suffix}", [])
                    if r.sf.path == path]
        if not handlers:
            return
        for action in actions:
            if not any(isinstance(sub, ast.Compare) and any(
                    isinstance(c, ast.Constant) and c.value == action
                    for c in sub.comparators)
                    for rec in handlers for sub in ast.walk(rec.node)):
                findings.append(Finding(
                    self.name, handlers[0].sf.path, handlers[0].node.lineno, 0,
                    f"declared alert action {action!r} "
                    f"(fleetmon.RULE_ACTIONS) is dispatched by no declared "
                    f"handler ({', '.join(s for _, s in P.ACTION_HANDLERS)}) "
                    f"— an alert carrying it would be silently dropped"))

    def _header_findings(self, index, findings) -> None:
        for spec in P.ENDPOINTS:
            if spec.server_path not in index.by_path:
                continue
            for read in P.header_reads(index, spec):
                decl = P.HEADER_FIELDS.get(read.fieldname)
                if decl is None:
                    findings.append(Finding(
                        self.name, read.path, read.line, 0,
                        f"endpoint '{spec.name}' reads undeclared wire-header "
                        f"field '{read.fieldname}' — declare it in "
                        f"protocol.HEADER_FIELDS with the protocol version "
                        f"that introduces it (the v1→v2 `trace` precedent)"))
                elif read.subscript and not decl[1]:
                    findings.append(Finding(
                        self.name, read.path, read.line, 0,
                        f"endpoint '{spec.name}' subscript-reads "
                        f"v{decl[0]}-optional header field '{read.fieldname}' "
                        f"— a v1 peer omits it; read it with .get() (version "
                        f"guard)"))
