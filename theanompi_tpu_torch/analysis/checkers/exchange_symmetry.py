"""exchange-symmetry: every ``exchange_body`` issues the same collective
sequence on all paths.

Counterpart of the JAX lint's exchange-symmetry.  Each rank runs its own
process and its own ``Exchanger.exchange_body``; a rule-specific early
return, or an ``if`` where one arm reduces and the other does not, makes
some ranks issue an all-reduce the others never reach: the group hangs
at the first mismatched collective.  Within every override in the
``parallel.exchanger.Exchanger`` hierarchy (found through the engine's
class graph):

* a collective-issuing expression — ``torch.distributed``'s collectives,
  a process group's own methods, or a call whose transitive summary
  issues one — must not sit under a Python ``if``/``else``/conditional
  expression unless both arms issue the same collective multiset;
* an early ``return``/``continue``/``break`` under a branch must not
  skip collectives the fall-through issues, nor issue ones it does not.
  An early return after every collective has been issued is fine
  (GoSGD's ``if not mine: return``).

Point-to-point sends and receives are paired by construction and differ
by rank on purpose (GoSGD's route): they are not counted.  Loops are
allowed (their trip counts are the same on every rank).  A ``raise``
is not an exit: it aborts every rank alike.
"""

from __future__ import annotations

import ast
from collections import Counter
from typing import List, Optional

from ..core import Checker, Finding, register
from ..engine import FuncRecord, ProgramIndex, call_collective

EXCHANGER_ROOT = "theanompi_tpu_torch.parallel.exchanger.Exchanger"
METHOD = "exchange_body"


@register
class ExchangeSymmetryChecker(Checker):
    name = "exchange-symmetry"
    description = ("every Exchanger.exchange_body must issue the same "
                   "collective sequence on all paths — no early return "
                   "or one-armed branch around a collective")
    needs_engine = True

    def check_program(self, index: ProgramIndex):
        findings: List[Finding] = []
        for rec in self._exchange_bodies(index):
            self._check_body(index, rec, findings)
        return findings

    def _exchange_bodies(self, index: ProgramIndex) -> List[FuncRecord]:
        out: List[FuncRecord] = []
        seen = set()
        # every class whose ancestry reaches the Exchanger root (the
        # root's own exchange_body raises NotImplementedError — harmless)
        root_key = index.class_key(EXCHANGER_ROOT)
        for rec in index.methods.get(METHOD, []):
            if rec.class_key is None or id(rec.node) in seen:
                continue
            keys = {rec.class_key}
            frontier = [rec.class_key]
            while frontier:
                k = frontier.pop()
                for b in index.class_bases.get(k, []):
                    if b == EXCHANGER_ROOT:
                        keys.add(root_key or k)
                    bk = index.class_key(b)
                    if bk is not None and bk not in keys:
                        keys.add(bk)
                        frontier.append(bk)
            in_hierarchy = (root_key in keys if root_key is not None
                            else any(b == EXCHANGER_ROOT
                                     for k in keys
                                     for b in index.class_bases.get(k, [])))
            if in_hierarchy:
                seen.add(id(rec.node))
                out.append(rec)
        return out

    # -- analysis of one exchange_body -------------------------------------

    def _check_body(self, index: ProgramIndex, rec: FuncRecord,
                    findings: List[Finding]) -> None:
        self._index = index
        self._rec = rec
        body = rec.node.body if isinstance(rec.node.body, list) else []
        self._walk_block(body, findings)

    def _collectives_in_expr(self, expr: ast.AST) -> Counter:
        """Multiset of collective names this expression issues when
        evaluated: direct collectives, plus resolvable calls whose
        transitive summary issues collectives (through
        ``autograd.Function.apply`` too)."""
        sf = self._rec.sf
        fidx = self._index.file_index[sf.path]
        out: Counter = Counter()
        stack = [expr]
        while stack:
            node = stack.pop()
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if isinstance(node, ast.Call):
                cname = call_collective(node, sf.resolver)
                if cname is not None:
                    out[cname] += 1
                else:
                    enc = fidx.enclosing.get(id(node.func), self._rec.node)
                    for tgt in self._index.resolve_df_call(sf, node.func,
                                                           enc):
                        ts = self._index.transitive_summary(tgt)
                        for n in sorted(ts.collective_names):
                            out[n] += 1
                        break
            stack.extend(ast.iter_child_nodes(node))
        return out

    def _block_collectives(self, stmts: List[ast.stmt]) -> Counter:
        out: Counter = Counter()
        for st in stmts:
            if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if isinstance(st, ast.If):
                out += self._block_collectives(st.body)
                out += self._block_collectives(st.orelse)
                out += self._collectives_in_expr(st.test)
                continue
            for _, value in ast.iter_fields(st):
                if isinstance(value, ast.AST):
                    out += self._collectives_in_expr(value)
                elif isinstance(value, list):
                    for v in value:
                        if isinstance(v, ast.stmt):
                            out += self._block_collectives([v])
                        elif isinstance(v, ast.AST):
                            out += self._collectives_in_expr(v)
        return out

    def _walk_block(self, stmts: List[ast.stmt],
                    findings: List[Finding],
                    after: Optional[Counter] = None) -> None:
        """``after`` = collectives issued AFTER this block returns to its
        parent (what an early exit here would skip)."""
        sf = self._rec.sf
        after = after if after is not None else Counter()
        # collectives issued by the statements following index i
        tails: List[Counter] = [Counter(after)]
        for st in reversed(stmts):
            tails.append(self._block_collectives([st]) + tails[-1])
        tails.reverse()          # tails[i] = everything from stmts[i] on

        for i, st in enumerate(stmts):
            rest = tails[i + 1]  # what follows this statement
            if isinstance(st, ast.If):
                arm_counts = (self._block_collectives(st.body),
                              self._block_collectives(st.orelse))
                arm_exits = (self._ends_flow(st.body),
                             self._ends_flow(st.orelse))
                # the collective multiset of the FULL PATH through each
                # arm: the arm's own collectives, plus — unless the arm
                # exits — everything after the if.  Any asymmetry is a
                # divergence, covering both an early return that SKIPS
                # later collectives and an exiting arm that ISSUES
                # collectives the fall-through never does.
                paths = tuple(
                    counts + (Counter() if exits else rest)
                    for counts, exits in zip(arm_counts, arm_exits))
                if paths[0] != paths[1]:
                    if arm_exits[0] or arm_exits[1]:
                        exiting = st.body if arm_exits[0] else st.orelse
                        node = exiting[-1] if exiting else st
                        findings.append(Finding(
                            self.name, sf.path, node.lineno,
                            node.col_offset,
                            f"early exit in `{self._rec.class_name}"
                            f".{METHOD}` diverges from the fall-through "
                            f"collective sequence: "
                            f"{dict(+paths[0]) or '{}'} vs "
                            f"{dict(+paths[1]) or '{}'} "
                            f"({', '.join(sorted((+paths[0]) + (+paths[1])))})"
                            " — all ranks must run the same collective "
                            "sequence"))
                    else:
                        findings.append(Finding(
                            self.name, sf.path, st.lineno, st.col_offset,
                            f"collective sequence diverges across `if` "
                            f"arms in `{self._rec.class_name}.{METHOD}`: "
                            f"{dict(arm_counts[0]) or '{}'} vs "
                            f"{dict(arm_counts[1]) or '{}'} — issue "
                            "the same sequence in both arms (a rank off "
                            "the active set sends zeros)"))
                # recurse for nested structure
                self._walk_block(st.body, findings, rest)
                self._walk_block(st.orelse, findings, rest)
                continue
            # conditional EXPRESSIONS with one-armed collectives
            for _, value in ast.iter_fields(st):
                values = value if isinstance(value, list) else [value]
                for v in values:
                    if not isinstance(v, ast.AST) or \
                            isinstance(v, ast.stmt):
                        continue
                    for sub in ast.walk(v):
                        if isinstance(sub, ast.IfExp):
                            a = self._collectives_in_expr(sub.body)
                            b = self._collectives_in_expr(sub.orelse)
                            if a != b:
                                findings.append(Finding(
                                    self.name, sf.path, sub.lineno,
                                    sub.col_offset,
                                    "collective sequence diverges "
                                    "across conditional-expression arms "
                                    f"in `{self._rec.class_name}"
                                    f".{METHOD}`: {dict(a) or '{}'} vs "
                                    f"{dict(b) or '{}'}"))
            # nested loop/with/try blocks
            for field in ("body", "orelse", "finalbody"):
                sub = getattr(st, field, None)
                if isinstance(sub, list) and sub and \
                        isinstance(sub[0], ast.stmt) and \
                        not isinstance(st, ast.If):
                    self._walk_block(sub, findings, rest)
            for h in getattr(st, "handlers", []):
                self._walk_block(h.body, findings, rest)

    @staticmethod
    def _ends_flow(stmts: List[ast.stmt]) -> bool:
        # Raise is deliberately NOT an exit here: an exception aborts
        # the whole process loudly (a config assert is uniform across
        # ranks), unlike a silent early return that keeps training with
        # a divergent collective sequence.
        return bool(stmts) and isinstance(
            stmts[-1], (ast.Return, ast.Continue, ast.Break))
