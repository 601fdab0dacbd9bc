"""telemetry-hot-path: on the hot paths, recording sits behind ``enabled``.

With telemetry off, a hot-path site must cost one attribute check:
``telemetry.active()`` returns the inert ``DISABLED`` registry, and every
recording call (``counter``, ``gauge``, ``observe``, ``phase``,
``event``, ...) in the hot files sits under ``if <handle>.enabled:``, after
``if not <handle>.enabled: return``, or in the true arm of ``... if
<handle>.enabled else ...``.  An unguarded call still works (the inert
methods do nothing), which is why review misses it: it costs a method
dispatch and its arguments every step.

The hot files are the port's files of these base names: the step and
its capture (``parallel/steps.py``), the prefetch producer
(``models/data/prefetch.py``), the exchanger, the worker, the islands
(``parallel/async_easgd.py``), the wire and the center, the fleet monitor
and the numerics plane.  Handles are found by dataflow: names assigned
from ``telemetry.active()``/``init(...)`` or ``tracing.active()``/
``init(...)``, and ``self.telemetry``.  The span API records too:
``Tracer.begin`` (a span begun under the guard needs none for its
``end``), and the module-level ``tracing.emit_wire_span``/
``emit_server_span``, ``fleetmon.emit_alert`` and ``numerics.record``.
"""

from __future__ import annotations

import ast
from typing import List, Set

from ..core import Checker, Finding, ImportResolver, SourceFile, register

HOT_BASENAMES = {"steps.py", "prefetch.py", "exchanger.py", "worker.py",
                 "async_easgd.py", "wire.py", "center_server.py",
                 "fleetmon.py", "numerics.py"}

_UTILS = "theanompi_tpu_torch.utils"
TELEMETRY_MODULE = f"{_UTILS}.telemetry"
TRACING_MODULE = f"{_UTILS}.tracing"
FLEETMON_MODULE = f"{_UTILS}.fleetmon"
NUMERICS_MODULE = f"{_UTILS}.numerics"
_RECORDING_MODULES = (TELEMETRY_MODULE, TRACING_MODULE, FLEETMON_MODULE,
                      NUMERICS_MODULE)

#: calls that record; the accessors and ``.enabled`` reads are free
RECORDING = {"counter", "gauge", "observe", "phase", "event",
             "system_snapshot", "dump_flight", "tail", "summary", "close",
             "begin", "emit_wire_span", "emit_server_span", "emit_alert",
             "record"}

HANDLE_SOURCES = {TELEMETRY_MODULE + ".active", TELEMETRY_MODULE + ".init",
                  TRACING_MODULE + ".active", TRACING_MODULE + ".init"}


def _guards(test: ast.AST) -> bool:
    """Is the body reachable only with ``enabled`` true?  A bare read, an
    ``and`` with such a conjunct, or an ``or`` whose every arm guards
    (``other or tm.enabled`` lets the body run with telemetry off)."""
    if isinstance(test, ast.Attribute) and test.attr == "enabled":
        return True
    if isinstance(test, ast.Name) and test.id == "enabled":
        return True
    if isinstance(test, ast.BoolOp):
        check = any if isinstance(test.op, ast.And) else all
        return check(_guards(v) for v in test.values)
    return False


def _negates(test: ast.AST) -> bool:
    """``not tm.enabled`` (the early exit)."""
    return isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not) \
        and _guards(test.operand)


def _leaves(stmts) -> bool:
    return bool(stmts) and isinstance(
        stmts[-1], (ast.Return, ast.Continue, ast.Break, ast.Raise))


@register
class TelemetryHotPathChecker(Checker):
    name = "telemetry-hot-path"
    description = ("telemetry/span-emission calls in steps/prefetch/"
                   "exchanger/worker/async_easgd/wire/center_server not "
                   "dominated by an `enabled` check")

    def applies_to(self, path: str) -> bool:
        return path.rsplit("/", 1)[-1] in HOT_BASENAMES

    def check_file(self, sf: SourceFile):
        findings: List[Finding] = []
        self._block(sf, sf.tree.body, self._handles(sf), False, findings)
        return findings

    @staticmethod
    def _handles(sf: SourceFile) -> Set[str]:
        handles: Set[str] = {"self.telemetry"}
        changed = True
        while changed:
            changed = False
            for node in ast.walk(sf.tree):
                if not isinstance(node, ast.Assign):
                    continue
                v = node.value
                if isinstance(v, ast.Call):
                    src = sf.resolver.resolve(v.func) in HANDLE_SOURCES
                elif isinstance(v, (ast.Name, ast.Attribute)):
                    src = ImportResolver.dotted(v) in handles
                else:
                    src = False
                if not src:
                    continue
                for t in node.targets:
                    name = ImportResolver.dotted(t)
                    if name and name not in handles:
                        handles.add(name)
                        changed = True
        return handles

    # A block walk, so that dominance is modelled: ``if tm.enabled:``
    # guards its body, ``if not tm.enabled: return`` the rest of the block,
    # an ``elif tm.enabled:`` its own arm, and ``x if tm.enabled else y``
    # its true arm.  A def under a guard inherits it.

    def _block(self, sf, stmts, handles: Set[str], guarded: bool,
               findings: List[Finding]) -> None:
        for st in stmts:
            if isinstance(st, ast.If):
                self._expr(sf, st.test, handles, guarded, findings)
                neg = _negates(st.test)
                self._block(sf, st.body, handles, guarded or _guards(st.test),
                            findings)
                self._block(sf, st.orelse, handles, guarded or neg, findings)
                if neg and _leaves(st.body):
                    guarded = True
                continue
            for _, value in ast.iter_fields(st):
                if isinstance(value, list) and value and \
                        isinstance(value[0], ast.stmt):
                    self._block(sf, value, handles, guarded, findings)
                elif isinstance(value, list):
                    for v in value:
                        if isinstance(v, ast.excepthandler):
                            self._block(sf, v.body, handles, guarded, findings)
                        elif isinstance(v, ast.AST):
                            self._expr(sf, v, handles, guarded, findings)
                elif isinstance(value, ast.AST):
                    self._expr(sf, value, handles, guarded, findings)

    def _expr(self, sf, node, handles, guarded, findings) -> None:
        if node is None:
            return
        if isinstance(node, ast.IfExp):
            self._expr(sf, node.test, handles, guarded, findings)
            self._expr(sf, node.body, handles, guarded or _guards(node.test),
                       findings)
            self._expr(sf, node.orelse, handles,
                       guarded or _negates(node.test), findings)
            return
        if isinstance(node, ast.Call) and not guarded:
            self._check_call(sf, node, handles, findings)
        for child in ast.iter_child_nodes(node):
            self._expr(sf, child, handles, guarded, findings)

    def _check_call(self, sf, node, handles, findings) -> None:
        func = node.func
        if not isinstance(func, ast.Attribute) or func.attr not in RECORDING:
            return
        base = ImportResolver.dotted(func.value)
        if base in handles or \
                sf.resolver.resolve(func.value) in _RECORDING_MODULES:
            findings.append(Finding(
                self.name, sf.path, node.lineno, node.col_offset,
                f"unguarded telemetry call `{base}.{func.attr}(...)` on a hot "
                f"path — wrap in `if <handle>.enabled:` (one attribute check "
                f"when disabled)"))
