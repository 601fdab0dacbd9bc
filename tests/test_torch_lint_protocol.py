"""The port's protocol model and its three checkers (wire-contract,
retry-safety, state-machine), and the schema-drift probes, against the
JAX package's.

* The op tables, reply keys, header reads and declared vocabularies that
  the port's model reads out of the port's wire code must equal what the
  JAX model reads out of the JAX package's: the port speaks the same
  wire, so a difference is a port fault.
* The protocol fixtures of ``tests/test_lint.py`` go through the JAX
  checkers as written and through the port's in the port's shape (the
  center's dispatch is ``CenterServer._dispatch``, its client sends
  through ``self._wire.request``): same findings, line for line.
* The schema-drift probes run on the port's live modules and fail on
  doctored stand-ins.
"""

import importlib
import os
import subprocess
import sys

import pytest

from theanompi_tpu.analysis import core as jcore
from theanompi_tpu.analysis import protocol as jproto
from theanompi_tpu.analysis.engine import ProgramIndex as JIndex
from theanompi_tpu_torch.analysis import core as pcore
from theanompi_tpu_torch.analysis import protocol as pproto
from theanompi_tpu_torch.analysis.checkers import schema_drift as sd
from theanompi_tpu_torch.analysis.engine import ProgramIndex as PIndex

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, HERE)
import test_lint as J  # noqa: E402  (the JAX suite's fixtures)
from test_torch_lint import _inject, _keys, to_port  # noqa: E402

# -- the model: the port's tables equal the JAX package's -------------------

_WIRE_FILES = ("parallel/center_server.py", "parallel/wire.py",
               "parallel/membership.py", "parallel/async_easgd.py",
               "utils/fleetmon.py", "utils/tracing.py")


@pytest.fixture(scope="module")
def indexes():
    j = JIndex(jcore.collect_files(REPO, [f"theanompi_tpu/{f}"
                                          for f in _WIRE_FILES]))
    p = PIndex(pcore.collect_files(REPO, [f"theanompi_tpu_torch/{f}"
                                          for f in _WIRE_FILES]))
    return j, p


def _emitted(proto, index, spec):
    sites, extra = proto.reply_sites(index, spec)
    keys = set(extra)
    for s in sites:
        keys |= s.keys or set()
    return sorted(keys)


ASPECTS = {
    "server": lambda proto, index, spec: sorted(
        proto.server_op_table(index, spec)),
    "client": lambda proto, index, spec: sorted(
        proto.client_op_table(index, spec)),
    "replies": _emitted,
    "dynamic": lambda proto, index, spec: sum(
        s.keys is None for s in proto.reply_sites(index, spec)[0]),
    "header": lambda proto, index, spec: sorted(
        (r.fieldname, r.subscript) for r in proto.header_reads(index, spec)),
    "exceptions": lambda proto, index, spec: {
        exc: sorted(sorted(s.consts.items())
                    for s in proto.exception_reply_sites(index, spec, exc))
        for exc in proto.EXCEPTION_VERDICTS},
}


@pytest.mark.parametrize("endpoint", ["center", "fleetmon", "statusz"])
@pytest.mark.parametrize("aspect", sorted(ASPECTS))
def test_endpoint_tables_equal_the_jax_packages(indexes, endpoint, aspect):
    j, p = indexes
    jspec = next(s for s in jproto.ENDPOINTS if s.name == endpoint)
    pspec = next(s for s in pproto.ENDPOINTS if s.name == endpoint)
    got = ASPECTS[aspect](pproto, p, pspec)
    assert got == ASPECTS[aspect](jproto, j, jspec)
    if aspect in ("server", "replies", "header"):
        assert got


def test_wire_client_reads_and_mutations_equal(indexes):
    j, p = indexes
    assert sorted(pproto.reply_reads(p, pproto.WIRE_CLIENT_READS)) == \
        sorted(jproto.reply_reads(j, jproto.WIRE_CLIENT_READS))
    # the port's center counts its pushes in a helper of its own
    # (``_count``); the JAX one's leaf-tree methods have no counterpart
    port = pproto.mutating_methods(p, pproto.ENDPOINTS[0].state_classes)
    jax = jproto.mutating_methods(j, jproto.ENDPOINTS[0].state_classes)
    assert port - jax == {"_count"}
    assert jax - port == {"ensure_init", "push_delta", "push_pull"}


@pytest.mark.parametrize("name", [
    "POLICY_KEYS", "REPLY_VERDICT_KEYS", "EXCEPTION_VERDICTS",
    "HEADER_FIELDS", "STATUS_EVENTS", "EVENT_HOOKS", "REACTOR_HOOKS",
    "CONTAINER_MUTATORS"])
def test_declared_vocabularies_equal(name):
    assert getattr(pproto, name) == getattr(jproto, name)


@pytest.mark.parametrize("const", [
    "parallel.membership.MEMBERSHIP_EVENTS",
    "parallel.membership.CENTER_EVENTS", "utils.fleetmon.RULE_ACTIONS"])
def test_module_vocabularies_equal(indexes, const):
    j, p = indexes
    assert p.module_constant(f"theanompi_tpu_torch.{const}") == \
        j.module_constant(f"theanompi_tpu.{const}") is not None


def test_statusz_dialers_differ_by_the_fleet_dialer_alone(indexes):
    """The JAX package's fleet dialer (``scripts/fleetz.py``) sends
    health, alerts and events; the port has no dialer of its own (the
    fleetmon and statusz query ops are its declared external surface), so
    its tree sends a subset."""
    j = JIndex(jcore.collect_files(REPO, ["theanompi_tpu", "scripts"]))
    p = PIndex(pcore.collect_files(REPO))
    port, jax = set(pproto.statusz_query_ops(p)), set(
        jproto.statusz_query_ops(j))
    assert port <= jax
    assert jax - port <= pproto.ENDPOINTS[1].external_ops


# -- the protocol fixtures of tests/test_lint.py -----------------------------

def center_to_port(text: str) -> str:
    """A JAX-shaped center fixture in the port's shape, line for line:
    the dispatch nested in ``CenterServer.start``'s ``Handler`` becomes
    ``CenterServer``'s own method (its body re-indented, the column
    counted from the indent), a top-level ``Handler`` dispatch becomes
    ``CenterServer``'s, and ``self._roundtrip(`` sends through
    ``self._wire.request(``."""
    lines = to_port(text).split("\n")
    out, dedent = [], False
    for i, ln in enumerate(lines):
        nested = ln == "    def start(self):" and any(
            l.strip() == "class Handler:" for l in lines[i:])
        if nested:
            name = next(l.strip()[4:].split("(")[0] for l in lines[i:]
                        if l.startswith("            def "))
            out.append(f"    def {name}(self, header, body):")
            continue
        if ln == "        class Handler:" or (
                ln.startswith("            def ") and not dedent):
            out.append("")
            dedent = dedent or ln.startswith("            def ")
            continue
        if dedent and ln.strip() and not ln.startswith(" " * 8):
            dedent = False                  # past the server class
        if dedent and ln.startswith(" " * 16):
            ln = ln[8:]
        out.append(ln)
    return "\n".join(out).replace("\nclass Handler:\n",
                                  "\nclass CenterServer:\n") \
        .replace("self._roundtrip(", "self._wire.request(")


C = jproto.CENTER_PATH
M = jproto.MEMBERSHIP_PATH
WG = J.WIRECONTRACT_GOOD
_POKE = WG.replace('    def pull(self):',
                   '    def poke(self):\n'
                   '        self._roundtrip({"op": "poke"})\n\n'
                   '    def pull(self):')
_SHARD = WG.replace("        return body", '        return resp.get("shard")')
_LATTICE_STATE = '''
class ElasticCenter:
    def __init__(self):
        self.n_updates = 0

    def _bump(self):
        self.n_updates += 1

    def apply(self, body):
        self._bump()

    def read(self):
        return self.n_updates
'''
_SELF_WRITE = '''
class CenterServer:
    def start(self):
        dedup = self.dedup
        {alias} = self

        class Handler:
            def _dispatch(self, header, body):
                op = header.get("op")
                tok = header.get("tok")
                if op == "push":
                    {alias}.center.n_updates += 1
                    dedup.record(tok, op, {{"ok": True}})
'''
_HEADER = '''
class Handler:
    def _dispatch(self, header, body):
        op = header.get("op")
        trc = header.get("trace")
        island = header["island"]
'''
_SM_NO_DEMOTE = J.SM_GOOD.replace(
    '        st["status"] = "demoted"\n'
    '        self._emit("worker_demote", worker, "on_demote")\n',
    '        st["status"] = "demoted"\n')
_SM_NO_HOOK = J.SM_GOOD.replace(
    "    def on_demote(self, worker, info):\n        pass\n\n"
    "    def on_readmit(self, worker, info):\n        pass\n\n\n"
    "class MembershipController:",
    "    def on_readmit(self, worker, info):\n        pass\n\n\n"
    "class MembershipController:")

# (id, check, {path: JAX text}, findings)
PROTOCOL_CASES = [
    ("wire-good", "wire-contract", {C: WG}, 0),
    ("subclass-send", "wire-contract", {C: J.WIRECONTRACT_BAD}, 0),
    ("no-handler", "wire-contract", {C: _POKE}, 1),
    ("dead-arm", "wire-contract", {C: WG.replace(
        'elif op == "pull":',
        'elif op == "purge":\n'
        '                    wire.send_msg(self.request, {"ok": True})\n'
        '                elif op == "pull":')}, 1),
    ("retry-on-ok", "wire-contract", {C: WG.replace(
        'wire.send_msg(self.request, {"ok": True}, body)',
        'wire.send_msg(self.request, {"ok": True, "retry": True}, body)')},
     1),
    ("unset-field", "wire-contract", {C: _SHARD}, 1),
    ("dynamic-reply", "wire-contract", {C: _SHARD.replace(
        'wire.send_msg(self.request, {"ok": True}, body)',
        'wire.send_msg(self.request, {"ok": True, **center.stats()}, body)')},
     0),
    ("unrelated-dict", "wire-contract", {C: _SHARD.replace(
        'wire.send_msg(self.request, {"ok": True}, body)',
        'info = {}\n                    info["shard"] = 1\n'
        '                    wire.send_msg(self.request, {"ok": True}, body)')},
     1),
    ("dispatch-missing", "wire-contract",
     {C: WG.replace("_dispatch", "_route")}, 1),
    ("retry-good", "retry-safety", {C: J.RETRY_GOOD}, 0),
    ("retry-bad", "retry-safety", {C: J.RETRY_BAD}, 1),
    ("dup-falls-through", "retry-safety", {C: J.RETRY_GOOD.replace(
        "                        wire.send_msg(self.request,\n"
        "                                      {\"ok\": True, \"dedup\": True})\n"
        "                        return\n", "                        pass\n")},
     1),
    ("lattice-good", "retry-safety", {
        C: J.RETRY_GOOD.replace("center.n_updates += 1", "center.apply(body)"),
        jproto.ASYNC_EASGD_PATH: _LATTICE_STATE}, 0),
    ("lattice-bad", "retry-safety", {
        C: J.RETRY_BAD.replace("center.n_updates += 1", "center.apply(body)"),
        jproto.ASYNC_EASGD_PATH: _LATTICE_STATE}, 1),
    ("lattice-read", "retry-safety", {
        C: J.RETRY_BAD.replace("center.n_updates += 1", "x = center.read()"),
        jproto.ASYNC_EASGD_PATH: _LATTICE_STATE}, 0),
    ("idempotent", "retry-safety", {C: J.RETRY_BAD.replace(
        'if op == "push":', 'if op == "demote":')}, 0),
    ("self-capture", "retry-safety", {C: _SELF_WRITE.format(alias="outer")},
     1),
    ("renamed-capture", "retry-safety", {C: _SELF_WRITE.format(alias="srv")},
     1),
    ("sm-good", "state-machine", {M: J.SM_GOOD}, 0),
    ("sm-no-event", "state-machine", {M: _SM_NO_DEMOTE}, 2),
    ("sm-no-hook", "state-machine", {M: _SM_NO_HOOK}, 1),
    ("sm-vocab", "state-machine", {M: J.SM_GOOD.replace(
        'self._emit("worker_demote", worker',
        'self._emit("worker_demotedz", worker')}, 3),
    ("header-good", "state-machine", {C: _HEADER}, 0),
    ("header-bad", "state-machine", {C: _HEADER.replace(
        'header.get("trace")', 'header["trace"]').replace(
        'header["island"]', 'header.get("shard")')}, 2),
]


def _port_tree(files):
    return {to_port(p): center_to_port(t) if p == C else to_port(t)
            for p, t in files.items()}


def _run(tmp_path, name, lint, files, check):
    root = tmp_path / name
    for rel, text in files.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(text)
    found = lint.run_lint(str(root), paths=sorted(files), only=[check])
    keys = _keys(found, str(root), name == "port")
    # the center's dispatch is named for the port's shape
    return {k[:4] + (k[4].replace("`Handler._dispatch` not found",
                                  "`CenterServer._dispatch` not found"),)
            if k[1] == pproto.CENTER_PATH else k for k in keys}


@pytest.mark.parametrize("name,check,files,n", PROTOCOL_CASES,
                         ids=[c[0] for c in PROTOCOL_CASES])
def test_protocol_fixtures_equal_the_jax_checkers(tmp_path, name, check,
                                                  files, n):
    jax = _run(tmp_path, "jax", jcore, files, check)
    port = _run(tmp_path, "port", pcore, _port_tree(files), check)
    assert port == jax
    assert len(port) == n, sorted(port)


def test_statusz_family_pools_its_dialer(tmp_path):
    """The dialer's ops pool over the statusz-compatible family (the
    port's dialer is any file of its tree; here one in ``tools/``)."""
    fam = {to_port(p): to_port(t) for p, t in J.STATUSZ_FAMILY.items()
           if p != jproto.FLEETZ_PATH}
    dialer = "theanompi_tpu_torch/tools/fleet_probe.py"
    fam[dialer] = to_port(J.STATUSZ_FAMILY[jproto.FLEETZ_PATH])
    for bogus, n in (("", 0), ('\n\ndef bad(addr):\n'
                                '    tracing.statusz_query(addr, "bogus")\n',
                                1)):
        jtree = dict(J.STATUSZ_FAMILY)
        jtree[jproto.FLEETZ_PATH] += bogus
        ptree = dict(fam)
        ptree[dialer] += to_port(bogus)
        jax = _run(tmp_path / f"j{n}", "jax", jcore, jtree, "wire-contract")
        port = _run(tmp_path / f"p{n}", "port", pcore, ptree, "wire-contract")
        assert {k[:2] + k[3:] for k in port} == {
            (k[0], dialer) + k[3:] for k in jax}
        assert len(port) == n


def test_protocol_extraction_units(tmp_path):
    (tmp_path / "srv.py").write_text(J.SYN_SERVER)
    (tmp_path / "cli.py").write_text(J.SYN_CLIENT)
    (tmp_path / "state.py").write_text(
        "class State:\n    def __init__(self):\n        self.n = 0\n"
        "        self.items = {}\n    def read(self):\n        return self.n\n"
        "    def peek(self, k):\n        return self.items.get(k)\n"
        "    def bump(self):\n        self.n += 1\n"
        "    def bump_twice(self):\n        self.bump()\n"
        "    def stash(self, k, v):\n        self.items[k] = v\n"
        "    def retire(self, k):\n        self.items.pop(k)\n")
    (tmp_path / "m.py").write_text("X = 'c'\n")
    files = [pcore.SourceFile(str(tmp_path), f)
             for f in ("srv.py", "cli.py", "state.py", "m.py")]
    index = PIndex(files)
    spec = pproto.EndpointSpec(
        name="syn", server_path="srv.py", dispatch="Srv.handle",
        clients=(pproto.ClientSurface("cli.py", "Cli", ("request",)),))
    assert set(pproto.server_op_table(index, spec)) == {"a", "b", "c"}
    assert set(pproto.client_op_table(index, spec)) == {"a", "b"}
    assert pproto.mutating_methods(index, ("state.State",)) == \
        {"__init__", "bump", "bump_twice", "stash", "retire"}
    import ast

    def fold(src, value):
        return pproto.fold_op_test(ast.parse(src, mode="eval").body, {"op"},
                                   value, files[3], index)

    assert [fold('op == "a"', "a"), fold('op == "a"', "b"),
            fold('op in ("a", "b")', "b"), fold('op not in ("a", "b")', "b"),
            fold('op == "a" and leaves is None', "b"),
            fold('op == "a" and leaves is None', "a"), fold('op == X', "c"),
            fold('other == "a"', "a")] == \
        [True, False, True, False, False, None, True, None]


# -- injections into copies of the port's real files ------------------------

def test_injection_dedup_claim_removed_from_center(tmp_path):
    import shutil
    dst = tmp_path / pproto.ASYNC_EASGD_PATH
    dst.parent.mkdir(parents=True, exist_ok=True)
    shutil.copy(os.path.join(REPO, pproto.ASYNC_EASGD_PATH), dst)
    rel = _inject(tmp_path, pproto.CENTER_PATH,
                  "dup, cached = dedup.check(tok, op)",
                  "dup, cached = False, None")
    found = pcore.run_lint(str(tmp_path), [rel, pproto.ASYNC_EASGD_PATH],
                           only=["retry-safety"])
    msgs = [f.message for f in found]
    assert len(found) == 2, msgs
    assert all("without a dominating DedupWindow claim check" in m
               for m in msgs)
    assert any("op 'push'" in m and "center.push_delta_leaves" in m
               for m in msgs)
    assert any("op 'push_pull'" in m and "center.push_pull_leaves" in m
               for m in msgs)


def test_injection_renamed_center_arm(tmp_path):
    rel = _inject(tmp_path, pproto.CENTER_PATH,
                  'elif op == "readmit":', 'elif op == "readmitz":')
    msgs = [f.message for f in pcore.run_lint(str(tmp_path), [rel],
                                              only=["wire-contract"])]
    assert any("no handler arm" in m and "'readmit'" in m for m in msgs)
    assert any("no in-repo client ever sends" in m and "'readmitz'" in m
               for m in msgs)


def test_injection_transition_without_event(tmp_path):
    rel = _inject(tmp_path, pproto.MEMBERSHIP_PATH,
                  '        self._emit("worker_demote", worker, "on_demote",\n'
                  '                   reason=reason, **info)\n', "")
    msgs = [f.message for f in pcore.run_lint(str(tmp_path), [rel],
                                              only=["state-machine"])]
    assert any("without emitting its declared 'worker_demote'" in m
               for m in msgs), msgs


# -- schema-drift: the live probes -------------------------------------------

def _mod(name):
    return importlib.import_module(f"theanompi_tpu_torch.{name}")


@pytest.fixture(scope="module")
def live():
    return {n.split(".")[-1]: _mod(n) for n in (
        "utils.recorder", "utils.telemetry", "utils.devprof", "utils.sentry",
        "utils.chaos", "utils.tracing", "utils.fleetmon", "utils.numerics",
        "utils.compile_cache", "parallel.membership", "parallel.wire",
        "parallel.center_server")} | {"report": sd.load_report()}


PROBES = {
    "phases": lambda m: sd.live_drift_errors(m["recorder"], m["telemetry"]),
    "device": lambda m: sd.device_schema_errors(
        m["devprof"], m["sentry"], m["telemetry"], m["report"]),
    "membership": lambda m: sd.membership_schema_errors(
        m["membership"], m["chaos"], m["telemetry"], m["report"]),
    "wire": lambda m: sd.wire_schema_errors(
        m["wire"], m["membership"], m["telemetry"], m["report"]),
    "tracing": lambda m: sd.tracing_schema_errors(
        m["tracing"], m["telemetry"], m["report"]),
    "fleetmon": lambda m: sd.fleetmon_schema_errors(
        m["fleetmon"], m["membership"], m["telemetry"], m["report"]),
    "numerics": lambda m: sd.numerics_schema_errors(
        m["numerics"], m["sentry"], m["fleetmon"], m["telemetry"],
        m["report"]),
    "compile-cache": lambda m: sd.compile_cache_schema_errors(
        m["compile_cache"], m["telemetry"]),
    "center": lambda m: sd.center_protocol_errors(m["center_server"]),
    "thread-roles": lambda m: sd.thread_role_coverage_errors(),
}


@pytest.mark.parametrize("probe", sorted(PROBES))
def test_schema_probe_is_clean_on_the_live_port(live, probe):
    assert live["report"] is not None
    assert PROBES[probe](live) == []


def test_schema_probes_fail_on_doctored_modules(live, tmp_path):
    class Rogue:
        SECTIONS = tuple(live["telemetry"].PHASES) + ("rogue",)
        RECORD_KEYS = live["recorder"].RECORD_KEYS
        Recorder = live["recorder"].Recorder

    assert any("SECTIONS" in m for _, m in
               sd.live_drift_errors(Rogue, live["telemetry"]))

    class BlindReport:
        TRACKED_EVENTS = ("phase",)
        TRACE_COMPONENTS = ()

        @staticmethod
        def assemble_traces(events):
            return []

    msgs = [m for _, m in sd.tracing_schema_errors(
        live["tracing"], live["telemetry"], BlindReport)]
    assert any("TRACKED_EVENTS" in m for m in msgs)
    assert any("round(s)" in m for m in msgs)
    assert any("TRACE_COMPONENTS" in m for m in msgs)

    class Stale:
        def __init__(self, mod, **drop):
            self.__dict__.update({k: getattr(mod, k) for k in dir(mod)
                                  if not k.startswith("__")})
            for k in drop:
                del self.__dict__[k]

    # the wire's histogram and gauge vocabulary (missing before the port
    # declared it, ROADMAP C10)
    msgs = [m for _, m in sd.wire_schema_errors(
        Stale(live["wire"], WIRE_HISTS=1, WIRE_GAUGES=1), None,
        live["telemetry"])]
    assert msgs == [
        "WIRE_HISTS is not declared — the wire streams metrics of that "
        "kind with no pinned vocabulary",
        "WIRE_GAUGES is not declared — the wire streams metrics of that "
        "kind with no pinned vocabulary"]

    cc = Stale(live["compile_cache"])
    cc.library_key = lambda source, flags, toolkit: "k"
    assert [m for _, m in sd.compile_cache_schema_errors(
        cc, live["telemetry"])] == [
        "library_key ignores the source, the flags or the toolkit — a "
        "stale library would hit"]

    bad = tmp_path / "theanompi_tpu_torch" / "utils"
    bad.mkdir(parents=True)
    (bad / "chaos.py").write_text(
        "import threading\n"
        "def go(fns):\n"
        "    threading.Thread(target=fns[0], daemon=True).start()\n")
    errors = sd.thread_role_coverage_errors(root=str(tmp_path))
    assert errors and "does not resolve" in errors[0][1]


def test_schema_probes_import_neither_jax_nor_the_jax_package():
    """The probes run in the lint's process: with the cache off (a tree
    hit would skip them) no ``jax`` and nothing of ``theanompi_tpu``
    loads; torch does, through ``center_server``."""
    code = ("import sys\n"
            "from theanompi_tpu_torch.analysis import cli\n"
            "rc = cli.main(['--only', 'schema-drift', '--no-cache'])\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in\n"
            "             ('jax', 'jaxlib', 'theanompi_tpu')),\n"
            "      'torch' in sys.modules)\n"
            "sys.exit(rc)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       env=dict(os.environ, PYTHONPATH=REPO),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.strip().splitlines()[-1] == "[] True"
