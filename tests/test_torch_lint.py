"""The port's lint (``theanompi_tpu_torch/analysis``) against the JAX
package's (``theanompi_tpu/analysis``), and on the port's own tree.

The JAX suite is loaded as ``tests/test_lint.py`` loads it, and its
fixtures are taken from that file: each goes through the JAX checker as
written and through the port's with ``theanompi_tpu`` read as
``theanompi_tpu_torch``, and both must give the same findings (check,
line, column, message).  The port's messages leave out the JAX text's
references to its review history and design document: :data:`WORDING`
lists each difference, and nothing else may differ.  Fixtures stay
inside strings written to ``tmp_path``, so this file stays clean under
the JAX lint, which walks ``tests/``.
"""

import json
import os
import re
import subprocess
import sys

import pytest

from theanompi_tpu.analysis import core as jcore
from theanompi_tpu.analysis.engine import ProgramIndex as JIndex
from theanompi_tpu_torch.analysis import core as pcore
from theanompi_tpu_torch.analysis.checkers import CHECK_GROUPS
from theanompi_tpu_torch.analysis.checkers import oracle_pair as op
from theanompi_tpu_torch.analysis.engine import MAIN_ROLE
from theanompi_tpu_torch.analysis.engine import ProgramIndex as PIndex

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, HERE)
import test_lint as J  # noqa: E402  (the JAX suite's fixtures)

#: JAX message text -> the port's (the port names no review history)
WORDING = (
    ("(the PR-4 class; use RLock", "(use RLock"),
    ("the PR-8 `_stop` collision class; rename",
     "the `_stop` collision class (Thread.join calls it); rename"),
    (" is sanctioned (docs/design.md §16)", " is sanctioned"),
    ("check when disabled, docs/design.md §11)", "check when disabled)"),
)
_PKG = re.compile(r"\btheanompi_tpu\b")


def to_port(text: str) -> str:
    return _PKG.sub("theanompi_tpu_torch", text)


def port_message(jax_message: str) -> str:
    for old, new in WORDING:
        jax_message = jax_message.replace(old, new)
    return to_port(jax_message)


def _keys(findings, root, port):
    """(check, path, line, column from the line's indent, message), the
    JAX message in the port's words.  The column counts from the indent
    so that a fixture re-indented into the port's shape compares."""
    out = set()
    for f in findings:
        with open(os.path.join(root, f.path)) as fh:
            lines = fh.read().splitlines()
        text = lines[f.line - 1] if 0 < f.line <= len(lines) else ""
        indent = len(text) - len(text.lstrip())
        msg = f.message if port else port_message(f.message)
        path = f.path if port else to_port(f.path)
        out.add((f.check, path, f.line, f.col - indent if f.col else 0, msg))
    return out


def run_both(tmp_path, files, check, port_files=None):
    """The JAX lint on ``files`` ({path: text}) and the port's on
    ``port_files`` (default: the same, package names mapped); returns the
    two key sets."""
    port_files = port_files or {to_port(p): to_port(t)
                                for p, t in files.items()}
    sets = []
    for name, lint, tree in (("jax", jcore, files), ("port", pcore,
                                                     port_files)):
        root = tmp_path / name
        for rel, text in tree.items():
            p = root / rel
            p.parent.mkdir(parents=True, exist_ok=True)
            p.write_text(text)
        found = lint.run_lint(str(root), paths=sorted(tree), only=[check])
        sets.append(_keys(found, str(root), name == "port"))
    return sets


# -- the per-file and host-concurrency fixtures of tests/test_lint.py -------

_EARLY = ("from theanompi_tpu.utils import telemetry\n"
          "def hot_loop(n):\n"
          "    tm = telemetry.active()\n"
          "    if not tm.enabled:\n"
          "        return\n"
          "    tm.counter('iters')\n"
          "    tm.observe('n', n)\n")
_ELIF = ("from theanompi_tpu.utils import telemetry\n"
         "def hot_loop(rec):\n"
         "    tm = telemetry.active()\n"
         "    if rec:\n"
         "        pass\n"
         "    elif tm.enabled:\n"
         "        tm.counter('iters')\n")
_OR = ("from theanompi_tpu.utils import telemetry\n"
       "def hot_loop(other):\n"
       "    tm = telemetry.active()\n"
       "    if other or tm.enabled:\n"
       "        tm.counter('iters')\n"
       "    if tm.enabled or other.enabled:\n"
       "        tm.gauge('x', 1)\n")
_NO_EXIT = ("from theanompi_tpu.utils import telemetry\n"
            "def hot_loop(n):\n"
            "    tm = telemetry.active()\n"
            "    if not tm.enabled:\n"
            "        n = 0\n"
            "    tm.counter('iters')\n")
_INIT_WRITES = ("import threading\n"
                "class C:\n"
                "    def __init__(self):\n"
                "        self.flag = False\n"
                "        threading.Thread(target=self._go, daemon=True).start()\n"
                "    def _go(self):\n"
                "        self.flag = True\n")
_OWN_INSTANCE = ("import threading\n"
                 "class Model:\n"
                 "    def compile(self):\n"
                 "        self.train_fn = 1\n"
                 "class Island:\n"
                 "    def start(self):\n"
                 "        self._t = threading.Thread(target=self._run, daemon=True)\n"
                 "        self._t.start()\n"
                 "    def _run(self):\n"
                 "        m = Model()\n"
                 "        m.compile()\n"
                 "    def stop(self):\n"
                 "        self._t.join(timeout=1)\n"
                 "def main_path():\n"
                 "    m = Model()\n"
                 "    m.compile()\n")
_SELF_DEADLOCK = ("import threading\n"
                  "class C:\n"
                  "    def __init__(self):\n"
                  "        self._lock = threading.Lock()\n"
                  "    def outer(self):\n"
                  "        with self._lock:\n"
                  "            self.inner()\n"
                  "    def inner(self):\n"
                  "        with self._lock:\n"
                  "            pass\n")
_SIGNAL_TM = ("import signal\n"
              "from theanompi_tpu.utils import telemetry\n"
              "tm = telemetry.active()\n"
              "def _handler(signum, frame):\n"
              "    tm.event('sig')\n"
              "signal.signal(signal.SIGTERM, _handler)\n")
_ESCAPING = ("import threading\n"
             "class P:\n"
             "    def __init__(self):\n"
             "        self._threads = []\n"
             "    def start(self):\n"
             "        t = threading.Thread(target=self._go, daemon=True)\n"
             "        t.start()\n"
             "        self._threads.append(t)\n"
             "    def _go(self):\n"
             "        pass\n")
_JOINED = _ESCAPING + ("    def stop(self):\n"
                       "        for t in self._threads:\n"
                       "            t.join(timeout=1)\n")
_DAEMON_AFTER = ("import threading\n"
                 "class C:\n"
                 "    def start(self):\n"
                 "        self._t = threading.Thread(target=self._go)\n"
                 "        self._t.daemon = True\n"
                 "        self._t.start()\n"
                 "    def _go(self):\n"
                 "        pass\n"
                 "    def stop(self):\n"
                 "        self._t.join(timeout=1)\n")

# (id, file name, check, fixture, findings the fixture gives)
FILE_CASES = [
    ("tm-bad", "worker.py", "telemetry-hot-path", J.TELEMETRY_BAD, 1),
    ("tm-good", "worker.py", "telemetry-hot-path", J.TELEMETRY_GOOD, 0),
    ("span-bad", "async_easgd.py", "telemetry-hot-path", J.TRACING_BAD, 1),
    ("span-good", "async_easgd.py", "telemetry-hot-path", J.TRACING_GOOD, 0),
    ("emit-bad", "wire.py", "telemetry-hot-path", J.EMIT_BAD, 1),
    ("emit-good", "wire.py", "telemetry-hot-path", J.EMIT_GOOD, 0),
    ("alert-bad", "fleetmon.py", "telemetry-hot-path", J.FLEETMON_BAD, 1),
    ("alert-good", "fleetmon.py", "telemetry-hot-path", J.FLEETMON_GOOD, 0),
    ("not-hot", "report_tool.py", "telemetry-hot-path", J.TELEMETRY_BAD, 0),
    ("early-return", "worker.py", "telemetry-hot-path", _EARLY, 0),
    ("elif", "worker.py", "telemetry-hot-path", _ELIF, 0),
    ("or-guard", "worker.py", "telemetry-hot-path", _OR, 1),
    ("no-exit", "worker.py", "telemetry-hot-path", _NO_EXIT, 1),
    ("race-bad", "bad.py", "shared-state-race", J.RACE_BAD, 2),
    ("race-good", "good.py", "shared-state-race", J.RACE_GOOD, 0),
    ("race-init", "x.py", "shared-state-race", _INIT_WRITES, 0),
    ("race-own", "x.py", "shared-state-race", _OWN_INSTANCE, 0),
    ("order-bad", "bad.py", "lock-ordering", J.LOCK_ORDER_BAD, 1),
    ("order-good", "good.py", "lock-ordering", J.LOCK_ORDER_GOOD, 0),
    ("self-deadlock", "x.py", "lock-ordering", _SELF_DEADLOCK, 2),
    ("rlock", "y.py", "lock-ordering",
     _SELF_DEADLOCK.replace("threading.Lock()", "threading.RLock()"), 0),
    ("signal-bad", "bad.py", "signal-safety", J.SIGNAL_BAD, 3),
    ("signal-good", "good.py", "signal-safety", J.SIGNAL_GOOD, 0),
    ("signal-tm", "x.py", "signal-safety", _SIGNAL_TM, 1),
    ("daemon-bad", "bad.py", "daemon-discipline", J.DAEMON_BAD, 3),
    ("daemon-good", "good.py", "daemon-discipline", J.DAEMON_GOOD, 0),
    ("escaping", "x.py", "daemon-discipline", _ESCAPING, 1),
    ("escaping-joined", "y.py", "daemon-discipline", _JOINED, 0),
    ("daemon-after", "x.py", "daemon-discipline", _DAEMON_AFTER, 0),
    ("groups", "bad.py", "shared-state-race",
     J.RACE_BAD + J.LOCK_ORDER_BAD, 2),
]


@pytest.mark.parametrize("name,fname,check,code,n",
                         FILE_CASES, ids=[c[0] for c in FILE_CASES])
def test_fixture_findings_equal_the_jax_checkers(tmp_path, name, fname,
                                                 check, code, n):
    jax_keys, port_keys = run_both(tmp_path, {fname: code}, check)
    assert port_keys == jax_keys
    assert len(port_keys) == n, sorted(port_keys)


def test_wording_differences_are_the_declared_ones(tmp_path):
    """Every WORDING entry is met by some fixture's JAX message (none is
    stale), so the declared differences are all the differences."""
    seen = set()
    for i, (_, fname, check, code, _) in enumerate(FILE_CASES):
        root = tmp_path / f"w{i}"
        root.mkdir()
        (root / fname).write_text(code)
        for f in jcore.run_lint(str(root), paths=[fname], only=[check]):
            seen |= {old for old, _ in WORDING if old in f.message}
    assert seen == {old for old, _ in WORDING}


def test_sanctioned_signal_hook_is_exempt():
    found = pcore.run_lint(REPO,
                           paths=["theanompi_tpu_torch/utils/telemetry.py"],
                           only=["signal-safety"])
    assert found == [], [f.render() for f in found]


# -- the engine: call graph and thread roles --------------------------------

def _tree_edges(tmp_path, name, lint, Index, files):
    root = tmp_path / name
    for rel, text in files.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(text)
    index = Index(lint.collect_files(str(root), sorted(files)))
    edges = {(r.qualname, c.qualname) for r in index.records.values()
             for c in index.callees(r)}
    roles = {r.qualname: sorted(index.roles_of(r))
             for r in index.records.values()}
    sites = sorted((s.kind, s.path, s.line, s.target_desc,
                    sorted(e.qualname for e in s.entries))
                   for s in index.spawn_sites())
    return edges, roles, sites


def _cross_file_trees():
    """The call-graph trees of tests/test_lint.py's cross-file cases."""
    host = {
        "pkg/__init__.py": "",
        "pkg/clock.py": "import time\ndef stamp():\n    return time.time()\n",
        "pkg/mid.py": ("from .clock import stamp\n"
                       "def helper(x):\n    return x + stamp()\n"),
        "pkg/body.py": ("from jax import lax\nfrom .mid import helper\n"
                        "def build(xs):\n    def body(c, x):\n"
                        "        return helper(c), x\n"
                        "    return lax.scan(body, 0.0, xs)\n"),
    }
    override = {
        "pkg/__init__.py": "",
        "pkg/base.py": (
            "from theanompi_tpu.jax_compat import shard_map\n"
            "class Base:\n"
            "    def build(self, mesh, spec):\n"
            "        return shard_map(self.exchange_body, mesh=mesh,\n"
            "                         in_specs=(spec,), out_specs=spec)\n"
            "    def exchange_body(self, state):\n"
            "        return state\n"),
        "pkg/sub.py": ("import time\nfrom .base import Base\n"
                       "class Sub(Base):\n"
                       "    def exchange_body(self, state):\n"
                       "        t = time.time()\n        return state\n"),
    }
    keys = {
        "pkg/__init__.py": "",
        "pkg/draws.py": ("import jax\ndef draw(key, shape):\n"
                         "    return jax.random.normal(key, shape)\n"),
        "pkg/use.py": ("from .draws import draw\ndef run(key):\n"
                       "    a = draw(key, (4,))\n    b = draw(key, (4,))\n"
                       "    return a + b\n"),
    }
    donate = {
        "pkg/__init__.py": "",
        "pkg/train.py": ("import jax\ndef g(s):\n    return s\n"
                         "step = jax.jit(g, donate_argnums=0)\n"),
        "pkg/use.py": ("from .train import step\ndef run(state):\n"
                       "    out = step(state)\n"
                       "    return out, state['params']\n"),
    }
    return {"host": host, "override": override, "keys": keys,
            "donate": donate}


_LOOP_TARGETS = ("import threading\n"
                 "class P:\n"
                 "    def start(self):\n"
                 "        for fn in (self._a, self._b):\n"
                 "            threading.Thread(target=fn, daemon=True).start()\n"
                 "    def _a(self):\n"
                 "        pass\n"
                 "    def _b(self):\n"
                 "        pass\n")
_CYCLIC = ("import threading\n"
           "def go(fn=None):\n"
           "    fn = fn\n"
           "    a = b = None\n"
           "    a = b\n"
           "    b = a\n"
           "    threading.Thread(target=fn, daemon=True).start()\n"
           "    threading.Thread(target=a, daemon=True).start()\n")

ENGINE_TREES = dict(_cross_file_trees(),
                    roles={"roles.py": J.ENGINE_ROLES},
                    pumps={"pumps.py": _LOOP_TARGETS},
                    cyclic={"cyc.py": _CYCLIC},
                    race={"bad.py": J.RACE_BAD + J.SIGNAL_BAD})


@pytest.mark.parametrize("tree", sorted(ENGINE_TREES))
def test_engine_edges_roles_and_spawns_equal_the_jax_engine(tmp_path, tree):
    files = ENGINE_TREES[tree]
    j = _tree_edges(tmp_path, "jax", jcore, JIndex, files)
    p = _tree_edges(tmp_path, "port", pcore, PIndex,
                    {to_port(k): to_port(v) for k, v in files.items()})

    def norm(x):
        return sorted(json.loads(json.dumps(
            sorted(x) if isinstance(x, set) else x, sort_keys=True)),
            key=json.dumps)

    def mapped(x):
        return norm(json.loads(to_port(json.dumps(
            sorted(x) if isinstance(x, set) else x, sort_keys=True))))

    edges, roles, sites = (norm(x) for x in p)
    assert (edges, roles, sites) == tuple(mapped(x) for x in j)
    assert roles


def test_engine_thread_roles_and_main_exclusion(tmp_path):
    (tmp_path / "roles.py").write_text(J.ENGINE_ROLES)
    index = PIndex([pcore.SourceFile(str(tmp_path), "roles.py")])
    assert {r.kind for r in index.thread_roles()} == \
        {"thread", "thread-subclass", "atexit", "signal"}
    by_qual = {r.qualname: r for r in index.records.values()}
    roles = {q: index.roles_of(r) for q, r in by_qual.items()}
    assert MAIN_ROLE not in roles["roles.Prod._producer"]
    assert MAIN_ROLE not in roles["roles.Prod._helper"]
    assert roles["roles.Prod._producer"] <= roles["roles.Prod._helper"]
    assert MAIN_ROLE in roles["roles.Prod.consume"]


def test_engine_sees_the_ports_exchange_body_family():
    index = PIndex(pcore.collect_files(REPO, ["theanompi_tpu_torch"]))
    recs = index.method_records(
        ("theanompi_tpu_torch.parallel.exchanger", "Exchanger"),
        "exchange_body")
    assert {"Exchanger", "BSP_Exchanger", "EASGD_Exchanger",
            "ASGD_Exchanger"} <= {r.class_name for r in recs}


def test_engine_sees_the_ports_pooled_loads_and_producer_callbacks():
    """The pooled library loads (``_kernel_build.prewarm``'s submit) and
    the prefetch producer's ``add_done_callback`` are executor roles."""
    index = PIndex(pcore.collect_files(REPO, ["theanompi_tpu_torch"]))
    names = {r.name for r in index.thread_roles()}
    assert "executor:theanompi_tpu_torch.ops._kernel_build._load" in names
    assert any(n.startswith("executor:theanompi_tpu_torch.models.data."
                            "prefetch.") for n in names), sorted(names)


def test_engine_resolves_no_method_for_an_imported_function(tmp_path):
    """``hashlib.sha256(...)`` names a function of an imported module: it
    resolves to nothing, not to the one class method of that name."""
    (tmp_path / "m.py").write_text(
        "import hashlib\nclass Log:\n    def sha256(self):\n"
        "        return 1\ndef key(b):\n    return hashlib.sha256(b)\n"
        "def log_key(log):\n    return log.sha256()\n")
    index = PIndex([pcore.SourceFile(str(tmp_path), "m.py")])
    recs = {r.qualname: r for r in index.records.values()}
    assert index.callees(recs["m.key"]) == []
    assert [r.qualname for r in index.callees(recs["m.log_key"])] == \
        ["m.Log.sha256"]


# -- framework: suppression, baseline ---------------------------------------

def test_suppression_baseline_and_parse_error(tmp_path):
    bad = to_port(J.TELEMETRY_BAD)
    (tmp_path / "worker.py").write_text(bad.replace(
        'tm.counter("iters")',
        'tm.counter("iters")  # tpulint: disable=telemetry-hot-path'))
    assert pcore.run_lint(str(tmp_path), ["worker.py"],
                          only=["telemetry-hot-path"]) == []
    (tmp_path / "worker.py").write_text(bad)
    found = pcore.run_lint(str(tmp_path), ["worker.py"],
                           only=["telemetry-hot-path"])
    bl = tmp_path / pcore.BASELINE_NAME
    pcore.save_baseline(str(bl), found)
    entries = pcore.load_baseline(str(bl))
    assert entries[0]["justification"] == "TODO: justify"
    entries[0]["justification"] = "kept: fixture"
    pcore.save_baseline(str(bl), found, entries)
    moved = [dict(e, line=e["line"] + 40) for e in pcore.load_baseline(str(bl))]
    new, matched, stale = pcore.compare_baseline(found, moved)
    assert (new, stale, len(matched)) == ([], [], 1)
    assert moved[0]["justification"] == "kept: fixture"
    (tmp_path / "broken.py").write_text("def f(:\n")
    found = pcore.run_lint(str(tmp_path), ["broken.py"],
                           only=["telemetry-hot-path"])
    assert [f.check for f in found] == ["parse-error"]


# -- oracle-pair, retargeted to the CUDA kernels -----------------------------

ORACLE_MOD = '''
import ctypes
import functools

from . import _kernel_build


def thing_plain(x):
    return x + 1


@functools.lru_cache(maxsize=None)
def _lib():
    return _kernel_build.load("thing")


def _launch(x):
    return _lib().thing(x)


def thing_cuda(x):
    out = _launch(x)
    thing_cuda.launches += 1
    return out


def thing_one(x):
    return thing_cuda(x)


def thing(x):
    return _kernel_build.route("thing", x, thing_plain, thing_cuda)(x)


CUDA_PLAINS = {"thing_cuda": "thing_plain"}
'''

ORACLE_TEST = '''
def test_thing_plain_matches_the_jax_reference():
    assert thing_plain is not None
'''

ORACLE_SMOKE = '''
def kernel_rows():
    return (("thing", ops.thing_cuda, "csrc/thing.cu", "jax:1"),)
'''


def _oracle(tmp_path, mod=ORACLE_MOD, test=ORACLE_TEST, smoke=ORACLE_SMOKE):
    ops = tmp_path / "theanompi_tpu_torch" / "ops"
    ops.mkdir(parents=True)
    (ops / "thing.py").write_text(mod)
    (tmp_path / "tests").mkdir()
    (tmp_path / "tests" / "test_torch_thing.py").write_text(test)
    (tmp_path / "chip_smoke.py").write_text(smoke)
    return [(f.line, f.message) for f in op.oracle_pair_findings(str(tmp_path))]


def test_oracle_pair_good_fixture(tmp_path):
    assert _oracle(tmp_path) == []


ORACLE_BAD = [
    ("unregistered", lambda m, t, s: (m.replace(
        'CUDA_PLAINS = {"thing_cuda": "thing_plain"}', "CUDA_PLAINS = {}"),
        t, s),
     [(21, "kernel wrapper `thing_cuda` has no CUDA_PLAINS entry — its "
           "plain version (the CPU path and the card's reference) is "
           "unpinned")]),
    ("no-registry", lambda m, t, s: (m.replace(
        'CUDA_PLAINS = {"thing_cuda": "thing_plain"}', ""), t, s),
     [(21, "module launches CUDA kernels but declares no pure-literal "
           "CUDA_PLAINS dict mapping each kernel wrapper to its plain "
           "version")]),
    ("untested", lambda m, t, s: (m, "def test_x():\n    pass\n", s),
     [(35, "no tests/test_torch_*.py file names `thing_plain` — the plain "
           "version of `thing_cuda` is not held to the JAX reference on the "
           "CPU")]),
    ("not-compared", lambda m, t, s: (m, t, s.replace("ops.thing_cuda",
                                                      "None")),
     [(21, "kernel wrapper `thing_cuda` is not in chip_smoke.py's "
           "kernel_rows() — the kernel is never held to `thing_plain` on "
           "the card")]),
    ("stale", lambda m, t, s: (m.replace(
        '{"thing_cuda": "thing_plain"}',
        '{"thing_cuda": "thing_plain", "gone_cuda": "thing_plain"}'), t, s),
     [(35, "CUDA_PLAINS entry `gone_cuda` names no function launching a "
           "CUDA kernel in this module — stale registry entry")]),
    ("plain-missing", lambda m, t, s: (m.replace(
        '"thing_plain"}', '"other_plain"}'), t, s),
     [(35, "CUDA_PLAINS maps `thing_cuda` to `other_plain`, which is not "
           "defined in this module")]),
    ("blind-route", lambda m, t, s: (m.replace(
        'thing_plain, thing_cuda)(x)', 'thing_plain, _pick(x))(x)') +
        "\n\ndef _pick(x):\n    return globals()['thing_cuda']\n", t, s),
     [(32, "_kernel_build.route hands CUDA tensors to `<expression>`, which "
           "reaches no kernel wrapper this checker can see — that path "
           "escapes the plain/test/card triple")]),
]


@pytest.mark.parametrize("name,edit,want", ORACLE_BAD,
                         ids=[c[0] for c in ORACLE_BAD])
def test_oracle_pair_bad_fixtures(tmp_path, name, edit, want):
    assert _oracle(tmp_path, *edit(ORACLE_MOD, ORACLE_TEST,
                                   ORACLE_SMOKE)) == want


def test_oracle_pair_dispatchers_reach_compared_rows():
    """``matmul_pack_cuda`` is a pass of one leaf through the grouped B9
    wrapper, and the flash dispatchers pick B10–B12 of the tensor's dtype:
    each reaches only wrappers ``kernel_rows()`` compares."""
    from theanompi_tpu_torch.analysis.core import SourceFile
    rows = op.compared_names(REPO)
    for rel, dispatchers in (
            ("theanompi_tpu_torch/ops/factor_pack.py",
             ("matmul_pack_cuda", "matmul_pack")),
            ("theanompi_tpu_torch/ops/flash_attention.py",
             ("_fwd_cuda", "_bwd_cuda"))):
        km = op.KernelModule(SourceFile(REPO, rel))
        assert km.wrappers == set(km.registry()[0])
        for d in dispatchers:
            reached = km.reaches(d) & km.wrappers
            assert reached and d not in km.wrappers, (d, reached)
            assert reached <= rows, reached
    fp = op.KernelModule(SourceFile(
        REPO, "theanompi_tpu_torch/ops/factor_pack.py"))
    assert fp.wrappers == {"matmul_pack_group_cuda"}


# -- injections into copies of the port's real files ------------------------

def _inject(tmp_path, rel, old, new):
    with open(os.path.join(REPO, rel)) as f:
        src = f.read()
    assert old in src, f"{rel} changed shape; update the injection"
    p = tmp_path / rel
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(src.replace(old, new, 1))
    return rel


def test_injection_unguarded_record_in_steps(tmp_path):
    rel = _inject(tmp_path, "theanompi_tpu_torch/parallel/steps.py",
                  "    def _numerics_step(self) -> None:\n",
                  "    def _numerics_step(self) -> None:\n"
                  "        numerics.record(self.telemetry, {}, rank=0)\n")
    found = pcore.run_lint(str(tmp_path), [rel], only=["telemetry-hot-path"])
    assert [f.message for f in found] == [
        "unguarded telemetry call `numerics.record(...)` on a hot path — "
        "wrap in `if <handle>.enabled:` (one attribute check when "
        "disabled)"]


def test_injection_stored_unjoined_thread_in_prefetch(tmp_path):
    rel = _inject(tmp_path, "theanompi_tpu_torch/models/data/prefetch.py",
                  "        self._thread.start()\n",
                  "        self._thread.start()\n"
                  "        self._ghost = threading.Thread(\n"
                  "            target=self._shutdown, daemon=True)\n"
                  "        self._ghost.start()\n")
    found = pcore.run_lint(str(tmp_path), [rel], only=["daemon-discipline"])
    assert [f.message for f in found] == [
        "Thread stored on `self._ghost` is start()ed but never joined — it "
        "can outlive stop(); add a bounded join (join(timeout=...)) on the "
        "shutdown path"]


def test_injection_entry_removed_from_lrn_plains(tmp_path):
    import shutil
    rel = _inject(tmp_path, "theanompi_tpu_torch/ops/lrn.py",
                  '"lrn_bwd_cuda": "lrn_bwd_plain"', "")
    (tmp_path / "tests").mkdir()
    shutil.copy(os.path.join(HERE, "test_torch_lrn.py"), tmp_path / "tests")
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    found = op.oracle_pair_findings(str(tmp_path))
    assert [(f.path, f.message) for f in found] == [
        (rel, "kernel wrapper `lrn_bwd_cuda` has no CUDA_PLAINS entry — its "
              "plain version (the CPU path and the card's reference) is "
              "unpinned")]


# -- the gate, the CLI and the cache ------------------------------------------

_NO_JAX_RUN = (
    "import runpy, sys\n"
    "sys.argv = ['lint'] + sys.argv[1:]\n"
    "try:\n"
    "    runpy.run_module('theanompi_tpu_torch.tools.lint',\n"
    "                     run_name='__main__')\n"
    "    rc = 0\n"
    "except SystemExit as e:\n"
    "    rc = e.code\n"
    "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
    "             ('jax', 'jaxlib', 'theanompi_tpu'))\n"
    "print('IMPORTED', bad, file=sys.stderr)\n"
    "sys.exit(3 if bad else rc)\n")


def _lint(*args, root=None):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run(
        [sys.executable, "-m", "theanompi_tpu_torch.tools.lint",
         *(["--root", str(root)] if root else []), *args],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)


def test_gate_is_clean_without_jax_and_hits_its_cache(tmp_path):
    """``--check-baseline`` on the repo exits 0 in a process that never
    imports ``jax`` or the JAX package; the second run is a tree hit."""
    env = dict(os.environ, PYTHONPATH=REPO)
    runs = []
    for _ in range(2):
        r = subprocess.run(
            [sys.executable, "-c", _NO_JAX_RUN, "--check-baseline",
             "--format", "json", "--cache-dir", str(tmp_path / "cache")],
            cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
        assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
        assert "IMPORTED []" in r.stderr
        runs.append(json.loads(r.stdout))
    assert [r["cache"] for r in runs] == ["miss", "hit"]
    assert runs[0]["findings"] == runs[1]["findings"] == []
    assert runs[0]["baselined"] == 0 and runs[0]["stale_baseline"] == []


def test_committed_baseline_is_empty():
    with open(os.path.join(REPO, pcore.BASELINE_NAME)) as f:
        assert json.load(f) == {"entries": [], "version": 1}


def test_cli_list_checks_names_the_ten_checks():
    """The ten host-side checks and the eleven of the dataflow half, then
    every JAX check beside its port counterpart; a JAX name is an alias
    for ``--only``."""
    r = _lint("--list-checks")
    assert r.returncode == 0
    checks, _, mapping = r.stdout.partition("\n\n")
    names = [ln.split(":")[0] for ln in checks.splitlines()]
    assert names == sorted([
        "shared-state-race", "lock-ordering", "signal-safety",
        "daemon-discipline", "wire-contract", "retry-safety",
        "state-machine", "telemetry-hot-path", "schema-drift",
        "oracle-pair",
        "collective-discipline", "exchange-symmetry", "rng-discipline",
        "capture-purity", "cache-key", "graph-key", "dtype-flow",
        "static-alias", "shard-rebuild-dominance", "group-schema",
        "package-boundary"])
    assert set(CHECK_GROUPS) == {"concurrency", "protocol", "spmd",
                                 "compile-surface"}
    from theanompi_tpu.analysis.core import CHECKERS as JCHECKERS
    pairs = dict(ln.strip().split(" -> ")
                 for ln in mapping.splitlines()[1:] if " -> " in ln)
    assert set(pairs) == set(JCHECKERS)
    assert set(pairs.values()) == set(names)
    assert pairs["trace-purity"] == "capture-purity"
    assert pairs["retrace-hazard"] == "graph-key"
    r = _lint("--only", "trace-purity", "--format", "json", "--no-cache",
              "chip_smoke.py")
    assert r.returncode == 0 and "capture-purity" in \
        json.loads(r.stdout)["cpu_seconds"]


def test_cli_exit_codes(tmp_path):
    """A new finding exits 1; a stale entry warns, and fails only under
    ``--check-baseline``; a bad path, an unknown check and a partial
    ``--update-baseline`` exit 2; json carries the fingerprints and the
    cache status; a change of content misses."""
    (tmp_path / "worker.py").write_text(to_port(J.TELEMETRY_BAD))
    r = _lint("worker.py", "--only", "telemetry-hot-path", root=tmp_path)
    assert r.returncode == 1 and "telemetry-hot-path" in r.stdout
    out = json.loads(_lint("worker.py", "--format", "json", "--only",
                           "telemetry-hot-path", root=tmp_path).stdout)
    assert out["cache"] == "hit" and len(out["new"][0]["fingerprint"]) == 12
    (tmp_path / "worker.py").write_text("x = 1\n")
    out = json.loads(_lint("worker.py", "--format", "json", "--only",
                           "telemetry-hot-path", root=tmp_path).stdout)
    assert out["cache"] == "miss" and out["findings"] == []
    sarif = json.loads(_lint("worker.py", "--format", "sarif", "--only",
                             "concurrency", root=tmp_path).stdout)
    assert sarif["version"] == "2.1.0"
    (tmp_path / pcore.BASELINE_NAME).write_text(json.dumps({
        "version": 1, "entries": [{
            "check": "lock-ordering", "path": "gone.py", "line": 1,
            "message": "lock-order cycle", "justification": "stale"}]}))
    r = _lint("--only", "concurrency", root=tmp_path)
    assert r.returncode == 0
    r = _lint("--check-baseline", "--disable", "schema-drift,oracle-pair",
              root=tmp_path)
    assert r.returncode == 0                    # partial: nothing is stale
    r = _lint("--check-baseline", "--no-cache", root=tmp_path)
    assert r.returncode == 1 and "stale baseline entry" in r.stderr
    assert _lint("no_such.py", root=tmp_path).returncode == 2
    assert _lint("--only", "no-such-check").returncode == 2
    r = _lint("worker.py", "--update-baseline", root=tmp_path)
    assert r.returncode == 2 and "full run" in r.stderr


@pytest.mark.parametrize("check", [
    "telemetry-hot-path", "concurrency", "protocol", "oracle-pair"])
def test_port_tree_is_clean(check):
    """The repairs this lint found stay repaired (ROADMAP §C): the
    numerics record in ``worker.py`` behind its guard, the compile cache's
    counters and manifest under a lock, ``_kernel_build``'s cache set
    under its lock, every kernel wrapper registered and compared."""
    from theanompi_tpu_torch.analysis.cli import _split
    found = pcore.run_lint(REPO, only=_split(check))
    assert found == [], [f.render() for f in found]


def test_compile_cache_manifest_keeps_every_parallel_entry(tmp_path):
    """The lint's shared-state-race finding on ``CompileCache`` (ROADMAP
    C11): libraries load on a pool's threads, and the manifest's
    read-modify-write lost entries (5–9 of 200 kept before the lock).
    More threads than cores, with a short switch interval."""
    import threading

    from theanompi_tpu_torch.utils import compile_cache as cc
    cache = cc.CompileCache(str(tmp_path))
    n = 2 * (os.cpu_count() or 4)
    start = threading.Barrier(n)

    def load(i):
        start.wait(timeout=30)
        for j in range(10):
            cache._record_manifest(f"k{i}_{j}", "lrn", "V", 1.0, 10)
            cache._tick("hits")

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=load, args=(i,), daemon=True)
                   for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert len(cache.load_manifest()) == 10 * n
    assert cache.counters["hits"] == 10 * n


def _git(cwd, *args):
    return subprocess.run(
        ["git", "-c", "user.email=t@t", "-c", "user.name=t", *args],
        cwd=str(cwd), capture_output=True, text=True, timeout=60)


def test_cli_diff_mode(tmp_path):
    """``--diff REF`` lints the changed files of the lint's paths only;
    ``CACHED`` is the staged index; the guard rails exit 2."""
    assert _git(tmp_path, "init", "-q").returncode == 0
    d = tmp_path / "theanompi_tpu_torch"
    d.mkdir()
    (d / "worker.py").write_text("x = 1\n")
    (tmp_path / "outside.py").write_text("x = 1\n")
    _git(tmp_path, "add", "-A")
    assert _git(tmp_path, "commit", "-qm", "init").returncode == 0
    only = ("--only", "telemetry-hot-path")
    r = _lint("--diff", "HEAD", *only, root=tmp_path)
    assert r.returncode == 0 and "no changed python files" in r.stdout
    (d / "worker.py").write_text(to_port(J.TELEMETRY_BAD))
    (tmp_path / "outside.py").write_text(to_port(J.TELEMETRY_BAD))
    r = _lint("--diff", "HEAD", "--format", "json", *only, root=tmp_path)
    assert r.returncode == 1
    assert {f["path"] for f in json.loads(r.stdout)["findings"]} == \
        {"theanompi_tpu_torch/worker.py"}
    r = _lint("--diff", "CACHED", *only, root=tmp_path)
    assert r.returncode == 0 and "no changed python files" in r.stdout
    _git(tmp_path, "add", "-A")
    assert _lint("--diff", "CACHED", *only, root=tmp_path).returncode == 1
    r = _lint("--diff", "HEAD", "theanompi_tpu_torch/worker.py",
              root=tmp_path)
    assert r.returncode == 2 and "mutually exclusive" in r.stderr
    assert _lint("--diff", "NOSUCHREF", root=tmp_path).returncode == 2
    r = _lint("--diff", "HEAD", "--update-baseline", root=tmp_path)
    assert r.returncode == 2 and "--diff" in r.stderr
