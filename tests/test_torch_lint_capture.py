"""The port's lint, what a CUDA graph captures and what builds it:
capture-purity, rng-discipline, graph-key, static-alias, dtype-flow,
cache-key and package-boundary (``theanompi_tpu_torch/analysis``).

Each JAX fixture of these checks in ``tests/test_lint.py`` has a torch
twin here: the same bug in the port's idiom, line for line, so that the
JAX checker on the JAX fixture and the port's checker on the twin find
the same count at the same lines.  Where no twin can exist (the port
donates no buffer) the case says so, and the port has fixtures of its
own.  Then: the engine's capture reach, the port's tree clean under each
check, one injection per check into a copy of a real port file, found at
its line, and the faults these checks found (ROADMAP §C15–C17), each
held by a test that fails on the code before its repair.  Fixtures stay
in strings written to ``tmp_path``.
"""

import os
import sys
import types

import pytest
import torch

from theanompi_tpu.analysis import core as jcore
from theanompi_tpu_torch.analysis import core as pcore
from theanompi_tpu_torch.analysis.checkers import capture_purity as cp
from theanompi_tpu_torch.analysis.engine import ProgramIndex

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, HERE)
import test_lint as J  # noqa: E402  (the JAX suite's fixtures)

CHECKS = ("capture-purity", "rng-discipline", "graph-key", "static-alias",
          "dtype-flow", "cache-key", "package-boundary")


def _lines(lint, root, name, code, check):
    """The sorted lines of ``check``'s findings on one fixture file."""
    p = root / name
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(code)
    return sorted(f.line for f in lint.run_lint(str(root), paths=[name],
                                                only=[check]))


# -- the torch twins of the JAX fixtures -------------------------------------

TRACE_BAD = """
import time
import numpy as np
import torch
from theanompi_tpu_torch.parallel.graph import StepGraph

def build(model, x, stream):
    def body():
        t = time.time()
        carry = x + np.random.rand()
        print("mid-capture")
        if carry.sum():
            carry = carry + x.item()
        return carry, x.cpu()
    return StepGraph(stream).capture(body)
"""

TRACE_GOOD = """
import time
import numpy as np
import torch
from theanompi_tpu_torch.parallel.graph import StepGraph

def host_loop(model, x, stream):
    # host side: clocks, NumPy draws and prints are all fine here
    t = time.time()
    noise = np.random.rand()
    print("host", t)

    def body():
        return torch.where(x.sum() > 0, x + 1.0, x), x
    out = StepGraph(stream).capture(body)
    return out, noise, time.time() - t
"""

RNG_BAD = """
import torch

def draw(seed):
    a = torch.randn(4, generator=torch.Generator().manual_seed(seed))
    b = torch.rand(4, generator=torch.Generator().manual_seed(seed))
    return a + b
"""

RNG_GOOD = """
import torch
from theanompi_tpu_torch.parallel.steps import step_seed

def draw(seed, count):
    gen = torch.Generator().manual_seed(seed)
    a = torch.randn(4, generator=gen)
    # a stream of its own per distinct step_seed tuple (fold_in's role)
    b = torch.rand(4, generator=torch.Generator().manual_seed(step_seed(seed, 1)))
    c = torch.randn(4, generator=torch.Generator().manual_seed(step_seed(seed, 2)))
    for i in range(3):
        step = step_seed(seed, count + i)
        a = a + torch.randn(4, generator=torch.Generator().manual_seed(step))
    return a + b + c
"""

RNG_BAD_LOOP = """
import torch

def draw(seed, n):
    out = 0.0
    for i in range(n):
        out = out + torch.randn((), generator=torch.Generator().manual_seed(seed))
    return out
"""

CACHEKEY_BAD = """
import os

def _nvcc(src, out, flags):
    extra = os.environ.get("NVCC_EXTRA", "")
    cmd = ["nvcc", *flags, extra, "-o", out, src]
    return cmd


def library_key(src, flags):
    return hash((src, tuple(flags)))
"""

CACHEKEY_GOOD = """
import os

def _nvcc(src, out, flags):
    n = tuple(flags)
    cmd = ["nvcc", *n, "-o", out, src]
    probe = os.environ.get("NVCC_PROBE", "")  # tpulint: disable=cache-key
    cmd2 = ["nvcc", probe, "-o", out, src]
    return cmd, cmd2


def library_key(src, flags):
    return hash((src, tuple(flags)))
"""

# retrace-hazard's five call shapes have no CUDA-graph counterpart (jit
# caches by function identity, a CUDA graph by its key); the twin holds
# the same bug class at the same lines — a host value shaping what is
# recorded: a branch, a size, a slice bound, a reshape, a host clock
RETRACE_BAD = """
import time
import torch
from theanompi_tpu_torch.parallel.graph import StepGraph

class Step:
    def body(self, x):
        y = x * 2
        # each host value below shapes what the capture records
        if self.on:
            y = y + 1
        for i in range(2):
            y = y + torch.zeros(self.k)
        y = y.sum()
        y = x[:self.m] * y
        return self.more(y)

    def more(self, y): return self.last(y.reshape(self.rows, -1))

    def last(self, y):
        # the graph keeps the capture's clock, which is in no key
        t = 0

        return y + torch.arange(int(time.time()) % 128)

    def __init__(self, n):
        self.on, self.k, self.m, self.rows = True, n, n, 1

    def toggle(self):
        self.on, self.k, self.m, self.rows = False, 2, 1, 2


def run(step, x, stream):
    return StepGraph(stream).capture(lambda: step.body(x))
"""

RETRACE_GOOD = """
import torch
from theanompi_tpu_torch.parallel.graph import StepGraph

class Step:
    def __init__(self, n):
        self.n = n

    def body(self, x):
        return x + torch.zeros(self.n)


def run(step, x, stream):
    return StepGraph(stream).capture(lambda: step.body(x))
"""

DTYPE_BAD = """
import torch
import torch.distributed as dist

def all_reduce(g, group, bias):
    w = g.to(torch.bfloat16); dist.all_reduce(w, group=group); total = w + bias
    r = g.to(torch.bfloat16); dist.all_reduce(r, group=group)
    out = r + bias
    return total, out

def bucketed(packed, group):
    flat = packed.to(torch.bfloat16)
    outs = [dist.all_reduce(b, group=group) for b in flat]
    return outs

def roundtrip(g, wd):
    return g.to(wd).to(torch.float32)
"""

DTYPE_GOOD = """
import torch
import torch.distributed as dist

NONBITEXACT = {
    "wire_round": "owned chunk rounds to the wire dtype so every rank "
                  "holds the identical bit pattern",
}

def all_reduce(g, group, bias):
    w = g.to(torch.bfloat16); dist.all_reduce(w, group=group); total = w.to(g.dtype) + bias
    r = g.to(torch.bfloat16); dist.all_reduce(r, group=group)
    r = r.to(torch.float32)
    return total, r + bias

def bucketed(buckets, group):
    outs = []
    for b in buckets:
        w = b.to(torch.bfloat16); dist.all_reduce(w, group=group); outs.append(w.float())
    return outs

def wire_round(g, wd):
    return g.to(wd).to(torch.float32)
"""

COMPAT_BAD = """
import importlib
import sys
from theanompi_tpu.parallel import exchanger

def build(f):
    g = importlib.import_module("jax.numpy")
    h = sys.path.insert(0, "../theanompi_tpu")
    return exchanger, g, h
"""

COMPAT_GOOD = """
import torch
from theanompi_tpu_torch.parallel import exchanger

def build(f):
    return exchanger.get_exchanger("bsp"), torch.float32, f
"""

# (id, JAX fixture, JAX check, torch twin, port check)
TWINS = [
    ("trace-bad", J.TRACE_BAD, "trace-purity", TRACE_BAD, "capture-purity"),
    ("trace-good", J.TRACE_GOOD, "trace-purity", TRACE_GOOD,
     "capture-purity"),
    ("rng-bad", J.RNG_BAD, "rng-discipline", RNG_BAD, "rng-discipline"),
    ("rng-good", J.RNG_GOOD, "rng-discipline", RNG_GOOD, "rng-discipline"),
    ("rng-bad-loop", J.RNG_BAD_LOOP, "rng-discipline", RNG_BAD_LOOP,
     "rng-discipline"),
    ("cachekey-bad", J.CACHEKEY_BAD, "cache-key", CACHEKEY_BAD, "cache-key"),
    ("cachekey-good", J.CACHEKEY_GOOD, "cache-key", CACHEKEY_GOOD,
     "cache-key"),
    ("retrace-bad", J.RETRACE_BAD, "retrace-hazard", RETRACE_BAD,
     "graph-key"),
    ("retrace-good", J.RETRACE_GOOD, "retrace-hazard", RETRACE_GOOD,
     "graph-key"),
    ("dtype-bad", J.DTYPE_BAD, "dtype-flow", DTYPE_BAD, "dtype-flow"),
    ("dtype-good", J.DTYPE_GOOD, "dtype-flow", DTYPE_GOOD, "dtype-flow"),
    ("compat-bad", J.COMPAT_BAD, "compat-boundary", COMPAT_BAD,
     "package-boundary"),
    ("compat-good", J.COMPAT_GOOD, "compat-boundary", COMPAT_GOOD,
     "package-boundary"),
]


@pytest.mark.parametrize("jax_code,jax_check,twin,check",
                         [t[1:] for t in TWINS], ids=[t[0] for t in TWINS])
def test_twin_finds_what_the_jax_checker_finds(tmp_path, jax_code,
                                               jax_check, twin, check):
    """The JAX checker on the JAX fixture and the port's on its twin: the
    same count of findings at the same lines."""
    want = _lines(jcore, tmp_path / "jax", "x.py", jax_code, jax_check)
    got = _lines(pcore, tmp_path / "port", "x.py", twin, check)
    assert got == want


def test_twin_messages_name_each_bug(tmp_path):
    """The twins' findings say what they found."""
    def msgs(code, check):
        (tmp_path / "x.py").write_text(code)
        return " | ".join(f.message for f in pcore.run_lint(
            str(tmp_path), paths=["x.py"], only=[check]))

    m = msgs(TRACE_BAD, "capture-purity")
    for part in ("time.time", "numpy.random", "print", "Python `if`",
                 ".item()", ".cpu()"):
        assert part in m, (part, m)
    assert "spent again" in msgs(RNG_BAD, "rng-discipline")
    assert "NVCC_EXTRA" in msgs(CACHEKEY_BAD, "cache-key")
    m = msgs(RETRACE_BAD, "graph-key")
    for part in ("self.on", "self.k", "self.m", "self.rows", "time.time"):
        assert part in m, (part, m)
    m = msgs(DTYPE_BAD, "dtype-flow")
    assert "`w` used" in m and "`r` used" in m and "BEFORE bucketing" in m
    assert "round-trip in `roundtrip`" in m
    m = msgs(COMPAT_BAD, "package-boundary")
    assert "theanompi_tpu.parallel" in m and "jax.numpy" in m and \
        "sys.path" in m


# -- the port's own fixtures where no twin can exist -------------------------

# donation-safety's fixtures (DONATION_BAD/GOOD) donate a buffer to a jit:
# torch donates nothing.  static-alias holds its counterpart, a captured
# graph's output kept past the replay that rewrites it.
ALIAS_BAD = """
from theanompi_tpu_torch.parallel.graph import StepGraph

def steps(stream, fn, n):
    g = StepGraph(stream)
    out = g.capture(fn)
    kept = []
    for _ in range(n):
        g.replay()
        kept.append(out)
    g.replay()
    return out, kept
"""

ALIAS_GOOD = ALIAS_BAD.replace("kept.append(out)", "kept.append(out.clone())") \
    .replace("return out, kept", "return out.clone(), kept")


def test_static_alias_fixtures(tmp_path):
    assert _lines(pcore, tmp_path, "x.py", ALIAS_BAD, "static-alias") == \
        [10, 12]
    assert _lines(pcore, tmp_path, "y.py", ALIAS_GOOD, "static-alias") == []


def test_static_alias_sees_graph_blocks_and_unpacked_outputs(tmp_path):
    """A name bound inside a ``torch.cuda.graph`` block is an output too;
    a replay in one arm counts only there."""
    code = ("import torch\n"
            "def run(g, f, x, cond):\n"
            "    with torch.cuda.graph(g):\n"
            "        y = f(x)\n"
            "    if cond:\n"
            "        g.replay()\n"
            "        return y.view(-1)\n"
            "    return y\n")
    assert _lines(pcore, tmp_path, "x.py", code, "static-alias") == [7]


def test_package_boundary_function_local_and_dunder_import(tmp_path):
    code = ("def f():\n"
            "    import jaxlib\n"
            "    return __import__('theanompi_tpu.utils')\n"
            "from theanompi_tpu_torch import base\n")
    assert _lines(pcore, tmp_path, "x.py", code, "package-boundary") == \
        [2, 3]


def test_rng_library_draws_tags_and_global_seeding(tmp_path):
    """A draw without generator= and global seeding in library code; two
    streams under one step_seed tag."""
    code = ("import numpy as np\n"
            "import torch\n"
            "from theanompi_tpu_torch.parallel.steps import step_seed\n"
            "TAG = 7\n"
            "def a(g, n):\n"
            "    g.manual_seed(step_seed(TAG, n))\n"
            "    return torch.rand(3)\n"
            "def b(g, n):\n"
            "    torch.manual_seed(0)\n"
            "    np.random.seed(0)\n"
            "    return g.manual_seed(step_seed(7, n))\n")
    assert _lines(pcore, tmp_path, "x.py", code, "rng-discipline") == \
        [7, 9, 10, 11]
    assert _lines(pcore, tmp_path / "t", "tests/x.py", code.replace(
        "step_seed(7, n)", "step_seed(8, n)"), "rng-discipline") == []


# -- the engine's capture reach ------------------------------------------------

@pytest.fixture(scope="module")
def tree():
    """One parse and index of the port's tree, and one run of this file's
    checks over it."""
    files = pcore.collect_files(REPO)
    index = ProgramIndex(files)
    found = pcore.run_lint(REPO, only=list(CHECKS))
    return index, found


def test_capture_seeds_reach_the_step_the_exchanges_and_the_wires(tree):
    index, _ = tree
    seeds, _ = cp.capture_seeds(index)
    reach = {r.qualname.split("theanompi_tpu_torch.", 1)[-1]
             for r in cp.capture_reach(index, seeds)}
    want = {"parallel.steps.TrainStep._body",
            "parallel.steps._accumulate_grads",
            "parallel.exchanger.Exchanger.exchange_body",
            "parallel.exchanger.BSP_Exchanger.exchange_body",
            "parallel.exchanger.EASGD_Exchanger.exchange_body",
            "parallel.exchanger.ASGD_Exchanger.exchange_body",
            "parallel.exchanger.GOSGD_Exchanger.exchange_body",
            "parallel.strategies.AllReduce.__call__",
            "parallel.strategies.Ring.__call__",
            "parallel.strategies.OneBit.__call__",
            "parallel.strategies.TopK.__call__",
            "parallel.strategies.PowerSGD.__call__",
            "models.model_base.ModelBase.loss_and_metrics",
            "models.layers.Dropout.apply",
            "utils.numerics.GraphPlan.compute"}
    assert want <= reach, sorted(want - reach)


def test_gosgd_route_is_read_out_of_the_reach(tree):
    """GoSGD refuses capture at world > 1 (``check_capture``): what follows
    ``rounds``' world-1 return is left out, read from the code."""
    index, _ = tree
    key = index.class_key(
        "theanompi_tpu_torch.parallel.exchanger.GOSGD_Exchanger")
    assert cp.world1_only(index, key)
    rec = index.by_qualname[
        "theanompi_tpu_torch.parallel.exchanger.GOSGD_Exchanger.rounds"][0]
    live = cp.live_body(index, rec)
    assert not any(isinstance(n, __import__("ast").Call) and
                   "RandomState" in __import__("ast").unparse(n.func)
                   for n in live)


@pytest.mark.parametrize("check", CHECKS)
def test_port_tree_is_clean(tree, check):
    found = [f for f in tree[1] if f.check == check]
    assert found == [], [f.render() for f in found]


# -- one injection per check into a copy of a real port file -----------------

def _inject(tmp_path, rel, old, new, extra=()):
    src = open(os.path.join(REPO, rel)).read()
    assert src.count(old) == 1, f"{rel} changed shape; update the injection"
    out = src.replace(old, new)
    p = tmp_path / rel
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(out)
    for e in extra:
        q = tmp_path / e
        q.parent.mkdir(parents=True, exist_ok=True)
        q.write_text(open(os.path.join(REPO, e)).read())
    line = out[:out.index(new)].count("\n") + 1 + \
        next(i for i, ln in enumerate(new.splitlines()) if "INJECTED" in ln)
    return rel, line


INJECTIONS = [
    ("capture-purity", "theanompi_tpu_torch/parallel/steps.py",
     "        out = torch.stack(costs + errs)\n",
     "        out = torch.stack(costs + errs)\n"
     "        probe = out.sum().item()  # INJECTED\n", ()),
    ("graph-key", "theanompi_tpu_torch/parallel/steps.py",
     "            self.exchanger.sync_bn(m.bn_state)\n",
     "            if not m.config.get('skip_sync_bn'):  # INJECTED\n"
     "                self.exchanger.sync_bn(m.bn_state)\n", ()),
    ("dtype-flow", "theanompi_tpu_torch/parallel/strategies.py",
     "                dist.all_reduce(w)\n",
     "                dist.all_reduce(w)\n"
     "                w.mul_(inv)  # INJECTED\n", ()),
    ("cache-key", "theanompi_tpu_torch/ops/_kernel_build.py",
     '        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,\n',
     '        cmd = [nvcc_path(), *NVCC_FLAGS, "-lineinfo",  # INJECTED\n'
     '               "-o", tmp,\n', ()),
    ("package-boundary", "theanompi_tpu_torch/parallel/steps.py",
     '    s = np.random.SeedSequence([int(k) for k in keys])\n',
     '    import jax  # noqa: F401  INJECTED\n'
     '    s = np.random.SeedSequence([int(k) for k in keys])\n', ()),
    ("rng-discipline", "theanompi_tpu_torch/models/layers.py",
     "        mask = torch.rand(x.shape, generator=gen, device=x.device) "
     "< keep\n",
     "        mask = torch.rand(x.shape, device=x.device) < keep  # INJECTED\n",
     ()),
    ("static-alias", "theanompi_tpu_torch/parallel/steps.py",
     "            return None if out is None else out.clone()\n",
     "            return out  # INJECTED\n", ()),
]


@pytest.mark.parametrize("check,rel,old,new,extra", INJECTIONS,
                         ids=[i[0] for i in INJECTIONS])
def test_injection_is_found_at_its_line(tmp_path, check, rel, old, new,
                                        extra):
    rel, line = _inject(tmp_path, rel, old, new, extra)
    clean = pcore.run_lint(REPO, paths=[rel], only=[check])
    assert clean == [], [f.render() for f in clean]
    found = pcore.run_lint(str(tmp_path), paths=[rel], only=[check])
    assert [f.line for f in found] == [line], [f.render() for f in found]


# -- the faults these checks found (ROADMAP §C15–C17) --------------------------

class _OneRankGroup:
    """A process group of one rank: its all-reduce is the identity."""

    def allreduce(self, tensors, opts):
        return types.SimpleNamespace(wait=lambda: True)

    def size(self):
        return 1


def _split_model():
    grid = types.SimpleNamespace(group=lambda axis: _OneRankGroup())
    return types.SimpleNamespace(
        grid=grid,
        split_axes_leaves=lambda: [("model",), (), ("model",),
                                   ("pipe", "model")])


@pytest.fixture
def no_host_copy(monkeypatch):
    """``torch.tensor``/``as_tensor`` raise: a captured step refuses a
    host → device copy (and would freeze its value)."""
    def refuse(*a, **k):
        raise AssertionError("a host → device copy inside the step")
    monkeypatch.setattr(torch, "tensor", refuse)
    monkeypatch.setattr(torch, "as_tensor", refuse)


def test_c15_tp_clip_makes_no_host_copy(no_host_copy):
    """C15: ``Exchanger._clip_grads`` picked the leaves a grid axis splits
    with a ``torch.tensor`` mask, a host → device copy inside the captured
    step.  The leaves are now picked by index, with the same sums."""
    from theanompi_tpu_torch.parallel.exchanger import Exchanger
    ex = Exchanger({"grad_clip": 0.5})
    ex.model = _split_model()
    g = {"a": torch.full((3,), 2.0), "b": torch.full((2,), 1.0),
         "c": torch.ones(4), "d": torch.full((2,), 3.0)}
    out = ex._clip_grads(g)
    norm = (12.0 + 2.0 + 4.0 + 18.0) ** 0.5
    for k in g:
        torch.testing.assert_close(out[k], g[k] * (0.5 / norm))


def test_c16_numerics_grid_sum_makes_no_host_copy(no_host_copy):
    """C16: the numerics sampler's ``GraphPlan._global_sum`` made the same
    mask copy inside the captured step."""
    from theanompi_tpu_torch.utils.numerics import GraphPlan
    plan = object.__new__(GraphPlan)
    plan.model, plan._split = _split_model(), None
    per_leaf = torch.arange(1.0, 5.0)
    torch.testing.assert_close(plan._global_sum(per_leaf), per_leaf.sum())


class _NoReads(dict):
    def get(self, *a, **k):
        raise AssertionError(f"a config read inside the step: {a[0]!r}")

    def __getitem__(self, k):
        raise AssertionError(f"a config read inside the step: {k!r}")


def test_c17_lm_forward_reads_no_config_knob():
    """C17: ``TransformerLM.apply_model`` read ``config["remat"]`` inside
    the captured forward: a replayed graph would keep the knob's value of
    the capture.  It is read once when the model is built."""
    from theanompi_tpu_torch.models.transformer_lm import TransformerLM
    tm = TransformerLM(dict(seq_len=128, d_model=32, n_head=2, n_layer=1,
                            vocab=32, batch_size=2, synthetic_train=4,
                            synthetic_val=2, verbose=False, device="cpu",
                            compute_dtype="float32", remat=True))
    tm.config = _NoReads(tm.config)
    x = torch.randint(0, 32, (2, 128), generator=torch.Generator()
                      .manual_seed(0))
    out = tm.apply_model(tm.params, x, train=True, gen=None,
                         state=tm.bn_state)
    assert torch.isfinite(out).all()


@pytest.mark.cuda
def test_c18_refused_capture_gives_back_its_pool():
    """C18: a capture the card refuses (a read back inside it) left the
    caching allocator routing every later allocation of the thread into
    the dead graph's private pool, which nothing released: memory freed
    after it stayed reserved.  ``StepGraph`` now ends the routing and
    releases the pool (the run out of memory this caused was in
    ``chip_smoke.py``'s shard phase, after its capture witness)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from theanompi_tpu_torch.parallel.graph import CaptureError, StepGraph
    x = torch.arange(1.0, 1025.0, device="cuda")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    prev = torch.cuda.current_stream()
    with pytest.raises(CaptureError):
        StepGraph(side).capture(lambda: x.sum().item())
    assert torch.cuda.current_stream() == prev
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_reserved()
    big = torch.empty(2 ** 30, dtype=torch.uint8, device="cuda")
    del big
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    assert torch.cuda.memory_reserved() - base < 2 ** 27
