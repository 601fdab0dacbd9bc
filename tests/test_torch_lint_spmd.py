"""The port's lint, what every rank must do alike: collective-discipline,
exchange-symmetry, group-schema and shard-rebuild-dominance
(``theanompi_tpu_torch/analysis``).

Each JAX fixture of these checks (``tests/test_lint.py``'s
collective-discipline fixtures, ``SYMMETRY_*``, ``USHARD_*``, and the
sharding-schema axis fixtures) has a torch twin here, line for line: the
JAX checker on the JAX fixture and the port's on the twin find the same
count at the same lines.  sharding-schema's ``shard_map`` arity fixtures
have no twin (the port has no ``shard_map``; its layouts are tables of
axis names, which group-schema holds).  Then: the engine's summaries of
the ``exchange_body`` family, the port's tree clean under each check, and
one injection per check into a copy of a real port file, found at its
line.  Fixtures stay in strings written to ``tmp_path``.
"""

import os
import sys

import pytest

from theanompi_tpu.analysis import core as jcore
from theanompi_tpu_torch.analysis import core as pcore
from theanompi_tpu_torch.analysis.checkers.exchange_symmetry import \
    ExchangeSymmetryChecker
from theanompi_tpu_torch.analysis.engine import ProgramIndex

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, HERE)
import test_lint as J  # noqa: E402  (the JAX suite's fixtures)

CHECKS = ("collective-discipline", "exchange-symmetry", "group-schema",
          "shard-rebuild-dominance")


def _lines(lint, root, name, code, check):
    p = root / name
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(code)
    return sorted(f.line for f in lint.run_lint(str(root), paths=[name],
                                                only=[check]))


# -- collective-discipline: the JAX fixtures (inline in tests/test_lint.py) --
# and their twins

CD = [
    ("axis-typo",
     "from jax import lax\n"
     "def exchange(x):\n"
     "    return lax.pmean(x, 'workerz')\n",
     "import torch.distributed as dist\n"
     "def exchange(x, grid):\n"
     "    return dist.all_reduce(x, group=grid.group('modle'))\n"),
    ("axis-constant-prop",
     "from jax import lax\n"
     "from theanompi_tpu.parallel.mesh import WORKER_AXIS\n"
     "def good(x, alpha):\n"
     "    axis, a = WORKER_AXIS, alpha\n"
     "    return lax.psum(x, axis)\n"
     "def bad(x, alpha):\n"
     "    axis, a = 'workerz', alpha\n"
     "    return lax.psum(x, axis)\n",
     "import torch.distributed as dist\n"
     "MODEL_AXIS = 'model'\n"
     "def good(x, grid):\n"
     "    axis, a = MODEL_AXIS, grid\n"
     "    return dist.all_reduce(x, group=grid.group(axis))\n"
     "def bad(x, grid):\n"
     "    axis, a = 'modle', grid\n"
     "    return dist.all_reduce(x, group=grid.group(axis))\n"),
    ("same-file-axes",
     "import numpy as np\n"
     "import jax\n"
     "from jax import lax\n"
     "from jax.sharding import Mesh\n"
     "mesh = Mesh(np.array(jax.devices()), ('rows', 'cols'))\n"
     "def f(x):\n"
     "    return lax.psum(x, 'rows')\n",
     "import torch.distributed as dist\n"
     "class RowGrid:\n"
     "    AXES = ('rows', 'cols')\n"
     "def f(x, grid):\n"
     "    return dist.all_reduce(x, group=grid.group('rows'))\n"),
    ("axis-name-kwarg-typo",
     "from jax import lax\n"
     "def exchange(x):\n"
     "    return lax.pmean(x, axis_name='workerz')\n",
     "import torch.distributed as dist\n"
     "def exchange(x):\n"
     "    return dist.all_reduce(x, group='modle')\n"),
    ("rank-branch",
     "from jax import lax\n"
     "def exchange(x):\n"
     "    rank = lax.axis_index('workers')\n"
     "    if rank == 0:\n"
     "        x = lax.psum(x, 'workers')\n"
     "    return x\n",
     "import torch.distributed as dist\n"
     "def exchange(x):\n"
     "    rank = dist.get_rank()\n"
     "    if rank == 0:\n"
     "        dist.all_reduce(x)\n"
     "    return x\n"),
    ("rank-branch-via-helper",
     "import jax\n"
     "from jax import lax\n"
     "def reduce_all(x):\n"
     "    return lax.psum(x, 'workers')\n"
     "def exchange(x):\n"
     "    if jax.process_index() == 0:\n"
     "        x = reduce_all(x)\n"
     "    return x\n",
     "import torch.distributed as dist\n"
     "\n"
     "def reduce_all(x):\n"
     "    return dist.all_reduce(x)\n"
     "def exchange(x):\n"
     "    if dist.get_rank() == 0:\n"
     "        x = reduce_all(x)\n"
     "    return x\n"),
    ("uniform-branch-ok",
     "from jax import lax\n"
     "def exchange(x, n, use_ring):\n"
     "    rank = lax.axis_index('workers')\n"
     "    y = x + rank\n"
     "    if n > 1 and use_ring:\n"
     "        y = lax.psum(y, 'workers')\n"
     "    return y\n",
     "import torch.distributed as dist\n"
     "def exchange(x, n, use_ring):\n"
     "    rank = dist.get_rank()\n"
     "    y = x + rank\n"
     "    if n > 1 and use_ring:\n"
     "        dist.all_reduce(y)\n"
     "    return y\n"),
    ("start-done-pairing",
     "from jax import lax\n"
     "def overlap(x):\n"
     "    t = lax.psum_start(x, 'workers')\n"
     "    return x\n"
     "def balanced(x):\n"
     "    t = lax.psum_start(x, 'workers')\n"
     "    return lax.psum_done(t)\n",
     "import torch.distributed as dist\n"
     "def overlap(x):\n"
     "    w = dist.all_reduce(x, async_op=True)\n"
     "    return x\n"
     "def balanced(x):\n"
     "    w = dist.all_reduce(x, async_op=True)\n"
     "    w.wait(); return x\n"),
    ("discarded-ticket",
     "from jax import lax\n"
     "def exchange(xs):\n"
     "    lax.psum_start(xs[0], 'workers')\n"
     "    t = lax.psum_start(xs[1], 'workers')\n"
     "    a = lax.psum_done(t)\n"
     "    b = lax.psum_done(t)\n"
     "    return a + b\n",
     "import torch.distributed as dist\n"
     "def exchange(xs):\n"
     "    dist.all_reduce(xs[0], async_op=True)\n"
     "    w = dist.all_reduce(xs[1], async_op=True)\n"
     "    a = w.wait()\n"
     "    b = w.wait()\n"
     "    return xs[0] + xs[1]\n"),
    ("bucket-loop-balanced-ok",
     "from theanompi_tpu.jax_compat import psum_start, psum_done\n"
     "def exchange(vecs):\n"
     "    tickets = [psum_start(v, 'workers') for v in vecs]\n"
     "    return [psum_done(t) for t in tickets]\n",
     "import torch.distributed as dist\n"
     "def exchange(vecs):\n"
     "    works = [dist.all_reduce(v, async_op=True) for v in vecs]\n"
     "    return [w.wait() and v for w, v in zip(works, vecs)]\n"),
    ("dead-ticket",
     "from jax import lax\n"
     "def hop(a, b):\n"
     "    t1 = lax.ppermute_start(a, 'pipe', [(0, 1)])\n"
     "    t2 = lax.ppermute_start(b, 'pipe', [(0, 1)])\n"
     "    x = lax.ppermute_done(t1)\n"
     "    y = lax.ppermute_done(t1)\n"
     "    return x + y\n",
     "import torch.distributed as dist\n"
     "def hop(a, b):\n"
     "    w1 = dist.all_reduce(a, async_op=True)\n"
     "    w2 = dist.all_reduce(b, async_op=True)\n"
     "    x = w1.wait()\n"
     "    y = w1.wait()\n"
     "    return a + b\n"),
    ("consumed-ticket-ok",
     "from theanompi_tpu.jax_compat import ppermute_start, "
     "ppermute_done\n"
     "def hop(x, perm):\n"
     "    ticket = ppermute_start(x, 'pipe', perm)\n"
     "    return ppermute_done(ticket)\n",
     "from theanompi_tpu_torch.parallel.buckets import (all_reduce_done,\n"
     "                                                  all_reduce_start)\n"
     "def hop(x):\n"
     "    ticket = all_reduce_start(x)\n"
     "    return all_reduce_done(ticket)\n"),
]

# exchange-symmetry's twins
SYMMETRY_BAD = """
import torch.distributed as dist
from theanompi_tpu_torch.parallel.exchanger import Exchanger

class Skippy(Exchanger):
    def exchange_body(self, count, gen=None):
        if self.config.get("skip"):
            return
        return [dist.all_reduce(p) for p in self.model.params.values()]
"""

SYMMETRY_BAD_ONE_ARM = """
import torch.distributed as dist
from theanompi_tpu_torch.parallel.exchanger import Exchanger

class OneArm(Exchanger):
    def exchange_body(self, count, gen=None):
        if count % 2:
            [dist.all_reduce(p) for p in self.model.params.values()]
        return
"""

SYMMETRY_GOOD = """
import torch.distributed as dist
from theanompi_tpu_torch.parallel.exchanger import Exchanger

class Clean(Exchanger):
    def exchange_body(self, count, gen=None):
        ps = list(self.model.params.values())
        for p in ps:
            dist.all_reduce(p)
        if count % 2:
            for p in ps:
                p.mul_(2)
"""

# shard-rebuild-dominance's twins
USHARD_BAD = """
from theanompi_tpu_torch.parallel.update_sharding import shard_tree

def step(params, plan, rank, lr, grads):
    my_p = shard_tree(params, plan, rank)
    new_p = my_p - lr * grads
    return new_p
"""

USHARD_GOOD = """
from theanompi_tpu_torch.parallel.update_sharding import (shard_tree,
                                                          unshard_tree)

def step(params, plan, rank, lr, grads):
    my_p = shard_tree(params, plan, rank)
    new_p = my_p - lr * grads
    full = unshard_tree(new_p, plan)
    return full
"""

USHARD_BRANCH_BAD = """
from theanompi_tpu_torch.parallel.update_sharding import (shard_tree,
                                                          unshard_tree)

def step(params, plan, rank, gather):
    my_p = shard_tree(params, plan, rank)
    if gather:
        my_p = unshard_tree(my_p, plan)
    return my_p
"""

USHARD_EXEMPT_GOOD = """
from theanompi_tpu_torch.parallel.update_sharding import shard_tree

def reshard_extra(extra, plan, rank):
    # a named producer helper: returning chunks is its JOB
    return shard_tree(extra, plan, rank)
"""

# sharding-schema's axis fixtures and their group-schema twins (its
# shard_map arity fixtures have no twin: the port has no shard_map)
SPEC_BAD_J = ("from jax.sharding import PartitionSpec as P\n"
              "SPEC = P('workerz', None)\n")
SPEC_BAD_P = ("from theanompi_tpu_torch.models.transformer_lm import Split\n"
              "SPEC = Split(modle=0)\n")
SPEC_GOOD_J = ("from jax.sharding import PartitionSpec as P\n"
               "A = P('workers', None)\n"
               "B = P(('workers', 'model'), 'seq')\n"
               "def stage(base):\n"
               "    return P(None, *base)\n")
SPEC_GOOD_P = ("from theanompi_tpu_torch.models.transformer_lm import Split\n"
               "A = Split(model=0)\n"
               "B = Split(pipe=0, model=1, seq=2)\n"
               "def stage(grid):\n"
               "    return grid.size('seq') * grid.size('model')\n")

TWINS = [(f"cd-{i}", j, "collective-discipline", p, "collective-discipline")
         for i, j, p in CD] + [
    ("symmetry-bad", J.SYMMETRY_BAD, "exchange-symmetry", SYMMETRY_BAD,
     "exchange-symmetry"),
    ("symmetry-one-arm", J.SYMMETRY_BAD_ONE_ARM, "exchange-symmetry",
     SYMMETRY_BAD_ONE_ARM, "exchange-symmetry"),
    ("symmetry-good", J.SYMMETRY_GOOD, "exchange-symmetry", SYMMETRY_GOOD,
     "exchange-symmetry"),
    ("ushard-bad", J.USHARD_BAD, "shard-rebuild-dominance", USHARD_BAD,
     "shard-rebuild-dominance"),
    ("ushard-good", J.USHARD_GOOD, "shard-rebuild-dominance", USHARD_GOOD,
     "shard-rebuild-dominance"),
    ("ushard-branch-bad", J.USHARD_BRANCH_BAD, "shard-rebuild-dominance",
     USHARD_BRANCH_BAD, "shard-rebuild-dominance"),
    ("ushard-exempt-good", J.USHARD_EXEMPT_GOOD, "shard-rebuild-dominance",
     USHARD_EXEMPT_GOOD, "shard-rebuild-dominance"),
    ("spec-bad", SPEC_BAD_J, "sharding-schema", SPEC_BAD_P, "group-schema"),
    ("spec-good", SPEC_GOOD_J, "sharding-schema", SPEC_GOOD_P,
     "group-schema"),
]


@pytest.mark.parametrize("jax_code,jax_check,twin,check",
                         [t[1:] for t in TWINS], ids=[t[0] for t in TWINS])
def test_twin_finds_what_the_jax_checker_finds(tmp_path, jax_code,
                                               jax_check, twin, check):
    want = _lines(jcore, tmp_path / "jax", "x.py", jax_code, jax_check)
    got = _lines(pcore, tmp_path / "port", "x.py", twin, check)
    assert got == want


def test_twin_messages_name_each_bug(tmp_path):
    def msgs(code, check):
        (tmp_path / "x.py").write_text(code)
        return " | ".join(f.message for f in pcore.run_lint(
            str(tmp_path), paths=["x.py"], only=[check]))

    cd = dict((i, p) for i, _, p in CD)
    assert "undeclared grid axis 'modle'" in msgs(cd["axis-typo"],
                                                  "collective-discipline")
    assert "names no process group" in msgs(cd["axis-name-kwarg-typo"],
                                            "collective-discipline")
    assert "call to `reduce_all`" in msgs(cd["rank-branch-via-helper"],
                                          "collective-discipline")
    assert "Work discarded" in msgs(cd["discarded-ticket"],
                                    "collective-discipline")
    assert "`w2`" in msgs(cd["dead-ticket"], "collective-discipline")
    assert "early exit" in msgs(SYMMETRY_BAD, "exchange-symmetry")
    assert "across `if` arms" in msgs(SYMMETRY_BAD_ONE_ARM,
                                      "exchange-symmetry")
    assert "`new_p` holds a rank's chunk" in msgs(USHARD_BAD,
                                                  "shard-rebuild-dominance")


def test_operand_read_before_its_wait(tmp_path):
    """An async collective's tensor read between the call and the wait is
    a finding; after the wait it is not."""
    code = ("import torch.distributed as dist\n"
            "def f(x):\n"
            "    w = dist.all_reduce(x, async_op=True)\n"
            "    y = x * 2\n"
            "    w.wait()\n"
            "    return x + y\n")
    assert _lines(pcore, tmp_path, "x.py", code,
                  "collective-discipline") == [4]


def test_sanctioned_lead_shape_is_clean(tmp_path):
    """``_CenterLink._lead``'s shape: rank 0 acts alone, every rank takes
    part in the broadcast of how it went."""
    code = ("import torch\n"
            "import torch.distributed as dist\n"
            "class Link:\n"
            "    def __init__(self, k):\n"
            "        self.k = k\n"
            "        self.lead = k == 1 or dist.get_rank() == 0\n"
            "    def _lead(self, call, default=None):\n"
            "        out, err = default, None\n"
            "        if self.lead:\n"
            "            try:\n"
            "                out = call()\n"
            "            except RuntimeError as e:\n"
            "                err = e\n"
            "        code = torch.tensor([0 if err is None else 1])\n"
            "        dist.broadcast(code, 0)\n"
            "        if int(code.item()) and err is None:\n"
            "            err = RuntimeError('rank 0 failed')\n"
            "        if err is not None:\n"
            "            raise err\n"
            "        return out\n"
            "    def bad(self, t):\n"
            "        if self.lead:\n"
            "            dist.broadcast(t, 0)\n")
    assert _lines(pcore, tmp_path, "x.py", code,
                  "collective-discipline") == [23]


def test_rank_property_and_point_to_point(tmp_path):
    """A property computed from the rank is a rank (``base.Grid.lead``);
    point-to-point calls under a rank branch are paired by design."""
    code = ("import torch.distributed as dist\n"
            "class G:\n"
            "    def __init__(self, world_rank):\n"
            "        self.pipe, rem = divmod(world_rank, 4)\n"
            "    @property\n"
            "    def lead(self):\n"
            "        return self.pipe == 0\n"
            "    def save(self, t, peer):\n"
            "        if self.lead:\n"
            "            dist.barrier()\n"
            "        if dist.get_rank() == 0:\n"
            "            dist.send(t, peer)\n"
            "        else:\n"
            "            dist.recv(t, 0)\n")
    assert _lines(pcore, tmp_path, "x.py", code,
                  "collective-discipline") == [10]


# -- the engine's summaries of the exchange_body family ----------------------

@pytest.fixture(scope="module")
def tree():
    """One parse and index of the port's tree, and one run of this file's
    checks over it."""
    files = pcore.collect_files(REPO)
    index = ProgramIndex(files)
    found = pcore.run_lint(REPO, only=list(CHECKS))
    return index, found


def test_every_exchange_body_override_issues_its_exchange(tree):
    """BSP (through its strategy's ``__call__``), EASGD and ASGD (through
    the center's all-gather and the delta's all-reduce) issue collectives;
    GoSGD's gossip is point-to-point; the base raises."""
    index, _ = tree
    bodies = {r.class_name: index.transitive_summary(r)
              for r in ExchangeSymmetryChecker()._exchange_bodies(index)}
    assert set(bodies) == {"Exchanger", "BSP_Exchanger", "EASGD_Exchanger",
                           "ASGD_Exchanger", "GOSGD_Exchanger"}
    for name in ("BSP_Exchanger", "EASGD_Exchanger", "ASGD_Exchanger"):
        assert bodies[name].issues_collective, name
        assert "all_reduce" in bodies[name].collective_names, name
    assert bodies["GOSGD_Exchanger"].issues_p2p
    assert not bodies["Exchanger"].issues_collective


def test_tp_wrappers_issue_collectives_through_autograd_functions(tree):
    """``tp.reduce_from_model`` reaches its group's all-reduce through
    ``_ReduceFromGroup.apply``; ``copy_to_model`` through the backward."""
    index, _ = tree
    for fn in ("reduce_from_model", "copy_to_model"):
        rec = index.by_qualname[f"theanompi_tpu_torch.parallel.tp.{fn}"][0]
        assert "allreduce" in index.transitive_summary(rec).collective_names


@pytest.mark.parametrize("check", CHECKS)
def test_port_tree_is_clean(tree, check):
    found = [f for f in tree[1] if f.check == check]
    assert found == [], [f.render() for f in found]


# -- one injection per check into a copy of a real port file -----------------

def _inject(tmp_path, rel, old, new, extra=()):
    src = open(os.path.join(REPO, rel)).read()
    assert src.count(old) == 1, f"{rel} changed shape; update the injection"
    out = src.replace(old, new)
    for e in (rel,) + tuple(extra):
        q = tmp_path / e
        q.parent.mkdir(parents=True, exist_ok=True)
        q.write_text(out if e == rel else
                     open(os.path.join(REPO, e)).read())
    line = out[:out.index(new)].count("\n") + 1 + \
        next(i for i, ln in enumerate(new.splitlines()) if "INJECTED" in ln)
    return [rel] + list(extra), line


INJECTIONS = [
    ("collective-discipline", "theanompi_tpu_torch/parallel/async_easgd.py",
     "        dist.broadcast(code, 0)\n",
     "        if self.lead:\n"
     "            dist.broadcast(code, 0)  # INJECTED\n", ()),
    ("exchange-symmetry", "theanompi_tpu_torch/parallel/exchanger.py",
     "        act = self._active_ranks\n"
     "        n_act = self.size if act is None else len(act)\n",
     "        if count % 2:\n"
     "            return  # INJECTED\n"
     "        act = self._active_ranks\n"
     "        n_act = self.size if act is None else len(act)\n",
     ("theanompi_tpu_torch/parallel/update_sharding.py",
      "theanompi_tpu_torch/parallel/buckets.py")),
    ("group-schema", "theanompi_tpu_torch/models/transformer_lm.py",
     "            return Split(pipe=0, model=None if d is None else d + 1,\n",
     "            return Split(pipe=0, modle=None if d is None else d + 1,"
     "  # INJECTED\n", ()),
    ("shard-rebuild-dominance",
     "theanompi_tpu_torch/parallel/update_sharding.py",
     "        unshard_tree(my_p, plan, out=params)\n"
     "        return params, st\n",
     "        return my_p, st  # INJECTED\n", ()),
]


@pytest.mark.parametrize("check,rel,old,new,extra", INJECTIONS,
                         ids=[i[0] for i in INJECTIONS])
def test_injection_is_found_at_its_line(tmp_path, check, rel, old, new,
                                        extra):
    paths, line = _inject(tmp_path, rel, old, new, extra)
    clean = pcore.run_lint(REPO, paths=paths, only=[check])
    assert clean == [], [f.render() for f in clean]
    found = pcore.run_lint(str(tmp_path), paths=paths, only=[check])
    assert [(f.path, f.line) for f in found] == [(rel, line)], \
        [f.render() for f in found]
