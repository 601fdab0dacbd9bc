"""The port stands alone: importing every module of ``theanompi_tpu_torch``
pulls in neither ``jax`` nor the JAX package.  Checked in a fresh
interpreter, because this test process has imported both already."""

import json
import os
import pkgutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = r"""
import importlib, pkgutil, sys
import theanompi_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "theanompi_tpu" or m.startswith("theanompi_tpu."))
print(len(names), bad)
assert not bad, bad
# the input path and checkpoints stand alone too: they build and run the
# native pass, read batch files and write a checkpoint without JAX
import os, tempfile
import numpy as np
from theanompi_tpu_torch import native
from theanompi_tpu_torch.models.data.prefetch import PrefetchLoader
from theanompi_tpu_torch.models.data.imagenet import ImageNet_data
from theanompi_tpu_torch.utils import checkpoint
x = np.zeros((2, 8, 8, 3), np.uint8)
native.augment_batch(x, 0, 0, 1, 5, mean_scalar=1.0)
d = tempfile.mkdtemp()
checkpoint.save_checkpoint(d, {"params": {"w": np.ones(3, np.float32)}}, 0, 0)
assert checkpoint.latest_epoch(d) == 0
loader = PrefetchLoader(ImageNet_data({"synthetic_batches": 2}, 2, crop=5), n_workers=2)
loader.shuffle_data(0)
loader.next_train_batch(1)
loader.close()
loader.set_window(2)
loader.shuffle_data(1)
assert loader.next_train_window(2)["x"].shape[0] == 2
loader.close()
# the graph helper gathers the twelve kernels' wrappers (B10-B12's
# float32 three too; B9's one-leaf entry is a pass of the group wrapper)
# without JAX
from theanompi_tpu_torch.parallel import graph
assert len(graph.kernel_wrappers()) == 15
# the zoo builds, and its synthetic Cifar10 set is made, without JAX
from theanompi_tpu_torch.models.googlenet import GoogLeNet
from theanompi_tpu_torch.models.resnet50 import ResNet50
from theanompi_tpu_torch.models.cifar10 import Cifar10_model
for cls in (GoogLeNet, ResNet50, Cifar10_model):
    cls({"device": "cpu", "verbose": False, "synthetic_train": 256})
# a center serves, and a client pushes and pulls, without JAX
from theanompi_tpu_torch.parallel.center_server import CenterServer, RemoteCenter
srv = CenterServer(alpha=0.5)
host, port = srv.start()
rc = RemoteCenter(f"{host}:{port}")
rc.ensure_init_leaves([np.ones(3, np.float32)])
rc.push_delta_leaves([np.ones(3, np.float32)], 0)
assert rc.pull_leaves()[0][0] == 1.5
rc.close()
srv.stop()
# the bucket planner plans, packs and unpacks without JAX
import torch
from theanompi_tpu_torch.parallel import buckets
tree = {"b": torch.ones(3), "a": torch.zeros(2, 2)}
plan = buckets.plan_buckets(tree, 8)
assert plan.n_buckets == 2 and plan.buckets[0].leaf_ids == (0,)
assert torch.equal(buckets.unpack(buckets.pack(tree, plan), tree, plan)["b"],
                   tree["b"])
# the sharding layouts plan, cut and box without JAX
from theanompi_tpu_torch.parallel import fsdp, update_sharding, zero
up = update_sharding.plan_tree(tree, 2, min_bytes=8)
assert [l.sharded for l in up.leaves] == [True, True]
assert update_sharding.shard_tree(tree, up, 1)["b"].tolist() == [1.0, 0.0]
boxed = update_sharding.shard_host_boxed({"b": np.ones(3, np.float32)},
                                         update_sharding.plan_tree(
                                             {"b": torch.ones(3)}, 2, min_bytes=8))
assert boxed["b"].shape == (2, 2)
assert zero.chunk_size(10, 4) == 3
lay = fsdp.FsdpLayout(tree, 2)
assert lay.chunk_host(tree).shape == (2, lay.chunk)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "theanompi_tpu" or m.startswith("theanompi_tpu."))
assert not bad, bad
# the GANs step, the MoE LM routes, samples and reads token files, and
# none of it imports JAX
from theanompi_tpu_torch.base import MeshProcess
from theanompi_tpu_torch.models.wgan import WGAN
from theanompi_tpu_torch.models.lsgan import LSGAN
from theanompi_tpu_torch.models.transformer_lm import MoETransformerLM
from theanompi_tpu_torch.models.data.tokens import TokenFileData
from theanompi_tpu_torch.parallel.moe import MoE
proc = MeshProcess({"device": "cpu", "verbose": False})
proc.get_internode_comm()
for cls in (WGAN, LSGAN):
    g = cls({"device": "cpu", "verbose": False, "batch_size": 2,
             "base_width": 4, "z_dim": 4, "n_critic": 2,
             "synthetic_train": 4, "synthetic_val": 2,
             "compute_dtype": "float32"})
    g.compile_iter_fns()
    g.train_iter(1)
moe_p = MoE(8, 4).init(torch.Generator().manual_seed(0))
moe_p["wg"].zero_()                    # a uniform router: the aux is 1
y, aux = MoE(8, 4, top_k=2, compute_dtype="float32").apply(
    moe_p, torch.ones(5, 8))
assert y.shape == (5, 8) and float(aux) == 1.0
td = tempfile.mkdtemp()
for split in ("train", "val"):
    np.arange(40, dtype=np.uint16).tofile(os.path.join(td, split + ".bin"))
lm = MoETransformerLM({"device": "cpu", "verbose": False, "data_dir": td,
                       "seq_len": 8, "d_model": 8, "n_head": 2, "n_layer": 2,
                       "batch_size": 2, "compute_dtype": "float32"})
assert isinstance(lm.data, TokenFileData)
assert lm.generate(np.ones((1, 2)), 3).shape == (1, 3)
# the model-parallel layers and the ring run over a group without JAX
import torch.distributed as dist
from theanompi_tpu_torch.models import layers as L
from theanompi_tpu_torch.ops.ring_attention import (attention_reference,
                                                    ring_attention)
from theanompi_tpu_torch.parallel import sp, tp
pg = dist.ProcessGroupGloo(dist.HashStore(), 0, 1)
x = torch.randn(1, 2, 8, 4)
assert torch.allclose(ring_attention(x, x, x, group=pg, causal=True),
                      attention_reference(x, x, x, causal=True), atol=1e-6)
logits, labels = torch.randn(4, 6), torch.tensor([0, 1, 2, 5])
assert torch.allclose(tp.tp_softmax_cross_entropy(logits, labels, pg, 0),
                      L.softmax_cross_entropy(logits, labels))
assert float(sp.sp_mean(torch.ones(()), pg)) == 1.0
from theanompi_tpu_torch.parallel import pipeline as pl
w, xm = torch.randn(2, 4, 4), pl.microbatch(torch.randn(4, 4), 2)
y = pl.pipeline_apply(lambda rows, h: h @ rows[0][0] @ rows[0][1], [w], xm,
                      pg)
assert torch.allclose(pl.unmicrobatch(y), pl.unmicrobatch(xm) @ w[0] @ w[1])
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "theanompi_tpu" or m.startswith("theanompi_tpu."))
assert not bad, bad
# the fleet monitor, the chaos harness and the membership plane run without
# JAX: a streamer feeds a collector, the monkey kills a process, and the
# controller ranks stragglers through the port's tools/telemetry_report.py
import json, subprocess, time
from theanompi_tpu_torch.parallel import membership
from theanompi_tpu_torch.utils import chaos, fleetmon, telemetry
fm = fleetmon.FleetMonServer()
fh, fp = fm.start()
tm = telemetry.Telemetry(rank=1, run_id="nojax")
tm.observe("phase.train", 0.1)
st = fleetmon.MetricStreamer(f"{fh}:{fp}", rank=1, telemetry_=tm)
assert st.push()
st.stop(final=True)
fm.stop()
assert fm.collector.retired == {1}
p = subprocess.Popen(["sleep", "30"])
monkey = chaos.ChaosMonkey(chaos.parse_schedule("kill@0:1"),
                           pid_of=lambda t: p.pid)
monkey.start()
assert p.wait(timeout=10) == -9
monkey.stop()
rd = tempfile.mkdtemp()
for r in range(3):
    with open(os.path.join(rd, f"telemetry_rank{r}.jsonl"), "w") as f:
        for i in range(30):
            f.write(json.dumps({"ts": time.time() + i, "run": "r", "rank": r,
                                "ev": "phase", "sec": "train",
                                "dt": 0.5 if r == 2 else 0.01}) + "\n")
ctl = membership.MembershipController(record_dir=rd, straggle_windows=2)
for w in range(3):
    ctl.join(w)
assert ctl.check_stragglers() == [2]
assert membership._load_report_module() is not None
# in-world membership, the refit and the async save run without JAX: the
# reactor demotes three ranks of four (rank 1's gossip then comes back to
# it alone), the layouts re-partition, and a checkpoint that names 4
# workers loads on 1
from theanompi_tpu_torch.parallel import exchanger as X
gx = X.GOSGD_Exchanger({"gosgd_peers": "iid"})
gx.prepare(type("M", (), {"rank": 1})(), 4)
reactor = membership.MeshReactor(gx)
for w in (0, 2, 3):
    reactor.on_demote(w, {})
assert gx.active_key() == (1,)
assert gx._route([torch.ones(2)], 0)[0].tolist() == [1.0, 1.0]
assert zero.rechunk_boxed(np.ones((2, 3), np.float32), 3, 1, 5).shape == \
    (3, 2)
assert lay.rechunk(lay.chunk_host(tree)).shape == (2, lay.chunk)
cm = Cifar10_model({"device": "cpu", "verbose": False,
                    "synthetic_train": 256, "async_ckpt": True})
cm.compile_iter_fns()
cd = tempfile.mkdtemp()
cm.save(cd, 0)
cm.wait_pending_ckpt()
meta_p = os.path.join(cd, "ckpt_epoch0.json")
with open(meta_p) as f:
    meta = json.load(f)
meta["n_workers"] = 4
with open(meta_p, "w") as f:
    json.dump(meta, f)
assert cm.load(cd) == 0
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "theanompi_tpu" or m.startswith("theanompi_tpu."))
assert not bad, bad
"""

NEW_MODULES = ("theanompi_tpu_torch.native",
               "theanompi_tpu_torch.models.data.prefetch",
               "theanompi_tpu_torch.utils.checkpoint",
               "theanompi_tpu_torch.parallel.graph",
               "theanompi_tpu_torch.models.data.cifar10",
               "theanompi_tpu_torch.models.cifar10",
               "theanompi_tpu_torch.models.googlenet",
               "theanompi_tpu_torch.models.resnet50",
               "theanompi_tpu_torch.models.vggnet_11_shallow",
               "theanompi_tpu_torch.models.registry",
               "theanompi_tpu_torch.parallel.topology",
               "theanompi_tpu_torch.parallel.wire",
               "theanompi_tpu_torch.parallel.center_server",
               "theanompi_tpu_torch.parallel.async_easgd",
               "theanompi_tpu_torch.parallel.membership",
               "theanompi_tpu_torch.utils.clock",
               "theanompi_tpu_torch.launcher",
               "theanompi_tpu_torch.parallel.buckets",
               "theanompi_tpu_torch.parallel.update_sharding",
               "theanompi_tpu_torch.parallel.zero",
               "theanompi_tpu_torch.parallel.fsdp",
               "theanompi_tpu_torch.models.gan",
               "theanompi_tpu_torch.models.wgan",
               "theanompi_tpu_torch.models.lsgan",
               "theanompi_tpu_torch.models.data.tokens",
               "theanompi_tpu_torch.parallel.moe",
               "theanompi_tpu_torch.parallel.tp",
               "theanompi_tpu_torch.parallel.sp",
               "theanompi_tpu_torch.ops.ring_attention",
               "theanompi_tpu_torch.parallel.pipeline",
               "theanompi_tpu_torch.utils.telemetry",
               "theanompi_tpu_torch.utils.tracing",
               "theanompi_tpu_torch.utils.numerics",
               "theanompi_tpu_torch.utils.sentry",
               "theanompi_tpu_torch.utils.watchdog",
               "theanompi_tpu_torch.utils.fleetmon",
               "theanompi_tpu_torch.utils.chaos",
               "theanompi_tpu_torch.utils.devprof",
               "theanompi_tpu_torch.utils.compile_cache",
               "theanompi_tpu_torch.simfleet",
               "theanompi_tpu_torch.simfleet.clock",
               "theanompi_tpu_torch.simfleet.events",
               "theanompi_tpu_torch.simfleet.transport",
               "theanompi_tpu_torch.simfleet.fleet",
               "theanompi_tpu_torch.simfleet.health",
               "theanompi_tpu_torch.simfleet.invariants",
               "theanompi_tpu_torch.simfleet.fidelity",
               "theanompi_tpu_torch.simfleet.drill",
               "theanompi_tpu_torch.tools",
               "theanompi_tpu_torch.tools.simfleet_run",
               "theanompi_tpu_torch.tools.chaos_run",
               "theanompi_tpu_torch.tools.lint",
               "theanompi_tpu_torch.tools._world",
               "theanompi_tpu_torch.tools.telemetry_report",
               "theanompi_tpu_torch.tools.fleetz",
               "theanompi_tpu_torch.tools.plot_records",
               "theanompi_tpu_torch.tools.profile_model",
               "theanompi_tpu_torch.tools.loader_bench",
               "theanompi_tpu_torch.tools.scaling_sweep",
               "theanompi_tpu_torch.tools.gosgd_mixing",
               "theanompi_tpu_torch.tools.async_vs_sync_easgd",
               "theanompi_tpu_torch.tools.rules_time_to_acc",
               "theanompi_tpu_torch.analysis",
               "theanompi_tpu_torch.analysis.core",
               "theanompi_tpu_torch.analysis.cache",
               "theanompi_tpu_torch.analysis.engine",
               "theanompi_tpu_torch.analysis.protocol",
               "theanompi_tpu_torch.analysis.cli",
               "theanompi_tpu_torch.analysis.checkers",
               "theanompi_tpu_torch.analysis.checkers.host_concurrency",
               "theanompi_tpu_torch.analysis.checkers.protocol_conformance",
               "theanompi_tpu_torch.analysis.checkers.telemetry_hot_path",
               "theanompi_tpu_torch.analysis.checkers.schema_drift",
               "theanompi_tpu_torch.analysis.checkers.oracle_pair")

PLANES = ("telemetry", "tracing", "numerics", "sentry", "watchdog",
          "fleetmon", "chaos", "devprof", "compile_cache")


def test_port_imports_neither_jax_nor_the_jax_package():
    r = subprocess.run([sys.executable, "-c", PROBE], cwd=REPO,
                       capture_output=True, text=True, timeout=120,
                       env=dict(os.environ, PYTHONPATH=REPO))
    assert r.returncode == 0, r.stdout + r.stderr
    n_modules = int(r.stdout.split()[0])
    assert n_modules >= 90, r.stdout


@pytest.mark.parametrize("name", PLANES)
def test_operations_planes_import_neither_jax_nor_torch(name):
    """Each operations plane's module, imported alone in a fresh
    interpreter, pulls in neither ``jax``, the JAX package nor ``torch``
    (their host halves are stdlib; ``numerics`` imports torch inside its
    step sampler only)."""
    probe = (f"import sys, theanompi_tpu_torch.utils.{name}; "
             "print(sorted(m for m in sys.modules if m.split('.')[0] in "
             "('jax', 'jaxlib', 'theanompi_tpu', 'torch')))")
    r = subprocess.run([sys.executable, "-c", probe], cwd=REPO,
                       capture_output=True, text=True, timeout=60,
                       env=dict(os.environ, PYTHONPATH=REPO))
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]", r.stdout


# the fault drill's model (``simfleet.drill``) imports torch: an island
# process imports it
SIM_MODULES = tuple(m for m in NEW_MODULES
                    if m.split(".")[1] in ("simfleet", "tools")
                    and not m.endswith(".drill"))

LINT_MODULES = tuple(m for m in NEW_MODULES if m.split(".")[1] == "analysis")


@pytest.mark.parametrize("name", LINT_MODULES)
def test_lint_modules_import_neither_jax_nor_torch(name):
    """Each module of the port's lint, imported alone in a fresh
    interpreter, pulls in neither ``jax``, the JAX package nor ``torch``
    (the schema-drift probes import what they probe when they run)."""
    probe = (f"import sys, importlib; importlib.import_module({name!r}); "
             "print(sorted(m for m in sys.modules if m.split('.')[0] in "
             "('jax', 'jaxlib', 'theanompi_tpu', 'torch')))")
    r = subprocess.run([sys.executable, "-c", probe], cwd=REPO,
                       capture_output=True, text=True, timeout=60,
                       env=dict(os.environ, PYTHONPATH=REPO))
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]", r.stdout


@pytest.mark.parametrize("name", SIM_MODULES)
def test_simfleet_and_tools_import_neither_jax_nor_torch(name):
    """Each module of the simulator and of the tools, imported alone in a
    fresh interpreter, pulls in neither ``jax``, the JAX package nor
    ``torch``; the simulator's modules run a small fleet with the health
    plane on and check its invariants without them."""
    probe = (f"import sys, importlib; importlib.import_module({name!r})\n")
    if name.split(".")[1] == "simfleet":
        probe += (
            "from theanompi_tpu_torch.simfleet import FleetSim, "
            "check_invariants\n"
            "f = FleetSim(n_workers=8, steps=200, sync_freq=4, seed=1, "
            "n_faults=2, net_n_faults=2, fleetmon=True)\n"
            "f.run()\n"
            "assert all(ok for _, ok, _ in check_invariants(f))\n")
    probe += ("print(sorted(m for m in sys.modules if m.split('.')[0] in "
              "('jax', 'jaxlib', 'theanompi_tpu', 'torch')))")
    r = subprocess.run([sys.executable, "-c", probe], cwd=REPO,
                       capture_output=True, text=True, timeout=60,
                       env=dict(os.environ, PYTHONPATH=REPO))
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]", r.stdout


def test_membership_and_its_straggler_ranking_import_no_jax_or_torch(
        tmp_path):
    """``parallel/membership.py`` imported alone, its straggler ranking run
    (the port's ``tools/telemetry_report.py``, imported) and its fleet
    monitor tick taken: neither ``jax``, the JAX package nor ``torch`` is
    imported; the island's process imports torch only when it starts."""
    rd = str(tmp_path)
    for r in range(3):
        with open(os.path.join(rd, f"telemetry_rank{r}.jsonl"), "w") as f:
            for i in range(30):
                f.write(json.dumps({"ts": 1e9 + i, "run": "r", "rank": r,
                                    "ev": "phase", "sec": "train",
                                    "dt": 0.5 if r == 2 else 0.01}) + "\n")
    probe = (
        "import sys\n"
        "from theanompi_tpu_torch.parallel import membership as mb\n"
        "from theanompi_tpu_torch.utils import fleetmon\n"
        f"ctl = mb.MembershipController(record_dir={rd!r}, "
        "straggle_windows=2, straggle_window_s=5.0)\n"
        "[ctl.join(w) for w in range(3)]\n"
        "assert ctl.check_stragglers() == [2], ctl.status()\n"
        "sup = mb.ElasticSupervisor(lambda w, a: ['true'], [1], "
        f"{rd!r}, fleetmon=fleetmon.FleetMonServer())\n"
        "sup._tick_fleetmon()\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'theanompi_tpu', 'torch')))")
    r = subprocess.run([sys.executable, "-c", probe], cwd=REPO,
                       capture_output=True, text=True, timeout=60,
                       env=dict(os.environ, PYTHONPATH=REPO))
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]", r.stdout


def test_the_walk_reaches_the_new_modules():
    import theanompi_tpu_torch as pkg
    names = {m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                    pkg.__name__ + ".")}
    assert set(NEW_MODULES) <= names, sorted(names)


def test_port_sources_name_no_jax_import():
    """No module of the port so much as mentions an import of jax or of the
    JAX package (a lazy import inside a function would escape the probe)."""
    import theanompi_tpu_torch as pkg
    root = pkg.__path__[0]
    for info in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
        rel = info.name.split(".", 1)[1].replace(".", os.sep)
        path = os.path.join(root, rel, "__init__.py") if info.ispkg \
            else os.path.join(root, rel + ".py")
        with open(path) as f:
            for line in f:
                s = line.strip()
                assert not s.startswith(("import jax", "from jax",
                                         "import theanompi_tpu.",
                                         "from theanompi_tpu.",
                                         "from theanompi_tpu import")), \
                    f"{path}: {s}"


def test_launched_workers_import_neither_jax_nor_the_jax_package(tmp_path):
    """Two ranks started by the port's launcher train an epoch through
    ``python -m theanompi_tpu_torch.worker``; as each rank's process exits
    it lists which of ``jax`` and the JAX package it imported: none."""
    _launch_modules(tmp_path)


def test_launched_sharded_workers_import_neither_jax_nor_the_jax_package(
        tmp_path):
    """The same under ``fsdp=true``, which the launcher passes through to
    each rank's worker."""
    _launch_modules(tmp_path, "fsdp=true")


def test_launched_workers_with_the_planes_import_no_jax(tmp_path):
    """The same with telemetry, tracing, the numerics plane and the
    watchdog on in each rank."""
    _launch_modules(tmp_path, f"record_dir={tmp_path / 'rec'}",
                    "tracing=true", "numerics=true", "stall_timeout=120")


def test_launched_elastic_islands_import_no_jax(tmp_path):
    """``launcher --elastic 2 --host-devices 1`` with the fleet monitor
    and a record dir: each island's process, as it exits, lists which of
    ``jax`` and the JAX package it imported: none."""
    _launch_modules(tmp_path, f"record_dir={tmp_path / 'rec'}",
                    "fleetmon=true", "sync_freq=2",
                    launch=["--rule", "easgd", "--elastic", "2",
                            "--host-devices", "1", "--elastic-steps", "4"],
                    ranks=(1, 2))


def _launch_modules(tmp_path, *kv, launch=("--n-workers", "2",
                                           "device=cpu"), ranks=(0, 1)):
    here = os.path.join(REPO, "tests")
    out = str(tmp_path / "mods")
    r = subprocess.run(
        [sys.executable, "-m", "theanompi_tpu_torch.launcher",
         "--modelfile", "torch_launch_helper", "--modelclass", "ModulesNet",
         *launch, f"modules_out={out}", *kv],
        cwd=REPO, capture_output=True, text=True, timeout=180,
        env=dict(os.environ, OMP_NUM_THREADS="1",
                 PYTHONPATH=os.pathsep.join([here, REPO])))
    assert r.returncode == 0, (r.stdout + r.stderr)[-3000:]
    for rank in ranks:
        with open(f"{out}_r{rank}.json") as f:
            got = json.load(f)
        assert got["bad"] == [] and got["n"] > 100, got


def test_tools_load_nothing_of_the_jax_tree_by_path():
    """No tool reaches into the JAX tree by file path: no module spec
    made from a file, no path built to ``scripts/`` or ``theanompi_tpu/``
    (the port keeps its own copy of what it needs)."""
    import theanompi_tpu_torch.tools as tools
    root = tools.__path__[0]
    for name in sorted(os.listdir(root)):
        if not name.endswith(".py"):
            continue
        with open(os.path.join(root, name)) as f:
            src = f.read()
        assert "spec_from_file_location" not in src, name
        assert '"scripts"' not in src and "'scripts'" not in src, name
        assert '"theanompi_tpu"' not in src and \
            "'theanompi_tpu'" not in src, name
