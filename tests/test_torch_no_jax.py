"""The port stands alone: importing every module of ``theanompi_tpu_torch``
pulls in neither ``jax`` nor the JAX package.  Checked in a fresh
interpreter, because this test process has imported both already."""

import json
import os
import pkgutil
import subprocess
import sys

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
# the graph helper gathers the twelve kernels' wrappers (B9's one-leaf
# entry too) without JAX
from theanompi_tpu_torch.parallel import graph
assert len(graph.kernel_wrappers()) == 13
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
               "theanompi_tpu_torch.parallel.fsdp")


def test_port_imports_neither_jax_nor_the_jax_package():
    r = subprocess.run([sys.executable, "-c", PROBE], cwd=REPO,
                       capture_output=True, text=True, timeout=120,
                       env=dict(os.environ, PYTHONPATH=REPO))
    assert r.returncode == 0, r.stdout + r.stderr
    n_modules = int(r.stdout.split()[0])
    assert n_modules >= 37, r.stdout


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


def _launch_modules(tmp_path, *kv):
    here = os.path.join(REPO, "tests")
    out = str(tmp_path / "mods")
    r = subprocess.run(
        [sys.executable, "-m", "theanompi_tpu_torch.launcher",
         "--modelfile", "torch_launch_helper", "--modelclass", "ModulesNet",
         "--n-workers", "2", "device=cpu", f"modules_out={out}", *kv],
        cwd=REPO, capture_output=True, text=True, timeout=180,
        env=dict(os.environ, OMP_NUM_THREADS="1",
                 PYTHONPATH=os.pathsep.join([here, REPO])))
    assert r.returncode == 0, (r.stdout + r.stderr)[-3000:]
    for rank in range(2):
        with open(f"{out}_r{rank}.json") as f:
            got = json.load(f)
        assert got["bad"] == [] and got["n"] > 100, got
