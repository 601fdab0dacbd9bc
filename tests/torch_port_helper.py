"""Tiny models for the port's tests, and the per-rank entries of the
multi-process tests.

* :class:`TinyLRNNet` — Conv → LRN → Pool → FC: the AlexNet block at toy
  width.
* :class:`TinyDropNet` — :class:`TinyLRNNet` with dropout before its FC.
* :class:`TinyVGGNet` — Conv 3×3 SAME → Pool 2/2 → Conv → Pool → FC: the
  VGG block at toy width, the model of the onebit tests.
* :class:`TinyLM` — the transformer LM at toy size (float32, reference
  attention, Adam).
* :class:`TinyFileNet` — :class:`TinyLRNNet`'s block on ImageNet batch
  files (``config['data_dir']``, written by :func:`write_imagenet_dir`),
  cropped to 13×13.
* :class:`TinyResNet` — ResNet-50's layers at toy depth and width (two
  bottlenecks, BatchNorm running state), float32, on the tiny set.

Imports only ``theanompi_tpu_torch`` (no JAX), so it can run as a child
process, one per rank of a gloo group:

    python tests/torch_port_helper.py train <rank> <world> <init_method> \
        <out> <batch_size> [<modelclass> [<exch_strategy>]]

trains one epoch of the model (default ``TinyLRNNet`` under
``allreduce``) under ``BSP`` and writes each rank's final parameters (and
the strategy's state, if it has one: a flat state as ``extra/strat``, a
per-leaf list as ``extra/strat/<i>/<key>``; and a BatchNorm model's running
state after the last step, ``bn/<i>``, and this rank's own before the last
``sync_bn``, ``bn_local/<i>``) to ``<out>_r<rank>.npz``;

    python tests/torch_port_helper.py onebit|topk|powersgd <rank> <world> \
        <init_method> <out>

runs one exchange of that strategy (``topk`` with a chunk of 256,
``powersgd`` at rank 1) of a gradient tree of ``TinyVGGNet``'s shapes
drawn from the seed ``100 + rank`` and writes the flat input (the port's
flat order), the decoded mean and the new state to ``<out>_r<rank>.npz``;

    python tests/torch_port_helper.py resume <rank> <world> <init_method> \
        <out> <modelclass> <exch_strategy> <ckpt_dir>

trains the model two epochs without a break, then one epoch that ends in a
checkpoint and, in a new session, a resumed second epoch, and writes both
runs' final state to ``<out>_r<rank>.npz`` (``full/...`` and
``resumed/...``);

    python tests/torch_port_helper.py rules <rank> <world> <init_method> \
        <out> <init_npz> <init_bn_npz> <ckpt_root>

trains :class:`TinyLRNNetFrom` (initial params from ``<init_npz>``) two
epochs under each of ``RULE_CASES`` (EASGD with ``grad_clip``, ASGD,
GoSGD; and :class:`TinyResNetFrom`, from ``<init_bn_npz>``, under EASGD),
checkpointing into ``<ckpt_root>/<case>``, and writes each run's
final state and records to ``<out>_r<rank>.npz`` (``<case>/...``); then
the GoSGD resume case: two epochs without a break, against one epoch, a
checkpoint and a resumed second epoch (``resume/full/...``,
``resume/resumed/...``);

    python tests/torch_port_helper.py gossip <rank> <world> <init_method> \
        <out>

for each ``gosgd_peers`` mode, trains :class:`TinyLRNNet` three steps
without an exchange (the replicas diverge), then runs six exchanges alone,
and writes the params before and after and α after each exchange
(``<peers>/...``);

    python tests/torch_port_helper.py island <proc> <center_addr> <rule> \
        <throttle_s> <seconds>

runs one async island of :class:`TinyLRNNet` (``island_base`` ``<proc>``,
``sync_freq`` 2) against the center at ``<center_addr>`` under ``easgd`` or
``asgd``, sleeping ``<throttle_s>`` after each step, for ``<seconds>``
(a negative number: until 2 exchanges, at most 300 s), and prints one line
``ST <json>`` with the trainer's stats.
"""

import os
import subprocess
import sys

import numpy as np

from theanompi_tpu_torch.models import layers as L
from theanompi_tpu_torch.models.data import DataBase
from theanompi_tpu_torch.models.model_base import ModelBase
from theanompi_tpu_torch.models.resnet50 import ResNet50
from theanompi_tpu_torch.models.transformer_lm import TransformerLM

N_TRAIN = 48
HW, C_IN, N_CLASS = 8, 3, 5


def tiny_arrays(seed: int = 7):
    """The dataset, from a seed: NHWC float32 images and int32 labels."""
    r = np.random.RandomState(seed)
    x = r.randn(N_TRAIN, HW, HW, C_IN).astype(np.float32)
    y = r.randint(0, N_CLASS, N_TRAIN).astype(np.int32)
    return x, y


class TinyData(DataBase):
    def __init__(self, config=None, batch_size=8):
        super().__init__(config, batch_size)
        self.x_train, self.y_train = tiny_arrays()
        self.x_val, self.y_val = self.x_train[:16], self.y_train[:16]
        self._finalize()


class TinyLRNNet(ModelBase):
    """Conv(3→16, 3×3 SAME) → LRN → Pool(3/2) → FC(3·3·16 → 5), float32,
    no dropout: the AlexNet block at toy width."""

    batch_size = 8
    epochs = 1
    learning_rate = 0.1
    momentum = 0.9
    weight_decay = 0.0005
    seed = 3

    def build_model(self):
        self.seq = L.Sequential([
            L.Conv(C_IN, 16, 3, padding=1, w_init=("normal", 0.3),
                   b_init=("constant", 0.1), compute_dtype="float32",
                   name="conv"),
            L.LRN(k=1.0, alpha=0.5, name="lrn"),
            L.Pool(3, 2, mode="max", name="pool"),
            L.Flatten(),
            L.FC(3 * 3 * 16, N_CLASS, w_init=("normal", 0.1),
                 activation=None, compute_dtype="float32", name="fc"),
        ])
        self.data = TinyData(self.config, self.batch_size)


class _FromNpz:
    """A model whose initial params are read from ``config['init_npz']``
    when it names one (the port's layout, leaves keyed by their
    ``/``-joined paths): the JAX twin's weights, for runs in processes
    that do not import JAX."""

    def init_params(self, gen):
        import torch
        from theanompi_tpu_torch.utils.helper_funcs import (leaf_paths,
                                                            tree_map)
        params = super().init_params(gen)
        path = self.config.get("init_npz")
        if not path:
            return params
        with np.load(path) as z:
            it = iter([torch.from_numpy(z["/".join(map(str, p))])
                       for p in leaf_paths(params)])
        return tree_map(lambda _: next(it), params)


class TinyLRNNetFrom(_FromNpz, TinyLRNNet):
    """:class:`TinyLRNNet` from ``config['init_npz']``."""


class TinyDropNet(TinyLRNNet):
    """:class:`TinyLRNNet` with dropout (rate 0.5) before its FC: the
    tests of the step's dropout streams."""

    def build_model(self):
        super().build_model()
        layers = self.seq.layers
        self.seq = L.Sequential(layers[:-1] + [L.Dropout(0.5, name="drop"),
                                               layers[-1]])


def tiny_vgg_layers(Lmod, f32):
    """The layer list of :class:`TinyVGGNet`, from a layer module (this
    package's or the JAX package's) and its float32 dtype."""
    return [
        Lmod.Conv(C_IN, 8, 3, padding="SAME", w_init="he",
                  b_init=("constant", 0.1), compute_dtype=f32, name="conv1"),
        Lmod.Pool(2, 2, mode="max", name="pool1"),
        Lmod.Conv(8, 8, 3, padding="SAME", w_init="he",
                  b_init=("constant", 0.1), compute_dtype=f32, name="conv2"),
        Lmod.Pool(2, 2, mode="max", name="pool2"),
        Lmod.Flatten(),
        Lmod.FC(2 * 2 * 8, N_CLASS, w_init=("normal", 0.1), activation=None,
                compute_dtype=f32, name="fc"),
    ]


class TinyVGGNet(ModelBase):
    """Conv(3→8, 3×3 SAME) → Pool 2/2 → Conv(8→8) → Pool 2/2 →
    FC(2·2·8 → 5), float32, no dropout: the VGG block at toy width."""

    batch_size = 8
    epochs = 1
    learning_rate = 0.05
    momentum = 0.9
    weight_decay = 0.0005
    seed = 5

    def build_model(self):
        self.seq = L.Sequential(tiny_vgg_layers(L, "float32"))
        self.data = TinyData(self.config, self.batch_size)


class TinyFileNet(ModelBase):
    """:class:`TinyLRNNet`'s layers on ImageNet batch files cropped to
    13×13: Conv(3→16, 3×3 SAME) → LRN → Pool(3/2) → FC(6·6·16 → 5)."""

    batch_size = 4
    epochs = 2
    learning_rate = 0.01
    momentum = 0.9
    weight_decay = 0.0005
    seed = 11

    def build_model(self):
        from theanompi_tpu_torch.models.data.imagenet import ImageNet_data
        self.seq = L.Sequential([
            L.Conv(C_IN, 16, 3, padding=1, w_init=("normal", 0.05),
                   b_init=("constant", 0.1), compute_dtype="float32",
                   name="conv"),
            L.LRN(k=1.0, alpha=0.5, name="lrn"),
            L.Pool(3, 2, mode="max", name="pool"),
            L.Flatten(),
            L.FC(6 * 6 * 16, N_CLASS, w_init=("normal", 0.01),
                 activation=None, compute_dtype="float32", name="fc"),
        ])
        self.data = ImageNet_data(self.config, self.batch_size, crop=13)


class TinyResNet(ResNet50):
    """ResNet-50's layers at toy size on the tiny set: ConvBN(3→64, 7×7/2)
    → SAME max pool 3/2 → Bottleneck(64→16→64) → Bottleneck(64→16→2048,
    stride 2, projection) → mean → FC(2048 → 5), float32 unless the config
    says otherwise; 9 BatchNorm layers (8×8 → 4 → 2 → 2 → 1)."""

    stages = ((16, 64, 1, 1), (16, 2048, 1, 2))
    batch_size = 8
    epochs = 1
    learning_rate = 0.01
    seed = 13

    def build_model(self):
        self.config.setdefault("compute_dtype", "float32")
        self.config.setdefault("n_class", N_CLASS)
        super().build_model()
        self.data = TinyData(self.config, self.batch_size)


class TinyResNetFrom(_FromNpz, TinyResNet):
    """:class:`TinyResNet` from ``config['init_npz']``."""


TINY_LM = dict(vocab=32, d_model=16, n_head=2, n_layer=1, seq_len=16,
               batch_size=4, synthetic_train=16, synthetic_val=8,
               attn_impl="reference", compute_dtype="float32")


class TinyLM(TransformerLM):
    """The LM at ``TINY_LM``'s size; the config's keys win."""

    def __init__(self, config=None):
        super().__init__(dict(TINY_LM, **(config or {})))


def write_imagenet_dir(root, n_train=6, n_val=2, bs=4, hw=16, layout="bc01",
                       fmt="npy", mean="chw", seed=0):
    """An ImageNet-layout directory of uint8 batch files made from
    ``seed``: ``train_hkl/`` and ``val_hkl/`` of ``bs``-image files in
    ``layout`` (``bc01``, ``c01b`` or ``nhwc``) and ``fmt`` (``npy``,
    ``npz`` or ``hkl``, the last written with h5py), the label files, and
    ``img_mean.npy`` as ``mean`` says (``chw``, ``hwc``, ``channel`` or
    ``none``).  Returns ``root``."""
    r = np.random.RandomState(seed)
    for sub, n in (("train_hkl", n_train), ("val_hkl", n_val)):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
        for j in range(n):
            x = r.randint(0, 256, (bs, hw, hw, C_IN), dtype=np.uint8)
            x = {"bc01": lambda a: a.transpose(0, 3, 1, 2),
                 "c01b": lambda a: a.transpose(3, 1, 2, 0),
                 "nhwc": lambda a: a}[layout](x)
            x = np.ascontiguousarray(x)
            path = os.path.join(root, sub, f"{j:04d}.{fmt}")
            if fmt == "hkl":
                import h5py
                with h5py.File(path, "w") as f:
                    f.create_dataset("data", data=x)
            elif fmt == "npz":
                np.savez(path, x)
            else:
                np.save(path, x)
        labels = r.randint(0, N_CLASS, n * bs).astype(np.int32)
        np.save(os.path.join(root, sub.split("_")[0] + "_labels.npy"), labels)
    m = (r.rand(C_IN, hw, hw) * 255).astype(np.float32)
    if mean == "chw":
        np.save(os.path.join(root, "img_mean.npy"), m)
    elif mean == "hwc":
        np.save(os.path.join(root, "img_mean.npy"), m.transpose(1, 2, 0))
    elif mean == "channel":
        np.save(os.path.join(root, "img_mean.npy"), m.mean(axis=(1, 2)))
    return root


def state_arrays(model) -> dict:
    """A model's params, optimizer state, BN state and strategy state as
    flat npz entries (``params/<path>``, ``opt/<i>``, ``bn/<i>``,
    ``extra/<i>``), copies (on the CPU a tensor's ``.numpy()`` shares its
    storage, which the next step rewrites)."""
    from theanompi_tpu_torch.utils.helper_funcs import leaf_paths, tree_leaves
    params = model.host_params()
    out = {"params/" + "/".join(map(str, p)): np.array(v)
           for p, v in zip(leaf_paths(params), tree_leaves(params))}
    for part, tree in (("opt", model.opt_state), ("bn", model.bn_state),
                       ("extra", model.extra)):
        for i, leaf in enumerate(tree_leaves(tree)):
            out[f"{part}/{i}"] = np.array(leaf.detach().cpu().numpy()
                                          if hasattr(leaf, "detach")
                                          else leaf)
    return out


def run_session(modelclass, epochs, modelfile="torch_port_helper",
                rule="bsp", **cfg):
    """One session of ``rule`` (BSP by default) on the CPU; returns the
    rule (its model trained, its recorder in ``.recorder``)."""
    import theanompi_tpu_torch as T
    rule = getattr(T, rule.upper())()
    rule.init(devices=int(cfg.pop("n_workers", 1)), modelfile=modelfile,
              modelclass=modelclass, device="cpu", epochs=epochs,
              scale_lr=False, printFreq=1000, verbose=False, **cfg)
    rule.wait()
    return rule


def resume(rank, world, init_method, out, modelclass, strategy, ckpt_dir):
    """Two epochs uninterrupted, then one with a checkpoint and a resumed
    second in a new session: both final states to ``<out>_r<rank>.npz``."""
    kw = dict(n_workers=int(world), rank=int(rank), exch_strategy=strategy)
    full = run_session(modelclass, 2, init_method=init_method + "_full", **kw)
    run_session(modelclass, 1, init_method=init_method + "_first",
                ckpt_dir=ckpt_dir, **kw)
    again = run_session(modelclass, 2, init_method=init_method + "_again",
                        ckpt_dir=ckpt_dir, resume=True, **kw)
    np.savez(f"{out}_r{rank}.npz",
             **{f"full/{k}": v for k, v in state_arrays(full.model).items()},
             **{f"resumed/{k}": v
                for k, v in state_arrays(again.model).items()})


# the async rules' 2-rank runs (``rules``), against the JAX package's
RULE_CASES = {
    "easgd": dict(rule="easgd", sync_freq=2, alpha=0.5, grad_clip=0.3),
    "asgd": dict(rule="asgd", sync_freq=2),
    "gosgd": dict(rule="gosgd", exch_prob=1.0),
    # local BatchNorm stats, validation on their replica mean
    "easgd_bn": dict(rule="easgd", sync_freq=2, modelclass="TinyResNetFrom"),
}
RULE_EPOCHS = 2
# the resume case: gossip that sends sometimes, so each step's draws count
RESUME_CASE = dict(rule="gosgd", exch_prob=0.5, gosgd_peers="shift")


def rules(rank, world, init_method, out, init_npz, init_bn_npz, ckpt_root):
    res = {}
    kw = dict(n_workers=int(world), rank=int(rank), init_npz=init_npz)
    for name, cfg in RULE_CASES.items():
        cfg = dict(cfg)
        cls = cfg.pop("modelclass", "TinyLRNNetFrom")
        more = dict(kw, init_npz=init_bn_npz) \
            if cls == "TinyResNetFrom" else kw
        rule = run_session(cls, RULE_EPOCHS,
                           init_method=f"{init_method}_{name}",
                           ckpt_dir=os.path.join(ckpt_root, name),
                           **cfg, **more)
        rec = rule.recorder
        res.update({f"{name}/{k}": v
                    for k, v in state_arrays(rule.model).items()})
        res[f"{name}/cost"] = np.float32([r["cost"]
                                          for r in rec.train_records])
        res[f"{name}/val_cost"] = np.float32([r["val_cost"]
                                              for r in rec.epoch_records])
    ck = os.path.join(ckpt_root, "resume")
    kw.update(RESUME_CASE)
    full = run_session("TinyLRNNetFrom", 2, init_method=init_method + "_rf",
                       **kw)
    run_session("TinyLRNNetFrom", 1, init_method=init_method + "_r1",
                ckpt_dir=ck, **kw)
    again = run_session("TinyLRNNetFrom", 2,
                        init_method=init_method + "_r2", ckpt_dir=ck,
                        resume=True, **kw)
    res.update({f"resume/full/{k}": v
                for k, v in state_arrays(full.model).items()})
    res.update({f"resume/resumed/{k}": v
                for k, v in state_arrays(again.model).items()})
    np.savez(f"{out}_r{rank}.npz", **res)


def gossip(rank, world, init_method, out):
    from theanompi_tpu_torch.worker import GOSGD_Worker
    res = {}
    for peers in ("perm", "shift", "iid"):
        w = GOSGD_Worker({"device": "cpu", "rank": int(rank),
                          "n_workers": int(world), "batch_size": 4,
                          "init_method": f"{init_method}_{peers}",
                          "exch_prob": 0.7, "gosgd_peers": peers,
                          "verbose": False})
        try:
            model = w.build_model("torch_port_helper", "TinyLRNNet")
            model.compile_iter_fns(w.exchanger)
            model.data.shuffle_data(0)
            for c in (1, 2, 3):
                model.train_iter(c)
            res.update({f"{peers}/before/{k}": v for k, v in
                        state_arrays(model).items() if k.startswith("p")})
            alphas = []
            for c in range(4, 10):
                w.exchanger.exchange(None, c)
                alphas.append(float(model.extra["alpha"]))
            res[f"{peers}/alpha"] = np.float32(alphas)
            res.update({f"{peers}/after/{k}": v for k, v in
                        state_arrays(model).items() if k.startswith("p")})
        finally:
            w.close()
    np.savez(f"{out}_r{rank}.npz", **res)


def _save(path, tree, **extra):
    from theanompi_tpu_torch.utils.helper_funcs import leaf_paths, tree_leaves
    np.savez(path, **{"/".join(map(str, p)): v for p, v in
                      zip(leaf_paths(tree), tree_leaves(tree))}, **extra)


def train(rank, world, init_method, out, bs, modelclass="TinyLRNNet",
          strategy="allreduce"):
    from theanompi_tpu_torch import BSP
    from theanompi_tpu_torch.parallel.exchanger import BSP_Exchanger
    from theanompi_tpu_torch.utils.helper_funcs import tree_leaves
    rule = BSP()
    rule.init(devices=int(world), modelfile="torch_port_helper",
              modelclass=modelclass, exch_strategy=strategy, device="cpu",
              rank=int(rank), init_method=init_method, batch_size=int(bs),
              scale_lr=False, printFreq=1000, verbose=False)
    local = []                 # this rank's running state before each sync
    sync_bn = BSP_Exchanger.sync_bn

    def spy(self, bn_state):
        local[:] = [t.clone() for t in tree_leaves(bn_state)]
        sync_bn(self, bn_state)

    BSP_Exchanger.sync_bn = spy          # this process is one rank's alone
    rule.wait()
    model = rule.model
    bn = {f"bn/{i}": t.numpy() for i, t in
          enumerate(tree_leaves(model.bn_state))}
    bn.update({f"bn_local/{i}": t.numpy() for i, t in enumerate(local)})
    _save(f"{out}_r{rank}.npz", model.host_params(),
          **_state_arrays(model.extra.get("strat")), **bn)


def _state_arrays(state, prefix="extra/strat"):
    """A strategy state as npz entries: a tensor as ``prefix``, a per-leaf
    list of dicts leaf by leaf as ``prefix/<i>/<key>``."""
    if state is None:
        return {}
    if isinstance(state, list):
        return {f"{prefix}/{i}/{k}": v.numpy() for i, d in enumerate(state)
                for k, v in d.items()}
    return {prefix: state.numpy()}


def exchange(strategy, rank, world, init_method, out):
    """One exchange of ``strategy`` over a gloo group of ``world`` ranks
    (``topk``: chunk 256; ``powersgd``: rank 1)."""
    import torch
    from theanompi_tpu_torch.base import MeshProcess
    from theanompi_tpu_torch.parallel import strategies as S
    from theanompi_tpu_torch.utils.helper_funcs import flatten_tree, tree_map
    proc = MeshProcess({"device": "cpu", "rank": int(rank),
                        "n_workers": int(world), "init_method": init_method,
                        "verbose": False})
    proc.get_internode_comm()
    try:
        shapes = TinyVGGNet({"device": "cpu", "verbose": False}).params
        r = np.random.RandomState(100 + int(rank))
        grads = tree_map(lambda p: torch.from_numpy(
            r.randn(*p.shape).astype(np.float32)), shapes)
        strat = {"onebit": S.OneBit, "topk": lambda: S.TopK(chunk=256),
                 "powersgd": lambda: S.PowerSGD(rank=1)}[strategy]()
        flat = flatten_tree(grads, pad_to_multiple_of=32768)
        mean, state = strat(grads, strat.init_state(grads), size=int(world))
        np.savez(f"{out}_r{rank}.npz", flat=flat.numpy(),
                 mean=flatten_tree(mean).numpy(),
                 **_state_arrays(state, "state"))
    finally:
        proc.close()


def run_ranks(mode, world, tmp_path, tag, *args, timeout=120):
    """Run ``mode`` in ``world`` processes over one gloo group (a file
    store in ``tmp_path``); returns each rank's output as a dict of
    arrays, in rank order."""
    here = os.path.dirname(os.path.abspath(__file__))
    init = "file://" + os.path.join(str(tmp_path), f"store_{tag}")
    out = os.path.join(str(tmp_path), f"out_{tag}")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [here, os.path.dirname(here), os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(here, "torch_port_helper.py"), mode,
         str(r), str(world), init, out, *map(str, args)], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(world)]
    logs = [p.communicate(timeout=timeout)[0].decode() for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    res = []
    for r in range(world):
        with np.load(f"{out}_r{r}.npz") as z:
            res.append({k: z[k] for k in z.files})
    return res


def island(proc, addr, rule, throttle, seconds):
    import json
    import time
    from theanompi_tpu_torch.parallel.async_easgd import AsyncEASGDTrainer
    proc, throttle, seconds = int(proc), float(throttle), float(seconds)
    tr = AsyncEASGDTrainer(TinyLRNNet, {
        "async_islands": 1, "alpha": 0.5, "sync_freq": 2, "device": "cpu",
        "center_addr": addr, "island_base": proc, "verbose": False,
        "island_throttle": throttle}, rule=rule)
    if seconds < 0:
        tr.start()
        deadline = time.time() + 300
        isl = tr.islands[0]
        while (isl.exchanges_done < 2 and isl.error is None
               and time.time() < deadline):
            time.sleep(0.05)
        tr.stop_and_join(timeout=120)
    else:
        tr.run_for(seconds)
    print("ST " + json.dumps({"proc": proc, **tr.stats()}), flush=True)


def main(argv):
    if argv[0] == "island":
        island(*argv[1:])
    elif argv[0] == "train":
        train(*argv[1:])
    elif argv[0] == "resume":
        resume(*argv[1:])
    elif argv[0] == "rules":
        rules(*argv[1:])
    elif argv[0] == "gossip":
        gossip(*argv[1:])
    else:
        exchange(*argv)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
