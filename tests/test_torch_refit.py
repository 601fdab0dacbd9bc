"""Checkpoints resumed on another worker count (``ModelBase.load``'s refit,
``convert.checkpoint_from_jax``), against the JAX package's elastic
resume (``theanompi_tpu/models/model_base.py:1167-1250``,
``tests/test_fsdp.py:235``, ``tests/test_checkpoint_and_data.py:143``).

* ``zero.rechunk_boxed`` bit for bit the JAX function over random arrays;
  ``FsdpLayout.rechunk`` (over the port's aligned layout) the identity on
  the data through any sequence of worker counts, and rows of another
  width refused as another model config;
* one launch of 4 gloo ranks (``torch_elastic_helper.py``'s ``refit``
  mode): BSP, ZeRO-1 with Adam and FSDP with Adam trained 3 steps and
  saved on 4 ranks and on 2, each file loaded on the other count: params
  and optimizer state in the unsharded layout (Adam's moments and count
  included) bit for bit the saving run's on every rank, and 2 more steps
  with finite costs and the replicas equal; the ``topk`` wire's and
  GoSGD's per-rank state refused with the JAX package's text ("no
  worker-count refit"), another model's file refused by name; a JAX FSDP
  and a JAX ZeRO-1 checkpoint of 4 workers converted into the 2-rank port
  model, bit for bit the JAX state, and a JAX EASGD one refused;
* ZeRO-1 on dp 2 × tp 2 (the LM, Adam) resumed on dp 1 × tp 2
  (``torch_mp_helper``'s ``pp`` mode): the global params and Adam's
  joined first moment bit for bit, and training going on;
* one resume through ``python -m theanompi_tpu_torch.launcher
  --n-workers 2`` from the 4-rank BSP checkpoint.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from theanompi_tpu.parallel import exchanger as JX
from theanompi_tpu.parallel import zero as JZ
from theanompi_tpu.parallel.fsdp import FsdpLayout as JFsdp
from theanompi_tpu_torch.parallel import zero as TZ
from theanompi_tpu_torch.parallel.fsdp import FsdpLayout
from theanompi_tpu_torch.utils import helper_funcs as TH

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, HERE)
import torch_elastic_helper as eh  # noqa: E402
import torch_mp_helper as mh  # noqa: E402
import torch_port_helper as helper  # noqa: E402
from test_torch_alexnet_bsp import _JTinyLRNNet  # noqa: E402
from test_torch_sharding import _jax_unsharded  # noqa: E402



# -- the layouts ---------------------------------------------------------------

@pytest.mark.parametrize("n_s,n_new,shards,local_total", [
    (4, 2, 1, 1173), (2, 4, 1, 1173), (3, 5, 2, 41), (8, 1, 3, 40),
    (1, 4, 2, 7)])
def test_rechunk_boxed_bit_equal_to_jax(n_s, n_new, shards, local_total):
    r = np.random.RandomState(n_s * 100 + n_new)
    arr = r.randn(n_s, shards * -(-local_total // n_s)).astype(np.float32)
    got = TZ.rechunk_boxed(arr, n_new, shards, local_total)
    want = JZ.rechunk_boxed(arr, n_new, shards, local_total)
    assert got.shape == want.shape == (n_new,
                                       shards * -(-local_total // n_new))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("counts", [[4, 8, 3, 4], [1, 5, 1], [2, 4, 2]])
def test_fsdp_rechunk_round_trips_through_any_counts(counts):
    """The JAX ``test_rechunk_roundtrips_across_worker_counts`` over the
    port's aligned layout: the rows after any sequence of counts hold the
    same params (its gaps and pad zeros), and the JAX layout of the same
    tree re-slices the same dense values."""
    rng = np.random.RandomState(0)
    params = {"a": rng.randn(13, 7).astype(np.float32),
              "b": rng.randn(29).astype(np.float32)}
    lay = {n: FsdpLayout(params, n) for n in counts}
    boxed = lay[counts[0]].chunk_host(params)
    for n in counts[1:]:
        boxed = lay[n].rechunk(boxed)
        assert boxed.shape == (n, lay[n].chunk)
    back = lay[counts[-1]].host_params_from_chunks(boxed)
    for k in params:
        np.testing.assert_array_equal(back[k], params[k])
    jl = {n: JFsdp(params, n) for n in counts}
    jb = jl[counts[0]].chunk_host(params)
    for n in counts[1:]:
        jb = jl[n].rechunk(jb)
    np.testing.assert_array_equal(
        jb.reshape(-1)[:jl[counts[-1]].n_total],
        np.concatenate([params["a"].reshape(-1), params["b"]]))


def test_fsdp_rechunk_refuses_rows_of_another_layout():
    params = {"a": np.zeros((13, 7), np.float32)}
    with pytest.raises(ValueError, match="different model config"):
        FsdpLayout(params, 2).rechunk(np.zeros((4, 30), np.float32))


# -- checkpoints of 4 ranks on 2, and of 2 on 4 ---------------------------------

def _jax_ckpts(tmp):
    """JAX checkpoints written at 4 workers after 2 steps, and the JAX
    state in the port's unsharded layout."""
    dirs, want = [], {}
    for case, (rule, cfg) in eh.JAX_CASES.items():
        cfg = dict(cfg, n_workers=4, batch_size=eh.BATCH, verbose=False,
                   rule=rule)
        jm = _JTinyLRNNet(cfg)
        jm.compile_iter_fns(JX.get_exchanger(rule, cfg))
        jm.data.shuffle_data(0)
        for count in (1, 2):
            jm.train_iter(count)
        d = str(tmp / f"jax_{case}")
        jm.save(d, epoch=0, count=2)
        if rule == "bsp":
            want[case] = _jax_unsharded(jm)
        dirs.append(f"jax_{case}={d}")
    return dirs, want


@pytest.fixture(scope="module")
def refit(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("refit")
    dirs, want = _jax_ckpts(tmp)
    ck = str(tmp / "ck")
    ranks = helper.run_ranks("refit", 4, tmp, "refit", ck, *dirs,
                             script="torch_elastic_helper.py", timeout=240)
    return ranks, want, ck


def _state_keys(st, prefix):
    pre = prefix + "/"
    return sorted(k[len(pre):] for k in st if k.startswith(pre)
                  and k[len(pre):].startswith(("params/", "opt/")))


REFITS = [c for c, (_, _, refused) in eh.REFIT_CASES.items() if not refused]


def _chunk(case, n):
    """A rank's chunk of TinyLRNNet at ``n`` ranks: ZeRO-1's of the dense
    flat vector, FSDP's of its aligned one."""
    params = helper.TinyLRNNet({"device": "cpu", "verbose": False}).params
    if case == "fsdp":
        return FsdpLayout(params, n).chunk
    return -(-TH.tree_size(params) // n)


@pytest.mark.parametrize("case", REFITS)
@pytest.mark.parametrize("src,dst", [(4, 2), (2, 4)])
def test_resume_on_another_count_is_bit_equal(refit, src, dst, case):
    ranks, _, _ = refit
    saved = ranks[0]
    keys = _state_keys(saved, f"save{src}/{case}")
    assert keys and any(k.startswith("opt/") for k in keys)
    for r in range(dst):
        st = ranks[r]
        assert int(st[f"load{src}to{dst}/{case}/epoch"]) == 0
        assert _state_keys(st, f"load{src}to{dst}/{case}") == keys
        for k in keys:
            np.testing.assert_array_equal(
                st[f"load{src}to{dst}/{case}/{k}"],
                saved[f"save{src}/{case}/{k}"], err_msg=f"rank {r} {k}")
        # a chunked layout holds this count's chunk: Adam's m and v
        if case != "bsp":
            assert int(st[f"load{src}to{dst}/{case}/elems/opt"]) == \
                2 * _chunk(case, dst)


@pytest.mark.parametrize("case", REFITS)
@pytest.mark.parametrize("src,dst", [(4, 2), (2, 4)])
def test_training_continues_after_the_refit(refit, src, dst, case):
    ranks, _, _ = refit
    pre = f"load{src}to{dst}/{case}"
    costs = ranks[0][f"{pre}/costs"]
    assert costs.shape == (2,) and np.isfinite(costs).all()
    keys = _state_keys(ranks[0], f"{pre}/after")
    assert keys
    for r in range(1, dst):
        np.testing.assert_array_equal(ranks[r][f"{pre}/costs"], costs)
        for k in keys:
            np.testing.assert_array_equal(ranks[r][f"{pre}/after/{k}"],
                                          ranks[0][f"{pre}/after/{k}"],
                                          err_msg=f"rank {r} {k}")
    # the steps moved the params off the loaded ones
    assert any(not np.array_equal(ranks[0][f"{pre}/after/{k}"],
                                  ranks[0][f"{pre}/{k}"])
               for k in keys if k.startswith("params/"))


@pytest.mark.parametrize("case", ["topk", "gosgd"])
@pytest.mark.parametrize("src,dst", [(4, 2), (2, 4)])
def test_per_rank_state_with_no_refit_is_refused(refit, src, dst, case):
    ranks, _, _ = refit
    for r in range(dst):
        msg = str(ranks[r][f"load{src}to{dst}/{case}/refused"])
        assert f"saved on {src} workers" in msg
        assert "no worker-count refit" in msg
        assert "'extra'" in msg


@pytest.mark.parametrize("case,match", [
    ("zero", "different model or grid config"),
    ("fsdp", "different model config")])
def test_another_model_config_is_refused_by_name(refit, case, match):
    ranks, _, _ = refit
    for r in range(2):
        assert match in str(ranks[r][f"load4to2/{case}-other/refused"])


@pytest.mark.parametrize("case", ["zero", "fsdp"])
def test_jax_checkpoint_of_four_workers_converts_into_two_ranks(refit, case):
    ranks, want, _ = refit
    params, vel = want[case]
    for r in range(2):
        st = ranks[r]
        assert int(st[f"jax/{case}/epoch"]) == 0
        for kind, tree in (("params", params), ("opt", vel)):
            for p in TH.leaf_paths(tree):
                name = "/".join(p)
                np.testing.assert_array_equal(
                    st[f"jax/{case}/{kind}/{name}"], TH.get_leaf(tree, p),
                    err_msg=f"rank {r} {kind} {name}")


def test_jax_replicas_of_four_workers_are_refused(refit):
    """A JAX EASGD checkpoint keeps each worker's replica: converting it
    for 2 ranks raises with the JAX package's text."""
    ranks, _, _ = refit
    for r in range(2):
        msg = str(ranks[r]["jax/easgd/refused"])
        assert "saved on 4 workers" in msg and \
            "no worker-count refit" in msg


# -- ZeRO-1 on a grid, and the launcher -----------------------------------------

def test_zero_on_a_grid_resumes_on_fewer_workers(tmp_path):
    """dp 2 × tp 2 (4 ranks, Adam, 3 steps, a save) resumed on dp 1 × tp 2
    (2 ranks): the ``[dp, shards·chunk]`` rows re-partition, the global
    params and Adam's first moment bit for bit, then 2 finite steps."""
    ck = str(tmp_path / "ck")
    grid = dict(tp=2, zero_opt=True)
    world = mh.spawn("pp", 4, tmp_path, "zgrid", dict(init_npz="", phases={
        "g4": dict(steps=3, save=ck, cfg=dict(grid, n_workers=2)),
        "g2": dict(world=2, load=ck, at=3, steps=2,
                   cfg=dict(grid, n_workers=1))}))
    ranks = mh.collect(world, timeout=240)
    from torch_mp_jax import part
    saved, saved_m = part(ranks[0], "g4"), part(ranks[0], "g4_m")
    assert saved and saved_m
    for r in range(2):
        res = ranks[r]
        assert int(res["g2_epoch"]) == 0
        for k, v in saved.items():
            np.testing.assert_array_equal(res[f"g2_loaded/{k}"], v,
                                          err_msg=f"rank {r} {k}")
        for k, v in saved_m.items():
            np.testing.assert_array_equal(res[f"g2_loaded_m/{k}"], v,
                                          err_msg=f"rank {r} m {k}")
        assert np.isfinite(res["g2_costs"]).all()


def test_launcher_resumes_a_four_rank_checkpoint_on_two(refit, tmp_path):
    _, _, ck = refit
    d = str(tmp_path / "bsp")
    import shutil
    shutil.copytree(os.path.join(ck, "w4", "bsp"), d)
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [HERE, REPO, os.environ.get("PYTHONPATH", "")]))
    r = subprocess.run(
        [sys.executable, "-m", "theanompi_tpu_torch.launcher",
         "--modelfile", "torch_port_helper", "--modelclass",
         "TinyLRNNetFrom", "--n-workers", "2", "device=cpu",
         f"batch_size={eh.BATCH}", "epochs=2", f"ckpt_dir={d}",
         "resume=true"], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=240)
    out = r.stdout + r.stderr
    assert r.returncode == 0, out[-3000:]
    assert "resumed from epoch 0" in out
    with open(os.path.join(d, "ckpt_epoch1.json")) as f:
        meta = json.load(f)
    assert meta["n_workers"] == 2 and meta["epoch"] == 1
