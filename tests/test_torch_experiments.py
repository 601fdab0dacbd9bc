"""The paper's four experiments as the port's tools, against the JAX
package's scripts (``scripts/gosgd_mixing.py``,
``scripts/rules_time_to_acc.py``, ``scripts/scaling_sweep.py``,
``scripts/async_vs_sync_easgd.py``).

* ``gosgd_mixing`` at 4 gloo ranks, d = 64, 10 exchanges: at ``--prob 1``
  with one routing table in the family (``gosgd_n_perms`` 1) the
  variance curves of ``perm`` and ``iid`` equal the JAX run's within 1e-5
  relative; ``shift`` draws its shift from the PRNG (the JAX key against
  the port's ``(gosgd_seed, count)``), so it is held at 2 ranks, where
  the only shift is the swap.  At ``--prob 0.25``: Σα conserved, the
  variance falls.
* ``rules_time_to_acc`` at 2 gloo ranks on Cifar10 (synthetic_train 128,
  2 epochs, float32, dropout at rate 0 in both packages, learning rate
  0.002 for every rule through ``--cfg``: see ``PARITY_LR``), each rule
  from the JAX model's initial checkpoint through
  ``convert.checkpoint_from_jax`` (``--init-from``): BSP, EASGD and ASGD,
  and GoSGD at ``exch_prob`` 1 (its route at 2 ranks the swap), each
  epoch's validation error within one sample's share of the JAX run's and
  its cost within 1e-4 relative.  Each rule also runs once with its
  exchange broken through the config (``FAULTS``: BSP's all-reduce
  dropped, EASGD's alpha 0, ASGD's push never due, GoSGD's swap never
  sent), and its cost must leave that band: at this size the faults land
  2.7e-2 to 0.31 relative from the JAX run, the sound runs within 9e-6.
* ``scaling_sweep --measure-comm --json`` at 2 gloo ranks: a
  ``comm_share`` in every row, a row with 2 workers, and the JAX rows'
  keys.
* ``async_vs_sync_easgd`` at 2 gloo ranks and 2 island threads: the JAX
  script's JSON keys, in the output and in ``--out``.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from theanompi_tpu.models.cifar10 import Cifar10_model as JCifar
from theanompi_tpu.parallel import exchanger as JEX
from theanompi_tpu.utils.recorder import Recorder as JRecorder

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(REPO, "scripts"))
import torch_port_helper as helper  # noqa: E402

ENV = dict(os.environ, **helper.RANK_ENV, PYTHONPATH=os.pathsep.join(
    [HERE, REPO, os.environ.get("PYTHONPATH", "")]))


def _tool(name, *args, timeout=300):
    r = subprocess.run(
        [sys.executable, "-m", f"theanompi_tpu_torch.tools.{name}", *args],
        cwd=REPO, env=ENV, capture_output=True, text=True, timeout=timeout)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    return r.stdout


# -- gosgd_mixing ---------------------------------------------------------------

GOSSIP = dict(d=64, iters=10)


@pytest.fixture(scope="module")
def jax_gossip():
    """The JAX script's curves at --prob 1, one table a family: perm and
    iid at 4 workers, shift at 2; seeds 0 and 1."""
    import gosgd_mixing as jg
    out = {}
    for mode, n in (("perm", 4), ("iid", 4), ("shift", 2)):
        for seed in (0, 1):
            out[mode, n, seed] = jg.run_mode(mode, n, GOSSIP["d"],
                                             GOSSIP["iters"], seed, prob=1.0,
                                             n_perms=1)
    return out


def test_gosgd_mixing_curves_equal_jax_at_prob_1(jax_gossip):
    from theanompi_tpu_torch.tools import gosgd_mixing as tg
    for n, modes in ((4, ("perm", "iid")), (2, ("shift",))):
        jobs = [(m, 1, s) for m in modes for s in (0, 1)]
        got = tg.curves(jobs, n, GOSSIP["d"], GOSSIP["iters"], 1.0)
        for (mode, _, seed), g in zip(jobs, got):
            want = jax_gossip[mode, n, seed]
            np.testing.assert_allclose(g["curve"], want, rtol=1e-5,
                                       err_msg=f"{mode} seed {seed}")
            assert g["curve"][-1] < 0.5 * g["curve"][0]
            np.testing.assert_allclose(sum(g["alpha"]), n, rtol=1e-6)


def test_gosgd_mixing_at_prob_quarter_conserves_alpha():
    """Pure gossip at the reference's send probability, every mode and a
    K-sweep family: Σα stays the worker count, α > 0, and the variance
    falls."""
    from theanompi_tpu_torch.tools import gosgd_mixing as tg
    jobs = [(m, k, s) for m, k in (("perm", 16), ("shift", 16),
                                   ("iid", 16), ("perm", 4))
            for s in (0, 1)]
    for g in tg.curves(jobs, 4, GOSSIP["d"], GOSSIP["iters"], 0.25):
        np.testing.assert_allclose(sum(g["alpha"]), 4.0, rtol=1e-6)
        assert min(g["alpha"]) > 0
        assert g["curve"][-1] < g["curve"][0]
    # the command line: the JAX script's summary keys for every mode
    out = json.loads(_tool("gosgd_mixing", "--host-devices", "4", "--dim",
                           "64", "--iters", "10", "--seeds", "2")
                     .strip().splitlines()[-1])
    assert sorted(out) == ["iid", "perm", "shift"]
    for s in out.values():
        assert set(s) == {"decay_per_exchange", "exchanges_to_half_variance",
                          "variance_ratio_at_10"}
        assert 0 < s["decay_per_exchange"] < 1


# -- rules_time_to_acc ---------------------------------------------------------

# the parity's learning rate: the script's 0.02 puts this tiny run in a
# chaotic regime (the cost jumps from 2.31 to 6.14 at the second step at
# 2 ranks), where the packages' float32 differences in the convolutions'
# sums (2e-6 relative at world 1, where 16 steps at 0.02 stay within 4e-6)
# grow tenfold a step; at 0.002 both rules' trajectories stay within 1e-5
PARITY_LR = 0.002
RULES_CFG = dict(synthetic_train=128, synthetic_val=64, batch_size=16,
                 compute_dtype="float32", learning_rate=PARITY_LR,
                 scale_lr=False, verbose=False)
RULE_EXTRA = {"BSP": {}, "EASGD": {"sync_freq": 2, "alpha": 0.1},
              "ASGD": {"sync_freq": 2}, "GOSGD": {"exch_prob": 1.0}}
EPOCHS = 2


def _jax_rule(rule, ckpt_dir):
    """The JAX rule at 2 workers, dropout at rate 0, its initial state
    checkpointed into ``ckpt_dir``, then driven as its worker drives it:
    the validation error and cost of each epoch."""
    jm = JCifar(dict(RULES_CFG, **RULE_EXTRA[rule], n_workers=2))
    helper.zero_dropout(jm.seq.layers)
    ex = JEX.get_exchanger(rule.lower(), jm.config)
    jm.compile_iter_fns(ex)
    jm.save(ckpt_dir, 0)
    count, errs, costs = 0, [], []
    for epoch in range(EPOCHS):
        jm.adjust_hyperp(epoch)
        jm.data.shuffle_data(epoch + jm.seed)
        for _ in range(jm.data.n_batch_train):
            count += 1
            jm.train_iter(count)
            ex.exchange(None, count)
        rec = JRecorder({"verbose": False})
        jm.begin_val()
        for _ in range(jm.data.n_batch_val):
            jm.val_iter(count, rec)
        jm.end_val()
        v = rec.print_val_info(count)
        errs.append(float(v["val_error"]))
        costs.append(float(v["val_cost"]))
    return errs, costs


# each rule's exchange broken through its config: the run must leave the
# parity band, or the band would not catch a broken rule
FAULTS = {"BSP": {"exch_strategy": "none"}, "EASGD": {"alpha": 0.0},
          "ASGD": {"sync_freq": 10 ** 6}, "GOSGD": {"exch_prob": 0.0}}


def _port_rule(tmp_path, rule, ck, name, cfg):
    out = str(tmp_path / f"{name}.json")
    _tool("rules_time_to_acc", "0.5", "--host-devices", "2", "--rules",
          rule, "--epochs", str(EPOCHS), "--synthetic-train", "128",
          "--synthetic-val", "64", "--modelfile", "torch_port_helper",
          "--modelclass", "Cifar10NoDrop", "--init-from", ck, "--out", out,
          "--cfg", json.dumps(cfg))
    with open(out) as f:
        rows = [json.loads(line) for line in f]
    assert len(rows) == 1
    return rows[0]


@pytest.mark.parametrize("rule", ["BSP", "EASGD", "ASGD", "GOSGD"])
def test_rules_time_to_acc_epochs_equal_jax(tmp_path, rule):
    ck = str(tmp_path / "ck")
    errs, costs = _jax_rule(rule, ck)
    cfg = {"learning_rate": PARITY_LR,
           **({"exch_prob": 1.0} if rule == "GOSGD" else {})}
    row = _port_rule(tmp_path, rule, ck, "sound", cfg)
    assert {"rule", "target_acc", "epochs_budget", "epochs_to_target",
            "secs_to_target_approx", "wall_secs_total", "best_acc",
            "acc_by_epoch", "platform"} <= set(row)
    assert row["rule"] == rule and row["platform"].startswith("cpu-gloo-2")
    got_err = [1.0 - a for a in row["acc_by_epoch"]]
    np.testing.assert_allclose(got_err, errs, rtol=0,
                               atol=1.0 / RULES_CFG["synthetic_val"] + 1e-4)
    np.testing.assert_allclose(row["val_cost_by_epoch"], costs, rtol=1e-4)
    bad = _port_rule(tmp_path, rule, ck, "fault", dict(cfg, **FAULTS[rule]))
    gap = np.max(np.abs(np.subtract(bad["val_cost_by_epoch"], costs))
                 / np.abs(costs))
    assert gap > 1e-2, f"{rule} with {FAULTS[rule]}: cost within {gap:.2g}"


# -- scaling_sweep and async_vs_sync_easgd --------------------------------------

def test_scaling_sweep_comm_share_and_jax_keys():
    """The port's mirror of the JAX ``test_scaling_sweep_comm_share``, and
    its rows' keys against a JAX row made by the JAX script's
    ``measure`` (one worker, one step)."""
    import scaling_sweep as js
    from theanompi_tpu.models.registry import MODELS as JMODELS
    jrow = js.measure(*JMODELS["cifar10"], 1, "allreduce", 8, 1, 0)
    want = set(jrow) | {"scaling_efficiency", "comm_share"}
    out = _tool("scaling_sweep", "--model", "cifar10", "--strategies",
                "allreduce", "--iters", "2", "--warmup", "1", "--batch-size",
                "8", "--json", "--measure-comm", "--host-devices", "2")
    rows = [json.loads(line) for line in out.splitlines()
            if line.startswith("{")]
    assert rows, out
    assert all("comm_share" in row for row in rows)
    assert any(row["workers"] > 1 for row in rows)
    assert all(set(row) == want for row in rows)
    assert [r["comm_share"] for r in rows if r["workers"] == 1] == [0.0]


def test_async_vs_sync_easgd_json_has_the_jax_keys(tmp_path):
    out_path = str(tmp_path / "avs.json")
    out = json.loads(_tool("async_vs_sync_easgd", "--host-devices", "2",
                           "--steps", "4", "--seconds", "2", "--batch", "8",
                           "--out", out_path).strip().splitlines()[-1])
    assert set(out) == {"platform", "devices", "islands", "batch_per_chip",
                        "sync_easgd_samples_per_sec",
                        "async_islands_samples_per_sec", "async_over_sync",
                        "note"}
    assert out["platform"] == "cpu" and out["devices"] == 2
    assert out["sync_easgd_samples_per_sec"] > 0 and \
        out["async_islands_samples_per_sec"] > 0
    with open(out_path) as f:
        assert json.loads(f.read()) == out
