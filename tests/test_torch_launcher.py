"""The port's launcher and worker command line
(``theanompi_tpu_torch/launcher.py``, ``worker.main``) against the JAX
package's, and the worlds it starts on CPU gloo.

* ``--emit-only`` with ``--num-hosts 2 --n-workers 2``: 4 rank lines with
  their ``rank``, ``local_rank``, ``n_workers`` and ``init_method``, and
  the rest of each line (rule, modelfile, modelclass, config) as
  ``theanompi_tpu.launcher.compose_worker_cmd`` composes it.
* ``key=value`` words parse to the same config through both workers'
  ``main``.
* Worlds of 2 and 4 ranks (``torch_launch_helper``'s ``wires`` mode in
  each rank, every wire in one launch of ``launcher.run_world``): params, optimizer state and BatchNorm state
  bit-identical on every rank under allreduce, onebit, topk, PowerSGD and
  the narrow ResNet's ``sync_bn``; at 4 ranks allreduce and onebit against
  the JAX package at ``n_workers=4`` on the conftest's 8 host devices,
  from the same weights through ``convert.py``, float32, no dropout.
* Supervision: a 2-rank world SIGKILLed after epoch 0's checkpoint
  restarts and ends bit-equal to an unkilled run; the crash-loop breaker,
  ``--min-uptime`` and an exhausted restart budget exit nonzero; a rank
  that raises stops its world with no child left.
* The refusals: the A10 flags, the keys the launcher owns, more ranks than
  visible GPUs, a ``local_rank`` past the device count.

Every world runs with ``OMP_NUM_THREADS=1`` (ranks share this host's
cores) and a timeout.
"""

import os
import shlex
import signal
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

from theanompi_tpu import launcher as JL
from theanompi_tpu import worker as JW
from theanompi_tpu.parallel import membership as JM
from theanompi_tpu_torch import base as TB
from theanompi_tpu_torch import convert
from theanompi_tpu_torch import launcher as TL
from theanompi_tpu_torch import worker as TW
from theanompi_tpu_torch.parallel import membership as TM
from theanompi_tpu_torch.utils import helper_funcs as TH

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, HERE)
import torch_launch_helper as lh  # noqa: E402
import torch_port_helper as helper  # noqa: E402
from test_torch_alexnet_bsp import _JTinyLRNNet  # noqa: E402
from test_torch_vgg import _JTinyVGGNet  # noqa: E402

ENV = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
    [HERE, REPO, os.environ.get("PYTHONPATH", "")]))
LAUNCH = [sys.executable, "-m", "theanompi_tpu_torch.launcher"]
# per-rank batch at each world size: the tiny set's 16 validation rows
# hold one global batch
BATCH = {2: 8, 4: 4}
EPOCHS = 2


def _launch(args, timeout=240, **kw):
    """The launcher in a process of its own: (rc, its and its ranks'
    output)."""
    r = subprocess.run(LAUNCH + list(args), cwd=REPO, env=ENV,
                       capture_output=True, text=True, timeout=timeout, **kw)
    return r.returncode, r.stdout + r.stderr


def _host(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _save_init(jm, path):
    init = convert.params_from_jax(_host(jm.params))
    np.savez(path, **{"/".join(p): TH.get_leaf(init, p)
                      for p in TH.leaf_paths(init)})
    return path


# -- composing the lines --------------------------------------------------------

def _rank_lines(out):
    return [shlex.split(ln.split(": ", 1)[1]) for ln in out.splitlines()
            if ln.startswith("#   rank ")]


@pytest.mark.parametrize("kv", [[], ["device=cpu", "batch_size=4"],
                                ["exch_strategy=onebit", "lr=0.01",
                                 "ckpt_dir=/tmp/a b"]])
def test_emit_only_composes_every_hosts_ranks(kv, capsys):
    rc = TL.main(["--emit-only", "--num-hosts", "2", "--n-workers", "2",
                  "--coordinator", "10.0.0.1:29500", "--rule", "easgd",
                  "--modelfile", "torch_port_helper", "--modelclass",
                  "TinyLRNNet"] + kv)
    assert rc == 0
    out = capsys.readouterr().out
    lines = _rank_lines(out)
    assert len(lines) == 4
    want = JL.compose_worker_cmd("easgd", "torch_port_helper", "TinyLRNNet",
                                 kv)
    assert want[3] == "theanompi_tpu.worker"
    for r, cmd in enumerate(lines):
        assert cmd[:4] == [sys.executable, "-u", "-m",
                           "theanompi_tpu_torch.worker"]
        keys = dict(w.partition("=")[::2] for w in cmd[7:11])
        assert keys == {"rank": str(r), "n_workers": "4",
                        "local_rank": str(r % 2),
                        "init_method": "tcp://10.0.0.1:29500"}
        assert cmd[4:7] + cmd[11:] == want[4:]
    # each host's launcher line runs its share
    hosts = [shlex.split(ln) for ln in out.splitlines()
             if "theanompi_tpu_torch.launcher" in ln]
    assert [h[h.index("--process-id") + 1] for h in hosts] == ["0", "1"]
    assert all(h[-len(kv):] == kv for h in hosts if kv)


def test_compose_worker_cmd_matches_jax_without_ranks():
    kv = ["a=1", "b=x y"]
    got = TL.compose_worker_cmd("bsp", "m", "C", kv)
    want = JL.compose_worker_cmd("bsp", "m", "C", kv)
    assert got[4:] == want[4:] and got[:3] == want[:3]
    assert got[3] == "theanompi_tpu_torch.worker"


def test_worker_parses_key_values_as_jax(monkeypatch):
    argv = ["bsp", "mf", "MC", "a=3", "b=-2", "c=0.5", "d=1e-3", "e=true",
            "f=FALSE", "g=True", "h=text", "i=", "j=a=b", "k=inf", "l=nan",
            "m=007", "n=0x10", "o=1_000"]
    seen = {}

    def fake(tag):
        class W:
            def __init__(self, config):
                seen[tag] = dict(config)

            def build_model(self, mf, mc):
                return None

            def run(self, model):
                return None

            def close(self):
                pass
        return {"bsp": W}

    monkeypatch.setattr(JW, "WORKERS", fake("jax"))
    monkeypatch.setattr(TW, "WORKERS", fake("torch"))
    assert JW.main(list(argv)) == 0
    assert TW.main(list(argv)) == 0
    assert [(k, type(v), repr(v)) for k, v in seen["torch"].items()] == \
        [(k, type(v), repr(v)) for k, v in seen["jax"].items()]
    assert seen["torch"]["e"] is True and seen["torch"]["f"] is False
    assert seen["torch"]["m"] == 7 and seen["torch"]["j"] == "a=b"


def test_worker_usage_and_unknown_rule():
    assert TW.main(["bsp"]) == 1
    assert TW.main(["nope", "m", "C"]) == 1


# -- worlds of 2 and 4 ranks: every wire ------------------------------------------

_WIRES = {}


def _wires(world, tmp_path_factory):
    """Every rank's final state of each ``WIRE_CASES`` run at ``world``
    ranks, from the JAX twins' initial weights; one launch, cached."""
    if world not in _WIRES:
        mp = pytest.MonkeyPatch()
        for k in ("OMP_NUM_THREADS", "PYTHONPATH"):
            mp.setenv(k, ENV[k])
        tmp = tmp_path_factory.mktemp(f"wires{world}")
        npz = _save_init(_JTinyLRNNet({"n_workers": 1, "verbose": False}),
                         str(tmp / "init.npz"))
        vgg = _save_init(_JTinyVGGNet({"n_workers": 1, "verbose": False}),
                         str(tmp / "init_vgg.npz"))
        out = str(tmp / "w")
        try:
            rc = lh.launch("bsp", "-", world, "device=cpu",
                           "helper_mode=wires", f"helper_out={out}",
                           f"batch_size={BATCH[world]}", f"epochs={EPOCHS}",
                           "scale_lr=false", f"init_npz={npz}",
                           f"init_vgg_npz={vgg}")
        finally:
            mp.undo()
        assert rc == 0
        res = []
        for r in range(world):
            with np.load(f"{out}_r{r}.npz") as z:
                res.append({k: z[k] for k in z.files})
        _WIRES[world] = res
    return _WIRES[world]


# the per-rank state each wire keeps: onebit's and topk's error feedback,
# PowerSGD's per-leaf error ``e`` (its ``q`` is shared)
def _per_rank(case, key, ranks):
    if not key.startswith("extra/"):
        return False
    return case in ("onebit", "topk") or (
        case == "powersgd" and not all(np.array_equal(ranks[0][f"{case}/"
                                                               f"{key}"],
                                                      r[f"{case}/{key}"])
                                       for r in ranks))


@pytest.mark.parametrize("case", list(lh.WIRE_CASES))
@pytest.mark.parametrize("world", [2, 4])
def test_launched_world_keeps_replicas_bit_identical(world, case,
                                                     tmp_path_factory):
    ranks = _wires(world, tmp_path_factory)
    keys = sorted(k[len(case) + 1:] for k in ranks[0]
                  if k.startswith(case + "/"))
    assert any(k.startswith("params/") for k in keys)
    n_shared = 0
    for k in keys:
        if _per_rank(case, k, ranks):
            assert all(r[f"{case}/{k}"].shape == ranks[0][f"{case}/{k}"].shape
                       for r in ranks)
            continue
        n_shared += 1
        for r, st in enumerate(ranks[1:], 1):
            np.testing.assert_array_equal(st[f"{case}/{k}"],
                                          ranks[0][f"{case}/{k}"],
                                          err_msg=f"rank {r} {k}")
    if case == "sync_bn":
        assert any(k.startswith("bn/") for k in keys)
    if case in ("onebit", "topk"):
        # the error feedback comes from each rank's own gradient
        assert not np.array_equal(ranks[0][f"{case}/extra/0"],
                                  ranks[1][f"{case}/extra/0"])
    assert n_shared >= 4


def _jax_bsp(cls, strategy, world):
    """The JAX model at ``world`` workers under ``strategy``, driven as its
    worker drives it (epoch schedule, common-seed shuffle, validation)."""
    jm = cls({"n_workers": world, "batch_size": BATCH[world],
              "exch_strategy": strategy, "verbose": False})
    jm.compile_iter_fns()
    count = 0
    for epoch in range(EPOCHS):
        jm.adjust_hyperp(epoch)
        jm.data.shuffle_data(epoch + jm.seed)
        for _ in range(jm.data.n_batch_train):
            count += 1
            jm.train_iter(count)
    return jm


@pytest.mark.parametrize("case,cls", [("allreduce", _JTinyLRNNet),
                                      ("onebit", _JTinyVGGNet)])
def test_four_ranks_match_jax_four_workers(case, cls, tmp_path_factory):
    """Params and momentum at rtol 1e-5 / atol 1e-6: float32, the mean of
    four gradients sums in another order in gloo and in XLA, and the
    gradients themselves in oneDNN and XLA (``test_torch_rules.py``'s
    bound).  Onebit's error state (rank 0's) is ``|c| − scale`` or
    ``scale − |c|``: where the two nearly cancel only c's own error
    remains, so it is held to atol 1e-5·scale as in
    ``test_torch_vgg.py``'s trajectory, with no sign flipped."""
    ranks = _wires(4, tmp_path_factory)
    jm = _jax_bsp(cls, lh.WIRE_CASES[case][1]["exch_strategy"], 4)
    st = _host(jm.step_state)
    want_p = convert.params_from_jax(jax.tree.map(lambda a: a[0],
                                                  st["params"]))
    want_v = convert.params_from_jax(jax.tree.map(lambda a: a[0],
                                                  st["opt_state"]))
    for path in TH.leaf_paths(want_p):
        name = "/".join(path)
        np.testing.assert_allclose(ranks[0][f"{case}/params/{name}"],
                                   TH.get_leaf(want_p, path), rtol=1e-5,
                                   atol=1e-6, err_msg=name)
    like = (helper.TinyVGGNet if case == "onebit" else helper.TinyLRNNet)(
        {"device": "cpu", "verbose": False}).params
    for i, path in enumerate(TH.leaf_paths(like)):       # opt/<i>: port order
        np.testing.assert_allclose(ranks[0][f"{case}/opt/{i}"],
                                   TH.get_leaf(want_v, path), rtol=1e-5,
                                   atol=1e-6, err_msg="velocity " +
                                   "/".join(path))
    if case == "onebit":
        jp0 = _host(cls({"n_workers": 1, "verbose": False}).params)
        want_s = convert.flat_from_jax(np.asarray(st["extra"]["strat"])[0],
                                       jp0, like)
        got_s = ranks[0]["onebit/extra/0"]
        n_true = sum(int(np.prod(v.shape)) for v in TH.tree_leaves(like))
        scale = float(np.abs(got_s[:n_true]).mean())
        assert not (np.abs(got_s - want_s) > scale).any()
        np.testing.assert_allclose(got_s, want_s, rtol=1e-5,
                                   atol=1e-5 * scale)


# -- supervision ------------------------------------------------------------------

def _children(pid):
    """Pids of ``pid``'s child processes, from /proc."""
    out = []
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat") as f:
                stat = f.read()
        except OSError:
            continue
        if int(stat.rsplit(")", 1)[1].split()[1]) == pid:
            out.append(int(d))
    return out


def _cmdline(pid):
    try:
        with open(f"/proc/{pid}/cmdline", "rb") as f:
            return f.read().replace(b"\0", b" ").decode()
    except OSError:
        return ""


def _wait_for(pred, timeout_s, what):
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        got = pred()
        if got:
            return got
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {what}")


def _latest(ckpt):
    try:
        with open(os.path.join(ckpt, "LATEST")) as f:
            return f.read().strip()
    except OSError:
        return None


def test_supervised_sigkill_resume_is_bit_equal(tmp_path):
    """SIGKILL rank 1 of a supervised 2-rank world once epoch 0's
    checkpoint is committed: the launcher stops rank 0, waits its backoff,
    restarts the world with ``resume=true``, and the run ends where an
    unkilled run ends, every array of the final checkpoint bit for bit
    (the counterpart of ``tests/test_chaos.py``'s supervised SIGKILL)."""
    npz = _save_init(_JTinyLRNNet({"n_workers": 1, "verbose": False}),
                     str(tmp_path / "init.npz"))
    runs = {}
    for name in ("killed", "whole"):
        ck = str(tmp_path / name)
        runs[name] = (ck, subprocess.Popen(
            LAUNCH + ["--supervise", "2", "--backoff", "0.1",
                      "--modelfile", "torch_launch_helper", "--modelclass",
                      "SleepyNet", "--n-workers", "2", "device=cpu",
                      "epochs=2", "batch_size=8", "scale_lr=false",
                      "iter_sleep=0.3", f"init_npz={npz}", f"ckpt_dir={ck}",
                      f"tag={name}"],
            cwd=REPO, env=ENV, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    ck, sup = runs["killed"]
    try:
        _wait_for(lambda: _latest(ck) == "0", 180, "epoch 0's checkpoint")
        rank1 = _wait_for(lambda: [p for p in _children(sup.pid)
                                   if "rank=1 " in _cmdline(p) + " "],
                          30, "rank 1")
        os.kill(rank1[0], signal.SIGKILL)
        outs = {n: p.communicate(timeout=300)[0] for n, (_, p) in
                runs.items()}
    finally:
        for _, p in runs.values():
            if p.poll() is None:
                p.terminate()           # the launcher stops its ranks
                try:
                    p.communicate(timeout=30)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.communicate()
    for n, (_, p) in runs.items():
        assert p.returncode == 0, outs[n][-3000:]
    out = outs["killed"]
    assert "restarting in" in out and "resumed from epoch 0" in out, out
    assert "restarting in" not in outs["whole"]
    for _, (ck, _) in runs.items():
        assert _latest(ck) == "1"
    a = np.load(os.path.join(runs["killed"][0], "ckpt_epoch1.npz"))
    b = np.load(os.path.join(runs["whole"][0], "ckpt_epoch1.npz"))
    assert sorted(a.files) == sorted(b.files) and len(a.files) > 4
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("flags,message,restarts", [
    (["--supervise", "6", "--crash-limit", "2"], "crash loop: 2 failures",
     1),
    (["--supervise", "3", "--min-uptime", "600"], "treating as "
     "unrecoverable", 0),
    (["--supervise", "1"], "supervised restarts exhausted (1)", 1)])
def test_supervised_failures_stop_nonzero(flags, message, restarts, capsys):
    """A world that fails at its first step: the breaker trips after
    ``--crash-limit`` failures, ``--min-uptime`` refuses to retry a fast
    failure, and an exhausted budget gives up; each exits nonzero (the
    counterpart of ``test_chaos.py``'s breaker test)."""
    with lh.deadline(240):
        rc = TL.main(flags + ["--rule", "bsp", "--backoff", "0.05",
                              "--modelfile", "torch_launch_helper",
                              "--modelclass", "CrashNet", "--n-workers",
                              "1", "device=cpu", "crash_at=1",
                              "verbose=false"])
    assert rc != 0
    err = capsys.readouterr().err
    assert message in err, err
    assert err.count("restarting in") == restarts
    assert "without ckpt_dir" in err


def test_a_failing_rank_stops_its_world(tmp_path):
    """Rank 1 raises at its second step while rank 0 waits for it in the
    gradient all-reduce: the launcher exits nonzero and leaves no rank
    running (rank 0 is stopped, or its collective fails first when gloo
    sees rank 1's connection close)."""
    tag = f"stopworld{os.getpid()}"
    t0 = time.time()
    rc, log = _launch(["--modelfile", "torch_launch_helper", "--modelclass",
                       "CrashNet", "--n-workers", "2", "device=cpu",
                       "crash_at=2", "crash_rank=1", f"tag={tag}"],
                      timeout=120)
    assert rc != 0
    assert "CrashNet: rank 1 fails at step 2" in log
    assert "exited rc=1; stopping the other ranks" in log
    assert time.time() - t0 < 100
    live = [p for p in os.listdir("/proc") if p.isdigit()
            and tag in _cmdline(int(p))]
    assert not live, [_cmdline(int(p)) for p in live]


def test_crash_loop_breaker_matches_jax():
    class Clock:
        t = 0.0

        def now(self):
            return self.t

    times = [0.0, 10.0, 400.0, 405.0, 406.0, 1000.0, 1001.0]
    trips = []
    for mod in (JM, TM):
        c = Clock()
        b = mod.CrashLoopBreaker(limit=3, window_s=300.0, clock=c)
        out = []
        for t in times:
            c.t = t
            out.append(b.record_failure())
        trips.append(out)
    assert trips[0] == trips[1] == [False, False, False, False, True, False,
                                    False]


# -- refusals ---------------------------------------------------------------------

@pytest.mark.parametrize("flag", [["--elastic", "2"], ["--elastic-steps", "4"],
                                  ["--host-devices", "2"], ["--center-proc"],
                                  ["--compile-cache", "/tmp/cache"]])
def test_a10_flags_are_refused(flag, capsys):
    with pytest.raises(SystemExit) as e:
        TL.main(flag + ["device=cpu"])
    assert e.value.code != 0
    assert "ROADMAP A10" in capsys.readouterr().err


@pytest.mark.parametrize("kv", ["rank=1", "n_workers=2", "local_rank=0",
                                "init_method=tcp://h:1"])
def test_keys_the_launcher_sets_are_refused(kv, capsys):
    with pytest.raises(SystemExit) as e:
        TL.main(["--n-workers", "1", "device=cpu", kv])
    assert e.value.code != 0
    assert "the launcher sets" in capsys.readouterr().err


def test_more_ranks_than_gpus_refused_before_spawning(monkeypatch, capsys):
    def no_spawn(*a, **k):
        raise AssertionError("the launcher spawned a rank")

    monkeypatch.setattr(subprocess, "Popen", no_spawn)
    monkeypatch.setattr(TL, "visible_gpus", lambda: 1)
    with pytest.raises(SystemExit) as e:
        TL.main(["--n-workers", "2"])
    assert e.value.code != 0
    assert "1 visible GPU" in capsys.readouterr().err
    if not torch.cuda.is_available():
        monkeypatch.setattr(TL, "visible_gpus", lambda: 0)
        with pytest.raises(SystemExit):
            TL.main(["--n-workers", "1"])
        assert "CUDA is not available" in capsys.readouterr().err


def test_local_rank_past_the_device_count_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert TB.resolve_device({"local_rank": 0}) == torch.device("cuda", 0)
    with pytest.raises(RuntimeError, match="local_rank 1 .* 1 visible GPU"):
        TB.resolve_device({"local_rank": 1, "rank": 0})
    with pytest.raises(RuntimeError, match="local_rank 3 .* 1 visible GPU"):
        TB.resolve_device({"rank": 3})


def test_record_dir_gets_one_run_id(capsys):
    TL.main(["--emit-only", "--n-workers", "2", "--record-dir", "/tmp/rec",
             "device=cpu"])
    lines = _rank_lines(capsys.readouterr().out)
    ids = {w for c in lines for w in c if w.startswith("run_id=run")}
    assert len(lines) == 2 and len(ids) == 1
    assert all("record_dir=/tmp/rec" in c for c in lines)
