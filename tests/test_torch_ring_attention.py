"""The port's ring attention (``ops/ring_attention.ring_attention`` over a
seq group of ``base.Grid``) against single-device attention
(``attention_reference``, the port's and its autograd) and the JAX
package's ``ring_attention`` under ``shard_map`` on a CPU mesh (what
``ring_attention_sharded`` runs): sp = 2 and 4, causal
and not, the forward and the gradients of ``sum(out · w)``.

One spawn of 4 gloo ranks runs both grids (sp = 4 at dp = 1, then sp = 2
at dp = 2: two seq groups).  Tolerances are ``tests/test_ring_attention.py``'s:
forward rtol/atol 2e-5, gradients 5e-4 (f32 sums in another order).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from theanompi_tpu.jax_compat import shard_map
from theanompi_tpu.ops import ring_attention as jra

import torch_mp_helper as mh
from theanompi_tpu_torch.ops.ring_attention import attention_reference

B, H, T, D = 2, 3, 64, 16
GRIDS = {"sp4": dict(n_workers=1, sp=4), "sp2": dict(n_workers=2, sp=2)}
FWD_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=5e-4, atol=5e-4)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ring")
    r = np.random.RandomState(5)
    q, k, v, w = (r.randn(B, H, T, D).astype(np.float32) for _ in range(4))
    np.savez(str(tmp / "qkvw.npz"), q=q, k=k, v=v, w=w)
    spawned = mh.spawn("ring", 4, tmp, "ring",
                       dict(grids=GRIDS, inputs=str(tmp / "qkvw.npz")))
    want = {}
    for causal in (False, True):
        ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
        out = attention_reference(*ts, causal=causal)
        (out * torch.from_numpy(w)).sum().backward()
        want[causal] = [out.detach().numpy()] + [t.grad.numpy() for t in ts]
    jax_out = {}
    for n in (2, 4):
        mesh = Mesh(np.asarray(jax.devices()[:n]), ("seq",))
        spec = P(None, None, "seq", None)
        for causal in (False, True):
            fn = shard_map(partial(jra.ring_attention, axis="seq",
                                   causal=causal), mesh=mesh,
                           in_specs=(spec,) * 3, out_specs=spec)
            sh = NamedSharding(mesh, spec)
            args = [jax.device_put(jnp.asarray(a), sh) for a in (q, k, v)]
            o = jax.jit(fn)(*args)
            grads = jax.jit(jax.grad(lambda a, b, c: jnp.sum(fn(a, b, c) * w),
                                     argnums=(0, 1, 2)))(*args)
            jax_out[(n, causal)] = [np.asarray(o)] + [np.asarray(g)
                                                      for g in grads]
    return {"want": want, "jax": jax_out, "ranks": mh.collect(spawned)}


def _blocks(run, tag, causal):
    """Each seq block's [out, dq, dk, dv] from the ranks (one seq group's
    ranks: the first ``sp`` of the world)."""
    key = f"{tag}_{'causal' if causal else 'full'}"
    sp = GRIDS[tag]["sp"]
    got = [[] for _ in range(4)]
    for res in run["ranks"][:sp]:
        for i, n in enumerate(("out", "dq", "dk", "dv")):
            got[i].append(res[f"{key}_{n}"])
    return [np.concatenate(g, axis=2) for g in got]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("tag", list(GRIDS))
def test_ring_matches_full_attention(run, tag, causal):
    got = _blocks(run, tag, causal)
    want = run["want"][causal]
    np.testing.assert_allclose(got[0], want[0], **FWD_TOL)
    for g, w_, name in zip(got[1:], want[1:], ("dq", "dk", "dv")):
        np.testing.assert_allclose(g, w_, err_msg=name, **GRAD_TOL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("tag", list(GRIDS))
def test_ring_matches_jax_ring(run, tag, causal):
    got = _blocks(run, tag, causal)
    want = run["jax"][(GRIDS[tag]["sp"], causal)]
    np.testing.assert_allclose(got[0], want[0], **FWD_TOL)
    for g, w_, name in zip(got[1:], want[1:], ("dq", "dk", "dv")):
        np.testing.assert_allclose(g, w_, err_msg=name, **GRAD_TOL)


def test_seq_groups_of_a_two_worker_grid_agree(run):
    """At sp = 2 × dp = 2 the two workers' seq groups compute the same
    blocks (same inputs), each rank its own seq coordinate."""
    ranks = run["ranks"]
    assert [int(r["sp2_seq"]) for r in ranks] == [0, 1, 0, 1]
    assert [int(r["sp4_seq"]) for r in ranks] == [0, 1, 2, 3]
    for key in ("sp2_full_out", "sp2_causal_dk"):
        np.testing.assert_array_equal(ranks[0][key], ranks[2][key])
        np.testing.assert_array_equal(ranks[1][key], ranks[3][key])
