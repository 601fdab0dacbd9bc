"""GAN family: WGAN and LSGAN.

Counterpart of ``theanompi_tpu/models/gan.py``: one step over the combined
``{"G": ..., "D": ...}`` parameter tree, the two objectives decoupled by
detaching, so one backward gives both gradient sets at the current
params (simultaneous-SGD GAN training):

* the critic loss sees the generated images detached (no gradient into G);
  the critic is stateless (no norm layers), so the real and the detached
  fake images share ONE critic pass;
* the generator loss sees the critic through detached critic params (no
  gradient into D).

The reference's "``n_critic`` critic steps per generator step" cadence is
the update hook (``ModelBase.postprocess_update``): off the cadence, G's
params AND every optimizer-state leaf under a ``"G"`` key (momentum,
RMSprop's square average, Adam's moments and its counts, the EMA shadow)
keep their values from before the update, as if the G update were never
called.  The port updates in place, so the step snapshots those leaves
just before the update (:meth:`GAN_ModelBase.snapshot_update`) and the
hook selects, leaf by leaf, the new or the old value with a predicate on
the device (``count % n_critic == 0`` of the step's count tensor), so a
captured step replays one graph on every step.  G's Adam leaves count
their own steps (``ModelBase.gated_path``, ``opt.split_counts``), as the
JAX package's per-leaf counts do.  WGAN's weight clipping rides the same
hook.

Images are NHWC, the generator's output ``tanh`` in [-1, 1].  ``cost`` is
the D + G loss, ``error`` the G loss (so the critic's loss is their
difference).  The noise ``z`` of a step comes from the step's generator
through :meth:`GAN_ModelBase.draw_z`: the JAX package's law, other bits.
"""

from __future__ import annotations

import torch

from ..utils.helper_funcs import leaf_paths, tree_leaves, tree_map
from . import layers as L
from .data.cifar10 import Cifar10_data
from .model_base import ModelBase


def _generator(z_dim: int, base: int, cd) -> L.Sequential:
    """DCGAN-style: z → 4×4×(4·base) → 8×8 → 16×16 → 32×32×3 tanh."""
    return L.Sequential([
        L.FC(z_dim, 4 * 4 * base * 4, w_init=("normal", 0.02),
             activation=None, compute_dtype=cd, name="proj"),
        L.Reshape((4, 4, base * 4), name="reshape"),
        L.BatchNorm(base * 4, name="bn0"),
        L.Activation("relu", name="relu0"),
        L.ConvTranspose(base * 4, base * 2, 5, stride=2, activation=None,
                        compute_dtype=cd, name="up1"),
        L.BatchNorm(base * 2, name="bn1"),
        L.Activation("relu", name="relu1"),
        L.ConvTranspose(base * 2, base, 5, stride=2, activation=None,
                        compute_dtype=cd, name="up2"),
        L.BatchNorm(base, name="bn2"),
        L.Activation("relu", name="relu2"),
        L.ConvTranspose(base, 3, 5, stride=2, activation="tanh",
                        compute_dtype=cd, name="up3"),
    ])


def _critic(base: int, cd) -> L.Sequential:
    """Strided-conv critic, LeakyReLU (0.2), no norm layers: stateless, so
    its two applications thread no BatchNorm state."""
    return L.Sequential([
        L.Conv(3, base, 5, stride=2, padding="SAME", w_init=("normal", 0.02),
               activation="leaky_relu", compute_dtype=cd, name="c1"),
        L.Conv(base, base * 2, 5, stride=2, padding="SAME",
               w_init=("normal", 0.02), activation="leaky_relu",
               compute_dtype=cd, name="c2"),
        L.Conv(base * 2, base * 4, 5, stride=2, padding="SAME",
               w_init=("normal", 0.02), activation="leaky_relu",
               compute_dtype=cd, name="c3"),
        L.Flatten(),
        L.FC(4 * 4 * base * 4, 1, w_init=("normal", 0.02), activation=None,
             compute_dtype=cd, name="score"),
    ])


def _in_g(path) -> bool:
    return "G" in path


class GAN_ModelBase(ModelBase):
    """Shared G/D machinery; subclasses define the two losses."""

    batch_size = 64
    epochs = 50
    n_subb = 1
    learning_rate = 5e-5
    weight_decay = 0.0
    optimizer = "rmsprop"
    z_dim = 128
    base_width = 64
    n_critic = 5          # D steps per G step (the WGAN paper's cadence)

    def build_model(self) -> None:
        cd = L.as_dtype(self.config.get("compute_dtype", torch.bfloat16))
        self.z_dim = int(self.config.get("z_dim", self.z_dim))
        self.n_critic = int(self.config.get("n_critic", self.n_critic))
        # the gate keeps optimizer-state subtrees by their "G" path: the
        # layouts that flatten paths away are refused (ModelBase)
        self.gates_opt_state_by_path = self.n_critic > 1
        base = int(self.config.get("base_width", self.base_width))
        self.G = _generator(self.z_dim, base, cd)
        self.D = _critic(base, cd)
        self.data = Cifar10_data(self.config, self.batch_size)

    def layers(self):
        return {"G": self.G, "D": self.D}

    def gated_path(self, path) -> bool:
        return _in_g(path)

    def draw_z(self, n: int, gen, device) -> torch.Tensor:
        """The step's noise ``[n, z_dim]``, standard normal, float32."""
        return torch.randn((n, self.z_dim), generator=gen, device=device)

    def generate(self, params, z, *, train=False, gen=None, bn_state=None):
        """Images from the generator, ``[n, 32, 32, 3]``; a training forward
        updates ``bn_state["G"]`` in place (fresh running stats when no
        state is given)."""
        state = bn_state["G"] if bn_state else \
            tree_map(lambda s: s.to(z.device), self.G.init_state())
        return self.G.apply(params["G"], z, train=train, gen=gen,
                            state=state)

    # -- subclass hooks: the two objectives ---------------------------------

    def d_loss(self, score_real, score_fake):
        raise NotImplementedError

    def g_loss(self, score_fake):
        raise NotImplementedError

    # -- the combined objective (see the module docstring) ------------------

    def _losses(self, params, bn_state, batch, gen, train: bool):
        x_real = self.stage_input(batch["x"])
        n = x_real.shape[0]
        z = self.draw_z(n, gen, x_real.device)
        fake = self.G.apply(params["G"], z, train=train, gen=gen,
                            state=bn_state["G"]).float()
        both = torch.cat([x_real, fake.detach()], dim=0)
        scores = self.D.apply(params["D"], both, train=train,
                              gen=gen).float()
        d_cost = self.d_loss(scores[:n], scores[n:])
        d_frozen = tree_map(lambda p: p.detach(), params["D"])
        g_cost = self.g_loss(self.D.apply(d_frozen, fake, train=train,
                                          gen=gen).float())
        return d_cost, g_cost

    def loss_and_metrics(self, params, bn_state, batch, gen, train: bool):
        # the differentiated value is the SUM (each term owns one gradient
        # path); the error column reports the G loss
        d_cost, g_cost = self._losses(params, bn_state, batch, gen, train)
        return d_cost + g_cost, g_cost

    def val_metrics(self, params, bn_state, batch):
        # a fixed noise draw, as the JAX package's key(0)
        dev = batch["x"].device
        gen = torch.Generator(device=dev).manual_seed(0)
        d_cost, g_cost = self._losses(params, bn_state, batch, gen, False)
        return d_cost + g_cost, (g_cost, g_cost)

    # -- the cadence gate and projection ------------------------------------

    def _gated_leaves(self, params, opt_state) -> list:
        """G's params and every optimizer-state leaf under a ``"G"`` key, in
        order, each tensor once (Adam's leaves share their count)."""
        out, seen = [], set()
        for tree in (params, opt_state):
            for path, leaf in zip(leaf_paths(tree), tree_leaves(tree)):
                if _in_g(path) and isinstance(leaf, torch.Tensor) and \
                        id(leaf) not in seen:
                    seen.add(id(leaf))
                    out.append(leaf)
        return out

    @torch.no_grad()
    def snapshot_update(self, params, opt_state):
        if self.n_critic <= 1:
            return None
        return [t.detach().clone()
                for t in self._gated_leaves(params, opt_state)]

    @torch.no_grad()
    def postprocess_update(self, old, params, opt_state, count) -> None:
        """Off the critic cadence (``count % n_critic != 0``), G's params and
        optimizer state take back their values from before the update."""
        if self.n_critic <= 1:
            return
        on = torch.remainder(count, self.n_critic) == 0
        for new, was in zip(self._gated_leaves(params, opt_state), old):
            torch.where(on, new, was, out=new)


class WGAN(GAN_ModelBase):
    """Wasserstein GAN with weight clipping (Arjovsky et al. 2017), the
    algorithm of the reference's ``wgan.py``."""

    clip = 0.01

    def build_model(self) -> None:
        # the clip below projects a top-level EMA shadow: zero_opt would
        # flatten it into optimizer chunks the projection cannot reach
        if self.config.get("ema_decay") and self.config.get("zero_opt"):
            raise ValueError("WGAN weight clipping cannot project the EMA "
                             "shadow once zero_opt has flattened it into "
                             "optimizer chunks: drop one of "
                             "ema_decay/zero_opt")
        super().build_model()
        self.clip = float(self.config.get("clip", self.clip))

    def d_loss(self, s_real, s_fake):
        # the critic maximizes E[s_real] − E[s_fake]
        return torch.mean(s_fake) - torch.mean(s_real)

    def g_loss(self, s_fake):
        return -torch.mean(s_fake)

    @torch.no_grad()
    def postprocess_update(self, old, params, opt_state, count) -> None:
        super().postprocess_update(old, params, opt_state, count)
        c = self.clip
        ds = tree_leaves(params["D"])
        if isinstance(opt_state, dict) and "ema" in opt_state:
            # the EMA blends the pre-clip params into the shadow (before
            # this hook): its critic is projected into the box too
            ds = ds + tree_leaves(opt_state["ema"]["D"])
        torch._foreach_clamp_min_(ds, -c)
        torch._foreach_clamp_max_(ds, c)


class LSGAN(GAN_ModelBase):
    """Least-squares GAN (Mao et al. 2017), the algorithm of the reference's
    ``lsgan.py``: a = 0, b = 1, c = 1 coding."""

    learning_rate = 2e-4
    optimizer = "adam"
    n_critic = 1

    def d_loss(self, s_real, s_fake):
        return 0.5 * (torch.mean((s_real - 1.0) ** 2)
                      + torch.mean(s_fake ** 2))

    def g_loss(self, s_fake):
        return 0.5 * torch.mean((s_fake - 1.0) ** 2)
