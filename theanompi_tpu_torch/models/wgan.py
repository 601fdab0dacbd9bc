"""WGAN: the reference's model path (``theanompi/models/wgan.py``); the
implementation is :mod:`theanompi_tpu_torch.models.gan`'s."""

from .gan import WGAN

__all__ = ["WGAN"]
