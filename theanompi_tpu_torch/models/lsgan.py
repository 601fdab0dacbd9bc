"""LSGAN: the reference's model path (``theanompi/models/lsgan.py``); the
implementation is :mod:`theanompi_tpu_torch.models.gan`'s."""

from .gan import LSGAN

__all__ = ["LSGAN"]
