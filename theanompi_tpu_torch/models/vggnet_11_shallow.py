"""VGG-11 "shallow": the reference's import path.

Counterpart of ``theanompi_tpu/models/vggnet_11_shallow.py``.  The model
lives in :mod:`theanompi_tpu_torch.models.vggnet_16` (the two VGG
configurations share the stack builder); this module keeps the path, so
dotted-path configs (``...models.vggnet_11_shallow:VGGNet_11_shallow``) run
unmodified.
"""

from .vggnet_16 import VGGNet_11_shallow

__all__ = ["VGGNet_11_shallow"]
