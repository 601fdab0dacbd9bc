"""theanompi_tpu_torch — the PyTorch/CUDA port of theanompi_tpu.

One process per GPU over ``torch.distributed``; the JAX package beside it is
the reference every ported piece is held against.  Public session API:

    from theanompi_tpu_torch import BSP    # or EASGD, ASGD, GOSGD
    rule = BSP()
    rule.init(devices=1, modelfile='theanompi_tpu_torch.models.alex_net',
              modelclass='AlexNet')
    rule.wait()

Entry points run on ``cuda`` unless the config says ``device='cpu'``.
"""

from .sync_rule import ASGD, BSP, EASGD, GOSGD, SyncRule

__version__ = "0.1.0"
__all__ = ["ASGD", "BSP", "EASGD", "GOSGD", "SyncRule", "__version__"]
