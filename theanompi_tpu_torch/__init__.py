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

__version__ = "0.1.0"
__all__ = ["ASGD", "BSP", "EASGD", "GOSGD", "SyncRule", "__version__"]


def __getattr__(name):
    # the session API on first use, so that ``python -m
    # theanompi_tpu_torch.worker`` runs the worker module once, as __main__
    if name in __all__:
        from . import sync_rule
        return getattr(sync_rule, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
