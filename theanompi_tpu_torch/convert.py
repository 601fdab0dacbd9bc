"""JAX parameter trees → the port's.

The JAX package keeps conv weights HWIO ``[kh, kw, in/groups, out]`` and FC
weights ``[in, out]``; the port keeps PyTorch's OIHW
``[out, in/groups, kh, kw]`` and ``[out, in]``.  Both group a grouped
conv's output channels the same way (group g owns outputs
``g·out/groups .. (g+1)·out/groups``), so a conv converts by a plain
transpose, and because the port flattens NHWC activations in (h, w, c)
order, as the JAX package does, so does the FC after a ``Flatten``.
Vectors (biases) are unchanged.  A momentum velocity tree has the params'
shapes and converts the same way.

Input and output are trees (nested dicts) of numpy arrays.
"""

from __future__ import annotations

import numpy as np

from .utils.helper_funcs import tree_map


def _to_port(a) -> np.ndarray:
    a = np.asarray(a, dtype=np.float32)
    if a.ndim == 4:
        return np.ascontiguousarray(a.transpose(3, 2, 0, 1))
    if a.ndim == 2:
        return np.ascontiguousarray(a.T)
    return a.copy()


def params_from_jax(tree):
    """JAX layout → port layout (params or momentum velocity)."""
    return tree_map(_to_port, tree)

