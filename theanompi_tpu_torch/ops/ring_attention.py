"""Softmax attention in plain torch ops.

Counterpart of ``theanompi_tpu/ops/ring_attention.py`` for ``NEG_INF`` and
``attention_reference`` (``attn_impl='reference'``), which XLA ran as an
einsum chain: f32 scores, an f32 softmax, output in q's dtype.  The ring
algorithm itself (sequence parallelism) is not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = False,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Single-device softmax attention of ``[B, H, T, hd]`` q, k, v."""
    d = q.shape[-1]
    scale = (1.0 / (d ** 0.5)) if scale is None else scale
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        tq, tk = s.shape[-2], s.shape[-1]
        valid = torch.arange(tq, device=s.device)[:, None] >= \
            torch.arange(tk, device=s.device)[None, :]
        s = torch.where(valid, s, torch.full((), NEG_INF, device=s.device))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)
