"""Normalization layers — counterpart of the subset of ``paddle_tpu/nn/layer/norm.py`` that Llama training runs.

``RMSNorm`` only; ``LayerNorm``, ``GroupNorm`` and the batch norms are
not ported yet (ROADMAP item 'nn').
"""
from __future__ import annotations

import torch
from torch import nn

from ...core.place import resolve_device
from .. import functional as F


class RMSNorm(nn.Module):
    """RMSNorm over the last axis with one ``weight [hidden_size]``
    parameter, initialised to 1 (reference :101-112). ``device=None``
    places it on the current CUDA device and raises without one."""

    def __init__(self, hidden_size, epsilon=1e-6, weight_attr=None,
                 name=None, *, device=None, dtype=torch.float32):
        super().__init__()
        if weight_attr is not None:
            raise NotImplementedError("RMSNorm(weight_attr=...) is not "
                                      "ported yet (ROADMAP item 'nn')")
        self._epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(
            hidden_size, device=resolve_device(device), dtype=dtype))

    def forward(self, x):
        return F.rms_norm(x, self.weight, self._epsilon)


__all__ = ["RMSNorm"]
