"""Normalization functionals — counterpart of the subset of ``paddle_tpu/nn/functional/norm.py`` that Llama training runs.

``rms_norm`` only. With a weight it goes through
:func:`paddle_tpu_torch.kernels.rms_norm.rms_norm`: the hand-written
CUDA kernels (forward and backward) for every CUDA tensor, the plain
version for CPU tensors. The reference routes to its Pallas kernel only
under ``PADDLE_TPU_PALLAS_RMSNORM=1`` on a TPU, a choice measured on
that chip; the port runs its kernel always, as it does its flash
kernels. Without a weight it computes the reference's plain body
(``_rms_norm_reference``). Under ``auto_cast`` O1 the inputs are cast
to float32 first (``rms_norm`` is on the black list).

The kernel multiplies ``x · rstd · w`` in f32 and casts last; the
reference's ``_rms_norm_reference`` casts to x's dtype before the
``· w``. ROADMAP queue C lists the difference as by design. The output
dtype is the reference's: x's and the weight's promoted (a bf16 x with
an f32 weight gives f32).

``layer_norm``, ``batch_norm`` and the other norms are not ported yet
(ROADMAP item 'nn').
"""
from __future__ import annotations

import torch

from ...amp.auto_cast import amp_cast_inputs
from ...kernels.rms_norm import rms_norm as _rms_kernel


def _rms_norm_plain(x, epsilon):
    """The reference's body without a weight: divide by ``sqrt`` in
    f32, cast to x's dtype."""
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf / torch.sqrt(var + epsilon)).to(x.dtype)


def rms_norm(x, weight=None, epsilon=1e-6, name=None):
    """RMSNorm over the last axis of ``x``, scaled by ``weight [f]`` when
    one is given (see the module docstring)."""
    if weight is None:
        (x,) = amp_cast_inputs("rms_norm", x)
        return _rms_norm_plain(x, epsilon)
    x, weight = amp_cast_inputs("rms_norm", x, weight)
    with torch.autocast(x.device.type, enabled=False):
        return _rms_kernel(x, weight, epsilon)


__all__ = ["rms_norm"]
