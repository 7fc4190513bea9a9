"""Attention functionals — counterpart of the subset of ``paddle_tpu/nn/functional/attention.py`` that Llama training runs.

Paddle's layout, ``[batch, seq, heads, head_dim]``, at the surface. Both
entry points compute the same function through
:func:`paddle_tpu_torch.kernels.flash_attention.flash_attention`: the
hand-written flash kernels for CUDA tensors at every length, the plain
version for CPU tensors. The ``[b, s, h, d]`` buffers reach the kernels
as ``transpose(1, 2)`` views, with no copies. Under ``auto_cast`` O1 the
inputs are cast to the low-precision dtype first (attention is on the
white list).
"""
from __future__ import annotations

import torch

from ...amp.auto_cast import amp_cast_inputs
from ...kernels.flash_attention import flash_attention as _flash


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, name=None):
    """``softmax(q k^T / sqrt(d)) v`` over ``[b, s, h, d]`` tensors,
    causal (sequence ends aligned) or full, GQA when key/value carry
    fewer heads. Returns ``[b, s, hq, d]`` in the (cast) query dtype."""
    if attn_mask is not None:
        raise NotImplementedError("attention masks are not ported yet "
                                  "(ROADMAP item 'nn')")
    if dropout_p and training:
        raise NotImplementedError("attention dropout is not ported yet "
                                  "(ROADMAP item 'nn')")
    q, k, v = amp_cast_inputs("scaled_dot_product_attention", query, key,
                              value)
    with torch.autocast(q.device.type, enabled=False):
        out = _flash(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                     causal=is_causal)
    return out.transpose(1, 2)


def flash_attention(query, key, value, dropout=0.0, causal=False,
                    return_softmax=False, fixed_seed_offset=None,
                    rng_name="", training=True, name=None):
    """``paddle.nn.functional.flash_attention``: ``(out, None)``."""
    if return_softmax:
        raise NotImplementedError("flash_attention(return_softmax=True) is "
                                  "not ported yet (ROADMAP item 'nn')")
    return scaled_dot_product_attention(query, key, value, None, dropout,
                                        causal, training), None


__all__ = ["flash_attention", "scaled_dot_product_attention"]
