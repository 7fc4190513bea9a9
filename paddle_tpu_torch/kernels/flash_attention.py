"""Flash attention, forward and backward — counterpart of ``paddle_tpu/kernels/flash_attention.py``.

Attention over ``[batch, heads, seq, head_dim]`` tensors, causal (ends
aligned: query ``i`` sees key ``j`` iff ``i + sk - sq >= j``) or full,
GQA-native (query head ``h`` reads kv head ``h // (hq // hkv)``),
returning the output and the f32 logsumexp ``[b, hq, sq]``. A query row
that sees no key gets output 0 and logsumexp ``-1e30``.

Two implementations of one function:

- :func:`flash_attention_reference`, plain PyTorch: dense f32 scores,
  masked softmax, backward by autograd;
- the CUDA kernels of ``csrc/flash_attention.cu`` (forward, dq, dk/dv;
  see its header), built by ``kernels/_build.py``: bf16 on the tensor
  cores, f32 on CUDA cores, a fixed choice by dtype. With GQA in bf16
  the dk/dv kernel writes f32 partials per query head and a second
  launch, :func:`flash_attention_bwd_dkv_sum`, adds each kv head's
  group in order.

:func:`flash_attention` chooses by where ``q`` lies: a CPU tensor runs
the plain version, a CUDA tensor goes through :class:`FlashAttention`,
whose forward and backward launch the kernels or raise. There is no
fallback between the two.

Layout: the kernels address every tensor through its (batch, head, seq)
strides and need only a contiguous head dimension, so a ``[b, s, h, d]``
buffer passes as its ``transpose(1, 2)`` view with no copy (as
``nn.functional.attention`` does), and the gradients come back in the
layout of their inputs.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import LAUNCHES

_NEG_INF = -1e30
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)


def flash_attention_reference(q, k, v, causal=False, scale=None):
    """Plain PyTorch flash attention: ``(out, lse)``. Scores, softmax and
    the output are computed in f32 over the dense ``[sq, sk]`` matrix;
    masked scores weigh exactly 0, so a row that sees no key gets out 0
    and lse ``-1e30``. ``out`` comes back in q's dtype; differentiable."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    group = hq // hkv
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    s = torch.matmul(q.float(), kf.transpose(-1, -2)) * scale
    if causal:
        qi = torch.arange(sq, device=q.device)[:, None]
        kj = torch.arange(sk, device=q.device)[None, :]
        ok = qi + (sk - sq) >= kj
    else:
        ok = torch.ones(sq, sk, dtype=torch.bool, device=q.device)
    s = s.masked_fill(~ok, _NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m) * ok
    l = p.sum(-1, keepdim=True)
    l = torch.where(l == 0, torch.ones_like(l), l)
    out = torch.matmul(p / l, vf)
    lse = (m + torch.log(l)).squeeze(-1)
    return out.to(q.dtype), lse


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash attention takes [b, h, s, d] tensors")
    b, hq, sq, d = q.shape
    if tuple(v.shape) != tuple(k.shape) or k.shape[0] != b or \
            k.shape[3] != d:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not pair")
    if hq % k.shape[1] != 0:
        raise ValueError(f"GQA needs hq % hkv == 0, got {hq}, {k.shape[1]}")


def _check_kernel_operands(*xs):
    """What the CUDA kernels take: f32 or bf16 on one CUDA device, one
    dtype, head_dim 64 or 128, a contiguous head dimension."""
    q = xs[0]
    if q.device.type != "cuda":
        raise ValueError(f"flash attention kernels run on cuda tensors, got "
                         f"{q.device}")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"flash attention kernels take float32 or bfloat16, "
                        f"got {q.dtype}")
    for x in xs:
        if x.dtype != q.dtype or x.device != q.device:
            raise TypeError(f"operand is {x.dtype} on {x.device}; the kernel "
                            f"needs {q.dtype} on {q.device}")
        if x.stride(-1) != 1:
            raise ValueError("flash attention kernels need a contiguous head "
                             "dimension (stride 1 on the last axis)")
    if q.shape[-1] not in _HEAD_DIMS:
        raise ValueError(f"flash attention kernels take head_dim in "
                         f"{_HEAD_DIMS}, got {q.shape[-1]}")
    if q.shape[2] == 0 or xs[1].shape[2] == 0:
        raise ValueError("flash attention needs non-empty sequences")
    if q.dtype == torch.bfloat16:
        for x in xs:
            if not _aligned(x):
                raise ValueError(
                    f"the bf16 flash kernels copy rows in 16-byte chunks: "
                    f"pointer and (batch, head, seq) strides {x.stride()[:3]} "
                    f"must be multiples of 16 bytes")


def _aligned(x):
    """Pointer and every (batch, head, seq) stride of an axis longer
    than 1 a multiple of 16 bytes."""
    size = x.element_size()
    return x.data_ptr() % 16 == 0 and all(
        n == 1 or (st * size) % 16 == 0
        for n, st in zip(x.shape[:3], x.stride()[:3]))


def _strides(*xs):
    vals = [s for x in xs for s in x.stride()[:3]]
    return (ctypes.c_longlong * len(vals))(*vals)


def flash_attention_fwd(q, k, v, causal, scale):
    """Launch the forward kernel: ``(out, lse)``, out in q's dtype and
    layout, lse f32 ``[b, hq, sq]``."""
    _check(q, k, v)
    _check_kernel_operands(q, k, v)
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    lib = _library()
    err = lib.flash_attention_fwd(
        _DTYPE_CODE[q.dtype], d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), lse.data_ptr(), _strides(q, k, v, out), b, hq, hkv,
        sq, sk, float(scale), int(causal), _stream(q))
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: CUDA error "
                           f"{err}")
    LAUNCHES["flash_attention_fwd"] += 1
    return out, lse


def _check_stats(q, *stats):
    b, hq, sq, _ = q.shape
    for x in stats:
        if x.dtype != torch.float32 or tuple(x.shape) != (b, hq, sq) or \
                not x.is_contiguous() or x.device != q.device:
            raise ValueError("lse and delta must be contiguous f32 "
                             "[b, hq, sq] on q's device")


def flash_attention_bwd_dq(q, k, v, dout, lse, delta, causal, scale):
    """Launch the dq kernel: dq in q's dtype and layout, from the saved
    lse and ``delta = rowsum(dO * O)`` (f32 ``[b, hq, sq]``)."""
    _check(q, k, v)
    _check_kernel_operands(q, k, v, dout)
    _check_stats(q, lse, delta)
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    dq = torch.empty_like(q)
    err = _library().flash_attention_bwd_dq(
        _DTYPE_CODE[q.dtype], d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        _strides(q, k, v, dout, dq), b, hq, hkv, sq, sk, float(scale),
        int(causal), _stream(q))
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd_dq launch failed: CUDA "
                           f"error {err}")
    LAUNCHES["flash_attention_bwd_dq"] += 1
    return dq


def flash_attention_bwd_dkv(q, k, v, dout, lse, delta, causal, scale):
    """Launch the dk/dv kernel: ``(dk, dv)`` in the dtype and layout of
    k and v, summed over each kv head's group of query heads. In bf16
    with ``hq != hkv`` the kernel writes f32 partials per query head
    and :func:`flash_attention_bwd_dkv_sum` adds them."""
    _check(q, k, v)
    _check_kernel_operands(q, k, v, dout)
    _check_stats(q, lse, delta)
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    part = None
    if q.dtype == torch.bfloat16 and hq != hkv:
        part = torch.empty((2, b, hq, sk, d), dtype=torch.float32,
                           device=q.device)
    err = _library().flash_attention_bwd_dkv(
        _DTYPE_CODE[q.dtype], d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), None if part is None else part.data_ptr(),
        _strides(q, k, v, dout, dk, dv), b, hq, hkv, sq, sk, float(scale),
        int(causal), _stream(q))
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd_dkv launch failed: CUDA "
                           f"error {err}")
    LAUNCHES["flash_attention_bwd_dkv"] += 1
    if part is not None:
        _launch_dkv_sum(part, dk, dv)
    return dk, dv


def flash_attention_bwd_dkv_sum_reference(part, k, v):
    """Plain version of the group sum: ``part`` f32 ``[2, b, hq, sk, d]``
    (each query head's dk and dv) summed over each kv head's group of
    query heads, in head order, then cast to k's and v's dtype."""
    b, hkv, sk, d = k.shape
    grouped = part.view(2, b, hkv, -1, sk, d)
    acc = grouped[:, :, :, 0]
    for hh in range(1, grouped.shape[3]):
        acc = acc + grouped[:, :, :, hh]
    return acc[0].to(k.dtype), acc[1].to(v.dtype)


def flash_attention_bwd_dkv_sum(part, k, v):
    """Launch the group sum (bf16 k and v, ``hq != hkv``): ``(dk, dv)``
    in the dtype and layout of k and v, bitwise the plain version's."""
    _check_kernel_operands(k, v)
    b, hkv, sk, d = k.shape
    if part.dtype != torch.float32 or part.dim() != 5 or \
            tuple(part.shape[:2]) != (2, b) or \
            tuple(part.shape[3:]) != (sk, d) or part.shape[2] % hkv or \
            not part.is_contiguous() or part.device != k.device:
        raise ValueError(f"partials must be contiguous f32 [2, {b}, hq, {sk}, "
                         f"{d}] on k's device, got {tuple(part.shape)}")
    if k.dtype != torch.bfloat16:
        raise TypeError(f"the group sum is the bf16 path's, got {k.dtype}")
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch_dkv_sum(part, dk, dv)
    return dk, dv


def _launch_dkv_sum(part, dk, dv):
    _, b, hq, sk, d = part.shape
    err = _library().flash_attention_bwd_dkv_sum(
        d, part.data_ptr(), dk.data_ptr(), dv.data_ptr(), _strides(dk, dv), b,
        hq, dk.shape[1], sk, _stream(dk))
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd_dkv_sum launch failed: CUDA "
                           f"error {err}")
    LAUNCHES["flash_attention_bwd_dkv_sum"] += 1


def flash_attention_bwd(q, k, v, out, lse, dout, causal, scale):
    """The whole backward: ``delta = rowsum(dO * O)`` in f32 (outside
    the kernels, as the reference computes it), then the dq and the
    dk/dv kernels. Returns ``(dq, dk, dv)``."""
    delta = (dout.float() * out.float()).sum(-1).contiguous()
    dq = flash_attention_bwd_dq(q, k, v, dout, lse, delta, causal, scale)
    dk, dv = flash_attention_bwd_dkv(q, k, v, dout, lse, delta, causal,
                                     scale)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """``(out, lse)`` through the CUDA kernels; lse is not
    differentiable. The backward recomputes from the saved lse."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        out, lse = flash_attention_fwd(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, out, lse = ctx.saved_tensors
        if dout.stride(-1) != 1 or not _aligned(dout):
            dout = dout.contiguous()     # autograd's own buffer, not an input
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout, ctx.causal,
                                         ctx.scale)
        return dq, dk, dv, None, None


def flash_attention_with_lse(q, k, v, causal=False, scale=None):
    """``(out, lse)`` over ``[b, h, s, d]`` tensors: the plain version on
    CPU tensors, the kernels on CUDA tensors (differentiable in out)."""
    _check(q, k, v)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cuda or cpu tensors, got "
                         f"{q.device}")
    return FlashAttention.apply(q, k, v, bool(causal), float(scale))


def flash_attention(q, k, v, causal=False, scale=None):
    """Differentiable flash attention over ``[b, h, s, d]`` tensors (see
    the module docstring): returns the output only."""
    return flash_attention_with_lse(q, k, v, causal, scale)[0]


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def _library():
    from ._build import load
    lib = load("flash_attention")
    if lib.flash_attention_fwd.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.flash_attention_fwd.argtypes = [i, i] + [p] * 6 + [i] * 5 + \
            [f, i, p]
        lib.flash_attention_bwd_dq.argtypes = [i, i] + [p] * 8 + [i] * 5 + \
            [f, i, p]
        lib.flash_attention_bwd_dkv.argtypes = [i, i] + [p] * 10 + \
            [i] * 5 + [f, i, p]
        lib.flash_attention_bwd_dkv_sum.argtypes = [i] + [p] * 4 + [i] * 4 + \
            [p]
        lib.flash_attention_smem_bytes.argtypes = [i, i, i]
        lib.flash_attention_smem_bytes.restype = ctypes.c_longlong
        for fn in (lib.flash_attention_fwd, lib.flash_attention_bwd_dq,
                   lib.flash_attention_bwd_dkv,
                   lib.flash_attention_bwd_dkv_sum):
            fn.restype = i
    return lib


__all__ = ["FlashAttention", "flash_attention", "flash_attention_bwd",
           "flash_attention_bwd_dkv", "flash_attention_bwd_dkv_sum",
           "flash_attention_bwd_dkv_sum_reference", "flash_attention_bwd_dq",
           "flash_attention_fwd", "flash_attention_reference",
           "flash_attention_with_lse"]
