"""Fused AdamW bucket update — counterpart of ``paddle_tpu/kernels/fused_adamw.py``.

One pass over a dtype bucket's flat buffers (``optimizer/fused.py``):
param and grad 1-D f32 or bf16, moments 1-D f32, all updated in place.
The step-varying scalars ride in a small f32 tensor ``[lr, 1 - beta1^t,
1 - beta2^t]`` on the buffers' device (:func:`adamw_scalars`), so a
changing lr or step never changes a launch's arguments.

A masked step (some of the bucket's parameters got no gradient) passes
``spans``, the device table of the present spans (:func:`span_table`):
only they are updated, and every other element keeps its value and
moments bit for bit, as the reference's ``jnp.where(mask, new, old)``.

Two implementations of one function:

- :func:`fused_adamw_reference`, plain PyTorch, the math of the
  reference's ``fused_adamw._reference``;
- the CUDA kernel ``csrc/fused_adamw.cu`` (see its header).

:func:`fused_adamw` chooses by where the param lies: a CPU tensor runs
the plain version, a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from . import LAUNCHES

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def adamw_scalars(lr, t, beta1, beta2):
    """``[lr, 1 - beta1^t, 1 - beta2^t]`` as Python floats (formed in
    double, as the reference forms them, then stored in f32)."""
    return [float(lr), 1.0 - beta1 ** t, 1.0 - beta2 ** t]


#: elements of a 16-byte vector of params, by dtype (the kernel's VEC)
_VEC = {torch.float32: 4, torch.bfloat16: 8}


def span_table(spans, dtype, device):
    """The kernel's int64 table of present spans ``[(start, length),
    ...]`` (ascending, disjoint, each start a multiple of 16 bytes of a
    ``dtype`` param): ``starts[S] | lens[S] | vpre[S + 1]``, vpre the
    16-byte vectors before each span, on ``device``."""
    if not spans:
        raise ValueError("span_table needs at least one span")
    vec = _VEC[dtype]
    starts = [int(a) for a, _ in spans]
    lens = [int(n) for _, n in spans]
    if any(a % vec for a in starts) or any(n <= 0 for n in lens) or any(
            a + n > b for a, n, b in zip(starts, lens, starts[1:])):
        raise ValueError(f"spans must be ascending, disjoint, non-empty and "
                         f"start at multiples of {vec} elements: {spans}")
    vpre = [0]
    for n in lens:
        vpre.append(vpre[-1] + n // vec)
    return torch.tensor(starts + lens + vpre, dtype=torch.int64,
                        device=device)


def _span_mask(table, n, device):
    """The bool mask ``[n]`` of a :func:`span_table`."""
    S = (table.numel() - 1) // 3
    t = table.tolist()
    mask = torch.zeros(n, dtype=torch.bool, device=device)
    for a, ln in zip(t[:S], t[S:2 * S]):
        mask[a:a + ln] = True
    return mask


def fused_adamw_reference(p, g, m, v, scalars, *, beta1, beta2, eps,
                          weight_decay, decoupled, spans=None):
    """Plain PyTorch AdamW/Adam over flat buffers, in place on p, m, v:
    op for op the reference's ``_reference`` (f32 math, decoupled or
    coupled weight decay, the result cast to p's dtype). ``spans``: a
    :func:`span_table`; outside its spans p, m and v keep their values
    (the reference's ``jnp.where(mask, new, old)``)."""
    lr, c1, c2 = scalars[0], scalars[1], scalars[2]
    wd = float(weight_decay)
    gf = g.float()
    pf = p.float()
    if wd and not decoupled:
        gf = gf + wd * pf
    m_new = beta1 * m + (1 - beta1) * gf
    v_new = beta2 * v + (1 - beta2) * (gf * gf)
    u = (m_new / c1) / (torch.sqrt(v_new / c2) + eps)
    if wd and decoupled:
        u = u + wd * pf
    p_new = (pf - lr * u).to(p.dtype)
    if spans is not None:
        mask = _span_mask(spans, p.numel(), p.device)
        p_new = torch.where(mask, p_new, p)
        m_new = torch.where(mask, m_new, m)
        v_new = torch.where(mask, v_new, v)
    p.copy_(p_new)
    m.copy_(m_new)
    v.copy_(v_new)


def fused_adamw(p, g, m, v, scalars, *, beta1=0.9, beta2=0.999, eps=1e-8,
                weight_decay=0.0, decoupled=True, spans=None):
    """Update the flat bucket ``(p, m, v)`` in place from grad ``g``.
    ``scalars`` is the f32 ``[lr, c1, c2]`` tensor of
    :func:`adamw_scalars` on p's device; ``spans`` None (every element)
    or a :func:`span_table` on p's device (only its spans)."""
    n = p.numel()
    for name, x in (("p", p), ("g", g), ("m", m), ("v", v)):
        if x.dim() != 1 or x.numel() != n:
            raise ValueError(f"{name} must be 1-D of {n} elements, got "
                             f"{tuple(x.shape)}")
        if x.device != p.device:
            raise ValueError(f"{name} is on {x.device}, p on {p.device}")
    if p.dtype not in _DTYPE_CODE or g.dtype != p.dtype:
        raise TypeError(f"fused AdamW takes float32 or bfloat16 params with "
                        f"grads of the same dtype, got {p.dtype} / {g.dtype}")
    if m.dtype != torch.float32 or v.dtype != torch.float32:
        raise TypeError("fused AdamW keeps float32 moments")
    if scalars.dtype != torch.float32 or tuple(scalars.shape) != (3,) or \
            scalars.device != p.device:
        raise ValueError("scalars must be f32 [lr, c1, c2] on p's device")
    if spans is not None and (
            spans.dtype != torch.int64 or spans.dim() != 1 or
            spans.numel() < 4 or spans.numel() % 3 != 1 or
            spans.device != p.device):
        raise ValueError("spans must be a span_table (int64 [3 S + 1]) on "
                         "p's device")
    kw = dict(beta1=beta1, beta2=beta2, eps=eps, weight_decay=weight_decay,
              decoupled=decoupled)
    if p.device.type == "cpu":
        fused_adamw_reference(p, g, m, v, scalars, spans=spans, **kw)
        return
    if p.device.type != "cuda":
        raise ValueError(f"fused AdamW runs on cuda or cpu tensors, got "
                         f"{p.device}")
    if not all(x.is_contiguous() and x.data_ptr() % 16 == 0
               for x in (p, g, m, v)) or not scalars.is_contiguous():
        raise ValueError("fused AdamW kernel needs contiguous, 16-byte "
                         "aligned buffers")
    err = _library().fused_adamw(
        _DTYPE_CODE[p.dtype], p.data_ptr(), g.data_ptr(), m.data_ptr(),
        v.data_ptr(), scalars.data_ptr(), n,
        0 if spans is None else spans.data_ptr(),
        0 if spans is None else (spans.numel() - 1) // 3, float(beta1),
        float(beta2), float(eps), float(weight_decay), int(bool(decoupled)),
        torch.cuda.current_stream(p.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_adamw launch failed: CUDA error {err}")
    LAUNCHES["fused_adamw"] += 1


def _library():
    from ._build import load
    lib = load("fused_adamw")
    if lib.fused_adamw.argtypes is None:
        p, i, f, d = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                      ctypes.c_double)
        lib.fused_adamw.argtypes = [i] + [p] * 5 + [ctypes.c_longlong, p, i,
                                                    d, d, f, f, i, p]
        lib.fused_adamw.restype = i
    return lib


__all__ = ["adamw_scalars", "fused_adamw", "fused_adamw_reference",
           "span_table"]
