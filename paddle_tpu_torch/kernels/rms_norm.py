"""RMSNorm forward and backward — counterpart of ``paddle_tpu/kernels/rms_norm.py``.

Over the last axis of ``x [..., f]`` with a weight ``w [f]``:

- forward: ``rstd = rsqrt(mean(x²) + eps)`` per row in f32 and
  ``y = x · rstd · w``, multiplied in f32 and cast last (the Pallas
  ``_fwd_kernel``'s rounding) to x's and w's promoted dtype
  (:func:`y_dtype`: f32 unless both are bf16, as jnp promotes the
  reference's ``_rms_norm_reference``); ``rstd`` is kept in f32;
- backward: ``x̂ = x · rstd``,
  ``dx = rstd · (dy·w − x̂ · mean(dy·w·x̂))`` in x's dtype and
  ``dw = Σ_rows dy · x̂`` in w's dtype; ``dy`` is taken in x's dtype, as
  the Pallas ``_bwd_kernel`` takes it.

Two implementations of each:

- :func:`rms_norm_fwd_reference` and :func:`rms_norm_bwd_reference`,
  plain PyTorch, op for op the Pallas kernels' math;
- the CUDA kernels of ``csrc/rms_norm.cu`` (see its header): the
  forward one launch, the backward one pass over ``x`` and ``dy`` whose
  blocks each write one f32 ``dw`` partial for a chunk of rows (its rows
  added in row order), then a second launch that adds the partials in
  chunk order. The chunking (:func:`dw_chunks`) is a function of the
  shape alone: two launches on the same inputs give the same bits.

:func:`rms_norm` is differentiable (:class:`RMSNormFunction`, which
saves ``x``, ``w`` and ``rstd`` as the reference's custom VJP ``_rms``
does). It chooses by where ``x`` lies: a CPU tensor runs the plain
versions, a CUDA tensor launches the kernels or raises. ``x`` and ``w``
are f32 or bf16 in any mix, with a contiguous last axis; anything else
raises on either device. The Pallas call's ``block_rows`` and autotune
have no counterpart: the kernel picks its own launch shape.

Rounding differs from the reference's training default
``_rms_norm_reference`` (``paddle_tpu/nn/functional/norm.py:45``), which
divides by ``sqrt`` and casts to x's dtype before the ``· w``: for f32
inputs the two differ in rounding only, for bf16 by up to 2 ulps.
"""
from __future__ import annotations

import ctypes

import torch

from . import LAUNCHES

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

#: the backward's chunking (csrc/rms_norm.cu: kBwdElems, kMaxTileF,
#: kWideThreads): row elements per thread of the tile kernel, the widest
#: row it takes, and the wide kernel's threads
_BWD_ELEMS = 8
_MAX_TILE_F = 4096
_WIDE_THREADS = 256
#: SMs of an H100, and backward blocks aimed at each: one, or as many as
#: make 8 warps (measured by tools/rms_variants.py --blocks)
_SMS = 132
_BWD_BLOCKS_PER_SM = 1


def y_dtype(x, w):
    """The forward's output dtype: x's and w's promoted."""
    return torch.promote_types(x.dtype, w.dtype)


def rms_norm_fwd_reference(x2, w, eps):
    """Plain forward over rows ``x2 [r, f]``: ``(y, rstd)``, y in
    :func:`y_dtype`, rstd f32 ``[r, 1]``."""
    xf = x2.float()
    rstd = torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return (xf * rstd * w.float()).to(y_dtype(x2, w)), rstd


def rms_norm_bwd_reference(x2, w, rstd, dy2):
    """Plain backward: ``(dx, dw)``, dx in x's dtype, dw in w's."""
    xhat = x2.float() * rstd
    dxhat = dy2.float() * w.float()
    dx = rstd * (dxhat - xhat * (dxhat * xhat).mean(-1, keepdim=True))
    dw = (dy2.float() * xhat).sum(0)
    return dx.to(x2.dtype), dw.to(w.dtype)


def _check(x, w):
    if x.dim() < 1 or w.dim() != 1 or w.shape[0] != x.shape[-1] or \
            w.shape[0] == 0:
        raise ValueError(f"rms_norm takes x [..., f] and w [f], f >= 1, "
                         f"got {tuple(x.shape)} and {tuple(w.shape)}")
    if x.dtype not in _DTYPE_CODE or w.dtype not in _DTYPE_CODE:
        raise TypeError(f"rms_norm takes float32 or bfloat16 x and w, got "
                        f"{x.dtype} and {w.dtype}")
    if x.device != w.device:
        raise ValueError(f"x is on {x.device}, w on {w.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"rms_norm runs on cuda or cpu tensors, got "
                         f"{x.device}")
    if (x.shape[-1] > 1 and x.stride(-1) != 1) or \
            (w.shape[0] > 1 and w.stride(0) != 1):
        raise ValueError("rms_norm needs a contiguous last axis")


def _rows(t):
    """``t [..., f]`` as contiguous rows ``[r, f]`` (a view when ``t`` is
    contiguous)."""
    return t.reshape(-1, t.shape[-1]).contiguous()


def _vec(f, *ts):
    """1 when each lane can move 16 bytes of x at a time: f a multiple of
    the vector, every pointer aligned to the bytes it moves per access."""
    n = 16 // ts[0].element_size()
    return int(f % n == 0 and all(
        t.data_ptr() % (n * t.element_size()) == 0 for t in ts))


def rms_norm_fwd(x2, w, eps):
    """Launch the forward kernel over rows ``x2 [r, f]`` (CUDA):
    ``(y, rstd)``, y contiguous in :func:`y_dtype`, rstd f32 ``[r, 1]``."""
    _check(x2, w)
    if x2.device.type != "cuda":
        raise ValueError(f"the rms_norm kernels run on cuda tensors, got "
                         f"{x2.device}")
    r, f = x2.shape
    y = torch.empty((r, f), dtype=y_dtype(x2, w), device=x2.device)
    rstd = torch.empty((r, 1), dtype=torch.float32, device=x2.device)
    if r == 0:
        return y, rstd
    x2, w = x2.contiguous(), w.contiguous()
    err = _library().rms_norm_fwd(
        _DTYPE_CODE[x2.dtype], _DTYPE_CODE[w.dtype], _vec(f, x2, w, y),
        x2.data_ptr(), w.data_ptr(), y.data_ptr(), rstd.data_ptr(), r, f,
        float(eps), _stream(x2))
    if err != 0:
        raise RuntimeError(f"rms_norm_fwd launch failed: CUDA error {err}")
    LAUNCHES["rms_norm_fwd"] += 1
    return y, rstd


def bwd_threads(f):
    """Threads of a backward block for rows of ``f`` elements: 32 per
    ``32 × _BWD_ELEMS`` elements up to ``_MAX_TILE_F``, else the wide
    kernel's."""
    if f > _MAX_TILE_F:
        return _WIDE_THREADS
    return 32 * -(-f // (32 * _BWD_ELEMS))


def dw_chunks(rows, f):
    """``(chunks, rows_per_chunk)`` of the backward: one block per chunk
    of consecutive rows, ``_BWD_BLOCKS_PER_SM`` per SM (more when a
    block has fewer than 8 warps: enough for 8), at most one per row. A
    function of the shape and of constants alone, so the summation order
    of ``dw`` is too: within a chunk in row order, then the chunks in
    chunk order."""
    per_sm = max(_BWD_BLOCKS_PER_SM, 8 // (bwd_threads(f) // 32))
    want = max(1, min(rows, _SMS * per_sm))
    per = -(-rows // want)
    return -(-rows // per), per


def rms_norm_bwd(x2, w, rstd, dy2):
    """Launch the backward kernels (CUDA): ``(dx, dw)``, dx contiguous in
    x's dtype, dw in w's dtype."""
    _check(x2, w)
    if x2.device.type != "cuda":
        raise ValueError(f"the rms_norm kernels run on cuda tensors, got "
                         f"{x2.device}")
    r, f = x2.shape
    if tuple(dy2.shape) != (r, f) or dy2.dtype != x2.dtype or \
            dy2.device != x2.device:
        raise ValueError(f"dy must be {x2.dtype} [{r}, {f}] on {x2.device}, "
                         f"got {dy2.dtype} {tuple(dy2.shape)} on "
                         f"{dy2.device}")
    if rstd.dtype != torch.float32 or rstd.numel() != r or \
            not rstd.is_contiguous() or rstd.device != x2.device:
        raise ValueError("rstd must be contiguous f32 [r, 1] on x's device")
    dx = torch.empty((r, f), dtype=x2.dtype, device=x2.device)
    if r == 0:
        return dx, torch.zeros_like(w)
    x2, w, dy2 = x2.contiguous(), w.contiguous(), dy2.contiguous()
    dw = torch.empty_like(w)
    chunks, per = dw_chunks(r, f)
    partial = torch.empty(chunks * f, dtype=torch.float32, device=x2.device)
    err = _library().rms_norm_bwd(
        _DTYPE_CODE[x2.dtype], _DTYPE_CODE[w.dtype], _vec(f, x2, dy2, w, dx),
        x2.data_ptr(), w.data_ptr(), rstd.data_ptr(), dy2.data_ptr(),
        dx.data_ptr(), dw.data_ptr(), partial.data_ptr(), r, f, chunks, per,
        _stream(x2))
    if err != 0:
        raise RuntimeError(f"rms_norm_bwd launch failed: CUDA error {err}")
    LAUNCHES["rms_norm_bwd"] += 1
    return dx, dw


class RMSNormFunction(torch.autograd.Function):
    """``y = rms_norm(x, w)`` over rows; saves x, w and rstd."""

    @staticmethod
    def forward(ctx, x, w, eps):
        x2 = _rows(x)
        if x.device.type == "cpu":
            y, rstd = rms_norm_fwd_reference(x2, w, eps)
        else:
            y, rstd = rms_norm_fwd(x2, w, eps)
        ctx.save_for_backward(x2, w, rstd)
        ctx.shape = x.shape
        return y.reshape(x.shape)

    @staticmethod
    def backward(ctx, dy):
        x2, w, rstd = ctx.saved_tensors
        dy2 = _rows(dy.to(x2.dtype))
        if x2.device.type == "cpu":
            dx, dw = rms_norm_bwd_reference(x2, w, rstd, dy2)
        else:
            dx, dw = rms_norm_bwd(x2, w, rstd, dy2)
        return dx.reshape(ctx.shape), dw, None


def rms_norm(x, weight, epsilon=1e-6):
    """Differentiable RMSNorm of ``x [..., f]`` by ``weight [f]`` (see
    the module docstring): the plain versions on CPU tensors, the CUDA
    kernels on CUDA tensors."""
    _check(x, weight)
    return RMSNormFunction.apply(x, weight, float(epsilon))


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def _library():
    from ._build import load
    lib = load("rms_norm")
    if lib.rms_norm_fwd.argtypes is None:
        p, i, f, ll = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                       ctypes.c_longlong)
        lib.rms_norm_fwd.argtypes = [i, i, i] + [p] * 4 + [ll, i, f, p]
        lib.rms_norm_bwd.argtypes = [i, i, i] + [p] * 7 + [ll, i, i, ll, p]
        lib.rms_norm_bwd_smem_bytes.argtypes = [i, i, i]
        lib.rms_norm_fwd.restype = i
        lib.rms_norm_bwd.restype = i
        lib.rms_norm_bwd_smem_bytes.restype = ll
    return lib


__all__ = ["RMSNormFunction", "bwd_threads", "dw_chunks", "rms_norm",
           "rms_norm_bwd", "rms_norm_bwd_reference", "rms_norm_fwd",
           "rms_norm_fwd_reference", "y_dtype"]
