"""Weight-only dequant-matmul — counterpart of
``paddle_tpu/kernels/int8_matmul.py``.

``x @ (w_q * scale)`` with an int8 weight ``[K, N]`` or an int4 weight
nibble-packed along K (``[ceil(K/2), N]``), one float32 scale per out
channel, f32 accumulation and the output in x's dtype. Two
implementations of one function:

- :func:`dequant_matmul_reference`, plain PyTorch: dequantize to f32,
  multiply in f32, cast (the reference's ``_reference`` exactly);
- the CUDA kernel ``csrc/int8_matmul.cu`` (see its header): tensor cores
  for bf16 activations (wgmma, or mma.sync at M <= 16), the raw payload
  staged by a TMA ring and widened in registers, split-K over a
  thread-block cluster summed in a fixed order; CUDA cores for f32; the
  scale applied in the epilogue.

The payload may be a column slice of a wider weight (unit column
stride, row stride >= N): the kernel reads it in place.

:func:`dequant_matmul` chooses by where x lies: a CPU tensor runs the
plain version, a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from . import LAUNCHES

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def dequant_matmul_reference(x2, w_q, scale, rows, bits):
    """Plain PyTorch: ``x2 [M, K]`` against the weight dequantized to
    f32, multiplied in f32, returned in x2's dtype."""
    if bits == 8:
        w = w_q.to(torch.float32)
    else:
        from ..quantization import unpack_int4
        w = unpack_int4(w_q, rows).to(torch.float32)
    w = w * scale.reshape(1, -1)
    return (x2.to(torch.float32) @ w).to(x2.dtype)


def dequant_matmul(x, w_q, scale, *, rows=None, bits=8):
    """``x @ dequant(w_q)`` with per-out-channel scales.

    x: [..., K] float; w_q: [K, N] int8 (bits=8) or nibble-packed
    [ceil(K/2), N] int8 (bits=4), unit column stride (a column slice of
    a wider payload is read in place); scale: N float32 values. Returns
    [..., N] in x's dtype.
    """
    if bits not in (8, 4):
        raise ValueError(f"bits must be 8 or 4, got {bits}")
    if rows is None:
        if bits == 4:
            raise ValueError("int4 needs rows= (the unpacked K)")
        rows = w_q.shape[0]
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    n = w_q.shape[1]
    if x.device.type == "cpu":
        out = dequant_matmul_reference(x2, w_q, scale, rows, bits)
    elif x.device.type == "cuda":
        out = _launch_cuda(x2, w_q, scale, rows, bits)
    else:
        raise ValueError(f"dequant_matmul runs on cuda or cpu tensors, got "
                         f"{x.device}")
    return out.reshape(lead + (n,))


def _launch_cuda(x2, w_q, scale, rows, bits, splits=0):
    """Launch the kernel. ``splits``, the bf16 kernel's K split count (0:
    its own choice), is for timing the alternatives side by side."""
    m, k = x2.shape
    n = w_q.shape[1]
    if x2.dtype not in _DTYPE_CODE:
        raise TypeError(f"dequant_matmul kernel takes float32 or bfloat16 "
                        f"activations, got {x2.dtype}")
    if w_q.dtype != torch.int8 or w_q.device != x2.device:
        raise TypeError(f"w_q is {w_q.dtype} on {w_q.device}; the kernel "
                        f"needs int8 on {x2.device}")
    if scale.dtype != torch.float32 or scale.device != x2.device \
            or scale.numel() != n:
        raise TypeError(f"scale must be {n} float32 values on {x2.device}, "
                        f"got {scale.dtype} {tuple(scale.shape)} on "
                        f"{scale.device}")
    if k != rows:
        raise ValueError(f"x has K = {k}, the weight {rows} rows")
    want_rows = rows if bits == 8 else (rows + 1) // 2
    if w_q.shape[0] != want_rows:
        raise ValueError(f"int{bits} weight of {rows} rows must have "
                         f"{want_rows} payload rows, got {w_q.shape[0]}")
    if not (x2.is_contiguous() and scale.is_contiguous()):
        raise ValueError("dequant_matmul kernel needs contiguous x and "
                         "scale")
    ldw = w_q.stride(0) if w_q.shape[0] > 1 else n
    if n > 1 and w_q.stride(1) != 1 or ldw < n:
        raise ValueError(f"w_q must have unit column stride and a row "
                         f"stride >= N = {n}, got strides {w_q.stride()}")
    out = torch.empty((m, n), dtype=x2.dtype, device=x2.device)
    if m == 0 or n == 0:
        return out
    if k == 0:
        return out.zero_()
    vec_x = int(x2.dtype == torch.bfloat16 and k % 8 == 0
                and x2.data_ptr() % 16 == 0)
    vec_w = int(ldw % 16 == 0 and w_q.data_ptr() % 16 == 0)
    vec_out = int(n % 4 == 0 and out.data_ptr() % 8 == 0
                  and scale.data_ptr() % 16 == 0)
    stream = torch.cuda.current_stream(x2.device).cuda_stream
    err = _library().dequant_matmul(
        _DTYPE_CODE[x2.dtype], bits, x2.data_ptr(), w_q.data_ptr(),
        scale.data_ptr(), out.data_ptr(), m, n, k, w_q.shape[0], ldw, vec_x,
        vec_w, vec_out, splits, stream)
    if err != 0:
        raise RuntimeError(f"dequant_matmul launch failed: CUDA error {err}")
    LAUNCHES["int8_matmul" if bits == 8 else "int4_matmul"] += 1
    return out


def kernel_splits(bits, m, n, k):
    """The K split count (thread blocks per cluster) the bf16 kernel
    takes for an ``[m, k] @ [k, n]`` call on the current card."""
    return _library().dequant_matmul_splits(bits, m, n, k)


def _library():
    from ._build import load
    lib = load("int8_matmul")
    if lib.dequant_matmul.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.dequant_matmul.argtypes = [i, i] + [p] * 4 + [i] * 9 + [p]
        lib.dequant_matmul.restype = i
        lib.dequant_matmul_splits.argtypes = [i] * 4
        lib.dequant_matmul_splits.restype = i
        lib.dequant_matmul_smem_bytes.argtypes = [i] * 2
        lib.dequant_matmul_smem_bytes.restype = i
    return lib


__all__ = ["dequant_matmul", "dequant_matmul_reference", "kernel_splits"]
