"""Ragged paged attention — counterpart of ``paddle_tpu/kernels/paged_attention.py``.

One attention call for any traffic mix: queries of every row (decode
steps, q_len = 1, and prefill chunks, q_len = k) are packed row-wise
into one ``[total_q_tokens, Hq, d]`` buffer, each row's slot starting at
a multiple of ``q_block``; per-row ``(q_start, q_len, kv_len)`` and a
block table map the row onto a paged pool ``[Hkv, num_pages, page_size,
d]``. Token ``i`` of a chunk sits at absolute position
``kv_len - q_len + i`` and sees kv positions ``<=`` its own.

An int8 pool (``k_scales``/``v_scales``: one f32 scale per (kv head,
pool page)) is dequantized page by page where it is read.

Two implementations of one function:

- :func:`ragged_paged_attention_reference`, plain PyTorch: per row,
  gather its pages densely and run a causally masked softmax;
- the CUDA kernel ``csrc/ragged_paged_attention.cu`` (see its header),
  built by ``kernels/_build.py`` and launched on the current stream:
  a split-KV launch over :func:`ragged_splits` runs of each q block's
  pages, then (more than one split) a merge launch that combines the
  runs in order.

:func:`ragged_paged_attention` chooses by where the query lies: a CPU
tensor runs the plain version, a CUDA tensor launches the kernel or
raises. There is no fallback between the two.
"""
from __future__ import annotations

import ctypes

import torch

from . import LAUNCHES

#: most shared memory one block may use on an H100 (bytes)
_MAX_SMEM = 232448

_NEG_INF = -1e30
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
#: most kv splits of one q block, and the (q block, kv head, split) slots
#: the wrapper aims for. At the 7B step (T = 128, q_block 8, 32 kv heads:
#: 512 blocks, half of them dead padding) that gives 2 splits: 480 busy
#: blocks against the 396 that fit at once (3 per SM). On the H100 2
#: splits beat 4 and 8 at both the decode and the prefill step: a
#: block's start-up (four dependent memory round trips before its first
#: tile arrives) costs more than the longer walk of fewer splits
_MAX_SPLITS = 8
_TARGET_SLOTS = 1024
#: kv positions per staged tile of the kernel
_TILE = 64


def ragged_block_row(q_starts, num_blocks, q_block):
    """q block -> row map from the ascending slot starts; blocks past
    every live slot resolve to the last row (their tokens mask dead)."""
    q_starts = q_starts.to(torch.int32)
    starts = torch.arange(num_blocks, dtype=torch.int32,
                          device=q_starts.device) * q_block
    row = torch.searchsorted(q_starts, starts, right=True) - 1
    return row.clamp_min(0).to(torch.int32)


def ragged_splits(num_blocks, hkv, pages_per_seq, page_size):
    """The kernel's split count S, from shapes alone (no host read of the
    lengths): at most 8, at most the 64-position tiles a row's table can
    hold, and no more than ``1024 / (num_blocks x hkv)`` rounded up, so
    a large batch keeps one split and its scratch small."""
    tiles = -(-pages_per_seq * page_size // _TILE)
    want = -(-_TARGET_SLOTS // max(1, num_blocks * hkv))
    return max(1, min(_MAX_SPLITS, tiles, want))


def ragged_paged_attention_reference(q, k_pages, v_pages, block_tables,
                                     q_starts, q_lens, kv_lens, scale=None,
                                     k_scales=None, v_scales=None):
    """Plain PyTorch ragged paged attention: per live row, gather its
    pages densely (int8 pools dequantized at the gather with their
    per-(head, page) scales) and run a causally masked softmax in f32
    over its chunk's queries. Rows outside any live slot are zeros."""
    t, hq, d = q.shape
    hkv, _, ps, _ = k_pages.shape
    group = hq // hkv
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    out = torch.zeros((t, hq, d), dtype=torch.float32, device=q.device)
    for qs, ql, kl, tbl in zip(q_starts.tolist(), q_lens.tolist(),
                               kv_lens.tolist(), block_tables):
        if ql == 0:
            continue
        tbl = tbl[:(kl + ps - 1) // ps].long()       # live pages only
        k = k_pages[:, tbl].to(torch.float32)
        v = v_pages[:, tbl].to(torch.float32)
        if k_scales is not None:
            k = k * k_scales[:, tbl, None, None]
            v = v * v_scales[:, tbl, None, None]
        k = k.reshape(hkv, -1, d)
        v = v.reshape(hkv, -1, d)
        qi = q[qs:qs + ql].to(torch.float32).reshape(ql, hkv, group, d)
        s = torch.einsum("qhgd,hsd->hgqs", qi, k) * scale
        pos = torch.arange(s.shape[-1], device=q.device)
        limit = (kl - ql + torch.arange(ql, device=q.device))[:, None]
        ok = (pos[None, :] <= limit) & (pos[None, :] < kl)      # [ql, S]
        s = s.masked_fill(~ok, _NEG_INF)
        w = torch.softmax(s, -1)
        out[qs:qs + ql] = torch.einsum("hgqs,hsd->qhgd", w, v) \
            .reshape(ql, hq, d)
    return out.to(q.dtype)


def ragged_paged_attention(q, k_pages, v_pages, block_tables, q_starts,
                           q_lens, kv_lens, *, q_block=8, scale=None,
                           block_row=None, k_scales=None, v_scales=None):
    """Mixed prefill-chunk + decode attention over a paged KV pool.

    q [T, Hq, d]; k_pages/v_pages [Hkv, num_pages, page_size, d];
    block_tables [R, pages_per_seq] int32; q_starts/q_lens/kv_lens [R]
    int32 (pad rows: ``q_start = T, q_len = 0``); ``kv_len`` counts the
    chunk's own tokens. ``block_row`` optionally passes a precomputed
    :func:`ragged_block_row` (the engine derives it once per step).
    ``k_scales``/``v_scales`` [Hkv, num_pages] f32 (both or neither)
    dequantize int8 pools. Returns [T, Hq, d] in q's dtype; tokens
    outside every row's ``q_len`` are zeros.
    """
    t, hq, d = q.shape
    hkv, _, _, dk = k_pages.shape
    if dk != d:
        raise ValueError(f"head_dim mismatch: q {d} vs pages {dk}")
    if hq % hkv != 0:
        raise ValueError(f"num_q_heads {hq} not a multiple of kv heads {hkv}")
    if t % q_block != 0:
        raise ValueError(f"total_q_tokens {t} not a multiple of q_block "
                         f"{q_block}")
    if (k_scales is None) != (v_scales is None):
        raise ValueError("k_scales and v_scales must be given together")
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    if q.device.type == "cpu":
        return ragged_paged_attention_reference(
            q, k_pages, v_pages, block_tables, q_starts, q_lens, kv_lens,
            scale=scale, k_scales=k_scales, v_scales=v_scales)
    if q.device.type != "cuda":
        raise ValueError(f"ragged_paged_attention runs on cuda or cpu "
                         f"tensors, got {q.device}")
    if block_row is None:
        block_row = ragged_block_row(q_starts, t // q_block, q_block)
    return _launch_cuda(q, k_pages, v_pages, block_tables, q_starts,
                        q_lens, kv_lens, block_row, q_block, scale,
                        k_scales, v_scales)


def _launch_cuda(q, k_pages, v_pages, block_tables, q_starts, q_lens,
                 kv_lens, block_row, q_block, scale, k_scales, v_scales):
    t, hq, d = q.shape
    hkv, num_pages, ps, _ = k_pages.shape
    r, pps = block_tables.shape
    quant = k_scales is not None
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"ragged_paged_attention kernel takes float32 or "
                        f"bfloat16, got {q.dtype}")
    pool_dtype = torch.int8 if quant else q.dtype
    for name, x in (("k_pages", k_pages), ("v_pages", v_pages)):
        if x.dtype != pool_dtype or x.device != q.device:
            raise TypeError(f"{name} is {x.dtype} on {x.device}; the "
                            f"kernel needs {pool_dtype} on {q.device}")
    if quant:
        for name, x in (("k_scales", k_scales), ("v_scales", v_scales)):
            if x.dtype != torch.float32 or x.device != q.device or \
                    tuple(x.shape) != (hkv, num_pages) or \
                    not x.is_contiguous():
                raise TypeError(f"{name} must be contiguous float32 "
                                f"[{hkv}, {num_pages}] on {q.device}, got "
                                f"{x.dtype} {tuple(x.shape)} on {x.device}")
    if tuple(v_pages.shape) != tuple(k_pages.shape):
        raise ValueError(f"v_pages {tuple(v_pages.shape)} != k_pages "
                         f"{tuple(k_pages.shape)}")
    ints = {"block_tables": block_tables, "q_starts": q_starts,
            "q_lens": q_lens, "kv_lens": kv_lens, "block_row": block_row}
    for name, x in ints.items():
        if x.dtype != torch.int32 or x.device != q.device:
            raise TypeError(f"{name} must be int32 on {q.device}, got "
                            f"{x.dtype} on {x.device}")
    for name, n in (("q_starts", r), ("q_lens", r), ("kv_lens", r),
                    ("block_row", t // q_block)):
        if tuple(ints[name].shape) != (n,):
            raise ValueError(f"{name} shape {tuple(ints[name].shape)} != "
                             f"({n},)")
    tensors = [q, k_pages, v_pages, *ints.values()]
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("ragged_paged_attention kernel needs contiguous "
                         "tensors")
    # the kernel reads K and V 16 bytes at a time: fp pools need d % 8,
    # int8 pools (16 values per load) d % 16
    vec = 16 if quant else 8
    if d % vec != 0 or k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError(f"ragged_paged_attention kernel needs head_dim a "
                         f"multiple of {vec} for {k_pages.dtype} pools (got "
                         f"{d}) and 16-byte aligned pools")
    lib = _library()
    code = _DTYPE_CODE[q.dtype]
    smem = lib.ragged_paged_attention_smem_bytes(code, int(quant),
                                                 q_block * (hq // hkv), d)
    if smem > _MAX_SMEM:
        raise ValueError(f"q_block {q_block} x group {hq // hkv} x head_dim "
                         f"{d} needs {smem} bytes of shared memory per block, "
                         f"over the card's {_MAX_SMEM}")
    out = torch.empty_like(q)
    if t == 0:
        return out
    nb = t // q_block
    splits = ragged_splits(nb, hkv, pps, ps)
    # f32 partials (m, l, acc) of every split, read by the merge
    part = torch.empty((splits, t, hq, d) if splits > 1 else (0,),
                       dtype=torch.float32, device=q.device)
    part_ml = torch.empty((splits, t, hq, 2) if splits > 1 else (0,),
                          dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    meta = (block_row.data_ptr(), q_starts.data_ptr(), q_lens.data_ptr(),
            kv_lens.data_ptr())
    if quant:
        err = lib.ragged_paged_attention_int8(
            code, q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            k_scales.data_ptr(), v_scales.data_ptr(), out.data_ptr(),
            part.data_ptr(), part_ml.data_ptr(), *meta,
            block_tables.data_ptr(), nb, hq, hkv, d, num_pages, ps, pps,
            q_block, splits, float(scale), stream)
    else:
        err = lib.ragged_paged_attention(
            code, q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            out.data_ptr(), part.data_ptr(), part_ml.data_ptr(), *meta,
            block_tables.data_ptr(), nb, hq, hkv, d, num_pages, ps, pps,
            q_block, splits, float(scale), stream)
    if err != 0:
        raise RuntimeError(f"ragged_paged_attention launch failed: CUDA "
                           f"error {err}")
    LAUNCHES["ragged_paged_attention_int8" if quant
             else "ragged_paged_attention"] += 1
    if splits > 1:
        err = lib.ragged_paged_attention_merge(
            code, out.data_ptr(), part.data_ptr(), part_ml.data_ptr(), *meta,
            nb, hq, hkv, d, q_block, splits, stream)
        if err != 0:
            raise RuntimeError(f"ragged_paged_attention merge launch "
                               f"failed: CUDA error {err}")
        LAUNCHES["ragged_paged_attention_merge"] += 1
    return out


def ragged_last_body():
    """The kernel body this process's last launch took: ``"tensor
    cores"`` (bf16 q, head_dim % 16 == 0 and <= 256) or ``"cuda cores"``
    (None before the first)."""
    return {1: "tensor cores", 0: "cuda cores", -1: None}[
        _library().ragged_paged_attention_last_body()]


def _library():
    from ._build import load
    lib = load("ragged_paged_attention")
    if lib.ragged_paged_attention.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.ragged_paged_attention_last_body.argtypes = []
        lib.ragged_paged_attention_last_body.restype = i
        lib.ragged_paged_attention_smem_bytes.argtypes = [i, i, i, i]
        lib.ragged_paged_attention_smem_bytes.restype = ctypes.c_size_t
        lib.ragged_paged_attention.argtypes = (
            [i] + [p] * 11 + [i] * 9 + [ctypes.c_float, p])
        lib.ragged_paged_attention.restype = i
        lib.ragged_paged_attention_int8.argtypes = (
            [i] + [p] * 13 + [i] * 9 + [ctypes.c_float, p])
        lib.ragged_paged_attention_int8.restype = i
        lib.ragged_paged_attention_merge.argtypes = [i] + [p] * 7 + [i] * 6 \
            + [p]
        lib.ragged_paged_attention_merge.restype = i
    return lib


def paged_attention(q, k_pages, v_pages, block_tables, seq_lens, *,
                    scale=None, k_scales=None, v_scales=None):
    """Single-token decode attention: the ``q_len = 1`` case of
    :func:`ragged_paged_attention` (one query row per sequence,
    ``q_block = 1``). q [B, Hq, d]; seq_lens [B] valid kv lengths.
    Returns [B, Hq, d]."""
    b = q.shape[0]
    arange = torch.arange(b, dtype=torch.int32, device=q.device)
    return ragged_paged_attention(
        q, k_pages, v_pages, block_tables, q_starts=arange,
        q_lens=torch.ones(b, dtype=torch.int32, device=q.device),
        kv_lens=seq_lens.to(torch.int32), q_block=1, scale=scale,
        k_scales=k_scales, v_scales=v_scales)


__all__ = ["paged_attention", "ragged_block_row", "ragged_last_body",
           "ragged_paged_attention", "ragged_paged_attention_reference",
           "ragged_splits"]
