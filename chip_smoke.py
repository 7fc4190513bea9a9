#!/usr/bin/env python3
"""Chip smoke test of paddle_tpu_torch on one CUDA card (an H100).

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero):

1. build every CUDA kernel of the port from ``paddle_tpu_torch/kernels/
   csrc`` with nvcc for sm_90a (one nvcc per source, started together)
   and report each flash and ragged kernel instantiation's registers,
   spills (``-Xptxas -v``) and tensor-core instructions (HMMA/HGMMA in
   ``cuobjdump -sass``), and flash's and the ragged split kernel's
   dynamic shared memory: a bf16 flash forward, dq or dk/dv
   kernel, or a ragged tensor-core instantiation (bf16 or int8 pool),
   without them or with spills fails the run; the same for the
   dequant-matmul's four bf16 instantiations (int8 and int4, wgmma at
   M > 16, mma.sync at M <= 16), with their shared memory; and every
   rms_norm kernel's registers, spills, stack and shared memory (a
   register-tile kernel with spills or a stack frame fails the run);
2. hold each kernel against its plain PyTorch version on the card:
   ragged paged attention (f32 and bf16, a mixed GQA batch: decode rows,
   multi-page prefill chunks, padding rows, a dead tail; and a batch of
   rows over several kv splits: one run, one position past it, kv 1, a
   chunk of a 600-token prompt) over fp pools and over int8 pools with
   per-(head, page) scales, a second call bitwise equal; the dequant-matmul
   (int8 and int4; bf16 at every 7B serving shape: the ragged step's
   projections at M = 128, a layer-scope burst's k/v at M = 8 and the
   fused layer's k|v column slice in place, a second call bitwise equal;
   bf16 and f32 at an odd-K ragged-N shape); flash attention forward and backward (f32 and
   bf16 at the llama_125m, llama_1b GQA and a d=128 ragged-tail
   geometry, a second backward bitwise equal to the first; the bf16 GQA
   dk/dv group sum bitwise equal to its plain version); fused AdamW (an
   odd-length bucket, f32 and bf16 params,
   both weight-decay modes, t = 1 and 7); phase ``[rms]``: the rms_norm
   forward (y, rstd) and backward (dx, dw) kernels at f32, bf16, bf16 x
   with an f32 weight and f32 x with a bf16 weight, at the llama_1b
   [2048, 2048], llama_125m [8192, 768], a ragged [37, 4100], one row
   [1, 2048], a wide [3, 8192] and an odd [9, 1001] shape, two backward
   launches bitwise equal; the decode megakernel at one
   full-width 7B layer (8 rows at the decode step's kv lengths 49-632):
   bf16 weights with the self-kv contract, int8 weights, an int8 pool,
   and the append in the kernel over 2 layers (model scope) and 1 (a
   layer-scope burst's launch) with a bf16 and an int8 pool (the pools
   after the kernel's own append held to the plain append: pages within
   1 int8 step, scales 1e-6 relative); the prefill megakernel at one
   full-width 7B layer over a T = 128 mixed step (a 64-token chunk, a
   continuation chunk, decode rows, pad rows), bf16 or int8 weights over
   a bf16 or int8 pool;
3. hold the engine on the card against the same engine on the CPU
   (identical greedy tokens on a small f32 Llama: fp, then int8 and int4
   projections with an int8 pool), and 3 ``TrainStep``s of a small f32
   Llama on the card against the CPU (losses), then 3 more with
   ``remat=True`` and ``accumulate_steps=2`` (launches counted);
4. serve 8 requests on a full-width Llama-2-7B (bf16, 32 layers, random
   N(0, 0.02) weights from a seeded generator) through ``LLMEngine``,
   with the kernel launch counts reset just before and read just after:
   every attention call must have gone through the kernel and its merge
   (launches = layers x ragged steps each), every request must finish,
   the pool audit must pass;
5. phase ``[7b-q]``: the same load three more times on the same model,
   quantized on the card: int8 projections + int8 pool, int4
   projections + int8 pool, int8 projections + bf16 pool; each must
   finish every request with 7 dequant-matmul launches, 1 attention
   launch and 1 merge per layer and ragged step (every other count 0);
6. phase ``[7b-burst]``: the same load with ``burst_tokens=8`` in four
   engines (bf16, and int8 projections + int8 pool, each at layer and at
   model scope): every request finishes, the decode megakernel launches
   32 times per burst iteration at layer scope and once at model scope,
   each launch writing the token's K/V into the pool (no dequant-matmul
   launch from a burst; the ragged steps keep their kernels' counts), 2
   bursts are traced;
7. phase ``[7b-fused]``: the same load through
   ``prefill_megakernel="fused"`` three more times (bf16; int8
   projections + int8 pool; bf16 in bursts of 8 at model scope): every
   ragged step's layers go through the prefill megakernel (32 launches
   per ragged step, no ragged-attention launch; the int8 pool's k|v
   projection outside it, one call over the fused weight's adjacent k
   and v columns: 32 dequant-matmul launches per ragged step;
   one decode-megakernel launch per burst iteration), beside the unfused
   runs of the same call;
8. train a full-width llama_125m (``bench.py``'s configuration: 12
   layers, batch 8 x 1024, AdamW 1e-4, auto_cast O1 bf16) for 2 warm and
   10 timed ``TrainStep``s, the counts reset before the timed ones:
   every attention forward and backward went through the flash kernels
   (12 x steps each), every norm through the rms_norm kernels (25 x
   steps forward and backward) and every update through fused AdamW
   (buckets x steps); the loss starts near ln 32000 and falls; 2 steps
   are traced;
9. phase ``[1b]``: the same for llama_1b (``bench.py:182-188``: the
   TinyLlama-1.1B shape, 22 layers, GQA 32/4, tied embeddings,
   ``loss_chunk_size=512``, ``remat=True``), batch 1 x 2048: per step
   rms_norm 89 forward launches (2 per layer, again in the recompute,
   and the final norm) and 45 backward, flash forward 44, dq, dk/dv
   and the dk/dv group sum 22 each;
10. time every kernel at its main-path shapes beside its bound, its
    plain version and a PyTorch yardstick (SDPA forward and backward,
    for flash at the llama_125m and llama_1b step shapes with achieved
    TFLOP/s, ``enable_gqa`` at 1b; ``torch.matmul`` on the
    unquantized bf16 weight, for the dequant-matmul at each of its five
    7B serving shapes with GB/s and TFLOP/s and per layer,
    ``torch.optim.AdamW(fused=True)``,
    the ragged kernel's split and merge launches apart by the profiler,
    ``F.rms_norm``, with GB/s, the share of the bound and the time
    behind an L2 of clean lines; for the decode and prefill
    megakernels, which no single PyTorch call matches, the unfused
    path's time for the same
    layer; the decode megakernel's phases each beside its bound, and
    ``torch.matmul`` of the 8 rows by the layer's 7 bf16 weights as the
    yardstick of its projections), and the int8 pool's segmented append
    (plain PyTorch) at the 7B step's shapes;
11. phase ``[graphs]``: every owner of a CUDA graph (``jit/_capture.py``)
    captured against the same step run eagerly
    (``jit.enable_to_static(False)``) in this process, on the same
    weights. Serving (the 8-request load, 64 new tokens each): 7B bf16,
    int8 w + int8 KV and int4 w + int8 KV; fused bf16 and int8 w + int8
    KV; bursts of 8 at both scopes, bf16 and int8 w + int8 KV, with two
    sampled rows among the 8. Bitwise: tokens, every graph call's
    outputs (the ragged step's logits, tokens and row guard; a burst's
    tokens), every pool page and scale. Training (llama_125m and llama_1b at full width, in
    phases ``[125m]`` and ``[1b]``): 3 steps each way from the same
    weights, losses, every parameter and both AdamW moments bitwise.
    Launches per step equal in both modes; Python ran only to warm up
    and capture each key. Printed per path: host ms/step and device
    busy/idle eager against captured, the captured step's host spans,
    capture ms per key, keys and graph-pool bytes. Since capture is the
    default, phases 3–9 run captured too, and their times include each
    key's warm-up and capture.

It prints the card's name and power limit, the kernels' JSON line, and
last the line ``{"ok": true, "device": {...}}``. Without CUDA, or away
from the repository, it exits non-zero and prints no result.
"""
from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

#: H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, dense bf16 FLOP/s
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
#: the f32 peak outside the tensor cores (same data sheet)
F32_FLOPS = 67e12

#: kernel vs plain version on the card, max |diff|: f32 sums differ in
#: order only; bf16 outputs may round one bf16 ulp apart (2^-7 at |x|<2,
#: 2^-6 below 4)
ATOL = {"float32": 1e-4, "bfloat16": 2e-2}

#: flash attention, max |diff| over max(1, max |plain|): gradients sum
#: thousands of terms and reach magnitudes well above 1, so the bound
#: scales with the largest value (f32: summation order; bf16: 8-bit
#: rounding of the outputs)
FLASH_RTOL = {"float32": 1e-4, "bfloat16": 2e-2}

#: dequant-matmul vs plain, max |diff| over max(1, max |plain|): f32
#: sums in another order and scales after the sum; bf16 outputs may
#: round one or two bf16 ulps apart
MATMUL_RTOL = {"float32": 1e-5, "bfloat16": 1e-2}

#: decode megakernel vs plain, max |diff| over max(1, max |plain|): f32
#: sums in another order; in bf16 a sum landing near a rounding boundary
#: rounds one ulp apart and that ulp travels through the rest of the layer
MEGA_RTOL = {"float32": 1e-4, "bfloat16": 2e-2}

#: fused AdamW vs plain, max |diff|: the kernel rounds each operation
#: like the plain version (bitwise in the tests); 1 f32 ulp of slack
ADAMW_ATOL = 1e-6

#: the llama_125m training configuration (bench.py:205-209, :243-253)
TRAIN_125M = dict(vocab_size=32000, hidden_size=768, intermediate_size=2048,
                  num_hidden_layers=12, num_attention_heads=12,
                  num_key_value_heads=12, max_position_embeddings=1024,
                  loss_chunk_size=2048)
TRAIN_BATCH, TRAIN_SEQ = 8, 1024
#: the llama_1b training configuration and batch (bench.py:182-188)
TRAIN_1B = dict(vocab_size=32000, hidden_size=2048, intermediate_size=5632,
                num_hidden_layers=22, num_attention_heads=32,
                num_key_value_heads=4, max_position_embeddings=2048,
                tie_word_embeddings=True, loss_chunk_size=512, remat=True)
TRAIN_1B_BATCH = (1, 2048)
WARM_STEPS, TIMED_STEPS, TRACED_STEPS = 2, 10, 2


def log(msg):
    print(msg, flush=True)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# ragged inputs
# ---------------------------------------------------------------------------

def ragged_inputs(torch, rows, *, hq, hkv, d, ps, num_pages, pps, q_block,
                  t_total, dtype, seed):
    """Packed queries, a random pool and metadata for ``rows`` =
    [(q_len, kv_len)] (q_len 0 = padding row), each row on its own
    random pool pages, slots packed in order at q_block alignment."""
    rng = np.random.RandomState(seed)
    r = len(rows)
    q_starts = np.full(r, t_total, np.int32)
    q_lens = np.zeros(r, np.int32)
    kv_lens = np.zeros(r, np.int32)
    tables = np.zeros((r, pps), np.int32)
    free = rng.permutation(np.arange(1, num_pages)).tolist()
    cursor = 0
    for i, (ql, kl) in enumerate(rows):
        if ql == 0:
            continue
        q_starts[i], q_lens[i], kv_lens[i] = cursor, ql, kl
        n = -(-kl // ps)
        tables[i, :n] = [free.pop() for _ in range(n)]
        cursor += -(-ql // q_block) * q_block
    if cursor > t_total:
        raise ValueError(f"rows need {cursor} query slots, over {t_total}")
    dev = "cuda"
    q = torch.from_numpy(rng.randn(t_total, hq, d).astype(np.float32))
    k = torch.from_numpy(rng.randn(hkv, num_pages, ps, d).astype(np.float32))
    v = torch.from_numpy(rng.randn(hkv, num_pages, ps, d).astype(np.float32))
    ints = [torch.from_numpy(a).to(dev) for a in (tables, q_starts, q_lens,
                                                   kv_lens)]
    return (q.to(dev, dtype), k.to(dev, dtype), v.to(dev, dtype), *ints)


def attention_bound_ms(rows, *, hq, hkv, d, ps, t_total, itemsize,
                       int8_pool=False):
    """Least time for one ragged attention call with this data: bytes
    (live queries read, their causal pages of K and V read -- int8 pages
    with their two f32 scales per (head, page) for an int8 pool -- the
    whole output written) over HBM bandwidth vs multiply-adds (QK and PV
    over each live token's visible kv) over the bf16 peak. Returns
    (ms, "bytes" | "operations")."""
    nbytes = t_total * hq * d * itemsize                  # output
    page = ps * d + 4 if int8_pool else ps * d * itemsize
    flops = 0
    for ql, kl in rows:
        if ql == 0:
            continue
        nbytes += ql * hq * d * itemsize                  # live queries
        nbytes += -(-kl // ps) * page * hkv * 2           # K and V
        seen = sum(kl - ql + i + 1 for i in range(ql))
        flops += 4 * seen * d * hq
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, \
        ("bytes" if t_bytes >= t_ops else "operations")


#: device clock cycles per ms, measured once (``_sleep`` counts cycles)
_CYCLES_PER_MS = []

def sleep_cycles_per_ms(torch):
    if not _CYCLES_PER_MS:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1_000_000)                  # warm
        a.record()
        torch.cuda._sleep(20_000_000)
        b.record()
        torch.cuda.synchronize()
        _CYCLES_PER_MS.append(20_000_000 / a.elapsed_time(b))
    return _CYCLES_PER_MS[0]


def time_ms(torch, fn, iters, label=None, waits_ok=False, clean_l2=False):
    """Mean device time of one call of ``fn``, in ms: each call timed by
    its own CUDA events, after a 128 MB write has evicted the 50 MB L2
    (in the engine each layer's pages are read once per step, cold) and
    behind a device sleep during which the host enqueues the start
    event, ``fn``'s launches and the end event: the events then bracket
    device work, not the wrapper's host time (which a busy host
    stretches). The sleep lasts 4x the host time of one call (at least
    1.5 ms), and an event recorded at its end must still be pending
    once the end event is enqueued; if it is not, the call is timed
    again behind twice the sleep. A call that outlasts three doublings
    (16x its own host time) waits on the device inside: a kernel or a
    library call must not (it raises); a plain version or a path of
    several ops (``waits_ok``) may read lengths to the host, and then it
    is logged and its time includes the host's work between those
    waits, as its callers pay it. ``clean_l2``: evict the L2 by reading
    the 128 MB instead of writing them, so the call finds it full of
    clean lines and pays for no write-back of the eviction's lines (the
    default leaves up to 50 MB of dirty lines, which the call's first
    50 MB of traffic through the L2 must write back)."""
    label = label or getattr(fn, "__qualname__", "call")
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_ms = 1e3 * (time.perf_counter() - t0)
    torch.cuda.synchronize()
    per_ms = sleep_cycles_per_ms(torch)
    sleep_ms = max(1.5, 4 * host_ms)
    if sleep_ms > 1.5:
        log(f"[time]   {label}: one call takes {host_ms:.3f} ms on the "
            f"host; the device sleeps {sleep_ms:.2f} ms before each")
    events, doublings, waits = [], 0, False
    while len(events) < iters:
        if clean_l2:
            flush.view(torch.int32).amax()
        else:
            flush.zero_()
        torch.cuda._sleep(int(sleep_ms * per_ms))
        slept = torch.cuda.Event()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        slept.record()
        start.record()
        fn()
        end.record()
        if not waits and slept.query():   # the device caught up with the host
            torch.cuda.synchronize()
            if doublings < 3:
                doublings += 1
                sleep_ms *= 2
                continue
            if not waits_ok:
                raise RuntimeError(f"timing {label}: the call waits on the "
                                   f"device, or its enqueue outlasts 16x "
                                   f"its host time")
            waits, sleep_ms = True, 1.5
            log(f"[time]   {label}: waits on the device inside the call; "
                f"its time includes the host's work between the waits")
        events.append((start, end))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in events) / iters


def sdpa_yardstick(torch, q, k, v, tables, q_starts, q_lens, kv_lens):
    """One ``F.scaled_dot_product_attention`` call over the same rows,
    with K/V gathered densely beforehand (the gather is not timed) and
    the ragged causal mask as a boolean mask. Returns the call."""
    import torch.nn.functional as F
    hkv, _, ps, d = k.shape
    hq = q.shape[1]
    group = hq // hkv
    qs, qls, kls = q_starts.tolist(), q_lens.tolist(), kv_lens.tolist()
    live = [i for i, ql in enumerate(qls) if ql > 0]
    qmax = max(qls[i] for i in live)
    smax = max(-(-kls[i] // ps) for i in live) * ps
    dq = torch.zeros(len(live), hq, qmax, d, dtype=q.dtype, device=q.device)
    dk = torch.zeros(len(live), hq, smax, d, dtype=q.dtype, device=q.device)
    dv = torch.zeros_like(dk)
    mask = torch.zeros(len(live), 1, qmax, smax, dtype=torch.bool,
                       device=q.device)
    for b, i in enumerate(live):
        n = -(-kls[i] // ps)
        pages = tables[i, :n].long()
        kk = k[:, pages].reshape(hkv, n * ps, d)
        vv = v[:, pages].reshape(hkv, n * ps, d)
        dk[b, :, :n * ps] = kk.repeat_interleave(group, 0)
        dv[b, :, :n * ps] = vv.repeat_interleave(group, 0)
        dq[b, :, :qls[i]] = q[qs[i]:qs[i] + qls[i]].transpose(0, 1)
        pos = torch.arange(smax, device=q.device)
        lim = kls[i] - qls[i] + torch.arange(qmax, device=q.device)
        mask[b, 0] = pos[None, :] <= lim[:, None]
    return lambda: F.scaled_dot_product_attention(dq, dk, dv,
                                                  attn_mask=mask)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_build():
    from paddle_tpu_torch.kernels import _build
    names = _build.kernel_sources()
    secs = _build.build(names)
    for n in names:
        _build.load(n)
    log(f"[build] {names} built for sm_90a in {secs:.2f} s (set-up)")
    report_flash_build(_build)
    report_ragged_build(_build)
    report_matmul_build(_build)
    report_rms_build(_build)
    report_prefill_build(_build)
    report_decode_build(_build)
    report_adamw_build(_build)


#: an rms_norm kernel's mangled name: body and template arguments
RMS_SYMBOL = re.compile(r"(rms_(?:fwd|bwd|dw)_\w*?kernel)I(\w+?)E+v")


def report_rms_build(_build, name="rms_norm"):
    """Per rms_norm kernel instantiation of ``csrc/<name>.cu``: registers,
    spills, stack and static shared memory (``-Xptxas -v``), and the
    backward ring's dynamic shared memory at the llama_1b and llama_125m
    widths. Raises on a register-tile kernel (the main path's) that
    spills or keeps a stack frame. Returns the rows."""
    from paddle_tpu_torch.kernels import rms_norm as trn
    ptx, _ = build_info(_build, name)
    rows = []
    for sym in sorted(ptx):
        m = RMS_SYMBOL.search(sym)
        if not m:
            continue
        info = ptx[sym]
        rows.append((m.group(1), m.group(2), info.get("registers"),
                     info.get("spills"), info.get("stack", 0),
                     info.get("smem", 0)))
        log(f"[build] {name}: {m.group(1)}<{m.group(2)}>: {rows[-1][2]} "
            f"registers, spills (store, load bytes) {rows[-1][3]}, stack "
            f"{rows[-1][4]} B, static shared memory {rows[-1][5]} B")
    smem = _build.load(name).rms_norm_bwd_smem_bytes
    smem.argtypes = trn._library().rms_norm_bwd_smem_bytes.argtypes
    smem.restype = trn._library().rms_norm_bwd_smem_bytes.restype
    log(f"[build] {name}: backward ring per block: {smem(0, 1, 2048)} B at "
        f"[2048, 2048] f32 ({trn.bwd_threads(2048)} threads), "
        f"{smem(0, 1, 768)} B at [8192, 768] f32 "
        f"({trn.bwd_threads(768)} threads); dw chunks "
        f"{trn.dw_chunks(2048, 2048)} and {trn.dw_chunks(8192, 768)} "
        f"(chunks, rows per chunk)")
    tile = [r for r in rows if "tile" in r[0]]
    if not tile or any(r[3] != (0, 0) or r[4] for r in tile):
        raise AssertionError(f"rms_norm tile kernels with spills or a stack "
                             f"frame: {tile}")
    return rows


#: a prefill megakernel's mangled name: its template arguments (hidden,
#: weight and pool types)
PREFILL_SYMBOL = re.compile(r"prefill_megakernelI(\w+?)EEv")


def prefill_variant_name(args):
    """``hidden/weights/pool`` of a prefill megakernel's mangled template
    arguments (``13__nv_bfloat16`` is bf16, ``S<n>_`` repeats it, ``a`` is
    int8, ``f`` f32)."""
    out, first = [], None
    for tok in re.findall(r"13__nv_bfloat16|S\d*_|a|f", args):
        name = {"a": "int8", "f": "f32"}.get(tok, "bf16")
        first = first or name
        out.append(name)
    return "/".join(out)


def report_prefill_build(_build, name="prefill_megakernel", strict=True):
    """Per prefill megakernel instantiation of ``csrc/<name>.cu``:
    registers, spills, dynamic shared memory and HGMMA/HMMA count, the
    cluster and the launch route. ``strict``: raises unless every bf16
    instantiation (bf16 or int8 weights) has wgmma (HGMMA) and no
    spills. Returns the rows."""
    ptx, mma = build_info(_build, name)
    limits = (ctypes.c_int * 9)()
    lib = _build.load(name)
    lib.prefill_megakernel_limits.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.prefill_megakernel_limits(limits)
    rows = []
    for sym in sorted(set(ptx) | set(mma)):
        m = PREFILL_SYMBOL.search(sym)
        if not m:
            continue
        info = ptx.get(sym, {})
        rows.append(dict(variant=prefill_variant_name(m.group(1)),
                         registers=info.get("registers"),
                         spills=info.get("spills"), mma=mma.get(sym, 0)))
        log(f"[build] {name}<{rows[-1]['variant']}>: {rows[-1]['registers']} "
            f"registers, spills (store, load bytes) {rows[-1]['spills']}, "
            f"{rows[-1]['mma']} HMMA/HGMMA instructions, "
            f"{limits[8]} B dynamic shared memory, clusters of {limits[3]}")
    tc = [r for r in rows if r["variant"].startswith("bf16")]
    bad = [r for r in tc if r["mma"] == 0 or r["spills"] != (0, 0)]
    if strict and (len(tc) != 4 or bad):
        raise AssertionError(f"prefill megakernel bf16 instantiations without "
                             f"tensor-core instructions or with spills: {tc}")
    return rows


#: a decode megakernel's mangled name: its template arguments (hidden,
#: weight and pool types)
DECODE_SYMBOL = re.compile(r"decode_megakernelI(\w+?)EEv")


def report_decode_build(_build, name="decode_megakernel", strict=True):
    """Per decode megakernel instantiation of ``csrc/<name>.cu``:
    registers, spills and HMMA/HGMMA count, and the launch geometry.
    ``strict``: raises unless every bf16 instantiation (bf16 or int8
    weights) has tensor-core instructions and no instantiation spills.
    Returns the rows."""
    ptx, mma = build_info(_build, name)
    limits = (ctypes.c_int * 6)()
    strip = (ctypes.c_int * 3)()
    lib = _build.load(name)
    lib.decode_megakernel_limits.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.decode_megakernel_limits(limits)
    lib.decode_megakernel_strip.argtypes = [ctypes.c_int, ctypes.c_int,
                                            ctypes.POINTER(ctypes.c_int)]
    rows = []
    for sym in sorted(set(ptx) | set(mma)):
        m = DECODE_SYMBOL.search(sym)
        if not m:
            continue
        info = ptx.get(sym, {})
        rows.append(dict(variant=prefill_variant_name(m.group(1)),
                         registers=info.get("registers"),
                         spills=info.get("spills"), mma=mma.get(sym, 0)))
        hidden, weights = rows[-1]["variant"].split("/")[:2]
        lib.decode_megakernel_strip(int(hidden == "bf16"),
                                    int(weights == "int8"), strip)
        log(f"[build] {name}<{rows[-1]['variant']}>: {rows[-1]['registers']} "
            f"registers, spills (store, load bytes) {rows[-1]['spills']}, "
            f"{rows[-1]['mma']} HMMA/HGMMA instructions; weight strips of "
            f"{strip[0]} columns in k tiles of {strip[1]}, {limits[4]} "
            f"phases a layer")
    tc = [r for r in rows if r["variant"].startswith("bf16")]
    bad = [r for r in rows if r["spills"] != (0, 0)] + \
        [r for r in tc if r["mma"] == 0]
    if strict and (len(tc) != 4 or len(rows) != 8 or bad):
        raise AssertionError(f"decode megakernel instantiations without "
                             f"tensor-core instructions (bf16) or with "
                             f"spills: {rows}")
    return rows


def report_adamw_build(_build):
    """fused AdamW's registers and spills per params dtype."""
    ptx, _ = build_info(_build, "fused_adamw")
    for sym, info in sorted(ptx.items()):
        if "fused_adamw_kernel" in sym:
            dt = "bf16" if "bfloat16" in sym else "f32"
            log(f"[build] fused_adamw_kernel<{dt}>: {info.get('registers')} "
                f"registers, spills (store, load bytes) {info.get('spills')}")


#: a dequant-matmul bf16 kernel's mangled name: bits, and M <= 16
MATMUL_SYMBOL = re.compile(r"dequant_matmul_bf16ILi(\d)ELb([01])E")


def report_matmul_build(_build):
    """Per dequant-matmul bf16 instantiation (int8/int4, wgmma at M > 16
    or mma.sync at M <= 16): registers, spills, tensor-core instructions
    and dynamic shared memory. Raises unless all four have tensor-core
    instructions and no spills."""
    from paddle_tpu_torch.kernels import int8_matmul as tmm
    ptx, mma = build_info(_build, "int8_matmul")
    smem = tmm._library().dequant_matmul_smem_bytes
    rows = []
    for name in sorted(set(ptx) | set(mma)):
        m = MATMUL_SYMBOL.search(name)
        if not m:
            continue
        bits, small = int(m.group(1)), int(m.group(2))
        info = ptx.get(name, {})
        rows.append((bits, small, info.get("registers"), info.get("spills"),
                     mma.get(name, 0)))
        log(f"[build] dequant_matmul_bf16<int{bits}, "
            f"{'mma.sync, M <= 16' if small else 'wgmma, M > 16'}>: "
            f"{rows[-1][2]} registers, spills (store, load bytes) "
            f"{rows[-1][3]}, {rows[-1][4]} HMMA/HGMMA instructions, "
            f"{smem(bits, small)} B dynamic shared memory")
    if len(rows) != 4 or any(r[4] == 0 or r[3] != (0, 0) for r in rows):
        raise AssertionError(f"dequant-matmul kernels without tensor-core "
                             f"instructions or with spills: {rows}")


#: a flash kernel's mangled name: template and head dim
FLASH_SYMBOL = re.compile(r"(flash_(?:fwd|bwd|dkv)\w*?kernel)ILi(\d+)E")
#: the CUDA-core kernels of the f32 path; every other flash kernel is bf16
FLASH_F32 = ("flash_fwd_kernel", "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel")


def build_info(_build, name):
    """Per kernel of ``csrc/<name>.cu`` (mangled name): registers and
    spills from nvcc's ``-Xptxas -v`` report, and the count of
    tensor-core instructions (HMMA/HGMMA) in its SASS (``cuobjdump``)."""
    ptx, entry = {}, None
    for line in _build.ptxas_log(name).splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry = m.group(1)
            ptx[entry] = {}
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and entry:
            ptx[entry]["spills"] = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            ptx[entry]["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes smem", line)
        if m and entry:
            ptx[entry]["smem"] = int(m.group(1))
        m = re.search(r"(\d+) bytes stack frame", line)
        if m and entry:
            ptx[entry]["stack"] = int(m.group(1))
    cuobjdump = Path(_build.nvcc()).parent / "cuobjdump"
    sass = subprocess.run(
        [str(cuobjdump), "-sass", str(_build.library_path(name))],
        capture_output=True, text=True, check=True, timeout=300).stdout
    mma, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            fn = m.group(1)
            mma[fn] = 0
        elif fn and re.search(r"\bH(G)?MMA\b", line):
            mma[fn] += 1
    return ptx, mma


#: a ragged kernel's mangled name: body and template arguments
RAGGED_SYMBOL = re.compile(r"(ragged_kernel_(?:mma|simt|merge))I(\w*?)EEv")


def report_ragged_build(_build):
    """Per ragged kernel instantiation: registers, spills and HMMA count.
    The tensor-core body is instantiated for head dims up to 64, 128 and
    256 over bf16 and int8 pools: raises unless all six have tensor-core
    instructions and no spills."""
    ptx, mma = build_info(_build, "ragged_paged_attention")
    tc = []
    for name in sorted(set(ptx) | set(mma)):
        m = RAGGED_SYMBOL.search(name)
        if not m:
            continue
        info = ptx.get(name, {})
        row = (m.group(1), m.group(2), info.get("registers"),
               info.get("spills"), mma.get(name, 0))
        if m.group(1) == "ragged_kernel_mma":
            tc.append(row)
        log(f"[build] {m.group(1)}<{m.group(2)}>: {row[2]} registers, "
            f"spills (store, load bytes) {row[3]}, {row[4]} HMMA/HGMMA "
            f"instructions")
    if len(tc) != 6 or any(r[4] == 0 or r[3] != (0, 0) for r in tc):
        raise AssertionError(f"ragged tensor-core kernels without HMMA or "
                             f"with spills: {tc}")
    from paddle_tpu_torch.kernels import paged_attention as tpa
    smem = tpa._library().ragged_paged_attention_smem_bytes
    log(f"[build] ragged split kernel at the 7B step (8 rows, d 128): "
        f"{smem(1, 0, 8, 128)} B (bf16 pool) and {smem(1, 1, 8, 128)} B "
        f"(int8 pool) of dynamic shared memory per block")


def report_flash_build(_build):
    """Per flash kernel instantiation: registers and spills from nvcc's
    ``-Xptxas -v`` report, dynamic shared memory per launch, and the
    tensor-core instructions (HMMA/HGMMA) in its SASS (``cuobjdump``).
    Raises if a bf16 flash kernel has no tensor-core instruction or
    spills."""
    from paddle_tpu_torch.kernels import flash_attention as tfa
    ptx, mma = build_info(_build, "flash_attention")
    lib = tfa._library()
    kinds = {"flash_fwd": 0, "flash_bwd_dq": 1, "flash_bwd_dkv": 2}
    rows = []
    for name in sorted(set(ptx) | set(mma)):
        m = FLASH_SYMBOL.search(name)
        if not m:
            continue
        kernel, d = m.group(1), int(m.group(2))
        dtype = "f32" if kernel in FLASH_F32 else "bf16"
        kind = next((v for k, v in kinds.items() if kernel.startswith(k)),
                    None)
        smem = lib.flash_attention_smem_bytes(kind, int(dtype == "bf16"),
                                              d) if kind is not None else 0
        info = ptx.get(name, {})
        rows.append((kernel, dtype, d, info.get("registers"),
                     info.get("spills"), smem, mma.get(name, 0)))
        log(f"[build] {kernel}<{dtype}, d {d}>: {info.get('registers')} "
            f"registers, spills (store, load bytes) {info.get('spills')}, "
            f"{smem} B dynamic shared memory, {mma.get(name, 0)} HMMA/HGMMA "
            f"instructions")
    # the bf16 forward, dq and dk/dv kernels at d 64 and 128 (the group
    # sum adds, it multiplies nothing)
    bf16 = [r for r in rows if r[1] == "bf16" and r[5]]
    if len(bf16) != 6 or any(r[6] == 0 or r[4] != (0, 0) for r in bf16):
        raise AssertionError(f"bf16 flash kernels without tensor-core "
                             f"instructions or with spills: {bf16}")


#: the ragged parity batches, GQA 8/2 at d 128: (rows, pool pages,
#: pages per row, T). "mixed": decode rows, prefill chunks over several
#: pages (first chunks and mid-prompt ones), padding rows (last, as the
#: engine packs them) and dead blocks at the tail; "multi-run": horizons
#: of one 64-position run and one position past it, kv 1, a 40-token
#: chunk of a 600-token prompt and long decode rows (8 splits, the merge)
RAGGED_BATCHES = {
    "mixed GQA batch": ([(1, 1), (1, 37), (20, 45), (8, 8), (13, 70),
                         (1, 16), (0, 0), (0, 0)], 40, 8, 96),
    "multi-run batch": ([(1, 64), (1, 65), (1, 1), (40, 600), (1, 632),
                         (13, 300), (0, 0)], 200, 40, 112),
}


def ragged_parity(torch, label, seed, int8_pool):
    """The ragged kernel against its plain version over each parity
    batch, f32 and bf16; a second call must give the same bits. Returns
    the worst |diff|."""
    from paddle_tpu_torch.kernels.paged_attention import (
        ragged_paged_attention, ragged_paged_attention_reference)
    worst = 0.0
    for batch, (rows, pages, pps, t) in RAGGED_BATCHES.items():
        for name, dtype in (("float32", torch.float32),
                            ("bfloat16", torch.bfloat16)):
            q, k, v, tables, q_starts, q_lens, kv_lens = ragged_inputs(
                torch, rows, hq=8, hkv=2, d=128, ps=16, num_pages=pages,
                pps=pps, q_block=8, t_total=t, dtype=dtype, seed=seed)
            kw = {}
            if int8_pool:
                k, ks, v, vs = quantize_pools(torch, k, v)
                kw = dict(k_scales=ks, v_scales=vs)
            args = (q, k, v, tables, q_starts, q_lens, kv_lens)
            got = ragged_paged_attention(*args, q_block=8, **kw)
            again = ragged_paged_attention(*args, q_block=8, **kw)
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                raise AssertionError(f"{label} {name} {batch}: two calls "
                                     f"differ")
            want = ragged_paged_attention_reference(*args, **kw)
            err = (got.float() - want.float()).abs().max().item()
            log(f"[parity] {label} {name} {batch}: max|kernel - plain| = "
                f"{err:.3e} (atol {ATOL[name]:g}); a second call bitwise "
                f"equal")
            if not (torch.isfinite(got.float()).all() and err <= ATOL[name]):
                raise AssertionError(f"{label} disagrees with its plain "
                                     f"version in {name} {batch}: {err}")
            worst = max(worst, err)
    return worst


def phase_kernel_parity(torch):
    return ragged_parity(torch, "ragged_paged_attention", 3, False)


def phase_engine_parity(torch):
    import paddle_tpu_torch as pt
    cfg = pt.llama_tiny_config(num_hidden_layers=2, hidden_size=128,
                               intermediate_size=256, num_attention_heads=4,
                               num_key_value_heads=2, vocab_size=512)
    model = pt.LlamaForCausalLM(cfg, device="cpu",
                                generator=torch.Generator().manual_seed(5))
    rng = np.random.RandomState(5)
    prompts = [rng.randint(0, 512, (n,)).tolist()
               for n in (3, 9, 17, 30, 41, 64)]
    tokens = {}
    for dev in ("cpu", "cuda"):
        eng = pt.LLMEngine(model, max_len=128, page_size=16, max_num_seqs=4,
                           chunk_size=16, device=dev)
        rids = [eng.add_request(p, max_new_tokens=8) for p in prompts]
        outs = eng.run(max_steps=500)
        eng.pool.check_invariants()
        tokens[dev] = [outs[r].token_ids for r in rids]
    if tokens["cpu"] != tokens["cuda"]:
        raise AssertionError(f"greedy tokens differ between the card and "
                             f"the CPU: {tokens}")
    log(f"[engine] small f32 Llama: greedy tokens on cuda == cpu for "
        f"{len(prompts)} requests x 8 tokens")


def quantize_pools(torch, k, v):
    """int8 copies of fp pools with one f32 scale per (kv head, page), as
    the engine's append leaves a full page."""
    out = []
    for pool in (k, v):
        s = pool.float().abs().amax(dim=(2, 3)).clamp_min(1e-8) / 127.0
        out += [torch.round(pool.float() / s[:, :, None, None])
                .clamp(-127, 127).to(torch.int8), s.contiguous()]
    return out


#: the 7B projections at the ragged step's M = 128: (name, K, N, count
#: per layer)
PROJ_7B = [("q/k/v/o", 4096, 4096, 4), ("gate/up", 4096, 11008, 2),
           ("down", 11008, 4096, 1)]
STEP_M = 128

#: every shape the dequant-matmul takes on the 7B serving paths: (name,
#: M, K, N, row stride of the payload): the ragged step's projections,
#: the k and v projections of a layer-scope burst's append (8 rows), and
#: the k|v columns of the fused q|k|v weight that the fused int8 + int8-KV
#: layer projects in place (a column slice, row stride 3 x 4096)
MATMUL_SHAPES_7B = [(name, STEP_M, k, n, n) for name, k, n, _ in PROJ_7B] + [
    ("burst k/v", 8, 4096, 4096, 4096),
    ("fused k|v", STEP_M, 4096, 8192, 12288)]


def matmul_case(torch, g, m, k, n, ldw, bits):
    """bf16 x [m, k], a random N(0, 0.02) bf16 weight [k, ldw] quantized
    per column, and its last n columns: (x, payload, scale, bf16 weight),
    the payload and weight column slices (row stride ldw) when ldw > n."""
    from paddle_tpu_torch.quantization.low_bit import quantize_weight
    w = (torch.randn(k, ldw, device="cuda", generator=g) * 0.02) \
        .to(torch.bfloat16)
    x = torch.randn(m, k, device="cuda", generator=g).to(torch.bfloat16)
    qw = quantize_weight(w, f"weight_only_int{bits}")
    lo = ldw - n
    return x, qw.qdata[:, lo:], qw.scale[lo:], w[:, lo:]


def phase_lowbit_parity(torch):
    """The dequant-matmul (int8 and int4; bf16 at every 7B serving shape,
    two calls bitwise equal, and an odd-K ragged-N shape, f32 at the
    latter) and the int8 ragged kernel (f32 and bf16, the mixed GQA
    batch) against their plain versions; then a small quantized engine
    on the card against the CPU. Returns the worst |diff| per kernel."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.kernels.int8_matmul import (
        dequant_matmul, dequant_matmul_reference)
    worst = {"int8_matmul": 0.0, "int4_matmul": 0.0,
             "ragged_paged_attention_int8": 0.0}
    g = torch.Generator(device="cuda").manual_seed(9)
    # every 7B serving shape (bf16, a second call bitwise equal), then an
    # odd K and a ragged N in bf16 and f32
    cases = [(name, m, k, n, ldw, torch.bfloat16)
             for name, m, k, n, ldw in MATMUL_SHAPES_7B]
    cases += [("odd", 8, 1023, 200, 200, torch.bfloat16),
              ("odd", 8, 1023, 200, 200, torch.float32)]
    for name, m, k, n, ldw, dtype in cases:
        for bits in (8, 4):
            x, wq, sc, _ = matmul_case(torch, g, m, k, n, ldw, bits)
            x = x.to(dtype)
            got = dequant_matmul(x, wq, sc, rows=k, bits=bits)
            again = dequant_matmul(x, wq, sc, rows=k, bits=bits)
            torch.cuda.synchronize()
            want = dequant_matmul_reference(x, wq, sc, k, bits)
            err = (got.float() - want.float()).abs().max().item()
            scale = max(1.0, want.float().abs().max().item())
            tol = MATMUL_RTOL[str(dtype).replace("torch.", "")]
            if not (torch.isfinite(got.float()).all() and err <= tol * scale):
                raise AssertionError(f"dequant_matmul int{bits} {dtype} "
                                     f"{name} {m}x{k}x{n}: |diff| {err} over "
                                     f"{scale}")
            if not torch.equal(got, again):
                raise AssertionError(f"dequant_matmul int{bits} {dtype} "
                                     f"{name}: two calls differ")
            key = f"int{bits}_matmul"
            worst[key] = max(worst[key], err)
            log(f"[parity] dequant_matmul int{bits} {dtype} {name} (M {m} K "
                f"{k} N {n}, payload row stride {wq.stride(0)}): "
                f"max|kernel - plain| = {err:.3e} (<= {tol:g} x max(1, "
                f"max|plain|) = {tol * scale:.3e}); a second call bitwise "
                f"equal")
    worst["ragged_paged_attention_int8"] = ragged_parity(
        torch, "ragged_paged_attention_int8", 4, True)
    cfg = pt.llama_tiny_config(num_hidden_layers=2, hidden_size=128,
                               intermediate_size=256, num_attention_heads=4,
                               num_key_value_heads=2, vocab_size=512)
    model = pt.LlamaForCausalLM(cfg, device="cpu",
                                generator=torch.Generator().manual_seed(5))
    rng = np.random.RandomState(5)
    prompts = [rng.randint(0, 512, (n,)).tolist()
               for n in (3, 9, 17, 30, 41, 64)]
    for mode in ("weight_only_int8", "weight_only_int4"):
        tokens = {}
        for dev in ("cpu", "cuda"):
            eng = pt.LLMEngine(model, max_len=128, page_size=16,
                               max_num_seqs=4, chunk_size=16, device=dev,
                               quantized_mode=mode, kv_cache_dtype="int8")
            rids = [eng.add_request(p, max_new_tokens=8) for p in prompts]
            outs = eng.run(max_steps=500)
            eng.pool.check_invariants()
            tokens[dev] = [outs[r].token_ids for r in rids]
        if tokens["cpu"] != tokens["cuda"]:
            raise AssertionError(f"{mode} + int8 KV: greedy tokens differ "
                                 f"between the card and the CPU: {tokens}")
        log(f"[engine] small f32 Llama, {mode} + int8 KV: greedy tokens on "
            f"cuda == cpu for {len(prompts)} requests x 8 tokens")
    return worst


def _flash_case(torch, b, hq, hkv, sq, sk, d, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    shapes = ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d),
              (b, hq, sq, d))
    return [torch.randn(*s, device="cuda", generator=g).to(dtype)
            for s in shapes]


def phase_flash_parity(torch):
    """Flash forward and backward against the plain version, f32 and
    bf16, at three geometries; a second backward launch bitwise equal to
    the first; the bf16 GQA group sum bitwise equal to its plain version.
    Returns the worst |diff| per kernel."""
    from paddle_tpu_torch.kernels import flash_attention as tfa
    geos = {"125m (b2 h12/12 s1024 d64)": (2, 12, 12, 1024, 1024, 64),
            "1b GQA (b1 h32/4 s2048 d64)": (1, 32, 4, 2048, 2048, 64),
            "d128 tail (b1 h8/2 sq192 sk320)": (1, 8, 2, 192, 320, 128)}
    worst = {"flash_attention_fwd": 0.0, "flash_attention_bwd_dq": 0.0,
             "flash_attention_bwd_dkv": 0.0,
             "flash_attention_bwd_dkv_sum": 0.0}
    for label, geo in geos.items():
        for name, dtype in (("float32", torch.float32),
                            ("bfloat16", torch.bfloat16)):
            q, k, v, do = _flash_case(torch, *geo, dtype, seed=7)
            q, k, v = (x.requires_grad_() for x in (q, k, v))
            scale = geo[-1] ** -0.5
            out, lse = tfa.FlashAttention.apply(q, k, v, True, scale)
            got = (out, *torch.autograd.grad(out, (q, k, v), do))
            again = tfa.flash_attention_bwd(q.detach(), k.detach(),
                                            v.detach(), out.detach(), lse,
                                            do, True, scale)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got[1:], again)):
                raise AssertionError(f"flash {label} {name}: two backward "
                                     f"launches differ")
            ref, _ = tfa.flash_attention_reference(q, k, v, True)
            want = (ref, *torch.autograd.grad(ref, (q, k, v), do))
            errs = []
            for a, b in zip(got, want):
                err = (a.float() - b.float()).abs().max().item()
                scale = max(1.0, b.float().abs().max().item())
                if not (torch.isfinite(a.float()).all()
                        and err <= FLASH_RTOL[name] * scale):
                    raise AssertionError(f"flash {label} {name}: |diff| "
                                         f"{err} over scale {scale}")
                errs.append(err)
            worst["flash_attention_fwd"] = max(
                worst["flash_attention_fwd"], errs[0])
            worst["flash_attention_bwd_dq"] = max(
                worst["flash_attention_bwd_dq"], errs[1])
            worst["flash_attention_bwd_dkv"] = max(
                worst["flash_attention_bwd_dkv"], errs[2], errs[3])
            log(f"[parity] flash {label} {name} causal: max|kernel - plain| "
                f"out {errs[0]:.3e}, dq {errs[1]:.3e}, dk {errs[2]:.3e}, "
                f"dv {errs[3]:.3e} (<= {FLASH_RTOL[name]:g} x max(1, "
                f"max|plain|)); a second backward bitwise equal")
    # the group sum alone at the llama_1b shape: in head order, as the
    # plain version adds, so bitwise
    g = torch.Generator(device="cuda").manual_seed(8)
    part = torch.randn(2, 1, 32, 2048, 64, device="cuda", generator=g)
    k, v = (torch.empty(1, 4, 2048, 64, device="cuda", dtype=torch.bfloat16)
            for _ in range(2))
    got = tfa.flash_attention_bwd_dkv_sum(part, k, v)
    want = tfa.flash_attention_bwd_dkv_sum_reference(part, k, v)
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError("flash dk/dv group sum differs from its plain "
                             "version")
    log("[parity] flash dk/dv group sum (b1 h32/4 s2048 d64): bitwise equal "
        "to the plain in-order sum")
    return worst


#: rms_norm parity shapes: the llama_1b and llama_125m norms, a ragged
#: one (37 rows, an f the 16-byte bf16 vector does not divide, wider than
#: the register tile), one row of the 1b norm (fewer rows than the
#: backward's blocks), a row wider than the register tile (the wide
#: kernels) and an odd f inside it (the single-element tile)
RMS_SHAPES = {"1b": (2048, 2048), "125m": (8192, 768), "ragged": (37, 4100),
              "one row": (1, 2048), "wide": (3, 8192), "odd": (9, 1001)}

#: rms_norm kernel vs plain: f32 max|diff| over max|plain| (sums in
#: another order); bf16 one bf16 ulp of the larger value, elementwise,
#: plus RMS_RTOL x max|plain| where the f32 value before the cast
#: carries a sum (dx, dw)
RMS_RTOL = 1e-5


def rms_err(torch, got, want, dtype, summed):
    """The worst |kernel - plain| over its tolerance (<= 1 passes), and
    the worst |kernel - plain|."""
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        return float("inf"), float("inf")
    diff = (got - want).abs()
    scale = want.abs().max().item()
    if dtype == torch.float32:
        tol = torch.full_like(diff, RMS_RTOL * scale)
    else:
        big = torch.maximum(got.abs(), want.abs()).clamp_min(2.0 ** -126)
        tol = torch.exp2(torch.floor(torch.log2(big)) - 7) + \
            (RMS_RTOL * scale if summed else 0.0)
    return (diff / tol.clamp_min(1e-30)).max().item(), diff.max().item()


def phase_rms_parity(torch):
    """rms_norm forward (y, rstd) and backward (dx, dw) kernels against
    their plain versions at f32, bf16, bf16 x with f32 w and f32 x with
    bf16 w, at the RMS_SHAPES; two backward launches give the same bits.
    Returns the worst |diff| per kernel."""
    from paddle_tpu_torch.kernels import rms_norm as trn
    worst = {"rms_norm_fwd": 0.0, "rms_norm_bwd": 0.0}
    for label, (rows, f) in RMS_SHAPES.items():
        for name, xdt, wdt in (("f32", torch.float32, torch.float32),
                               ("bf16", torch.bfloat16, torch.bfloat16),
                               ("bf16 x, f32 w", torch.bfloat16,
                                torch.float32),
                               ("f32 x, bf16 w", torch.float32,
                                torch.bfloat16)):
            g = torch.Generator(device="cuda").manual_seed(rows + f)
            x = torch.randn(rows, f, device="cuda", generator=g).to(xdt)
            w = (1 + 0.5 * torch.randn(f, device="cuda", generator=g)) \
                .to(wdt)
            dy = torch.randn(rows, f, device="cuda", generator=g).to(xdt)
            y, rstd = trn.rms_norm_fwd(x, w, 1e-5)
            dx, dw = trn.rms_norm_bwd(x, w, rstd, dy)
            dx2, dw2 = trn.rms_norm_bwd(x, w, rstd, dy)
            torch.cuda.synchronize()
            if not (torch.equal(dw, dw2) and torch.equal(dx, dx2)):
                raise AssertionError(f"rms_norm bwd {label} {name}: two "
                                     f"launches differ")
            py, prstd = trn.rms_norm_fwd_reference(x, w, 1e-5)
            pdx, pdw = trn.rms_norm_bwd_reference(x, w, rstd, dy)
            rel = ((rstd - prstd).abs() / prstd).max().item()
            checks = {"y": rms_err(torch, y, py, xdt, False),
                      "dx": rms_err(torch, dx, pdx, xdt, True),
                      "dw": rms_err(torch, dw, pdw, wdt, True)}
            bad = {k: v for k, v in checks.items() if not v[0] <= 1.0}
            if bad or not rel <= RMS_RTOL:
                raise AssertionError(f"rms_norm {label} {name}: over the "
                                     f"tolerance {bad}, rstd rel {rel}")
            worst["rms_norm_fwd"] = max(worst["rms_norm_fwd"],
                                        checks["y"][1])
            worst["rms_norm_bwd"] = max(worst["rms_norm_bwd"],
                                        checks["dx"][1], checks["dw"][1])
            log(f"[rms] {label} [{rows}, {f}] {name}: max|kernel - plain| "
                f"y {checks['y'][1]:.3e}, rstd rel {rel:.2e}, dx "
                f"{checks['dx'][1]:.3e}, dw {checks['dw'][1]:.3e} (worst "
                f"{max(c[0] for c in checks.values()):.2f} of the tolerance"
                f"); dx and dw bitwise equal over two launches")
    return worst


def phase_adamw_parity(torch):
    from paddle_tpu_torch.kernels import fused_adamw as tfw
    n = 1_000_003
    worst = 0.0
    for name, dtype in (("float32", torch.float32),
                        ("bfloat16", torch.bfloat16)):
        for wd, decoupled in ((0.01, True), (0.01, False)):
            for t in (1, 7):
                g = torch.Generator(device="cuda").manual_seed(t)
                p = torch.randn(n, device="cuda", generator=g).to(dtype)
                gr = (torch.randn(n, device="cuda", generator=g) * 1e-2) \
                    .to(dtype)
                m = torch.randn(n, device="cuda", generator=g) * 1e-3
                v = torch.rand(n, device="cuda", generator=g) * 1e-5
                sc = torch.tensor(tfw.adamw_scalars(1e-3, t, 0.9, 0.999),
                                  device="cuda")
                kw = dict(beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=wd,
                          decoupled=decoupled)
                got = [x.clone() for x in (p, m, v)]
                tfw.fused_adamw(got[0], gr, got[1], got[2], sc, **kw)
                torch.cuda.synchronize()
                want = [x.clone() for x in (p, m, v)]
                tfw.fused_adamw_reference(want[0], gr, want[1], want[2], sc,
                                          **kw)
                err = max((a.float() - b.float()).abs().max().item()
                          for a, b in zip(got, want))
                if err > ADAMW_ATOL:
                    raise AssertionError(f"fused_adamw {name} wd={wd} "
                                         f"decoupled={decoupled} t={t}: "
                                         f"{err}")
                worst = max(worst, err)
    log(f"[parity] fused_adamw bucket of {n} (f32 and bf16 params, AdamW "
        f"and coupled Adam, t = 1 and 7): max|kernel - plain| = "
        f"{worst:.3e} (atol {ADAMW_ATOL:g})")
    # a masked step: a span table over an odd-length bucket (absent
    # parameters between the spans), bitwise the plain masked version, the
    # absent elements byte-identical before and after
    n = 1_000_003
    spans = [(0, 7), (16, 40_001), (40_024, 3), (100_000, 600_000),
             (999_992, 11)]
    for name, dtype in (("float32", torch.float32),
                        ("bfloat16", torch.bfloat16)):
        g = torch.Generator(device="cuda").manual_seed(9)
        p = torch.randn(n, device="cuda", generator=g).to(dtype)
        gr = (torch.randn(n, device="cuda", generator=g) * 1e-2).to(dtype)
        m = torch.randn(n, device="cuda", generator=g) * 1e-3
        v = torch.rand(n, device="cuda", generator=g) * 1e-5
        table = tfw.span_table(spans, dtype, "cuda")
        sc = torch.tensor(tfw.adamw_scalars(1e-3, 4, 0.9, 0.999),
                          device="cuda")
        kw = dict(beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=0.01,
                  decoupled=True, spans=table)
        got = [x.clone() for x in (p, m, v)]
        tfw.fused_adamw(got[0], gr, got[1], got[2], sc, **kw)
        torch.cuda.synchronize()
        want = [x.clone() for x in (p, m, v)]
        tfw.fused_adamw_reference(want[0], gr, want[1], want[2], sc, **kw)
        mask = torch.zeros(n, dtype=torch.bool, device="cuda")
        for a, ln in spans:
            mask[a:a + ln] = True
        if not all(torch.equal(a, b) for a, b in zip(got, want)) or not all(
                torch.equal(a[~mask], b[~mask])
                for a, b in zip(got, (p, m, v))):
            raise AssertionError(f"fused_adamw masked {name}: not bitwise the "
                                 f"plain masked version, or an absent span "
                                 f"moved")
    log(f"[parity] fused_adamw masked step: {len(spans)} present spans of an "
        f"odd bucket of {n} (f32 and bf16 params): bitwise the plain masked "
        f"version; the absent elements' values and moments byte-identical")
    return worst


def phase_train_parity(torch):
    """3 TrainSteps of a small f32 Llama on the card and on the CPU, then
    3 more with ``remat=True`` and ``accumulate_steps=2``: the losses
    agree to 1e-4 relative (f32 sums in another order, and AdamW may move
    entries whose gradient is within rounding of zero the other way, by
    lr each). The accumulated run's launches are counted on the card."""
    import dataclasses
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.kernels import LAUNCHES, reset_launch_counts
    base = pt.llama_tiny_config(num_hidden_layers=2, hidden_size=256,
                                intermediate_size=512, num_attention_heads=4,
                                num_key_value_heads=2, vocab_size=512,
                                loss_chunk_size=100)
    ids = np.random.RandomState(3).randint(0, base.vocab_size, (2, 96))
    for label, cfg, micro in (
            ("", base, 1),
            (" with remat and accumulate_steps=2",
             dataclasses.replace(base, remat=True), 2)):
        losses = {}
        for dev in ("cpu", "cuda"):
            model = pt.LlamaForCausalLM(
                cfg, device="cpu", generator=torch.Generator().manual_seed(3))
            model.to(dev)
            opt = pt.AdamW(learning_rate=1e-3, parameters=model.parameters())
            step = pt.TrainStep(model, lambda x: model(x, labels=x)[1], opt,
                                accumulate_steps=micro)
            x = torch.from_numpy(ids).to(dev)
            reset_launch_counts()
            losses[dev] = [step(x).item() for _ in range(3)]
            launches = dict(LAUNCHES)
        want = expected_train_launches(cfg, 3, 1, micro)
        bad = {k: (launches[k], n) for k, n in want.items()
               if launches[k] != n}
        if bad:
            raise AssertionError(f"small Llama{label}: launches (got, want) "
                                 f"{bad}")
        np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-4)
        if not losses["cuda"][-1] < losses["cuda"][0]:
            raise AssertionError(f"small Llama{label}: loss did not fall: "
                                 f"{losses}")
        log(f"[train] small f32 Llama{label}, 3 TrainSteps: losses on cuda "
            f"{losses['cuda']} vs cpu {losses['cpu']} (rtol 1e-4)")
    phase_train_masked(torch)


def phase_train_masked(torch):
    """A small f32 Llama on the card and on the CPU, 3 TrainSteps: one
    weight frozen after the optimizer's build, the final norm's weight
    left out of one step's graph (no gradient): both keep their values
    and moments on the steps they sit out, bitwise on each device; the
    losses agree to 1e-4 relative and the parameters within 2 lr per
    step (Adam moves an entry by about lr whatever its gradient, so an
    entry whose gradient is within rounding of zero may step the other
    way on the other device: the bound of tests/test_torch_train.py);
    one AdamW launch per step."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.kernels import LAUNCHES, reset_launch_counts
    cfg = pt.llama_tiny_config(num_hidden_layers=2, hidden_size=256,
                               intermediate_size=512, num_attention_heads=4,
                               num_key_value_heads=2, vocab_size=256,
                               loss_chunk_size=64)
    ids = np.random.RandomState(4).randint(0, cfg.vocab_size, (2, 32))
    out = {}
    for dev in ("cpu", "cuda"):
        model = pt.LlamaForCausalLM(
            cfg, device="cpu", generator=torch.Generator().manual_seed(4))
        model.to(dev)
        opt = pt.AdamW(learning_rate=1e-3, parameters=model.parameters())
        frozen = model.model.layers[0].mlp.down_proj.weight
        frozen.requires_grad_(False)
        absent = model.model.norm.weight
        x = torch.from_numpy(ids).to(dev)

        def loss_fn(x, skip_norm):
            # out of the graph for one step: the final norm's weight gets
            # no gradient then
            absent.requires_grad_(not skip_norm)
            return model(x, labels=x)[1]
        step = pt.TrainStep(model, loss_fn, opt)
        reset_launch_counts()
        losses = []
        for i in range(3):
            keep = [t.detach().clone() for t in (frozen, absent)]
            views = opt._fused_engine.state_views()
            moms = [views[(absent, k)].clone() for k in ("moment1",
                                                         "moment2")]
            losses.append(step(x, i == 1).item())
            if not torch.equal(keep[0], frozen.detach()):
                raise AssertionError(f"{dev}: a frozen weight moved")
            if i == 1 and not (torch.equal(keep[1], absent.detach()) and all(
                    torch.equal(a, opt._fused_engine.state_views()[
                        (absent, k)]) for a, k in zip(moms, ("moment1",
                                                            "moment2")))):
                raise AssertionError(f"{dev}: a parameter without a gradient "
                                     f"moved or its moments did")
        if dev == "cuda" and LAUNCHES["fused_adamw"] != 3:
            raise AssertionError(f"fused_adamw launches "
                                 f"{LAUNCHES['fused_adamw']}, want 3")
        out[dev] = ({k: v.detach().cpu()
                     for k, v in model.named_parameters()}, losses)
    np.testing.assert_allclose(out["cuda"][1], out["cpu"][1], rtol=1e-4)
    worst = max((out["cuda"][0][k] - out["cpu"][0][k]).abs().max().item()
                for k in out["cpu"][0])
    if worst > 2 * 1e-3 * 3 + 1e-6:
        raise AssertionError(f"masked TrainSteps: card vs cpu {worst}")
    log(f"[train] small f32 Llama, 3 TrainSteps with a weight frozen after "
        f"the build and the final norm's weight without a gradient on step "
        f"2: both held bitwise where absent, on both devices; losses on "
        f"cuda {out['cuda'][1]} vs cpu {out['cpu'][1]} (rtol 1e-4), "
        f"parameters max|diff| {worst:.3e} (<= 2 lr x 3 steps); 3 fused_adamw "
        f"launches")


#: decode steps of the 7B run traced by torch.profiler
PROFILED_STEPS = 4


def is_gemm(name):
    return any(w in name.lower() for w in ("gemm", "cutlass", "xmma", "nvjet"))


def report_profile(torch, prof, step_s, label, categories):
    """Where a traced window's time went: device busy time by kernel
    (``torch.profiler``'s CUDA events) against the host clock, split by
    ``categories`` ({name: predicate on the kernel name}). Returns the
    per-step numbers in ms (None when the profiler saw no device time)."""
    from torch.autograd import DeviceType

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    n = len(step_s)
    wall_ms = 1e3 * sum(step_s) / n
    busy_ms = sum(dev_us(e) for e in kernels) / 1e3 / n
    if busy_ms == 0:
        log(f"[profile] torch.profiler saw no device time over {n} steps")
        return None
    out = {"host_ms": wall_ms, "busy_ms": busy_ms,
           "idle_share": 1 - busy_ms / wall_ms}
    for cat, pred in categories.items():
        out[cat] = sum(dev_us(e) for e in kernels if pred(e.key)) / 1e3 / n
    out["other"] = busy_ms - sum(out[c] for c in categories)
    log(f"[profile] {label}: host {wall_ms:.2f} ms/step, device busy "
        f"{busy_ms:.2f} ms/step (idle {100 * out['idle_share']:.1f}%): "
        + ", ".join(f"{c} {out[c]:.2f}" for c in (*categories, "other"))
        + " ms/step")
    top = sorted(kernels, key=dev_us, reverse=True)[:10]
    for e in top:
        log(f"[profile]   {dev_us(e) / 1e3 / n:8.3f} ms/step "
            f"{e.count // n:5d} launches/step  {e.key[:90]}")
    return out


#: the 7B load: prompt lengths, 32 new tokens each, the sampled rows
SERVE_LENS = [17, 96, 600, 233, 410, 512, 350]
SERVE_SAMPLED = {3, 6}

#: the ragged kernel's merge launches once per attention call at the 7B
#: step (T = 128 over 64-page tables: 2 splits)
MERGE = {"ragged_paged_attention_merge": 1}

#: the low-bit runs of phase [7b-q]: engine knobs, and the launches each
#: makes per ragged step per layer (every other count must stay 0)
LOW_BIT_RUNS = {
    "w8_kv8": (dict(quantized_mode="weight_only_int8", kv_cache_dtype="int8"),
               {"int8_matmul": 7, "ragged_paged_attention_int8": 1, **MERGE}),
    "w4_kv8": (dict(quantized_mode="weight_only_int4", kv_cache_dtype="int8"),
               {"int4_matmul": 7, "ragged_paged_attention_int8": 1, **MERGE}),
    "w8": (dict(quantized_mode="weight_only_int8"),
           {"int8_matmul": 7, "ragged_paged_attention": 1, **MERGE}),
}


def build_7b(torch):
    import paddle_tpu_torch as pt
    cfg = pt.llama2_7b_config()
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = pt.LlamaForCausalLM(cfg, device="cuda", dtype=torch.bfloat16,
                                generator=gen)
    torch.cuda.synchronize()
    log(f"[7b] Llama-2-7B bf16 ({cfg.num_hidden_layers} layers) built in "
        f"{time.perf_counter() - t0:.1f} s (set-up)")
    return model


def serve_prompts(V):
    """The 7B load's prompts (``SERVE_LENS`` tokens; the 2nd, 200 tokens,
    opens with a 128-token prefix) and the late request (145 tokens: the
    same prefix, so it forks the 2nd's pages)."""
    rng = np.random.RandomState(0)
    prefix = rng.randint(0, V, (128,)).tolist()
    prompts = [rng.randint(0, V, (n,)).tolist() for n in SERVE_LENS]
    prompts[1] = prefix + prompts[1][:72]
    late = prefix + rng.randint(0, V, (17,)).tolist()
    return prompts, late


def serve_7b(torch, model, tag, per_step, **knobs):
    """Serve the 8-request 7B load through ``LLMEngine(**knobs)``, the
    launch counts reset just before the load and read just after; every
    request must finish and every count must be ``per_step[name]`` x
    layers x ragged steps (0 for kernels not named). Traces 4 decode
    steps. Returns the run's numbers and tokens."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.kernels import LAUNCHES, reset_launch_counts
    cfg = model.config
    t0 = time.perf_counter()
    eng = pt.LLMEngine(model, max_len=1024, page_size=16, max_num_seqs=8,
                       **knobs)
    torch.cuda.synchronize()
    log(f"[{tag}] engine {knobs or 'bf16'} + pool of {eng.pool.num_pages} "
        f"{str(eng.pool.dtype).replace('torch.', '')} pages built in "
        f"{time.perf_counter() - t0:.1f} s (set-up)")
    V = cfg.vocab_size
    prompts, late = serve_prompts(V)
    plans = []
    orig = eng.scheduler.prepare_step

    def prepare_step():
        plan = orig()
        if plan is not None:
            plans.append(sum(q for s, _, q in plan.rows
                             if s.cached_len < len(s.prompt_ids)))
        return plan

    eng.scheduler.prepare_step = prepare_step
    rids = []
    for i, p in enumerate(prompts):
        kw = dict(temperature=0.8, top_k=50, seed=100 + i) \
            if i in SERVE_SAMPLED else {}
        rids.append(eng.add_request(p, max_new_tokens=32, **kw))
    categories = {"ragged attention": lambda k: "ragged_kernel" in k,
                  "prefill megakernel": lambda k: "prefill_megakernel" in k,
                  "dequant matmul": lambda k: "dequant_matmul" in k,
                  "matmuls": is_gemm}
    reset_launch_counts()
    step_s, step_tok = [], []
    prof, profiled, breakdown = None, [], None
    while eng.has_unfinished():
        if len(rids) == len(prompts) and eng.outputs()[rids[1]].token_ids:
            rids.append(eng.add_request(late, max_new_tokens=32))
        if prof is None and not profiled and len(rids) > len(prompts) \
                and plans and plans[-1] == 0:
            # once every prompt is in, trace a few decode steps
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            prof.start()
        tok0 = eng.metrics.tokens_generated.value
        t = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
        step_tok.append(eng.metrics.tokens_generated.value - tok0)
        if prof is not None:
            profiled.append(len(step_s) - 1)
            if len(profiled) == PROFILED_STEPS or not eng.has_unfinished():
                prof.stop()
                breakdown = report_profile(
                    torch, prof, [step_s[i] for i in profiled],
                    f"{tag}: {len(profiled)} traced 7B steps (prefill "
                    f"tokens {[plans[i] for i in profiled]})", categories)
                prof = None
        if len(step_s) > 2000:
            raise AssertionError(f"[{tag}] the 7B load did not drain in "
                                 f"2000 steps")
    launches = dict(LAUNCHES)
    snap = eng.metrics_snapshot()
    outs = eng.outputs()
    eng.pool.check_invariants()
    steps = snap["decode_steps"]
    for r in rids:
        o = outs[r]
        if o.status != "finished" or len(o.token_ids) != 32 or \
                not all(0 <= t < V for t in o.token_ids):
            raise AssertionError(f"[{tag}] {r}: {o}")
    if snap["prefix_cache_hits"] < 1:
        raise AssertionError(f"[{tag}] the shared-prefix request did not "
                             f"fork")
    layers = cfg.num_hidden_layers
    want = {k: per_step.get(k, 0) * layers * steps for k in launches}
    if launches != want:
        raise AssertionError(f"[{tag}] kernel launches {launches} != {want} "
                             f"(per layer and ragged step {per_step}, "
                             f"{layers} layers x {steps} steps)")
    # traced steps pay the profiler's cost: they stay out of the means
    timed = [(n, s, k) for i, (n, s, k) in enumerate(zip(plans, step_s,
                                                            step_tok))
             if i not in profiled]
    pre = [(n, s) for n, s, _ in timed if n > 0]
    dec = [s for n, s, _ in timed if n == 0]
    dec_tok = sum(k for n, _, k in timed if n == 0)
    ms_tok = 1e3 * sum(dec) / max(dec_tok, 1)
    pre_tok = sum(n for n, _ in pre)
    pre_s = sum(s for _, s in pre)
    decode_ms = 1e3 * sum(dec) / max(len(dec), 1)
    log(f"[{tag}] served {len(rids)} requests (prompts 17-600 tokens, 32 "
        f"new tokens each, 2 sampled at T=0.8 top_k=50, 1 prefix fork): "
        f"{steps} ragged steps, {snap['prefix_cache_hits']} prefix hits, "
        f"{snap['preemptions']} preemptions")
    log(f"[{tag}] prefill: {pre_tok} prompt tokens in {len(pre)} steps "
        f"(decode rows riding along), {pre_s:.3f} s -> "
        f"{pre_tok / pre_s:.1f} prefill tokens/s; decode: {len(dec)} steps, "
        f"{decode_ms:.2f} ms/step, {ms_tok:.3f} ms per generated token "
        f"(host clock, synchronised per step, {len(profiled)} traced steps "
        f"left out)")
    per_run = {k: v for k, v in launches.items() if v}
    log(f"[{tag}] kernel launches {per_run} = {per_step} x {layers} layers "
        f"x {steps} steps")
    p = eng.params
    read = snap["weight_bytes"] - p["embed"].numel() * p["embed"].element_size()
    log(f"[{tag}] weight_bytes {snap['weight_bytes']} "
        f"({snap['weight_bytes'] / 1e9:.2f} GB; a step reads all but the "
        f"embedding table, {read / 1e9:.2f} GB, bound "
        f"{1e3 * read / HBM_BYTES_PER_S:.2f} ms), kv_bytes_per_token "
        f"{snap['kv_bytes_per_token']}")
    tokens = [outs[r].token_ids for r in rids]
    del eng
    torch.cuda.empty_cache()
    return dict(launches=launches, steps=steps, decode_ms=decode_ms,
                decode_ms_per_token=ms_tok,
                prefill_tok_s=pre_tok / pre_s, profile=breakdown,
                weight_bytes=snap["weight_bytes"], read_bytes=read,
                kv_bytes_per_token=snap["kv_bytes_per_token"],
                tokens=tokens, greedy=[i for i in range(len(rids))
                                       if i not in SERVE_SAMPLED])


def phase_serve_7b_lowbit(torch, model, bf16):
    """Phase [7b-q]: the same load with int8/int4 projections and an
    int8 pool, each quantized from the bf16 model on the card. The share
    of greedy tokens equal to the bf16 run's is informational
    (quantized outputs differ by design)."""
    runs = {}
    for tag, (knobs, per_step) in LOW_BIT_RUNS.items():
        run = serve_7b(torch, model, f"7b-q {tag}", per_step, **knobs)
        same = total = 0
        for i in bf16["greedy"]:
            for a, b in zip(run["tokens"][i], bf16["tokens"][i]):
                same += a == b
                total += 1
        run["bf16_token_share"] = same / total
        log(f"[7b-q {tag}] greedy tokens equal to the bf16 run's: {same} of "
            f"{total} ({100 * same / total:.1f}%, informational)")
        runs[tag] = run
    return runs


def expected_train_launches(cfg, steps, buckets, micro=1, bf16=False):
    """Launches per kernel over ``steps`` TrainSteps of a Llama with L
    layers, each step ``micro`` forward and backward passes. Forward: 2
    norms per layer and the final one, one attention per layer; under
    remat every layer runs its forward again in backward (2 norms, 1
    attention). Backward: each norm and attention once, and with GQA in
    bf16 one dk/dv group sum per attention. One fused AdamW launch per
    bucket and step."""
    L = cfg.num_hidden_layers
    replay = 2 if cfg.remat else 1
    passes = steps * micro
    grouped = bf16 and cfg.num_key_value_heads != cfg.num_attention_heads
    return {"rms_norm_fwd": passes * (2 * L * replay + 1),
            "rms_norm_bwd": passes * (2 * L + 1),
            "flash_attention_fwd": passes * L * replay,
            "flash_attention_bwd_dq": passes * L,
            "flash_attention_bwd_dkv": passes * L,
            "flash_attention_bwd_dkv_sum": passes * L if grouped else 0,
            "fused_adamw": steps * buckets}


#: the rms_norm kernels of csrc/rms_norm.cu: forward (tile, wide),
#: backward (tile, wide) and the dw sum in chunk order
RMS_KERNEL = re.compile(r"\brms_(?:fwd|bwd|dw)_\w*kernel")


def is_rms(name):
    return RMS_KERNEL.search(name) is not None


def train_run(torch, tag, cfg, batch, seq):
    """Full-width training through TrainStep (AdamW 1e-4, auto_cast O1
    bf16): 2 warm steps, 10 timed steps with the launch counts reset
    before them, 2 traced steps."""
    import gc
    import math
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.kernels import LAUNCHES, reset_launch_counts
    # an optimizer and its fused engine point at each other: an earlier
    # phase's model is freed by the collector, not when its names go
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = pt.LlamaForCausalLM(
        cfg, device="cuda", generator=torch.Generator(device="cuda")
        .manual_seed(0))
    opt = pt.AdamW(learning_rate=1e-4, parameters=model.parameters())
    buckets = len(opt._fused_engine.buckets)
    n_params = sum(p.numel() for p in model.parameters())

    def loss_fn(ids):
        with pt.auto_cast(level="O1", dtype="bfloat16"):
            return model(ids, labels=ids)[1]

    step = pt.TrainStep(model, loss_fn, opt)
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (batch, seq))).to("cuda")
    # the initial weights, for phase [graphs]'s runs from the same state
    init = [b.flat_p.clone() for b in opt._fused_engine.buckets]
    torch.cuda.synchronize()
    log(f"[{tag}] {n_params / 1e6:.1f} M parameters, {buckets} f32 bucket, "
        f"{cfg.num_hidden_layers} layers, remat {cfg.remat}: built in "
        f"{time.perf_counter() - t0:.1f} s (set-up)")
    losses = [step(ids) for _ in range(WARM_STEPS)]
    torch.cuda.synchronize()
    reset_launch_counts()
    t = time.perf_counter()
    for _ in range(TIMED_STEPS):
        losses.append(step(ids))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t
    launches = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])
    traced = []
    with prof:
        for _ in range(TRACED_STEPS):
            t1 = time.perf_counter()
            step(ids)
            torch.cuda.synchronize()
            traced.append(time.perf_counter() - t1)
    breakdown = report_profile(
        torch, prof, traced, f"{TRACED_STEPS} traced {tag} steps",
        {"flash attention": lambda k: "flash_" in k, "matmuls": is_gemm,
         "fused AdamW": lambda k: "fused_adamw_kernel" in k,
         "rms_norm": is_rms})
    losses = [x.item() for x in losses]
    want = expected_train_launches(cfg, TIMED_STEPS, buckets, bf16=True)
    for k, n in want.items():
        if launches[k] != n:
            raise AssertionError(f"[{tag}] {k}: {launches[k]} launches over "
                                 f"{TIMED_STEPS} steps, want {n}")
    ln_v = math.log(cfg.vocab_size)
    if not all(math.isfinite(x) for x in losses) or \
            abs(losses[0] - ln_v) > 0.5 or not losses[-1] < losses[0]:
        raise AssertionError(f"[{tag}] losses {losses} (ln V = {ln_v})")
    tokens = batch * seq
    tok_s = tokens * TIMED_STEPS / dt
    fpt = model.flops_per_token(seq)
    mfu = tok_s * fpt / BF16_FLOPS
    log(f"[{tag}] losses {[round(x, 4) for x in losses]} (ln "
        f"{cfg.vocab_size} = {ln_v:.4f})")
    log(f"[{tag}] {TIMED_STEPS} timed steps of {batch} x {seq} tokens: "
        f"{1e3 * dt / TIMED_STEPS:.2f} ms/step, {tok_s:.1f} tokens/s, MFU "
        f"{100 * mfu:.2f}% of the dense bf16 peak ({fpt / 1e9:.3f} "
        f"GFLOP/token{', remat term included' if cfg.remat else ''}), peak "
        f"memory {peak / 2 ** 30:.2f} GiB (host clock, synchronised at the "
        f"ends)")
    log(f"[{tag}] launches over the timed steps {launches}")
    run = dict(launches=launches, n_params=n_params, buckets=buckets,
               ms_per_step=1e3 * dt / TIMED_STEPS, tokens_per_s=tok_s,
               mfu=mfu, flops_per_token=fpt, peak_bytes=peak, losses=losses,
               profile=breakdown, graphs=graph_stats(step.graphs))
    check_graph_calls(tag, run["graphs"])
    del step
    run["graph_run"] = train_graphs(torch, tag, model, opt, loss_fn, ids,
                                    init, run)
    return run


GRAPH_TRAIN_STEPS, GRAPH_EAGER_TIMED = 3, 5


def train_graphs(torch, tag, model, opt, loss_fn, ids, init, captured):
    """Phase [graphs], training: the step run eagerly
    (``jit.enable_to_static(False)``: 2 warm, ``GRAPH_EAGER_TIMED`` timed
    and 2 traced steps) beside the captured numbers of :func:`train_run`;
    then ``GRAPH_TRAIN_STEPS`` eager and as many captured steps, each
    from the initial weights and zero moments: losses, every parameter
    and both AdamW moments bitwise equal."""
    import gc
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import jit
    from paddle_tpu_torch.kernels import LAUNCHES, reset_launch_counts
    eng = opt._fused_engine

    def restore():
        for b, p0 in zip(eng.buckets, init):
            b.flat_p.copy_(p0)
            for m in b.state.values():
                m.zero_()
        opt._step_count = 0

    jit.enable_to_static(False)
    try:
        step = pt.TrainStep(model, loss_fn, opt)
        for _ in range(WARM_STEPS):
            step(ids)
        torch.cuda.synchronize()
        reset_launch_counts()
        t = time.perf_counter()
        for _ in range(GRAPH_EAGER_TIMED):
            step(ids)
        torch.cuda.synchronize()
        eager_ms = 1e3 * (time.perf_counter() - t) / GRAPH_EAGER_TIMED
        per_step = {k: v / GRAPH_EAGER_TIMED for k, v in LAUNCHES.items()}
        prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
        traced = []
        with prof:
            for _ in range(TRACED_STEPS):
                t1 = time.perf_counter()
                step(ids)
                torch.cuda.synchronize()
                traced.append(time.perf_counter() - t1)
        eager_profile = report_profile(
            torch, prof, traced, f"graphs {tag} eager: {TRACED_STEPS} traced "
            f"steps", {"matmuls": is_gemm})
        restore()
        want = [step(ids) for _ in range(GRAPH_TRAIN_STEPS)]
        want_state = [(b.flat_p.clone(), [m.clone() for m in
                                          b.state.values()])
                      for b in eng.buckets]
    finally:
        jit.enable_to_static(True)
    del step
    gc.collect()
    restore()
    step = pt.TrainStep(model, loss_fn, opt)
    got = [step(ids) for _ in range(GRAPH_TRAIN_STEPS)]
    torch.cuda.synchronize()
    same_loss = [a.item() for a in got] == [b.item() for b in want]
    same_state = all(torch.equal(b.flat_p, p) and all(
        torch.equal(m, w) for m, w in zip(b.state.values(), ms))
        for b, (p, ms) in zip(eng.buckets, want_state))
    cap_step = {k: v / TIMED_STEPS for k, v in captured["launches"].items()}
    if not (same_loss and same_state) or cap_step != per_step:
        raise AssertionError(
            f"[graphs {tag}] captured != eager after {GRAPH_TRAIN_STEPS} "
            f"steps: losses {[a.item() for a in got]} vs "
            f"{[b.item() for b in want]}, parameters and moments "
            f"{same_state}; launches per step {cap_step} vs {per_step}")
    stats = graph_stats(step.graphs)
    check_graph_calls(tag, stats)
    cap_prof = captured["profile"]
    nonzero = {k: v for k, v in per_step.items() if v}
    busy = [f"{p['busy_ms']:.2f}" if p else "not measured"
            for p in (eager_profile, cap_prof)]
    log(f"[graphs {tag}] bitwise equal after {GRAPH_TRAIN_STEPS} steps from "
        f"the same weights: losses, every parameter and both moments; "
        f"launches per step equal ({nonzero}); host {eager_ms:.2f} -> "
        f"{captured['ms_per_step']:.2f} ms/step, busy {busy[0]} -> "
        f"{busy[1]} ms/step (eager -> captured); {stats['keys']} key, capture "
        f"{list(captured['graphs']['capture_ms'].values())} ms, graph pool "
        f"{captured['graphs']['pool_bytes']} bytes")
    del step, want_state
    return dict(eager_ms=eager_ms, eager_profile=eager_profile,
                captured_ms=captured["ms_per_step"], captured_profile=cap_prof,
                launches_per_step=per_step, graphs=captured["graphs"])


def phase_train_125m(torch):
    """llama_125m exactly as bench.py:205-209, batch 8 x 1024."""
    import paddle_tpu_torch as pt
    return train_run(torch, "125m", pt.LlamaConfig(**TRAIN_125M),
                     TRAIN_BATCH, TRAIN_SEQ)


def phase_train_1b(torch):
    """llama_1b exactly as bench.py:182-188 (the TinyLlama-1.1B shape,
    tied embeddings, remat), batch 1 x 2048."""
    import paddle_tpu_torch as pt
    return train_run(torch, "1b", pt.LlamaConfig(**TRAIN_1B), *TRAIN_1B_BATCH)


def bound_ms(nbytes, flops, peak=BF16_FLOPS):
    """(least ms, "bytes" | "operations") at the HBM rate and ``peak``
    FLOP/s (the dense bf16 peak unless named)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, \
        ("bytes" if t_bytes >= t_ops else "operations")


#: the flash kernels' main-path shapes: (b, hq, hkv, s, d), bf16, causal
FLASH_TIME_SHAPES = {"125m": (TRAIN_BATCH, 12, 12, TRAIN_SEQ, 64),
                     "1b": (*TRAIN_1B_BATCH[:1], 32, 4, TRAIN_1B_BATCH[1], 64)}


def sdpa_calls(torch, q, k, v, do):
    """``F.scaled_dot_product_attention`` forward and backward on the
    same tensors (``enable_gqa`` when hq != hkv; where the installed
    torch lacks it, on K/V expanded by ``repeat_interleave`` beforehand,
    outside the timed call)."""
    import torch.nn.functional as F
    group = q.shape[1] // k.shape[1]
    kw = {}
    if group > 1:
        try:
            F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                           enable_gqa=True)
            kw = dict(enable_gqa=True)
        except TypeError:
            log("[time]   this torch's SDPA lacks enable_gqa: K/V expanded "
                "by repeat_interleave before the timed calls")
            k, v = (x.repeat_interleave(group, 1) for x in (k, v))
    qs, ks, vs = (x.detach().requires_grad_() for x in (q, k, v))
    so = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True, **kw)
    return (lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                   **kw),
            lambda: torch.autograd.grad(so, (qs, ks, vs), do,
                                        retain_graph=True))


def time_flash_shape(torch, tag, b, hq, hkv, s, d):
    """The flash launches at one main-path shape (bf16, causal): each
    held against the plain version, timed beside its bound (dense bf16
    peak, HBM rate) and achieved TFLOP/s, the plain version and SDPA.
    The dk/dv time includes its group sum where there is one, which is
    also timed alone."""
    from paddle_tpu_torch.kernels import flash_attention as tfa
    q, k, v, do = _flash_case(torch, b, hq, hkv, s, s, d, torch.bfloat16, 11)
    scale = d ** -0.5
    out, lse = tfa.flash_attention_fwd(q, k, v, True, scale)
    delta = (do.float() * out.float()).sum(-1).contiguous()
    dq = tfa.flash_attention_bwd_dq(q, k, v, do, lse, delta, True, scale)
    dk, dv = tfa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, True,
                                         scale)
    qr, kr, vr = (x.detach().requires_grad_() for x in (q, k, v))
    ref, _ = tfa.flash_attention_reference(qr, kr, vr, True)
    rq, rk, rv = torch.autograd.grad(ref, (qr, kr, vr), do,
                                     retain_graph=True)
    err = {"fwd": (out.float() - ref.float()).abs().max().item(),
           "dq": (dq.float() - rq.float()).abs().max().item(),
           "dkv": max((dk.float() - rk.float()).abs().max().item(),
                      (dv.float() - rv.float()).abs().max().item())}
    for key, want in {"fwd": ref, "dq": rq, "dkv": rk}.items():
        if err[key] > FLASH_RTOL["bfloat16"] * max(
                1.0, want.float().abs().max().item()):
            raise AssertionError(f"flash {key} at the {tag} shape: {err}")
    pairs = b * hq * s * (s + 1) // 2         # visible (query, key) pairs
    io_q = b * hq * s * d * 2                 # one bf16 [b, hq, s, d]
    io_kv = b * hkv * s * d * 2               # one bf16 [b, hkv, s, d]
    stats = b * hq * s * 4                    # one f32 [b, hq, s]
    flops = {"fwd": 4 * pairs * d, "dq": 6 * pairs * d, "dkv": 8 * pairs * d}
    bounds = {"fwd": bound_ms(2 * io_q + 2 * io_kv + stats, flops["fwd"]),
              "dq": bound_ms(3 * io_q + 2 * io_kv + 2 * stats, flops["dq"]),
              "dkv": bound_ms(2 * io_q + 4 * io_kv + 2 * stats,
                              flops["dkv"])}
    ms = {"fwd": time_ms(torch, lambda: tfa.flash_attention_fwd(
              q, k, v, True, scale), 50),
          "dq": time_ms(torch, lambda: tfa.flash_attention_bwd_dq(
              q, k, v, do, lse, delta, True, scale), 50),
          "dkv": time_ms(torch, lambda: tfa.flash_attention_bwd_dkv(
              q, k, v, do, lse, delta, True, scale), 50)}
    rows = {key: dict(ms=ms[key], bound_ms=bounds[key][0],
                      bound_by=bounds[key][1], max_abs_err=err[key],
                      tflops=flops[key] / ms[key] / 1e9)
            for key in ms}
    if hq != hkv:
        part = torch.randn(2, b, hq, s, d, device="cuda")
        got = tfa.flash_attention_bwd_dkv_sum(part, k, v)
        want = tfa.flash_attention_bwd_dkv_sum_reference(part, k, v)
        sum_err = max((a.float() - w.float()).abs().max().item()
                      for a, w in zip(got, want))
        sum_ms = time_ms(torch, lambda: tfa.flash_attention_bwd_dkv_sum(
            part, k, v), 50)
        sum_plain = time_ms(torch, lambda: tfa
                            .flash_attention_bwd_dkv_sum_reference(
                                part, k, v), 10, "group sum plain")
        sb = bound_ms(part.numel() * 4 + 2 * io_kv, part.numel())
        rows["sum"] = dict(ms=sum_ms, bound_ms=sb[0], bound_by=sb[1],
                           max_abs_err=sum_err, plain_ms=sum_plain,
                           tflops=part.numel() / sum_ms / 1e9)
    plain_fwd = time_ms(torch, lambda: tfa.flash_attention_reference(
        q, k, v, True, scale), 10, "flash plain forward", waits_ok=True)
    plain_bwd = time_ms(torch, lambda: torch.autograd.grad(
        ref, (qr, kr, vr), do, retain_graph=True), 10,
        "flash plain backward", waits_ok=True)
    sdpa_f, sdpa_b = sdpa_calls(torch, q, k, v, do)
    sdpa_fwd = time_ms(torch, sdpa_f, 50, "SDPA forward")
    sdpa_bwd = time_ms(torch, sdpa_b, 50, "SDPA backward")
    bwd_ms = ms["dq"] + ms["dkv"]
    log(f"[time] flash attention at the {tag} step shape (b {b}, hq {hq}, "
        f"hkv {hkv}, s {s}, d {d}, bf16, causal): "
        + "; ".join(f"{key} {r['ms']:.4f} ms (bound {r['bound_ms']:.4f}, "
                    f"{r['bound_by']}; {r['tflops']:.1f} TFLOP/s)"
                    for key, r in rows.items())
        + f"; dq + dk/dv {bwd_ms:.4f} ms; plain fwd {plain_fwd:.4f}, plain "
        f"bwd {plain_bwd:.4f}; SDPA fwd {sdpa_fwd:.4f}, SDPA bwd "
        f"{sdpa_bwd:.4f} ms (flash/SDPA: fwd {ms['fwd'] / sdpa_fwd:.2f}x, "
        f"bwd {bwd_ms / sdpa_bwd:.2f}x); max|diff| {err}")
    return rows, dict(plain_fwd=plain_fwd, plain_bwd=plain_bwd,
                      sdpa_fwd=sdpa_fwd, sdpa_bwd=sdpa_bwd)


def phase_time_flash(torch):
    """The flash kernels at the llama_125m and llama_1b step shapes."""
    return {tag: time_flash_shape(torch, tag, *shape)
            for tag, shape in FLASH_TIME_SHAPES.items()}


def phase_time_rms(torch):
    """Rows 6-7 at the llama_1b and llama_125m norm shapes (f32, the
    residual stream's dtype): each kernel through its own wrapper beside
    its bytes bound, its plain version and torch.nn.functional.rms_norm
    (forward; backward through autograd)."""
    import torch.nn.functional as F
    from paddle_tpu_torch.kernels import rms_norm as trn
    out = {}
    for label, (rows, f) in (("1b", RMS_SHAPES["1b"]),
                             ("125m", RMS_SHAPES["125m"])):
        g = torch.Generator(device="cuda").manual_seed(9)
        x = torch.randn(rows, f, device="cuda", generator=g)
        w = 1 + 0.5 * torch.randn(f, device="cuda", generator=g)
        dy = torch.randn(rows, f, device="cuda", generator=g)
        eps = 1e-5
        y, rstd = trn.rms_norm_fwd(x, w, eps)
        dx, dw = trn.rms_norm_bwd(x, w, rstd, dy)
        py, _ = trn.rms_norm_fwd_reference(x, w, eps)
        pdx, pdw = trn.rms_norm_bwd_reference(x, w, rstd, dy)
        err = {}
        for key, pairs in (("fwd", ((y, py),)),
                           ("bwd", ((dx, pdx), (dw, pdw)))):
            for got, want in pairs:
                e = (got - want).abs().max().item()
                if not e <= RMS_RTOL * want.abs().max().item():
                    raise AssertionError(f"rms_norm {key} at the {label} "
                                         f"shape: max|diff| {e}")
                err[key] = max(err.get(key, 0.0), e)
        n = rows * f
        # bytes: each input read once, each output written once (f32);
        # operations: 4 per element forward, 12 backward (dx and dw)
        nbytes = {"fwd": 4 * (2 * n + f + rows),
                  "bwd": 4 * (3 * n + 2 * f + rows)}
        bounds = {"fwd": bound_ms(nbytes["fwd"], 4 * n, F32_FLOPS),
                  "bwd": bound_ms(nbytes["bwd"], 12 * n, F32_FLOPS)}
        xr = x.detach().requires_grad_()
        wr = w.detach().requires_grad_()
        lib_out = F.rms_norm(xr, (f,), wr, eps)
        row = {}
        for key, kern, plain, lib in (
                ("fwd", lambda: trn.rms_norm_fwd(x, w, eps),
                 lambda: trn.rms_norm_fwd_reference(x, w, eps),
                 lambda: F.rms_norm(x, (f,), w, eps)),
                ("bwd", lambda: trn.rms_norm_bwd(x, w, rstd, dy),
                 lambda: trn.rms_norm_bwd_reference(x, w, rstd, dy),
                 lambda: torch.autograd.grad(lib_out, (xr, wr), dy,
                                             retain_graph=True))):
            row[key] = dict(
                ms=time_ms(torch, kern, 50, f"rms_norm {key} kernel"),
                plain_ms=time_ms(torch, plain, 20, f"rms_norm {key} plain",
                                 waits_ok=True),
                library_ms=time_ms(torch, lib, 50,
                                   f"F.rms_norm {key} (library)"),
                bound_ms=bounds[key][0], bound_by=bounds[key][1],
                max_abs_err=err[key])
            row[key]["ms_clean_l2"] = time_ms(
                torch, kern, 50, f"rms_norm {key} kernel, clean L2",
                clean_l2=True)
            row[key]["gb_s"] = nbytes[key] / row[key]["ms"] / 1e6
            row[key]["bound_share"] = row[key]["bound_ms"] / row[key]["ms"]
            log(f"[time] rms_norm {key} at the {label} shape [{rows}, {f}] "
                f"f32: kernel {row[key]['ms']:.4f} ms, "
                f"{row[key]['gb_s']:.0f} GB/s, "
                f"{100 * row[key]['bound_share']:.1f}% of the bound "
                f"{row[key]['bound_ms']:.4f} ms ({row[key]['bound_by']}), "
                f"{row[key]['ms_clean_l2']:.4f} ms behind a clean L2, "
                f"plain {row[key]['plain_ms']:.4f} ms, "
                f"F.rms_norm{' backward' if key == 'bwd' else ''} "
                f"{row[key]['library_ms']:.4f} ms, max|diff| {err[key]:.3e}")
        out[label] = row
    return out


def phase_time_adamw(torch, buckets):
    """fused AdamW on each bucket of ``{label: n f32 elements}`` (the
    llama_125m and llama_1b ones) beside its bound, the plain version and
    torch.optim.AdamW(fused=True), the memory of one freed before the
    next."""
    out = {}
    for label, n in buckets.items():
        out[label] = time_adamw_bucket(torch, label, n)
        torch.cuda.empty_cache()
    return out


def time_adamw_bucket(torch, label, n):
    from paddle_tpu_torch.kernels import fused_adamw as tfw
    g = torch.Generator(device="cuda").manual_seed(5)
    p = torch.randn(n, device="cuda", generator=g)
    gr = torch.randn(n, device="cuda", generator=g) * 1e-2
    m = torch.zeros(n, device="cuda")
    v = torch.zeros(n, device="cuda")
    sc = torch.tensor(tfw.adamw_scalars(1e-4, 3, 0.9, 0.999), device="cuda")
    kw = dict(beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=0.01,
              decoupled=True)
    got = [x.clone() for x in (p, m, v)]
    tfw.fused_adamw(got[0], gr, got[1], got[2], sc, **kw)
    tfw.fused_adamw_reference(p, gr, m, v, sc, **kw)
    err = max((a - b).abs().max().item() for a, b in zip(got, (p, m, v)))
    if err > ADAMW_ATOL:
        raise AssertionError(f"fused_adamw at the {label} bucket: {err}")
    del got
    ms = time_ms(torch, lambda: tfw.fused_adamw(p, gr, m, v, sc, **kw), 20)
    plain_ms = time_ms(torch, lambda: tfw.fused_adamw_reference(
        p, gr, m, v, sc, **kw), 5, "fused_adamw plain", waits_ok=True)
    torch.cuda.empty_cache()
    param = torch.nn.Parameter(p)          # shares p's memory
    param.grad = gr
    lib_opt = torch.optim.AdamW([param], lr=1e-4, weight_decay=0.01,
                                fused=True)
    library_ms = time_ms(torch, lib_opt.step, 20)
    del lib_opt, param
    bms, by = bound_ms(28 * n, 0)
    log(f"[time] fused_adamw on the {label} bucket ({n} f32): kernel "
        f"{ms:.4f} ms, bound {bms:.4f} ms ({by}, 28 B/element, "
        f"{bms / ms:.1%} of it), plain {plain_ms:.4f} ms, "
        f"torch.optim.AdamW(fused=True) {library_ms:.4f} ms, max|diff| "
        f"{err:.3e}")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                library_ms=library_ms, max_abs_err=err, n=n)


def ragged_kernel_split(torch, call, n=20):
    """Device ms per call of the ragged split launch and of the merge
    (``torch.profiler``, kernel names), over n calls back to back."""
    from torch.autograd import DeviceType
    call()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            call()
        torch.cuda.synchronize()
    split = merge = 0.0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or "ragged_kernel" not in e.key:
            continue
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0))
        if "ragged_kernel_merge" in e.key:
            merge += us
        else:
            split += us
    return split / 1e3 / n, merge / 1e3 / n


def phase_time_kernel(torch):
    """Rows 1 and 2: the ragged kernel over a bf16 pool and over the same
    pool quantized to int8, at the 7B step's shapes."""
    from paddle_tpu_torch.kernels.paged_attention import (
        ragged_paged_attention, ragged_paged_attention_reference)
    geo = dict(hq=32, hkv=32, d=128, ps=16)
    # the 7B step's shapes: T = 8 rows x q_block 8 + a 64-token chunk,
    # 513 pool pages, 64-page tables
    shapes = {
        "decode": [(1, n) for n in (49, 128, 233, 350, 441, 512, 560, 632)],
        "prefill": [(64, 600)] + [(1, n) for n in (49, 128, 233, 350, 441,
                                                  512, 560)],
    }
    out, out8 = {}, {}
    for label, rows in shapes.items():
        args = ragged_inputs(torch, rows, num_pages=513, pps=64, q_block=8,
                             t_total=128, dtype=torch.bfloat16, seed=11,
                             **geo)
        q, k, v, tables, q_starts, q_lens, kv_lens = args
        kq, ks, vq, vs = quantize_pools(torch, k, v)
        meta = (tables, q_starts, q_lens, kv_lens)
        for pool, res in (("bf16", out), ("int8", out8)):
            if pool == "bf16":
                kv, sc, lib_kv = (k, v), {}, (k, v)
            else:
                kv, sc = (kq, vq), dict(k_scales=ks, v_scales=vs)
                # the yardstick attends over the dequantized pages
                lib_kv = ((kq.float() * ks[:, :, None, None]).to(q.dtype),
                          (vq.float() * vs[:, :, None, None]).to(q.dtype))
            kern = lambda: ragged_paged_attention(   # noqa: E731
                q, *kv, *meta, q_block=8, **sc)
            plain = lambda: ragged_paged_attention_reference(  # noqa: E731
                q, *kv, *meta, **sc)
            err = (kern().float() - plain().float()).abs().max().item()
            if not err <= ATOL["bfloat16"]:
                raise AssertionError(f"{pool} {label}: kernel vs plain {err}")
            lib = sdpa_yardstick(torch, q, *lib_kv, *meta)
            ms = time_ms(torch, kern, 200)
            plain_ms = time_ms(torch, plain, 20, f"ragged {pool} {label} "
                               f"plain", waits_ok=True)
            library_ms = time_ms(torch, lib, 200)
            bms, by = attention_bound_ms(rows, t_total=128, itemsize=2,
                                         int8_pool=pool == "int8", **geo)
            split_ms, merge_ms = ragged_kernel_split(torch, kern)
            res[label] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bms,
                              bound_by=by, library_ms=library_ms,
                              max_abs_err=err, split_kernel_ms=split_ms,
                              merge_ms=merge_ms)
            log(f"[time] ragged_paged_attention 7B {label} step ({pool} "
                f"pool, bf16 q, rows (q_len, kv_len) {rows}): kernel "
                f"{ms:.4f} ms, bound {bms:.4f} ms ({by}), plain "
                f"{plain_ms:.4f} ms, SDPA on gathered K/V {library_ms:.4f} "
                f"ms, max|diff| {err:.3e}")
            log(f"[time]   of which (profiler, 20 calls, L2 warm): split "
                f"launch {split_ms:.4f} ms, merge {merge_ms:.4f} ms "
                f"({100 * merge_ms / max(split_ms + merge_ms, 1e-9):.1f}% "
                f"of the two)")
        del kq, vq, lib_kv
    return out, out8


def phase_time_matmul(torch):
    """Row 9 at each 7B serving shape (``MATMUL_SHAPES_7B``, bf16
    activations), int8 and int4, beside the shape's bound, the plain
    version and torch.matmul of the same activations against the
    unquantized bf16 weight (cuBLAS reads 2x or 4x the weight bytes), with
    GB/s and TFLOP/s; per body also one layer's 7 projections at M = 128
    (``PROJ_7B``)."""
    from paddle_tpu_torch.kernels import int8_matmul as tmm
    g = torch.Generator(device="cuda").manual_seed(13)
    count = {name: c for name, _, _, c in PROJ_7B}
    out = {}
    for bits in (8, 4):
        shapes, layer = {}, dict(ms=0.0, plain_ms=0.0, library_ms=0.0,
                                 bytes=0, flops=0, max_abs_err=0.0)
        for name, m, k, n, ldw in MATMUL_SHAPES_7B:
            x, wq, sc, w = matmul_case(torch, g, m, k, n, ldw, bits)
            kern = lambda: tmm.dequant_matmul(       # noqa: E731
                x, wq, sc, rows=k, bits=bits)
            plain = lambda: tmm.dequant_matmul_reference(  # noqa: E731
                x, wq, sc, k, bits)
            want = plain().float()
            err = (kern().float() - want).abs().max().item()
            if err > MATMUL_RTOL["bfloat16"] * max(1.0, want.abs().max()
                                                   .item()):
                raise AssertionError(f"int{bits} {name}: |diff| {err}")
            ms = time_ms(torch, kern, 100)
            plain_ms = time_ms(torch, plain, 10, "dequant-matmul plain",
                               waits_ok=True)
            library_ms = time_ms(torch, lambda: torch.matmul(x, w), 100)
            nbytes = m * k * 2 + wq.shape[0] * n + 4 * n + m * n * 2
            flops = 2 * m * k * n
            bms, by = bound_ms(nbytes, flops)
            splits = tmm.kernel_splits(bits, m, n, k)
            shapes[name] = dict(m=m, k=k, n=n, row_stride=ldw, ms=ms,
                                plain_ms=plain_ms, library_ms=library_ms,
                                bound_ms=bms, bound_by=by, splits=splits,
                                gb_s=nbytes / ms / 1e6,
                                tflop_s=flops / ms / 1e9, max_abs_err=err)
            for key, val in (("ms", ms), ("plain_ms", plain_ms),
                             ("library_ms", library_ms), ("bytes", nbytes),
                             ("flops", flops)):
                layer[key] += count.get(name, 0) * val
            if name in count:
                layer["max_abs_err"] = max(layer["max_abs_err"], err)
            log(f"[time] dequant_matmul int{bits} {name} (M {m}, K {k}, N "
                f"{n}, payload row stride {ldw}, bf16, {splits} K splits): "
                f"kernel {ms:.4f} ms, bound {bms:.4f} ms ({by}), "
                f"{nbytes / ms / 1e6:.0f} GB/s, {flops / ms / 1e9:.1f} "
                f"TFLOP/s, plain {plain_ms:.4f} ms, torch.matmul on the bf16 "
                f"weight {library_ms:.4f} ms ({ms / library_ms:.2f}x), "
                f"max|diff| {err:.3e}")
            del x, wq, sc, w
        layer["bound_ms"], layer["bound_by"] = bound_ms(layer.pop("bytes"),
                                                        layer.pop("flops"))
        layer["shapes"] = shapes
        out[bits] = layer
        log(f"[time] dequant_matmul int{bits}, one 7B layer's 7 projections "
            f"at M = {STEP_M}: kernel {layer['ms']:.4f} ms, bound "
            f"{layer['bound_ms']:.4f} ms ({layer['bound_by']}), plain "
            f"{layer['plain_ms']:.4f} ms, torch.matmul bf16 "
            f"{layer['library_ms']:.4f} ms "
            f"({layer['ms'] / layer['library_ms']:.2f}x)")
    return out


def phase_time_append(torch):
    """The int8 pool's segmented quantizing append (plain PyTorch, not a
    kernel) at the 7B step's shapes: device time of one call (one pool,
    K or V, of one layer) and the kernels it launches; a ragged step
    makes 2 x 32 calls (its plan is made once per step on the host)."""
    from paddle_tpu_torch.serving.engine import (_append_plan,
                                                 _segmented_quant_append)
    hkv, d, ps, pages, pps, t = 32, 128, 16, 513, 64, 128
    shapes = {
        "decode": [(1, n) for n in (49, 128, 233, 350, 441, 512, 560, 632)],
        "prefill": [(64, 600)] + [(1, n) for n in (49, 128, 233, 350, 441,
                                                  512, 560)],
    }
    out = {}
    for label, rows in shapes.items():
        q, _, _, tables, q_starts, q_lens, kv_lens = ragged_inputs(
            torch, rows, hq=hkv, hkv=hkv, d=d, ps=ps, num_pages=pages,
            pps=pps, q_block=8, t_total=t, dtype=torch.bfloat16, seed=12)
        chunk = q.transpose(0, 1).contiguous()          # [Hkv, T, d]
        Pp = torch.zeros(hkv, pages, ps, d, dtype=torch.int8, device="cuda")
        Ps = torch.zeros(hkv, pages, device="cuda")
        page, tok, sel = (torch.from_numpy(a).to("cuda") for a in
                          _append_plan(*(x.cpu().numpy() for x in
                                         (tables, q_starts, q_lens,
                                          kv_lens)), ps, 64, t))
        slots = page.numel() // len(rows)
        plan = (page.long(), tok.long(), sel.bool())
        call = lambda: _segmented_quant_append(   # noqa: E731
            Pp, Ps, chunk, *plan)
        ms = time_ms(torch, call, 50, f"int8 append {label}",
                     waits_ok=True)
        prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
        with prof:
            call()
            torch.cuda.synchronize()
        launches = sum(e.count for e in prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CUDA)
        out[label] = dict(ms=ms, launches=launches, slots=slots)
        log(f"[time] segmented int8 append, 7B {label} step ({slots} page "
            f"slot(s) per row): {ms:.4f} ms and {launches} kernel launches "
            f"per call; x 64 calls = {64 * ms:.2f} ms and {64 * launches} "
            f"launches per ragged step")
    return out


# ---------------------------------------------------------------------------
# burst decode: the decode megakernel
# ---------------------------------------------------------------------------

#: the 7B decode step's rows: kv lengths with the current token
DECODE_KV = [49, 128, 233, 350, 441, 512, 560, 632]
POOL_PAGES, PAGES_PER_SEQ, PAGE = 513, 64, 16


def mega_layers(torch, n, quant_w, seed):
    """``n`` full-width Llama-2-7B layers, N(0, 0.02) bf16 weights (int8
    projections when ``quant_w``), norms at 1."""
    from paddle_tpu_torch.quantization.low_bit import quantize_weight
    D, HD, F = 4096, 4096, 11008
    g = torch.Generator(device="cuda").manual_seed(seed)
    shapes = {"q": (D, HD), "k": (D, HD), "v": (D, HD), "o": (HD, D),
              "gate": (D, F), "up": (D, F), "down": (F, D)}
    layers = []
    for _ in range(n):
        lyr = {"ln1": torch.ones(D, device="cuda", dtype=torch.bfloat16),
               "ln2": torch.ones(D, device="cuda", dtype=torch.bfloat16)}
        for k, shp in shapes.items():
            w = (torch.randn(*shp, device="cuda", generator=g) * 0.02) \
                .to(torch.bfloat16)
            lyr[k] = quantize_weight(w, "weight_only_int8") if quant_w else w
        layers.append(lyr)
    return layers


def mega_inputs(torch, quant_kv, n_layers, seed):
    """Hidden states, block tables and per-layer pools (bf16, or int8 with
    per-(head, page) scales) for the 7B decode step's 8 rows."""
    rng = np.random.RandomState(seed)
    R, H, dh = len(DECODE_KV), 32, 128
    tables = np.zeros((R, PAGES_PER_SEQ), np.int32)
    free = rng.permutation(np.arange(1, POOL_PAGES)).tolist()
    for r, n in enumerate(DECODE_KV):
        tables[r, :-(-n // PAGE)] = [free.pop() for _ in range(-(-n // PAGE))]
    g = torch.Generator(device="cuda").manual_seed(seed)
    shape = (H, POOL_PAGES, PAGE, dh)
    pools = []
    for _ in range(n_layers):
        k = torch.randn(*shape, device="cuda", generator=g)
        v = torch.randn(*shape, device="cuda", generator=g)
        if quant_kv:
            kq, ks, vq, vs = quantize_pools(torch, k, v)
            pools.append([kq, vq, ks, vs])
        else:
            pools.append([k.to(torch.bfloat16), v.to(torch.bfloat16), None,
                          None])
        del k, v
    h = torch.randn(R, 4096, device="cuda", generator=g).to(torch.bfloat16)
    return h, pools, torch.from_numpy(tables).to("cuda"), \
        torch.tensor(DECODE_KV, dtype=torch.int32, device="cuda")


def mega_append_at(torch, tbl, kv_lens):
    """Each row's append slot, as a burst passes it: the token at
    position ``kv_len - 1`` goes to its page and offset."""
    R = kv_lens.shape[0]
    pos = kv_lens - 1
    page = tbl[torch.arange(R, device="cuda"), (pos // PAGE).long()]
    return page.contiguous(), (pos % PAGE).to(torch.int32)


def mega_err(torch, got, want, name="decode megakernel"):
    """(max |diff|, tolerance) of a bf16 megakernel output."""
    err = (got.float() - want.float()).abs().max().item()
    tol = MEGA_RTOL["bfloat16"] * max(1.0, want.float().abs().max().item())
    if not (bool(torch.isfinite(got.float()).all()) and err <= tol):
        raise AssertionError(f"{name} vs plain: |diff| {err} over "
                             f"tolerance {tol}")
    return err, tol


def phase_megakernel_parity(torch):
    """The decode megakernel against its plain version at one full-width
    7B layer (8 rows, kv 49-632, bf16 hidden states), every contract, and
    with the append in the kernel over 2 layers (model scope) and 1 (a
    layer-scope burst's launch). Returns the worst |diff|."""
    from paddle_tpu_torch.kernels import decode_megakernel as dmk
    from paddle_tpu_torch.serving.engine import _quantized_append
    kw = dict(eps=1e-5, theta=10000.0, num_heads=32)
    worst = 0.0
    cases = (("bf16 weights, bf16 pool, self_kv", False, False, True),
             ("int8 weights, bf16 pool, self_kv", True, False, True),
             ("bf16 weights, int8 pool, append first", False, True, False))
    for label, quant_w, quant_kv, self_kv in cases:
        lyr = mega_layers(torch, 1, quant_w, seed=21)[0]
        h, pools, tbl, kv_lens = mega_inputs(torch, quant_kv, 1, seed=22)
        kp, vp, ks, vs = pools[0]
        args = (lyr, h, kp, vp, tbl, kv_lens)
        got = dmk.fused_decode_layer(*args, self_kv=self_kv, k_scales=ks,
                                     v_scales=vs, **kw)
        torch.cuda.synchronize()
        want = dmk._reference_layer(*args, self_kv=self_kv, k_scales=ks,
                                    v_scales=vs, **kw)
        errs = [mega_err(torch, a, b) for a, b in zip(got, want)
                if a is not None]
        worst = max([worst] + [e for e, _ in errs])
        log(f"[parity] decode_megakernel 7B layer, {label}: max|kernel - "
            f"plain| h {errs[0][0]:.3e} (tol {errs[0][1]:.3e})"
            + (f", k {errs[1][0]:.3e}, v {errs[2][0]:.3e}"
               if len(errs) == 3 else ""))
        del lyr, pools, args, got, want
    # 2 layers in one launch (model scope) and one (a layer-scope burst's
    # launch, the pool write in the kernel)
    for pool, n_layers in (("bf16", 2), ("int8", 2), ("bf16", 1),
                           ("int8", 1)):
        quant = pool == "int8"
        layers = mega_layers(torch, n_layers, False, seed=23)
        h, pools, tbl, kv_lens = mega_inputs(torch, quant, n_layers, seed=24)
        R = h.shape[0]
        append_at = mega_append_at(torch, tbl, kv_lens)
        runs = []
        for side in ("kernel", "plain"):
            ps_ = [[x.clone() if x is not None else None for x in p]
                   for p in pools]
            rec = torch.zeros((n_layers, 2, R, 32, 128), device="cuda")
            kss = [p[2] for p in ps_] if quant else None
            vss = [p[3] for p in ps_] if quant else None
            if side == "kernel":
                out = dmk.fused_decode_model(
                    layers, h, [p[0] for p in ps_], [p[1] for p in ps_], tbl,
                    kv_lens, self_kv=not quant, k_scales=kss, v_scales=vss,
                    append_at=append_at, appended=rec, **kw)[0]
                torch.cuda.synchronize()
            else:
                out = dmk._plain_model(
                    layers, h, [p[0] for p in ps_], [p[1] for p in ps_], kss,
                    vss, tbl, kv_lens, kw["eps"], kw["theta"],
                    kw["num_heads"], not quant, None, None, append_at, rec)
            runs.append((out, ps_, rec))
        (kout, kpools, krec), (pout, ppools, prec) = runs
        err_h, tol = mega_err(torch, kout, pout)
        err_kv, _ = mega_err(torch, krec, prec)
        worst = max(worst, err_h, err_kv)
        pool_note = ""
        if quant:
            # the plain append of the kernel's own K/V from the same pools
            steps, rel = 0, 0.0
            for li in range(n_layers):
                for j in range(2):
                    P, S = pools[li][j].clone(), pools[li][2 + j].clone()
                    _quantized_append(P, S, krec[li, j].to(torch.bfloat16)
                                      .transpose(0, 1), *append_at, PAGE,
                                      torch.ones(R, dtype=torch.bool,
                                                 device="cuda"))
                    steps = max(steps, (kpools[li][j].int() - P.int()).abs()
                                .max().item())
                    d = (kpools[li][2 + j] - S).abs() \
                        / S.abs().clamp_min(1e-30)
                    rel = max(rel, d.max().item())
            if steps > 1 or rel > 1e-6:
                raise AssertionError(f"in-kernel int8 append: pages {steps} "
                                     f"steps, scales {rel} relative")
            pool_note = (f"; int8 pools vs the plain append of the kernel's "
                         f"K/V: {steps} step(s) (<= 1), scales {rel:.2e} "
                         f"relative (<= 1e-6)")
        else:
            diff = max((kp[:, 1:].float() - pp[:, 1:].float()).abs().max()
                       .item() for kl, pl in zip(kpools, ppools)
                       for kp, pp in zip(kl[:2], pl[:2]))
            if diff > err_kv:
                raise AssertionError(f"bf16 pools after the append: {diff}")
            pool_note = f"; bf16 pools {diff:.3e}"
        log(f"[parity] decode_megakernel, {n_layers} full-width 7B "
            f"layer(s) with the append, {pool} pool, one launch: "
            f"max|kernel - plain| h {err_h:.3e} "
            f"(tol {tol:.3e}), appended K/V {err_kv:.3e}{pool_note}")
        del layers, pools, runs
    torch.cuda.empty_cache()
    return worst


#: the burst engines of phase [7b-burst]: knobs; the per-token run whose
#: greedy tokens each is compared with (informational)
BURST_RUNS = {
    "bf16 layer": (dict(megakernel_scope="layer"), "bf16"),
    "bf16 model": (dict(megakernel_scope="model"), "bf16"),
    "w8_kv8 layer": (dict(quantized_mode="weight_only_int8",
                          kv_cache_dtype="int8", megakernel_scope="layer"),
                     "w8_kv8"),
    "w8_kv8 model": (dict(quantized_mode="weight_only_int8",
                          kv_cache_dtype="int8", megakernel_scope="model"),
                     "w8_kv8"),
}
BURST_TOKENS = 8
TRACED_BURSTS = 2


def serve_7b_burst(torch, model, tag, knobs):
    """Serve the 7B load with ``burst_tokens=8``: the counts reset just
    before and read just after; every request must finish and the
    megakernel must launch once per layer and burst iteration (layer
    scope) or once per iteration (model scope); the ragged steps keep
    their own kernels' counts. Traces 2 bursts."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.kernels import LAUNCHES, reset_launch_counts
    cfg = model.config
    layers = cfg.num_hidden_layers
    eng = pt.LLMEngine(model, max_len=1024, page_size=16, max_num_seqs=8,
                       burst_tokens=BURST_TOKENS, **knobs)
    V = cfg.vocab_size
    prompts, late = serve_prompts(V)
    kinds = []                 # per step: burst length, or 0 (ragged)
    sch = eng.scheduler
    orig_burst = sch.prepare_burst

    def prepare_burst(n):
        plan = orig_burst(n)
        kinds.append(0 if plan is None else plan.burst_len)
        return plan

    sch.prepare_burst = prepare_burst
    rids = []
    for i, p in enumerate(prompts):
        kw = dict(temperature=0.8, top_k=50, seed=100 + i) \
            if i in SERVE_SAMPLED else {}
        rids.append(eng.add_request(p, max_new_tokens=32, **kw))
    reset_launch_counts()
    step_s, step_tok = [], []
    prof, traced, breakdown = None, [], None
    while eng.has_unfinished():
        if len(rids) == len(prompts) and eng.outputs()[rids[1]].token_ids:
            rids.append(eng.add_request(late, max_new_tokens=32))
        if prof is None and not traced and len(rids) > len(prompts) and \
                kinds and kinds[-1] > 0:
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            prof.start()
        tok0 = eng.metrics.tokens_generated.value
        t = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
        step_tok.append(eng.metrics.tokens_generated.value - tok0)
        if prof is not None:
            if kinds[-1] > 0:
                traced.append(len(step_s) - 1)
            if len(traced) == TRACED_BURSTS or not eng.has_unfinished():
                prof.stop()
                breakdown = report_profile(
                    torch, prof, [step_s[i] for i in traced],
                    f"{tag}: {len(traced)} traced bursts (burst lengths "
                    f"{[kinds[i] for i in traced]})",
                    {"decode megakernel": lambda k: "decode_megakernel" in k,
                     "prefill megakernel":
                         lambda k: "prefill_megakernel" in k,
                     "matmuls": is_gemm,
                     "dequant matmul": lambda k: "dequant_matmul" in k})
                prof = None
        if len(step_s) > 1000:
            raise AssertionError(f"[{tag}] the 7B load did not drain")
    launches = dict(LAUNCHES)
    snap = eng.metrics_snapshot()
    outs = eng.outputs()
    eng.pool.check_invariants()
    for r in rids:
        o = outs[r]
        if o.status != "finished" or len(o.token_ids) != 32 or \
                not all(0 <= t < V for t in o.token_ids):
            raise AssertionError(f"[{tag}] {r}: {o}")
    iters = sum(kinds)
    bursts = sum(1 for k in kinds if k)
    ragged = len(kinds) - bursts
    scope = knobs["megakernel_scope"]
    quant = "kv_cache_dtype" in knobs
    fused = knobs.get("prefill_megakernel") == "fused"
    want = {k: 0 for k in launches}
    want["decode_megakernel"] = (layers if scope == "layer" else 1) * iters
    attn = "ragged_paged_attention_int8" if quant else "ragged_paged_attention"
    want["prefill_megakernel" if fused else attn] = layers * ragged
    if not fused:
        want["ragged_paged_attention_merge"] = layers * ragged
    if quant:
        # ragged steps: 7 projections per layer (fused: the k|v one of
        # the append outside the kernel); bursts at either scope append
        # inside the megakernel and launch none
        want["int8_matmul"] = layers * (1 if fused else 7) * ragged
    if launches != want or snap["burst_launches"] != bursts or not bursts:
        raise AssertionError(f"[{tag}] launches {launches} != {want} "
                             f"({bursts} bursts of {iters} iterations, "
                             f"{ragged} ragged steps)")
    timed = [i for i, k in enumerate(kinds) if k and i not in traced]
    b_s = sum(step_s[i] for i in timed)
    b_tok = sum(step_tok[i] for i in timed)
    ms_tok = 1e3 * b_s / max(b_tok, 1)
    log(f"[{tag}] served {len(rids)} requests: {ragged} ragged steps, "
        f"{bursts} bursts of {iters} iterations ({snap['tokens_generated']} "
        f"tokens, {sum(step_tok[i] for i, k in enumerate(kinds) if k)} in "
        f"bursts, {b_tok / max(len(timed), 1):.2f} per untraced burst), "
        f"{snap['prefix_cache_hits']} prefix hits, {snap['preemptions']} "
        f"preemptions")
    log(f"[{tag}] decode {ms_tok:.3f} ms per generated token (host time of "
        f"{len(timed)} untraced bursts over the {b_tok} tokens they "
        f"committed, synchronised per step); launches "
        f"{ {k: v for k, v in launches.items() if v} } = {want}; "
        f"host_dispatches {snap['host_dispatches']}")
    tokens = [outs[r].token_ids for r in rids]
    del eng
    torch.cuda.empty_cache()
    return dict(launches=launches, iterations=iters, bursts=bursts,
                ragged_steps=ragged, decode_ms_per_token=ms_tok,
                burst_tokens=b_tok, timed_bursts=len(timed),
                profile=breakdown, tokens=tokens)


def phase_serve_7b_burst(torch, model, per_token):
    """Phase [7b-burst]: the four burst engines; greedy tokens equal to
    the per-token run of the same weights are informational, with where
    each request first leaves the per-token run and how close the two
    candidates were there (:func:`burst_divergence`)."""
    runs = {}
    greedy = [i for i in range(len(SERVE_LENS) + 1) if i not in SERVE_SAMPLED]
    for tag, (knobs, ref) in BURST_RUNS.items():
        run = serve_7b_burst(torch, model, f"7b-burst {tag}", knobs)
        same = total = 0
        for i in greedy:
            for a, b in zip(run["tokens"][i], per_token[ref]["tokens"][i]):
                same += a == b
                total += 1
        run["per_token_share"] = same / total
        log(f"[7b-burst {tag}] greedy tokens equal to the per-token {ref} "
            f"run's: {same} of {total} ({100 * same / total:.1f}%, "
            f"informational)")
        runs[tag] = run
    burst_divergence(torch, model, per_token, runs, greedy)
    return runs


def plain_step_logits(torch, p, cfg, ids, n):
    """The bf16 logits ``[n, V]`` that predict the last ``n`` tokens of
    ``ids`` and the one after them: a plain full-sequence forward of the
    engine's weights (``x @ w`` projections, PyTorch's causal attention,
    the port's plain norm and rope), no kernel of the port."""
    from paddle_tpu_torch.models.generation import _logits, _rms_norm, _rope
    H, d, eps, theta = (cfg.num_attention_heads, cfg.head_dim,
                        cfg.rms_norm_eps, cfg.rope_theta)
    s, dev = len(ids), p["embed"].device
    pos = torch.arange(s, device=dev)[None]
    x = p["embed"][torch.tensor(ids, device=dev)][None]         # [1, s, D]
    for lyr in p["layers"]:
        a = _rms_norm(x, lyr["ln1"], eps)
        q, k, v = ((a @ lyr[m]).reshape(1, s, -1, d) for m in "qkv")
        q, k = _rope(q, pos, theta, d), _rope(k, pos, theta, d)
        if k.shape[2] != H:
            k, v = (t.repeat_interleave(H // t.shape[2], 2) for t in (k, v))
        o = torch.nn.functional.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True).transpose(1, 2).reshape(1, s, H * d)
        x = x + o @ lyr["o"]
        a = _rms_norm(x, lyr["ln2"], eps)
        x = x + (torch.nn.functional.silu(a @ lyr["gate"]) * (a @ lyr["up"])) \
            @ lyr["down"]
    return _logits(p, _rms_norm(x[0, s - n:], p["norm"], eps), cfg).float()


def burst_divergence(torch, model, per_token, runs, greedy):
    """Why a burst engine's greedy tokens leave the per-token run's. One
    plain forward (:func:`plain_step_logits`) per greedy request over its
    prompt and the per-token run's tokens gives every generation step's
    logits, teacher-forced along that run. Printed: how many steps the
    per-token run's own tokens differ from that forward's argmax (two
    implementations of the same bf16 function), and per burst engine
    and request the first step that differs, the forward's logit of the
    per-token run's token minus the burst's there (the margin), and the
    forward's top-1 minus top-2 gap there and its median over the
    request's steps. The forward has bf16 weights and pool: for the int8
    engines it is the nearest plain function, not theirs."""
    from paddle_tpu_torch.models.generation import extract_params
    p, cfg = extract_params(model), model.config
    prompts, late = serve_prompts(cfg.vocab_size)
    prompts = prompts + [late]
    out = {}
    for ref in dict.fromkeys(r for _, r in BURST_RUNS.values()):
        toks = per_token[ref]["tokens"]
        steps = {}
        own = []
        with torch.inference_mode():
            for i in greedy:
                n = len(toks[i])
                lg = plain_step_logits(torch, p, cfg, prompts[i]
                                       + toks[i][:-1], n)       # [n, V]
                top = lg.topk(2, -1)
                gap = (top.values[:, 0] - top.values[:, 1]).tolist()
                steps[i] = (lg, gap)
                own += [(j, gap[j]) for j in range(n)
                        if int(top.indices[j, 0]) != toks[i][j]]
        own_gaps = [g for _, g in own] or [0.0]
        log(f"[7b-burst] the per-token {ref} run against a plain bf16 "
            f"forward teacher-forced along its tokens: "
            f"{len(own)} of {sum(len(toks[i]) for i in greedy)} steps "
            f"differ (the forward's top-1 minus top-2 gap there: median "
            f"{float(np.median(own_gaps)):.4f}, max {max(own_gaps):.4f})")
        for tag, (_, r) in BURST_RUNS.items():
            if r != ref:
                continue
            rows = []
            for i in greedy:
                lg, gap = steps[i]
                a, b = toks[i], runs[tag]["tokens"][i]
                j = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y),
                         None)
                med = float(np.median(gap))
                if j is None:
                    rows.append(dict(request=i, first=None, median_gap=med))
                    continue
                rows.append(dict(request=i, first=j, median_gap=med,
                                 margin=float(lg[j, a[j]] - lg[j, b[j]]),
                                 gap=gap[j]))
            runs[tag]["divergence"] = rows
            out[tag] = rows
            log(f"[7b-burst {tag}] first step that differs from the per-"
                f"token run, per greedy request (of 32): " + "; ".join(
                    f"r{d['request']} none (median gap "
                    f"{d['median_gap']:.4f})" if d["first"] is None else
                    f"r{d['request']} step {d['first']} (margin "
                    f"{d['margin']:.4f}, gap {d['gap']:.4f}, median gap "
                    f"{d['median_gap']:.4f})" for d in rows))
        del steps
    torch.cuda.empty_cache()
    return out


#: the decode megakernel's projection phases and their weights
MEGA_PROJ_PHASES = {"q|k|v": ("q", "k", "v"), "o": ("o",),
                    "gate|up": ("gate", "up"), "down": ("down",)}


def mega_phase_bounds(lyr, kv_bytes):
    """ms bound of each decode-megakernel phase that moves bytes: its
    weights (int8 payload and scales) and, for attention, the K/V pages,
    over the HBM rate."""
    def nbytes(w):
        if hasattr(w, "qdata"):
            return w.qdata.numel() + 4 * w.scale.numel()
        return w.numel() * w.element_size()
    out = {k: 1e3 * sum(nbytes(lyr[m]) for m in ms) / HBM_BYTES_PER_S
           for k, ms in MEGA_PROJ_PHASES.items()}
    out["attention"] = 1e3 * kv_bytes / HBM_BYTES_PER_S
    return out


def phase_time_megakernel(torch):
    """Row 10 at the 7B decode shape (8 rows, kv 49-632): the launch a
    layer-scope burst makes (``fused_decode_model([layer], ...,
    append_at=..., rope_tables=...)``: one layer, each row's K/V written
    into its pool slot in the kernel; bf16 weights and pool, and int8
    weights with an int8 pool) beside its bound, its plain version and
    the per-token path's time for the same layer (cuBLAS projections,
    the ragged kernel, elementwise: ``spec_decode._ragged_fp_layer`` on
    the engine's 128-token decode step)."""
    from paddle_tpu_torch.kernels import decode_megakernel as dmk
    from paddle_tpu_torch.kernels.paged_attention import ragged_block_row
    from paddle_tpu_torch.models.llama import llama2_7b_config
    from paddle_tpu_torch.serving.spec_decode import (_ragged_fp_layer,
                                                      _ragged_packing)
    cfg = llama2_7b_config()
    kw = dict(eps=cfg.rms_norm_eps, theta=cfg.rope_theta, num_heads=32)
    R, D, dh, H = len(DECODE_KV), 4096, 128, 32
    out = {}
    for label, quant in (("bf16", False), ("int8", True)):
        lyr = mega_layers(torch, 1, quant, seed=31)[0]
        h, pools, tbl, kv_lens = mega_inputs(torch, quant, 1, seed=32)
        kp, vp, ks, vs = pools[0]
        self_kv = not quant
        append_at = mega_append_at(torch, tbl, kv_lens)
        rope = dmk._rope_tables(kv_lens, cfg.rope_theta, dh)
        one = lambda t: None if t is None else [t]        # noqa: E731

        def kern(kp, vp, ks, vs):
            return dmk.fused_decode_model(
                [lyr], h, [kp], [vp], tbl, kv_lens, self_kv=self_kv,
                k_scales=one(ks), v_scales=one(vs), append_at=append_at,
                rope_tables=rope, **kw)[0]

        def plain(kp, vp, ks, vs):
            return dmk._plain_model(
                [lyr], h, [kp], [vp], one(ks), one(vs), tbl, kv_lens,
                kw["eps"], kw["theta"], kw["num_heads"], self_kv, None,
                None, append_at, None)

        def fresh():            # the pool as it was, for each side
            return [None if t is None else t.clone() for t in pools[0]]
        got = kern(*fresh())
        torch.cuda.synchronize()
        err = mega_err(torch, got, plain(*fresh()))[0]
        ms = time_ms(torch, lambda: kern(kp, vp, ks, vs), 50)
        plain_ms = time_ms(torch, lambda: plain(kp, vp, ks, vs), 5,
                           "decode megakernel plain", waits_ok=True)
        wbytes = sum(w.nbytes if hasattr(w, "nbytes") and not
                     isinstance(w, torch.Tensor) else
                     w.numel() * w.element_size() for w in lyr.values())
        # attention reads the cached positions (fp: the current token is
        # attended in registers; int8: from its page, after the append)
        pos_read = sum(n - (1 if self_kv else 0) for n in DECODE_KV)
        kv_item = 1 if quant else 2
        kv_bytes = pos_read * 32 * dh * 2 * kv_item
        if quant:       # two f32 scales per (head, page) read
            kv_bytes += sum(-(-n // PAGE) for n in DECODE_KV) * 32 * 2 * 4
        # h in and out, each row's K and V written into its slot
        io = R * D * 2 * 2 + R * 32 * dh * 2 * kv_item
        params = sum((w.qdata if quant else w).numel()
                     for k, w in lyr.items() if k not in ("ln1", "ln2"))
        flops = 2 * R * params + 4 * sum(DECODE_KV) * dh * H
        bms, by = bound_ms(wbytes + kv_bytes + io, flops)
        # where a launch's time goes: the device clock at each phase's end
        stamps = torch.zeros(1 + len(dmk.PHASES), dtype=torch.int64,
                             device="cuda")
        phases = dict.fromkeys(dmk.PHASES, 0.0)
        for _ in range(10):
            dmk._launch_cuda([lyr], h, [kp], [vp], one(ks), one(vs), tbl,
                             kv_lens, self_kv=self_kv, append_at=append_at,
                             rope_tables=rope, stamps=stamps, **kw)
            t = stamps.tolist()
            for i, name in enumerate(dmk.PHASES):
                phases[name] += (t[i + 1] - t[i]) / 1e6 / 10
        phase_bound = mega_phase_bounds(lyr, kv_bytes)
        res = dict(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                   max_abs_err=err, weight_bytes=wbytes, kv_bytes=kv_bytes,
                   phase_ms=phases, phase_bound_ms=phase_bound)
        if not quant:
            # the yardstick of the projections: cuBLAS at M = 8 over the
            # layer's 7 bf16 weights (timed here; the port never calls it)
            ws = [lyr[k] for k in dmk._LAYER_MATS]
            xs = {n: torch.randn(R, n, device="cuda", dtype=torch.bfloat16)
                  for n in {w.shape[0] for w in ws}}
            res["matmul_yardstick_ms"] = time_ms(
                torch, lambda: [torch.matmul(xs[w.shape[0]], w) for w in ws],
                50)
        if not quant:
            # the per-token path's layer on the same rows: the engine's
            # decode step packs 8 rows at q_block 8 into 128 tokens
            T, qb = 128, 8
            q_starts = torch.full((R,), T, dtype=torch.int32)
            q_starts[:] = torch.arange(R, dtype=torch.int32) * qb
            q_lens = torch.ones(R, dtype=torch.int32)
            positions = torch.zeros(T, dtype=torch.int32)
            positions[q_starts.long()] = kv_lens.cpu() - 1
            hT = torch.zeros(1, T, D, dtype=torch.bfloat16, device="cuda")
            hT[0, q_starts.long().cuda()] = h
            meta = [x.cuda() for x in (positions, q_starts, q_lens)]
            tok_row, live = _ragged_packing(meta[1], meta[2], T)
            brow = ragged_block_row(meta[1], T // qb, qb)
            ragged = lambda: _ragged_fp_layer(   # noqa: E731
                lyr, hT, kp, vp, meta[0], tbl, tok_row, live, meta[1],
                meta[2], kv_lens, cfg, PAGE, PAGES_PER_SEQ, qb,
                block_row=brow)
            res["per_token_layer_ms"] = time_ms(
                torch, ragged, 50, "per-token layer", waits_ok=True)
        out[label] = res
        log(f"[time] decode_megakernel 7B layer, {label} weights + {label} "
            f"pool, 8 rows (kv {DECODE_KV[0]}-{DECODE_KV[-1]}), the "
            f"layer-scope burst's launch (K/V appended in the kernel): kernel "
            f"{ms:.4f} ms, bound {bms:.4f} ms ({by}: weights "
            f"{wbytes / 1e6:.2f} MB + K/V {kv_bytes / 1e6:.2f} MB), plain "
            f"{plain_ms:.4f} ms"
            + (f", per-token path's layer (cuBLAS + ragged kernel + "
               f"elementwise) {res['per_token_layer_ms']:.4f} ms"
               if "per_token_layer_ms" in res else "")
            + f", max|diff| {err:.3e}")
        log(f"[time] decode_megakernel 7B layer, {label}: ms per phase, "
            f"each to the end of the barrier after it (device clock, 10 "
            f"launches, L2 warm), with its bound where it moves bytes: "
            + ", ".join(f"{k} {v:.4f}" + (f" (bound {phase_bound[k]:.4f})"
                                          if k in phase_bound else "")
                        for k, v in phases.items()))
        if "matmul_yardstick_ms" in res:
            log(f"[time] yardstick: torch.matmul of the 8 rows by the "
                f"layer's 7 bf16 weights (cuBLAS, M = 8): "
                f"{res['matmul_yardstick_ms']:.4f} ms against the kernel's "
                f"projection phases' "
                f"{sum(phases[k] for k in MEGA_PROJ_PHASES):.4f} ms")
        del lyr, pools, got
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# fused ragged prefill: the prefill megakernel
# ---------------------------------------------------------------------------

#: the 7B ragged step of the prefill megakernel's phases, (q_len, kv_len)
#: per row at T = 128, q_block 8: a 64-token chunk of a 600-token prompt, a
#: continuation chunk, decode rows, pad rows (16 tokens of slot padding)
PREFILL_7B_ROWS = [(64, 600), (16, 250), (1, 49), (1, 233), (1, 441),
                   (1, 632), (0, 0), (0, 0)]
STEP_T = 128

#: the prefill megakernel's variants held to the plain version at the 7B
#: layer: (label, int8 weights, int8 pool)
PREFILL_CASES = (("bf16 weights, bf16 pool", False, False),
                 ("int8 weights, bf16 pool", True, False),
                 ("bf16 weights, int8 pool", False, True),
                 ("int8 weights, int8 pool", True, True))


def prefill_inputs(torch, quant_kv, seed):
    """Hidden states ``[1, 128, 4096]`` bf16, per-layer-shaped pools (bf16,
    or int8 with per-(head, page) scales), the step's metadata and
    prologue for :data:`PREFILL_7B_ROWS` as the engine packs them, and the
    int8 pool's append plan (the engine's, made on the host)."""
    from paddle_tpu_torch.kernels import prefill_megakernel as pmk
    from paddle_tpu_torch.serving.engine import _append_plan
    rng = np.random.RandomState(seed)
    R = len(PREFILL_7B_ROWS)
    q_starts = np.full(R, STEP_T, np.int32)
    q_lens = np.zeros(R, np.int32)
    kv_lens = np.zeros(R, np.int32)
    tables = np.zeros((R, PAGES_PER_SEQ), np.int32)
    positions = np.zeros(STEP_T, np.int32)
    free = rng.permutation(np.arange(1, POOL_PAGES)).tolist()
    cur = 0
    for r, (ql, kl) in enumerate(PREFILL_7B_ROWS):
        if ql == 0:
            continue
        q_starts[r], q_lens[r], kv_lens[r] = cur, ql, kl
        n = -(-kl // PAGE)
        tables[r, :n] = [free.pop() for _ in range(n)]
        positions[cur:cur + ql] = np.arange(kl - ql, kl)
        cur += -(-ql // 8) * 8
    m = dict(zip(("positions", "tbl", "q_starts", "q_lens", "kv_lens"),
                 (torch.from_numpy(a).to("cuda") for a in (
                     positions, tables, q_starts, q_lens, kv_lens))))
    m["pre"] = pmk.ragged_prologue(
        m["positions"], m["tbl"], m["q_starts"], m["q_lens"], theta=10000.0,
        head_dim=128, page_size=PAGE, max_pages=PAGES_PER_SEQ, q_block=8)
    g = torch.Generator(device="cuda").manual_seed(seed)
    shape = (32, POOL_PAGES, PAGE, 128)
    k = torch.randn(*shape, device="cuda", generator=g)
    v = torch.randn(*shape, device="cuda", generator=g)
    if quant_kv:
        kq, ks, vq, vs = quantize_pools(torch, k, v)
        pool = [kq, vq, ks, vs]
    else:
        pool = [k.to(torch.bfloat16), v.to(torch.bfloat16), None, None]
    del k, v
    h = torch.randn(1, STEP_T, 4096, device="cuda", generator=g) \
        .to(torch.bfloat16)
    append = None
    if quant_kv:
        page, tok, sel = (torch.from_numpy(a).to("cuda") for a in _append_plan(
            tables, q_starts, q_lens, kv_lens, PAGE, 64, STEP_T))
        append = (page.long(), tok.long(), sel.bool())
    return h, pool, m, append


def phase_prefill_parity(torch):
    """The prefill megakernel against its plain version at one full-width
    7B layer over the T = 128 mixed step, every variant: h (all tokens),
    the bf16 pools after the step (null page excluded), or the int8 pools
    appended outside the kernel (pages in int8 steps, scales relative).
    Returns the worst |diff| of h."""
    from paddle_tpu_torch.kernels import prefill_megakernel as pmk
    from paddle_tpu_torch.serving.engine import _chunk_append_fn
    kw = dict(eps=1e-5, num_heads=32, q_block=8)
    worst = 0.0
    for label, quant_w, quant_kv in PREFILL_CASES:
        fused = pmk.fuse_layer_weights(mega_layers(torch, 1, quant_w,
                                                   seed=41)[0])
        h, pool, m, append = prefill_inputs(torch, quant_kv, seed=42)
        kw_kv = dict(quant_append_fn=_chunk_append_fn(append)) \
            if quant_kv else {}
        outs = []
        for side in ("kernel", "plain"):
            kp, vp, ks, vs = [x.clone() if x is not None else None
                              for x in pool]
            args = (fused, h, kp, vp, m["tbl"], m["pre"], m["q_starts"],
                    m["q_lens"], m["kv_lens"])
            if side == "kernel":
                out = pmk.fused_prefill_layer(*args, k_scales=ks, v_scales=vs,
                                              **kw, **kw_kv)
                kp2, vp2, ks2, vs2 = [x.clone() if x is not None else None
                                      for x in pool]
                again = pmk.fused_prefill_layer(
                    fused, h, kp2, vp2, *args[4:], k_scales=ks2,
                    v_scales=vs2, **kw, **kw_kv)
                torch.cuda.synchronize()
                if not all(a is None or torch.equal(a, b)
                           for a, b in zip(out, again)):
                    raise AssertionError(f"prefill megakernel {label}: two "
                                         f"launches differ")
                del again, kp2, vp2, ks2, vs2
            else:
                out = pmk._reference_prefill_layer(
                    *args, num_kv_heads=32, head_dim=128, page_size=PAGE,
                    k_scales=ks, v_scales=vs, **kw, **kw_kv)
            outs.append(out)
        (got, gk, gv, gks, gvs), (want, wk, wv, wks, wvs) = outs
        err, tol = mega_err(torch, got, want, "prefill megakernel")
        worst = max(worst, err)
        if quant_kv:
            steps = max((a[:, 1:].int() - b[:, 1:].int()).abs().max().item()
                        for a, b in ((gk, wk), (gv, wv)))
            rel = max(((a - b).abs() / b.abs().clamp_min(1e-30)).max().item()
                      for a, b in ((gks, wks), (gvs, wvs)))
            if steps > 1 or rel > 1e-2:
                raise AssertionError(f"prefill megakernel {label}: int8 pools "
                                     f"{steps} steps, scales {rel} relative")
            pool_note = (f"int8 pools {steps} step(s) (<= 1), scales "
                         f"{rel:.2e} relative (<= 1e-2: one bf16 ulp of the "
                         f"k/v amax)")
        else:
            kv = max(mega_err(torch, a[:, 1:], b[:, 1:],
                              "prefill megakernel pools")[0]
                     for a, b in ((gk, wk), (gv, wv)))
            pool_note = f"bf16 pools {kv:.3e}"
        log(f"[parity] prefill_megakernel 7B layer, {label}, T {STEP_T} "
            f"(rows {PREFILL_7B_ROWS}): max|kernel - plain| h {err:.3e} (tol "
            f"{tol:.3e}), {pool_note}; two launches bitwise equal")
        del fused, pool, outs
        torch.cuda.empty_cache()
    # model scope: two full-width layers through fused_prefill_model (one
    # launch each) against the plain layer loop, bf16 weights and pools
    from paddle_tpu_torch.kernels import LAUNCHES, reset_launch_counts
    fused = [pmk.fuse_layer_weights(lyr)
             for lyr in mega_layers(torch, 2, False, seed=43)]
    h, pool, m, _ = prefill_inputs(torch, False, seed=44)
    meta = (m["tbl"], m["pre"], m["q_starts"], m["q_lens"], m["kv_lens"])
    kps, vps = [pool[0].clone() for _ in fused], [pool[1].clone()
                                                  for _ in fused]
    reset_launch_counts()
    got = pmk.fused_prefill_model(fused, h, kps, vps, *meta, **kw)[0]
    torch.cuda.synchronize()
    if LAUNCHES["prefill_megakernel"] != len(fused):
        raise AssertionError(f"fused_prefill_model: "
                             f"{LAUNCHES['prefill_megakernel']} launches, "
                             f"want {len(fused)}")
    want = h
    for lyr in fused:
        want = pmk._reference_prefill_layer(
            lyr, want, pool[0].clone(), pool[1].clone(), *meta,
            num_kv_heads=32, head_dim=128, page_size=PAGE, **kw)[0]
    err, tol = mega_err(torch, got, want, "prefill megakernel model scope")
    worst = max(worst, err)
    log(f"[parity] prefill_megakernel model scope, 2 7B layers, bf16: one "
        f"launch per layer; max|kernel - plain| h {err:.3e} (tol {tol:.3e})")
    del fused, pool, kps, vps
    torch.cuda.empty_cache()
    return worst


#: the fused engines of phase [7b-fused]: knobs, the launches per layer and
#: ragged step (every other count 0), and the unfused run of this call
#: they are compared with
FUSED_RUNS = {
    "bf16": (dict(prefill_megakernel="fused"), {"prefill_megakernel": 1},
             "bf16"),
    "w8_kv8": (dict(prefill_megakernel="fused",
                    quantized_mode="weight_only_int8", kv_cache_dtype="int8"),
               {"prefill_megakernel": 1, "int8_matmul": 1}, "w8_kv8"),
}


def phase_serve_7b_fused(torch, model, unfused, burst):
    """Phase [7b-fused]: the 7B load through ``prefill_megakernel="fused"``
    (bf16; int8 weights + int8 pool; bf16 in bursts of 8 at model scope),
    beside the unfused runs of this call. Greedy tokens shared with them
    are informational."""
    runs = {}
    greedy = [i for i in range(len(SERVE_LENS) + 1) if i not in SERVE_SAMPLED]

    def share(a, b):
        same = sum(x == y for i in greedy for x, y in zip(a[i], b[i]))
        return same, sum(len(a[i]) for i in greedy)

    for tag, (knobs, per_step, ref) in FUSED_RUNS.items():
        run = serve_7b(torch, model, f"7b-fused {tag}", per_step, **knobs)
        base = unfused[ref]
        same, total = share(run["tokens"], base["tokens"])
        log(f"[7b-fused {tag}] prefill {run['prefill_tok_s']:.1f} tokens/s, "
            f"decode {run['decode_ms']:.2f} ms/step; the unfused {ref} run "
            f"of this call: {base['prefill_tok_s']:.1f} tokens/s, "
            f"{base['decode_ms']:.2f} ms/step; greedy tokens equal to it: "
            f"{same} of {total} (informational)")
        runs[tag] = run
    run = serve_7b_burst(torch, model, "7b-fused bf16 burst model",
                         dict(megakernel_scope="model",
                              prefill_megakernel="fused"))
    base = burst["bf16 model"]
    same, total = share(run["tokens"], base["tokens"])
    log(f"[7b-fused bf16 burst model] decode {run['decode_ms_per_token']:.3f} "
        f"ms per generated token; the unfused burst run of this call: "
        f"{base['decode_ms_per_token']:.3f}; greedy tokens equal to it: "
        f"{same} of {total} (informational)")
    runs["bf16 burst model"] = run
    return runs


# ---------------------------------------------------------------------------
# [graphs]: each main path captured into CUDA graphs against its eager run
# ---------------------------------------------------------------------------

W8_KV8 = dict(quantized_mode="weight_only_int8", kv_cache_dtype="int8")

#: the serving paths of phase [graphs]: engine knobs
GRAPH_SERVE_RUNS = {
    "bf16": {},
    "w8_kv8": W8_KV8,
    "w4_kv8": dict(quantized_mode="weight_only_int4", kv_cache_dtype="int8"),
    "fused bf16": dict(prefill_megakernel="fused"),
    "fused w8_kv8": dict(prefill_megakernel="fused", **W8_KV8),
    "burst bf16 layer": dict(burst_tokens=BURST_TOKENS,
                             megakernel_scope="layer"),
    "burst bf16 model": dict(burst_tokens=BURST_TOKENS,
                             megakernel_scope="model"),
    "burst w8_kv8 layer": dict(burst_tokens=BURST_TOKENS,
                               megakernel_scope="layer", **W8_KV8),
    "burst w8_kv8 model": dict(burst_tokens=BURST_TOKENS,
                               megakernel_scope="model", **W8_KV8),
}


def graph_stats(cache):
    """A GraphCache's keys, capture ms per key, pool bytes and calls."""
    return dict(keys=len(cache.keys),
                capture_ms={str(k): v for k, v in cache.capture_ms().items()},
                pool_bytes=cache.pool_bytes(), calls=dict(cache.calls))


def check_graph_calls(tag, stats):
    """Python ran the owner's step only to warm up and to capture: one
    warm-up per key, one capture per key, no eager call, a replay."""
    c = stats["calls"]
    if c["eager"] or c["warmup"] != stats["keys"] or \
            c["capture"] != len(stats["capture_ms"]) or not c["replay"]:
        raise AssertionError(f"[graphs {tag}] the captured run's calls {c} "
                             f"({stats['keys']} keys): a step ran Python "
                             f"outside its warm-up and capture")


#: new tokens per request in phase [graphs]: enough bursts of 8 that
#: several replay after each burst key's warm-up and capture
GRAPH_NEW_TOKENS = 64


def graphs_serve(torch, model, tag, knobs, captured, trace_at=None):
    """The 7B load (:func:`serve_prompts`, ``GRAPH_NEW_TOKENS`` new tokens
    each) through ``LLMEngine(**knobs)`` with capture on or off
    (``jit.enable_to_static``): per step its host time (synchronised),
    its kind (prefill tokens, 0 for a decode step, -1 for a burst) and
    what the graph cache did; each graph call's outputs (the ragged
    step's logits, tokens and row guard, a burst's tokens) as device
    copies; the
    launch counts, tokens and the pools after the load. The captured run
    traces 4 decode steps (2 bursts) once a decode step has replayed;
    ``trace_at``, the steps (first, last) to trace, makes the eager run
    trace the same ones."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import jit
    from paddle_tpu_torch.kernels import LAUNCHES, reset_launch_counts
    jit.enable_to_static(captured)
    try:
        eng = pt.LLMEngine(model, max_len=1024, page_size=16,
                           max_num_seqs=8, **knobs)
        V = model.config.vocab_size
        prompts, late = serve_prompts(V)
        cache, outs, kinds, modes = eng.graphs, [], [], []
        orig = eng.scheduler.prepare_step

        def prepare_step():
            plan = orig()
            if plan is not None:
                kinds.append(sum(q for s, _, q in plan.rows
                                 if s.cached_len < len(s.prompt_ids)))
            return plan

        # host clock marks per step: the launch entered, the graph call
        # entered and returned, the launch returned; CUDA events per step
        # around the graph call (with its outputs' copies)
        marks, events = [], []

        def event():
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e

        def record(key, *a, **k):
            marks[-1].append(time.perf_counter())
            events.append([event()])
            out = cache(key, *a, **k)
            marks[-1].append(time.perf_counter())
            if key[0] == "burst":
                kinds.append(-1)
            modes.append(cache.last_mode)
            leaves = out if isinstance(out, tuple) else (out,)
            outs.append([t.clone() for t in leaves])
            events[-1].append(event())
            return out

        def timed(launch):
            def run(*a, **k):
                marks.append([time.perf_counter()])
                out = launch(*a, **k)
                marks[-1].append(time.perf_counter())
                return out
            return run

        eng.scheduler.prepare_step = prepare_step
        eng.graphs = record
        eng._launch = timed(eng._launch)
        eng._launch_burst = timed(eng._launch_burst)
        new = GRAPH_NEW_TOKENS
        rids = [eng.add_request(p, max_new_tokens=new, **(
            dict(temperature=0.8, top_k=50, seed=100 + i)
            if i in SERVE_SAMPLED else {})) for i, p in enumerate(prompts)]
        reset_launch_counts()
        step_s, tok, prof, traced, breakdown = [], [], None, [], None
        spans = []
        want_traced = TRACED_BURSTS if "burst_tokens" in knobs \
            else PROFILED_STEPS
        while eng.has_unfinished():
            if len(rids) == len(prompts) and \
                    eng.outputs()[rids[1]].token_ids:
                rids.append(eng.add_request(late, max_new_tokens=new))
            n = len(step_s)
            if trace_at is None:
                start = not traced and len(rids) > len(prompts) and \
                    kinds and kinds[-1] <= 0 and modes[-1] == "replay"
            else:
                start = n == trace_at[0]
            if prof is None and start:
                prof = torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA])
                prof.start()
            tok0 = eng.metrics.tokens_generated.value
            t = time.perf_counter()
            eng.step()
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t)
            tok.append(eng.metrics.tokens_generated.value - tok0)
            t0, t1, t2, t3 = marks[-1]
            # ms: scheduling before the launch, packing (and the sampled
            # rows' uniform draws) before the graph call, the call (a
            # replay's enqueue and output copies), the wait for the
            # device and the read-back, the commit after the launch; and
            # the graph call's span on the device
            ev = events[-1]
            spans.append((t0 - t, t1 - t0, t2 - t1, t3 - t2,
                          t + step_s[-1] - t3,
                          1e-3 * ev[0].elapsed_time(ev[1])))
            if prof is not None:
                traced.append(n)
                if (len(traced) == want_traced if trace_at is None
                        else n == trace_at[1]) or not eng.has_unfinished():
                    prof.stop()
                    breakdown = report_profile(
                        torch, prof, [step_s[i] for i in traced],
                        f"graphs {tag} {'captured' if captured else 'eager'}"
                        f": {len(traced)} traced steps {traced} (kinds "
                        f"{[kinds[i] for i in traced]})",
                        {"matmuls": is_gemm})
                    prof = None
            if len(step_s) > 2000:
                raise AssertionError(f"[graphs {tag}] the load did not "
                                     f"drain")
        launches = dict(LAUNCHES)
        res = eng.outputs()
        eng.pool.check_invariants()
        for r in rids:
            if res[r].status != "finished" or len(res[r].token_ids) != new:
                raise AssertionError(f"[graphs {tag}] {r}: {res[r]}")
        pools = [t.clone() for pair in eng.pool.kv for t in pair]
        if eng.pool.quantized:
            pools += [t.clone() for pair in eng.pool.kv_scales for t in pair]
        stats = graph_stats(cache)
        del eng
        return dict(tokens=[res[r].token_ids for r in rids], outs=outs,
                    pools=pools, launches=launches, step_s=step_s, tok=tok,
                    kinds=kinds, modes=modes, traced=traced, spans=spans,
                    profile=breakdown, graphs=stats)
    finally:
        jit.enable_to_static(True)


def graph_times(run, skip):
    """Host ms per decode step, per burst and per generated token in
    bursts, and over every step, leaving out the steps ``skip``."""
    def mean(idx):
        return 1e3 * sum(run["step_s"][i] for i in idx) / len(idx) \
            if idx else None
    idx = [i for i in range(len(run["step_s"])) if i not in skip
           and i not in run["traced"]]
    bursts = [i for i in idx if run["kinds"][i] < 0]
    btok = sum(run["tok"][i] for i in bursts)
    decode = [i for i in idx if run["kinds"][i] == 0]

    def spans(sel):
        return [1e3 * sum(run["spans"][i][j] for i in sel) / len(sel)
                for j in range(6)] if sel else None
    return dict(decode_ms=mean(decode),
                decode_spans_ms=spans(decode), burst_spans_ms=spans(bursts),
                burst_ms=mean(bursts),
                burst_ms_per_token=1e3 * sum(run["step_s"][i]
                                             for i in bursts) / btok
                if btok else None,
                step_ms=mean(idx), steps=len(idx))


def fmt_ms(x):
    return "none" if x is None else f"{x:.2f}"


def phase_graphs_serve(torch, model):
    """Phase [graphs], serving: every path of ``GRAPH_SERVE_RUNS``
    captured and then eager on the same weights and requests. Bitwise:
    tokens, every graph call's outputs, pool pages and scales; launches
    equal; Python ran only to warm up and capture. Host times leave out
    the steps that warmed up or captured a key (in both runs), and the
    traced ones."""
    import gc
    out = {}
    for tag, knobs in GRAPH_SERVE_RUNS.items():
        cap = graphs_serve(torch, model, tag, knobs, True)
        eager = graphs_serve(torch, model, tag, knobs, False,
                             trace_at=(cap["traced"][0], cap["traced"][-1])
                             if cap["traced"] else (-1, -1))
        same_outs = len(cap["outs"]) == len(eager["outs"]) and all(
            len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))
            for a, b in zip(cap["outs"], eager["outs"]))
        same_pools = all(torch.equal(a, b)
                         for a, b in zip(cap["pools"], eager["pools"]))
        steps = len(cap["step_s"])
        if cap["tokens"] != eager["tokens"] or not same_outs or \
                not same_pools or cap["launches"] != eager["launches"] or \
                steps != len(eager["step_s"]):
            raise AssertionError(
                f"[graphs {tag}] captured != eager: tokens "
                f"{cap['tokens'] == eager['tokens']}, outputs {same_outs}, "
                f"pools {same_pools}, launches {cap['launches']} vs "
                f"{eager['launches']}, steps {steps} vs "
                f"{len(eager['step_s'])}")
        check_graph_calls(tag, cap["graphs"])
        replayed = [m == "replay" for i, m in enumerate(cap["modes"])
                    if i in cap["traced"]]
        skip = {i for i, m in enumerate(cap["modes"]) if m != "replay"}
        row = {k: dict(graph_times(r, skip), profile=r["profile"])
               for k, r in (("eager", eager), ("captured", cap))}
        row["graphs"] = cap["graphs"]
        row["traced_steps_replayed"] = all(replayed)
        row["launches_per_step"] = {k: v / steps
                                    for k, v in cap["launches"].items() if v}
        out[tag] = row
        e, c = row["eager"], row["captured"]
        log(f"[graphs {tag}] bitwise equal: tokens, {len(cap['outs'])} "
            f"graph outputs, {len(cap['pools'])} pool tensors; launches "
            f"equal ({ {k: v for k, v in cap['launches'].items() if v} } "
            f"over {steps} steps); eager -> "
            f"captured host ms (synchronised per step, the {len(skip)} "
            f"warm-up and capture steps left out): decode step "
            f"{fmt_ms(e['decode_ms'])} -> {fmt_ms(c['decode_ms'])}, burst "
            f"{fmt_ms(e['burst_ms'])} -> {fmt_ms(c['burst_ms'])} "
            f"({fmt_ms(e['burst_ms_per_token'])} -> "
            f"{fmt_ms(c['burst_ms_per_token'])} per token), every step "
            f"{fmt_ms(e['step_ms'])} -> {fmt_ms(c['step_ms'])}; captured "
            f"host spans (schedule, pack, graph call, wait + read-back, "
            f"commit) and the graph call's device span (with its "
            f"outputs' copies) per decode step "
            f"{[round(x, 3) for x in c['decode_spans_ms'] or []]}, per "
            f"burst {[round(x, 3) for x in c['burst_spans_ms'] or []]}; "
            f"{cap['graphs']['keys']} keys, capture ms "
            f"{cap['graphs']['capture_ms']}, graph pool "
            f"{cap['graphs']['pool_bytes']} bytes; traced steps all "
            f"replays: {row['traced_steps_replayed']}")
        del eager, cap
        gc.collect()
        torch.cuda.empty_cache()
    return out


def phase_time_prefill(torch):
    """Row 11 at the 7B T = 128 mixed step: the kernel per layer (bf16
    weights and pool; int8 weights and pool, whose whole layer call also
    runs the k|v projection and the append outside the kernel) beside its
    bound, its plain version and the unfused ragged layer on the same
    inputs (cuBLAS or the dequant-matmul for the projections, the ragged
    kernel, elementwise), and where a launch's time goes."""
    from paddle_tpu_torch.kernels import prefill_megakernel as pmk
    from paddle_tpu_torch.models.llama import llama2_7b_config
    from paddle_tpu_torch.serving.engine import (_chunk_append_fn,
                                                 _ragged_int8_layer)
    from paddle_tpu_torch.serving.spec_decode import (_ragged_fp_layer,
                                                      _ragged_packing)
    cfg = llama2_7b_config()
    kw = dict(eps=cfg.rms_norm_eps, num_heads=32, q_block=8)
    D, Hd, F, dh = 4096, 4096, 11008, 128
    rows = [r for r in PREFILL_7B_ROWS if r[0]]
    live = sum(ql for ql, _ in rows)
    seen = sum(kl - ql + i + 1 for ql, kl in rows for i in range(ql))
    out = {}
    for label, quant in (("bf16", False), ("int8", True)):
        lyr = mega_layers(torch, 1, quant, seed=51)[0]
        fused = pmk.fuse_layer_weights(lyr)
        h, pool, m, append = prefill_inputs(torch, quant, seed=52)
        kp, vp, ks, vs = pool
        meta = (m["tbl"], m["pre"], m["q_starts"], m["q_lens"], m["kv_lens"])
        kw_kv = dict(k_scales=ks, v_scales=vs,
                     quant_append_fn=_chunk_append_fn(append)) if quant else {}
        layer = lambda: pmk.fused_prefill_layer(     # noqa: E731
            fused, h, kp, vp, *meta, **kw, **kw_kv)
        kern = lambda: pmk._launch_cuda(             # noqa: E731
            fused, h, kp, vp, ks, vs, *meta, **kw)
        plain = lambda: pmk._reference_prefill_layer(  # noqa: E731
            fused, h, kp, vp, *meta, num_kv_heads=32, head_dim=dh,
            page_size=PAGE, **kw, **kw_kv)
        err = mega_err(torch, layer()[0], plain()[0], "prefill megakernel")[0]
        ms = time_ms(torch, kern, 30)
        layer_ms = time_ms(torch, layer, 30, "fused prefill layer",
                           waits_ok=True)
        plain_ms = time_ms(torch, plain, 5, "prefill megakernel plain",
                           waits_ok=True)
        if quant:
            unfused = lambda: _ragged_int8_layer(    # noqa: E731
                lyr, h, kp, ks, vp, vs, m["positions"], m["tbl"],
                m["q_starts"], m["q_lens"], m["kv_lens"], cfg, 8, append,
                block_row=m["pre"].block_row)
        else:
            tok_row, lv = _ragged_packing(m["q_starts"], m["q_lens"], STEP_T)
            unfused = lambda: _ragged_fp_layer(      # noqa: E731
                lyr, h, kp, vp, m["positions"], m["tbl"], tok_row, lv,
                m["q_starts"], m["q_lens"], m["kv_lens"], cfg, PAGE,
                PAGES_PER_SEQ, 8, block_row=m["pre"].block_row)
        unfused_ms = time_ms(torch, unfused, 30, "unfused ragged layer",
                             waits_ok=True)
        # the kernel's own work: every projection but, for an int8 pool,
        # the k and v ones (run outside it); the live rows' pages read, the
        # live tokens' fresh K/V written (fp pool), h read and written
        cols = {"qkv": Hd if quant else 3 * Hd, "o": D, "gateup": 2 * F,
                "down": D}
        rows_in = {"qkv": D, "o": Hd, "gateup": D, "down": F}
        params = sum(rows_in[k] * cols[k] for k in cols)
        item = 1 if quant else 2
        wbytes = params * item + (4 * sum(cols.values()) if quant else 0)
        pages = sum(-(-kl // PAGE) for _, kl in rows)
        kv_bytes = pages * 32 * PAGE * dh * 2 * item \
            + (pages * 32 * 2 * 4 if quant else 0)
        if not quant:
            kv_bytes += live * 32 * dh * 2 * 2
        io = STEP_T * D * 2 * 2
        flops = 2 * live * params + 4 * seen * dh * 32
        bms, by = bound_ms(wbytes + kv_bytes + io, flops)
        stamps = torch.zeros(1 + len(pmk.PHASES), dtype=torch.int64,
                             device="cuda")
        phases = dict.fromkeys(pmk.PHASES, 0.0)
        for _ in range(10):
            pmk._launch_cuda(fused, h, kp, vp, ks, vs, *meta, stamps=stamps,
                             **kw)
            t = stamps.tolist()
            for i, name in enumerate(pmk.PHASES):
                phases[name] += (t[i + 1] - t[i]) / 1e6 / 10
        out[label] = dict(ms=ms, layer_ms=layer_ms, plain_ms=plain_ms,
                          bound_ms=bms, bound_by=by,
                          unfused_layer_ms=unfused_ms,
                          max_abs_err=err, weight_bytes=wbytes,
                          kv_bytes=kv_bytes, phase_ms=phases)
        log(f"[time] prefill_megakernel 7B layer, {label} weights + {label} "
            f"pool, T {STEP_T} mixed step ({live} live tokens): kernel "
            f"{ms:.4f} ms, bound {bms:.4f} ms ({by}: weights "
            f"{wbytes / 1e6:.2f} MB + K/V {kv_bytes / 1e6:.2f} MB, "
            f"{flops / 1e9:.1f} GFLOP), plain {plain_ms:.4f} ms, the unfused "
            f"ragged layer on the same inputs {unfused_ms:.4f} ms"
            + (f", the whole fused layer call (k|v projection and append "
               f"outside the kernel) {layer_ms:.4f} ms" if quant else "")
            + f", max|diff| {err:.3e}")
        log(f"[time] prefill_megakernel 7B layer, {label}: ms per phase, each "
            f"to the end of the barrier after it (device clock, 10 launches, "
            f"L2 warm): " + ", ".join(f"{k} {v:.4f}"
                                      for k, v in phases.items()))
        del lyr, fused, pool
        torch.cuda.empty_cache()
    return out


def main() -> int:
    if not (ROOT / "paddle_tpu_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke.py must run from a checkout of the repository",
              file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py runs on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"[card] {card}")
    phase_build()
    parity_err = phase_kernel_parity(torch)
    lowbit_err = phase_lowbit_parity(torch)
    flash_err = phase_flash_parity(torch)
    rms_parity = phase_rms_parity(torch)
    adamw_err = phase_adamw_parity(torch)
    mega_parity_err = phase_megakernel_parity(torch)
    prefill_parity_err = phase_prefill_parity(torch)
    phase_engine_parity(torch)
    phase_train_parity(torch)
    model = build_7b(torch)
    bf16 = serve_7b(torch, model, "7b", {"ragged_paged_attention": 1,
                                         **MERGE})
    low = phase_serve_7b_lowbit(torch, model, bf16)
    burst = phase_serve_7b_burst(torch, model, {"bf16": bf16, **low})
    fused = phase_serve_7b_fused(torch, model, {"bf16": bf16, **low}, burst)
    graphs = phase_graphs_serve(torch, model)
    del model
    torch.cuda.empty_cache()
    train = phase_train_125m(torch)
    train_1b = phase_train_1b(torch)
    times, times8 = phase_time_kernel(torch)
    matmul = phase_time_matmul(torch)
    phase_time_append(torch)
    flash = phase_time_flash(torch)
    adamw_all = phase_time_adamw(torch, {"llama_125m": train["n_params"],
                                         "llama_1b": train_1b["n_params"]})
    adamw = adamw_all["llama_125m"]
    mega = phase_time_megakernel(torch)
    prefill = phase_time_prefill(torch)
    rms = phase_time_rms(torch)
    dec, pre = times["decode"], times["prefill"]
    src = "paddle_tpu_torch/kernels/csrc/"
    shape = "llama_125m step (b 8, h 12, s 1024, d 64, bf16, causal)"
    kernels = [{
        "name": "ragged_paged_attention",
        "route": "cuda",
        "source": src + "ragged_paged_attention.cu",
        "replaces": "paddle_tpu/kernels/paged_attention.py:53",
        "launches": bf16["launches"]["ragged_paged_attention"],
        "max_abs_err": max(parity_err, dec["max_abs_err"],
                           pre["max_abs_err"]),
        "ms": dec["ms"], "plain_ms": dec["plain_ms"],
        "bound_ms": dec["bound_ms"], "bound_by": dec["bound_by"],
        "library_ms": dec["library_ms"],
        "shape": "7B decode step", "prefill_step": pre,
        "merge_launches": bf16["launches"]["ragged_paged_attention_merge"],
        "split_kernel_ms": dec["split_kernel_ms"], "merge_ms": dec["merge_ms"],
    }]
    dec8, pre8 = times8["decode"], times8["prefill"]
    kernels.append({
        "name": "ragged_paged_attention_int8", "route": "cuda",
        "source": src + "ragged_paged_attention.cu",
        "replaces": "paddle_tpu/kernels/paged_attention.py:124",
        "launches": low["w8_kv8"]["launches"]["ragged_paged_attention_int8"],
        "max_abs_err": max(lowbit_err["ragged_paged_attention_int8"],
                           dec8["max_abs_err"], pre8["max_abs_err"]),
        "ms": dec8["ms"], "plain_ms": dec8["plain_ms"],
        "bound_ms": dec8["bound_ms"], "bound_by": dec8["bound_by"],
        "library_ms": dec8["library_ms"], "fp_kernel_ms": dec["ms"],
        "shape": "7B decode step, int8 pool", "prefill_step": pre8,
        "merge_launches": low["w8_kv8"]["launches"]
        ["ragged_paged_attention_merge"],
        "split_kernel_ms": dec8["split_kernel_ms"],
        "merge_ms": dec8["merge_ms"],
    })
    rows, yard = flash["125m"]
    rows_1b, yard_1b = flash["1b"]
    for name, key, line, plain, library in (
            ("flash_attention_fwd", "fwd", 47, "plain_fwd", "sdpa_fwd"),
            ("flash_attention_bwd_dq", "dq", 143, "plain_bwd", None),
            ("flash_attention_bwd_dkv", "dkv", 182, "plain_bwd", None)):
        row, row_1b = rows[key], rows_1b[key]
        kernels.append({
            "name": name, "route": "cuda",
            "source": src + "flash_attention.cu",
            "replaces": f"paddle_tpu/kernels/flash_attention.py:{line}",
            "launches": train["launches"][name],
            "max_abs_err": max(flash_err[name], row["max_abs_err"],
                               row_1b["max_abs_err"]),
            "ms": row["ms"], "plain_ms": yard[plain],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": library and yard[library], "shape": shape,
            "tflops": row["tflops"],
            "llama_1b": dict(
                ms=row_1b["ms"], plain_ms=yard_1b[plain],
                bound_ms=row_1b["bound_ms"], bound_by=row_1b["bound_by"],
                tflops=row_1b["tflops"],
                library_ms=library and yard_1b[library],
                launches=train_1b["launches"][name],
                shape="llama_1b step (b 1, hq 32, hkv 4, s 2048, d 64, "
                      "bf16, causal; dk/dv with its group sum)")})
        if library is None:
            # no single PyTorch call computes dq (or dk, dv) alone: the
            # backward rows carry SDPA's whole backward beside them, and
            # their plain time is the plain version's whole backward
            kernels[-1]["library_backward_ms"] = yard["sdpa_bwd"]
            kernels[-1]["llama_1b"]["library_backward_ms"] = \
                yard_1b["sdpa_bwd"]
    row = rows_1b["sum"]
    kernels.append({
        "name": "flash_attention_bwd_dkv_sum", "route": "cuda",
        "source": src + "flash_attention.cu",
        # the Pallas dk/dv kernel writes per query head; the group is
        # summed outside it
        "replaces": "paddle_tpu/kernels/flash_attention.py:313",
        "launches": train_1b["launches"]["flash_attention_bwd_dkv_sum"],
        "max_abs_err": max(flash_err["flash_attention_bwd_dkv_sum"],
                           row["max_abs_err"]),
        "ms": row["ms"], "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
        # no single PyTorch call sums the group in f32 and casts
        "library_ms": None,
        "shape": "llama_1b dk/dv partials [2, 1, 32, 2048, 64] f32 "
                 "(launches: 10 llama_1b steps)"})
    kernels.append({
        "name": "fused_adamw", "route": "cuda",
        "source": src + "fused_adamw.cu",
        "replaces": "paddle_tpu/kernels/fused_adamw.py:28",
        "launches": train["launches"]["fused_adamw"],
        "max_abs_err": max(adamw_err, adamw["max_abs_err"]),
        "ms": adamw["ms"], "plain_ms": adamw["plain_ms"],
        "bound_ms": adamw["bound_ms"], "bound_by": adamw["bound_by"],
        "library_ms": adamw["library_ms"],
        "shape": f"llama_125m bucket ({train['n_params']} f32)",
        "llama_1b": dict(adamw_all["llama_1b"],
                         launches=train_1b["launches"]["fused_adamw"],
                         shape=f"llama_1b bucket ({train_1b['n_params']} "
                               f"f32)")})
    for bits, line, run in ((8, 61, "w8_kv8"), (4, 80, "w4_kv8")):
        row = matmul[bits]
        name = f"int{bits}_matmul"
        kernels.append({
            "name": name, "route": "cuda", "source": src + "int8_matmul.cu",
            "replaces": f"paddle_tpu/kernels/int8_matmul.py:{line}",
            "launches": low[run]["launches"][name],
            "max_abs_err": max(lowbit_err[name], row["max_abs_err"]),
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            "shape": f"one 7B layer's 7 projections at M = {STEP_M}, bf16",
            "shapes": row["shapes"]})
    m = mega["bf16"]
    kernels.append({
        "name": "decode_megakernel", "route": "cuda",
        "source": src + "decode_megakernel.cu",
        "replaces": "paddle_tpu/kernels/decode_megakernel.py:185",
        "launches": burst["bf16 layer"]["launches"]["decode_megakernel"],
        "max_abs_err": max(mega_parity_err, m["max_abs_err"],
                           mega["int8"]["max_abs_err"]),
        "ms": m["ms"], "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
        "bound_by": m["bound_by"], "library_ms": None,
        # no single PyTorch call computes a decoder layer: the per-token
        # path's time for the same layer stands beside it
        "per_token_layer_ms": m["per_token_layer_ms"],
        "phase_ms": m["phase_ms"], "phase_bound_ms": m["phase_bound_ms"],
        "matmul_yardstick_ms": m["matmul_yardstick_ms"],
        "shape": "one 7B layer, 8 decode rows (kv 49-632), bf16, the "
                 "layer-scope burst's launch (append_at)",
        "int8": mega["int8"],
        "model_scope_launches": burst["bf16 model"]["launches"]
        ["decode_megakernel"],
        "burst": {k: dict(decode_ms_per_token=v["decode_ms_per_token"],
                          bursts=v["bursts"], iterations=v["iterations"],
                          profile=v["profile"])
                  for k, v in burst.items()}})
    pm = prefill["bf16"]
    kernels.append({
        "name": "prefill_megakernel", "route": "cuda",
        "source": src + "prefill_megakernel.cu",
        "replaces": "paddle_tpu/kernels/prefill_megakernel.py:342",
        "launches": fused["bf16"]["launches"]["prefill_megakernel"],
        "max_abs_err": max(prefill_parity_err, pm["max_abs_err"],
                           prefill["int8"]["max_abs_err"]),
        "ms": pm["ms"], "plain_ms": pm["plain_ms"],
        "bound_ms": pm["bound_ms"], "bound_by": pm["bound_by"],
        "library_ms": None,
        # no single PyTorch call computes a decoder layer: the unfused
        # ragged layer's time on the same inputs stands beside it
        "unfused_layer_ms": pm["unfused_layer_ms"],
        "shape": f"one 7B layer, T = {STEP_T} mixed step {PREFILL_7B_ROWS}, "
                 f"bf16",
        "int8": prefill["int8"], "phase_ms": pm["phase_ms"],
        "engines": {k: {key: v.get(key) for key in (
            "steps", "ragged_steps", "prefill_tok_s", "decode_ms",
            "decode_ms_per_token", "launches", "profile")}
            for k, v in fused.items()}})
    for name, key, line in (("rms_norm_fwd", "fwd", 30),
                            ("rms_norm_bwd", "bwd", 38)):
        row, small = rms["1b"][key], rms["125m"][key]
        kernels.append({
            "name": name, "route": "cuda", "source": src + "rms_norm.cu",
            "replaces": f"paddle_tpu/kernels/rms_norm.py:{line}",
            "launches": train_1b["launches"][name],
            "max_abs_err": max(rms_parity[name], row["max_abs_err"],
                               small["max_abs_err"]),
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            "shape": "llama_1b norm [2048, 2048] f32 (launches: 10 "
                     "llama_1b steps)",
            "llama_125m": dict(small, launches=train["launches"][name],
                               shape="[8192, 768] f32 (launches: 10 "
                                     "llama_125m steps)")})
    graphs["train 125m"] = train["graph_run"]
    graphs["train 1b"] = train_1b["graph_run"]
    log("[graphs] summary " + json.dumps(graphs, default=str))
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
