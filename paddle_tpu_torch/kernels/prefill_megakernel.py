"""Ragged prefill megakernel — counterpart of
``paddle_tpu/kernels/prefill_megakernel.py``.

One launch per decoder layer over a ragged step's packed chunk (prefill
chunks, continuation chunks and decode rows alike):

    rms_norm -> fused q|k|v projection -> rope at each token's position
    (phase tables computed once per step) -> the chunk's K/V written
    into its pool slots (fp pools) -> causal ragged paged attention
    (int8 pages x per-(head, page) scales) -> o projection -> residual ->
    rms_norm -> fused gate|up projection -> silu(gate) * up -> down ->
    residual

:func:`fuse_layer_weights` concatenates q|k|v and gate|up column by
column, which is exact for fp and int8 weights (every int8 scale belongs
to one output column); int4 and mixed layouts give None and the engine
keeps its unfused layer bodies. :func:`ragged_prologue` computes the
layer-invariant part once per step: the rope tables at the packed
positions, each token's pool slot (dead tokens: the null page) and the
q block -> row map.

An int8 pool keeps the append outside the kernel, as the reference
does: the wrapper projects k and v from column slices of the fused
weight, ropes them and runs the caller's ``quant_append_fn`` (the
running-amax requantizing append) before the launch; the kernel then
only reads pages and scales.

Two implementations of one function:

- :func:`_reference_prefill_layer`, plain PyTorch: the reference's jnp
  body rounding for rounding, over the port's ``_rms_norm``, the plain
  projection (``x @ w``, or the plain dequant-matmul) and the plain
  ragged attention — off the TPU the JAX engine runs exactly that body;
- the CUDA kernel ``csrc/prefill_megakernel.cu`` (see its header): one
  persistent launch per layer, in clusters, whose seven phases are split
  by grid-wide barriers: projections on wgmma fed by TMA rings with their
  epilogues (rope and the pool write, silu * up, the residuals) in
  registers, attention on mma.sync.

The wrappers choose by where ``h`` lies: a CPU tensor runs the plain
version, a CUDA tensor launches the kernel or raises. There is no
fallback between the two: :func:`prefill_fallback_tripped` is always
False. :func:`fused_prefill_model` runs the layer once per layer (the
counterpart of the reference's scan): L launches per ragged step.
"""
from __future__ import annotations

import collections
import ctypes

import torch
import torch.nn.functional as F

from . import LAUNCHES, check_not_capturing, keep_alive
from ..quantization.low_bit import QuantizedWeight
from .decode_megakernel import (_DTYPE_CODE, _barrier, _check, _grid,
                                _per_layer, _plain_wmat, _unstack_layers)

#: the null pool page (``serving.kv_cache.NULL_PAGE``): dead tokens' slot
_NULL_PAGE = 0

#: the fused projection layout: q|k|v and gate|up are concat-dots, o and
#: down single matrices
_FUSED_MATS = ("qkv", "o", "gateup", "down")

#: the kernel's phases per launch, in order (``stamps`` of a launch)
PHASES = ("norm", "q|k|v", "attention", "o", "h2+norm", "gate|up", "down")


def _chk(name, x, dtype, shape, device, align=16):
    return _check(name, x, dtype, shape, device, align,
                  kernel="prefill_megakernel")


def prefill_fallback_tripped() -> bool:
    """Always False: no launch is ever rerouted to the plain body."""
    return False


def reset_prefill_fallback() -> None:
    """Nothing to reset (kept for the reference's API)."""


def _fused_kernel_ready(fused):
    """``"fp"`` for plain fused weights, ``"int8"`` for all-int8
    ``QuantizedWeight``s; None for None, int4 or mixed layouts."""
    if fused is None:
        return None
    kinds = set()
    for k in _FUSED_MATS:
        w = fused[k]
        if isinstance(w, QuantizedWeight):
            if w.bits != 8:
                return None
            kinds.add("int8")
        else:
            kinds.add("fp")
    return kinds.pop() if len(kinds) == 1 else None


def prefill_megakernel_mode(fused, device) -> str:
    """How :func:`fused_prefill_layer` runs ``fused`` on ``device``:
    ``"cuda"`` (the kernel) or ``"plain"`` (the PyTorch body: CPU
    tensors, or a layout with no fused geometry)."""
    if _fused_kernel_ready(fused) is None:
        return "plain"
    return "cuda" if torch.device(device).type == "cuda" else "plain"


def fuse_layer_weights(layer):
    """One decoder layer's projections in the fused layout ``{ln1, ln2,
    qkv, o, gateup, down}``: q|k|v and gate|up concatenated along their
    output columns (byte-identical to the reference's). int4 and mixed
    layouts have no column-exact concat: None."""
    def kind(w):
        if isinstance(w, QuantizedWeight):
            return "int8" if w.bits == 8 else None
        return "fp"

    kinds = {kind(layer[k]) for k in
             ("q", "k", "v", "o", "gate", "up", "down")}
    if len(kinds) != 1 or None in kinds:
        return None

    def cat(keys):
        ws = [layer[k] for k in keys]
        if isinstance(ws[0], QuantizedWeight):
            return QuantizedWeight.concat_columns(ws)
        return torch.cat(ws, 1)

    return {"ln1": layer["ln1"], "ln2": layer["ln2"],
            "qkv": cat(("q", "k", "v")), "o": layer["o"],
            "gateup": cat(("gate", "up")), "down": layer["down"]}


#: the layer-invariant ragged prologue, computed once per step and shared
#: by every layer: rope phase tables at the packed positions, each token's
#: pool slot (dead tokens -> the null page) and the q block -> row map
RaggedPrologue = collections.namedtuple(
    "RaggedPrologue", ["cos", "sin", "slot", "block_row"])


def _rank_right(q_starts, v):
    """``searchsorted(q_starts, v, right=True) - 1`` clamped at 0, as one
    broadcast compare-sum (the same integers for ascending starts)."""
    rank = (q_starts[None, :] <= v[:, None]).sum(1, dtype=torch.int32) - 1
    return rank.clamp_min(0)


def ragged_prologue(positions, tbls, q_starts, q_lens, *, theta, head_dim,
                    page_size, max_pages, q_block):
    """The :class:`RaggedPrologue` of one ragged step: ``cos``/``sin``
    ``[1, T, 1, d/2]`` f32 (``models.generation._rope``'s tables),
    ``slot [T]`` int32 (``page * page_size + position % page_size``, the
    null page for dead tokens) and ``block_row [T // q_block]`` int32."""
    d = head_dim
    T = positions.shape[0]
    dev = positions.device
    inv_freq = 1.0 / (theta ** (torch.arange(
        0, d, 2, dtype=torch.float32, device=dev) / d))
    ang = positions[None].to(torch.float32)[..., None] * inv_freq
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    q_starts = q_starts.to(torch.int32)
    tok_row = _rank_right(q_starts, torch.arange(T, dtype=torch.int32,
                                                 device=dev)).long()
    live = (torch.arange(T, device=dev) - q_starts[tok_row]) \
        < q_lens[tok_row]
    page_idx = (positions // page_size).clamp(0, max_pages - 1).long()
    page = torch.where(live, tbls[tok_row, page_idx],
                       torch.full_like(positions, _NULL_PAGE))
    slot = (page * page_size + positions % page_size).to(torch.int32)
    block_row = _rank_right(q_starts, torch.arange(
        T // q_block, dtype=torch.int32, device=dev) * q_block)
    return RaggedPrologue(cos, sin, slot, block_row)


def rope_apply(x, cos, sin):
    """Apply precomputed interleaved-pair phase tables: the apply half of
    ``models.generation._rope``, in f32, returned in x's dtype."""
    x1 = x[..., ::2].to(torch.float32)
    x2 = x[..., 1::2].to(torch.float32)
    o1 = x1 * cos - x2 * sin
    o2 = x2 * cos + x1 * sin
    return torch.stack([o1, o2], dim=-1).reshape(x.shape).to(x.dtype)


def _slice_qkv(fused):
    """``sl(lo, hi)``: columns ``lo:hi`` of the fused q|k|v weight as a
    weight of their own, a view of the fused one (int8: the payload's
    column slice, read in place by the dequant-matmul, and its scales)."""
    w = fused["qkv"]
    if isinstance(w, QuantizedWeight):
        def sl(lo, hi):
            return QuantizedWeight(w.qdata[:, lo:hi],
                                   w.scale.reshape(-1)[lo:hi], w.bits,
                                   w.rows)
        return sl

    def sl(lo, hi):
        return w[:, lo:hi]
    return sl


def _reference_prefill_layer(fused, h, Kp, Vp, tbls, pre, q_starts, q_lens,
                             kv_lens, *, eps, num_heads, num_kv_heads,
                             head_dim, page_size, q_block, k_scales=None,
                             v_scales=None, quant_append_fn=None):
    """Plain PyTorch fused layer body, rounded where the reference's
    ``_reference_prefill_layer`` rounds. An fp pool takes the chunk's K/V
    at ``pre.slot`` in place (dead tokens: the null page); an int8 pool
    goes through ``quant_append_fn`` before the attention. Returns
    ``(h, Kp, Vp, k_scales, v_scales)``."""
    from ..models.generation import _rms_norm
    from .paged_attention import ragged_paged_attention_reference
    H, Hkv, d = num_heads, num_kv_heads, head_dim
    T = h.shape[1]
    Fh = fused["gateup"].shape[-1] // 2
    x = _rms_norm(h, fused["ln1"], eps)
    qkv = _plain_wmat(x, fused["qkv"])
    q = qkv[..., :H * d].reshape(1, T, H, d)
    k = qkv[..., H * d:(H + Hkv) * d].reshape(1, T, Hkv, d)
    v = qkv[..., (H + Hkv) * d:].reshape(1, T, Hkv, d)
    q = rope_apply(q, pre.cos, pre.sin)
    k = rope_apply(k, pre.cos, pre.sin)
    kt = k[0].transpose(0, 1)                              # [Hkv, T, d]
    vt = v[0].transpose(0, 1)
    if quant_append_fn is not None:
        Kp, k_scales, Vp, v_scales = quant_append_fn(
            Kp, k_scales, Vp, v_scales, kt, vt)
    else:
        npages = Kp.shape[1]
        slot = pre.slot.long()
        Kp.view(Hkv, npages * page_size, d)[:, slot] = kt
        Vp.view(Hkv, npages * page_size, d)[:, slot] = vt
    o = ragged_paged_attention_reference(q[0], Kp, Vp, tbls, q_starts,
                                         q_lens, kv_lens, k_scales=k_scales,
                                         v_scales=v_scales)
    h = h + _plain_wmat(o.reshape(1, T, H * d), fused["o"])
    x = _rms_norm(h, fused["ln2"], eps)
    gu = _plain_wmat(x, fused["gateup"])
    h = h + _plain_wmat(F.silu(gu[..., :Fh]) * gu[..., Fh:], fused["down"])
    return h, Kp, Vp, k_scales, v_scales


def fused_prefill_layer(fused, h, Kp, Vp, tbls, pre, q_starts, q_lens,
                        kv_lens, *, eps, num_heads, q_block, k_scales=None,
                        v_scales=None, quant_append_fn=None):
    """One fused decoder layer over a packed ragged chunk.

    fused: :func:`fuse_layer_weights` result (fp or all-int8);
    h: [1, T, hidden]; Kp/Vp: [Hkv, num_pages, page_size, dh] pools (int8
        with ``k_scales``/``v_scales`` [Hkv, num_pages] f32); tbls: [R,
        PPS] int32; pre: the step's :class:`RaggedPrologue`;
    q_starts/q_lens/kv_lens: [R] int32 (kv_lens AFTER this step's
        appends; rows packed at q_block multiples, pad rows last at
        ``q_start = T``).
    quant_append_fn(Kp, Ks, Vp, Vs, kt, vt) -> (Kp, Ks, Vp, Vs): an int8
        pool's append, run before the attention (caller-owned). fp pools
        take the chunk's K/V in place.
    Returns ``(h, Kp, Vp, k_scales, v_scales)``; the pools are the
    caller's, updated in place.
    """
    if (k_scales is None) != (v_scales is None):
        raise ValueError("k_scales and v_scales must be given together")
    quant_kv = k_scales is not None
    if quant_kv and quant_append_fn is None:
        raise ValueError("int8 pools need quant_append_fn (the caller owns "
                         "the running-amax append)")
    Hkv, _, ps, dh = Kp.shape
    H = num_heads
    if h.device.type == "cpu":
        return _reference_prefill_layer(
            fused, h, Kp, Vp, tbls, pre, q_starts, q_lens, kv_lens, eps=eps,
            num_heads=H, num_kv_heads=Hkv, head_dim=dh, page_size=ps,
            q_block=q_block, k_scales=k_scales, v_scales=v_scales,
            quant_append_fn=quant_append_fn)
    if h.device.type != "cuda":
        raise ValueError(f"fused_prefill_layer runs on cuda or cpu tensors, "
                         f"got {h.device}")
    if quant_kv:
        # the append first, outside the kernel: k|v in one projection off
        # the fused weight's adjacent k and v columns (exact), roped, then
        # the caller's append
        from ..models.generation import _rms_norm, _wmat
        T = h.shape[1]
        x = _rms_norm(h, fused["ln1"], eps)
        kv = _wmat(x, _slice_qkv(fused)(H * dh, (H + 2 * Hkv) * dh))
        k = kv[..., :Hkv * dh].reshape(1, T, Hkv, dh)
        v = kv[..., Hkv * dh:].reshape(1, T, Hkv, dh)
        k = rope_apply(k, pre.cos, pre.sin)
        Kp, k_scales, Vp, v_scales = quant_append_fn(
            Kp, k_scales, Vp, v_scales, k[0].transpose(0, 1),
            v[0].transpose(0, 1))
    h_out = _launch_cuda(fused, h, Kp, Vp, k_scales, v_scales, tbls, pre,
                         q_starts, q_lens, kv_lens, eps=eps, num_heads=H,
                         q_block=q_block)
    return h_out, Kp, Vp, k_scales, v_scales


def fused_prefill_model(layers, h, k_pages, v_pages, tbls, pre, q_starts,
                        q_lens, kv_lens, *, eps, num_heads, q_block,
                        k_scales=None, v_scales=None, quant_append_fn=None):
    """The fused layer over every layer of the model, in order: one launch
    per layer on a CUDA device (the reference scans the same body).

    layers: a list of :func:`fuse_layer_weights` dicts or their
        ``stack_layer_params`` stack; k_pages/v_pages (and k_scales/
        v_scales): per-layer lists or ``[L, ...]`` stacks.
    Returns ``(h, k_pages, v_pages, k_scales, v_scales)`` in the form the
    pools came in (stacks are stacked anew; lists are updated in place).
    """
    stacked = isinstance(k_pages, torch.Tensor)
    lyrs = _unstack_layers(layers)
    n = len(lyrs)
    kps, vps = _per_layer(k_pages, n), _per_layer(v_pages, n)
    kss, vss = _per_layer(k_scales, n), _per_layer(v_scales, n)
    for i, lyr in enumerate(lyrs):
        h, kps[i], vps[i], ks, vs = fused_prefill_layer(
            lyr, h, kps[i], vps[i], tbls, pre, q_starts, q_lens, kv_lens,
            eps=eps, num_heads=num_heads, q_block=q_block,
            k_scales=None if kss is None else kss[i],
            v_scales=None if vss is None else vss[i],
            quant_append_fn=quant_append_fn)
        if kss is not None:
            kss[i], vss[i] = ks, vs
    if stacked:
        kps, vps = torch.stack(kps), torch.stack(vps)
        if kss is not None:
            kss, vss = torch.stack(kss), torch.stack(vss)
    return h, kps, vps, kss, vss


# ---------------------------------------------------------------------------
# the CUDA launch
# ---------------------------------------------------------------------------

#: tensor maps (128 bytes each) of weights and scratch buffers, keyed by
#: what they encode: (pointer, element bytes, columns, rows, row bytes,
#: box); encoded once, so a model-scope step encodes nothing
_TMAPS: "collections.OrderedDict" = collections.OrderedDict()
_MAX_TMAPS = 1024
#: the launch's scratch (x, q, o, act, h2) and its tensor maps, per
#: (device, dtype, T, D, H dh, F): launches on a stream run one after the
#: other, so they share it
_SCRATCH: "collections.OrderedDict" = collections.OrderedDict()
_MAX_SCRATCH = 8


def _tmap(lib, x, cols, rows, box_cols, box_rows):
    """The tensor map of a row-major ``[rows, cols]`` bf16 or int8 tensor
    ``x`` in boxes of ``box_cols x box_rows`` (128- or 64-byte swizzle)."""
    es = x.element_size()
    key = (x.data_ptr(), es, cols, rows, box_cols, box_rows)
    m = _TMAPS.get(key)
    if m is None:
        buf = ctypes.create_string_buffer(128)
        err = lib.prefill_megakernel_encode(es, x.data_ptr(), cols, rows,
                                            cols * es, box_cols, box_rows,
                                            buf)
        if err != 0:
            raise RuntimeError(f"prefill_megakernel: tensor map encoding "
                               f"failed: CUDA error {err}")
        m = _TMAPS[key] = buf.raw
        while len(_TMAPS) > _MAX_TMAPS:
            _TMAPS.popitem(last=False)
    else:
        _TMAPS.move_to_end(key)
    return m


def _scratch(lib, dev, dtype, T, D, Hd, Fh, bm, bk):
    """``(buffers, maps)``: x, q, o, act (hidden type) and h2 (f32), and
    for bf16 the tensor maps of x, o and act (empty for f32)."""
    key = (dev.index, dtype, T, D, Hd, Fh)
    hit = _SCRATCH.get(key)
    if hit is None:
        check_not_capturing("the prefill megakernel's scratch")
        bufs = [torch.empty((T, n), dtype=dtype, device=dev)
                for n in (D, Hd, Hd, Fh)]
        bufs.append(torch.empty((T, D), dtype=torch.float32, device=dev))
        maps = b""
        if dtype == torch.bfloat16:
            maps = b"".join(_tmap(lib, b, n, T, bk, bm)
                            for b, n in ((bufs[0], D), (bufs[2], Hd),
                                         (bufs[3], Fh)))
        hit = _SCRATCH[key] = (bufs, maps)
        while len(_SCRATCH) > _MAX_SCRATCH:
            _SCRATCH.popitem(last=False)
    else:
        _SCRATCH.move_to_end(key)
    keep_alive(hit[0])        # a graph being captured keeps the buffers
    return hit


def _launch_cuda(fused, h, Kp, Vp, k_scales, v_scales, tbls, pre, q_starts,
                 q_lens, kv_lens, *, eps, num_heads, q_block, stamps=None):
    """Check every operand and launch the kernel for one layer. Returns
    ``h_out``; an fp pool takes the live tokens' K/V in place.
    ``stamps``: optional int64 ``[1 + len(PHASES)]`` receiving the device
    clock (ns) at the start and at the end of each phase of
    :data:`PHASES`."""
    dev = h.device
    dtype = h.dtype
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"prefill_megakernel takes float32 or bfloat16 hidden "
                        f"states, got {dtype}")
    kind = _fused_kernel_ready(fused)
    if kind is None:
        raise NotImplementedError(
            "prefill_megakernel takes fp or all-int8 fused weights; int4 and "
            "mixed layouts have no fused geometry (the engine serves them "
            "unfused)")
    quant_w = kind == "int8"
    quant_kv = k_scales is not None
    _, T, D = h.shape
    Hkv, P, ps, dh = Kp.shape
    H = num_heads
    R, pps = tbls.shape
    F2 = fused["gateup"].shape[1]
    lib = _library()
    limits = (ctypes.c_int * 9)()
    lib.prefill_megakernel_limits(limits)
    bm, bn, bk, _, max_dh, phases, max_blocks, max_rows, _ = list(limits)
    f32_rows = dtype == torch.float32 and H // Hkv * q_block > max_rows
    if H % Hkv or dh > max_dh or dh % 16 or q_block < 1 or T % q_block or \
            T // q_block > max_blocks or f32_rows:
        raise ValueError(f"prefill_megakernel takes head_dim <= {max_dh} (a "
                         f"multiple of 16), whole kv-head groups, T a "
                         f"multiple of q_block, at most {max_blocks} q blocks "
                         f"and, for float32, {max_rows} query rows per q "
                         f"block and kv head; got H {H}, Hkv {Hkv}, dh {dh}, "
                         f"T {T}, q_block {q_block}")
    Fh = F2 // 2
    step = 16 if quant_w else 8        # 16-byte rows for the tensor maps
    for n in (H * dh, Hkv * dh, D, Fh):
        if n % step:
            raise ValueError(f"prefill_megakernel needs every projection "
                             f"width a multiple of {step} "
                             f"({'int8' if quant_w else 'fp'} weights), got "
                             f"{n}")
    _chk("h", h, dtype, (1, T, D), dev)
    _chk("block_tables", tbls, torch.int32, (R, pps), dev, 4)
    for name, x in (("q_starts", q_starts), ("q_lens", q_lens),
                    ("kv_lens", kv_lens)):
        _chk(name, x, torch.int32, (R,), dev, 4)
    _chk("rope cos", pre.cos, torch.float32, (1, T, 1, dh // 2), dev, 4)
    _chk("rope sin", pre.sin, torch.float32, (1, T, 1, dh // 2), dev, 4)
    _chk("slot", pre.slot, torch.int32, (T,), dev, 4)
    _chk("block_row", pre.block_row, torch.int32, (T // q_block,), dev, 4)
    nqkv = (H + 2 * Hkv) * dh
    shapes = {"qkv": (D, nqkv), "o": (H * dh, D), "gateup": (D, F2),
              "down": (Fh, D)}
    ptrs = [_chk(k, fused[k], dtype, (D,), dev, 4)
            for k in ("ln1", "ln2")]
    scales, wmaps = [], []
    tc = dtype == torch.bfloat16
    for k in _FUSED_MATS:
        w = fused[k]
        if quant_w:
            if w.rows != shapes[k][0]:
                raise ValueError(f"{k}: {w.rows} rows, want {shapes[k][0]}")
            w, sc = w.qdata, w.scale
            ptrs.append(_chk(k, w, torch.int8, shapes[k], dev))
            scales.append(_chk(f"{k} scale", sc, torch.float32,
                                 (shapes[k][1],), dev, 4))
        else:
            ptrs.append(_chk(k, w, dtype, shapes[k], dev))
            scales.append(0)
        if tc:
            wmaps.append(_tmap(lib, w, shapes[k][1], shapes[k][0], bn, bk))
    ptrs += scales
    pool_dtype = torch.int8 if quant_kv else dtype
    ptrs += [_chk("k_pages", Kp, pool_dtype, (Hkv, P, ps, dh), dev),
             _chk("v_pages", Vp, pool_dtype, (Hkv, P, ps, dh), dev)]
    if quant_kv:
        ptrs += [_chk("k_scales", k_scales, torch.float32, (Hkv, P), dev, 4),
                 _chk("v_scales", v_scales, torch.float32, (Hkv, P), dev, 4)]
    else:
        ptrs += [0, 0]
    if stamps is not None:
        _chk("stamps", stamps, torch.int64, (1 + phases,), dev, 8)
    key = (_DTYPE_CODE[dtype], int(quant_w), int(quant_kv))
    grid = _grid(lib.prefill_megakernel_grid, dev, key)
    # the int8 pool's k and v were projected outside: only q here
    nq = H * dh if quant_kv else nqkv
    bufs, xmaps = _scratch(lib, dev, dtype, T, D, H * dh, Fh, bm, bk)
    h_out = torch.empty_like(h)
    bar = _barrier(dev)
    args = ptrs + [h.data_ptr(), h_out.data_ptr(), tbls.data_ptr(),
                   q_starts.data_ptr(), q_lens.data_ptr(), kv_lens.data_ptr(),
                   pre.block_row.data_ptr(), pre.slot.data_ptr(),
                   pre.cos.data_ptr(), pre.sin.data_ptr(),
                   *(b.data_ptr() for b in bufs), bar.data_ptr(),
                   0 if stamps is None else stamps.data_ptr()]
    dims = [T, D, H, Hkv, dh, Fh, P, ps, pps, R, q_block, nq]
    maps = b"".join(wmaps) + xmaps if tc else None
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.prefill_megakernel(
        *key, (ctypes.c_ulonglong * len(args))(*args),
        (ctypes.c_int * len(dims))(*dims), maps, float(eps),
        float(1.0 / dh ** 0.5), grid, stream)
    if err != 0:
        raise RuntimeError(f"prefill_megakernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES["prefill_megakernel"] += 1
    return h_out


def _library():
    from ._build import load
    lib = load("prefill_megakernel")
    if lib.prefill_megakernel.argtypes is None:
        i, p = ctypes.c_int, ctypes.c_void_p
        lib.prefill_megakernel_grid.argtypes = [i, i, i,
                                                ctypes.POINTER(ctypes.c_int)]
        lib.prefill_megakernel_grid.restype = i
        lib.prefill_megakernel_limits.argtypes = [ctypes.POINTER(ctypes.c_int)]
        lib.prefill_megakernel_limits.restype = None
        lib.prefill_megakernel_encode.argtypes = [i, p, i, i,
                                                  ctypes.c_longlong, i, i, p]
        lib.prefill_megakernel_encode.restype = i
        lib.prefill_megakernel.argtypes = [
            i, i, i, ctypes.POINTER(ctypes.c_ulonglong),
            ctypes.POINTER(ctypes.c_int), ctypes.c_char_p, ctypes.c_float,
            ctypes.c_float, i, p]
        lib.prefill_megakernel.restype = i
    return lib


__all__ = ["RaggedPrologue", "fuse_layer_weights", "fused_prefill_layer",
           "fused_prefill_model", "prefill_fallback_tripped",
           "prefill_megakernel_mode", "ragged_prologue",
           "reset_prefill_fallback", "rope_apply"]
