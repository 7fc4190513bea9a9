"""Decode megakernel — counterpart of ``paddle_tpu/kernels/decode_megakernel.py``.

One launch per decoder layer for ``q_len = 1`` rows, and — through
:func:`fused_decode_model` — one launch per token for every layer:

    rms_norm -> q/k/v projections (int8 weights: x column scale) -> rope
    at position ``kv_len - 1`` -> online-softmax attention over the row's
    pages (int8 pages x per-(head, page) scales) -> o projection ->
    residual -> rms_norm -> silu(gate) * up -> down -> residual

Two KV contracts, as the reference's:

- ``self_kv=True`` (fp pools): pages hold ``kv_len - 1`` cached tokens;
  the layer computes the current token's roped k and v, attends it in
  registers and returns them for the caller to scatter into the pool;
- ``self_kv=False`` (int8 pools): the caller appended first (the running
  amax requant must be visible to the attention), and pages hold all
  ``kv_len`` tokens.

Through :func:`fused_decode_model` the pool write is the kernel's own,
at either scope (one layer per launch, or every layer): each layer
writes the current token's K/V into its slot (``append_at``; an int8
pool runs the running-amax requantizing append of the engine's
``_quantized_append`` in the kernel), and the layers' weights and pools
are found through a device table of per-layer pointers, so nothing is
stacked or copied.

Two implementations of one function:

- :func:`_reference_layer`, plain PyTorch: the reference's
  ``_reference_layer`` rounding for rounding (it goes through the port's
  ``_rms_norm`` and ``_rope`` and, for the projections, the plain
  dequant-matmul that ``_wmat`` runs on the CPU), because off the TPU
  the JAX engine runs exactly that body;
- the CUDA kernel ``csrc/decode_megakernel.cu`` (see its header): one
  persistent cooperative launch whose phases are split by grid-wide
  barriers, the weights streamed by TMA tensor maps (a device table the
  wrapper encodes once per set of weights) into tensor cores, built by
  ``kernels/_build.py``.

The wrappers choose by where ``h`` lies: a CPU tensor runs the plain
version, a CUDA tensor launches the kernel or raises. There is no
fallback between the two: :func:`megakernel_fallback_tripped` is always
False (the reference's ``FLAGS_enable_fusion_fallback`` reroute has no
counterpart). int4 and mixed weight layouts take the plain body in the
reference on every backend; here they have no kernel and raise on the
card.
"""
from __future__ import annotations

import ctypes
from collections import OrderedDict

import torch
import torch.nn.functional as F

from . import LAUNCHES, check_not_capturing, keep_alive
from ..quantization.low_bit import QuantizedWeight

_NEG_INF = -1e30

_LAYER_MATS = ("q", "k", "v", "o", "gate", "up", "down")

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

#: the null pool page (``serving.kv_cache.NULL_PAGE``): an ``append_at``
#: row that targets it is dead and writes nothing in the kernel
_NULL_PAGE = 0

#: the kernel's phases per layer, in order (``stamps`` of a launch)
PHASES = ("q|k|v", "rope", "attention", "combine", "o", "h2", "gate|up",
          "act", "down", "out")


def megakernel_fallback_tripped() -> bool:
    """Always False: no launch is ever rerouted to the plain body."""
    return False


def _weights_kernel_ready(layer):
    """``"fp"`` for plain weights, ``"int8"`` for all-int8
    ``QuantizedWeight``s; None for int4 or mixed layouts."""
    kinds = set()
    for k in _LAYER_MATS:
        w = layer[k]
        if isinstance(w, QuantizedWeight):
            if w.bits != 8:
                return None
            kinds.add("int8")
        else:
            kinds.add("fp")
    return kinds.pop() if len(kinds) == 1 else None


def megakernel_mode(layer, device) -> str:
    """How :func:`fused_decode_layer` runs ``layer`` on ``device``:
    ``"cuda"`` (the kernel) or ``"plain"`` (the PyTorch body: CPU
    tensors, or an int4 / mixed layout, which the kernel refuses)."""
    if _weights_kernel_ready(layer) is None:
        return "plain"
    return "cuda" if torch.device(device).type == "cuda" else "plain"


def _rope_tables(kv_lens, theta, dh):
    """Interleaved-pair cos/sin tables for position ``kv_len - 1`` per
    row, expanded to the full head_dim (pairs (2i, 2i+1) share frequency
    i): ``[R, dh]`` f32 each, the values ``models.generation._rope``
    computes."""
    pos = (kv_lens - 1).clamp_min(0).to(torch.float32)
    inv = 1.0 / (theta ** (torch.arange(
        0, dh, 2, dtype=torch.float32, device=kv_lens.device) / dh))
    ang = pos[:, None] * inv                                   # [R, dh/2]
    return (torch.cos(ang).repeat_interleave(2, 1).contiguous(),
            torch.sin(ang).repeat_interleave(2, 1).contiguous())


def _plain_wmat(x, w):
    """The plain projection: ``x @ w``, or the plain dequant-matmul of a
    ``QuantizedWeight`` (what ``generation._wmat`` runs on the CPU)."""
    if isinstance(w, QuantizedWeight):
        from .int8_matmul import dequant_matmul_reference
        lead = x.shape[:-1]
        y = dequant_matmul_reference(x.reshape(-1, x.shape[-1]), w.qdata,
                                     w.scale, w.rows, w.bits)
        return y.reshape(lead + (y.shape[-1],))
    return x @ w


def _reference_layer(layer, h, k_pages, v_pages, block_tables, kv_lens, *,
                     eps, theta, num_heads, self_kv, k_scales, v_scales):
    """Plain PyTorch layer body: dense page gather and a masked softmax,
    rounded where the reference's ``_reference_layer`` rounds."""
    from ..models.generation import _rms_norm, _rope
    R = h.shape[0]
    Hkv, _, ps, dh = k_pages.shape
    H = num_heads
    grp = H // Hkv
    scale = 1.0 / (dh ** 0.5)
    pos = (kv_lens - 1).clamp_min(0).to(torch.int32)
    x = _rms_norm(h[None], layer["ln1"], eps)[0]
    q = _rope(_plain_wmat(x, layer["q"]).reshape(R, H, dh)[None],
              pos[None], theta, dh)[0]
    k_cur = v_cur = None
    if self_kv:
        k_cur = _rope(_plain_wmat(x, layer["k"]).reshape(R, Hkv, dh)[None],
                      pos[None], theta, dh)[0]
        v_cur = _plain_wmat(x, layer["v"]).reshape(R, Hkv, dh)
    Lc = kv_lens - (1 if self_kv else 0)
    tbl = block_tables.long()
    K = k_pages[:, tbl].to(torch.float32)            # [Hkv, R, PPS, ps, dh]
    V = v_pages[:, tbl].to(torch.float32)
    if k_scales is not None:
        K = K * k_scales[:, tbl, None, None]
        V = V * v_scales[:, tbl, None, None]
    S = K.shape[2] * ps
    K = K.reshape(Hkv, R, S, dh)
    V = V.reshape(Hkv, R, S, dh)
    qh = q.reshape(R, Hkv, grp, dh).to(torch.float32)
    s = torch.einsum("rhgd,hrsd->rhgs", qh, K) * scale
    posk = torch.arange(S, device=h.device)
    s = torch.where(posk[None, None, None, :] < Lc[:, None, None, None], s,
                    torch.full_like(s, _NEG_INF))
    if self_kv:
        s_self = torch.einsum("rhgd,rhd->rhg", qh,
                              k_cur.to(torch.float32))[..., None] * scale
        s = torch.cat([s, s_self], -1)
        V = torch.cat([V, v_cur.to(torch.float32).permute(1, 0, 2)
                       [:, :, None, :]], 2)
    w = torch.softmax(s, -1)
    o = torch.einsum("rhgs,hrsd->rhgd", w, V).reshape(R, H * dh).to(h.dtype)
    h2 = h + _plain_wmat(o, layer["o"])
    x2 = _rms_norm(h2[None], layer["ln2"], eps)[0]
    mlp = _plain_wmat(F.silu(_plain_wmat(x2, layer["gate"]))
                      * _plain_wmat(x2, layer["up"]), layer["down"])
    return h2 + mlp, k_cur, v_cur


def fused_decode_layer(layer, h, k_pages, v_pages, block_tables, kv_lens,
                       *, eps, theta, num_heads, self_kv=True, k_scales=None,
                       v_scales=None, rope_tables=None):
    """One fused decoder layer over q_len = 1 rows.

    layer: dict with ln1/ln2 and the q/k/v/o/gate/up/down projections
        (``[in, out]`` tensors or int8 ``QuantizedWeight``s);
    h: [R, hidden]; k_pages/v_pages: [Hkv, num_pages, page_size, dh]
        (int8 with ``k_scales``/``v_scales`` [Hkv, num_pages] f32);
    block_tables: [R, PPS] int32; kv_lens: [R] int32, the attention
        length per row INCLUDING the current token (at ``kv_len - 1``).
    rope_tables: ``_rope_tables(kv_lens, theta, dh)`` when the caller
        has them (every layer of a decode step shares them); the plain
        version computes its own.
    Returns ``(h_out, k_cur, v_cur)``: k_cur/v_cur ``[R, Hkv, dh]`` (the
    current token's roped k and v for the caller to append) with
    ``self_kv=True``, else None.
    """
    if (k_scales is None) != (v_scales is None):
        raise ValueError("k_scales and v_scales must be given together")
    if h.device.type == "cpu":
        return _reference_layer(
            layer, h, k_pages, v_pages, block_tables, kv_lens, eps=eps,
            theta=theta, num_heads=num_heads, self_kv=self_kv,
            k_scales=k_scales, v_scales=v_scales)
    if h.device.type != "cuda":
        raise ValueError(f"fused_decode_layer runs on cuda or cpu tensors, "
                         f"got {h.device}")
    Hkv, _, _, dh = k_pages.shape
    R = h.shape[0]
    h_out, k_cur, v_cur = _launch_cuda(
        [layer], h, [k_pages], [v_pages],
        None if k_scales is None else [k_scales],
        None if v_scales is None else [v_scales], block_tables, kv_lens,
        eps=eps, theta=theta, num_heads=num_heads, self_kv=self_kv,
        rope_tables=rope_tables)
    if self_kv:
        return h_out, k_cur.view(R, Hkv, dh), v_cur.view(R, Hkv, dh)
    return h_out, None, None


def stack_layer_params(layers):
    """Stack per-layer param dicts into one ``[L, ...]`` dict (the
    reference's LayerStack layout): tensors stack leafwise, and
    ``QuantizedWeight``s stack their payloads and scales (bits and rows
    must match). A slice of the result equals the original layer."""
    layers = list(layers)
    if not layers:
        raise ValueError("stack_layer_params needs at least one layer")
    out = {}
    for k, v in layers[0].items():
        vals = [lyr[k] for lyr in layers]
        if isinstance(v, QuantizedWeight):
            if any((w.bits, w.rows) != (v.bits, v.rows) for w in vals):
                raise ValueError(f"{k}: quantized layouts differ")
            out[k] = QuantizedWeight(torch.stack([w.qdata for w in vals]),
                                     torch.stack([w.scale for w in vals]),
                                     v.bits, v.rows)
        else:
            out[k] = torch.stack(vals)
    return out


def _unstack_layers(layers):
    """Per-layer dicts from a list (as is) or a stacked dict (views)."""
    if isinstance(layers, (list, tuple)):
        return list(layers)
    n = next(iter(layers.values()))
    n = (n.qdata if isinstance(n, QuantizedWeight) else n).shape[0]
    return [{k: (QuantizedWeight(v.qdata[i], v.scale[i], v.bits, v.rows)
                 if isinstance(v, QuantizedWeight) else v[i])
             for k, v in layers.items()} for i in range(n)]


def _per_layer(x, n):
    if x is None or isinstance(x, (list, tuple)):
        return None if x is None else list(x)
    return [x[i] for i in range(n)]


def fused_decode_model(layers, h, k_pages, v_pages, block_tables, kv_lens,
                       *, eps, theta, num_heads, self_kv=True, k_scales=None,
                       v_scales=None, append_fn=None, quant_append_fn=None,
                       append_at=None, appended=None, rope_tables=None):
    """Whole-model decode step: the fused layer body over every layer.
    On a CUDA device it is ONE launch for all layers (one layer: the
    layer-scope launch, the pool write inside it).

    layers: :func:`stack_layer_params` output (leaves ``[L, ...]``) or a
        list of per-layer dicts (no copy); k_pages/v_pages: ``[L, Hkv, P,
        ps, dh]`` or a list of per-layer pools; k_scales/v_scales: the
        int8 pools' ``[L, Hkv, P]`` (or lists; ``self_kv=False`` only);
    block_tables/kv_lens: as :func:`fused_decode_layer`, shared by every
        layer.
    The pool write of each layer is one of:
    - ``append_fn(Kp, Vp, k_cur, v_cur) -> (Kp, Vp)`` (fp) or
      ``quant_append_fn(Kp, Ks, Vp, Vs, k_cur, v_cur) -> (Kp, Ks, Vp,
      Vs)`` (int8, before the attention): the reference's callbacks,
      plain version only;
    - ``append_at=(page, off)``, int32 ``[R]``: each row's token goes to
      slot ``off`` of pool page ``page``, in place (the null page: a dead
      row). The kernel takes only this form and writes nothing for dead
      rows; the plain version writes them to the null page, as the
      engine's append does. An int8 pool runs the engine's
      ``_quantized_append`` math.
    ``appended``: optional f32 ``[L, 2, R, Hkv, dh]`` that receives each
    layer's appended K and V. ``rope_tables``: as
    :func:`fused_decode_layer` (the kernel's; the plain version computes
    its own).

    Returns ``(h_out, k_pages, v_pages, k_scales, v_scales)``, the pools
    updated (in place for ``append_at``; scales None for fp).
    """
    stacked = isinstance(k_pages, torch.Tensor)
    lyrs = _unstack_layers(layers)
    n = len(lyrs)
    kps, vps = _per_layer(k_pages, n), _per_layer(v_pages, n)
    kss, vss = _per_layer(k_scales, n), _per_layer(v_scales, n)
    if self_kv:
        if kss is not None or vss is not None:
            raise ValueError("self_kv=True is the fp contract; int8 scale "
                             "columns need self_kv=False")
        if append_fn is None and append_at is None:
            raise ValueError("self_kv=True needs append_fn or append_at "
                             "(the caller owns the fp pool write)")
    else:
        if kss is None or vss is None:
            raise ValueError("self_kv=False needs k_scales/v_scales")
        if quant_append_fn is None and append_at is None:
            raise ValueError("self_kv=False needs quant_append_fn or "
                             "append_at (the running-amax append)")
    if h.device.type == "cuda":
        if append_fn is not None or quant_append_fn is not None:
            raise ValueError("the kernel owns the pool write: pass "
                             "append_at, not append_fn/quant_append_fn")
        h_out, _, _ = _launch_cuda(
            lyrs, h, kps, vps, kss, vss, block_tables, kv_lens, eps=eps,
            theta=theta, num_heads=num_heads, self_kv=self_kv,
            append_at=append_at, appended=appended, rope_tables=rope_tables)
    elif h.device.type == "cpu":
        h_out = _plain_model(lyrs, h, kps, vps, kss, vss, block_tables,
                             kv_lens, eps, theta, num_heads, self_kv,
                             append_fn, quant_append_fn, append_at, appended)
    else:
        raise ValueError(f"fused_decode_model runs on cuda or cpu tensors, "
                         f"got {h.device}")
    if stacked:
        kps, vps = torch.stack(kps), torch.stack(vps)
        if kss is not None:
            kss, vss = torch.stack(kss), torch.stack(vss)
    return h_out, kps, vps, kss, vss


def _plain_model(lyrs, h, kps, vps, kss, vss, block_tables, kv_lens, eps,
                 theta, num_heads, self_kv, append_fn, quant_append_fn,
                 append_at, appended):
    """The plain layer loop of :func:`fused_decode_model`; updates the
    per-layer lists ``kps``/``vps`` (and ``kss``/``vss``) in place."""
    from ..models.generation import _rms_norm, _rope
    R = h.shape[0]
    Hkv, npages, ps, dh = kps[0].shape
    pos = (kv_lens - 1).clamp_min(0)
    if append_at is not None:
        page, off = (a.long() for a in append_at)
        live = page != _NULL_PAGE
    for i, lyr in enumerate(lyrs):
        Kp, Vp = kps[i], vps[i]
        if self_kv:
            h, kc, vc = _reference_layer(
                lyr, h, Kp, Vp, block_tables, kv_lens, eps=eps, theta=theta,
                num_heads=num_heads, self_kv=True, k_scales=None,
                v_scales=None)
            if append_fn is not None:
                Kp, Vp = append_fn(Kp, Vp, kc, vc)
            else:
                slot = page * ps + off
                Kp.view(Hkv, npages * ps, dh)[:, slot] = kc.transpose(0, 1)
                Vp.view(Hkv, npages * ps, dh)[:, slot] = vc.transpose(0, 1)
        else:
            # the append precedes the attention: the running-amax requant
            # must be visible to the page gather
            x = _rms_norm(h[None], lyr["ln1"], eps)[0]
            kc = _rope(_plain_wmat(x, lyr["k"]).reshape(R, Hkv, dh)[None],
                       pos[None], theta, dh)[0]
            vc = _plain_wmat(x, lyr["v"]).reshape(R, Hkv, dh)
            Ks, Vs = kss[i], vss[i]
            if quant_append_fn is not None:
                Kp, Ks, Vp, Vs = quant_append_fn(Kp, Ks, Vp, Vs, kc, vc)
            else:
                from ..serving.engine import _quantized_append
                _quantized_append(Kp, Ks, kc.transpose(0, 1), page, off, ps,
                                  live)
                _quantized_append(Vp, Vs, vc.transpose(0, 1), page, off, ps,
                                  live)
            kss[i], vss[i] = Ks, Vs
            h, _, _ = _reference_layer(
                lyr, h, Kp, Vp, block_tables, kv_lens, eps=eps, theta=theta,
                num_heads=num_heads, self_kv=False, k_scales=Ks, v_scales=Vs)
        kps[i], vps[i] = Kp, Vp
        if appended is not None:
            appended[i, 0] = kc.to(torch.float32)
            appended[i, 1] = vc.to(torch.float32)
    return h


# ---------------------------------------------------------------------------
# the CUDA launch
# ---------------------------------------------------------------------------

def _k_split(ntiles, kt, grid, max_tiles):
    """K chunks of one projection phase over ``kt`` k tiles: the fewest
    (each at most ``max_tiles`` tiles, none empty) that keep >= 90% of the
    grid's unit slots busy (a unit is a strip of ``ntiles`` and a chunk),
    else the best share among a few more."""
    lo = -(-kt // max_tiles)
    best = (0.0, lo)
    for ks in range(lo, max(lo, min(lo + 31, kt)) + 1):
        units = ntiles * ks
        share = units / (-(-units // grid) * grid)
        if share >= 0.9:
            return ks
        if share > best[0]:
            best = (share, ks)
    return best[1]


_GRIDS: dict = {}
_BARRIERS: dict = {}
#: device tables by what they hold (pointers, tensor maps): a launch
#: takes two, so a layer-scope model keeps two per layer and the bound
#: holds 512 layers' before any is encoded again
_TABLES: OrderedDict = OrderedDict()
_MAX_TABLES = 1024


def _grid(query, device, key):
    """Co-resident blocks of one kernel variant on ``device``: ``query`` is
    the library's ``<kernel>_grid`` function."""
    k = (query.__name__, device.index, key)
    if k not in _GRIDS:
        out = ctypes.c_int(0)
        with torch.cuda.device(device):
            err = query(*key, ctypes.byref(out))
        if err != 0:
            raise RuntimeError(f"{query.__name__}: occupancy query failed: "
                               f"CUDA error {err}")
        _GRIDS[k] = out.value
    return _GRIDS[k]


def _barrier(device):
    """The grid barrier's (count, generation) words on ``device``: the
    kernel leaves the count at 0, so launches on one stream share them,
    a CUDA graph's replays and eager launches alike."""
    if device.index not in _BARRIERS:
        check_not_capturing("the grid barrier")
        _BARRIERS[device.index] = torch.zeros(2, dtype=torch.int32,
                                              device=device)
    return keep_alive(_BARRIERS[device.index])


def _cached(key, make):
    """A device table cached by what it holds (``_TABLES``, bounded). A
    graph being captured keeps every table it reads (an eviction would
    free it under the graph); none is made during a capture."""
    t = _TABLES.get(key)
    if t is None:
        check_not_capturing("a decode megakernel device table")
        t = _TABLES[key] = make()
        while len(_TABLES) > _MAX_TABLES:
            _TABLES.popitem(last=False)
    else:
        _TABLES.move_to_end(key)
    return keep_alive(t)


def _pointer_table(ptrs, device):
    """The device copy of a per-layer pointer table, cached by its
    content (the same pointers are the same table)."""
    return _cached(("ptrs", device.index, tuple(ptrs)), lambda: torch.tensor(
        ptrs, dtype=torch.int64).pin_memory().to(device, non_blocking=True))


def _map_table(lib, key, mats, device):
    """The device table of the layers' weight tensor maps (128 bytes
    each, in the kernel's boxes for the variant ``key``), from ``mats``:
    per map ``(pointer, element bytes, columns, rows)``; encoded once per
    set of weights."""
    def make():
        raw = bytearray()
        for ptr, es, cols, rows in mats:
            buf = ctypes.create_string_buffer(128)
            err = lib.decode_megakernel_encode(*key[:2], ptr, cols, rows,
                                               cols * es, buf)
            if err != 0:
                raise RuntimeError(f"decode_megakernel: tensor map encoding "
                                   f"failed: CUDA error {err}")
            raw += buf.raw
        return torch.frombuffer(raw, dtype=torch.uint8).pin_memory() \
            .to(device, non_blocking=True)
    return _cached(("maps", device.index, key, tuple(mats)), make)


def _check(name, x, dtype, shape, device, align=16,
           kernel="decode_megakernel"):
    if not isinstance(x, torch.Tensor) or x.dtype != dtype or \
            x.device != device or tuple(x.shape) != tuple(shape) or \
            not x.is_contiguous() or x.data_ptr() % align:
        desc = (f"{x.dtype} {tuple(x.shape)} on {x.device}"
                if isinstance(x, torch.Tensor) else type(x).__name__)
        raise TypeError(f"{kernel}: {name} must be a contiguous, "
                        f"{align}-byte aligned {dtype} {tuple(shape)} on "
                        f"{device}, got {desc}")
    return x.data_ptr()


def _launch_cuda(lyrs, h, kps, vps, kss, vss, block_tables, kv_lens, *, eps,
                 theta, num_heads, self_kv, append_at=None, appended=None,
                 stamps=None, rope_tables=None):
    """Check every operand and launch the kernel over ``lyrs`` (one layer:
    layer scope). Returns ``(h_out, k_cur, v_cur)``; k_cur/v_cur are
    ``[R, Hkv*dh]`` for a ``self_kv`` launch without ``append_at``, else
    None. ``stamps``: optional int64 ``[1 + len(PHASES) L]`` receiving the
    device clock (ns) at the start and at the end of each phase of
    :data:`PHASES`."""
    dev = h.device
    dtype = h.dtype
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"decode_megakernel takes float32 or bfloat16 hidden "
                        f"states, got {dtype}")
    kinds = {_weights_kernel_ready(lyr) for lyr in lyrs}
    if None in kinds or len(kinds) != 1:
        raise NotImplementedError(
            "decode_megakernel takes fp or all-int8 weights; int4 and mixed "
            "layouts have no kernel (ROADMAP queue A, 'int4 weights in "
            "decode bursts')")
    quant_w = kinds.pop() == "int8"
    quant_kv = kss is not None
    L = len(lyrs)
    R, D = h.shape
    Hkv, P, ps, dh = kps[0].shape
    H = num_heads
    pps = block_tables.shape[1]
    F_ = (lyrs[0]["gate"].shape[1])
    lib = _library()
    limits = (ctypes.c_int * 6)()
    lib.decode_megakernel_limits(limits)
    max_rows, max_grp, max_dh, split, phases, x_bytes = list(limits)
    pool_es = 1 if quant_kv else h.element_size()
    if H % Hkv or H // Hkv > max_grp or dh > max_dh or (dh * pool_es) % 16 \
            or R > max_rows or R < 1:
        raise ValueError(f"decode_megakernel takes up to {max_rows} rows, "
                         f"{max_grp} query heads per kv head and head_dim "
                         f"<= {max_dh} (pool rows a multiple of 16 bytes); "
                         f"got R {R}, H {H}, Hkv {Hkv}, dh {dh}")
    # every width a multiple of 8 (x is staged 8 values at a time) and a
    # weight row a multiple of 16 bytes (a tensor map's row pitch)
    wmul = 16 if quant_w else 8
    for n in (H * dh, Hkv * dh, D, F_):
        if n % wmul:
            raise ValueError(f"decode_megakernel needs every projection "
                             f"width a multiple of {wmul}, got {n}")
    _check("h", h, dtype, (R, D), dev)
    _check("block_tables", block_tables, torch.int32, (R, pps), dev, 4)
    _check("kv_lens", kv_lens, torch.int32, (R,), dev, 4)
    shapes = {"q": (D, H * dh), "k": (D, Hkv * dh), "v": (D, Hkv * dh),
              "o": (H * dh, D), "gate": (D, F_), "up": (D, F_),
              "down": (F_, D)}
    pool_dtype = torch.int8 if quant_kv else dtype
    ptrs, mats = [], []
    for i, lyr in enumerate(lyrs):
        row = [_check(f"layer {i} {k}", lyr[k], dtype, (D,), dev)
               for k in ("ln1", "ln2")]
        scales = []
        for k in _LAYER_MATS:
            w = lyr[k]
            if quant_w:
                if w.rows != shapes[k][0]:
                    raise ValueError(f"layer {i} {k}: {w.rows} rows, "
                                     f"want {shapes[k][0]}")
                w, s = w.qdata, w.scale
                row.append(_check(f"layer {i} {k}", w, torch.int8, shapes[k],
                                  dev))
                scales.append(_check(f"layer {i} {k} scale", s,
                                     torch.float32, (shapes[k][1],), dev, 4))
            else:
                row.append(_check(f"layer {i} {k}", w, dtype, shapes[k], dev))
                scales.append(0)
            mats.append((w.data_ptr(), w.element_size(), shapes[k][1],
                         shapes[k][0]))
        row += scales
        row += [_check(f"layer {i} k_pages", kps[i], pool_dtype,
                       (Hkv, P, ps, dh), dev),
                _check(f"layer {i} v_pages", vps[i], pool_dtype,
                       (Hkv, P, ps, dh), dev)]
        if quant_kv:
            row += [_check(f"layer {i} k_scales", kss[i], torch.float32,
                           (Hkv, P), dev, 4),
                    _check(f"layer {i} v_scales", vss[i], torch.float32,
                           (Hkv, P), dev, 4)]
        else:
            row += [0, 0]
        ptrs += row
    app_page = app_off = None
    if append_at is not None:
        app_page, app_off = append_at
        _check("append_at page", app_page, torch.int32, (R,), dev, 4)
        _check("append_at off", app_off, torch.int32, (R,), dev, 4)
    if appended is not None:
        _check("appended", appended, torch.float32, (L, 2, R, Hkv, dh), dev,
               4)
    if stamps is not None:
        _check("stamps", stamps, torch.int64, (1 + phases * L,), dev, 8)
    append = append_at is not None
    with_kv = self_kv or append
    layer_kv = self_kv and not append      # outputs k_cur/v_cur
    key = (_DTYPE_CODE[dtype], int(quant_w), int(quant_kv))
    grid = _grid(lib.decode_megakernel_grid, dev, key)
    n_qkv = (H + (2 * Hkv if with_kv else 0)) * dh
    strip = (ctypes.c_int * 3)()
    lib.decode_megakernel_strip(*key[:2], strip)
    uc, bk = strip[0], strip[1]
    # the x window's k tiles at R rows: a unit's chunk stages once
    rp = -(-R // 8) * 8
    pad = 8 if dtype == torch.bfloat16 else 4
    win = (x_bytes // (rp * h.element_size()) - pad) // bk
    strips = lambda *ns: sum(-(-n // uc) for n in ns)     # noqa: E731
    ks = (_k_split(strips(H * dh, *((Hkv * dh,) * 2 if with_kv else ())),
                   -(-D // bk), grid, win),
          _k_split(strips(D), -(-(H * dh) // bk), grid, win),
          _k_split(strips(F_, F_), -(-D // bk), grid, win),
          _k_split(strips(D), -(-F_ // bk), grid, win))
    S = -(-pps * ps // split)           # attention splits per row slot
    sizes = [ks[0] * R * n_qkv, R * (H + 2 * Hkv) * dh,
             R * Hkv * S * (H // Hkv) * (dh + 2), R * H * dh, ks[1] * R * D,
             R * D, ks[2] * R * 2 * F_, R * F_, ks[3] * R * D]
    sizes = [-(-n // 4) * 4 for n in sizes]        # 16-byte aligned parts
    scratch = torch.empty(sum(sizes), dtype=torch.float32, device=dev)
    offs, at = [], 0
    for s in sizes:
        offs.append(scratch.data_ptr() + 4 * at)
        at += s
    if rope_tables is None:
        rope_tables = _rope_tables(kv_lens, theta, dh)
    cos, sin = rope_tables
    _check("rope cos", cos, torch.float32, (R, dh), dev, 4)
    _check("rope sin", sin, torch.float32, (R, dh), dev, 4)
    h_out = torch.empty_like(h)
    k_cur = v_cur = None
    if layer_kv:
        k_cur = torch.empty((R, Hkv * dh), dtype=dtype, device=dev)
        v_cur = torch.empty_like(k_cur)
    table = _pointer_table(ptrs, dev)
    maps = _map_table(lib, key, mats, dev)
    bar = _barrier(dev)
    addr = lambda t: 0 if t is None else t.data_ptr()     # noqa: E731
    args = [table.data_ptr(), maps.data_ptr(), h.data_ptr(),
            h_out.data_ptr(), addr(k_cur), addr(v_cur),
            block_tables.data_ptr(), kv_lens.data_ptr(), cos.data_ptr(),
            sin.data_ptr(), addr(app_page), addr(app_off), addr(appended),
            *offs, bar.data_ptr(), addr(stamps)]
    dims = [L, R, D, H, Hkv, dh, F_, P, ps, pps, *ks, int(self_kv),
            int(with_kv), int(append), S]
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.decode_megakernel(
        *key, (ctypes.c_ulonglong * len(args))(*args),
        (ctypes.c_int * len(dims))(*dims), float(eps),
        float(1.0 / dh ** 0.5), grid, stream)
    if err != 0:
        raise RuntimeError(f"decode_megakernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES["decode_megakernel"] += 1
    return h_out, k_cur, v_cur


def _library():
    from ._build import load
    lib = load("decode_megakernel")
    if lib.decode_megakernel.argtypes is None:
        i, p = ctypes.c_int, ctypes.c_void_p
        lib.decode_megakernel_grid.argtypes = [i, i, i,
                                               ctypes.POINTER(ctypes.c_int)]
        lib.decode_megakernel_grid.restype = i
        lib.decode_megakernel_limits.argtypes = [ctypes.POINTER(ctypes.c_int)]
        lib.decode_megakernel_limits.restype = None
        lib.decode_megakernel_encode.argtypes = [i, i, p, i, i,
                                                 ctypes.c_longlong, p]
        lib.decode_megakernel_encode.restype = i
        lib.decode_megakernel_strip.argtypes = [i, i,
                                                ctypes.POINTER(ctypes.c_int)]
        lib.decode_megakernel_strip.restype = i
        lib.decode_megakernel.argtypes = [
            i, i, i, ctypes.POINTER(ctypes.c_ulonglong),
            ctypes.POINTER(ctypes.c_int), ctypes.c_float, ctypes.c_float, i,
            p]
        lib.decode_megakernel.restype = i
    return lib


__all__ = ["fused_decode_layer", "fused_decode_model", "megakernel_mode",
           "megakernel_fallback_tripped", "stack_layer_params"]
