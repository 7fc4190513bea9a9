"""paddle_tpu_torch's low-bit serving pieces against the JAX package.

The same numpy inputs go through ``paddle_tpu`` (its Pallas kernels in
interpret mode where it has one, and its plain references) and the
port's plain PyTorch versions. Tolerances:

- quantized payloads and scales of f32 weights: byte for byte (the same
  division, round-half-to-even and clip);
- dequant-matmul, f32: 1e-5 relative (the products are summed in
  another order);
- the bf16 CUDA kernel's arithmetic emulated on the CPU: its widening of
  payload bytes bit for bit (exact for every value), and its split-K
  partials summed in split order with the scale after the sum, against
  the plain version and the Pallas kernel in interpret mode: f32 1e-5,
  bf16 1e-2 (the card tests' tolerance), of max(1, max|plain|);
- ragged attention over int8 pools: 1e-5 absolute, f32 (as the fp pool);
- the quantizing appends: int8 pages within 1 (a value within rounding
  of a half may round the other way), scales 1e-6 relative.

The CUDA kernels run only on the card: ``tests/test_torch_cuda_kernels.py``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu import quantization as jq
from paddle_tpu.kernels import int8_matmul as jmm
from paddle_tpu.kernels import paged_attention as jpa
from paddle_tpu.quantization import low_bit as jlb
from paddle_tpu.serving import engine as jeng
from paddle_tpu_torch import quantization as tq
from paddle_tpu_torch.kernels import LAUNCHES, reset_launch_counts
from paddle_tpu_torch.kernels import int8_matmul as tmm
from paddle_tpu_torch.kernels import paged_attention as tpa
from paddle_tpu_torch.quantization import low_bit as tlb
from paddle_tpu_torch.serving import engine as teng
from paddle_tpu_torch.serving import kv_cache as tkv

#: (K, N): odd K (int4 pads one zero row), N not a multiple of anything
SHAPES = [(96, 200), (67, 130), (1, 9), (33, 8)]


def _weights(k, n, seed):
    rng = np.random.RandomState(seed)
    w = rng.randn(k, n).astype(np.float32)
    w[:, 0] = 0.0                 # an all-zero column: the 1e-8 floor
    return w


@pytest.mark.parametrize("mode", ["weight_only_int8", "weight_only_int4"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_quantize_weight_payload_is_byte_identical(shape, mode):
    w = _weights(*shape, seed=shape[0])
    got = tlb.quantize_weight(torch.from_numpy(w), mode)
    want = jlb.quantize_weight(jnp.asarray(w), mode)
    assert (got.bits, got.rows, got.shape) == (want.bits, want.rows,
                                               want.shape)
    assert got.qdata.dtype == torch.int8
    np.testing.assert_array_equal(got.qdata.numpy(), np.asarray(want.qdata))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    assert got.nbytes == want.nbytes
    np.testing.assert_array_equal(got.dequantize().numpy(),
                                  np.asarray(want.dequantize()))


@pytest.mark.parametrize("rows", [7, 8])
def test_int4_pack_and_unpack_match_jax(rows):
    w = _weights(rows, 5, seed=rows)
    got, gs = tq.quantize_to_int4(torch.from_numpy(w), axis=1)
    want, ws = jq.quantize_to_int4(jnp.asarray(w), axis=1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
    np.testing.assert_array_equal(tq.unpack_int4(got, rows).numpy(),
                                  np.asarray(jq.unpack_int4(want, rows)))
    # every nibble value round-trips, -7 .. 7 and the sign-extended 8..15
    every = torch.arange(-128, 128, dtype=torch.int32).to(torch.int8)
    np.testing.assert_array_equal(
        tq.unpack_int4(every[:, None], 512).numpy(),
        np.asarray(jq.unpack_int4(jnp.asarray(every.numpy()[:, None]), 512)))


def test_quantize_params_matches_jax_and_keeps_fp_leaves():
    rng = np.random.RandomState(4)
    layer = {k: rng.randn(16, 24).astype(np.float32)
             for k in ("q", "k", "v", "o", "gate", "up", "down")}
    layer["ln1"] = rng.randn(16).astype(np.float32)
    params = {"embed": rng.randn(32, 16).astype(np.float32),
              "norm": rng.randn(16).astype(np.float32),
              "layers": [layer, dict(layer)]}
    to_t = {k: torch.from_numpy(v) for k, v in params.items()
            if k != "layers"}
    to_t["layers"] = [{k: torch.from_numpy(v) for k, v in lyr.items()}
                      for lyr in params["layers"]]
    to_j = {k: jnp.asarray(v) for k, v in params.items() if k != "layers"}
    to_j["layers"] = [{k: jnp.asarray(v) for k, v in lyr.items()}
                      for lyr in params["layers"]]
    for mode in tlb.QUANT_MODES:
        got = tlb.quantize_params(to_t, mode)
        want = jlb.quantize_params(to_j, mode)
        assert got["embed"] is to_t["embed"]
        assert got["layers"][0]["ln1"] is to_t["layers"][0]["ln1"]
        for g, w in zip(got["layers"], want["layers"]):
            for k in ("q", "k", "v", "o", "gate", "up", "down"):
                np.testing.assert_array_equal(g[k].qdata.numpy(),
                                              np.asarray(w[k].qdata))
        assert tlb.params_weight_bytes(got) == jlb.params_weight_bytes(want)
    assert tlb.QUANT_MODES == jlb.QUANT_MODES
    assert tlb.quantize_params(to_t, None) is to_t
    for mod in (tlb, jlb):
        with pytest.raises(ValueError, match="unknown quantized mode"):
            mod.quantize_params(to_j if mod is jlb else to_t, "int8")


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_dequant_matmul_plain_matches_jax(shape, bits):
    k, n = shape
    w = _weights(k, n, seed=k + bits)
    x = np.random.RandomState(n).randn(2, 5, k).astype(np.float32)
    quant = jq.quantize_to_int8 if bits == 8 else jq.quantize_to_int4
    q, s = quant(jnp.asarray(w), axis=1)
    # the JAX payload, carried over byte for byte
    qw = tlb.QuantizedWeight.from_numpy(np.asarray(q), np.asarray(s), bits,
                                        k)
    reset_launch_counts()
    got = tlb.matmul(torch.from_numpy(x), qw)
    assert all(v == 0 for v in LAUNCHES.values())     # CPU: plain version
    assert got.shape == (2, 5, n) and got.dtype == torch.float32
    ref = np.asarray(jmm._reference(jnp.asarray(x.reshape(-1, k)), q, s, k,
                                    bits)).reshape(2, 5, n)
    kern = np.asarray(jmm.dequant_matmul(jnp.asarray(x), q, s, rows=k,
                                         bits=bits, interpret=True))
    scale = max(1.0, float(np.abs(ref).max()))
    for want in (ref, kern):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * scale)


def test_dequant_matmul_checks_like_the_reference():
    x = torch.zeros(3, 8)
    w = torch.zeros(8, 4, dtype=torch.int8)
    s = torch.ones(4)
    with pytest.raises(ValueError, match="bits"):
        tmm.dequant_matmul(x, w, s, bits=2)
    with pytest.raises(ValueError, match="rows"):
        tmm.dequant_matmul(x, w[:4], s, bits=4)
    with pytest.raises(ValueError, match="cuda or cpu"):
        tmm.dequant_matmul(x.to("meta"), w, s)
    bf = torch.ones(3, 8, dtype=torch.bfloat16)
    out = tmm.dequant_matmul(bf, w + 1, s)
    assert out.dtype == torch.bfloat16 and torch.all(out == 8)


# ---------------------------------------------------------------------------
# the bf16 CUDA kernel's arithmetic, emulated on the CPU
# ---------------------------------------------------------------------------


def _prmt(a, b, sel):
    """PTX ``prmt.b32`` (default mode) on uint32 arrays: byte i of the
    result is byte ``(sel >> 4i) & 7`` of the pair (a, b)."""
    pool = [(a >> (8 * i)) & 0xFF for i in range(4)] + \
        [(b >> (8 * i)) & 0xFF for i in range(4)]
    return sum(pool[(sel >> (4 * i)) & 7] << (8 * i) for i in range(4))


def _bf16_halves(word):
    """The two bf16 halves of uint32 words as float32, low half first."""
    lo = ((word & 0xFFFF) << 16).astype(np.uint32).view(np.float32)
    hi = (word & 0xFFFF0000).astype(np.uint32).view(np.float32)
    return lo, hi


def _bf16x2_add(a, b):
    """``fma.rn.bf16x2 d, a, 1.0, b`` where every sum is exact in bf16
    (asserted), as the kernel's widening needs."""
    (al, ah), (bl, bh) = _bf16_halves(a), _bf16_halves(b)
    lo, hi = al + bl, ah + bh
    for v in (lo, hi):
        assert not (v.view(np.uint32) & 0xFFFF).any(), "sum not exact"
    return lo, hi


@pytest.mark.parametrize("bits", [8, 4])
def test_kernel_widening_is_exact_for_every_value(bits):
    """``csrc/int8_matmul.cu`` widens payload bytes to bf16 pairs with
    integer bit operations (``widen_i8``, ``widen_i4``): emulated bit for
    bit here, every int8 value (or int4 pair) at every byte position of
    its word, beside neighbouring bytes, widens to itself."""
    rng = np.random.RandomState(bits)
    u32 = np.uint32
    for j in range(4):
        sel = j | (j << 4) | ((j + 4) << 8) | ((j + 4) << 12)
        if bits == 8:
            lo_v = np.arange(-128, 128)
            hi_v = rng.permutation(lo_v)
            lo_w = rng.randint(0, 2 ** 32, 256, dtype=np.uint64).astype(u32)
            hi_w = rng.randint(0, 2 ** 32, 256, dtype=np.uint64).astype(u32)
            mask = u32(~(0xFF << (8 * j)) & 0xFFFFFFFF)
            lo_w = (lo_w & mask) | ((lo_v.astype(np.uint8).astype(u32)) << 8 * j)
            hi_w = (hi_w & mask) | ((hi_v.astype(np.uint8).astype(u32)) << 8 * j)
            d = _prmt(lo_w, hi_w, sel).astype(u32)
            got = _bf16x2_add((d & 0x007F007F) | 0x43004300,
                              (d & 0x00800080) | 0xC300C300)
            np.testing.assert_array_equal(got[0], lo_v)
            np.testing.assert_array_equal(got[1], hi_v)
        else:
            x0, x1 = np.meshgrid(np.arange(-8, 8), np.arange(-8, 8))
            x0, x1 = x0.ravel(), x1.ravel()
            byte = ((x1 & 0xF) << 4 | (x0 & 0xF)).astype(u32)
            word = rng.randint(0, 2 ** 32, byte.size, dtype=np.uint64) \
                .astype(u32)
            word = (word & u32(~(0xFF << (8 * j)) & 0xFFFFFFFF)) | \
                (byte << 8 * j)
            biased = word ^ u32(0x88888888)
            d = _prmt(biased, biased >> 4, sel).astype(u32)
            got = _bf16x2_add((d & 0x000F000F) | 0x43004300,
                              np.full_like(d, 0xC308C308))
            np.testing.assert_array_equal(got[0], x0)
            np.testing.assert_array_equal(got[1], x1)


def _kernel_emulation(x, q, s, rows, bits, splits, tile=64):
    """The bf16 CUDA kernel's arithmetic in plain PyTorch: x as the card
    holds it times the exactly widened weight, an f32 partial sum per K
    split (split r of S takes K tiles [T r / S, T (r + 1) / S) of 64 rows,
    T tiles in all), the partials added in split order, the scale applied
    after the sum, one rounding to x's dtype."""
    k = x.shape[1]
    w = (q if bits == 8 else tq.unpack_int4(q, rows)).to(torch.float32)
    tiles = -(-k // tile)
    total = torch.zeros(x.shape[0], q.shape[1])
    for r in range(splits):
        a = tiles * r // splits * tile
        b = min(tiles * (r + 1) // splits * tile, k)
        total = total + x[:, a:b].to(torch.float32) @ w[a:b]
    return (total * s.reshape(1, -1)).to(x.dtype)


#: (K, N): a K of whole tiles, a ragged K with a ragged N, an odd K
EMULATED = [(256, 40), (200, 96), (67, 130)]
_JAX_KERNEL = {}


def _jax_kernel(x, q, s, k, bits):
    """``paddle_tpu``'s Pallas kernel in interpret mode (cached: it does
    not depend on the split count)."""
    key = (x.shape, str(x.dtype), k, bits)
    if key not in _JAX_KERNEL:
        xj = jnp.asarray(x.to(torch.float32).numpy())
        if x.dtype == torch.bfloat16:
            xj = xj.astype(jnp.bfloat16)
        _JAX_KERNEL[key] = np.asarray(
            jmm.dequant_matmul(xj, jnp.asarray(q.numpy()),
                               jnp.asarray(s.numpy()), rows=k, bits=bits,
                               interpret=True).astype(jnp.float32))
    return _JAX_KERNEL[key]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("splits", [1, 3, 4])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("shape", EMULATED, ids=lambda s: f"{s[0]}x{s[1]}")
def test_kernel_arithmetic_matches_plain_and_jax(shape, bits, splits, dtype):
    """The split-K sum in split order with the scale after it stays
    within the card tests' tolerance of the plain version and of the
    Pallas kernel in interpret mode: f32 1e-5, bf16 1e-2 (both of
    max(1, max|plain|)); the two differ in summation order and, in bf16,
    in the one rounding of the output."""
    k, n = shape
    w = _weights(k, n, seed=k + n + bits)
    quant = jq.quantize_to_int8 if bits == 8 else jq.quantize_to_int4
    qj, sj = quant(jnp.asarray(w), axis=1)
    q = torch.from_numpy(np.array(qj, np.int8))
    s = torch.from_numpy(np.array(sj, np.float32)).reshape(-1)
    x = torch.from_numpy(np.random.RandomState(n).randn(5, k)
                         .astype(np.float32)).to(dtype)
    got = _kernel_emulation(x, q, s, k, bits, splits)
    plain = tmm.dequant_matmul_reference(x, q, s, k, bits)
    assert got.dtype == plain.dtype == dtype
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    scale = max(1.0, plain.float().abs().max().item())
    for want in (plain.float().numpy(), _jax_kernel(x, q, s, k, bits)):
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                                   atol=tol * scale)


# ---------------------------------------------------------------------------
# ragged attention over int8 pools
# ---------------------------------------------------------------------------

HQ, HKV, D, PS = 4, 2, 16, 4

#: (q_len, kv_len) per row: decode rows across page boundaries, a first
#: chunk and a mid-prompt chunk over several pages, padding rows last
INT8_ROWS = [(1, 1), (1, 5), (6, 19), (11, 11), (1, 13), (0, 0)]


def _int8_inputs(rows, q_block=4, num_pages=30, pps=6, seed=0):
    rng = np.random.RandomState(seed)
    r = len(rows)
    starts, cursor = [], 0
    for ql, _ in rows:
        starts.append(cursor)
        cursor += -(-ql // q_block) * q_block
    t = cursor + q_block
    q_starts = np.full(r, t, np.int32)
    q_lens = np.zeros(r, np.int32)
    kv_lens = np.zeros(r, np.int32)
    tables = np.zeros((r, pps), np.int32)
    free = list(rng.permutation(np.arange(1, num_pages)))
    for i, (ql, kl) in enumerate(rows):
        if ql == 0:
            continue
        q_starts[i], q_lens[i], kv_lens[i] = starts[i], ql, kl
        for p in range(-(-kl // PS)):
            tables[i, p] = free.pop()
    q = rng.randn(t, HQ, D).astype(np.float32)
    k = rng.randint(-127, 128, (HKV, num_pages, PS, D)).astype(np.int8)
    v = rng.randint(-127, 128, (HKV, num_pages, PS, D)).astype(np.int8)
    ks = (rng.rand(HKV, num_pages) * 0.05).astype(np.float32)
    vs = (rng.rand(HKV, num_pages) * 0.05).astype(np.float32)
    return q, k, v, tables, q_starts, q_lens, kv_lens, ks, vs


@pytest.mark.parametrize("q_block", [4, 8])
def test_ragged_attention_over_int8_pools_matches_jax(q_block):
    q, k, v, tables, qs, ql, kl, ks, vs = _int8_inputs(INT8_ROWS, q_block)
    tt = [torch.from_numpy(a) for a in (q, k, v, tables, qs, ql, kl)]
    reset_launch_counts()
    got = tpa.ragged_paged_attention(
        *tt, q_block=q_block, k_scales=torch.from_numpy(ks),
        v_scales=torch.from_numpy(vs)).numpy()
    assert LAUNCHES["ragged_paged_attention_int8"] == 0
    jargs = [jnp.asarray(a) for a in (q, k, v, tables)]
    kern = np.asarray(jpa.ragged_paged_attention(
        *jargs, jnp.asarray(qs), jnp.asarray(ql), jnp.asarray(kl),
        q_block=q_block, interpret=True, k_scales=jnp.asarray(ks),
        v_scales=jnp.asarray(vs)))
    ref = np.asarray(jpa.ragged_paged_attention_reference(
        *jargs, qs, ql, kl, k_scales=jnp.asarray(ks),
        v_scales=jnp.asarray(vs)))
    live = np.zeros(q.shape[0], bool)
    for s, n in zip(qs, ql):
        live[s:s + n] = True
    np.testing.assert_allclose(got[live], kern[live], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    assert not got[~live].any()


def test_paged_attention_wrapper_over_int8_pools_matches_jax():
    q, k, v, tables, _, _, _, ks, vs = _int8_inputs(INT8_ROWS)
    lens = np.asarray([1, 4, 9, 13], np.int32)
    got = tpa.paged_attention(
        torch.from_numpy(q[:4]), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(tables[1:5]), torch.from_numpy(lens),
        k_scales=torch.from_numpy(ks), v_scales=torch.from_numpy(vs))
    want = jpa.paged_attention(
        jnp.asarray(q[:4]), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(tables[1:5]), jnp.asarray(lens), interpret=True,
        k_scales=jnp.asarray(ks), v_scales=jnp.asarray(vs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def test_int8_attention_needs_both_scales():
    q, k, v, tables, qs, ql, kl, ks, _ = _int8_inputs(INT8_ROWS)
    tt = [torch.from_numpy(a) for a in (q, k, v, tables, qs, ql, kl)]
    with pytest.raises(ValueError, match="together"):
        tpa.ragged_paged_attention(*tt, q_block=4,
                                   k_scales=torch.from_numpy(ks))


# ---------------------------------------------------------------------------
# the quantizing appends
# ---------------------------------------------------------------------------

def _append_case(seed, rows, ps=4, npages=20, pps=6, hkv=2, d=8,
                 fresh_scale=0.02):
    """A pool with some pages already written (int8 payload and scales)
    and a packed chunk of new tokens for ``rows`` = [(q_len, kv_len)]."""
    rng = np.random.RandomState(seed)
    r = len(rows)
    t = sum(-(-ql // 4) * 4 for ql, _ in rows) + 4
    Pp = rng.randint(-127, 128, (hkv, npages, ps, d)).astype(np.int8)
    Ps = (rng.rand(hkv, npages) * fresh_scale).astype(np.float32)
    Ps[:, 0] = 0.0
    Pp[:, 0] = 0
    tbls = np.zeros((r, pps), np.int32)
    q_starts = np.full(r, t, np.int32)
    q_lens = np.zeros(r, np.int32)
    kv_lens = np.zeros(r, np.int32)
    free = list(rng.permutation(np.arange(1, npages)))
    cursor = 0
    for i, (ql, kl) in enumerate(rows):
        if ql == 0:
            continue
        q_starts[i], q_lens[i], kv_lens[i] = cursor, ql, kl
        tbls[i, :-(-kl // ps)] = [free.pop() for _ in range(-(-kl // ps))]
        cursor += -(-ql // 4) * 4
    chunk = (rng.randn(hkv, t, d) * rng.choice([0.5, 4.0])) \
        .astype(np.float32)
    return Pp, Ps, chunk, tbls, q_starts, q_lens, kv_lens


def _port_append(P, S, chunk, tbls, qs, ql, kl, ps):
    """The port's append as the engine runs it: planned on the host,
    applied in place. Returns the plan's page slots per row."""
    page, tok, sel = teng._append_plan(tbls, qs, ql, kl, ps, 16,
                                       chunk.shape[1])
    teng._segmented_quant_append(P, S, torch.from_numpy(chunk),
                                 torch.from_numpy(page).long(),
                                 torch.from_numpy(tok).long(),
                                 torch.from_numpy(sel).bool())
    return len(page) // len(ql)


#: decode rows, a chunk crossing pages, a first chunk, one that starts a
#: page exactly, padding rows
APPEND_ROWS = [(1, 1), (1, 6), (7, 13), (9, 9), (4, 8), (0, 0)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_segmented_quant_append_matches_jax(seed):
    ps, pps = 4, 6
    Pp, Ps, chunk, tbls, qs, ql, kl = _append_case(seed, APPEND_ROWS)
    jP, jS = jeng._segmented_quant_append(
        jnp.asarray(Pp), jnp.asarray(Ps), jnp.asarray(chunk),
        jnp.asarray(tbls), jnp.asarray(qs), jnp.asarray(ql),
        jnp.asarray(kl), ps, pps, 16)
    tP, tS = torch.from_numpy(Pp.copy()), torch.from_numpy(Ps.copy())
    assert _port_append(tP, tS, chunk, tbls, qs, ql, kl, ps) == 3
    diff = np.abs(tP.numpy().astype(np.int32)
                  - np.asarray(jP).astype(np.int32))
    assert diff.max() <= 1
    np.testing.assert_allclose(tS.numpy(), np.asarray(jS), rtol=1e-6,
                               atol=0)
    touched = np.abs(Pp.astype(np.int32) - tP.numpy()).sum(axis=(0, 2, 3))
    assert touched[0] == 0 and not tS[:, 0].any()    # the null page


def test_single_token_appends_match_jax():
    """Decode rows only: the segmented append (the engine's) and the
    one-token append both equal the reference's ``_quantized_append``."""
    ps, pps = 4, 6
    rows = [(1, 1), (1, 4), (1, 6), (1, 13), (0, 0)]
    Pp, Ps, chunk, tbls, qs, ql, kl = _append_case(5, rows,
                                                   fresh_scale=0.01)
    live = ql > 0
    pos = np.maximum(kl - 1, 0)
    page_ids = np.where(live, tbls[np.arange(len(rows)), pos // ps], 0)
    tok = chunk[:, np.minimum(qs, chunk.shape[1] - 1)]        # [Hkv, R, d]
    jP, jS = jeng._quantized_append(
        jnp.asarray(Pp), jnp.asarray(Ps), jnp.asarray(tok),
        jnp.asarray(page_ids), jnp.asarray(pos % ps), ps, jnp.asarray(live))
    one = [torch.from_numpy(Pp.copy()), torch.from_numpy(Ps.copy())]
    teng._quantized_append(*one, torch.from_numpy(tok),
                           torch.from_numpy(page_ids).long(),
                           torch.from_numpy(pos % ps), ps,
                           torch.from_numpy(live))
    seg = [torch.from_numpy(Pp.copy()), torch.from_numpy(Ps.copy())]
    assert _port_append(*seg, chunk, tbls, qs, ql, kl, ps) == 1
    for P, S in (one, seg):
        assert np.abs(P.numpy().astype(np.int32)
                      - np.asarray(jP).astype(np.int32)).max() <= 1
        np.testing.assert_allclose(S.numpy(), np.asarray(jS), rtol=1e-6,
                                   atol=0)
    assert torch.equal(one[0], seg[0]) and torch.equal(one[1], seg[1])


def test_append_plan_slots_are_the_reference_loop_count():
    """The plan holds ``bound`` page slots per row, the reference's
    loop count (the pages any row appends into, capped by the chunk)."""
    ps = 4
    for rows, want in (([(1, 1), (1, 9), (0, 0)], 1),
                       ([(16, 16), (1, 3)], 4),
                       ([(3, 5), (0, 0)], 2),
                       ([(0, 0), (0, 0)], 0)):
        ql = np.asarray([r[0] for r in rows], np.int32)
        kl = np.asarray([r[1] for r in rows], np.int32)
        qs = np.arange(len(rows), dtype=np.int32) * 16
        tbls = np.arange(1, 1 + 6 * len(rows), dtype=np.int32) \
            .reshape(len(rows), 6)
        page, tok, sel = teng._append_plan(tbls, qs, ql, kl, ps, 16, 32)
        assert page.shape == (want * len(rows),)
        assert tok.shape == sel.shape == (want * len(rows), ps)
        # every live entry writes a page of its own row; dead ones the
        # null page
        for i, p in enumerate(page):
            row = i // max(want, 1)
            assert p == 0 if not sel[i].any() else p in tbls[row]


# ---------------------------------------------------------------------------
# the int8 pool
# ---------------------------------------------------------------------------

def test_int8_pool_accounting_matches_jax():
    from paddle_tpu.serving import kv_cache as jkv
    kw = dict(num_layers=2, num_kv_heads=2, head_dim=64, page_size=16)
    for tdt, jdt in ((torch.int8, jnp.int8), (torch.float32, jnp.float32),
                     (torch.bfloat16, jnp.bfloat16)):
        assert tkv.PagedKVPool.page_bytes_for(dtype=tdt, **kw) == \
            jkv.PagedKVPool.page_bytes_for(dtype=jdt, **kw)
        tp = tkv.PagedKVPool(2, 2, 64, num_pages=9, page_size=16, dtype=tdt)
        jp = jkv.PagedKVPool(2, 2, 64, num_pages=9, page_size=16, dtype=jdt)
        assert (tp.pool_bytes, tp.kv_bytes_per_token) == \
            (jp.pool_bytes, jp.kv_bytes_per_token)
        assert tp.quantized == jp.quantized == (tdt == torch.int8)
    with pytest.raises(ValueError, match="dtype"):
        tkv.PagedKVPool(1, 1, 4, num_pages=4, page_size=4,
                        dtype=torch.int16)
