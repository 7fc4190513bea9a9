"""paddle_tpu_torch ragged paged attention against the JAX package.

The same numpy inputs (from ``np.random.RandomState``) go through the
JAX kernel in interpret mode, the JAX plain reference and the port's
plain PyTorch version. Tolerance: f32, ``atol=1e-5`` — the three sum
the same products in different orders. The port's CUDA kernel runs only
on the card: ``tests/test_torch_cuda_kernels.py``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.kernels import paged_attention as jpa
from paddle_tpu_torch.kernels import LAUNCHES, reset_launch_counts
from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels import paged_attention as tpa

ATOL = 1e-5

# GQA 4/2, small head dim; pages of 4 tokens
HQ, HKV, D, PS = 4, 2, 16, 4

#: (q_len, kv_len) per row; q_len 0 is a padding row
CASES = {
    # every row a decode step, kv lengths straddling page boundaries
    "decode": [(1, 1), (1, 4), (1, 5), (1, 13), (1, 16)],
    # prefill chunks over several pages: a first chunk and a mid-prompt
    # chunk whose earlier tokens sit on pages written by an earlier step
    "multipage_prefill": [(11, 11), (6, 19), (1, 9)],
    # padding rows after the live rows (q_start = T keeps the starts
    # ascending), dead blocks at the tail
    "padding_rows": [(3, 7), (1, 12), (0, 0), (0, 0)],
    # a 16-token first chunk at q_block 4: its first block's horizon is
    # page 0, so it must skip the three later pages the chunk wrote
    "horizon_skip": [(16, 16), (1, 2)],
}


def _inputs(rows, *, q_block=4, num_pages=24, pps=5, slack=1, seed=0,
            hq=HQ, hkv=HKV, ps=PS):
    """Packed queries, a random pool and the per-row metadata, as numpy.
    Rows take distinct random pool pages; slots start at q_block
    multiples; padding rows (last, as the engine packs them) start at T;
    ``slack`` extra dead q blocks close the buffer."""
    rng = np.random.RandomState(seed)
    r = len(rows)
    starts, cursor = [], 0
    for ql, _ in rows:
        starts.append(cursor)
        cursor += -(-ql // q_block) * q_block
    t = cursor + slack * q_block
    q_starts = np.full(r, t, np.int32)
    q_lens = np.zeros(r, np.int32)
    kv_lens = np.zeros(r, np.int32)
    tables = np.zeros((r, pps), np.int32)
    free = list(rng.permutation(np.arange(1, num_pages)))
    for i, (ql, kl) in enumerate(rows):
        if ql == 0:
            continue
        q_starts[i], q_lens[i], kv_lens[i] = starts[i], ql, kl
        for p in range(-(-kl // ps)):
            tables[i, p] = free.pop()
    q = rng.randn(t, hq, D).astype(np.float32)
    k = rng.randn(hkv, num_pages, ps, D).astype(np.float32)
    v = rng.randn(hkv, num_pages, ps, D).astype(np.float32)
    return q, k, v, tables, q_starts, q_lens, kv_lens


def _live_mask(t, q_starts, q_lens):
    live = np.zeros(t, bool)
    for s, n in zip(q_starts, q_lens):
        live[s:s + n] = True
    return live


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("case", sorted(CASES))
def test_ragged_plain_matches_jax_kernel_and_reference(case):
    rows = CASES[case]
    q, k, v, tables, q_starts, q_lens, kv_lens = _inputs(rows)
    reset_launch_counts()
    got = tpa.ragged_paged_attention(*_torch(q, k, v, tables, q_starts,
                                             q_lens, kv_lens), q_block=4)
    assert LAUNCHES["ragged_paged_attention"] == 0   # CPU: plain version
    got = got.numpy()
    kern = np.asarray(jpa.ragged_paged_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(tables),
        jnp.asarray(q_starts), jnp.asarray(q_lens), jnp.asarray(kv_lens),
        q_block=4, interpret=True))
    ref = np.asarray(jpa.ragged_paged_attention_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(tables),
        q_starts, q_lens, kv_lens))
    live = _live_mask(q.shape[0], q_starts, q_lens)
    # the JAX kernel leaves slot padding finite but unspecified: compare
    # live tokens with it, every token with the zero-padded reference
    np.testing.assert_allclose(got[live], kern[live], rtol=0, atol=ATOL)
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)
    assert not got[~live].any()


@pytest.mark.parametrize("q_block", [1, 2, 8])
def test_ragged_plain_independent_of_q_block(q_block):
    """The slot alignment moves where rows sit, not what they compute."""
    rows = CASES["multipage_prefill"]
    q, k, v, tables, q_starts, q_lens, kv_lens = _inputs(rows,
                                                         q_block=q_block)
    got = tpa.ragged_paged_attention(*_torch(q, k, v, tables, q_starts,
                                             q_lens, kv_lens),
                                     q_block=q_block).numpy()
    kern = np.asarray(jpa.ragged_paged_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(tables),
        jnp.asarray(q_starts), jnp.asarray(q_lens), jnp.asarray(kv_lens),
        q_block=q_block, interpret=True))
    live = _live_mask(q.shape[0], q_starts, q_lens)
    np.testing.assert_allclose(got[live], kern[live], rtol=0, atol=ATOL)


def test_ragged_plain_bf16_rounds_like_f32_then_casts():
    """bf16 inputs: f32 softmax and sums, one cast at the end."""
    q, k, v, tables, q_starts, q_lens, kv_lens = _inputs(
        CASES["multipage_prefill"])
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    ints = _torch(tables, q_starts, q_lens, kv_lens)
    got = tpa.ragged_paged_attention(tq, tk, tv, *ints, q_block=4)
    want = tpa.ragged_paged_attention(tq.float(), tk.float(), tv.float(),
                                      *ints, q_block=4).to(torch.bfloat16)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want)


@pytest.mark.parametrize("lens", [[1, 4, 5, 16], [15, 16, 17, 3],
                                  [20, 2, 9, 12]])
def test_paged_attention_wrapper_matches_jax(lens):
    rng = np.random.RandomState(3)
    b, npages, pps = len(lens), 24, 5
    q = rng.randn(b, HQ, D).astype(np.float32)
    k = rng.randn(HKV, npages, PS, D).astype(np.float32)
    v = rng.randn(HKV, npages, PS, D).astype(np.float32)
    tbl = rng.permutation(np.arange(1, npages))[:b * pps] \
        .reshape(b, pps).astype(np.int32)
    sl = np.asarray(lens, np.int32)
    got = tpa.paged_attention(*_torch(q, k, v, tbl, sl)).numpy()
    kern = np.asarray(jpa.paged_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(tbl),
        jnp.asarray(sl), interpret=True))
    ref = np.asarray(jpa.paged_attention_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(tbl),
        jnp.asarray(sl)))
    np.testing.assert_allclose(got, kern, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("q_starts,num_blocks,q_block", [
    ([0, 8, 16, 24], 4, 8),            # one block per row
    ([0, 24, 32, 40, 40], 6, 8),       # a long row, then pad rows at T
    ([0, 4, 12, 12], 5, 4),            # a row of two blocks, tail pads
    ([0, 1, 2, 3], 4, 1),              # q_block 1 (paged_attention)
])
def test_ragged_block_row_matches_jax(q_starts, num_blocks, q_block):
    qs = np.asarray(q_starts, np.int32)
    got = tpa.ragged_block_row(torch.from_numpy(qs), num_blocks, q_block)
    want = np.asarray(jpa.ragged_block_row(jnp.asarray(qs), num_blocks,
                                           q_block))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_cpu_calls_never_bump_the_launch_counter():
    q, k, v, tables, q_starts, q_lens, kv_lens = _inputs(CASES["decode"])
    reset_launch_counts()
    args = _torch(q, k, v, tables, q_starts, q_lens, kv_lens)
    tpa.ragged_paged_attention(*args, q_block=4)
    tpa.paged_attention(args[0][:3], args[1], args[2], args[3][:3],
                        args[6][:3])
    assert "ragged_paged_attention" in LAUNCHES
    assert all(n == 0 for n in LAUNCHES.values()), LAUNCHES


def test_wrapper_rejects_bad_shapes_and_devices():
    q, k, v, tables, q_starts, q_lens, kv_lens = _torch(
        *_inputs(CASES["decode"]))
    with pytest.raises(ValueError, match="multiple of q_block"):
        tpa.ragged_paged_attention(q[:-1], k, v, tables, q_starts, q_lens,
                                   kv_lens, q_block=4)
    with pytest.raises(ValueError, match="head_dim"):
        tpa.ragged_paged_attention(q[..., :8], k, v, tables, q_starts,
                                   q_lens, kv_lens, q_block=4)
    with pytest.raises(ValueError, match="kv heads"):
        tpa.ragged_paged_attention(q[:, :3], k, v, tables, q_starts,
                                   q_lens, kv_lens, q_block=4)
    meta = q.to("meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        tpa.ragged_paged_attention(meta, k, v, tables, q_starts, q_lens,
                                   kv_lens, q_block=4)
    assert LAUNCHES["ragged_paged_attention"] == 0


def test_build_names_libraries_by_source_hash():
    assert _build.kernel_sources() == ["decode_megakernel",
                                       "flash_attention", "fused_adamw",
                                       "int8_matmul",
                                       "prefill_megakernel",
                                       "ragged_paged_attention", "rms_norm"]
    path = _build.library_path("ragged_paged_attention")
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith("libragged_paged_attention-")
    assert path.suffix == ".so"
    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags and "-shared" in flags


# ---------------------------------------------------------------------------
# the CUDA kernel's arithmetic, emulated: split-KV runs and their merge
# ---------------------------------------------------------------------------

#: kv positions per staged tile and per tensor-core chunk (the kernel's)
TILE, CHUNK = 64, 16
LOG2E = 1.4426950408889634

#: rows that span several runs: a 20-token chunk of a 200-token prompt,
#: long decode rows, horizons of exactly one run and one position past
#: it (16-token pages, 13 per row)
MULTI_RUN = dict(rows=[(20, 200), (1, 150), (1, 65), (1, 64), (1, 1)],
                 num_pages=48, pps=13, ps=16)


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _run_state(qr, kr, vr, ksr, vsr, lim, pos0, tiles, tensor_cores):
    """(m, l, acc) of one split's run over tiles ``tiles`` for the query
    rows ``qr`` [n, d] (last visible position ``lim`` [n]) against the
    block's staged K/V rows ``kr``/``vr`` [P, d] (f32 values; int8
    widened) and per-position page scales (or None), log2 domain.
    CUDA cores: one online-softmax step per 64-position tile, all f32.
    Tensor cores: 16-position chunks dealt to the warps of each 16-row
    tile (4 warps for one row tile, 2 for two, 1 for 3-4, passes of 4
    tiles); P rounded to bf16 as the P.V operand; the warps of a row
    tile combined in warp order."""
    n, d = qr.shape
    sl2 = torch.tensor(d ** -0.5, dtype=torch.float32) * LOG2E
    neg = torch.tensor(-1e30, dtype=torch.float32)

    def step(m, l, acc, rows, p0, p1):
        x = (qr[rows] @ kr[p0:p1].T) * sl2
        if ksr is not None:
            x = x * ksr[p0:p1]
        pos = torch.arange(p0, p1) + pos0
        x = x.masked_fill(pos[None, :] > lim[rows, None], -torch.inf)
        mx = torch.maximum(m, x.max(1).values)
        alpha = torch.exp2(m - mx)
        p = torch.exp2(x - mx[:, None])
        l = l * alpha + p.sum(1)
        w = p * vsr[p0:p1] if vsr is not None else p
        if tensor_cores:
            w = _bf16(w)
        return mx, l, acc * alpha[:, None] + w @ vr[p0:p1]

    m = torch.full((n,), -1e30)
    l = torch.zeros(n)
    acc = torch.zeros(n, d)
    if not tensor_cores:
        for it in tiles:
            m, l, acc = step(m, l, acc, slice(None), it * TILE,
                             (it + 1) * TILE)
        return m, l, acc
    tiles_n = -(-n // 16)
    for pt0 in range(0, tiles_n, 4):
        nt = min(4, tiles_n - pt0)
        wp = 4 if nt == 1 else 2 if nt == 2 else 1
        for rt in range(pt0, pt0 + nt):
            rows = slice(rt * 16, min(n, rt * 16 + 16))
            nr = rows.stop - rows.start
            states = []
            for sl in range(wp):
                st = (torch.full((nr,), -1e30), torch.zeros(nr),
                      torch.zeros(nr, d))
                for it in tiles:
                    for c in range(sl, TILE // CHUNK, wp):
                        p0 = it * TILE + c * CHUNK
                        if pos0 + p0 > lim.max():
                            break
                        st = step(*st, rows, p0, p0 + CHUNK)
                states.append(st)
            mm = torch.stack([s_[0] for s_ in states]).max(0).values
            mm = torch.maximum(mm, neg)
            ll, aa = torch.zeros(nr), torch.zeros(nr, d)
            for s_m, s_l, s_a in states:          # warp order
                f = torch.exp2(s_m - mm)
                ll = ll + s_l * f
                aa = aa + s_a * f[:, None]
            m[rows], l[rows], acc[rows] = mm, ll, aa
    return m, l, acc


def _emulate_kernel(q, k, v, tables, q_starts, q_lens, kv_lens, *,
                    q_block, splits, tensor_cores, k_scales=None,
                    v_scales=None):
    """The ragged kernel's arithmetic in plain PyTorch: per (q block, kv
    head), the causal horizon's 64-position tiles dealt into
    ``min(splits, tiles)`` near-equal runs, each run's (m, l, acc) from
    :func:`_run_state`, the runs merged in order (one run: acc / l).
    Tensor cores take bf16 q, K and V (int8 pools exact)."""
    t, hq, d = q.shape
    hkv, _, ps, _ = k.shape
    group = hq // hkv
    q, k, v = (x.float() for x in (q, k, v))
    if tensor_cores:
        q, k, v = _bf16(q), _bf16(k), _bf16(v)
    out = torch.zeros(t, hq, d)
    brow = tpa.ragged_block_row(torch.from_numpy(q_starts), t // q_block,
                                q_block).numpy()
    for g, row in enumerate(brow):
        ql, kl = int(q_lens[row]), int(kv_lens[row])
        kv_start, off = kl - ql, g * q_block - int(q_starts[row])
        if not 0 <= off < ql:
            continue
        live = min(q_block, ql - off)
        horizon = min(kl, kv_start + off + live)
        tiles = -(-horizon // TILE)
        runs = max(1, min(splits, tiles))
        pos = torch.arange(tiles * TILE)
        ok = pos < horizon
        page = torch.from_numpy(tables[row]).long()[
            torch.where(ok, pos // ps, 0)]
        r = torch.arange(live * group)
        tok, head = off + r // group, r % group
        lim = kv_start + tok
        for h in range(hkv):
            kr = torch.where(ok[:, None], k[h, page, pos % ps], 0.)
            vr = torch.where(ok[:, None], v[h, page, pos % ps], 0.)
            ksr = vsr = None
            if k_scales is not None:
                ksr = torch.where(ok, k_scales[h, page], 0.)
                vsr = torch.where(ok, v_scales[h, page], 0.)
            qr = q[g * q_block + r // group, h * group + head]
            parts = [_run_state(qr, kr, vr, ksr, vsr, lim, 0,
                                range(s * tiles // runs,
                                      (s + 1) * tiles // runs),
                                tensor_cores) for s in range(runs)]
            if runs == 1:
                m, l, acc = parts[0]
                o = acc / l[:, None]
            else:
                mm = torch.stack([p_[0] for p_ in parts]).max(0).values
                ll, aa = torch.zeros_like(mm), torch.zeros_like(parts[0][2])
                for s_m, s_l, s_a in parts:        # split order
                    f = torch.exp2(s_m - mm)
                    ll = ll + s_l * f
                    aa = aa + s_a * f[:, None]
                o = aa / ll[:, None]
            out[g * q_block + r // group, h * group + head] = o
    return out


#: (case, q_block, (hq, hkv), splits): every CASES entry at the wrapper's
#: split count, and rows over several runs at uneven and full split
#: counts, one at GQA 8/1 with q_block 8 (64 rows: a warp per row tile)
ROUNDING_CASES = [(c, 4, (HQ, HKV), None) for c in sorted(CASES)] + [
    ("multi_run", 4, (HQ, HKV), None), ("multi_run", 4, (HQ, HKV), 3),
    ("multi_run", 4, (HQ, HKV), 8), ("multi_run", 4, (8, 2), 8),
    ("multi_run", 8, (8, 1), 8)]


def _rounding_inputs(case, q_block, heads):
    if case == "multi_run":
        kw = dict(MULTI_RUN)
        rows = kw.pop("rows")
    else:
        rows, kw = CASES[case], {}
    return _inputs(rows, q_block=q_block, hq=heads[0], hkv=heads[1], **kw)


def _jax_kernel(q, k, v, tables, q_starts, q_lens, kv_lens, q_block,
                **scales):
    return np.asarray(jpa.ragged_paged_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(tables),
        jnp.asarray(q_starts), jnp.asarray(q_lens), jnp.asarray(kv_lens),
        q_block=q_block, interpret=True,
        **{n: jnp.asarray(x) for n, x in scales.items()}))


def _splits(q, tables, q_block, hkv, ps, splits):
    return splits or tpa.ragged_splits(q.shape[0] // q_block, hkv,
                                       tables.shape[1], ps)


@pytest.mark.parametrize("case,q_block,heads,splits", ROUNDING_CASES,
                         ids=lambda x: str(x))
@pytest.mark.parametrize("body", ["cuda_cores_f32", "tensor_cores_bf16"])
def test_ragged_rounding_split_merge_matches_jax_kernel(case, q_block, heads,
                                                        splits, body):
    """The split runs and their in-order merge against the Pallas kernel
    in interpret mode. f32 (CUDA cores): only the summation order
    changes, 1e-5. bf16 (tensor cores): q, K, V in bf16 and P rounded to
    bf16 as an operand, within the card's bf16 tolerance 2e-2 x max(1,
    max|ref|)."""
    q, k, v, tables, q_starts, q_lens, kv_lens = _rounding_inputs(
        case, q_block, heads)
    tc = body.startswith("tensor")
    if tc:   # the card's inputs are bf16: both sides see the same values
        q, k, v = (_bf16(torch.from_numpy(x)).numpy() for x in (q, k, v))
    ps = k.shape[2]
    s = _splits(q, tables, q_block, heads[1], ps, splits)
    got = _emulate_kernel(*_torch(q, k, v), tables, q_starts, q_lens,
                          kv_lens, q_block=q_block, splits=s,
                          tensor_cores=tc).numpy()
    want = _jax_kernel(q, k, v, tables, q_starts, q_lens, kv_lens, q_block)
    live = _live_mask(q.shape[0], q_starts, q_lens)
    tol = 2e-2 * max(1.0, np.abs(want[live]).max()) if tc else ATOL
    np.testing.assert_allclose(got[live], want[live], rtol=0, atol=tol)
    assert not got[~live].any()
    if case == "multi_run":
        assert s > 1 and max(kv_lens) > TILE * 2


@pytest.mark.parametrize("case,q_block,heads,splits",
                         [("mixed", 4, (HQ, HKV), None),
                          ("multi_run", 4, (HQ, HKV), 8),
                          ("multi_run", 8, (8, 1), 3)],
                         ids=lambda x: str(x))
@pytest.mark.parametrize("body", ["cuda_cores_f32", "tensor_cores_bf16"])
def test_ragged_rounding_int8_pool_scale_order_matches_jax_kernel(
        case, q_block, heads, splits, body):
    """int8 pools: the K scale multiplies the f32 score, the V scale each
    probability's weight on v before its bf16 rounding, l the unscaled
    probability; against the Pallas int8 kernel in interpret mode at the
    same tolerances."""
    if case == "mixed":
        rows = [(1, 1), (1, 5), (6, 19), (3, 7), (1, 12), (0, 0)]
        q, _, _, tables, q_starts, q_lens, kv_lens = _inputs(
            rows, q_block=q_block, hq=heads[0], hkv=heads[1], num_pages=40,
            pps=6)
    else:
        q, _, _, tables, q_starts, q_lens, kv_lens = _rounding_inputs(
            case, q_block, heads)
    rng = np.random.RandomState(7)
    num_pages = int(tables.max()) + 1
    ps = MULTI_RUN["ps"] if case == "multi_run" else PS
    k, v = (rng.randint(-127, 128, (heads[1], num_pages, ps, D))
            .astype(np.int8) for _ in range(2))
    ks, vs = ((rng.rand(heads[1], num_pages) * 0.05 + 0.01)
              .astype(np.float32) for _ in range(2))
    tc = body.startswith("tensor")
    if tc:
        q = _bf16(torch.from_numpy(q)).numpy()
    s = _splits(q, tables, q_block, heads[1], ps, splits)
    got = _emulate_kernel(*_torch(q, k, v), tables, q_starts, q_lens,
                          kv_lens, q_block=q_block, splits=s,
                          tensor_cores=tc, k_scales=torch.from_numpy(ks),
                          v_scales=torch.from_numpy(vs)).numpy()
    want = _jax_kernel(q, k, v, tables, q_starts, q_lens, kv_lens, q_block,
                       k_scales=ks, v_scales=vs)
    live = _live_mask(q.shape[0], q_starts, q_lens)
    tol = 2e-2 * max(1.0, np.abs(want[live]).max()) if tc else ATOL
    np.testing.assert_allclose(got[live], want[live], rtol=0, atol=tol)


@pytest.mark.parametrize("nb,hkv,pps,ps,want", [
    (16, 32, 64, 16, 2),     # the 7B step: T 128, q_block 8, 64-page rows
    (256, 32, 64, 16, 1),    # a 2048-token step keeps one split
    (4, 2, 6, 16, 2),        # 96-position rows: two tiles
    (4, 2, 4, 16, 1),        # one tile: one run, no merge
    (12, 32, 128, 16, 3),    # 1024 / (12 x 32) rounds up to 3
    (2, 2, 64, 16, 8),       # few blocks: at most 8
])
def test_ragged_splits_from_shapes(nb, hkv, pps, ps, want):
    assert tpa.ragged_splits(nb, hkv, pps, ps) == want
