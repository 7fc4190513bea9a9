"""The prefill megakernel's tensor-core attention, emulated in plain
PyTorch, against the JAX package's ragged paged-attention kernel in
interpret mode and the port's plain version.

The CUDA kernel (``csrc/prefill_megakernel.cu``, phase "attention") runs
a unit of 16 query rows of one sequence row and kv head (two q blocks
of the row when a q block holds 8 query rows per kv head), walks the
row's causal horizon 16 positions at a time with an online softmax (two
warps, each a contiguous half of the steps, their states merged in
order), and feeds P (times the page's V scale for an int8 pool; the K
scale multiplies the score) to P.V as three bf16 parts, each the
rounding of what the parts before it left. The plain version stays
all-f32
(``ragged_paged_attention_reference``). This emulation repeats the
kernel's steps and rounding points at narrow widths; the card holds the
kernel itself to the plain version (``tests/test_torch_cuda_kernels.py``).

Tolerance: the card's for bf16 attention, 2e-2 x max(1, max|ref|) (as
the ragged kernel's, whose P is one bf16 part); dead tokens are zeros on
every side.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels import paged_attention as jpa
from paddle_tpu_torch.kernels import paged_attention as tpa

#: (q_len, kv_len) per row: a chunk of 3 q blocks (a pair and a lone
#: block), decode rows, a continuation chunk of 24 over earlier pages, a
#: decode row at position 0, a pad row
ROWS = [(21, 21), (1, 37), (24, 70), (1, 1), (1, 50), (0, 0)]
PS, QB = 16, 8
HEADS = [(4, 4, 32), (8, 2, 64), (8, 1, 64), (2, 2, 128)]


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _inputs(heads, quant, seed=0):
    H, Hkv, dh = heads
    rng = np.random.RandomState(seed)
    R = len(ROWS)
    T = sum(-(-ql // QB) * QB for ql, _ in ROWS) + QB
    q_starts = np.full(R, T, np.int32)
    q_lens = np.zeros(R, np.int32)
    kv_lens = np.zeros(R, np.int32)
    pps = max(-(-kl // PS) for _, kl in ROWS)
    num_pages = sum(-(-kl // PS) for _, kl in ROWS) + 2
    tables = np.zeros((R, pps), np.int32)
    free = list(rng.permutation(np.arange(1, num_pages)))
    cur = 0
    for i, (ql, kl) in enumerate(ROWS):
        if ql == 0:
            continue
        q_starts[i], q_lens[i], kv_lens[i] = cur, ql, kl
        for p in range(-(-kl // PS)):
            tables[i, p] = free.pop()
        cur += -(-ql // QB) * QB
    q = _bf16(torch.from_numpy(rng.randn(T, H, dh).astype(np.float32)))
    scales = {}
    if quant:
        k, v = (rng.randint(-127, 128, (Hkv, num_pages, PS, dh))
                .astype(np.int8) for _ in range(2))
        scales = {n: (rng.rand(Hkv, num_pages) * 0.05 + 0.01)
                  .astype(np.float32) for n in ("k_scales", "v_scales")}
    else:
        k, v = (_bf16(torch.from_numpy(rng.randn(Hkv, num_pages, PS, dh)
                                       .astype(np.float32))).numpy()
                for _ in range(2))
    return q.numpy(), k, v, tables, q_starts, q_lens, kv_lens, scales


def _emulate(q, k, v, tables, q_starts, q_lens, kv_lens, *, q_block,
             pair_blocks=True, k_scales=None, v_scales=None):
    """The kernel's attention phase, unit by unit (see the module
    docstring)."""
    q, k, v = (torch.from_numpy(np.asarray(x)).float() for x in (q, k, v))
    T, H, dh = q.shape
    Hkv = k.shape[0]
    grp = H // Hkv
    scale = 1.0 / dh ** 0.5
    per = grp * q_block
    GB = 16 // per if pair_blocks and per < 16 and 16 % per == 0 else 1
    rows_u = GB * per
    nb = T // q_block
    brow = np.maximum(np.searchsorted(q_starts, np.arange(nb) * q_block,
                                      side="right") - 1, 0)
    out = torch.zeros(T, H, dh)
    for i0 in range(nb):
        row = brow[i0]
        qs, ql, kl = (int(x[row]) for x in (q_starts, q_lens, kv_lens))
        off = i0 * q_block - qs
        if not (0 <= off < ql and (off // q_block) % GB == 0):
            continue
        kv0 = kl - ql
        last = min(ql - 1, (i0 + GB) * q_block - 1 - qs)
        horizon = min(kl, kv0 + last + 1)
        tbl = torch.from_numpy(tables[row]).long()
        for hk in range(Hkv):
            for tile in range(-(-rows_u // 16)):
                r = tile * 16 + torch.arange(16)
                b, wi = r // per, r % per
                tok = (i0 + b) * q_block + wi % q_block
                head = hk * grp + wi // q_block
                offs = tok - qs
                lim = torch.where((r < rows_u) & (offs < ql), kv0 + offs,
                                  torch.full_like(offs, -1))
                live = lim >= 0
                qr = torch.where(live[:, None],
                                 q[tok.clamp(max=T - 1), head], 0.)
                # two warps, each half of the steps, merged in order
                steps = -(-horizon // 16)
                states = []
                for s0, s1 in ((0, steps // 2), (steps // 2, steps)):
                    states.append(_run(qr, k[hk], v[hk], tbl, lim, horizon,
                                       range(s0 * 16, s1 * 16, 16), scale,
                                       k_scales, v_scales, hk))
                (m, l_, acc), (m2, l2, acc2) = states
                mx = torch.maximum(m, m2)
                fa, fb = torch.exp(m - mx), torch.exp(m2 - mx)
                l_ = l_ * fa + l2 * fb
                acc = acc * fa[:, None] + acc2 * fb[:, None]
                for x in torch.nonzero(live).flatten().tolist():
                    out[tok[x], head[x]] = acc[x] / l_[x]
    return _bf16(out)


def _run(qr, k, v, tbl, lim, horizon, starts, scale, k_scales, v_scales,
         hk):
    """One warp's (m, l, acc) over the 16-position steps at ``starts``."""
    m = torch.full((16,), -1e30)
    l_ = torch.zeros(16)
    acc = torch.zeros(16, qr.shape[1])
    for p0 in starts:
        pos = p0 + torch.arange(16)
        ok = pos < horizon
        page = tbl[torch.where(ok, pos // PS, 0)]
        kr = torch.where(ok[:, None], k[page, pos % PS], 0.)
        vr = torch.where(ok[:, None], v[page, pos % PS], 0.)
        s = qr @ kr.T
        if k_scales is not None:
            ks = torch.from_numpy(k_scales)[hk, page]
            s = s * torch.where(ok, ks, 0.) * scale
        else:
            s = s * scale
        vis = pos[None, :] <= lim[:, None]
        s = torch.where(vis, s, torch.tensor(-1e30))
        mx = torch.maximum(m, s.max(1).values)
        alpha = torch.exp(m - mx)
        m = mx
        ex = torch.where(vis, torch.exp(s - m[:, None]), 0.)
        l_ = l_ * alpha + ex.sum(1)
        pr = ex
        if v_scales is not None:
            vs = torch.from_numpy(v_scales)[hk, page]
            pr = ex * torch.where(ok, vs, 0.)[None, :]
        acc = acc * alpha[:, None]
        for _ in range(3):       # P in three bf16 parts
            part = _bf16(pr)
            acc = acc + part @ vr
            pr = pr - part
    return m, l_, acc


def _live(T, q_starts, q_lens):
    live = np.zeros(T, bool)
    for s, n in zip(q_starts, q_lens):
        live[s:s + n] = True
    return live


@pytest.mark.parametrize("pair", [True, False], ids=["pairs", "single"])
@pytest.mark.parametrize("pool", ["bf16", "int8"])
@pytest.mark.parametrize("heads", HEADS,
                         ids=lambda h: f"h{h[0]}_kv{h[1]}_d{h[2]}")
def test_prefill_attention_rounding_matches_jax_kernel(heads, pool, pair):
    q, k, v, tables, qs, ql, kl, sc = _inputs(heads, pool == "int8")
    got = _emulate(q, k, v, tables, qs, ql, kl, q_block=QB,
                   pair_blocks=pair, **sc).numpy()
    want = np.asarray(jpa.ragged_paged_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(tables),
        jnp.asarray(qs), jnp.asarray(ql), jnp.asarray(kl), q_block=QB,
        interpret=True, **{n: jnp.asarray(x) for n, x in sc.items()}))
    plain = tpa.ragged_paged_attention_reference(
        *(torch.from_numpy(np.asarray(x)) for x in (q, k, v, tables, qs, ql,
                                                     kl)),
        **{n: torch.from_numpy(x) for n, x in sc.items()}).numpy()
    live = _live(q.shape[0], qs, ql)
    tol = 2e-2 * max(1.0, np.abs(want[live]).max())
    np.testing.assert_allclose(got[live], want[live], rtol=0, atol=tol)
    np.testing.assert_allclose(got[live], plain[live], rtol=0, atol=tol)
    assert not got[~live].any() and not plain[~live].any()


def test_units_pair_q_blocks_of_one_row_only():
    """With one query head per kv head and q_block 8, a unit holds two
    q blocks of the same row: the 21-token chunk's blocks 0-1 and its
    lone block 2, the 24-token chunk's 3 blocks likewise; decode rows a
    unit each (half a tile)."""
    q, k, v, tables, qs, ql, kl, _ = _inputs((4, 4, 32), False)
    nb = q.shape[0] // QB
    brow = np.maximum(np.searchsorted(qs, np.arange(nb) * QB,
                                      side="right") - 1, 0)
    leaders = [i for i in range(nb)
               if 0 <= i * QB - qs[brow[i]] < ql[brow[i]] and
               ((i * QB - qs[brow[i]]) // QB) % 2 == 0]
    assert leaders == [0, 2, 3, 4, 6, 7, 8]
