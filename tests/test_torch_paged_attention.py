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


def _inputs(rows, *, q_block=4, num_pages=24, pps=5, slack=1, seed=0):
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
        for p in range(-(-kl // PS)):
            tables[i, p] = free.pop()
    q = rng.randn(t, HQ, D).astype(np.float32)
    k = rng.randn(HKV, num_pages, PS, D).astype(np.float32)
    v = rng.randn(HKV, num_pages, PS, D).astype(np.float32)
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
                                       "ragged_paged_attention"]
    path = _build.library_path("ragged_paged_attention")
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith("libragged_paged_attention-")
    assert path.suffix == ".so"
    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags and "-shared" in flags
