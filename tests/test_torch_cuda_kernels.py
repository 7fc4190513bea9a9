"""paddle_tpu_torch's CUDA kernels on the card, against their plain
PyTorch versions on the same tensors.

Every test here needs an NVIDIA card (``cuda`` marker) and skips
without one. The file imports neither JAX nor ``paddle_tpu``, so it runs
on a machine that has only the port's dependencies:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda_kernels.py

Tolerances: f32 ``1e-4`` (the kernel sums in another order than the
plain version); bf16 ``2e-2`` (outputs may round one bf16 ulp apart);
the dequant-matmul's are stated beside its test.
"""
import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
from paddle_tpu_torch.kernels import LAUNCHES, reset_launch_counts
from paddle_tpu_torch.kernels import paged_attention as tpa

ATOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}

#: (q_len, kv_len) per row, padding rows (q_len 0) last
CASES = {
    "decode": [(1, 1), (1, 16), (1, 17), (1, 70), (1, 129)],
    "multipage_prefill": [(37, 37), (20, 45), (1, 9), (0, 0)],
    "mixed": [(1, 1), (1, 37), (20, 45), (8, 8), (13, 70), (1, 16), (0, 0),
              (0, 0)],
    # a horizon of exactly one 64-position run (written by the split
    # itself), one a position past it (two runs and the merge), kv 1
    "run_edge": [(1, 64), (1, 65), (1, 1)],
    # the 7B prefill step's chunk (its blocks' horizons span many runs)
    # beside decode rows
    "prefill_7b": [(64, 600), (1, 49), (1, 128), (1, 233), (1, 560)],
    # chunks whose q_len is not a multiple of q_block, over several runs
    "chunk_tail": [(19, 150), (5, 5), (1, 3)],
}

#: (hq, hkv, d): GQA 8/2 at d 128, MHA at d 32, the Llama-2-7B heads and
#: the llama_1b heads (GQA 32/4, d 64)
HEADS = {"gqa8_2": (8, 2, 128), "mha4_d32": (4, 4, 32),
         "llama7b": (32, 32, 128), "llama1b": (32, 4, 64)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(rows, dev, dtype, *, hq, hkv, d, ps=16, q_block=8, seed=0):
    rng = np.random.RandomState(seed)
    r = len(rows)
    pps = max(-(-kl // ps) for _, kl in rows)
    num_pages = r * pps + 1
    t = sum(-(-ql // q_block) * q_block for ql, _ in rows) + q_block
    q_starts = np.full(r, t, np.int32)
    q_lens = np.zeros(r, np.int32)
    kv_lens = np.zeros(r, np.int32)
    tables = np.zeros((r, pps), np.int32)
    free = list(rng.permutation(np.arange(1, num_pages)))
    cursor = 0
    for i, (ql, kl) in enumerate(rows):
        if ql == 0:
            continue
        q_starts[i], q_lens[i], kv_lens[i] = cursor, ql, kl
        tables[i, :-(-kl // ps)] = [free.pop() for _ in range(-(-kl // ps))]
        cursor += -(-ql // q_block) * q_block
    fl = [torch.from_numpy(rng.randn(*shape).astype(np.float32))
          .to(dev, dtype) for shape in ((t, hq, d),
                                        (hkv, num_pages, ps, d),
                                        (hkv, num_pages, ps, d))]
    ints = [torch.from_numpy(a).to(dev)
            for a in (tables, q_starts, q_lens, kv_lens)]
    return fl + ints


def _merges(args, hkv, q_block=8, ps=16):
    """Merge launches one call makes: 1 when the wrapper splits the kv
    walk (more than one split), else 0."""
    t, pps = args[0].shape[0], args[3].shape[1]
    return int(tpa.ragged_splits(t // q_block, hkv, pps, ps) > 1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("heads", sorted(HEADS))
@pytest.mark.parametrize("case", sorted(CASES))
def test_ragged_kernel_matches_plain_version(cuda, case, heads, dtype):
    hq, hkv, d = HEADS[heads]
    args = _inputs(CASES[case], cuda, dtype, hq=hq, hkv=hkv, d=d)
    reset_launch_counts()
    got = tpa.ragged_paged_attention(*args, q_block=8)
    torch.cuda.synchronize()
    assert LAUNCHES["ragged_paged_attention"] == 1
    assert LAUNCHES["ragged_paged_attention_merge"] == _merges(args, hkv)
    want = tpa.ragged_paged_attention_reference(*args)
    assert got.dtype == dtype and got.shape == want.shape
    assert torch.isfinite(got.float()).all()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= ATOL[dtype], err


@pytest.mark.cuda
@pytest.mark.parametrize("pool", ["fp", "int8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", ["mixed", "prefill_7b"])
def test_ragged_kernel_two_calls_are_bitwise_equal(cuda, case, dtype, pool):
    """Splits write partials and the merge adds them in split order, no
    atomics: two calls give the same bits."""
    args = _inputs(CASES[case], cuda, dtype, hq=8, hkv=2, d=128)
    kw = {}
    if pool == "int8":
        args, ks, vs = _int8_pools(args)
        kw = dict(k_scales=ks, v_scales=vs)
    first = tpa.ragged_paged_attention(*args, q_block=8, **kw)
    second = tpa.ragged_paged_attention(*args, q_block=8, **kw)
    torch.cuda.synchronize()
    assert _merges(args, 2) == 1
    assert torch.equal(first, second)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d,pool,body", [
    (torch.float32, 32, "fp", "cuda cores"),
    (torch.float32, 128, "int8", "cuda cores"),
    (torch.bfloat16, 24, "fp", "cuda cores"),
    (torch.bfloat16, 32, "fp", "tensor cores"),
    (torch.bfloat16, 64, "int8", "tensor cores"),
    (torch.bfloat16, 128, "fp", "tensor cores"),
    (torch.bfloat16, 128, "int8", "tensor cores"),
], ids=["f32_d32", "f32_d128_int8", "bf16_d24", "bf16_d32", "bf16_d64_int8",
        "bf16_d128", "bf16_d128_int8"])
def test_ragged_kernel_body_follows_dtype_and_head_dim(cuda, dtype, d, pool,
                                                       body):
    """The body is fixed by q's dtype and head_dim: the library records
    which one each launch took (``chip_smoke.py [build]`` shows the
    tensor-core body's HMMA instructions)."""
    args = _inputs(CASES["mixed"], cuda, dtype, hq=4, hkv=2, d=d)
    kw = {}
    if pool == "int8":
        args, ks, vs = _int8_pools(args)
        kw = dict(k_scales=ks, v_scales=vs)
    other = "cuda cores" if body == "tensor cores" else "tensor cores"
    # a launch of the other body first, so the record below is this call's
    tpa.ragged_paged_attention(
        *_inputs(CASES["mixed"], cuda, torch.bfloat16 if other ==
                 "tensor cores" else torch.float32, hq=4, hkv=2, d=32),
        q_block=8)
    assert tpa.ragged_last_body() == other
    reset_launch_counts()
    got = tpa.ragged_paged_attention(*args, q_block=8, **kw)
    torch.cuda.synchronize()
    assert tpa.ragged_last_body() == body
    assert LAUNCHES["ragged_paged_attention_merge"] == 1
    want = tpa.ragged_paged_attention_reference(*args, **kw)
    assert (got.float() - want.float()).abs().max().item() <= ATOL[dtype]


@pytest.mark.cuda
def test_paged_attention_wrapper_launches_the_kernel(cuda):
    rng = np.random.RandomState(1)
    b, hq, hkv, d, ps, npages = 4, 8, 2, 64, 16, 20
    q = torch.from_numpy(rng.randn(b, hq, d).astype(np.float32)).to(cuda)
    k, v = (torch.from_numpy(rng.randn(hkv, npages, ps, d)
                             .astype(np.float32)).to(cuda) for _ in range(2))
    tbl = torch.from_numpy(rng.permutation(np.arange(1, npages))[:b * 4]
                           .reshape(b, 4).astype(np.int32)).to(cuda)
    lens = torch.tensor([1, 16, 33, 64], dtype=torch.int32, device=cuda)
    reset_launch_counts()
    got = tpa.paged_attention(q, k, v, tbl, lens)
    assert LAUNCHES["ragged_paged_attention"] == 1
    want = tpa.paged_attention(q.cpu(), k.cpu(), v.cpu(), tbl.cpu(),
                               lens.cpu())
    assert (got.cpu() - want).abs().max().item() <= ATOL[torch.float32]


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda):
    args = _inputs(CASES["decode"], cuda, torch.float16, hq=4, hkv=2, d=32)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tpa.ragged_paged_attention(*args, q_block=8)
    args = _inputs(CASES["decode"], cuda, torch.float32, hq=4, hkv=2, d=12)
    with pytest.raises(ValueError, match="multiple of 8"):
        tpa.ragged_paged_attention(*args, q_block=8)
    args = _inputs(CASES["decode"], cuda, torch.float32, hq=4, hkv=2, d=32)
    args[4] = args[4].long()
    with pytest.raises(TypeError, match="int32"):
        tpa.ragged_paged_attention(*args, q_block=8)


def _engine_merges(eng, cfg):
    """Merge launches per attention call of the engine's fixed step."""
    return int(tpa.ragged_splits(eng.step_token_budget // eng.q_block,
                                 cfg.num_key_value_heads,
                                 eng.max_pages_per_seq, eng.page_size) > 1)


@pytest.mark.cuda
def test_engine_on_the_card_matches_the_cpu(cuda):
    """Greedy tokens of a small f32 Llama: the engine on the card (every
    attention call through the kernel) equals the engine on the CPU."""
    cfg = pt.llama_tiny_config(num_hidden_layers=2, num_key_value_heads=2)
    model = pt.LlamaForCausalLM(cfg, device="cpu",
                                generator=torch.Generator().manual_seed(0))
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size, (n,)).tolist()
               for n in (3, 17, 40, 9)]
    tokens = {}
    for dev in ("cpu", "cuda"):
        eng = pt.LLMEngine(model, max_len=96, page_size=16, max_num_seqs=4,
                           chunk_size=16, device=dev)
        rids = [eng.add_request(p, max_new_tokens=6) for p in prompts]
        reset_launch_counts()
        outs = eng.run(max_steps=200)
        launches = LAUNCHES["ragged_paged_attention"]
        steps = eng.metrics_snapshot()["decode_steps"]
        assert launches == (cfg.num_hidden_layers * steps
                            if dev == "cuda" else 0)
        assert LAUNCHES["ragged_paged_attention_merge"] == \
            launches * _engine_merges(eng, cfg)
        assert eng.pool.check_invariants()
        tokens[dev] = [outs[r].token_ids for r in rids]
    assert tokens["cuda"] == tokens["cpu"]


# ---------------------------------------------------------------------------
# low-bit serving: the dequant-matmul and the ragged kernel over int8 pools
# ---------------------------------------------------------------------------

#: dequant-matmul vs plain version, max |diff| over max(1, max |plain|):
#: f32 sums in another order (and applies the scale after the sum); bf16
#: outputs may round one or two bf16 ulps apart
MATMUL_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}

#: (K, N): the 7B projections (q/k/v/o, gate/up, down), odd K with a
#: ragged N, an N below one tile
MATMUL_SHAPES = [(4096, 4096), (4096, 11008), (11008, 4096), (1023, 200),
                 (257, 40)]


def _quantized(k, n, bits, dev, seed=0):
    from paddle_tpu_torch.quantization import low_bit
    g = torch.Generator().manual_seed(seed)
    w = torch.randn(k, n, generator=g) * 0.02
    qw = low_bit.quantize_weight(w, "weight_only_int8" if bits == 8
                                 else "weight_only_int4")
    return qw.qdata.to(dev), qw.scale.to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("m", [1, 8, 128, 200])
@pytest.mark.parametrize("shape", MATMUL_SHAPES,
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_dequant_matmul_kernel_matches_plain_version(cuda, shape, m, bits,
                                                     dtype):
    from paddle_tpu_torch.kernels import int8_matmul as tmm
    k, n = shape
    wq, sc = _quantized(k, n, bits, cuda, seed=k + m)
    g = torch.Generator().manual_seed(m)
    x = torch.randn(m, k, generator=g).to(cuda, dtype)
    reset_launch_counts()
    got = tmm.dequant_matmul(x, wq, sc, rows=k, bits=bits)
    torch.cuda.synchronize()
    assert LAUNCHES["int8_matmul" if bits == 8 else "int4_matmul"] == 1
    want = tmm.dequant_matmul_reference(x, wq, sc, k, bits)
    assert got.dtype == dtype and got.shape == (m, n)
    assert torch.isfinite(got.float()).all()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= MATMUL_TOL[dtype] * max(1.0, want.float().abs().max()
                                          .item()), err


@pytest.mark.cuda
def test_dequant_matmul_rejects_what_it_does_not_take(cuda):
    from paddle_tpu_torch.kernels import int8_matmul as tmm
    wq, sc = _quantized(64, 32, 8, cuda)
    x = torch.zeros(4, 64, device=cuda)
    reset_launch_counts()
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tmm.dequant_matmul(x.half(), wq, sc)
    with pytest.raises(TypeError, match="int8"):
        tmm.dequant_matmul(x, wq.cpu(), sc)
    with pytest.raises(TypeError, match="scale"):
        tmm.dequant_matmul(x, wq, sc[:-1])
    with pytest.raises(ValueError, match="contiguous"):
        tmm.dequant_matmul(torch.zeros(64, 4, device=cuda).t(), wq, sc)
    with pytest.raises(ValueError, match="unit column stride"):
        tmm.dequant_matmul(x, wq.t().contiguous().t(), sc)
    with pytest.raises(ValueError, match="payload rows"):
        tmm.dequant_matmul(x, wq, sc, rows=64, bits=4)
    assert LAUNCHES["int4_matmul"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("m", [8, 128])
def test_dequant_matmul_reads_a_column_slice_in_place(cuda, m, bits):
    """The k|v columns of a fused q|k|v payload (row stride 3 x 512, the
    fused int8 + int8-KV layer's slice at a small width): the kernel reads
    the view in place, bitwise as it reads a contiguous copy of it, and
    within the bf16 tolerance of the plain version."""
    from paddle_tpu_torch.kernels import int8_matmul as tmm
    k, width, lo = 512, 3 * 512, 512
    wq, sc = _quantized(k, width, bits, cuda, seed=m)
    view, view_sc = wq[:, lo:], sc[lo:]
    assert view.stride() == (width, 1)
    x = torch.randn(m, k, generator=torch.Generator().manual_seed(m)) \
        .to(cuda, torch.bfloat16)
    reset_launch_counts()
    got = tmm.dequant_matmul(x, view, view_sc, rows=k, bits=bits)
    copy = tmm.dequant_matmul(x, view.contiguous(), view_sc.contiguous(),
                              rows=k, bits=bits)
    torch.cuda.synchronize()
    assert LAUNCHES[f"int{bits}_matmul"] == 2
    assert torch.equal(got, copy)
    want = tmm.dequant_matmul_reference(x, view, view_sc, k, bits)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= MATMUL_TOL[torch.bfloat16] * max(
        1.0, want.float().abs().max().item()), err


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("m", [8, 128])
@pytest.mark.parametrize("shape", [(4096, 4096), (11008, 4096)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_dequant_matmul_two_calls_bitwise_equal(cuda, shape, m, bits):
    """The split-K partials are summed in a fixed order (no atomics): two
    calls give the same bits."""
    from paddle_tpu_torch.kernels import int8_matmul as tmm
    k, n = shape
    wq, sc = _quantized(k, n, bits, cuda, seed=k + m)
    x = torch.randn(m, k, generator=torch.Generator().manual_seed(m)) \
        .to(cuda, torch.bfloat16)
    first = tmm.dequant_matmul(x, wq, sc, rows=k, bits=bits)
    second = tmm.dequant_matmul(x, wq, sc, rows=k, bits=bits)
    torch.cuda.synchronize()
    assert tmm.kernel_splits(bits, m, n, k) > 1
    assert torch.equal(first, second)


def _int8_pools(args, seed=0):
    """The fp pools of ``_inputs`` quantized per (kv head, page), as the
    engine's append leaves them: int8 pages and f32 scales."""
    q, k, v = args[:3]
    out = []
    for pool in (k, v):
        s = pool.float().abs().amax(dim=(2, 3)).clamp_min(1e-8) / 127.0
        out.append(torch.round(pool.float() / s[:, :, None, None])
                   .clamp(-127, 127).to(torch.int8))
        out.append(s.contiguous())
    kq, ks, vq, vs = out
    return [q, kq, vq] + list(args[3:]), ks, vs


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("heads", sorted(HEADS))
@pytest.mark.parametrize("case", sorted(CASES))
def test_ragged_int8_kernel_matches_plain_version(cuda, case, heads, dtype):
    hq, hkv, d = HEADS[heads]
    args, ks, vs = _int8_pools(_inputs(CASES[case], cuda, dtype, hq=hq,
                                       hkv=hkv, d=d))
    reset_launch_counts()
    got = tpa.ragged_paged_attention(*args, q_block=8, k_scales=ks,
                                     v_scales=vs)
    torch.cuda.synchronize()
    assert LAUNCHES["ragged_paged_attention_int8"] == 1
    assert LAUNCHES["ragged_paged_attention"] == 0
    assert LAUNCHES["ragged_paged_attention_merge"] == _merges(args, hkv)
    want = tpa.ragged_paged_attention_reference(*args, k_scales=ks,
                                                v_scales=vs)
    assert got.dtype == dtype and got.shape == want.shape
    assert torch.isfinite(got.float()).all()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= ATOL[dtype], err


@pytest.mark.cuda
def test_ragged_int8_kernel_rejects_what_it_does_not_take(cuda):
    args, ks, vs = _int8_pools(_inputs(CASES["decode"], cuda,
                                       torch.float32, hq=4, hkv=2, d=24))
    reset_launch_counts()
    with pytest.raises(ValueError, match="multiple of 16"):
        tpa.ragged_paged_attention(*args, q_block=8, k_scales=ks,
                                   v_scales=vs)
    args, ks, vs = _int8_pools(_inputs(CASES["decode"], cuda,
                                       torch.float32, hq=4, hkv=2, d=32))
    with pytest.raises(TypeError, match="k_scales"):
        tpa.ragged_paged_attention(*args, q_block=8, k_scales=ks.double(),
                                   v_scales=vs)
    with pytest.raises(TypeError, match="int8"):
        fp = _inputs(CASES["decode"], cuda, torch.float32, hq=4, hkv=2, d=32)
        tpa.ragged_paged_attention(*fp, q_block=8, k_scales=ks, v_scales=vs)
    assert LAUNCHES["ragged_paged_attention_int8"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("knobs", [
    dict(quantized_mode="weight_only_int8", kv_cache_dtype="int8"),
    dict(quantized_mode="weight_only_int4", kv_cache_dtype="int8"),
    dict(quantized_mode="weight_only_int8")], ids=["w8_kv8", "w4_kv8", "w8"])
def test_low_bit_engine_on_the_card_matches_the_cpu(cuda, knobs):
    """Greedy tokens of a small f32 Llama with quantized projections (and
    an int8 pool): the card (every projection through the dequant-matmul
    kernel, every attention through the int8 ragged kernel) equals the
    CPU (the plain versions)."""
    cfg = pt.llama_tiny_config(num_hidden_layers=2, num_key_value_heads=2)
    model = pt.LlamaForCausalLM(cfg, device="cpu",
                                generator=torch.Generator().manual_seed(0))
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size, (n,)).tolist()
               for n in (3, 17, 40, 9)]
    tokens = {}
    bits = 8 if knobs["quantized_mode"].endswith("int8") else 4
    attn = "ragged_paged_attention_int8" if "kv_cache_dtype" in knobs \
        else "ragged_paged_attention"
    for dev in ("cpu", "cuda"):
        eng = pt.LLMEngine(model, max_len=96, page_size=16, max_num_seqs=4,
                           chunk_size=16, device=dev, **knobs)
        rids = [eng.add_request(p, max_new_tokens=6) for p in prompts]
        reset_launch_counts()
        outs = eng.run(max_steps=200)
        steps = eng.metrics_snapshot()["decode_steps"]
        on_card = dev == "cuda"
        layers = cfg.num_hidden_layers
        assert LAUNCHES[attn] == (layers * steps if on_card else 0)
        assert LAUNCHES["ragged_paged_attention_merge"] == \
            LAUNCHES[attn] * _engine_merges(eng, cfg)
        assert LAUNCHES[f"int{bits}_matmul"] == \
            (7 * layers * steps if on_card else 0)
        assert eng.pool.check_invariants()
        tokens[dev] = [outs[r].token_ids for r in rids]
    assert tokens["cuda"] == tokens["cpu"]


# ---------------------------------------------------------------------------
# training kernels: flash attention (forward, dq, dk/dv) and fused AdamW
# ---------------------------------------------------------------------------

#: (b, hq, hkv, sq, sk, d); tails that are not a multiple of the 64-row
#: tiles, sq < sk and sq > sk; llama_1b's GQA 8:1 grouping; one query
#: and one key; an sq that is not a multiple of the mma fragment's 16 rows
FLASH_CASES = {
    "mha_d64": (2, 4, 4, 256, 256, 64),
    "gqa8_2_d128_tail": (1, 8, 2, 192, 320, 128),
    "gqa4_2_sq_gt_sk": (1, 4, 2, 320, 192, 128),
    "gqa4_1_ragged": (2, 4, 1, 100, 77, 64),
    "gqa8_1_d64": (1, 32, 4, 512, 512, 64),
    "one_row": (1, 2, 1, 1, 1, 64),
    "sq23_d128": (2, 4, 2, 23, 90, 128),
}

#: flash kernels vs plain version, max |diff| over max(1, max |plain|):
#: f32 sums in another order; bf16 outputs round to 8 bits
FLASH_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _flash_inputs(case, dev, dtype, seed=0):
    b, hq, hkv, sq, sk, d = FLASH_CASES[case]
    g = torch.Generator().manual_seed(seed)
    shapes = ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d),
              (b, hq, sq, d))
    return [torch.randn(*s, generator=g).to(dev, dtype) for s in shapes]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_kernels_match_plain_version(cuda, case, causal, dtype):
    from paddle_tpu_torch.kernels import flash_attention as tfa
    q, k, v, do = _flash_inputs(case, cuda, dtype)
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    reset_launch_counts()
    out, lse = tfa.flash_attention_with_lse(q, k, v, causal=causal)
    grads = torch.autograd.grad(out, (q, k, v), do)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention_fwd"] == 1
    assert LAUNCHES["flash_attention_bwd_dq"] == 1
    assert LAUNCHES["flash_attention_bwd_dkv"] == 1
    # bf16 GQA: per-query-head f32 partials, summed by a second launch
    grouped = dtype == torch.bfloat16 and q.shape[1] != k.shape[1]
    assert LAUNCHES["flash_attention_bwd_dkv_sum"] == int(grouped)
    want, want_lse = tfa.flash_attention_reference(q, k, v, causal)
    want_grads = torch.autograd.grad(want, (q, k, v), do)
    live = want_lse > -1e29
    assert torch.equal(live, lse > -1e29)
    assert (lse - want_lse)[live].abs().max().item() <= 1e-4
    for name, got, ref in zip(("out", "dq", "dk", "dv"), (out, *grads),
                              (want, *want_grads)):
        assert got.dtype == dtype and got.shape == ref.shape, name
        assert torch.isfinite(got.float()).all(), name
        err = (got.float() - ref.float()).abs().max().item()
        assert err <= FLASH_TOL[dtype] * max(1.0, ref.float().abs().max()
                                             .item()), (name, err)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_backward_is_bitwise_repeatable(cuda, dtype):
    """Two backward launches on the same inputs give the same bits for
    dq, dk and dv: no atomics; the GQA group sum runs in a fixed order."""
    from paddle_tpu_torch.kernels import flash_attention as tfa
    q, k, v, do = _flash_inputs("gqa8_1_d64", cuda, dtype, seed=4)
    out, lse = tfa.flash_attention_fwd(q, k, v, True, 0.125)
    first = tfa.flash_attention_bwd(q, k, v, out, lse, do, True, 0.125)
    second = tfa.flash_attention_bwd(q, k, v, out, lse, do, True, 0.125)
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(a, b), name


@pytest.mark.cuda
def test_flash_dkv_group_sum_matches_plain_version_bitwise(cuda):
    from paddle_tpu_torch.kernels import flash_attention as tfa
    g = torch.Generator().manual_seed(5)
    part = torch.randn(2, 2, 8, 70, 64, generator=g).to(cuda)
    k, v = (torch.zeros(2, 70, 2, 64, device=cuda, dtype=torch.bfloat16)
            .transpose(1, 2) for _ in range(2))
    reset_launch_counts()
    dk, dv = tfa.flash_attention_bwd_dkv_sum(part, k, v)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention_bwd_dkv_sum"] == 1
    assert dk.stride() == k.stride()
    want = tfa.flash_attention_bwd_dkv_sum_reference(part, k, v)
    assert torch.equal(dk, want[0]) and torch.equal(dv, want[1])


@pytest.mark.cuda
def test_flash_bf16_rejects_unaligned_seq_stride(cuda):
    """The bf16 kernels copy rows in 16-byte chunks: a seq stride of 68
    elements (136 bytes) raises, with no copy and no other path."""
    from paddle_tpu_torch.kernels import flash_attention as tfa
    buf = torch.zeros(1, 2, 16, 68, device=cuda, dtype=torch.bfloat16)
    q = buf[..., :64]
    k, v = (torch.zeros(1, 2, 16, 64, device=cuda, dtype=torch.bfloat16)
            for _ in range(2))
    reset_launch_counts()
    with pytest.raises(ValueError, match="16 bytes"):
        tfa.flash_attention_fwd(q, k, v, True, 0.125)
    with pytest.raises(ValueError, match="16 bytes"):
        tfa.flash_attention_fwd(k, q, v, True, 0.125)
    assert LAUNCHES["flash_attention_fwd"] == 0


@pytest.mark.cuda
def test_flash_kernels_read_paddle_layout_through_strides(cuda):
    """``[b, s, h, d]`` buffers as ``transpose(1, 2)`` views: no copies,
    outputs and gradients in the same layout."""
    from paddle_tpu_torch.nn import functional as TF
    g = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(2, 130, h, 64, generator=g).to(cuda)
               .requires_grad_() for h in (4, 2, 2))
    out = TF.scaled_dot_product_attention(q, k, v, is_causal=True)
    assert out.is_contiguous() and out.shape == (2, 130, 4, 64)
    dq, dk, dv = torch.autograd.grad(out.sum(), (q, k, v))
    assert dq.is_contiguous() and dk.is_contiguous()
    ref = TF.scaled_dot_product_attention(
        *(x.detach().cpu().requires_grad_() for x in (q, k, v)),
        is_causal=True)
    assert (out.cpu() - ref).abs().max().item() <= 1e-4


@pytest.mark.cuda
def test_flash_wrapper_rejects_what_it_does_not_take(cuda):
    from paddle_tpu_torch.kernels import flash_attention as tfa
    q, k, v, _ = _flash_inputs("mha_d64", cuda, torch.float16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tfa.flash_attention_fwd(q, k, v, True, 0.125)
    q, k, v = (torch.zeros(1, 2, 16, 32, device=cuda) for _ in range(3))
    with pytest.raises(ValueError, match="head_dim"):
        tfa.flash_attention_fwd(q, k, v, True, 0.125)
    wide = torch.zeros(1, 2, 16, 128, device=cuda)
    with pytest.raises(ValueError, match="contiguous head"):
        tfa.flash_attention_fwd(wide[..., ::2], wide[..., ::2],
                                wide[..., ::2], True, 0.125)
    q, k, v, _ = _flash_inputs("mha_d64", cuda, torch.float32)
    with pytest.raises(TypeError, match="needs"):
        tfa.flash_attention_fwd(q, k.cpu(), v, True, 0.125)
    with pytest.raises(ValueError, match="cuda tensors"):
        tfa.flash_attention_fwd(q.cpu(), k.cpu(), v.cpu(), True, 0.125)


@pytest.mark.cuda
@pytest.mark.parametrize("t", [1, 7])
@pytest.mark.parametrize("wd,decoupled", [(0.0, True), (0.01, True),
                                          (0.01, False)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_fused_adamw_kernel_matches_plain_version(cuda, dtype, wd, decoupled,
                                                  t):
    """Bitwise: the kernel rounds every operation on its own, in the plain
    version's order, with the same f32 constants."""
    from paddle_tpu_torch.kernels import fused_adamw as tfw
    n = 1_000_003
    g = torch.Generator().manual_seed(2)
    p = torch.randn(n, generator=g).to(cuda, dtype)
    gr = (torch.randn(n, generator=g) * 1e-2).to(cuda, dtype)
    m = (torch.randn(n, generator=g) * 1e-3).to(cuda)
    v = (torch.rand(n, generator=g) * 1e-5).to(cuda)
    sc = torch.tensor(tfw.adamw_scalars(1e-3, t, 0.9, 0.999), device=cuda)
    kw = dict(beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=wd,
              decoupled=decoupled)
    got = [x.clone() for x in (p, m, v)]
    reset_launch_counts()
    tfw.fused_adamw(got[0], gr, got[1], got[2], sc, **kw)
    torch.cuda.synchronize()
    assert LAUNCHES["fused_adamw"] == 1
    want = [x.clone() for x in (p, m, v)]
    tfw.fused_adamw_reference(want[0], gr, want[1], want[2], sc, **kw)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_fused_adamw_wrapper_rejects_what_it_does_not_take(cuda):
    from paddle_tpu_torch.kernels import fused_adamw as tfw
    p = torch.zeros(10, device=cuda)
    sc = torch.zeros(3, device=cuda)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tfw.fused_adamw(p.half(), p.half(), p, p.clone(), sc)
    with pytest.raises(ValueError, match="scalars"):
        tfw.fused_adamw(p, p.clone(), p.clone(), p.clone(), sc.cpu())
    with pytest.raises(ValueError, match="contiguous"):
        big = torch.zeros(20, device=cuda)
        tfw.fused_adamw(big[::2], p.clone(), p.clone(), p.clone(), sc)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_fused_adamw_masked_spans_match_plain_version(cuda, dtype):
    """A span table (some parameters absent) on an odd-length bucket:
    bitwise the plain masked version, and the absent elements (values
    and moments) byte-identical before and after; one launch."""
    from paddle_tpu_torch.kernels import fused_adamw as tfw
    n = 100_003
    g = torch.Generator().manual_seed(4)
    p = torch.randn(n, generator=g).to(cuda, dtype)
    gr = (torch.randn(n, generator=g) * 1e-2).to(cuda, dtype)
    m = (torch.randn(n, generator=g) * 1e-3).to(cuda)
    v = (torch.rand(n, generator=g) * 1e-5).to(cuda)
    spans = [(0, 5), (8, 4093), (8200, 1), (16384, 50000), (99992, 11)]
    table = tfw.span_table(spans, dtype, cuda)
    sc = torch.tensor(tfw.adamw_scalars(1e-3, 3, 0.9, 0.999), device=cuda)
    kw = dict(beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=0.01,
              decoupled=True, spans=table)
    got = [x.clone() for x in (p, m, v)]
    reset_launch_counts()
    tfw.fused_adamw(got[0], gr, got[1], got[2], sc, **kw)
    torch.cuda.synchronize()
    assert LAUNCHES["fused_adamw"] == 1
    want = [x.clone() for x in (p, m, v)]
    tfw.fused_adamw_reference(want[0], gr, want[1], want[2], sc, **kw)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    mask = torch.zeros(n, dtype=torch.bool, device=cuda)
    for a, ln in spans:
        mask[a:a + ln] = True
    for a, b in zip(got, (p, m, v)):
        assert torch.equal(a[~mask], b[~mask])
        assert not torch.equal(a[mask], b[mask])


class _Branches(torch.nn.Module):
    """Three linear maps; ``c`` takes part only when asked."""

    def __init__(self):
        super().__init__()
        g = torch.Generator().manual_seed(5)
        self.a, self.b, self.c = (torch.nn.Linear(16, 16) for _ in range(3))
        with torch.no_grad():
            for prm in self.parameters():
                prm.copy_(torch.randn(prm.shape, generator=g) * 0.2)

    def forward(self, x, use_c):
        y = self.b(torch.tanh(self.a(x)))
        return (self.c(y) if use_c else y).square().mean()


def _masked_train(dev):
    model = _Branches().to(dev)
    opt = pt.AdamW(learning_rate=1e-2, parameters=model.parameters())
    x = torch.from_numpy(np.random.RandomState(1).randn(8, 16)
                         .astype(np.float32)).to(dev)
    model.b.weight.requires_grad_(False)         # frozen after the build
    step = pt.TrainStep(model, lambda x, use_c: model(x, use_c), opt)
    held = {}
    for i in range(3):
        use_c = i != 1                            # c: no gradient at step 1
        if i == 1:
            held = {k: q.detach().clone() for k, q in
                    model.named_parameters() if k.startswith(("b.w", "c."))}
        step(x, use_c)
        if i == 1:
            for k, q in model.named_parameters():
                if k in held:
                    assert torch.equal(q.detach(), held[k]), k
    return {k: q.detach().cpu() for k, q in model.named_parameters()}


@pytest.mark.cuda
def test_train_step_masks_absent_parameters_on_the_card(cuda):
    """A frozen weight and a layer that sits out one step keep their
    values on that step on both devices (bitwise), and 3 steps on the
    card match the CPU (f32 sums in another order: 1e-5)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    reset_launch_counts()
    on_card = _masked_train(cuda)
    assert LAUNCHES["fused_adamw"] == 3
    on_cpu = _masked_train("cpu")
    assert torch.equal(on_card["b.weight"], on_cpu["b.weight"])
    for k in on_card:
        np.testing.assert_allclose(on_card[k].numpy(), on_cpu[k].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


def _tiny_train(dev, steps=3, amp=False, remat=False, accumulate_steps=1):
    cfg = pt.llama_tiny_config(num_hidden_layers=2, num_key_value_heads=2,
                               hidden_size=128, num_attention_heads=2,
                               loss_chunk_size=48, remat=remat)
    model = pt.LlamaForCausalLM(cfg, device="cpu",
                                generator=torch.Generator().manual_seed(0))
    model.to(dev)
    opt = pt.AdamW(learning_rate=1e-3, parameters=model.parameters())

    def loss_fn(ids):
        with pt.auto_cast(enable=amp, level="O1"):
            return model(ids, labels=ids)[1]

    step = pt.TrainStep(model, loss_fn, opt,
                        accumulate_steps=accumulate_steps)
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (2, 64))).to(dev)
    return [step(ids).item() for _ in range(steps)], cfg


@pytest.mark.cuda
def test_train_step_on_the_card_matches_the_cpu(cuda):
    """3 AdamW steps of a tiny f32 Llama: the losses on the card (flash
    and AdamW kernels) match the CPU (plain versions) to 1e-4 relative:
    f32 sums in another order, and AdamW may step entries whose
    gradient is within rounding of zero the other way (by lr each)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    reset_launch_counts()
    on_card, cfg = _tiny_train(cuda)
    assert LAUNCHES["flash_attention_fwd"] == 3 * cfg.num_hidden_layers
    assert LAUNCHES["flash_attention_bwd_dkv"] == 3 * cfg.num_hidden_layers
    assert LAUNCHES["rms_norm_fwd"] == LAUNCHES["rms_norm_bwd"] == \
        3 * (2 * cfg.num_hidden_layers + 1)
    assert LAUNCHES["fused_adamw"] == 3
    on_cpu, _ = _tiny_train("cpu")
    np.testing.assert_allclose(on_card, on_cpu, rtol=1e-4)
    assert on_card[-1] < on_card[0]


@pytest.mark.cuda
def test_train_step_on_the_card_never_reaches_a_plain_version(cuda,
                                                              monkeypatch):
    from paddle_tpu_torch.kernels import fused_adamw as tfw
    from paddle_tpu_torch.kernels import flash_attention as tfa
    from paddle_tpu_torch.kernels import rms_norm as trn

    def refuse(*a, **k):
        raise AssertionError("a CUDA tensor reached a plain version")

    monkeypatch.setattr(tfa, "flash_attention_reference", refuse)
    monkeypatch.setattr(tfw, "fused_adamw_reference", refuse)
    monkeypatch.setattr(trn, "rms_norm_fwd_reference", refuse)
    monkeypatch.setattr(trn, "rms_norm_bwd_reference", refuse)
    reset_launch_counts()
    losses, cfg = _tiny_train(cuda, steps=2, amp=True)
    assert all(np.isfinite(losses))
    assert LAUNCHES["flash_attention_bwd_dq"] == 2 * cfg.num_hidden_layers
    assert LAUNCHES["fused_adamw"] == 2


# ---------------------------------------------------------------------------
# burst decode: the decode megakernel (layer and model scope)
# ---------------------------------------------------------------------------

#: megakernel vs plain version, max |diff| over max(1, max |plain|): f32
#: sums in another order; bf16 values may round one ulp apart where a sum
#: lands near a rounding boundary, and that ulp travels through the layer
MEGA_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}

#: (H, Hkv, dh): GQA 4/1, MHA with a narrow head, a 7B head
MEGA_HEADS = [(8, 2, 64), (4, 4, 32), (4, 4, 128)]

#: kv lengths of the rows past the fixture's first 5 (up to 13 rows: two
#: row groups of the kernel's mma, the second ragged)
MEGA_MORE_KV = [7, 64, 65, 2, 40, 16, 80, 3]


def _mega_fixture(dev, dtype, heads, *, quant_w=False, quant_kv=False,
                  layers=1, R=5, D=256, F=384, P=48, ps=16, seed=0):
    """Random layer(s), hidden states and pools; kv lengths 1-90 over
    random pages (pages past a row's length point at the null page)."""
    from paddle_tpu_torch.quantization.low_bit import quantize_weight
    H, Hkv, dh = heads
    g = torch.Generator().manual_seed(seed)

    def rnd(*s, scale=0.3):
        return torch.randn(*s, generator=g) * scale

    lyrs = []
    for _ in range(layers):
        lyr = {"ln1": rnd(D) + 1.0, "ln2": rnd(D) + 1.0,
               "q": rnd(D, H * dh, scale=0.05),
               "k": rnd(D, Hkv * dh, scale=0.05),
               "v": rnd(D, Hkv * dh, scale=0.05),
               "o": rnd(H * dh, D, scale=0.05), "gate": rnd(D, F, scale=0.05),
               "up": rnd(D, F, scale=0.05), "down": rnd(F, D, scale=0.05)}
        lyr = {k: (quantize_weight(v, "weight_only_int8")
                   if quant_w and k not in ("ln1", "ln2") else v)
               for k, v in lyr.items()}
        for k, v in lyr.items():
            if isinstance(v, torch.Tensor):
                lyr[k] = v.to(dev, dtype)
            else:
                v.qdata, v.scale = v.qdata.to(dev), v.scale.to(dev)
        lyrs.append(lyr)
    kv_lens = torch.tensor(([5, 1, 17, 33, 90] + MEGA_MORE_KV)[:R],
                           dtype=torch.int32)
    pps = 6
    P = max(P, R * pps + 1)
    perm = torch.randperm(P - 1, generator=g) + 1
    tbl = torch.zeros((R, pps), dtype=torch.int32)
    for r, n in enumerate(kv_lens.tolist()):
        need = -(-n // ps)
        tbl[r, :need] = perm[r * pps:r * pps + need]
    pools = []
    for _ in range(layers):
        kp, vp = rnd(Hkv, P, ps, dh), rnd(Hkv, P, ps, dh)
        if quant_kv:
            ks = kp.abs().amax(dim=(2, 3)) / 127.0
            vs = vp.abs().amax(dim=(2, 3)) / 127.0
            kp = torch.round(kp / ks[:, :, None, None]).to(torch.int8)
            vp = torch.round(vp / vs[:, :, None, None]).to(torch.int8)
            ks[:, 0] = vs[:, 0] = 0.0
            kp[:, 0] = vp[:, 0] = 0
            pools.append((kp.to(dev), vp.to(dev), ks.to(dev), vs.to(dev)))
        else:
            pools.append((kp.to(dev, dtype), vp.to(dev, dtype), None, None))
    h = rnd(R, D, scale=1.0).to(dev, dtype)
    return lyrs, h, pools, tbl.to(dev), kv_lens.to(dev), \
        dict(eps=1e-6, theta=10000.0, num_heads=H)


def _close(got, want, dtype):
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    err = (got - want).abs().max().item()
    assert err <= MEGA_TOL[dtype] * max(1.0, want.abs().max().item()), err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("heads", MEGA_HEADS,
                         ids=lambda h: f"h{h[0]}_kv{h[1]}_d{h[2]}")
@pytest.mark.parametrize("contract", ["fp_self_kv", "fp_pages", "int8_w",
                                      "int8_kv", "int8_w_int8_kv"])
def test_decode_megakernel_matches_plain_version(cuda, contract, heads,
                                                 dtype):
    from paddle_tpu_torch.kernels import decode_megakernel as dmk
    quant_w = contract.startswith("int8_w")
    quant_kv = contract.endswith("int8_kv")
    self_kv = contract in ("fp_self_kv", "int8_w")
    lyrs, h, pools, tbl, kv_lens, kw = _mega_fixture(
        cuda, dtype, heads, quant_w=quant_w, quant_kv=quant_kv)
    kp, vp, ks, vs = pools[0]
    reset_launch_counts()
    got = dmk.fused_decode_layer(lyrs[0], h, kp, vp, tbl, kv_lens,
                                 self_kv=self_kv, k_scales=ks, v_scales=vs,
                                 **kw)
    torch.cuda.synchronize()
    assert LAUNCHES["decode_megakernel"] == 1
    want = dmk._reference_layer(lyrs[0], h, kp, vp, tbl, kv_lens,
                                self_kv=self_kv, k_scales=ks, v_scales=vs,
                                **kw)
    assert got[0].dtype == dtype and got[0].shape == h.shape
    assert (got[1] is None) == (want[1] is None) == (not self_kv)
    for a, b in zip(got, want):
        if a is not None:
            _close(a, b, dtype)


def _append_case(cuda, pool, dtype, quant_w, L):
    """``fused_decode_model`` over L layers in one launch (L = 1: the
    layer-scope launch of a burst), with a dead row, against
    ``_plain_model`` on the same pools: the hidden state, the K/V each
    layer appended, and the pools. An int8 pool is held to the plain
    append of the kernel's own K/V (pages within 1, scales 1e-6
    relative); the null page is the plain version's dead-row target."""
    from paddle_tpu_torch.kernels import decode_megakernel as dmk
    from paddle_tpu_torch.serving.engine import _quantized_append
    quant = pool == "int8"
    lyrs, h, pools, tbl, kv_lens, kw = _mega_fixture(
        cuda, dtype, (8, 2, 64), quant_w=quant_w, quant_kv=quant, layers=L)
    R, Hkv, ps, dh = h.shape[0], 2, 16, 64
    pos = kv_lens - 1
    page = tbl[torch.arange(R, device=cuda), (pos // ps).long()].clone()
    page[2] = 0                                       # a dead row
    append_at = (page, (pos % ps).to(torch.int32))
    before = [[x.clone() if x is not None else None for x in p]
              for p in pools]
    got_pools = [[x.clone() if x is not None else None for x in p]
                 for p in pools]
    args = dict(self_kv=not quant, append_at=append_at, **kw)
    if quant:
        args.update(k_scales=[p[2] for p in got_pools],
                    v_scales=[p[3] for p in got_pools])
    rec = torch.zeros((L, 2, R, Hkv, dh), device=cuda)
    reset_launch_counts()
    got = dmk.fused_decode_model(lyrs, h, [p[0] for p in got_pools],
                                 [p[1] for p in got_pools], tbl, kv_lens,
                                 appended=rec, **args)
    torch.cuda.synchronize()
    assert LAUNCHES["decode_megakernel"] == 1
    want_pools = [[x.clone() if x is not None else None for x in p]
                  for p in pools]
    want_rec = torch.zeros_like(rec)
    if quant:
        args.update(k_scales=[p[2] for p in want_pools],
                    v_scales=[p[3] for p in want_pools])
    want = dmk._plain_model(
        lyrs, h, [p[0] for p in want_pools], [p[1] for p in want_pools],
        args.get("k_scales"), args.get("v_scales"), tbl, kv_lens,
        kw["eps"], kw["theta"], kw["num_heads"], not quant, None, None,
        append_at, want_rec)
    _close(got[0], want, dtype)
    live = page != 0
    _close(rec[:, :, live], want_rec[:, :, live], dtype)
    for li in range(L):
        if not quant:
            for gp, wp in zip(got_pools[li][:2], want_pools[li][:2]):
                _close(gp[:, 1:], wp[:, 1:], dtype)
            continue
        # the plain append fed the kernel's own K/V
        kp, vp, ks, vs = before[li]
        for j, (P, S) in enumerate(((kp, ks), (vp, vs))):
            tok = rec[li, j].to(dtype).transpose(0, 1)
            _quantized_append(P, S, tok, page, append_at[1], ps, live)
            gp, gs = got_pools[li][j], got_pools[li][2 + j]
            assert (gp[:, 1:].int() - P[:, 1:].int()).abs().max() <= 1
            np.testing.assert_allclose(gs[:, 1:].cpu().numpy(),
                                       S[:, 1:].cpu().numpy(), rtol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("pool", ["fp", "int8"])
def test_decode_megakernel_model_scope_matches_plain_version(cuda, pool,
                                                             dtype):
    """Three layers in one launch (fp weights), with a dead row."""
    _append_case(cuda, pool, dtype, False, 3)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("pool", ["fp", "int8"])
def test_decode_megakernel_model_scope_int8_weights_match_plain_version(
        cuda, pool, dtype):
    """The int8-weight contracts at model scope (int8_w, int8_w_int8_kv):
    three layers in one launch, with a dead row."""
    _append_case(cuda, pool, dtype, True, 3)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("quant_w", [False, True], ids=["fp_w", "int8_w"])
@pytest.mark.parametrize("pool", ["fp", "int8"])
def test_decode_megakernel_layer_scope_append_matches_plain_version(
        cuda, pool, quant_w, dtype):
    """A layer-scope burst launch (one layer, ``append_at``: the pool
    write in the kernel) against the plain version on the same pools."""
    _append_case(cuda, pool, dtype, quant_w, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("R", [8, 13])
@pytest.mark.parametrize("contract", ["fp_self_kv", "int8_w_int8_kv"])
def test_decode_megakernel_row_groups_match_plain_version(cuda, contract, R,
                                                          dtype):
    """8 rows (one row group of the mma's N) and 13 (two, the second
    ragged): every group on the same staged weight tile."""
    from paddle_tpu_torch.kernels import decode_megakernel as dmk
    quant = contract == "int8_w_int8_kv"
    lyrs, h, pools, tbl, kv_lens, kw = _mega_fixture(
        cuda, dtype, (8, 2, 64), quant_w=quant, quant_kv=quant, R=R)
    kp, vp, ks, vs = pools[0]
    got = dmk.fused_decode_layer(lyrs[0], h, kp, vp, tbl, kv_lens,
                                 self_kv=not quant, k_scales=ks, v_scales=vs,
                                 **kw)
    want = dmk._reference_layer(lyrs[0], h, kp, vp, tbl, kv_lens,
                                self_kv=not quant, k_scales=ks, v_scales=vs,
                                **kw)
    for a, b in zip(got, want):
        if a is not None:
            _close(a, b, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("quant_w", [False, True], ids=["fp_w", "int8_w"])
def test_decode_megakernel_ragged_tile_widths_match_plain_version(
        cuda, quant_w, dtype):
    """Widths that are no multiple of the 64-column tile or of the k tile
    (hidden 272, intermediate 400): the tensor copies fill the edge boxes
    with zeros."""
    from paddle_tpu_torch.kernels import decode_megakernel as dmk
    lyrs, h, pools, tbl, kv_lens, kw = _mega_fixture(
        cuda, dtype, (4, 4, 32), quant_w=quant_w, D=272, F=400)
    kp, vp, _, _ = pools[0]
    got = dmk.fused_decode_layer(lyrs[0], h, kp, vp, tbl, kv_lens, **kw)
    want = dmk._reference_layer(lyrs[0], h, kp, vp, tbl, kv_lens,
                                self_kv=True, k_scales=None, v_scales=None,
                                **kw)
    for a, b in zip(got, want):
        _close(a, b, dtype)


@pytest.mark.cuda
def test_decode_megakernel_rejects_what_it_does_not_take(cuda):
    from paddle_tpu_torch.kernels import decode_megakernel as dmk
    from paddle_tpu_torch.quantization.low_bit import quantize_weight
    lyrs, h, pools, tbl, kv_lens, kw = _mega_fixture(cuda, torch.float32,
                                                     (4, 4, 32))
    kp, vp, _, _ = pools[0]
    reset_launch_counts()
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        dmk.fused_decode_layer(lyrs[0], h.half(), kp, vp, tbl, kv_lens, **kw)
    with pytest.raises(TypeError, match="block_tables"):
        dmk.fused_decode_layer(lyrs[0], h, kp, vp, tbl.long(), kv_lens, **kw)
    with pytest.raises(TypeError, match="k_pages"):
        dmk.fused_decode_layer(lyrs[0], h, kp.to(torch.bfloat16), vp, tbl,
                               kv_lens, **kw)
    int4 = dict(lyrs[0])
    w4 = quantize_weight(lyrs[0]["q"].cpu(), "weight_only_int4")
    w4.qdata, w4.scale = w4.qdata.to(cuda), w4.scale.to(cuda)
    int4["q"] = w4
    with pytest.raises(NotImplementedError, match="int4"):
        dmk.fused_decode_layer(int4, h, kp, vp, tbl, kv_lens, **kw)
    with pytest.raises(ValueError, match="append_at"):
        dmk.fused_decode_model(lyrs, h, [kp], [vp], tbl, kv_lens,
                               append_fn=lambda *a: a[:2], **kw)
    assert LAUNCHES["decode_megakernel"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("scope", ["layer", "model"])
@pytest.mark.parametrize("knobs", [
    {}, dict(quantized_mode="weight_only_int8", kv_cache_dtype="int8")],
    ids=["fp", "w8_kv8"])
def test_burst_engine_on_the_card_matches_the_cpu(cuda, knobs, scope):
    """Greedy tokens of a small f32 Llama served in bursts of 4: the card
    (every decode layer through the megakernel) equals the CPU (the plain
    body); the megakernel runs once per layer and iteration at layer
    scope, once per iteration at model scope."""
    cfg = pt.llama_tiny_config(num_hidden_layers=2, num_key_value_heads=2)
    model = pt.LlamaForCausalLM(cfg, device="cpu",
                                generator=torch.Generator().manual_seed(0))
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size, (n,)).tolist()
               for n in (3, 17, 40, 9)]
    tokens = {}
    for dev in ("cpu", "cuda"):
        eng = pt.LLMEngine(model, max_len=96, page_size=16, max_num_seqs=4,
                           chunk_size=16, device=dev, burst_tokens=4,
                           megakernel_scope=scope, **knobs)
        iters = []
        orig = eng.scheduler.prepare_burst

        def prepare_burst(n, _orig=orig):
            plan = _orig(n)
            if plan is not None:
                iters.append(plan.burst_len)
            return plan

        eng.scheduler.prepare_burst = prepare_burst
        rids = [eng.add_request(p, max_new_tokens=9) for p in prompts]
        reset_launch_counts()
        outs = eng.run(max_steps=200)
        per = cfg.num_hidden_layers if scope == "layer" else 1
        assert iters and LAUNCHES["decode_megakernel"] == \
            (per * sum(iters) if dev == "cuda" else 0)
        snap = eng.metrics_snapshot()
        assert snap["burst_launches"] == len(iters)
        assert snap["megakernel_mode"] == ("cuda" if dev == "cuda"
                                           else "plain")
        assert eng.pool.check_invariants()
        tokens[dev] = [outs[r].token_ids for r in rids]
    assert tokens["cuda"] == tokens["cpu"]


# ---------------------------------------------------------------------------
# fused ragged prefill: the prefill megakernel (one launch per layer)
# ---------------------------------------------------------------------------

#: (q_len, kv_len) per row of a ragged step: a first chunk, a decode row, a
#: continuation chunk, a decode row at position 0, a pad row
PREFILL_ROWS = [(16, 16), (1, 37), (13, 70), (1, 1), (0, 0)]

#: (H, Hkv, dh): GQA 4/1, MHA with a narrow head, a 7B head, GQA 8/1
#: (64 query rows per q block and kv head: 8 query groups)
PREFILL_HEADS = [(8, 2, 64), (4, 4, 32), (4, 4, 128), (8, 1, 64)]


def _prefill_step(dev, rows, *, P, pps, ps=16, qb=8, seed=0):
    """The step's metadata, packed as the engine packs it (rows at q_block
    multiples, pad rows last at q_start = T, one spare block of slot
    padding), positions and block tables on distinct random pages."""
    g = torch.Generator().manual_seed(seed)
    R = len(rows)
    T = sum(-(-ql // qb) * qb for ql, _ in rows) + qb
    q_starts = torch.full((R,), T, dtype=torch.int32)
    q_lens = torch.zeros(R, dtype=torch.int32)
    kv_lens = torch.zeros(R, dtype=torch.int32)
    tbl = torch.zeros((R, pps), dtype=torch.int32)
    positions = torch.zeros(T, dtype=torch.int32)
    free = (torch.randperm(P - 1, generator=g) + 1).tolist()
    cur = 0
    for r, (ql, kl) in enumerate(rows):
        if ql == 0:
            continue
        q_starts[r], q_lens[r], kv_lens[r] = cur, ql, kl
        tbl[r, :-(-kl // ps)] = torch.tensor(
            [free.pop() for _ in range(-(-kl // ps))], dtype=torch.int32)
        positions[cur:cur + ql] = torch.arange(kl - ql, kl)
        cur += -(-ql // qb) * qb
    return [x.to(dev) for x in (positions, tbl, q_starts, q_lens, kv_lens)]


def _prefill_fixture(dev, dtype, heads, *, quant_w=False, quant_kv=False,
                     layers=1, D=256, F=384, rows=PREFILL_ROWS, seed=0):
    """Fused layer(s), hidden states, pools and one ragged step; with an
    int8 pool, both sides' ``quant_append_fn`` (the engine's segmented
    append over the step's host plan)."""
    from paddle_tpu_torch.kernels import prefill_megakernel as pmk
    from paddle_tpu_torch.serving.engine import (_append_plan,
                                                 _chunk_append_fn)
    H, Hkv, dh = heads
    pages = [-(-kl // 16) for _, kl in rows]
    P, pps = max(48, sum(pages) + 1), max(6, max(pages))
    lyrs, _, pools, _, _, _ = _mega_fixture(
        dev, dtype, heads, quant_w=quant_w, quant_kv=quant_kv, layers=layers,
        D=D, F=F, P=P, seed=seed)
    fused = [pmk.fuse_layer_weights(lyr) for lyr in lyrs]
    positions, tbl, q_starts, q_lens, kv_lens = _prefill_step(
        dev, rows, P=P, pps=pps)
    T = positions.shape[0]
    pre = pmk.ragged_prologue(positions, tbl, q_starts, q_lens,
                              theta=10000.0, head_dim=dh, page_size=16,
                              max_pages=tbl.shape[1], q_block=8)
    g = torch.Generator().manual_seed(seed + 1)
    h = torch.randn(1, T, D, generator=g).to(dev, dtype)
    kw = dict(eps=1e-6, num_heads=H, q_block=8)
    if quant_kv:
        plan = [torch.from_numpy(a).to(dev) for a in _append_plan(
            *(x.cpu().numpy() for x in (tbl, q_starts, q_lens, kv_lens)),
            16, 64, T)]
        kw["quant_append_fn"] = _chunk_append_fn(
            (plan[0].long(), plan[1].long(), plan[2].bool()))
    return fused, h, pools, (tbl, pre, q_starts, q_lens, kv_lens), kw


def _clone_pools(pools):
    return [[x.clone() if x is not None else None for x in p] for p in pools]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("heads", PREFILL_HEADS,
                         ids=lambda h: f"h{h[0]}_kv{h[1]}_d{h[2]}")
@pytest.mark.parametrize("contract", ["fp", "int8_w", "int8_kv",
                                      "int8_w_int8_kv"])
def test_prefill_megakernel_matches_plain_version(cuda, contract, heads,
                                                  dtype):
    """One layer over the mixed step: h (every token: dead ones attend to
    nothing on both sides) and the pools after the step (the null page
    excluded: the plain version writes dead tokens there). An int8 pool
    is appended to outside the kernel on both sides: its pages and scales
    then differ only where the k/v projections round apart."""
    from paddle_tpu_torch.kernels import prefill_megakernel as pmk
    quant_w = contract.startswith("int8_w")
    quant_kv = contract.endswith("int8_kv")
    fused, h, pools, meta, kw = _prefill_fixture(
        cuda, dtype, heads, quant_w=quant_w, quant_kv=quant_kv)
    runs = []
    for side in ("kernel", "plain"):
        kp, vp, ks, vs = _clone_pools(pools)[0]
        reset_launch_counts()
        if side == "kernel":
            out = pmk.fused_prefill_layer(fused[0], h, kp, vp, *meta,
                                          k_scales=ks, v_scales=vs, **kw)
            torch.cuda.synchronize()
            assert LAUNCHES["prefill_megakernel"] == 1
            # int8 weights over an int8 pool: one k|v projection outside
            assert sum(LAUNCHES.values()) == 1 + (quant_w * quant_kv)
            assert LAUNCHES["int8_matmul"] == quant_w * quant_kv
        else:
            out = pmk._reference_prefill_layer(
                fused[0], h, kp, vp, *meta, num_kv_heads=heads[1],
                head_dim=heads[2], page_size=16, k_scales=ks, v_scales=vs,
                **kw)
            assert sum(LAUNCHES.values()) == 0
        runs.append(out)
    (got, *gp), (want, *wp) = runs
    assert got.dtype == dtype and got.shape == h.shape
    _close(got, want, dtype)
    if quant_kv:
        for a, b in zip(gp[:2], wp[:2]):
            assert (a[:, 1:].int() - b[:, 1:].int()).abs().max() <= 1
        for a, b in zip(gp[2:], wp[2:]):
            _close(a, b, dtype)
    else:
        for a, b in zip(gp[:2], wp[:2]):
            _close(a[:, 1:], b[:, 1:], dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("quant_w", [False, True], ids=["bf16", "int8_w"])
def test_prefill_megakernel_7b_layer_matches_plain_version(cuda, quant_w):
    """One full-width Llama-2-7B layer (D 4096, 32 heads of 128, F 11008)
    over a 128-token step: a 64-token chunk of a 600-token prompt, a
    continuation chunk, decode rows and a pad row."""
    from paddle_tpu_torch.kernels import prefill_megakernel as pmk
    rows = [(64, 600), (24, 300), (1, 49), (1, 632), (1, 1), (0, 0)]
    fused, h, pools, meta, kw = _prefill_fixture(
        cuda, torch.bfloat16, (32, 32, 128), quant_w=quant_w, D=4096,
        F=11008, rows=rows, seed=3)
    kp, vp, _, _ = pools[0]
    reset_launch_counts()
    got = pmk.fused_prefill_layer(fused[0], h, kp.clone(), vp.clone(), *meta,
                                  **kw)[0]
    torch.cuda.synchronize()
    assert LAUNCHES["prefill_megakernel"] == 1
    want = pmk._reference_prefill_layer(
        fused[0], h, kp.clone(), vp.clone(), *meta, num_kv_heads=32,
        head_dim=128, page_size=16, **kw)[0]
    _close(got, want, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("pool", ["fp", "int8"])
def test_prefill_megakernel_model_scope_matches_plain_version(cuda, pool,
                                                              dtype):
    """Three layers through ``fused_prefill_model``: one launch per layer;
    h and every layer's pools against the plain layer loop."""
    from paddle_tpu_torch.kernels import prefill_megakernel as pmk
    quant = pool == "int8"
    fused, h, pools, meta, kw = _prefill_fixture(
        cuda, dtype, (8, 2, 64), quant_kv=quant, layers=3)
    runs = []
    for side in ("kernel", "plain"):
        ps_ = _clone_pools(pools)
        args = ([p[0] for p in ps_], [p[1] for p in ps_])
        sc = dict(k_scales=[p[2] for p in ps_],
                  v_scales=[p[3] for p in ps_]) if quant else {}
        reset_launch_counts()
        if side == "kernel":
            out = pmk.fused_prefill_model(fused, h, *args, *meta, **sc,
                                          **kw)
            torch.cuda.synchronize()
            assert LAUNCHES["prefill_megakernel"] == 3
        else:
            hh = h
            for i, lyr in enumerate(fused):
                hh = pmk._reference_prefill_layer(
                    lyr, hh, args[0][i], args[1][i], *meta, num_kv_heads=2,
                    head_dim=64, page_size=16,
                    k_scales=sc["k_scales"][i] if quant else None,
                    v_scales=sc["v_scales"][i] if quant else None, **kw)[0]
            out = (hh, *args)
        runs.append(out)
    (got, gk, gv), (want, wk, wv) = runs[0][:3], runs[1]
    _close(got, want, dtype)
    for a_list, b_list in ((gk, wk), (gv, wv)):
        for a, b in zip(a_list, b_list):
            if quant:
                assert (a[:, 1:].int() - b[:, 1:].int()).abs().max() <= 1
            else:
                _close(a[:, 1:], b[:, 1:], dtype)


#: rows packing to T = 64 and T = 128 (one spare q block closes each)
PREFILL_T_ROWS = {64: [(32, 40), (1, 17), (13, 60), (0, 0)],
                  128: [(64, 100), (1, 33), (40, 90), (1, 5), (0, 0)]}


@pytest.mark.cuda
@pytest.mark.parametrize("heads", [(4, 4, 64), (8, 2, 64)],
                         ids=["mha", "gqa"])
@pytest.mark.parametrize("pool", ["bf16", "int8"])
@pytest.mark.parametrize("weights", ["bf16", "int8"])
@pytest.mark.parametrize("T", sorted(PREFILL_T_ROWS))
def test_prefill_megakernel_twice_bitwise_at_full_token_tiles(
        cuda, T, weights, pool, heads):
    """The tensor-core layer (TMA + wgmma projections, the K split of o
    and down over a cluster, attention on mma.sync) at T = 64 and a
    whole 128-token tile: two launches bitwise equal (h and the pools),
    and within the plain version's tolerance."""
    from paddle_tpu_torch.kernels import prefill_megakernel as pmk
    quant_w, quant_kv = weights == "int8", pool == "int8"
    fused, h, pools, meta, kw = _prefill_fixture(
        cuda, torch.bfloat16, heads, quant_w=quant_w, quant_kv=quant_kv,
        rows=PREFILL_T_ROWS[T])
    assert h.shape[1] == T
    runs = []
    for _ in range(2):
        kp, vp, ks, vs = _clone_pools(pools)[0]
        reset_launch_counts()
        runs.append(pmk.fused_prefill_layer(fused[0], h, kp, vp, *meta,
                                            k_scales=ks, v_scales=vs, **kw))
        torch.cuda.synchronize()
        assert LAUNCHES["prefill_megakernel"] == 1
    for a, b in zip(*runs):
        assert a is None or torch.equal(a, b)
    kp, vp, ks, vs = _clone_pools(pools)[0]
    want = pmk._reference_prefill_layer(
        fused[0], h, kp, vp, *meta, num_kv_heads=heads[1],
        head_dim=heads[2], page_size=16, k_scales=ks, v_scales=vs, **kw)
    _close(runs[0][0], want[0], torch.bfloat16)


@pytest.mark.cuda
def test_prefill_megakernel_rejects_what_it_does_not_take(cuda):
    from paddle_tpu_torch.kernels import prefill_megakernel as pmk
    from paddle_tpu_torch.quantization.low_bit import quantize_weight
    fused, h, pools, meta, kw = _prefill_fixture(cuda, torch.float32,
                                                 (4, 4, 32))
    kp, vp, _, _ = pools[0]
    tbl, pre, q_starts, q_lens, kv_lens = meta
    reset_launch_counts()
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        pmk.fused_prefill_layer(fused[0], h.half(), kp, vp, *meta, **kw)
    with pytest.raises(TypeError, match="block_tables"):
        pmk.fused_prefill_layer(fused[0], h, kp, vp, tbl.long(),
                                *meta[1:], **kw)
    with pytest.raises(TypeError, match="k_pages"):
        pmk.fused_prefill_layer(fused[0], h, kp.to(torch.bfloat16), vp,
                                *meta, **kw)
    with pytest.raises(TypeError, match="slot"):
        pmk.fused_prefill_layer(fused[0], h, kp, vp, tbl,
                                pre._replace(slot=pre.slot.long()),
                                *meta[2:], **kw)
    int4 = dict(fused[0])
    w4 = quantize_weight(fused[0]["o"].cpu(), "weight_only_int4")
    w4.qdata, w4.scale = w4.qdata.to(cuda), w4.scale.to(cuda)
    int4["o"] = w4
    with pytest.raises(NotImplementedError, match="int4"):
        pmk.fused_prefill_layer(int4, h, kp, vp, *meta, **kw)
    # the tensor-core limits: head_dim a multiple of 16 (mma.sync k
    # steps), int8 weight widths a multiple of 16 (16-byte tensor-map
    # rows); on the CUDA cores, at most 64 query rows per q block and kv
    # head, which bf16 (m16 tiles) does not need
    f24, h24, p24, m24, kw24 = _prefill_fixture(cuda, torch.bfloat16,
                                                (4, 4, 24))
    with pytest.raises(ValueError, match="multiple of 16"):
        pmk.fused_prefill_layer(f24[0], h24, *p24[0][:2], *m24, **kw24)
    f8, h8, p8, m8, kw8 = _prefill_fixture(cuda, torch.bfloat16, (4, 4, 32),
                                           quant_w=True, D=264)
    with pytest.raises(ValueError, match="multiple of 16"):
        pmk.fused_prefill_layer(f8[0], h8, *p8[0][:2], *m8, **kw8)
    for dtype, ok in ((torch.float32, False), (torch.bfloat16, True)):
        fw, hw, pw, mw, kww = _prefill_fixture(cuda, dtype, (16, 1, 32))
        if ok:
            pmk.fused_prefill_layer(fw[0], hw, *pw[0][:2], *mw, **kww)
            torch.cuda.synchronize()
        else:
            with pytest.raises(ValueError, match="64 query rows"):
                pmk.fused_prefill_layer(fw[0], hw, *pw[0][:2], *mw, **kww)
    assert LAUNCHES["prefill_megakernel"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("scope", ["layer", "model"])
@pytest.mark.parametrize("knobs", [
    {}, dict(quantized_mode="weight_only_int8", kv_cache_dtype="int8")],
    ids=["fp", "w8_kv8"])
def test_fused_engine_on_the_card_matches_the_cpu(cuda, knobs, scope):
    """Greedy tokens of a small f32 Llama through
    ``prefill_megakernel="fused"``: the card (every ragged step's layers
    through the prefill megakernel, no ragged-attention launch) equals
    the CPU (the plain body)."""
    cfg = pt.llama_tiny_config(num_hidden_layers=2, num_key_value_heads=2)
    model = pt.LlamaForCausalLM(cfg, device="cpu",
                                generator=torch.Generator().manual_seed(0))
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size, (n,)).tolist()
               for n in (3, 17, 40, 9)]
    tokens = {}
    for dev in ("cpu", "cuda"):
        eng = pt.LLMEngine(model, max_len=96, page_size=16, max_num_seqs=4,
                           chunk_size=16, device=dev, megakernel_scope=scope,
                           prefill_megakernel="fused", **knobs)
        rids = [eng.add_request(p, max_new_tokens=9) for p in prompts]
        reset_launch_counts()
        outs = eng.run(max_steps=200)
        snap = eng.metrics_snapshot()
        steps = snap["decode_steps"]
        want = cfg.num_hidden_layers * steps if dev == "cuda" else 0
        assert LAUNCHES["prefill_megakernel"] == want
        assert LAUNCHES["ragged_paged_attention"] == 0
        assert LAUNCHES["ragged_paged_attention_int8"] == 0
        assert snap["prefill_megakernel_mode"] == ("cuda" if dev == "cuda"
                                                   else "plain")
        assert eng.pool.check_invariants()
        tokens[dev] = [outs[r].token_ids for r in rids]
    assert tokens["cuda"] == tokens["cpu"]


# ---------------------------------------------------------------------------
# rms_norm forward and backward; remat and accumulation on the card
# ---------------------------------------------------------------------------

#: the llama_1b and llama_125m norm shapes, a ragged one (odd rows, an
#: f that the 16-byte bf16 vector does not divide, wider than the register
#: tile), one row of the 1b norm (fewer rows than the backward's blocks),
#: a row wider than the register tile (the wide kernels) and an odd f
#: inside it (the single-element tile)
RMS_SHAPES = {"1b": (2048, 2048), "125m": (8192, 768), "ragged": (37, 4100),
              "one_row": (1, 2048), "wide": (3, 8192), "odd": (9, 1001)}


def _rms_case(dev, rows, f, xdt, wdt, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(rows, f, device=dev, generator=g).to(xdt)
    w = (1 + 0.5 * torch.randn(f, device=dev, generator=g)).to(wdt)
    dy = torch.randn(rows, f, device=dev, generator=g).to(xdt)
    return x, w, dy


def _ulp_bf16(v):
    e = torch.floor(torch.log2(v.abs().clamp_min(2.0 ** -126)))
    return torch.exp2(e - 7)


def _rms_close(got, want, dtype, summed):
    """f32: max|diff| <= 1e-5 x max|plain| (sums in another order).
    bf16: one bf16 ulp of the larger value, elementwise, plus 1e-5 x
    max|plain| where the f32 value before the cast carries a sum."""
    got, want = got.float(), want.float()
    assert got.shape == want.shape and torch.isfinite(got).all()
    scale = want.abs().max().item()
    if dtype == torch.float32:
        err = (got - want).abs().max().item()
        assert err <= 1e-5 * scale, err
        return
    tol = _ulp_bf16(torch.maximum(got.abs(), want.abs())) + \
        (1e-5 * scale if summed else 0.0)
    assert ((got - want).abs() <= tol).all(), \
        (got - want).abs().max().item()


RMS_DTYPES = {"f32": (torch.float32, torch.float32),
              "bf16": (torch.bfloat16, torch.bfloat16),
              "bf16_x_f32_w": (torch.bfloat16, torch.float32),
              "f32_x_bf16_w": (torch.float32, torch.bfloat16)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtypes", sorted(RMS_DTYPES))
@pytest.mark.parametrize("shape", sorted(RMS_SHAPES))
def test_rms_norm_kernels_match_plain_version(cuda, shape, dtypes):
    from paddle_tpu_torch.kernels import rms_norm as trn
    xdt, wdt = RMS_DTYPES[dtypes]
    x, w, dy = _rms_case(cuda, *RMS_SHAPES[shape], xdt, wdt)
    reset_launch_counts()
    y, rstd = trn.rms_norm_fwd(x, w, 1e-5)
    dx, dw = trn.rms_norm_bwd(x, w, rstd, dy)
    dx2, dw2 = trn.rms_norm_bwd(x, w, rstd, dy)
    torch.cuda.synchronize()
    assert LAUNCHES["rms_norm_fwd"] == 1 and LAUNCHES["rms_norm_bwd"] == 2
    assert torch.equal(dw, dw2) and torch.equal(dx, dx2)   # deterministic
    py, prstd = trn.rms_norm_fwd_reference(x, w, 1e-5)
    pdx, pdw = trn.rms_norm_bwd_reference(x, w, rstd, dy)
    ydt = torch.promote_types(xdt, wdt)
    assert (y.dtype, dx.dtype, dw.dtype) == (ydt, xdt, wdt)
    err = ((rstd - prstd).abs() / prstd).max().item()
    assert err <= 1e-5, err
    _rms_close(y, py, xdt, summed=False)
    _rms_close(dx, pdx, xdt, summed=True)
    _rms_close(dw, pdw, wdt, summed=True)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["1b", "odd", "wide"])
def test_rms_norm_bf16_x_with_f32_weight_returns_f32(cuda, shape):
    """x and w promoted, as the reference's ``_rms_norm_reference``: an
    f32 y from the kernel, its rows rounded nowhere before the store."""
    from paddle_tpu_torch.kernels import rms_norm as trn
    x, w, _ = _rms_case(cuda, *RMS_SHAPES[shape], torch.bfloat16,
                        torch.float32)
    y = pt.nn.functional.rms_norm(x, w, 1e-5)
    torch.cuda.synchronize()
    assert y.dtype == torch.float32 and y.shape == x.shape
    py, _ = trn.rms_norm_fwd_reference(x, w, 1e-5)
    assert py.dtype == torch.float32
    _rms_close(y, py, torch.float32, summed=False)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_rms_norm_kernels_on_unaligned_rows(cuda, dtype):
    """Rows that start one element past a 16-byte boundary take the
    single-element path (vec = 0) at the 1b width."""
    from paddle_tpu_torch.kernels import rms_norm as trn
    rows, f = 40, 2048
    g = torch.Generator(device=cuda).manual_seed(3)
    base = torch.randn(2, rows * f + 1, device=cuda, generator=g).to(dtype)
    x, dy = base[0, 1:].view(rows, f), base[1, 1:].view(rows, f)
    w = (1 + 0.5 * torch.randn(f, device=cuda, generator=g)).to(dtype)
    assert trn._vec(f, x, w) == 0
    y, rstd = trn.rms_norm_fwd(x, w, 1e-5)
    dx, dw = trn.rms_norm_bwd(x, w, rstd, dy)
    py, _ = trn.rms_norm_fwd_reference(x, w, 1e-5)
    pdx, pdw = trn.rms_norm_bwd_reference(x, w, rstd, dy)
    _rms_close(y, py, dtype, summed=False)
    _rms_close(dx, pdx, dtype, summed=True)
    _rms_close(dw, pdw, dtype, summed=True)


@pytest.mark.cuda
def test_rms_norm_through_autograd_launches_the_kernels(cuda):
    """``nn.RMSNorm`` on a 3-D strided view: one forward and one backward
    launch, gradients equal to the plain version's on the CPU."""
    base = torch.randn(2, 9, 80)
    for dev in ("cpu", cuda):
        x = base.to(dev)[:, :, 8:72]
        norm = pt.nn.RMSNorm(64, 1e-6, device=dev)
        with torch.no_grad():
            norm.weight.copy_(torch.linspace(0.5, 1.5, 64))
        xt = x.requires_grad_()
        reset_launch_counts()
        norm(xt).square().sum().backward()
        if dev == "cpu":
            want = (xt.grad, norm.weight.grad)
            assert LAUNCHES["rms_norm_fwd"] == 0
        else:
            assert LAUNCHES["rms_norm_fwd"] == LAUNCHES["rms_norm_bwd"] == 1
            for a, b in zip((xt.grad, norm.weight.grad), want):
                _rms_close(a.cpu(), b, torch.float32, summed=True)


@pytest.mark.cuda
def test_rms_norm_kernel_rejects_what_it_does_not_take(cuda):
    from paddle_tpu_torch.kernels import rms_norm as trn
    x = torch.randn(4, 16, device=cuda, dtype=torch.float64)
    w = torch.ones(16, device=cuda, dtype=torch.float64)
    reset_launch_counts()
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        trn.rms_norm(x, w)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        trn.rms_norm_fwd(x, w, 1e-6)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        pt.nn.functional.rms_norm(x.half(), w.half())
    with pytest.raises(ValueError, match="contiguous last axis"):
        trn.rms_norm(torch.randn(16, 4, device=cuda).t(),
                     torch.ones(16, device=cuda))
    with pytest.raises(ValueError, match="on cpu"):
        trn.rms_norm(torch.randn(4, 16, device=cuda), torch.ones(16))
    assert LAUNCHES["rms_norm_fwd"] == 0


@pytest.mark.cuda
def test_remat_and_accumulation_on_the_card_match_the_cpu(cuda):
    """3 AdamW steps of a tiny f32 Llama with ``remat=True`` and
    ``accumulate_steps=2``: the losses on the card match the CPU to 1e-4
    relative (as test_train_step_on_the_card_matches_the_cpu); every
    layer's norms and attention forward run twice (the replay)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    reset_launch_counts()
    on_card, cfg = _tiny_train(cuda, remat=True, accumulate_steps=2)
    n = 3 * 2                                    # steps x micro-batches
    L = cfg.num_hidden_layers
    assert LAUNCHES["rms_norm_fwd"] == n * (4 * L + 1)
    assert LAUNCHES["rms_norm_bwd"] == n * (2 * L + 1)
    assert LAUNCHES["flash_attention_fwd"] == n * 2 * L
    assert LAUNCHES["fused_adamw"] == 3
    on_cpu, _ = _tiny_train("cpu", remat=True, accumulate_steps=2)
    np.testing.assert_allclose(on_card, on_cpu, rtol=1e-4)
    assert on_card[-1] < on_card[0]
