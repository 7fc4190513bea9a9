"""paddle_tpu_torch's prefill megakernel module and fused engine against
``paddle_tpu.kernels.prefill_megakernel`` and the JAX fused engine.

The same numpy inputs go through both packages. The layer fixture is the
reference test's mixed step (``tests/test_prefill_megakernel.py``
``_layer_fixture``: a full prefill chunk, a decode row, a continuation
chunk and a pad row; T 32, D 64, H 4, Hkv 2, dh 16, page 8). Tolerances,
all in f32: the prologue's integers exactly and its tables within one
ulp (XLA's and torch's cos/sin); the plain layer against the
reference's jnp body 1e-5 (of the largest value) on the live tokens' h
and on the pools (the null page excluded: both sides leave it and the
dead tokens' h unspecified), int8 pages within one
quantization step (the same K/V rounded on the other side of a .5 in
another summation order) and scales 1e-6 relative; against the Pallas
kernel in interpret mode 1e-4, the reference's own kernel tolerance.
The engines: greedy tokens, step plans and int8 scales (1e-5 relative,
as the unfused low-bit engines) equal the JAX fused engine's. The CUDA
kernel itself is held to the plain version on the card
(``tests/test_torch_cuda_kernels.py``).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.kernels import prefill_megakernel as jpmk
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import llama_tiny_config as jax_tiny_config
from paddle_tpu.quantization.low_bit import quantize_weight as jquantize
from paddle_tpu.serving import LLMEngine as JaxEngine
from paddle_tpu.serving import engine as jengine
import paddle_tpu_torch as pt
from paddle_tpu_torch.kernels import LAUNCHES, reset_launch_counts
from paddle_tpu_torch.kernels import prefill_megakernel as tpmk
from paddle_tpu_torch.quantization.low_bit import QuantizedWeight
from paddle_tpu_torch.serving import engine as tengine

QB = 8
KW = dict(eps=1e-6, num_heads=4, q_block=QB)
MATS = ("q", "k", "v", "o", "gate", "up", "down")


def _fixture(seed=0, T=32, R=4, D=64, H=4, Hkv=2, dh=16, F=96, PPS=6, ps=8,
             P=16):
    """numpy arrays of the reference's ``_layer_fixture``, its rows
    packed at q_block multiples as the engine packs them: the reference
    starts its continuation chunk at token 9, inside the decode row's q
    block, where the ragged kernel's block -> row map (which both of its
    layer bodies use) gives that block to the decode row alone."""
    rng = np.random.default_rng(seed)

    def arr(*s):
        return rng.standard_normal(s).astype(np.float32) * 0.3

    layer = {"ln1": arr(D) + 1.0, "ln2": arr(D) + 1.0,
             "q": arr(D, H * dh), "k": arr(D, Hkv * dh),
             "v": arr(D, Hkv * dh), "o": arr(H * dh, D),
             "gate": arr(D, F), "up": arr(D, F), "down": arr(F, D)}
    h = arr(1, T, D)
    Kp, Vp = arr(Hkv, P, ps, dh), arr(Hkv, P, ps, dh)
    tbls = np.full((R, PPS), 0, np.int32)
    tbls[:, :3] = rng.permutation(np.arange(1, P))[:R * 3].reshape(R, 3)
    q_lens = np.array([8, 1, 13, 0], np.int32)
    q_starts = np.array([0, 8, 16, T], np.int32)
    kv_lens = np.array([8, 5, 20, 0], np.int32)
    positions = np.zeros((T,), np.int32)
    for r in range(R):
        for t in range(q_lens[r]):
            positions[q_starts[r] + t] = kv_lens[r] - q_lens[r] + t
    return layer, h, Kp, Vp, tbls, positions, q_starts, q_lens, kv_lens


def _prologues(positions, tbls, q_starts, q_lens, dh=16, ps=8):
    kw = dict(theta=10000.0, head_dim=dh, page_size=ps,
              max_pages=tbls.shape[1], q_block=QB)
    jpre = jpmk.ragged_prologue(jnp.asarray(positions), jnp.asarray(tbls),
                                jnp.asarray(q_starts), jnp.asarray(q_lens),
                                **kw)
    tpre = tpmk.ragged_prologue(*(torch.from_numpy(a) for a in (
        positions, tbls, q_starts, q_lens)), **kw)
    return jpre, tpre


def test_ragged_prologue_matches_jax():
    """slot and block_row exactly; cos and sin within one f32 ulp: the
    angles are bitwise equal, and XLA's and torch's cos/sin differ in the
    last bit for a few of them."""
    _, _, _, _, tbls, positions, q_starts, q_lens, _ = _fixture()
    jpre, tpre = _prologues(positions, tbls, q_starts, q_lens)
    for name in ("cos", "sin", "slot", "block_row"):
        a, b = getattr(tpre, name).numpy(), np.asarray(getattr(jpre, name))
        assert a.shape == b.shape and a.dtype == b.dtype, name
        if name in ("cos", "sin"):
            np.testing.assert_array_max_ulp(a, b, maxulp=1)
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)
    # dead tokens (slot padding after the chunks) go to the null page
    assert (tpre.slot[9:16] < 8).all() and (tpre.slot[29:] < 8).all()


def _quantized_pair(w):
    """The reference's int8 weight of ``w`` and the port's, byte for
    byte."""
    jw = jquantize(jnp.asarray(w), "weight_only_int8")
    return jw, QuantizedWeight.from_numpy(np.asarray(jw.qdata),
                                          np.asarray(jw.scale), jw.bits,
                                          jw.rows)


def _layers(layer, quant_w):
    jl = {k: jnp.asarray(v) for k, v in layer.items()}
    tl = {k: torch.from_numpy(v.copy()) for k, v in layer.items()}
    if quant_w:
        for k in MATS:
            jl[k], tl[k] = _quantized_pair(layer[k])
    return jl, tl


@pytest.mark.parametrize("quant_w", [False, True], ids=["fp", "int8"])
def test_fuse_layer_weights_byte_identical(quant_w):
    jl, tl = _layers(_fixture()[0], quant_w)
    jf, tf = jpmk.fuse_layer_weights(jl), tpmk.fuse_layer_weights(tl)
    assert set(tf) == set(jf)
    for k in jf:
        a, b = tf[k], jf[k]
        if quant_w and k not in ("ln1", "ln2"):
            assert (a.bits, a.rows) == (b.bits, b.rows)
            assert a.qdata.dtype == torch.int8
            np.testing.assert_array_equal(a.qdata.numpy(),
                                          np.asarray(b.qdata))
            np.testing.assert_array_equal(a.scale.numpy(),
                                          np.asarray(b.scale).reshape(-1))
        else:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("quant_w", [False, True], ids=["fp", "int8"])
def test_slice_qkv_reads_the_fused_weight_in_place(quant_w):
    """The k|v columns the fused int8 + int8-KV layer projects outside the
    kernel are a view of the fused q|k|v weight (no copy), and projecting
    them in one call equals the reference's k and v columns of the fused
    weight (1e-5 of the largest value, f32)."""
    H, Hkv, dh = 4, 2, 16
    lo, hi = H * dh, (H + 2 * Hkv) * dh
    jl, tl = _layers(_fixture()[0], quant_w)
    jf, tf = jpmk.fuse_layer_weights(jl), tpmk.fuse_layer_weights(tl)
    kv = tpmk._slice_qkv(tf)(lo, hi)
    fused = tf["qkv"]
    if quant_w:
        base, view = fused.qdata, kv.qdata
        assert kv.scale.untyped_storage().data_ptr() == \
            fused.scale.untyped_storage().data_ptr()
        np.testing.assert_array_equal(kv.scale.numpy(),
                                      np.asarray(jf["qkv"].scale)
                                      .reshape(-1)[lo:hi])
        want_w = np.asarray(jf["qkv"].qdata, np.float32)[:, lo:hi] * \
            np.asarray(jf["qkv"].scale).reshape(1, -1)[:, lo:hi]
    else:
        base, view = fused, kv
        want_w = np.asarray(jf["qkv"])[:, lo:hi]
    assert view.untyped_storage().data_ptr() == \
        base.untyped_storage().data_ptr()
    assert view.shape == (base.shape[0], hi - lo)
    assert view.stride() == (base.shape[1], 1) and not view.is_contiguous()
    x = np.random.default_rng(1).standard_normal((5, base.shape[0])) \
        .astype(np.float32)
    got = pt.models.generation._wmat(torch.from_numpy(x), kv).numpy()
    want = x @ want_w
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_fuse_layer_weights_refuses_int4_and_mixed_like_jax():
    layer = _fixture()[0]
    jl, tl = _layers(layer, False)
    j4 = jquantize(jnp.asarray(layer["q"]), "weight_only_int4")
    t4 = QuantizedWeight.from_numpy(np.asarray(j4.qdata),
                                    np.asarray(j4.scale), 4, j4.rows)
    assert jpmk.fuse_layer_weights(dict(jl, q=j4)) is None
    assert tpmk.fuse_layer_weights(dict(tl, q=t4)) is None
    j8, t8 = _quantized_pair(layer["q"])
    assert jpmk.fuse_layer_weights(dict(jl, q=j8)) is None
    assert tpmk.fuse_layer_weights(dict(tl, q=t8)) is None
    assert tpmk.prefill_megakernel_mode(None, "cpu") == "plain"


def _int8_pools(Kp, seed=11):
    """The reference test's int8 pools and per-(head, page) scales."""
    rng = np.random.default_rng(seed)
    Hkv, P = Kp.shape[:2]
    Kq = rng.integers(-127, 128, Kp.shape).astype(np.int8)
    Vq = rng.integers(-127, 128, Kp.shape).astype(np.int8)
    Ks = rng.uniform(0.01, 0.05, (Hkv, P)).astype(np.float32)
    Vs = rng.uniform(0.01, 0.05, (Hkv, P)).astype(np.float32)
    return Kq, Vq, Ks, Vs


def _append_fns(tbls, q_starts, q_lens, kv_lens, ps, T):
    """Both packages' int8 chunk append for the fixture's step: the
    reference's ``_segmented_quant_append`` and the port's, planned on the
    host."""
    PPS, P = tbls.shape[1], 16
    jargs = [jnp.asarray(a) for a in (tbls, q_starts, q_lens, kv_lens)]

    def jfn(Kp, Ks, Vp, Vs, kt, vt):
        Kp, Ks = jengine._segmented_quant_append(Kp, Ks, kt, *jargs, ps,
                                                 PPS, P)
        Vp, Vs = jengine._segmented_quant_append(Vp, Vs, vt, *jargs, ps,
                                                 PPS, P)
        return Kp, Ks, Vp, Vs

    page, tok, sel = (torch.from_numpy(a) for a in tengine._append_plan(
        tbls, q_starts, q_lens, kv_lens, ps, P, T))
    return jfn, tengine._chunk_append_fn((page.long(), tok.long(),
                                          sel.bool()))


#: case -> (int8 weights, int8 pool)
CASES = {"fp": (False, False), "int8_w": (True, False),
         "int8_w_int8_kv": (True, True)}


def _case(case, seed=0):
    quant_w, quant_kv = CASES[case]
    layer, h, Kp, Vp, tbls, positions, q_starts, q_lens, kv_lens = \
        _fixture(seed)
    jpre, tpre = _prologues(positions, tbls, q_starts, q_lens)
    jl, tl = _layers(layer, quant_w)
    jsc, tsc = {}, {}
    if quant_kv:
        Kp, Vp, Ks, Vs = _int8_pools(Kp)
        jfn, tfn = _append_fns(tbls, q_starts, q_lens, kv_lens, 8, 32)
        jsc = dict(k_scales=jnp.asarray(Ks), v_scales=jnp.asarray(Vs),
                   quant_append_fn=jfn)
        tsc = dict(k_scales=torch.from_numpy(Ks.copy()),
                   v_scales=torch.from_numpy(Vs.copy()), quant_append_fn=tfn)
    common = (h, Kp, Vp, tbls)
    meta = (q_starts, q_lens, kv_lens)
    jargs = [jnp.asarray(a) for a in common] + [jpre] + \
        [jnp.asarray(a) for a in meta]
    targs = [torch.from_numpy(a.copy()) for a in common] + [tpre] + \
        [torch.from_numpy(a) for a in meta]
    return (jpmk.fuse_layer_weights(jl), jargs, jsc), \
        (tpmk.fuse_layer_weights(tl), targs, tsc)


#: the fixture's live tokens: the full chunk, the decode row and the
#: continuation chunk (slot padding and the pad row are dead: the
#: reference leaves their attention output, hence their h, unspecified)
LIVE = np.r_[0:9, 16:29]


def _close(a, b, tol):
    """max |a - b| <= tol x max(1, max |b|): f32 sums in another order
    (XLA's dots against torch's) err in proportion to the values' scale,
    which reaches ~50 in this fixture's h."""
    err = np.abs(a - b).max()
    assert err <= tol * max(1.0, np.abs(b).max()), err


def _assert_layer(got, want, tol):
    """h on the live tokens and the pools' pages other than the null page
    within ``tol`` (int8 pages: one step); int8 scales 1e-6 relative."""
    _close(got[0].numpy()[:, LIVE], np.asarray(want[0])[:, LIVE], tol)
    for a, b in zip(got[1:3], want[1:3]):
        a, b = a.numpy()[..., 1:, :, :], np.asarray(b)[..., 1:, :, :]
        if a.dtype == np.int8:
            assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
        else:
            _close(a, b, tol)
    for a, b in zip(got[3:], want[3:]):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=0)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_layer_matches_jax_reference_body(case):
    (jf, jargs, jsc), (tf, targs, tsc) = _case(case)
    Hkv, _, ps, dh = targs[1].shape
    want = jpmk._reference_prefill_layer(
        jf, *jargs, eps=KW["eps"], num_heads=4, num_kv_heads=Hkv,
        head_dim=dh, page_size=ps, q_block=QB, attn_interpret=True, **jsc)
    reset_launch_counts()
    got = tpmk.fused_prefill_layer(tf, *targs, **KW, **tsc)
    assert LAUNCHES["prefill_megakernel"] == 0
    assert got[0].dtype == torch.float32 and got[0].shape == (1, 32, 64)
    # the pools are the caller's, updated in place
    assert got[1] is targs[1] and got[2] is targs[2]
    _assert_layer(got, want, 1e-5)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_layer_matches_jax_pallas_kernel_interpret(case):
    """The reference's own kernel-vs-body tolerance (1e-4)."""
    (jf, jargs, jsc), (tf, targs, tsc) = _case(case)
    want = jpmk.fused_prefill_layer(jf, *jargs, interpret=True,
                                    attn_interpret=True, **KW, **jsc)
    got = tpmk.fused_prefill_layer(tf, *targs, **KW, **tsc)
    _assert_layer(got, want, 1e-4)


@pytest.mark.parametrize("case", ["fp", "int8_w_int8_kv"])
def test_plain_model_matches_jax_fused_prefill_model(case):
    """Three layers, stacked as the reference's scan takes them: h, the
    stacked pools and scales."""
    from paddle_tpu.kernels.decode_megakernel import \
        stack_layer_params as jstack
    from paddle_tpu_torch.kernels.decode_megakernel import \
        stack_layer_params as tstack
    cases = [_case(case, seed=s) for s in range(3)]
    (_, jargs, jsc), (_, targs, tsc) = cases[0]
    jl = jstack([c[0][0] for c in cases])
    tl = tstack([c[1][0] for c in cases])
    jpools = [jnp.stack([c[0][1][i] for c in cases]) for i in (1, 2)]
    tpools = [torch.stack([c[1][1][i] for c in cases]) for i in (1, 2)]
    if tsc:
        for k in ("k_scales", "v_scales"):
            jsc[k] = jnp.stack([c[0][2][k] for c in cases])
            tsc[k] = torch.stack([c[1][2][k] for c in cases])
    rest = 3
    want = jpmk.fused_prefill_model(
        jl, jargs[0], *jpools, *jargs[rest:], attn_interpret=True, **KW,
        **jsc)
    got = tpmk.fused_prefill_model(tl, targs[0], *tpools, *targs[rest:],
                                   **KW, **tsc)
    assert got[1].shape == tpools[0].shape
    _assert_layer(got, want, 1e-5)


def test_wrapper_refuses_mismatched_scales_and_missing_append():
    (_, _, _), (tf, targs, tsc) = _case("int8_w_int8_kv")
    with pytest.raises(ValueError, match="together"):
        tpmk.fused_prefill_layer(tf, *targs, k_scales=tsc["k_scales"], **KW)
    with pytest.raises(ValueError, match="quant_append_fn"):
        tpmk.fused_prefill_layer(tf, *targs, k_scales=tsc["k_scales"],
                                 v_scales=tsc["v_scales"], **KW)
    assert not tpmk.prefill_fallback_tripped()


# ---------------------------------------------------------------------------
# LLMEngine(prefill_megakernel="fused")
# ---------------------------------------------------------------------------

TINY = dict(num_hidden_layers=2, hidden_size=64, intermediate_size=128,
            num_attention_heads=4, num_key_value_heads=2, vocab_size=128)


@pytest.fixture(scope="module")
def models():
    """A JAX Llama and the port's, with the same weights."""
    paddle.seed(7)
    jm = JaxLlama(jax_tiny_config(**TINY))
    tm = pt.LlamaForCausalLM(pt.llama_tiny_config(**TINY), device="cpu")
    pt.load_numpy_state_dict(
        tm, {k: np.asarray(v) for k, v in jm.state_dict().items()})
    return jm, tm


def _prompts(lengths, seed):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, TINY["vocab_size"], (n,)).tolist()
            for n in lengths]


def _traces():
    """The serving tests' mixed, starved-pool and prefix-fork traces."""
    same = _prompts([18], seed=33)[0]
    tails = _prompts([2, 3], seed=35)
    return {
        "mixed": (
            {0: [(p, dict(max_new_tokens=6)) for p in
                 _prompts([3, 9, 17, 30, 41, 5, 22, 12], seed=0)]},
            dict(max_len=64, page_size=4, max_num_seqs=4, chunk_size=16)),
        "starved_pool": (
            {0: [(p, dict(max_new_tokens=8)) for p in
                 _prompts([6, 7, 9, 11], seed=1)]},
            dict(max_len=32, page_size=4, num_pages=9)),
        "prefix_fork": (
            {0: [(same, dict(max_new_tokens=10))],
             1: [(same, dict(max_new_tokens=5)),
                 (same[:16] + tails[0], dict(max_new_tokens=5))]},
            dict(max_len=64, page_size=8, max_num_seqs=4, chunk_size=32)),
    }


def _serve(engine, arrivals, max_steps=500):
    """Drive ``engine`` over a trace. Returns the tokens, every planning
    call (bursts and ragged steps, with their preemptions), the int8
    pool's scales after every step, and the metrics snapshot."""
    plans, scales = [], []
    sch = engine.scheduler
    orig_burst, orig_step = sch.prepare_burst, sch.prepare_step

    def prepare_burst(n):
        plan = orig_burst(n)
        plans.append(("burst", None if plan is None else
                      ([(q.seq_id, c) for q, c in plan.rows], plan.burst_len),
                      [q.seq_id for q in sch.last_preempted]))
        return plan

    def prepare_step():
        plan = orig_step()
        plans.append(("step", None if plan is None else
                      [(q.seq_id, qs, ql) for q, qs, ql in plan.rows],
                      [q.seq_id for q in sch.last_preempted]))
        return plan

    sch.prepare_burst, sch.prepare_step = prepare_burst, prepare_step
    rids, step = [], 0
    while step <= max(arrivals) or engine.has_unfinished():
        for prompt, kw in arrivals.get(step, []):
            rids.append(engine.add_request(prompt, **kw))
        engine.step()
        if engine.pool.kv_scales is not None:
            scales.append([np.array(a) for pair in engine.pool.kv_scales
                           for a in pair])
        step += 1
        assert step < max_steps, "the trace did not drain"
    outs = engine.outputs()
    return ([outs[r].token_ids for r in rids], plans, scales,
            engine.metrics_snapshot())


_KNOBS = {"fp": {}, "w8": dict(quantized_mode="weight_only_int8"),
          "w8_kv8": dict(quantized_mode="weight_only_int8",
                         kv_cache_dtype="int8")}

_COUNTERS = ("requests_added", "tokens_generated", "prefills",
             "prefill_chunks", "decode_steps", "preemptions", "cow_copies",
             "prefix_cache_hits", "prefix_cache_misses", "finished_requests",
             "host_dispatches", "prefill_launches", "burst_launches")


def _check_engines(models, trace, **knobs):
    jm, tm = models
    arrivals, kw = _traces()[trace]
    kw = dict(kw, prefill_megakernel="fused", **knobs)
    jtok, jplans, jscales, jsnap = _serve(JaxEngine(jm, **kw), arrivals)
    teng = pt.LLMEngine(tm, device="cpu", **kw)
    reset_launch_counts()
    ttok, tplans, tscales, tsnap = _serve(teng, arrivals)
    assert sum(LAUNCHES.values()) == 0
    assert ttok == jtok and tplans == jplans
    for c in _COUNTERS:
        assert tsnap[c] == jsnap[c], c
    assert (tsnap["prefill_megakernel"], jsnap["prefill_megakernel"]) == \
        ("fused", "fused")
    assert tsnap["prefill_megakernel_mode"] == "plain"
    assert len(tscales) == len(jscales)
    assert bool(tscales) == ("kv_cache_dtype" in kw)
    for t_step, j_step in zip(tscales, jscales):
        for a, b in zip(t_step, j_step):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=0)
    assert teng.pool.check_invariants()
    return tsnap


@pytest.mark.parametrize("knobs", sorted(_KNOBS))
@pytest.mark.parametrize("scope", ["layer", "model"])
@pytest.mark.parametrize("trace", ["mixed", "starved_pool", "prefix_fork"])
def test_fused_engine_matches_jax(models, trace, scope, knobs):
    """Every ragged step through the fused layer, at both scopes: greedy
    tokens, step plans, counters and int8 scales after every step equal
    the JAX fused engine's."""
    snap = _check_engines(models, trace, megakernel_scope=scope,
                          **_KNOBS[knobs])
    if trace == "starved_pool":
        assert snap["preemptions"] >= 1
    if trace == "prefix_fork":
        assert snap["prefix_cache_hits"] >= 1


@pytest.mark.parametrize("knobs", sorted(_KNOBS))
@pytest.mark.parametrize("trace", ["mixed", "starved_pool", "prefix_fork"])
def test_fused_engine_with_bursts_matches_jax(models, trace, knobs):
    """``burst_tokens=4`` at model scope: ragged steps through the fused
    layer, bursts through the decode megakernel's plain body."""
    snap = _check_engines(models, trace, megakernel_scope="model",
                          burst_tokens=4, **_KNOBS[knobs])
    assert snap["burst_launches"] >= 1


def test_int4_engine_reports_unfused_like_jax(models):
    jm, tm = models
    kw = dict(max_len=64, page_size=4, prefill_megakernel="fused",
              quantized_mode="weight_only_int4")
    jsnap = JaxEngine(jm, **kw).metrics_snapshot()
    tsnap = pt.LLMEngine(tm, device="cpu", **kw).metrics_snapshot()
    for k in ("prefill_megakernel", "prefill_megakernel_mode"):
        assert tsnap[k] == jsnap[k], k
    assert (tsnap["prefill_megakernel"], tsnap["prefill_megakernel_mode"]) \
        == ("unfused", None)
    unfused = pt.LLMEngine(tm, device="cpu", max_len=64, page_size=4)
    assert unfused.metrics_snapshot()["prefill_megakernel_mode"] is None
