"""paddle_tpu_torch's serving stack against ``paddle_tpu.serving``.

The same request traces go through the JAX ``LLMEngine`` (its ragged
kernel in interpret mode on the CPU) and the port's
``LLMEngine(device="cpu")`` holding the same weights. Greedy tokens must
be identical, and so must the scheduler's step plans, step for step.
Sampled rows are not compared across frameworks (JAX's ``fold_in``
streams have no torch counterpart); the port is held to the reference's
invariant instead: a request's draws do not depend on its batch.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.core.flags import GLOBAL_FLAGS as JAX_FLAGS
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import generation as jgen
from paddle_tpu.models import llama_tiny_config as jax_tiny_config
from paddle_tpu.serving import LLMEngine as JaxEngine
from paddle_tpu.serving import kv_cache as jkv
from paddle_tpu.serving import spec_decode as jsd
from paddle_tpu.serving.tracing import FlightRecorder as JaxFlightRecorder
import paddle_tpu_torch as pt
from paddle_tpu_torch.core.flags import GLOBAL_FLAGS
from paddle_tpu_torch.kernels import LAUNCHES, reset_launch_counts
from paddle_tpu_torch.models import generation as tgen
from paddle_tpu_torch.serving import kv_cache as tkv
from paddle_tpu_torch.serving import spec_decode as tsd
from paddle_tpu_torch.serving.tracing import FlightRecorder

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


def _drive(engine, arrivals, max_steps=500):
    """Run ``engine`` over a trace: ``arrivals[i]`` lists the
    ``(prompt, kwargs)`` added just before step ``i``. Returns the
    request ids, their tokens, the scheduler's step plans (rows as
    ``(id, q_start, q_len)`` plus the ids preempted while planning),
    the finish reasons and the metrics snapshot."""
    plans = []
    orig = engine.scheduler.prepare_step

    def prepare_step():
        plan = orig()
        rows = None if plan is None else \
            [(s.seq_id, qs, ql) for s, qs, ql in plan.rows]
        plans.append((rows, [s.seq_id for s in
                             engine.scheduler.last_preempted]))
        return plan

    engine.scheduler.prepare_step = prepare_step
    rids, step = [], 0
    last = max(arrivals)
    while step <= last or engine.has_unfinished():
        for prompt, kw in arrivals.get(step, []):
            rids.append(engine.add_request(prompt, **kw))
        engine.step()
        step += 1
        assert step < max_steps, "the trace did not drain"
    outs = engine.outputs()
    return (rids, [outs[r].token_ids for r in rids], plans,
            [outs[r].finish_reason for r in rids],
            engine.metrics_snapshot())


def _both(models, arrivals, **engine_kw):
    jm, tm = models
    j = _drive(JaxEngine(jm, **engine_kw), arrivals)
    t = _drive(pt.LLMEngine(tm, device="cpu", **engine_kw), arrivals)
    return j, t


_COUNTERS = ("requests_added", "tokens_generated", "prefills",
             "prefill_chunks", "decode_steps", "preemptions", "cow_copies",
             "prefix_cache_hits", "prefix_cache_misses", "finished_requests",
             "host_dispatches", "prefill_launches")


def _traces():
    mixed = _prompts([3, 9, 17, 30, 41, 5, 22, 12], seed=0)
    starved = _prompts([6, 7, 9, 11], seed=1)
    prefix = _prompts([12], seed=34)[0]
    tails = _prompts([2, 3], seed=35)
    same = _prompts([18], seed=33)[0]
    return {
        # 8 mixed-length requests, several prompts chunked over steps
        "mixed": (
            {0: [(p, dict(max_new_tokens=6)) for p in mixed]},
            dict(max_len=64, page_size=4, max_num_seqs=4, chunk_size=16)),
        # 8 usable pages cannot hold four 5-page requests: preemption
        "starved_pool": (
            {0: [(p, dict(max_new_tokens=8)) for p in starved]},
            dict(max_len=32, page_size=4, num_pages=9)),
        # an identical prompt forks the donor's partial tail page and
        # copy-on-writes it; a shared-prefix prompt forks the full pages
        "prefix_fork": (
            {0: [(same, dict(max_new_tokens=10))],
             1: [(same, dict(max_new_tokens=5)),
                 (same[:16] + tails[0], dict(max_new_tokens=5))]},
            dict(max_len=64, page_size=8, max_num_seqs=4, chunk_size=32)),
        # forks, then a pool too small for them: preemption of forks
        "fork_under_pressure": (
            {0: [(prefix, dict(max_new_tokens=8))],
             1: [(prefix + t, dict(max_new_tokens=8)) for t in tails]},
            dict(max_len=32, page_size=4, num_pages=9, max_num_seqs=3,
                 chunk_size=16, high_watermark=1.0)),
    }


@pytest.mark.parametrize("trace", ["mixed", "starved_pool", "prefix_fork",
                                   "fork_under_pressure"])
def test_greedy_tokens_and_step_plans_match_jax(models, trace):
    arrivals, kw = _traces()[trace]
    j, t = _both(models, arrivals, **kw)
    (jr, jtok, jplans, jwhy, jsnap), (tr, ttok, tplans, twhy, tsnap) = j, t
    assert tr == jr
    assert ttok == jtok
    assert twhy == jwhy == ["length"] * len(jr)
    assert tplans == jplans
    for c in _COUNTERS:
        assert tsnap[c] == jsnap[c], c
    if trace in ("starved_pool", "fork_under_pressure"):
        assert tsnap["preemptions"] >= 1
    if trace in ("prefix_fork", "fork_under_pressure"):
        assert tsnap["prefix_cache_hits"] >= 1
    if trace == "prefix_fork":
        assert tsnap["cow_copies"] >= 1


def test_eos_finish_matches_jax(models):
    prompts = _prompts([5, 9, 14], seed=2)
    # run once to learn a token the first request emits mid-way
    _, toks, _, _, _ = _drive(
        pt.LLMEngine(models[1], device="cpu", max_len=64, page_size=4),
        {0: [(p, dict(max_new_tokens=8)) for p in prompts]})
    eos = toks[0][3]
    arrivals = {0: [(p, dict(max_new_tokens=8, eos_token_id=eos))
                    for p in prompts]}
    j, t = _both(models, arrivals, max_len=64, page_size=4)
    assert t[1] == j[1]
    assert t[3] == j[3]
    assert t[3][0] == "eos" and t[1][0][-1] == eos
    assert len(t[1][0]) <= 4


def _engine(models, **kw):
    kw.setdefault("max_len", 64)
    kw.setdefault("page_size", 4)
    return pt.LLMEngine(models[1], device="cpu", **kw)


def test_sampled_request_does_not_depend_on_its_batch(models):
    """Alone, co-scheduled with others, and under preemption, a sampled
    request draws the same tokens: each draw is a pure function of
    (engine seed, request seed, generation position, tag)."""
    target = _prompts([10], seed=3)[0]
    others = _prompts([7, 13, 5], seed=4)
    knobs = dict(max_new_tokens=8, temperature=0.8, top_k=20, seed=11)

    def run(arrivals, **kw):
        rids, toks, _, _, snap = _drive(_engine(models, **kw), arrivals)
        return toks[rids.index("target")], snap

    alone, _ = run({0: [(target, dict(request_id="target", **knobs))]})
    busy, _ = run({0: [(others[0], dict(max_new_tokens=8)),
                       (others[1], dict(max_new_tokens=8, temperature=1.0,
                                        seed=3))],
                   2: [(target, dict(request_id="target", **knobs)),
                       (others[2], dict(max_new_tokens=8))]})
    starved, snap = run({0: [(p, dict(max_new_tokens=8)) for p in others]
                         + [(target, dict(request_id="target", **knobs))]},
                        max_len=32, num_pages=9)
    assert snap["preemptions"] >= 1
    assert alone == busy == starved
    assert len(alone) == 8
    reseeded, _ = run({0: [(target, dict(request_id="target",
                                         **{**knobs, "seed": 12}))]})
    assert reseeded != alone


def test_engine_on_cpu_counts_no_kernel_launches(models):
    reset_launch_counts()
    eng = _engine(models)
    eng.add_request(_prompts([9], seed=5)[0], max_new_tokens=3)
    eng.run(max_steps=50)
    assert LAUNCHES["ragged_paged_attention"] == 0
    assert eng.pool.check_invariants()
    assert eng.pool.free_pages == eng.pool.capacity


@pytest.mark.parametrize("knob,item", [
    (dict(burst_tokens=4, quantized_mode="weight_only_int4"),
     "int4 weights in decode bursts"),
    (dict(draft_model=object(), spec_tokens=2), "speculative decoding"),
    (dict(mesh=object()), "tensor-parallel"),
    (dict(host_kv_pages=8), "kv_tier"),
    (dict(adapter_slots=2), "tenancy"),
    (dict(tracer=object()), "RequestTracer"),
    (dict(burst_tokens=2, megakernel_scope="model",
          quantized_mode="weight_only_int4", kv_cache_dtype="int8"),
     "int4 weights in decode bursts"),
])
def test_other_paths_raise_naming_their_roadmap_item(models, knob, item):
    with pytest.raises(NotImplementedError, match=item):
        _engine(models, **knob)


def test_spec_tokens_without_a_draft_model_serve_with_speculation_off(
        models):
    """As the reference (engine.py:296-304): no draft model means no
    speculation, whatever ``spec_tokens`` says; a negative one raises.
    Greedy tokens and step plans equal the reference engine's with the
    same knob and the port's with ``spec_tokens=0``."""
    jm, _ = models
    arrivals = {0: [(p, dict(max_new_tokens=5))
                    for p in _prompts([5, 11, 3], seed=21)]}
    kw = dict(max_len=64, page_size=4, max_num_seqs=4, chunk_size=8)
    j, t = _both(models, arrivals, spec_tokens=2, **kw)
    off = _drive(pt.LLMEngine(models[1], device="cpu", spec_tokens=0, **kw),
                 arrivals)
    assert t[1] == j[1] == off[1] and t[2] == j[2] == off[2]
    assert all(len(x) == 5 for x in t[1])
    with pytest.raises(ValueError, match="spec_tokens"):
        JaxEngine(jm, max_len=64, page_size=4, spec_tokens=-1)
    with pytest.raises(ValueError, match="spec_tokens"):
        _engine(models, spec_tokens=-1)


def test_unknown_quantized_mode_raises_like_the_reference(models):
    jm, tm = models
    with pytest.raises(ValueError, match="unknown quantized mode"):
        JaxEngine(jm, max_len=64, page_size=4, quantized_mode="int8")
    with pytest.raises(ValueError, match="unknown quantized mode"):
        _engine(models, quantized_mode="int8")


#: the low-bit knob sets held against the reference
_LOW_BIT = {
    "w8": dict(quantized_mode="weight_only_int8"),
    "w4": dict(quantized_mode="weight_only_int4"),
    "w8_kv8": dict(quantized_mode="weight_only_int8", kv_cache_dtype="int8"),
}


def _record_scales(engine, to_numpy):
    """After every step, the int8 pool's scales as numpy (a list that
    grows as the engine steps)."""
    seen = []
    orig = engine.step

    def step():
        out = orig()
        if engine.pool.kv_scales is not None:
            seen.append([to_numpy(a) for pair in engine.pool.kv_scales
                         for a in pair])
        return out

    engine.step = step
    return seen


@pytest.mark.parametrize("knobs", sorted(_LOW_BIT))
@pytest.mark.parametrize("trace", ["mixed", "starved_pool", "prefix_fork"])
def test_low_bit_engine_matches_jax(models, trace, knobs):
    """Quantized weights (int8 or int4 projections) and an int8 pool:
    greedy tokens and step plans equal the reference's, and the pool's
    per-(head, page) scales agree to 1e-5 relative after every step
    (both quantize the same K/V, computed in f32 in another order)."""
    jm, tm = models
    arrivals, kw = _traces()[trace]
    kw = dict(kw, **_LOW_BIT[knobs])
    jeng, teng = JaxEngine(jm, **kw), pt.LLMEngine(tm, device="cpu", **kw)
    jscales = _record_scales(jeng, np.asarray)
    tscales = _record_scales(teng, lambda a: a.numpy().copy())
    (jr, jtok, jplans, jwhy, jsnap) = _drive(jeng, arrivals)
    (tr, ttok, tplans, twhy, tsnap) = _drive(teng, arrivals)
    assert tr == jr and ttok == jtok and tplans == jplans
    assert twhy == jwhy == ["length"] * len(jr)
    for c in _COUNTERS:
        assert tsnap[c] == jsnap[c], c
    assert len(tscales) == len(jscales)
    assert bool(tscales) == ("kv_cache_dtype" in kw)
    for t_step, j_step in zip(tscales, jscales):
        for a, b in zip(t_step, j_step):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=0)
    assert any(a.any() for step in tscales for a in step) or not tscales
    if trace == "prefix_fork":
        assert tsnap["prefix_cache_hits"] >= 1
    assert teng.pool.check_invariants()


def test_low_bit_engine_byte_accounting_matches_jax(models):
    from paddle_tpu.quantization import params_weight_bytes
    jm, tm = models
    for mode in ("weight_only_int8", "weight_only_int4"):
        kw = dict(max_len=64, page_size=4, quantized_mode=mode,
                  kv_cache_dtype="int8")
        jeng, teng = JaxEngine(jm, **kw), pt.LLMEngine(tm, device="cpu",
                                                        **kw)
        snap = teng.metrics_snapshot()
        assert snap["weight_bytes"] == params_weight_bytes(jeng.params)
        assert snap["kv_bytes_per_token"] == jeng.pool.kv_bytes_per_token
        assert snap["kv_hbm_bytes"] == jeng.pool.pool_bytes
        assert teng.pool.dtype == torch.int8


def test_int8_pool_shares_full_pages_only(models):
    """An int8 pool's prefix fork maps only FULL pages (an append
    requantizes its page in place), as the reference's does."""
    same = _prompts([18], seed=33)[0]
    arrivals = {0: [(same, dict(max_new_tokens=4))],
                1: [(same, dict(max_new_tokens=4))]}
    for kv in (None, "int8"):
        eng = _engine(models, page_size=8, kv_cache_dtype=kv)
        forks = []
        orig = eng.pool.fork

        def fork(seq_id, parent_id, num_tokens=None, _orig=orig):
            forks.append(num_tokens)
            return _orig(seq_id, parent_id, num_tokens)

        eng.pool.fork = fork
        _drive(eng, arrivals)
        assert forks == ([16] if kv else [17])


def test_request_lifecycle_matches_jax(models):
    """Admission rejection, outputs(), release() and cancel() behave as
    the reference's."""
    jm, tm = models
    engines = [JaxEngine(jm, max_len=32, page_size=4),
               pt.LLMEngine(tm, device="cpu", max_len=32, page_size=4)]
    for eng in engines:
        with pytest.raises(ValueError) as err:
            eng.add_request(list(range(30)), max_new_tokens=8,
                            request_id="big")
        assert err.value.reason == "rejected_oversize"
        assert eng.outputs()["big"].finish_reason == "rejected_oversize"
        rid = eng.add_request([1, 2, 3], max_new_tokens=2)
        gone = eng.add_request([4, 5, 6], max_new_tokens=2)
        with pytest.raises(ValueError, match="still"):
            eng.release(rid)
        assert eng.cancel(gone)
        eng.run(max_steps=50)
        out = eng.release(rid)
        assert out.finished and len(out.token_ids) == 2
        assert rid not in eng.outputs()
        assert eng.outputs()[gone].status == "cancelled"
        with pytest.raises(KeyError):
            eng.release(rid)


def test_engine_without_device_raises_when_no_cuda(models, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for knobs in ({}, *_LOW_BIT.values()):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            pt.LLMEngine(models[1], **knobs)


# ---------------------------------------------------------------------------
# the pieces under the engine
# ---------------------------------------------------------------------------

def test_ragged_packing_matches_jax():
    qs = np.asarray([0, 8, 16, 40, 40], np.int32)
    ql = np.asarray([3, 8, 5, 0, 0], np.int32)
    tr, tl = tsd._ragged_packing(torch.from_numpy(qs), torch.from_numpy(ql),
                                 40)
    jr, jl = jsd._ragged_packing(jnp.asarray(qs), jnp.asarray(ql), 40)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))


def test_ragged_fp_layer_matches_jax(models):
    """One layer body on a mixed packed step: the new hidden state and
    the K/V it writes into the pool match, and dead tokens touch only
    the null page."""
    jm, tm = models
    cfg = tm.config
    ps, pps, npages, qb, T = 4, 4, 12, 4, 16
    rng = np.random.RandomState(6)
    # row 0: a 6-token first chunk; row 1: a decode at position 9 whose
    # earlier K/V is already in the pool; row 2: padding
    qs = np.asarray([0, 8, T], np.int32)
    ql = np.asarray([6, 1, 0], np.int32)
    kl = np.asarray([6, 10, 0], np.int32)
    tbls = np.asarray([[3, 5, 0, 0], [7, 2, 9, 0], [0, 0, 0, 0]], np.int32)
    pos = np.zeros(T, np.int32)
    pos[:6] = np.arange(6)
    pos[8] = 9
    h = rng.randn(1, T, cfg.hidden_size).astype(np.float32)
    kp = rng.randn(2, npages, ps, cfg.head_dim).astype(np.float32)
    vp = rng.randn(2, npages, ps, cfg.head_dim).astype(np.float32)
    jlyr = jgen.extract_params(jm)["layers"][0]
    tlyr = tgen.extract_params(tm)["layers"][0]
    jtr, jlive = jsd._ragged_packing(jnp.asarray(qs), jnp.asarray(ql), T)
    jh, jK, jV = jsd._ragged_fp_layer(
        jlyr, jnp.asarray(h), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(pos), jnp.asarray(tbls), jtr, jlive, jnp.asarray(qs),
        jnp.asarray(ql), jnp.asarray(kl), jm.config, ps, pps, qb, True)
    t = [torch.from_numpy(a.copy()) for a in (pos, tbls, qs, ql, kl)]
    tK, tV = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    ttr, tlive = tsd._ragged_packing(t[2], t[3], T)
    th = tsd._ragged_fp_layer(tlyr, torch.from_numpy(h), tK, tV, t[0], t[1],
                              ttr, tlive, t[2], t[3], t[4], cfg, ps, pps, qb)
    live = np.zeros(T, bool)
    live[:6] = live[8] = True
    np.testing.assert_allclose(th[0, live].numpy(), np.asarray(jh)[0, live],
                               rtol=1e-5, atol=1e-5)
    keep = np.ones(npages, bool)
    keep[0] = False                 # the null page takes dead tokens' K/V
    np.testing.assert_allclose(tK[:, keep].numpy(), np.asarray(jK)[:, keep],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tV[:, keep].numpy(), np.asarray(jV)[:, keep],
                               rtol=1e-5, atol=1e-6)
    written = np.abs(tK.numpy() - kp).sum(axis=(0, 2, 3)) > 0
    assert written[[3, 5, 9]].all() and not written[[1, 2, 4, 6, 7, 8]].any()


def test_speculative_sample_k0_is_one_direct_draw():
    rng = np.random.RandomState(8)
    logits = torch.from_numpy(rng.randn(3, 1, 30).astype(np.float32))
    temps = torch.tensor([0.0, 0.9, 0.0])
    top_ks = torch.tensor([0, 7, 0], dtype=torch.int32)
    top_ps = torch.ones(3)
    out, n = tsd.speculative_sample(logits, None, None, [0, 0, 0], temps,
                                    top_ks, top_ps, 4, [1, 2, 3], [0, 5, 9])
    want = tgen.sample_rows(logits[:, 0], temps, top_ks, top_ps, 4,
                            [1, 2, 3], [0, 5, 9], tsd.FINAL_TAG)
    assert torch.equal(out[:, 0], want) and n.tolist() == [1, 1, 1]
    assert (tsd.DRAFT_TAG, tsd.ACCEPT_TAG, tsd.FINAL_TAG) == \
        (jsd.DRAFT_TAG, jsd.ACCEPT_TAG, jsd.FINAL_TAG)
    with pytest.raises(NotImplementedError, match="draft model"):
        tsd.speculative_sample(logits, None, None, [1, 0, 0], temps, top_ks,
                               top_ps, 4, [1, 2, 3], [0, 5, 9])


def _pool_ops(mod, **kw):
    """One op script on a pool of ``mod``: allocate, fork, CoW append,
    pin, free, with the data of one page set to tell copies apart."""
    pool = mod.PagedKVPool(1, 2, 4, num_pages=10, page_size=4,
                           pinned_page_budget=2, **kw)
    log = []
    pool.allocate("a", 6)
    pool.prepare_append("a", 6)
    log.append(pool.block_table("a"))
    pool.fork("b", "a", num_tokens=6)          # shares the partial page
    log.append([pool.page_refcount(p) for p in range(10)])
    log.append(pool.prepare_append("b", 8))    # CoW of the tail page
    log.append((pool.block_table("a"), pool.block_table("b"),
                pool.cow_copies))
    log.append(pool.pin(("chain",), "a", 4))
    pool.free("a")
    log.append((pool.used_pages, pool.pinned_pages, pool.evictable_pages))
    pool.fork_pinned("c", ("chain",), 4)
    pool.prepare_append("c", 9)
    log.append((pool.block_table("c"), pool.free_pages,
                pool.shared_page_fraction))
    pool.check_invariants()
    pool.free("b")
    pool.free("c")
    pool.unpin(("chain",))
    log.append((pool.free_pages, pool.capacity, pool.page_bytes))
    return pool, log


def test_pool_bookkeeping_matches_jax():
    _, jlog = _pool_ops(jkv)
    _, tlog = _pool_ops(tkv, device="cpu")
    assert tlog == jlog


def test_pool_cow_copies_page_data_in_place():
    pool = tkv.PagedKVPool(2, 1, 2, num_pages=6, page_size=2)
    pool.allocate("a", 3)
    src = pool.block_table("a")[1]
    K0 = pool.kv[0][0]
    for li, (K, V) in enumerate(pool.kv):
        K[:, src] = 1.0 + li
        V[:, src] = -1.0 - li
    pool.fork("b", "a", num_tokens=3)
    assert pool.prepare_append("b", 4) == 1
    dst = pool.block_table("b")[1]
    assert dst != src and pool.kv[0][0] is K0       # same tensor, in place
    for li, (K, V) in enumerate(pool.kv):
        assert torch.equal(K[:, dst], K[:, src])
        assert torch.equal(V[:, dst], V[:, src])
    assert pool.check_invariants()


def test_pool_refuses_int8_and_checks_invariants():
    """The int8 pool's scales: zeros at first, reset when a page is
    recycled (and only then), copied with a copy-on-write page; a dtype
    the pool does not hold is refused; the audit catches a refcount
    drift."""
    with pytest.raises(ValueError, match="dtype"):
        tkv.PagedKVPool(1, 1, 4, num_pages=4, page_size=4,
                        dtype=torch.complex64)
    pool = tkv.PagedKVPool(2, 2, 4, num_pages=8, page_size=4,
                           dtype=torch.int8)
    assert pool.quantized and len(pool.kv_scales) == 2
    assert pool.kv[0][0].dtype == torch.int8
    assert all(s.shape == (2, 8) and s.dtype == torch.float32 and
               not s.any() for pair in pool.kv_scales for s in pair)
    pool.allocate("a", 6)
    pool.prepare_append("a", 6)
    a0, a1 = pool.block_table("a")
    for li, (Ks, Vs) in enumerate(pool.kv_scales):
        Ks[:, [a0, a1]] = 0.5 + li
        Vs[:, [a0, a1]] = 0.25 + li
    pool.kv[1][0][:, a1] = 7
    pool.fork("b", "a", num_tokens=6)
    assert pool.prepare_append("b", 7) == 1          # CoW of the tail page
    b1 = pool.block_table("b")[1]
    for li, (Ks, Vs) in enumerate(pool.kv_scales):
        assert torch.equal(Ks[:, b1], Ks[:, a1]) and \
            torch.equal(Vs[:, b1], Vs[:, a1])
    assert torch.equal(pool.kv[1][0][:, b1], pool.kv[1][0][:, a1])
    pool.free("a")           # page a0 is still b's: its scales stay
    for li, (Ks, Vs) in enumerate(pool.kv_scales):
        assert (Ks[:, a0] == 0.5 + li).all() and not Ks[:, a1].any()
        assert not Vs[:, a1].any()
    pool.free("b")
    assert not any(s.any() for pair in pool.kv_scales for s in pair)
    assert pool.check_invariants()
    pool = tkv.PagedKVPool(1, 1, 4, num_pages=4, page_size=4)
    assert pool.kv_scales is None and not pool.quantized
    assert tkv.NULL_PAGE == jkv.NULL_PAGE == 0
    pool.allocate("a", 5)
    pool._refcounts[pool.block_table("a")[0]] += 1
    with pytest.raises(tkv.InvariantViolation, match="refcount"):
        pool.check_invariants()


def test_flags_share_the_reference_names_and_defaults():
    names = ("decode_burst_tokens", "spec_decode_tokens",
             "decode_megakernel_scope", "prefill_megakernel")
    for n in names:
        assert n in GLOBAL_FLAGS, n
        assert GLOBAL_FLAGS.get(n) == JAX_FLAGS.get(n), n
    with pytest.raises(ValueError):
        GLOBAL_FLAGS.set("decode_burst_tokens", 0)
    assert GLOBAL_FLAGS.get("decode_burst_tokens") == 1


def test_flight_recorder_dumps_like_the_reference():
    dumps = []
    for cls in (JaxFlightRecorder, FlightRecorder):
        fr = cls(capacity=2)
        for i in range(3):
            fr.record("step", float(i), running=i)
        dumps.append(fr.dump("why", t=9.0, request="r"))
        assert len(fr) == 2
    assert dumps[0] == dumps[1]


def test_metrics_snapshot_keys_are_the_references(models):
    eng = _engine(models)
    eng.add_request([1, 2, 3], max_new_tokens=2)
    eng.run(max_steps=20)
    jeng = JaxEngine(models[0], max_len=64, page_size=4)
    jsnap = jeng.metrics_snapshot()
    snap = eng.metrics_snapshot()
    # the port reports where it runs and its low-bit byte accounting
    # (the reference's bench probe reads those off params and pool)
    assert set(snap) - set(jsnap) == {"device", "weight_bytes",
                                      "kv_bytes_per_token"}
    assert snap["device"] == "cpu"
    assert snap["finished_requests"] == 1 and snap["ttft_s_count"] == 1


# ---------------------------------------------------------------------------
# burst decode (the decode megakernel's path)
# ---------------------------------------------------------------------------

def _record_plans(engine):
    """Every planning call of the engine's scheduler, in order: bursts as
    ``("burst", [(id, cap)], burst_len, preempted)``, ragged steps as
    ``("step", [(id, q_start, q_len)], preempted)``; None plans too."""
    seen = []
    sch = engine.scheduler
    orig_burst, orig_step = sch.prepare_burst, sch.prepare_step

    def prepare_burst(n):
        plan = orig_burst(n)
        seen.append(("burst", None if plan is None else
                     ([(q.seq_id, c) for q, c in plan.rows], plan.burst_len),
                     [q.seq_id for q in sch.last_preempted]))
        return plan

    def prepare_step():
        plan = orig_step()
        seen.append(("step", None if plan is None else
                     [(q.seq_id, qs, ql) for q, qs, ql in plan.rows],
                     [q.seq_id for q in sch.last_preempted]))
        return plan

    sch.prepare_burst, sch.prepare_step = prepare_burst, prepare_step
    return seen


def _serve(engine, arrivals, max_steps=500):
    rids, step = [], 0
    last = max(arrivals)
    while step <= last or engine.has_unfinished():
        for prompt, kw in arrivals.get(step, []):
            rids.append(engine.add_request(prompt, **kw))
        engine.step()
        step += 1
        assert step < max_steps, "the trace did not drain"
    outs = engine.outputs()
    return (rids, [outs[r].token_ids for r in rids],
            [outs[r].finish_reason for r in rids], engine.metrics_snapshot())


#: the burst engines held against the reference: weights and pool
_BURST_KNOBS = {
    "fp": {},
    "w8": dict(quantized_mode="weight_only_int8"),
    "w8_kv8": dict(quantized_mode="weight_only_int8", kv_cache_dtype="int8"),
}


@pytest.mark.parametrize("knobs", sorted(_BURST_KNOBS))
@pytest.mark.parametrize("scope", ["layer", "model"])
@pytest.mark.parametrize("trace", ["mixed", "starved_pool", "prefix_fork"])
def test_burst_engine_matches_jax(models, trace, scope, knobs):
    """``burst_tokens=4`` at both scopes: greedy tokens, the plan of every
    step (burst or ragged, with its caps and preemptions), the counters
    and, with an int8 pool, its scales after every step equal the
    reference's."""
    jm, tm = models
    arrivals, kw = _traces()[trace]
    kw = dict(kw, burst_tokens=4, megakernel_scope=scope,
              **_BURST_KNOBS[knobs])
    jeng, teng = JaxEngine(jm, **kw), pt.LLMEngine(tm, device="cpu", **kw)
    jplans, tplans = _record_plans(jeng), _record_plans(teng)
    jscales = _record_scales(jeng, np.asarray)
    tscales = _record_scales(teng, lambda a: a.numpy().copy())
    jr, jtok, jwhy, jsnap = _serve(jeng, arrivals)
    tr, ttok, twhy, tsnap = _serve(teng, arrivals)
    assert tr == jr and ttok == jtok and tplans == jplans
    assert twhy == jwhy == ["length"] * len(jr)
    for c in _COUNTERS + ("burst_launches",):
        assert tsnap[c] == jsnap[c], c
    assert tsnap["burst_launches"] >= 1
    assert tsnap["host_dispatches"] < tsnap["tokens_generated"]
    assert (tsnap["burst_tokens"], tsnap["megakernel_scope"],
            tsnap["megakernel_mode"]) == (4, scope, "plain")
    assert len(tscales) == len(jscales)
    assert bool(tscales) == ("kv_cache_dtype" in kw)
    for t_step, j_step in zip(tscales, jscales):
        for a, b in zip(t_step, j_step):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=0)
    if trace == "starved_pool":
        assert tsnap["preemptions"] >= 1
    assert teng.pool.check_invariants()


def _burst_engine(models, burst, **kw):
    return _engine(models, burst_tokens=burst, **kw)


@pytest.mark.parametrize("scope", ["layer", "model"])
def test_bursts_and_per_token_serve_the_same_tokens(models, scope):
    """Greedy and sampled requests draw the same tokens in bursts as one
    token per step: a live row's generation position at burst iteration
    i is its position at the burst's start plus i, so its draws come from
    the same streams."""
    prompts = _prompts([5, 12, 9, 20], seed=40)
    arrivals = {0: [(p, dict(max_new_tokens=11, temperature=t, top_k=k,
                             seed=s))
                    for p, t, k, s in zip(prompts, (0.0, 0.9, 0.0, 1.3),
                                          (None, 20, None, 0),
                                          (1, 2, 3, 4))]}
    runs = {}
    for burst in (1, 4):
        runs[burst] = _serve(_burst_engine(models, burst,
                                           megakernel_scope=scope), arrivals)
    (r1, t1, w1, s1), (r4, t4, w4, s4) = runs[1], runs[4]
    assert t1 == t4 and w1 == w4 and r1 == r4
    assert all(len(t) == 11 for t in t4)
    assert s1["burst_launches"] == 0 and s4["burst_launches"] >= 2


@pytest.mark.parametrize("scope", ["layer", "model"])
def test_mid_burst_eos_finishes_one_row(models, scope):
    """A row that samples its EOS in the middle of a burst finishes there
    (its later iterations run masked and commit nothing); the others
    finish by length, with the per-token path's tokens."""
    prompts = _prompts([6, 10, 15], seed=41)
    _, toks, _, _ = _serve(_burst_engine(models, 1),
                           {0: [(p, dict(max_new_tokens=10))
                                for p in prompts]})
    eos = toks[1][5]
    assert eos not in toks[1][:5]
    arrivals = {0: [(p, dict(max_new_tokens=10,
                             eos_token_id=eos if i == 1 else None))
                    for i, p in enumerate(prompts)]}
    want = _serve(_burst_engine(models, 1), arrivals)
    eng = _burst_engine(models, 8, megakernel_scope=scope)
    plans = _record_plans(eng)
    got = _serve(eng, arrivals)
    assert got[1] == want[1] and got[2] == want[2]
    assert got[2][1] == "eos" and got[1][1] == toks[1][:6]
    assert got[2][0] == got[2][2] == "length"
    bursts = [p for p in plans if p[0] == "burst" and p[1] is not None]
    assert bursts and max(p[1][1] for p in bursts) == 8
    assert eng.pool.check_invariants()
    assert eng.pool.free_pages == eng.pool.capacity


def test_host_dispatches_count_one_per_burst(models):
    prompts = _prompts([4, 7], seed=42)
    eng = _burst_engine(models, 8)
    plans = _record_plans(eng)
    _, toks, _, snap = _serve(eng, {0: [(p, dict(max_new_tokens=17))
                                        for p in prompts]})
    bursts = sum(1 for p in plans if p[0] == "burst" and p[1] is not None)
    steps = sum(1 for p in plans if p[0] == "step" and p[1] is not None)
    assert snap["burst_launches"] == bursts >= 2
    assert snap["host_dispatches"] == bursts + steps
    assert snap["decode_steps"] == bursts + steps
    assert snap["tokens_generated"] == 34
    assert snap["host_dispatches_per_token"] < 0.25
    assert snap["ragged_pad_fraction"] == 0.0


def test_burst_aborts_a_row_whose_logits_go_nonfinite(models, monkeypatch):
    """A row whose logits turn NaN at any burst iteration commits none of
    the burst's tokens, is aborted, and its pool length rolls back; the
    other rows commit theirs."""
    from paddle_tpu_torch.serving import engine as teng
    prompts = _prompts([5, 8], seed=43)
    eng = _burst_engine(models, 4)
    real = teng._logits
    calls = {"n": 0}

    def poisoned(p, h, cfg):
        out = real(p, h, cfg)
        calls["n"] += 1
        if h.shape[0] == eng.max_num_seqs and calls["n"] == 3:
            out = out.clone()
            out[1] = float("nan")
        return out

    monkeypatch.setattr(teng, "_logits", poisoned)
    rids = [eng.add_request(p, max_new_tokens=8) for p in prompts]
    eng.step()                          # the prompts' ragged step
    calls["n"] = 0
    eng.step()                          # a burst of 4; row 1 poisoned
    outs = eng.outputs()
    assert outs[rids[1]].finish_reason == "nonfinite_logits"
    assert len(outs[rids[1]].token_ids) == 1
    assert len(outs[rids[0]].token_ids) == 5
    assert eng.metrics_snapshot()["nonfinite_rows"] == 1
    eng.run(max_steps=20)
    assert len(eng.outputs()[rids[0]].token_ids) == 8
    assert eng.pool.check_invariants()


def _per_row_sample(logits, temps, top_ks, top_ps, base_seed, seeds,
                    positions, tag):
    """Each sampling row alone: its generator's uniforms, the Gumbel-max
    of its masked log-probabilities; greedy rows the argmax."""
    tok = logits.argmax(-1)
    safe_t = torch.where(temps > 0, temps, torch.ones_like(temps))
    logp = torch.log_softmax(
        tgen._masked_logits(logits, safe_t, top_ks, top_ps), -1)
    for i in range(len(temps)):
        if temps[i] > 0:
            g = torch.Generator().manual_seed(tgen.stream_seed(
                base_seed, seeds[i], positions[i], tag))
            u = torch.rand(logits.shape[-1], generator=g)
            tok[i] = (logp[i] - torch.log(-torch.log(
                u.clamp_min(1e-20)))).argmax()
    return tok


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_drawn_sampler_matches_sample_rows(seed):
    """The burst's sampler with its uniforms drawn ahead of the graph
    (``draw_uniforms`` + ``sample_rows_drawn``) picks the same tokens as
    ``sample_rows`` and as each row sampled alone, for hot and greedy
    rows, at several request seeds and generation positions."""
    rng = np.random.RandomState(seed)
    R, V = 6, 50
    logits = torch.from_numpy(rng.randn(R, V).astype(np.float32))
    temps = torch.tensor([0.0, 0.7, 1.3, 0.0, 0.9, 0.5])
    top_ks = torch.tensor([0, 10, 0, 0, 3, 0], dtype=torch.int32)
    top_ps = torch.tensor([1.0, 1.0, 0.8, 1.0, 1.0, 0.95])
    hot = [i for i in range(R) if temps[i] > 0]
    for pos0 in (0, 7, 31):
        seeds = rng.randint(0, 2 ** 31, R).tolist()
        pos = [pos0 + i for i in range(R)]
        want = tgen.sample_rows(logits, temps, top_ks, top_ps, seed, seeds,
                                pos, tsd.FINAL_TAG)
        u = torch.full((R, V), 0.5)
        tgen.draw_uniforms(u, seed, seeds, pos, tsd.FINAL_TAG, hot)
        got = tgen.sample_rows_drawn(logits, temps, top_ks, top_ps, u)
        assert torch.equal(got, want)
        assert torch.equal(got, _per_row_sample(
            logits, temps, top_ks, top_ps, seed, seeds, pos, tsd.FINAL_TAG))
        assert torch.equal(got[[0, 3]], logits[[0, 3]].argmax(-1))


@pytest.mark.parametrize("trace", ["mixed", "starved_pool", "prefix_fork"])
def test_int8_pool_steps_keyed_by_append_bound_match_jax(models, trace):
    """An int8 pool's ragged step is keyed by its append plan's bound
    (the most pages a row appends into): one key per bound the trace
    needs, decode-only steps at 1. Greedy tokens and plans equal the
    reference's; after the run the pages are within 1 int8 step and the
    scales within 1e-6 relative."""
    jm, tm = models
    arrivals, kw = _traces()[trace]
    kw = dict(kw, kv_cache_dtype="int8")
    jeng, teng = JaxEngine(jm, **kw), pt.LLMEngine(tm, device="cpu", **kw)
    (jr, jtok, jplans, _, _) = _drive(jeng, arrivals)
    (tr, ttok, tplans, _, _) = _drive(teng, arrivals)
    assert tr == jr and ttok == jtok and tplans == jplans
    keys = teng.graphs.keys
    ps, chunk = teng.page_size, teng.chunk_size
    assert all(k[0] == "ragged" and 1 <= k[1] <= -(-chunk // ps) + 1
               for k in keys)
    assert ("ragged", 1, False) in keys and len(keys) >= 2
    assert teng.graphs.calls["eager"] == sum(p[0] is not None
                                             for p in tplans)
    for (jK, jV), (tK, tV) in zip(jeng.pool.kv, teng.pool.kv):
        for j, t in ((jK, tK), (jV, tV)):
            diff = np.abs(np.asarray(j).astype(np.int32)
                          - t.numpy().astype(np.int32))
            assert diff.max() <= 1
    for jpair, tpair in zip(jeng.pool.kv_scales, teng.pool.kv_scales):
        for j, t in zip(jpair, tpair):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6,
                                       atol=0)
