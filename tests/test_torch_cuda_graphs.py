"""paddle_tpu_torch's CUDA-graph capture on the card: each owner's
captured step against the same step run eagerly
(``jit.enable_to_static(False)``), on the same weights and inputs.

Every test here needs an NVIDIA card (``cuda`` marker) and skips
without one. The file imports neither JAX nor ``paddle_tpu``:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda_graphs.py

A replay runs the same kernels in the same order as the eager step, so
every comparison is bitwise: losses, parameters and AdamW moments after
5 ``TrainStep``s; tokens, pool pages and scales after an engine's run.
The kernels' launch counts read the same in both modes.
"""
import contextlib
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
from paddle_tpu_torch import jit
from paddle_tpu_torch.kernels import LAUNCHES, reset_launch_counts
from paddle_tpu_torch.models import generation as tgen


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a CUDA graph has no CPU mode")
    return torch.device("cuda")


@contextlib.contextmanager
def _eager():
    jit.enable_to_static(False)
    try:
        yield
    finally:
        jit.enable_to_static(True)


# ---------------------------------------------------------------------------
# TrainStep
# ---------------------------------------------------------------------------

TRAIN_CFG = dict(num_hidden_layers=2, hidden_size=256, intermediate_size=512,
                 num_attention_heads=4, num_key_value_heads=2, vocab_size=256,
                 loss_chunk_size=64)


def _train(dev, *, amp, remat, K, steps=5):
    cfg = pt.llama_tiny_config(**TRAIN_CFG, remat=remat)
    model = pt.LlamaForCausalLM(cfg, device="cpu",
                                generator=torch.Generator().manual_seed(1))
    model.to(dev)
    opt = pt.AdamW(learning_rate=1e-3, parameters=model.parameters())

    def loss_fn(x):
        ctx = pt.auto_cast(level="O1", dtype="bfloat16") if amp \
            else contextlib.nullcontext()
        with ctx:
            return model(x, labels=x)[1]

    step = pt.TrainStep(model, loss_fn, opt, accumulate_steps=K)
    rng = np.random.RandomState(2)
    batches = [torch.from_numpy(rng.randint(0, cfg.vocab_size, (4, 64)))
               .to(dev) for _ in range(steps)]
    reset_launch_counts()
    losses = [step(x) for x in batches]
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    state = {k: v.detach().clone() for k, v in model.named_parameters()}
    views = opt._fused_engine.state_views()
    for i, p in enumerate(model.parameters()):
        for name in ("moment1", "moment2"):
            state[f"p{i}.{name}"] = views[(p, name)].clone()
    return [x.item() for x in losses], state, launches, step


@pytest.mark.cuda
@pytest.mark.parametrize("amp,remat,K", [(False, False, 1), (True, True, 2)],
                         ids=["f32", "bf16_o1_remat_k2"])
def test_train_step_captured_matches_eager_bitwise(cuda, amp, remat, K):
    with _eager():
        want = _train(cuda, amp=amp, remat=remat, K=K)
    got = _train(cuda, amp=amp, remat=remat, K=K)
    assert got[0] == want[0]
    for k in want[1]:
        assert torch.equal(got[1][k], want[1][k]), k
    assert got[2] == want[2]
    step = got[3]
    assert len(step.graphs.keys) == 1
    assert step.graphs.calls == {"eager": 0, "warmup": 1, "capture": 1,
                                 "replay": 4}
    assert want[3].graphs.calls["eager"] == 5
    assert step.last_compile_ms > 0 and step.compile_ms_total > 0
    assert step.graphs.pool_bytes() > 0


@pytest.mark.cuda
def test_train_step_new_shape_captures_a_second_graph(cuda):
    """A batch of another shape is another key: its own warm-up and its
    own graph, beside the first."""
    cfg = pt.llama_tiny_config(**TRAIN_CFG)
    model = pt.LlamaForCausalLM(cfg, device=cuda,
                                generator=torch.Generator(cuda).manual_seed(1))
    opt = pt.AdamW(learning_rate=1e-3, parameters=model.parameters())
    step = pt.TrainStep(model, lambda x: model(x, labels=x)[1], opt)
    a = torch.randint(0, 256, (2, 32), device=cuda)
    b = torch.randint(0, 256, (2, 48), device=cuda)
    for x in (a, a, b, b, a):
        step(x)
    assert step.graphs.calls["capture"] == 2
    assert len(step.graphs.capture_ms()) == 2
    assert opt._step_count == 5


@pytest.mark.cuda
def test_item_inside_train_step_raises(cuda):
    cfg = pt.llama_tiny_config(**TRAIN_CFG)
    model = pt.LlamaForCausalLM(cfg, device=cuda,
                                generator=torch.Generator(cuda).manual_seed(1))
    opt = pt.AdamW(learning_rate=1e-3, parameters=model.parameters())

    def loss_fn(x):
        loss = model(x, labels=x)[1]
        if loss.item() > 1e9:            # a host read of a device value
            raise AssertionError
        return loss

    step = pt.TrainStep(model, loss_fn, opt)
    x = torch.randint(0, 256, (2, 32), device=cuda)
    step(x)                              # the warm-up runs eagerly
    with pytest.raises(jit.CaptureError, match="TrainStep"):
        step(x)
    # the card, its random generator included, works after the failure
    assert torch.randn(4, device=cuda).isfinite().all()


# ---------------------------------------------------------------------------
# to_static
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_to_static_function_replays_and_counts_launches(cuda):
    w = torch.randn(64, 64, device=cuda)

    @jit.to_static
    def f(x, scale):
        return torch.relu(x @ w) * scale

    xs = [torch.randn(8, 64, device=cuda) for _ in range(4)]
    outs = [f(x, 2.0) for x in xs]
    kept = outs[1].clone()
    for x, o in zip(xs, outs):
        assert torch.equal(o, torch.relu(x @ w) * 2.0)
    assert torch.equal(outs[1], kept)    # later replays left it alone
    assert f._graphs.calls["capture"] == 1
    f(torch.randn(3, 64, device=cuda), 2.0)
    f(torch.randn(3, 64, device=cuda), 2.0)
    assert f._graphs.calls["capture"] == 2


@pytest.mark.cuda
def test_to_static_item_warns_once_and_runs_eagerly(cuda):
    @jit.to_static
    def f(x):
        return x * float(x.sum().item())

    x = torch.randn(16, device=cuda)
    want = x * float(x.sum().item())
    assert torch.equal(f(x), want)                   # the warm-up
    with pytest.warns(UserWarning, match="eagerly"):
        assert torch.equal(f(x), want)               # the graph break
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert torch.equal(f(x), want)               # eager, no warning
    assert len(f._graph_broken) == 1
    # the card, its random generator included, works after the failure
    assert torch.randn(4, device=cuda).isfinite().all()
    g = jit.to_static(lambda y: y + torch.rand_like(y))
    for _ in range(3):
        assert ((g(x) - x) < 1).all()


# ---------------------------------------------------------------------------
# LLMEngine: the ragged step and the bursts
# ---------------------------------------------------------------------------

ENGINE_KNOBS = {
    "fp": {},
    "w8_kv8": dict(quantized_mode="weight_only_int8", kv_cache_dtype="int8"),
    "w4_kv8": dict(quantized_mode="weight_only_int4", kv_cache_dtype="int8"),
    "w8": dict(quantized_mode="weight_only_int8"),
    "fused_layer": dict(prefill_megakernel="fused", megakernel_scope="layer"),
    "fused_model": dict(prefill_megakernel="fused", megakernel_scope="model"),
    "fused_w8_kv8": dict(prefill_megakernel="fused",
                         quantized_mode="weight_only_int8",
                         kv_cache_dtype="int8"),
    "burst_layer": dict(burst_tokens=4, megakernel_scope="layer"),
    "burst_model": dict(burst_tokens=4, megakernel_scope="model"),
    "burst_w8_kv8_model": dict(burst_tokens=4, megakernel_scope="model",
                               quantized_mode="weight_only_int8",
                               kv_cache_dtype="int8"),
    "burst_w8_kv8_layer": dict(burst_tokens=4, megakernel_scope="layer",
                               quantized_mode="weight_only_int8",
                               kv_cache_dtype="int8"),
}


def _serve(model, dev, knobs):
    cfg = model.config
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size, (n,)).tolist()
               for n in (3, 17, 40, 9)]
    eng = pt.LLMEngine(model, max_len=96, page_size=16, max_num_seqs=4,
                       chunk_size=16, device=dev, **knobs)
    rids = [eng.add_request(p, max_new_tokens=9,
                            **(dict(temperature=0.8, top_k=20, seed=7 + i)
                               if i % 2 else {}))
            for i, p in enumerate(prompts)]
    reset_launch_counts()
    outs = eng.run(max_steps=300)
    torch.cuda.synchronize()
    assert eng.pool.check_invariants()
    pools = [t.clone() for pair in eng.pool.kv for t in pair]
    if eng.pool.quantized:
        pools += [t.clone() for pair in eng.pool.kv_scales for t in pair]
    return [outs[r].token_ids for r in rids], pools, dict(LAUNCHES), eng


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(ENGINE_KNOBS))
def test_engine_captured_matches_eager_bitwise(cuda, name):
    """Tokens (two of four requests sampled), every pool page and scale
    and the launch counts of a small f32 Llama's run: the captured
    engine equals the eager one."""
    cfg = pt.llama_tiny_config(num_hidden_layers=2, num_key_value_heads=2)
    model = pt.LlamaForCausalLM(cfg, device="cpu",
                                generator=torch.Generator().manual_seed(0))
    knobs = ENGINE_KNOBS[name]
    with _eager():
        want = _serve(model, cuda, knobs)
    got = _serve(model, cuda, knobs)
    assert got[0] == want[0]
    assert all(torch.equal(a, b) for a, b in zip(got[1], want[1]))
    assert got[2] == want[2]
    calls = got[3].graphs.calls
    assert calls["eager"] == 0 and calls["replay"] > 0
    assert calls["warmup"] == len(got[3].graphs.keys)
    if "burst_tokens" in knobs:
        assert any(k[0] == "burst" for k in got[3].graphs.keys)


@pytest.mark.cuda
def test_drawn_sampler_matches_sample_rows_on_the_card(cuda):
    gen = torch.Generator(cuda).manual_seed(3)
    R, V = 8, 1000
    logits = torch.randn(R, V, device=cuda, generator=gen)
    temps = torch.tensor([0, .8, 0, 1.2, .5, 0, 1., .7], device=cuda)
    top_ks = torch.tensor([0, 20, 0, 0, 5, 0, 50, 0], device=cuda,
                          dtype=torch.int32)
    top_ps = torch.tensor([1, 1, 1, .9, 1, 1, .8, 1.], device=cuda)
    hot = [i for i in range(R) if temps[i] > 0]
    seeds, pos = list(range(10, 10 + R)), list(range(R))
    want = tgen.sample_rows(logits, temps, top_ks, top_ps, 4, seeds, pos, 2)
    u = torch.zeros(R, V, device=cuda)
    tgen.draw_uniforms(u, 4, seeds, pos, 2, hot)
    got = tgen.sample_rows_drawn(logits, temps, top_ks, top_ps, u)
    assert torch.equal(got, want)
