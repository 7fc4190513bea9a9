"""paddle_tpu_torch.jit against ``paddle_tpu.jit`` on the CPU.

The port's compiled step is a CUDA graph per key; on the CPU there is
nothing to capture, so these tests hold what the CPU can show: the
surface and its names, what ``to_static`` returns for a function and a
Layer, how many keys a call sequence makes (the reference's
``StaticFunction._cache``), ``TrainStep`` with the step scalars staged
from the host before each step (the replay-safe form) against
``paddle.jit.TrainStep`` + AdamW, and the recompute without RNG state
(which a capture needs) leaving losses and gradients bitwise unchanged.
The card tests of the capture itself are ``tests/test_torch_cuda_graphs.py``.

Tolerances: outputs of ``to_static`` ``rtol = 1e-6`` (one f32 matmul in
two frameworks); ``TrainStep`` those of ``tests/test_torch_train.py``
(losses ``rtol = 1e-5, atol = 1e-6``; parameters ``atol = 1e-6`` where
the first gradient is 0 or above 1e-4 in size, else ``2 lr`` per step).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import llama_tiny_config as jax_tiny_config
import paddle_tpu_torch as pt
from paddle_tpu_torch import jit
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.nn.functional import loss as tloss

TIGHT = dict(rtol=1e-5, atol=1e-6)
LR = 1e-3
TINY = dict(num_hidden_layers=2, hidden_size=64, intermediate_size=128,
            num_attention_heads=4, num_key_value_heads=2, vocab_size=128)

#: the reference's jit names the port keeps
NAMES = ["StaticFunction", "TrainStep", "enable_to_static", "ignore_module",
         "load", "not_to_static", "save", "set_code_level", "set_verbosity",
         "to_static"]


def _pair(seed=7, **extra):
    kw = dict(TINY, **extra)
    paddle.seed(seed)
    jm = JaxLlama(jax_tiny_config(**kw))
    tm = pt.LlamaForCausalLM(pt.llama_tiny_config(**kw), device="cpu")
    pt.load_numpy_state_dict(
        tm, {k: np.asarray(v) for k, v in jm.state_dict().items()})
    return jm, tm


@pytest.mark.parametrize("name", NAMES)
def test_jit_surface_names_match_the_reference(name):
    assert callable(getattr(paddle.jit, name))
    assert callable(getattr(jit, name))


def test_save_and_load_name_their_roadmap_item():
    for call in (lambda: jit.save(torch.nn.Linear(2, 2), "x"),
                 lambda: jit.load("x")):
        with pytest.raises(NotImplementedError, match="jit/save_load.py"):
            call()


def _jfn(x, scale):
    return paddle.tanh(x) * scale + x


def _tfn(x, scale):
    return torch.tanh(x) * scale + x


@pytest.mark.parametrize("form", ["bare", "called", "with_arguments"])
def test_to_static_on_a_function_matches_the_reference(form):
    if form == "bare":
        jf, tf = paddle.jit.to_static(_jfn), jit.to_static(_tfn)
    elif form == "called":
        jf, tf = paddle.jit.to_static()(_jfn), jit.to_static()(_tfn)
    else:
        jf = paddle.jit.to_static(input_spec=None, full_graph=True)(_jfn)
        tf = jit.to_static(input_spec=None, full_graph=True)(_tfn)
    assert isinstance(tf, jit.StaticFunction)
    assert isinstance(jf, paddle.jit.StaticFunction)
    x = np.random.RandomState(0).randn(3, 5).astype(np.float32)
    got = tf(torch.from_numpy(x), 0.5)
    want = np.asarray(jf(paddle.to_tensor(x), 0.5).numpy())
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    assert not got.requires_grad
    assert tf.__name__ == "_tfn"


def test_to_static_on_a_layer_matches_the_reference():
    rng = np.random.RandomState(1)
    w = rng.randn(6, 4).astype(np.float32)
    b = rng.randn(4).astype(np.float32)
    jl = paddle.nn.Linear(6, 4)
    jl.weight.set_value(w)
    jl.bias.set_value(b)
    tl = torch.nn.Linear(6, 4)
    with torch.no_grad():
        tl.weight.copy_(torch.from_numpy(w.T))
        tl.bias.copy_(torch.from_numpy(b))
    assert paddle.jit.to_static(jl) is jl and jit.to_static(tl) is tl
    assert isinstance(tl.forward, jit.StaticFunction)
    x = rng.randn(3, 6).astype(np.float32)
    got = tl(torch.from_numpy(x))
    want = np.asarray(jl(paddle.to_tensor(x)).numpy())
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-6,
                               atol=1e-6)


def test_key_count_matches_the_reference():
    """Shapes A, A, B, A, then a changed Python argument: as many keys in
    the port as executables in the reference's cache; a Layer's
    ``training`` flag is part of the key in both."""
    jf, tf = paddle.jit.to_static(_jfn), jit.to_static(_tfn)
    rng = np.random.RandomState(2)
    calls = [((3, 5), 0.5), ((3, 5), 0.5), ((4, 5), 0.5), ((3, 5), 0.5),
             ((3, 5), 2.0)]
    for shape, scale in calls:
        x = rng.randn(*shape).astype(np.float32)
        jf(paddle.to_tensor(x), scale)
        tf(torch.from_numpy(x), scale)
    assert len(tf._cache) == len(jf._cache) == 3
    assert len(tf._graphs.keys) == 3
    jl, tl = paddle.nn.Linear(5, 2), torch.nn.Linear(5, 2)
    paddle.jit.to_static(jl)
    jit.to_static(tl)
    x = rng.randn(3, 5).astype(np.float32)
    for train in (True, False, True):
        jl.train() if train else jl.eval()
        tl.train(train)
        jl(paddle.to_tensor(x))
        tl(torch.from_numpy(x))
    assert len(tl.forward._cache) == len(jl.forward._cache) == 2


def test_not_to_static_and_the_switch_run_the_function():
    calls = []

    def f(x):
        calls.append(1)
        return x * 2

    tf = jit.to_static(f)
    x = torch.ones(2, requires_grad=True)
    assert not tf(x).requires_grad                  # the compiled forward
    jit.enable_to_static(False)
    try:
        assert tf(x).requires_grad                  # the plain call
    finally:
        jit.enable_to_static(True)
    assert len(tf._cache) == 1
    g = jit.to_static(jit.not_to_static(lambda x: x + 1))
    assert g(x).requires_grad and not g._cache
    jit.set_verbosity(2)
    jit.set_code_level(1)
    jit.ignore_module([np])
    from paddle_tpu_torch.core.flags import GLOBAL_FLAGS
    assert GLOBAL_FLAGS.get("v") == 2
    jit.set_verbosity(0)


def _jax_steps(jm, ids_list, k):
    jopt = paddle.optimizer.AdamW(learning_rate=LR,
                                  parameters=jm.parameters())
    jstep = paddle.jit.TrainStep(jm, lambda x: jm(x, labels=x)[1], jopt,
                                 accumulate_steps=k)
    return [float(jstep(paddle.to_tensor(ids)).numpy()) for ids in ids_list]


@pytest.mark.parametrize("k", [1, 2])
def test_train_step_with_staged_scalars_matches_the_reference(k):
    """5 steps on changing batches: every step's scalars reach the
    bucket through the host staging before the step, and the losses and
    parameters follow the reference's TrainStep + AdamW."""
    jm, tm = _pair()
    rng = np.random.RandomState(3)
    ids_list = [rng.randint(0, TINY["vocab_size"], (4, 9)) for _ in range(5)]
    jm(paddle.to_tensor(ids_list[0]),
       labels=paddle.to_tensor(ids_list[0]))[1].backward()
    g1 = {n: np.asarray(p.grad.numpy()) for n, p in jm.named_parameters()}
    jm.clear_gradients()
    jl = _jax_steps(jm, ids_list, k)
    topt = pt.AdamW(learning_rate=LR, parameters=tm.parameters())
    tstep = pt.TrainStep(tm, lambda x: tm(x, labels=x)[1], topt,
                         accumulate_steps=k)
    staged = []
    orig = topt._fused_engine.stage_scalars

    def stage_scalars(lr, t):
        staged.append(t)
        return orig(lr, t)

    topt._fused_engine.stage_scalars = stage_scalars
    tl = [tstep(torch.from_numpy(ids)).item() for ids in ids_list]
    assert staged == [1, 2, 3, 4, 5] and topt._step_count == 5
    (b,) = topt._fused_engine.buckets
    assert b.scalars.tolist() == pytest.approx(
        [LR, 1 - 0.9 ** 5, 1 - 0.999 ** 5], rel=1e-6)
    np.testing.assert_allclose(tl, jl, **TIGHT)
    after = {n: np.asarray(v) for n, v in jm.state_dict().items()}
    for n, p in tm.named_parameters():
        got, want = p.detach().numpy(), after[n]
        firm = (np.abs(g1[n]) > 1e-4) | (g1[n] == 0)
        np.testing.assert_allclose(got[firm], want[firm], rtol=0, atol=1e-6,
                                   err_msg=n)
        assert np.abs(got - want).max() <= 2 * LR * 5 + 1e-6, n
    assert tstep.graphs.keys and tstep.graphs.calls["eager"] == 5
    assert tstep.last_compile_ms is None and tstep.compile_ms_total == 0.0


def test_train_step_keys_count_shapes_tails_and_frozen_parameters():
    """The key holds the batch shapes, K, the remat policy and which
    parameters require a gradient: a ragged tail batch and a frozen
    parameter each make another key."""
    _, tm = _pair()
    opt = pt.AdamW(learning_rate=LR, parameters=tm.parameters())
    step = pt.TrainStep(tm, lambda x: tm(x, labels=x)[1], opt,
                        accumulate_steps=2)
    rng = np.random.RandomState(4)
    even = torch.from_numpy(rng.randint(0, 128, (4, 9)))
    odd = torch.from_numpy(rng.randint(0, 128, (3, 9)))
    step(even)
    step(even)
    with pytest.warns(UserWarning, match="without accumulation"):
        step(odd)
    tm.model.norm.weight.requires_grad_(False)
    step(even)
    keys = step.graphs.keys
    assert len(keys) == 3
    assert [k[1] for k in keys] == [2, 1, 2]
    assert keys[0][3] != keys[2][3]
    assert opt._step_count == 4


def test_recompute_without_rng_state_leaves_losses_bitwise(monkeypatch):
    """llama_1b's shape, narrow (GQA 8:1, tied embeddings, remat, a loss
    chunk below the token count): three TrainSteps with the recompute
    and the chunked loss keeping no RNG state give the same losses and
    parameters, bit for bit, as with the RNG state kept."""
    kw = dict(num_hidden_layers=2, hidden_size=64, intermediate_size=176,
              num_attention_heads=8, num_key_value_heads=1, vocab_size=128,
              tie_word_embeddings=True, loss_chunk_size=16, remat=True)
    ids = torch.from_numpy(np.random.RandomState(5).randint(0, 128, (2, 24)))

    def run():
        tm = pt.LlamaForCausalLM(pt.llama_tiny_config(**kw), device="cpu",
                                 generator=torch.Generator().manual_seed(6))
        opt = pt.AdamW(learning_rate=LR, parameters=tm.parameters())
        step = pt.TrainStep(tm, lambda x: tm(x, labels=x)[1], opt)
        losses = [step(ids).item() for _ in range(3)]
        return losses, [p.detach().clone() for p in tm.parameters()]

    seen = []
    orig_recompute, orig_ckpt = tllama.recompute, tloss.checkpoint

    def spy_recompute(*a, **k):
        seen.append(k.get("preserve_rng_state"))
        return orig_recompute(*a, **k)

    monkeypatch.setattr(tllama, "recompute", spy_recompute)
    without = run()
    assert seen and not any(seen)
    monkeypatch.setattr(tllama, "recompute", lambda *a, **k: orig_recompute(
        *a, **dict(k, preserve_rng_state=True)))
    monkeypatch.setattr(tloss, "checkpoint", lambda *a, **k: orig_ckpt(
        *a, **dict(k, preserve_rng_state=True)))
    with_state = run()
    assert without[0] == with_state[0]
    assert all(torch.equal(a, b) for a, b in zip(without[1], with_state[1]))
