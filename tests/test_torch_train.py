"""paddle_tpu_torch's training step against the JAX package's.

A tiny Llama (2 layers, GQA 4/2, tied and untied heads, a loss chunk
smaller than the token count) holds the same weights on both sides
(moved through ``load_numpy_state_dict``); ids come from numpy. Compared:
first-step gradients (JAX eager ``loss.backward()``), the losses of 3
``TrainStep``s with AdamW (``paddle.jit.TrainStep``), and the parameters
after them. All in f32.

Tolerances: losses and gradients ``rtol = 1e-5, atol = 1e-6`` (the same
math in another summation order). Parameters after 3 AdamW steps:
entries whose first gradient is 0 or above 1e-4 in size must agree to
``atol = 1e-6``; AdamW moves an entry by about ``lr`` in the direction of
its gradient's sign whatever the gradient's size, so where the gradient
is within the two frameworks' rounding of zero the direction can differ,
and those entries are only held to the ``2 lr`` per step such a flip can
cost.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import llama_tiny_config as jax_tiny_config
import paddle_tpu_torch as pt
from paddle_tpu_torch.models import generation as tgen
from paddle_tpu_torch.optimizer import dispatch_count

TIGHT = dict(rtol=1e-5, atol=1e-6)
LR = 1e-3
STEPS = 3

TINY = dict(num_hidden_layers=2, hidden_size=64, intermediate_size=128,
            num_attention_heads=4, num_key_value_heads=2, vocab_size=128)


def _pair(tie=False, chunk=5, seed=7):
    """A JAX model and the port's, holding the same weights."""
    kw = dict(TINY, tie_word_embeddings=tie, loss_chunk_size=chunk)
    paddle.seed(seed)
    jm = JaxLlama(jax_tiny_config(**kw))
    tm = pt.LlamaForCausalLM(pt.llama_tiny_config(**kw), device="cpu")
    pt.load_numpy_state_dict(
        tm, {k: np.asarray(v) for k, v in jm.state_dict().items()})
    return jm, tm


def _ids(seed=0, shape=(2, 9)):
    return np.random.RandomState(seed).randint(0, TINY["vocab_size"], shape)


@pytest.mark.parametrize("tie", [False, True], ids=["untied", "tied"])
def test_first_step_grads_match_jax(tie):
    jm, tm = _pair(tie=tie)
    ids = _ids()
    jloss = jm(paddle.to_tensor(ids), labels=paddle.to_tensor(ids))[1]
    jloss.backward()
    out, tloss = tm(torch.from_numpy(ids), labels=torch.from_numpy(ids))
    assert out is None                    # the chunked head forms no logits
    tloss.backward()
    np.testing.assert_allclose(tloss.item(), float(jloss.numpy()), **TIGHT)
    jgrads = {n: np.asarray(p.grad.numpy()) for n, p in jm.named_parameters()}
    tgrads = dict(tm.named_parameters())
    assert sorted(jgrads) == sorted(tgrads)
    for n, g in jgrads.items():
        np.testing.assert_allclose(tgrads[n].grad.numpy(), g, err_msg=n,
                                   **TIGHT)


def test_unchunked_head_returns_logits_and_the_same_loss():
    jm, tm = _pair(chunk=0)
    ids = _ids(1)
    jlogits, jloss = jm(paddle.to_tensor(ids), labels=paddle.to_tensor(ids))
    logits, loss = tm(torch.from_numpy(ids), labels=torch.from_numpy(ids))
    np.testing.assert_allclose(logits.detach().numpy(),
                               np.asarray(jlogits.numpy()), **TIGHT)
    np.testing.assert_allclose(loss.item(), float(jloss.numpy()), **TIGHT)
    _, chunked = _pair(chunk=5)
    _, closs = chunked(torch.from_numpy(ids), labels=torch.from_numpy(ids))
    np.testing.assert_allclose(closs.item(), loss.item(), **TIGHT)


@pytest.mark.parametrize("tie", [False, True], ids=["untied", "tied"])
def test_train_steps_match_jax(tie):
    jm, tm = _pair(tie=tie)
    ids = _ids(2)
    # the first step's gradient decides which entries can be held tight
    jm(paddle.to_tensor(ids), labels=paddle.to_tensor(ids))[1].backward()
    g1 = {n: np.asarray(p.grad.numpy()) for n, p in jm.named_parameters()}
    jm.clear_gradients()
    before = {n: np.asarray(v) for n, v in jm.state_dict().items()}

    jopt = paddle.optimizer.AdamW(learning_rate=LR,
                                  parameters=jm.parameters())
    jstep = paddle.jit.TrainStep(
        jm, lambda x: jm(x, labels=x)[1], jopt)
    jl = [float(jstep(paddle.to_tensor(ids)).numpy()) for _ in range(STEPS)]

    topt = pt.AdamW(learning_rate=LR, parameters=tm.parameters())
    tstep = pt.TrainStep(tm, lambda x: tm(x, labels=x)[1], topt)
    tl = [tstep(torch.from_numpy(ids)).item() for _ in range(STEPS)]
    np.testing.assert_allclose(tl, jl, **TIGHT)
    assert tl[-1] < tl[0]

    after = {n: np.asarray(v) for n, v in jm.state_dict().items()}
    for n, p in tm.named_parameters():
        got, want = p.detach().numpy(), after[n]
        assert not np.array_equal(want, before[n]), n
        firm = (np.abs(g1[n]) > 1e-4) | (g1[n] == 0)
        np.testing.assert_allclose(got[firm], want[firm], rtol=0, atol=1e-6,
                                   err_msg=n)
        assert np.abs(got - want).max() <= 2 * LR * STEPS + 1e-6, n


def test_grads_are_views_of_the_flat_bucket():
    """``.data`` and ``.grad`` of every parameter view the bucket's flat
    buffers; backward accumulates into them in place; one update launch
    per bucket; replacing a ``.grad`` is caught, not silently used."""
    _, tm = _pair()
    _, ref = _pair()
    ids = torch.from_numpy(_ids(3))
    opt = pt.AdamW(learning_rate=LR, parameters=tm.parameters())
    (b,) = opt._fused_engine.buckets
    assert b.flat_p.numel() == sum(p.numel() for p in tm.parameters())
    tm(ids, labels=ids)[1].backward()
    ref(ids, labels=ids)[1].backward()
    size = b.flat_g.element_size()
    for p, off in zip(b.params, b.offsets):
        assert p.data_ptr() == b.flat_p.data_ptr() + off * size
        assert p.grad.data_ptr() == b.flat_g.data_ptr() + off * size
    for (n, p), (_, q) in zip(tm.named_parameters(), ref.named_parameters()):
        assert torch.equal(p.grad, q.grad), n
    n0 = dispatch_count()
    opt.step()
    assert dispatch_count() - n0 == 1
    opt.clear_grad()
    assert not b.flat_g.any()
    opt._fused_engine.check_aliasing()
    p0 = b.params[0]
    p0.grad = torch.zeros_like(p0)
    with pytest.raises(RuntimeError, match="no longer views"):
        opt.step()


def test_one_bucket_per_dtype():
    _, tm = _pair()
    tm.model.norm.weight.data = tm.model.norm.weight.data.bfloat16()
    opt = pt.AdamW(learning_rate=LR, parameters=tm.parameters())
    assert sorted(str(b.flat_p.dtype) for b in opt._fused_engine.buckets) == \
        ["torch.bfloat16", "torch.float32"]
    ids = torch.from_numpy(_ids(3))
    tm(ids, labels=ids)[1].backward()      # a step updates what got grads
    n0 = dispatch_count()
    opt.step()
    assert dispatch_count() - n0 == 2
    state = opt.state_dict()
    assert state["step"] == 1
    assert len([k for k in state if k.endswith(".moment1")]) == \
        len(list(tm.parameters()))


def test_o1_runs_the_matmuls_in_bf16_and_keeps_the_loss_close():
    _, tm = _pair()
    ids = torch.from_numpy(_ids(4))
    f32 = tm(ids, labels=ids)[1].item()
    seen = []
    hook = tm.model.layers[0].self_attn.q_proj.register_forward_hook(
        lambda mod, inp, out: seen.append(out.dtype))
    with pt.auto_cast(level="O1", dtype="bfloat16"):
        loss = tm(ids, labels=ids)[1]
    hook.remove()
    assert seen == [torch.bfloat16] and loss.dtype == torch.float32
    assert abs(loss.item() - f32) < 2e-2 * abs(f32)


def test_flops_per_token_matches_jax():
    jm, tm = _pair()
    assert tm.flops_per_token(1024) == jm.flops_per_token(1024)


def test_serving_a_trainable_model_records_no_graph():
    _, tm = _pair()
    assert all(p.requires_grad for p in tm.parameters())
    saved = []
    eng = pt.LLMEngine(tm, max_len=64, page_size=16, max_num_seqs=2,
                       chunk_size=16, device="cpu")
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(t.shape) or t, lambda t: t):
        rid = eng.add_request([1, 2, 3, 4, 5], max_new_tokens=4)
        out = eng.run(max_steps=50)[rid]
    assert len(out.token_ids) == 4
    assert saved == []
    assert all(p.grad is None for p in tm.parameters())
    params = tgen.extract_params(tm)
    assert not params["embed"].requires_grad
    assert not any(w.requires_grad for layer in params["layers"]
                   for w in layer.values())


def test_knobs_not_ported_raise():
    cfg = pt.llama_tiny_config(**TINY)
    tm = pt.LlamaForCausalLM(cfg, device="cpu")
    opt = pt.AdamW(parameters=tm.parameters())
    with pytest.raises(NotImplementedError, match="distributed item"):
        pt.TrainStep(tm, lambda x: x, opt, sharding="dp=2")
    with pytest.raises(NotImplementedError, match="ROADMAP item .optimizer/."):
        pt.AdamW(parameters=tm.parameters(), lr_ratio=lambda p: 1.0)
    with pytest.raises(NotImplementedError, match="ROADMAP item .optimizer/."):
        pt.AdamW(parameters=tm.parameters(), grad_clip=object())
    with pytest.raises(NotImplementedError, match="ROADMAP item .optimizer/."):
        pt.AdamW(learning_rate=object(), parameters=tm.parameters())
    with pytest.raises(NotImplementedError, match="ROADMAP item .amp/."):
        pt.auto_cast(level="O2")
