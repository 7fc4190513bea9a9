"""paddle_tpu_torch's recompute (remat) and micro-batch accumulation
against the JAX package's.

A tiny Llama (2 layers, GQA 4/2, a loss chunk smaller than the token
count) holds the same weights on both sides (``load_numpy_state_dict``);
ids come from numpy. Compared:

- ``remat=True`` (each decoder layer recomputed in backward): loss and
  every gradient against the reference's ``remat=True`` model,
  ``rtol = 1e-5, atol = 1e-6`` (the same math in another summation
  order); against the port without remat, the loss within ``1e-6`` and
  the gradients at ``rtol = 1e-5, atol = 1e-7``
  (``tests/test_scan_layers.py``'s bounds);
- ``TrainStep(accumulate_steps=2)`` with AdamW against the reference's:
  losses ``rtol = 1e-5, atol = 1e-6`` and the parameters after 2 steps
  with ``tests/test_torch_train.py::test_train_steps_match_jax``'s rule;
  against the port's ``accumulate_steps=1`` on the same batch, the loss
  within ``1e-6`` and the gradients at ``rtol = 1e-5, atol = 1e-7``;
- the remat policy's resolution and flag validation, and
  ``flops_per_token`` under each policy (exactly equal).
"""
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core.flags import GLOBAL_FLAGS as JAX_FLAGS
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import llama_tiny_config as jax_tiny_config
import paddle_tpu_torch as pt
from paddle_tpu_torch.amp.auto_cast import snapshot_amp_state
from paddle_tpu_torch.core.flags import GLOBAL_FLAGS, set_flags
from paddle_tpu_torch.distributed.fleet import recompute, recompute_sequential
from paddle_tpu_torch.kernels import flash_attention as tfa
from paddle_tpu_torch.kernels import rms_norm as trn
from paddle_tpu_torch.nn.scan_stack import (REMAT_POLICIES,
                                            effective_remat_policy,
                                            remat_policy_scope)

TIGHT = dict(rtol=1e-5, atol=1e-6)
LR = 1e-3
STEPS = 2

TINY = dict(num_hidden_layers=2, hidden_size=64, intermediate_size=128,
            num_attention_heads=4, num_key_value_heads=2, vocab_size=128)


@pytest.fixture(autouse=True)
def _policy_flags():
    """Every test starts and ends with both packages' flag at none."""
    for flags in (GLOBAL_FLAGS, JAX_FLAGS):
        flags.set("remat_policy", "none")
    yield
    for flags in (GLOBAL_FLAGS, JAX_FLAGS):
        flags.set("remat_policy", "none")


def _pair(remat=False, chunk=5, seed=7):
    """A JAX model and the port's, holding the same weights."""
    kw = dict(TINY, loss_chunk_size=chunk, remat=remat)
    paddle.seed(seed)
    jm = JaxLlama(jax_tiny_config(**kw))
    tm = pt.LlamaForCausalLM(pt.llama_tiny_config(**kw), device="cpu")
    pt.load_numpy_state_dict(
        tm, {k: np.asarray(v) for k, v in jm.state_dict().items()})
    return jm, tm


def _ids(seed=0, shape=(2, 9)):
    return np.random.RandomState(seed).randint(0, TINY["vocab_size"], shape)


def _port_loss_and_grads(tm, ids):
    ids = torch.from_numpy(ids)
    loss = tm(ids, labels=ids)[1]
    loss.backward()
    return loss.item(), {n: p.grad.numpy().copy()
                         for n, p in tm.named_parameters()}


def test_remat_matches_the_reference_remat():
    jm, tm = _pair(remat=True)
    ids = _ids()
    jloss = jm(paddle.to_tensor(ids), labels=paddle.to_tensor(ids))[1]
    jloss.backward()
    tloss, tgrads = _port_loss_and_grads(tm, ids)
    np.testing.assert_allclose(tloss, float(jloss.numpy()), **TIGHT)
    jgrads = {n: np.asarray(p.grad.numpy()) for n, p in jm.named_parameters()}
    assert sorted(jgrads) == sorted(tgrads)
    for n, g in jgrads.items():
        np.testing.assert_allclose(tgrads[n], g, err_msg=n, **TIGHT)


def test_remat_preserves_values():
    _, plain = _pair(remat=False)
    _, remat = _pair(remat=True)
    ids = _ids(1)
    base_l, base_g = _port_loss_and_grads(plain, ids)
    l, g = _port_loss_and_grads(remat, ids)
    assert abs(l - base_l) <= 1e-6
    for n in base_g:
        np.testing.assert_allclose(g[n], base_g[n], rtol=1e-5, atol=1e-7,
                                   err_msg=n)


def _count_calls(monkeypatch):
    """Count the plain versions' calls (the kernels' wrappers count
    launches only on the card)."""
    calls = {"rms_fwd": 0, "rms_bwd": 0, "flash_fwd": 0}

    def counted(key, fn):
        def wrapper(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapper

    monkeypatch.setattr(trn, "rms_norm_fwd_reference",
                        counted("rms_fwd", trn.rms_norm_fwd_reference))
    monkeypatch.setattr(trn, "rms_norm_bwd_reference",
                        counted("rms_bwd", trn.rms_norm_bwd_reference))
    monkeypatch.setattr(tfa, "flash_attention_reference",
                        counted("flash_fwd", tfa.flash_attention_reference))
    return calls


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_remat_replays_each_layer_once(monkeypatch, remat):
    """Per step with L layers: the norms run 2L + 1 times forward, and
    again 2L times under remat (the replay of every layer); 2L + 1
    backward; attention forward L times, 2L under remat. These are the
    launch counts ``chip_smoke.py`` asserts on the card."""
    _, tm = _pair(remat=remat)
    L = TINY["num_hidden_layers"]
    calls = _count_calls(monkeypatch)
    _port_loss_and_grads(tm, _ids(2))
    assert calls == {"rms_fwd": (4 if remat else 2) * L + 1,
                     "rms_bwd": 2 * L + 1,
                     "flash_fwd": (2 if remat else 1) * L}


def test_remat_policy_pins_the_policy_for_the_step(monkeypatch):
    _, tm = _pair(remat=False)
    calls = _count_calls(monkeypatch)
    ids = torch.from_numpy(_ids(3))
    opt = pt.AdamW(learning_rate=LR, parameters=tm.parameters())
    step = pt.TrainStep(tm, lambda x: tm(x, labels=x)[1], opt,
                        remat_policy="full")
    step(ids)
    assert calls["flash_fwd"] == 2 * TINY["num_hidden_layers"]
    assert effective_remat_policy() == "none"     # the scope is left


def test_recompute_replays_the_forward_auto_cast_state():
    """Backward outside ``auto_cast`` replays the layer in bf16 as the
    forward ran it: the gradients equal the un-recomputed ones."""
    lin = torch.nn.Linear(16, 16)
    x = torch.randn(4, 16, requires_grad=True)
    seen = []

    def fn(a):
        seen.append(snapshot_amp_state()[0])
        return torch.nn.functional.silu(lin(a))

    grads = []
    for use in (False, True):
        with pt.auto_cast(level="O1", dtype="bfloat16"):
            y = recompute(fn, x) if use else fn(x)
        y.float().sum().backward()
        grads.append((x.grad.clone(), lin.weight.grad.clone()))
        x.grad = None
        lin.weight.grad = None
    assert seen == [True, True, True]        # plain, forward, replay
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_recompute_without_grad_runs_the_function():
    lin = torch.nn.Linear(8, 8)
    x = torch.randn(2, 8)
    with torch.no_grad():
        y = recompute(lin, x)
    assert y.grad_fn is None and torch.equal(y, lin(x).detach())


def test_recompute_sequential_matches_the_sequence():
    torch.manual_seed(0)
    layers = torch.nn.Sequential(*[torch.nn.Linear(8, 8) for _ in range(4)])
    x = torch.randn(3, 8, requires_grad=True)
    layers(x).sum().backward()
    want = [p.grad.clone() for p in layers.parameters()] + [x.grad.clone()]
    layers.zero_grad()
    x.grad = None
    recompute_sequential({"segments": 2}, layers, x).sum().backward()
    got = [p.grad for p in layers.parameters()] + [x.grad]
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def _jax_steps(jm, ids, k):
    jopt = paddle.optimizer.AdamW(learning_rate=LR,
                                  parameters=jm.parameters())
    jstep = paddle.jit.TrainStep(jm, lambda x: jm(x, labels=x)[1], jopt,
                                 accumulate_steps=k)
    return [float(jstep(paddle.to_tensor(ids)).numpy())
            for _ in range(STEPS)]


def _port_steps(tm, ids, k):
    topt = pt.AdamW(learning_rate=LR, parameters=tm.parameters())
    tstep = pt.TrainStep(tm, lambda x: tm(x, labels=x)[1], topt,
                         accumulate_steps=k)
    losses = [tstep(torch.from_numpy(ids)).item() for _ in range(STEPS)]
    topt._fused_engine.check_aliasing()       # grads still view the bucket
    return losses


def test_accumulation_matches_the_reference_accumulation():
    jm, tm = _pair()
    ids = _ids(4, shape=(4, 9))
    jm(paddle.to_tensor(ids), labels=paddle.to_tensor(ids))[1].backward()
    g1 = {n: np.asarray(p.grad.numpy()) for n, p in jm.named_parameters()}
    jm.clear_gradients()
    before = {n: np.asarray(v) for n, v in jm.state_dict().items()}
    jl = _jax_steps(jm, ids, 2)
    tl = _port_steps(tm, ids, 2)
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


def test_accumulation_equals_one_step_on_the_whole_batch():
    """The mean of the micro-batches' gradients, left in the flat bucket
    by the last step, equals the whole batch's (rtol 1e-5, atol 1e-7);
    the first loss within 1e-6."""
    ids = _ids(5, shape=(4, 9))
    _, one = _pair()
    _, two = _pair()
    l1 = _port_steps(one, ids, 1)
    l2 = _port_steps(two, ids, 2)
    assert abs(l2[0] - l1[0]) <= 1e-6
    for (n, p), (_, q) in zip(one.named_parameters(),
                              two.named_parameters()):
        np.testing.assert_allclose(q.grad.numpy(), p.grad.numpy(),
                                   rtol=1e-5, atol=1e-7, err_msg=n)
        np.testing.assert_allclose(q.detach().numpy(), p.detach().numpy(),
                                   rtol=0, atol=2 * LR * STEPS, err_msg=n)


def test_ragged_batch_runs_without_accumulation_and_warns_once():
    ids = _ids(6, shape=(3, 9))
    _, tm = _pair()
    _, ref = _pair()
    opt = pt.AdamW(learning_rate=LR, parameters=tm.parameters())
    step = pt.TrainStep(tm, lambda x: tm(x, labels=x)[1], opt,
                        accumulate_steps=2)
    with pytest.warns(UserWarning, match="without accumulation"):
        got = step(torch.from_numpy(ids)).item()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        step(torch.from_numpy(ids))
    want = _port_steps(ref, ids, 1)[0]
    assert got == want


def test_accumulation_refuses_a_model_with_buffers():
    _, tm = _pair()
    tm.register_buffer("running", torch.zeros(3))
    opt = pt.AdamW(learning_rate=LR, parameters=tm.parameters())
    step = pt.TrainStep(tm, lambda x: tm(x, labels=x)[1], opt,
                        accumulate_steps=2)
    with pytest.raises(RuntimeError, match="buffers"):
        step(torch.from_numpy(_ids(7, shape=(4, 9))))


def test_train_step_validates_its_knobs():
    _, tm = _pair()
    opt = pt.AdamW(parameters=tm.parameters())
    with pytest.raises(ValueError, match="accumulate_steps"):
        pt.TrainStep(tm, lambda x: x, opt, accumulate_steps=0)
    with pytest.raises(ValueError, match="remat_policy"):
        pt.TrainStep(tm, lambda x: x, opt, remat_policy="everything")


def test_remat_policy_flag_validates():
    with pytest.raises(ValueError, match="remat_policy"):
        GLOBAL_FLAGS.set("remat_policy", "everything")
    assert GLOBAL_FLAGS.get("remat_policy") in REMAT_POLICIES
    with pytest.raises(ValueError, match="remat_policy"):
        remat_policy_scope("everything")


def test_policy_resolution_matches_the_reference():
    from paddle_tpu.nn.scan_stack import effective_remat_policy as jax_eff
    from paddle_tpu.nn.scan_stack import remat_policy_scope as jax_scope
    for flag in REMAT_POLICIES:
        for cfg in (False, True):
            GLOBAL_FLAGS.set("remat_policy", flag)
            JAX_FLAGS.set("remat_policy", flag)
            assert effective_remat_policy(cfg) == jax_eff(cfg)
            for pinned in REMAT_POLICIES:
                with remat_policy_scope(pinned), jax_scope(pinned):
                    assert effective_remat_policy(cfg) == jax_eff(cfg) \
                        == pinned
    GLOBAL_FLAGS.set("remat_policy", "none")
    assert effective_remat_policy(True) == "full"
    GLOBAL_FLAGS.set("remat_policy", "dots_saveable")
    # an explicit flag wins over the config's spelling
    assert effective_remat_policy(True) == "dots_saveable"


def test_scan_layers_flag_names_its_roadmap_item():
    with pytest.raises(NotImplementedError, match="ROADMAP item .nn."):
        set_flags({"FLAGS_scan_layers": True})
    set_flags({"FLAGS_scan_layers": False})
    assert GLOBAL_FLAGS.get("scan_layers") is False


@pytest.mark.parametrize("remat", [False, True], ids=["config", "remat"])
def test_flops_per_token_matches_the_reference(remat):
    jm, tm = _pair(remat=remat)
    assert tm.flops_per_token(128) == jm.flops_per_token(128)
    for pol in REMAT_POLICIES:
        assert tm.flops_per_token(128, remat_policy=pol) == \
            jm.flops_per_token(128, remat_policy=pol), pol
    base = tm.flops_per_token(128, remat_policy="none")
    n = sum(p.numel() for p in tm.parameters())
    attn = 12 * TINY["num_hidden_layers"] * TINY["hidden_size"] * 128
    assert tm.flops_per_token(128, remat_policy="full") == \
        base + 2 * n + attn // 3


def test_llama2_13b_config_matches_the_reference():
    from paddle_tpu.models.llama import llama2_13b_config as jax_13b
    want, got = jax_13b(), pt.llama2_13b_config()
    for f in ("hidden_size", "intermediate_size", "num_hidden_layers",
              "num_attention_heads", "num_key_value_heads", "vocab_size",
              "max_position_embeddings", "rms_norm_eps"):
        assert getattr(got, f) == getattr(want, f), f
