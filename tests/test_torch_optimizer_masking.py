"""paddle_tpu_torch's fused optimizer over parameters that got no
gradient, against the JAX package's fused engine.

The same numpy parameters and gradients go to ``paddle_tpu``'s Adam or
AdamW and to the port's. A parameter without a gradient at the build,
or frozen, is left out of the buckets; one that loses its gradient on a
later step is masked: its value and both moments stay bit for bit, the
buckets are not rebuilt, and the step is still one update per bucket.
The port's gradients come from a backward of ``sum(p * g)``, which
accumulates exactly ``g`` into each ``.grad``.

Tolerances: the reference's own between its fused and per-parameter
paths (``tests/test_optimizer_fused.py``): f32 1e-6, bf16 2e-2 (one
bf16 ulp near 1.0 is ~8e-3).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as pt
from paddle_tpu.core.flags import GLOBAL_FLAGS
from paddle_tpu.kernels import fused_adamw as jfw
from paddle_tpu_torch.kernels import fused_adamw as tfw
from paddle_tpu_torch.optimizer.fused import dispatch_count

F32_TOL = 1e-6
BF16_TOL = 2e-2
SPECS = [((4, 8), "float32"), ((16,), "float32"), ((), "float32"),
         ((3, 3, 2), "float32"), ((8, 4), "bfloat16"), ((5,), "bfloat16"),
         ((7,), "float32"), ((2, 3), "bfloat16")]
OPTS = {"Adam": dict(learning_rate=0.01),
        "AdamW": dict(learning_rate=0.01, weight_decay=0.05)}


@pytest.fixture
def fused_flag():
    GLOBAL_FLAGS.set("fused_optimizer", True)
    yield
    GLOBAL_FLAGS.set("fused_optimizer", True)


def _numpy(specs, seed):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(s).astype(np.float32),
             rng.standard_normal(s).astype(np.float32)) for s, _ in specs]


def _jax_params(specs, data):
    params = []
    for i, ((_, dtype), (v, g)) in enumerate(zip(specs, data)):
        t = paddle.to_tensor(v, dtype=dtype)
        t.stop_gradient = False
        t.name = f"p{i}"
        t.grad = paddle.to_tensor(g, dtype=dtype)
        params.append(t)
    return params


def _torch_params(specs, data):
    return [torch.nn.Parameter(torch.from_numpy(v.copy()).to(
        getattr(torch, dtype))) for (_, dtype), (v, _) in zip(specs, data)]


def _backward(params, data, skip=()):
    """Accumulate each ``g`` into its parameter's ``.grad`` (all but
    ``skip``) through one backward."""
    loss = sum((p * torch.from_numpy(g).to(p.dtype)).sum().float()
               for i, (p, (_, g)) in enumerate(zip(params, data))
               if i not in skip)
    loss.backward()


def _assert_close(specs, tparams, jparams, idx):
    for i in idx:
        tol = F32_TOL if specs[i][1] == "float32" else BF16_TOL
        np.testing.assert_allclose(
            tparams[i].detach().float().numpy(),
            np.asarray(jparams[i].numpy(), np.float32), atol=tol, rtol=tol,
            err_msg=f"p{i}")


def _moments(topt, p):
    views = topt._fused_engine.state_views()
    return [views[(p, k)].clone() for k in ("moment1", "moment2")]


@pytest.mark.parametrize("kind", sorted(OPTS))
def test_build_excludes_stop_gradient_and_missing_grads(kind, fused_flag):
    data = _numpy(SPECS, seed=1)
    jparams = _jax_params(SPECS, data)
    jparams[1].stop_gradient = True
    jparams[3].grad = None
    jopt = getattr(paddle.optimizer, kind)(parameters=jparams, **OPTS[kind])
    jopt.step()

    tparams = _torch_params(SPECS, data)
    tparams[1].requires_grad_(False)
    _backward(tparams, data, skip=(1, 3))
    frozen = [tparams[i].detach().clone() for i in (1, 3)]
    topt = getattr(pt, kind)(parameters=tparams, **OPTS[kind])
    n0 = dispatch_count()
    topt.step()
    eng = topt._fused_engine
    bucketed = {id(p) for b in eng.buckets for p in b.params}
    assert id(tparams[1]) not in bucketed and id(tparams[3]) not in bucketed
    assert dispatch_count() - n0 == len(eng.buckets) == 2
    for i, v in zip((1, 3), frozen):
        assert torch.equal(tparams[i].detach(), v)
    live = [i for i in range(len(SPECS)) if i not in (1, 3)]
    _assert_close(SPECS, tparams, jparams, live)
    for i in live:
        jst = jopt._param_state(jparams[i])
        for name, got in zip(("moment1", "moment2"),
                             _moments(topt, tparams[i])):
            np.testing.assert_allclose(got.numpy(), np.asarray(
                jst[name], np.float32), atol=F32_TOL, rtol=1e-5,
                err_msg=f"p{i} {name}")


@pytest.mark.parametrize("kind", sorted(OPTS))
def test_mid_run_grad_drop_masks_without_rebuild(kind, fused_flag):
    """A parameter losing its gradient mid-run (an expert off route)
    takes the masked path: untouched value AND moments, no rebuild, one
    update per bucket; the next step with every gradient present reads
    no span table."""
    specs = [((4, 4), "float32")] * 6
    data = _numpy(specs, seed=2)
    jparams = _jax_params(specs, data)
    jopt = getattr(paddle.optimizer, kind)(parameters=jparams, **OPTS[kind])
    jopt.step()
    jparams[2].grad = None
    jopt.step()

    tparams = _torch_params(specs, data)
    topt = getattr(pt, kind)(parameters=tparams, **OPTS[kind])
    eng = topt._fused_engine
    buckets0 = list(eng.buckets)
    _backward(tparams, data)
    topt.step()
    topt.clear_grad()
    tparams[2].grad = None
    _backward(tparams, data, skip=(2,))
    before = tparams[2].detach().clone()
    m_before = _moments(topt, tparams[2])
    m3_before = _moments(topt, tparams[3])
    n0 = dispatch_count()
    topt.step()
    assert dispatch_count() - n0 == 1
    assert torch.equal(before, tparams[2].detach())
    for a, b in zip(m_before, _moments(topt, tparams[2])):
        assert torch.equal(a, b)
    assert not torch.equal(m3_before[0], _moments(topt, tparams[3])[0])
    assert eng.buckets == buckets0                 # masked, not rebuilt
    (b,) = eng.buckets
    assert len(b.tables) == 1                      # one presence pattern
    _assert_close(specs, tparams, jparams, range(len(specs)))
    jst = jopt._param_state(jparams[2])
    np.testing.assert_array_equal(
        m_before[0].numpy(), np.asarray(jst["moment1"], np.float32))
    # zero_grad gives the view back; all present: no new table, one launch
    topt.clear_grad()
    eng.check_aliasing()
    _backward(tparams, data)
    n0 = dispatch_count()
    topt.step()
    assert dispatch_count() - n0 == 1 and len(b.tables) == 1


def test_no_accumulation_since_the_last_step_is_no_gradient():
    """A second step with no backward in between moves nothing; a frozen
    parameter (``requires_grad`` off after the build) stays put while the
    others train."""
    specs = [((6,), "float32"), ((3, 2), "float32"), ((5,), "bfloat16")]
    data = _numpy(specs, seed=3)
    tparams = _torch_params(specs, data)
    opt = pt.AdamW(learning_rate=0.01, parameters=tparams)
    _backward(tparams, data)
    opt.step()
    after = [p.detach().clone() for p in tparams]
    n0 = dispatch_count()
    opt.step()
    assert dispatch_count() == n0
    assert all(torch.equal(a, p.detach()) for a, p in zip(after, tparams))
    tparams[1].requires_grad_(False)
    opt.clear_grad()
    _backward(tparams, data, skip=(1,))
    m1 = _moments(opt, tparams[1])
    opt.step()
    assert torch.equal(after[1], tparams[1].detach())
    assert all(torch.equal(a, b) for a, b in zip(m1, _moments(opt,
                                                            tparams[1])))
    assert not torch.equal(after[0], tparams[0].detach())


def test_a_left_out_parameter_with_a_gradient_rebuilds_the_buckets():
    specs = [((4,), "float32"), ((3,), "float32")]
    data = _numpy(specs, seed=4)
    tparams = _torch_params(specs, data)
    _backward(tparams, data, skip=(1,))
    opt = pt.Adam(learning_rate=0.01, parameters=tparams)
    opt.step()
    m0 = _moments(opt, tparams[0])
    assert [len(b.params) for b in opt._fused_engine.buckets] == [1]
    opt.clear_grad()
    _backward(tparams, data)
    opt.step()
    assert [len(b.params) for b in opt._fused_engine.buckets] == [2]
    assert not torch.equal(m0[0], _moments(opt, tparams[0])[0])
    assert _moments(opt, tparams[1])[0].abs().sum() > 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("wd,decoupled", [(0.01, True), (0.01, False)],
                         ids=["adamw", "adam_coupled"])
def test_plain_masked_update_matches_the_reference_under_where(
        dtype, wd, decoupled):
    """The plain version over a span table against ``_reference`` with
    the reference engine's ``jnp.where(mask, new, old)``: spans of odd
    lengths, one running to the bucket's end; outside them every value
    and moment keeps its bits."""
    n = 3001
    rng = np.random.RandomState(5)
    p = rng.randn(n).astype(np.float32)
    g = (rng.randn(n) * 1e-2).astype(np.float32)
    m = (rng.randn(n) * 1e-3).astype(np.float32)
    v = (rng.rand(n) * 1e-5).astype(np.float32)
    spans = [(0, 13), (24, 1000), (1048, 3), (2000, 1001)]
    mask = np.zeros(n, bool)
    for a, ln in spans:
        mask[a:a + ln] = True
    lr, t = 1e-3, 3
    kw = dict(beta1=0.9, beta2=0.999, eps=1e-8)
    jp, jg = (jnp.asarray(a, dtype) for a in (p, g))
    new = jfw._reference(jp, jg, jnp.asarray(m), jnp.asarray(v), lr,
                         1 - 0.9 ** t, 1 - 0.999 ** t, wd=wd,
                         decoupled=decoupled, **kw)
    want = [np.asarray(jnp.where(mask, a, b).astype(jnp.float32))
            for a, b in zip(new, (jp, jnp.asarray(m), jnp.asarray(v)))]

    tdt = getattr(torch, dtype)
    tp, tg = torch.from_numpy(p).to(tdt), torch.from_numpy(g).to(tdt)
    tm, tv = torch.from_numpy(m.copy()), torch.from_numpy(v.copy())
    old = [x.clone() for x in (tp, tm, tv)]
    table = tfw.span_table(spans, tdt, "cpu")
    sc = torch.tensor(tfw.adamw_scalars(lr, t, 0.9, 0.999))
    tfw.fused_adamw(tp, tg, tm, tv, sc, weight_decay=wd,
                    decoupled=decoupled, spans=table, **kw)
    keep = torch.from_numpy(~mask)
    for a, b in zip((tp, tm, tv), old):
        assert torch.equal(a[keep], b[keep])
    ptol = dict(rtol=1e-6, atol=1e-7) if dtype == "float32" else \
        dict(rtol=2 ** -8, atol=0)
    np.testing.assert_allclose(tp.float().numpy(), want[0], **ptol)
    np.testing.assert_allclose(tm.numpy(), want[1], rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tv.numpy(), want[2], rtol=1e-6, atol=1e-7)


def test_span_table_layout_and_rejects():
    t = tfw.span_table([(0, 13), (24, 9)], torch.float32, "cpu")
    assert t.tolist() == [0, 24, 13, 9, 0, 3, 5]
    t = tfw.span_table([(8, 17)], torch.bfloat16, "cpu")
    assert t.tolist() == [8, 17, 0, 2]
    for bad in ([], [(2, 4)], [(0, 8), (4, 8)], [(0, 0)]):
        with pytest.raises(ValueError):
            tfw.span_table(bad, torch.float32, "cpu")
    p = torch.zeros(16)
    sc = torch.tensor(tfw.adamw_scalars(1e-3, 1, 0.9, 0.999))
    with pytest.raises(ValueError, match="span_table"):
        tfw.fused_adamw(p, p.clone(), p.clone(), p.clone(), sc,
                        spans=torch.zeros(4, dtype=torch.int32))
