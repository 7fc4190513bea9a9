"""paddle_tpu_torch's flash attention (plain version) against the JAX
package's Pallas kernel, run in interpret mode on the CPU.

Same numpy inputs on both sides. Out, logsumexp, dq, dk and dv are
compared; the JAX gradients come from ``jax.vjp`` through the kernel's
custom VJP (its dq and dk/dv kernels), the port's from autograd through
the plain version. Tolerance: f32, ``atol = rtol = 2e-5`` (the two sum
the scores in another order; the Pallas tests use the same bound).

``sq > sk`` with causal masking leaves rows that see no key. Their
output, logsumexp and gradients are exactly the port's (0, -1e30, 0)
when the dead rows fill whole Pallas q blocks, as with ``sq - sk = 128``
here; see ROADMAP §C for other shapes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels import flash_attention as jfa
from paddle_tpu.nn import functional as JF
import paddle_tpu as paddle
from paddle_tpu_torch.kernels import LAUNCHES, reset_launch_counts
from paddle_tpu_torch.kernels import flash_attention as tfa
from paddle_tpu_torch.nn import functional as TF
import paddle_tpu_torch as pt

TOL = dict(atol=2e-5, rtol=2e-5)

#: (hq, hkv, sq, sk, d)
GEOMETRIES = {
    "mha_eq_d64": (4, 4, 64, 64, 64),
    "gqa4_2_sq_lt_sk": (4, 2, 32, 96, 64),
    "gqa8_2_sq_gt_sk_d128": (8, 2, 256, 128, 128),
    "gqa8_2_eq_d128": (8, 2, 128, 128, 128),
}


def _inputs(hq, hkv, sq, sk, d, seed=0, b=1):
    rng = np.random.RandomState(seed)
    return [rng.randn(*s).astype(np.float32)
            for s in ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d),
                      (b, hq, sq, d))]


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("geo", sorted(GEOMETRIES))
def test_plain_version_matches_pallas_kernel(geo, causal):
    q, k, v, do = _inputs(*GEOMETRIES[geo])
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    jout, vjp = jax.vjp(
        lambda a, b, c: jfa.flash_attention(a, b, c, causal=causal,
                                            interpret=True), jq, jk, jv)
    jgrads = vjp(jnp.asarray(do))
    _, jlse = jfa.flash_attention_with_lse(jq, jk, jv, causal=causal,
                                           interpret=True)

    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    tout, tlse = tfa.flash_attention_reference(tq, tk, tv, causal)
    tgrads = torch.autograd.grad(tout, (tq, tk, tv), torch.from_numpy(do))

    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(tlse.detach().numpy(), np.asarray(jlse), **TOL)
    for name, t, j in zip(("dq", "dk", "dv"), tgrads, jgrads):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), err_msg=name,
                                   **TOL)


def test_rows_that_see_no_key_are_zero():
    """Causal, sq > sk: the first sq - sk rows see no key: out 0, lse
    -1e30, no gradient through them."""
    q, k, v, do = _inputs(2, 1, 12, 5, 64, seed=3)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out, lse = tfa.flash_attention_reference(tq, tk, tv, causal=True)
    assert torch.equal(out[:, :, :7], torch.zeros_like(out[:, :, :7]))
    assert bool((lse[:, :, :7] == -1e30).all())
    assert bool((out[:, :, 7:].abs().sum(-1) > 0).all())
    dq, = torch.autograd.grad(out, (tq,), torch.from_numpy(do))
    assert torch.equal(dq[:, :, :7], torch.zeros_like(dq[:, :, :7]))


def test_wrapper_on_cpu_runs_the_plain_version_and_counts_nothing():
    q, k, v, _ = _inputs(4, 2, 16, 16, 64, seed=1)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    reset_launch_counts()
    out, lse = tfa.flash_attention_with_lse(tq, tk, tv, causal=True)
    want, want_lse = tfa.flash_attention_reference(tq, tk, tv, True)
    assert torch.equal(out, want) and torch.equal(lse, want_lse)
    assert all(n == 0 for n in LAUNCHES.values())
    with pytest.raises(ValueError, match="cuda or cpu"):
        tfa.flash_attention(tq.to("meta"), tk.to("meta"), tv.to("meta"))


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_functional_sdpa_matches_jax_in_paddle_layout(causal):
    """``[b, s, h, d]`` surface: the port's scaled_dot_product_attention
    against the JAX package's, GQA 4/2."""
    rng = np.random.RandomState(5)
    q = rng.randn(2, 24, 4, 64).astype(np.float32)
    k = rng.randn(2, 24, 2, 64).astype(np.float32)
    v = rng.randn(2, 24, 2, 64).astype(np.float32)
    want = JF.scaled_dot_product_attention(
        *(paddle.to_tensor(a) for a in (q, k, v)), is_causal=causal).numpy()
    got = TF.scaled_dot_product_attention(
        *(torch.from_numpy(a) for a in (q, k, v)), is_causal=causal)
    assert got.shape == (2, 24, 4, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    out, none = TF.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                   causal=causal)
    assert none is None and torch.equal(out, got)


def test_functional_attention_casts_its_inputs_under_o1():
    rng = np.random.RandomState(6)
    q, k, v = (torch.from_numpy(rng.randn(1, 8, 2, 64).astype(np.float32))
               for _ in range(3))
    with pt.auto_cast(level="O1", dtype="bfloat16"):
        out = TF.scaled_dot_product_attention(q, k, v, is_causal=True)
    assert out.dtype == torch.bfloat16
    assert TF.scaled_dot_product_attention(q, k, v).dtype == torch.float32


#: the card tests' flash geometries (b, hq, hkv, sq, sk, d), with
#: llama_1b's GQA 8:1 grouping at s 256
ROUNDING_GEOMETRIES = {
    "mha_d64": (2, 4, 4, 256, 256, 64),
    "gqa8_2_d128_tail": (1, 8, 2, 192, 320, 128),
    "gqa4_2_sq_gt_sk": (1, 4, 2, 320, 192, 128),
    "gqa4_1_ragged": (2, 4, 1, 100, 77, 64),
    "gqa8_1_d64": (1, 32, 4, 256, 256, 64),
    "one_row": (1, 2, 1, 1, 1, 64),
    "sq23_d128": (2, 4, 2, 23, 90, 128),
}

#: the card's bf16 bound on |kernel - plain| over max(1, max |plain|)
#: (tests/test_torch_cuda_kernels.py FLASH_TOL, chip_smoke.py FLASH_RTOL)
BF16_TOL = 2e-2


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _tensor_core_arithmetic(q, k, v, do, causal, scale, tile=64):
    """The bf16 tensor-core kernels' arithmetic in plain PyTorch, tile by
    tile over 64 keys: products take bf16 operands and sum in f32, scale
    multiplies the f32 score, the running max and the denominator l come
    from the f32 probabilities with online rescaling, and P and dS =
    P (dP - delta) are rounded to bf16 only as operands of their
    products. Returns out, lse, dq, dk, dv."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    group = hq // hkv
    qf, dof = q.float(), do.float()
    kf = k.float().repeat_interleave(group, 1)
    vf = v.float().repeat_interleave(group, 1)
    qi = torch.arange(sq)[:, None]
    tiles = [(k0, min(k0 + tile, sk)) for k0 in range(0, sk, tile)]

    def scores(k0, k1):
        s = torch.matmul(qf, kf[:, :, k0:k1].transpose(-1, -2)) * scale
        if causal:
            s = s.masked_fill(qi + (sk - sq) < torch.arange(k0, k1)[None],
                              float("-inf"))
        return s

    m = torch.full((b, hq, sq, 1), -1e30)
    l = torch.zeros(b, hq, sq, 1)
    acc = torch.zeros(b, hq, sq, d)
    for k0, k1 in tiles:
        s = scores(k0, k1)
        mn = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - mn)                 # masked: exactly 0
        alpha = torch.exp(m - mn)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.matmul(_bf16(p), vf[:, :, k0:k1])
        m = mn
    dead = l == 0
    out = (acc / torch.where(dead, torch.ones_like(l), l)).to(q.dtype)
    lse = torch.where(dead, torch.full_like(l, -1e30), m + torch.log(l))

    delta = (dof * out.float()).sum(-1, keepdim=True)
    dq = torch.zeros(b, hq, sq, d)
    dkh, dvh = torch.zeros(b, hq, sk, d), torch.zeros(b, hq, sk, d)
    for k0, k1 in tiles:
        p = torch.exp(scores(k0, k1) - lse)
        dp = torch.matmul(dof, vf[:, :, k0:k1].transpose(-1, -2))
        ds = _bf16(p * (dp - delta))
        dq += torch.matmul(ds, kf[:, :, k0:k1])
        dkh[:, :, k0:k1] = torch.matmul(ds.transpose(-1, -2), qf)
        dvh[:, :, k0:k1] = torch.matmul(_bf16(p).transpose(-1, -2), dof)
    dk = (dkh * scale).view(b, hkv, group, sk, d).sum(2)
    dv = dvh.view(b, hkv, group, sk, d).sum(2)
    return (out, lse.squeeze(-1), (dq * scale).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("geo", sorted(ROUNDING_GEOMETRIES))
def test_tensor_core_rounding_holds_the_card_tolerance(geo, causal):
    """Where the bf16 kernels round (P and dS to bf16 before their
    products) keeps them within the card's bf16 tolerance of the f32
    plain version, and lse within 1e-4: checked here, before any chip."""
    b, hq, hkv, sq, sk, d = ROUNDING_GEOMETRIES[geo]
    q, k, v, do = (torch.from_numpy(a).to(torch.bfloat16)
                   for a in _inputs(hq, hkv, sq, sk, d, seed=2, b=b))
    scale = d ** -0.5
    got = _tensor_core_arithmetic(q, k, v, do, causal, scale)
    tq, tk, tv = (x.clone().requires_grad_() for x in (q, k, v))
    ref, ref_lse = tfa.flash_attention_reference(tq, tk, tv, causal, scale)
    want = (ref, ref_lse, *torch.autograd.grad(ref, (tq, tk, tv), do))
    live = ref_lse > -1e29
    assert torch.equal(got[1] > -1e29, live)
    assert (got[1] - ref_lse)[live].abs().max().item() <= 1e-4
    for name, a, w in zip(("out", "dq", "dk", "dv"), got[:1] + got[2:],
                          want[:1] + want[2:]):
        assert a.dtype == w.dtype == torch.bfloat16, name
        err = (a.float() - w.float()).abs().max().item()
        assert err <= BF16_TOL * max(1.0, w.float().abs().max().item()), \
            (name, err)
