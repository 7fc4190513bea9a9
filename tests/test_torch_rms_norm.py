"""paddle_tpu_torch's RMSNorm against the JAX package's.

The port's ``nn.functional.rms_norm`` and ``nn.RMSNorm`` (on the CPU:
the plain versions beside the CUDA kernels of ``csrc/rms_norm.cu``),
forward and both gradients, against the Pallas kernel
``paddle_tpu.kernels.rms_norm.rms_norm`` in interpret mode (block_rows 2,
so its dw sums across several row blocks), on the same numpy inputs, for
a 2-D and a 3-D input in f32 and bf16.

Tolerances, against the Pallas kernel (the same rounding order: every
product in f32, the cast last):
- f32: ``rtol = atol = 1e-5`` (sums in another order);
- bf16: one bf16 ulp of the larger of the two values, elementwise; for
  ``dx`` and ``dw``, whose f32 value before the cast carries a sum, plus
  ``1e-5 × max|oracle|`` for the f32 summation order.

Against the reference's training default ``_rms_norm_reference``, which
divides by ``sqrt`` and casts to x's dtype before the ``· w``:
- f32: ``rtol = atol = 1e-5`` for the output and both gradients (a
  division against a multiply by ``rsqrt``);
- bf16 x: two bf16 ulps (the reference rounds ``x̂`` to bf16 before
  the ``· w``, the port rounds once at the end); with an f32 weight the
  reference promotes the output to f32 where the port keeps bf16 (by
  design, ROADMAP queue C).

Row counts are multiples of the oracle's block_rows: the Pallas kernel's
padded rows of a ragged last block enter its ``dw`` (NaN in interpret
mode).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels.rms_norm import rms_norm as pallas_rms_norm
from paddle_tpu.nn.functional.norm import _rms_norm_reference
import paddle_tpu_torch as pt
from paddle_tpu_torch.kernels import LAUNCHES, reset_launch_counts
from paddle_tpu_torch.kernels import rms_norm as trn
from paddle_tpu_torch.nn import functional as F

EPS = 1e-6
SHAPES = {"2d": (6, 384), "3d": (2, 8, 256)}
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    w = (1.0 + 0.5 * rng.normal(size=shape[-1:])).astype(np.float32)
    g = rng.normal(size=shape).astype(np.float32)
    return x, w, g


def _f32(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _ulp_bf16(v):
    """One bf16 ulp at |v| (7 stored mantissa bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(v), 2.0 ** -126)))
    return 2.0 ** (e - 7)


def _assert_bf16(got, want, ulps=1, slack=0.0, what=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    tol = ulps * _ulp_bf16(np.maximum(np.abs(got), np.abs(want))) + slack
    bad = np.abs(got - want) > tol
    assert not bad.any(), (what, got[bad][:5], want[bad][:5])


def _port(x, w, g, tdt, layer=False):
    """Forward and gradients of ``sum(y * g)`` through the port."""
    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    if layer:
        norm = pt.nn.RMSNorm(x.shape[-1], EPS, device="cpu", dtype=tdt)
        with torch.no_grad():
            norm.weight.copy_(torch.from_numpy(w))
        wt = norm.weight
        y = norm(xt)
    else:
        wt = torch.from_numpy(w).to(tdt).requires_grad_()
        y = F.rms_norm(xt, wt, EPS)
    (y.float() * torch.from_numpy(g)).sum().backward()
    return (y.detach().float().numpy(), xt.grad.float().numpy(),
            wt.grad.float().numpy(), y.dtype)


def _jax(fn, x, w, g, jdt, wdt=None):
    xj = jnp.asarray(x, jdt)
    wj = jnp.asarray(w, wdt or jdt)
    y = fn(xj, wj)
    dx, dw = jax.grad(
        lambda a, b: (fn(a, b).astype(jnp.float32) * g).sum(),
        argnums=(0, 1))(xj, wj)
    return _f32(y), _f32(dx), _f32(dw), y.dtype


def _pallas(x, w):
    return pallas_rms_norm(x, w, EPS, block_rows=2, interpret=True)


@pytest.mark.parametrize("layer", [False, True], ids=["functional", "layer"])
@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_matches_the_pallas_kernel(shape, dt, layer):
    x, w, g = _inputs(SHAPES[shape], seed=len(shape) + len(dt))
    tdt, jdt = DTYPES[dt]
    ty, tdx, tdw, tdtype = _port(x, w, g, tdt, layer)
    jy, jdx, jdw, jdtype = _jax(_pallas, x, w, g, jdt)
    assert str(tdtype).split(".")[-1] == str(jdtype)
    if dt == "f32":
        for a, b, what in ((ty, jy, "y"), (tdx, jdx, "dx"), (tdw, jdw, "dw")):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5,
                                       err_msg=what)
    else:
        _assert_bf16(ty, jy, what="y")
        _assert_bf16(tdx, jdx, slack=1e-5 * np.abs(jdx).max(), what="dx")
        _assert_bf16(tdw, jdw, slack=1e-5 * np.abs(jdw).max(), what="dw")


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_matches_the_reference_default_in_f32(shape):
    x, w, g = _inputs(SHAPES[shape], seed=11)
    ty, tdx, tdw, _ = _port(x, w, g, torch.float32)
    ref = lambda a, b: _rms_norm_reference(a, b, epsilon=EPS)  # noqa: E731
    jy, jdx, jdw, _ = _jax(ref, x, w, g, jnp.float32)
    for a, b, what in ((ty, jy, "y"), (tdx, jdx, "dx"), (tdw, jdw, "dw")):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5, err_msg=what)


def test_reference_default_in_bf16_rounds_twice_and_promotes():
    x, w, _ = _inputs(SHAPES["3d"], seed=12)
    xt = torch.from_numpy(x).bfloat16()
    ref = lambda a, b: _rms_norm_reference(a, b, epsilon=EPS)  # noqa: E731
    got = F.rms_norm(xt, torch.from_numpy(w).bfloat16(), EPS)
    want = ref(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    _assert_bf16(got.float().numpy(), _f32(want), ulps=2, what="bf16 w")
    # an f32 weight: both promote to f32
    got = F.rms_norm(xt, torch.from_numpy(w), EPS)
    want = ref(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.float32))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    _assert_bf16(got.numpy(), _f32(want), ulps=2, what="f32 w")


def test_mixed_dtypes_give_x_and_w_their_own_gradient_dtypes():
    x, w, g = _inputs((6, 64), seed=13)
    xt = torch.from_numpy(x).bfloat16().requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    y = F.rms_norm(xt, wt, EPS)
    (y.float() * torch.from_numpy(g)).sum().backward()
    assert (y.dtype, xt.grad.dtype, wt.grad.dtype) == \
        (torch.float32, torch.bfloat16, torch.float32)
    jy, jdx, jdw, _ = _jax(_pallas, x, w, g, jnp.bfloat16, jnp.float32)
    _assert_bf16(y.float().detach().numpy(), jy, what="y")
    _assert_bf16(xt.grad.float().numpy(), jdx,
                 slack=1e-5 * np.abs(jdx).max(), what="dx")
    np.testing.assert_allclose(wt.grad.numpy(), jdw, rtol=1e-5, atol=1e-5)


def test_without_a_weight_it_is_the_reference_body():
    x, _, _ = _inputs(SHAPES["2d"], seed=14)
    got = F.rms_norm(torch.from_numpy(x), None, EPS).numpy()
    want = _f32(_rms_norm_reference(jnp.asarray(x), epsilon=EPS))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_auto_cast_runs_it_in_f32():
    x, w, _ = _inputs((4, 32), seed=15)
    xt = torch.from_numpy(x).bfloat16()
    wt = torch.from_numpy(w)
    with pt.auto_cast(level="O1", dtype="bfloat16"):
        got = F.rms_norm(xt, wt, EPS)
    assert got.dtype == torch.float32
    assert torch.equal(got, F.rms_norm(xt.float(), wt, EPS))


def test_layer_holds_one_weight_at_one():
    norm = pt.nn.RMSNorm(48, 1e-5, device="cpu")
    assert [n for n, _ in norm.named_parameters()] == ["weight"]
    assert torch.equal(norm.weight.detach(), torch.ones(48))
    assert norm.weight.requires_grad
    bf = pt.nn.RMSNorm(48, device="cpu", dtype=torch.bfloat16)
    assert bf.weight.dtype == torch.bfloat16
    with pytest.raises(NotImplementedError, match="ROADMAP item .nn."):
        pt.nn.RMSNorm(48, weight_attr=object(), device="cpu")


def test_llama_norms_are_the_layer():
    from paddle_tpu_torch.models.llama import LlamaRMSNorm
    m = pt.LlamaForCausalLM(pt.llama_tiny_config(num_hidden_layers=1),
                            device="cpu")
    assert LlamaRMSNorm is pt.nn.RMSNorm
    assert isinstance(m.model.norm, pt.nn.RMSNorm)
    assert isinstance(m.model.layers[0].input_layernorm, pt.nn.RMSNorm)


def test_plain_versions_count_no_launch_and_reject_what_the_kernel_does_not():
    reset_launch_counts()
    x = torch.randn(3, 16, requires_grad=True)
    w = torch.ones(16, requires_grad=True)
    F.rms_norm(x, w).sum().backward()
    assert LAUNCHES["rms_norm_fwd"] == LAUNCHES["rms_norm_bwd"] == 0
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        F.rms_norm(x.double(), w.double())
    with pytest.raises(ValueError, match="contiguous last axis"):
        F.rms_norm(torch.randn(16, 3).t(), w)
    with pytest.raises(ValueError, match=r"w \[f\]"):
        F.rms_norm(x, torch.ones(8))
    with pytest.raises(ValueError, match="cuda tensors"):
        trn.rms_norm_fwd(x.detach(), w.detach(), EPS)


def test_strided_rows_read_through_a_view():
    """A [..., f] view with a contiguous last axis (a column slice) gives
    what its contiguous copy gives."""
    base = torch.randn(6, 40)
    x = base[:, 4:36]
    w = torch.randn(32)
    assert torch.equal(F.rms_norm(x, w), F.rms_norm(x.contiguous(), w))


@pytest.mark.parametrize("rows,f", [(2048, 2048), (8192, 768), (37, 4100),
                                    (1, 5), (300, 256), (1, 2048),
                                    (3, 8192), (10 ** 6, 64)])
def test_dw_chunks_cover_the_rows_once(rows, f):
    chunks, per = trn.dw_chunks(rows, f)
    assert 1 <= chunks <= 65535 and per >= 1
    assert (chunks - 1) * per < rows <= chunks * per
    assert trn.dw_chunks(rows, f) == (chunks, per)


def _dw_in_chunk_order(x2, w, g2, eps):
    """The CUDA backward's dw order in plain PyTorch (f32): per chunk of
    ``dw_chunks``, the rows' ``dy · x̂`` (each product rounded) added in
    row order from zero; then the chunks' partials added in chunk order.
    Returns ``(dw, chunks, rows_per_chunk)``."""
    rows, f = x2.shape
    _, rstd = trn.rms_norm_fwd_reference(x2, w, eps)
    prod = g2 * (x2 * rstd)
    chunks, per = trn.dw_chunks(rows, f)
    dw = torch.zeros(f)
    for c in range(chunks):
        part = torch.zeros(f)
        for r in range(c * per, min((c + 1) * per, rows)):
            part = part + prod[r]
        dw = dw + part
    return dw, chunks, per


#: the llama_1b and llama_125m norms with fewer rows (several rows per
#: chunk, many chunks), and the ragged shape (the wide kernel) and a
#: 1b-wide one with fewer rows than the backward aims blocks at (a chunk
#: per row)
DW_SHAPES = {"1b_rows": (600, 2048), "125m_rows": (600, 768),
             "ragged": (37, 4100), "rows_lt_chunks": (5, 2048)}


@pytest.mark.parametrize("shape", sorted(DW_SHAPES))
def test_dw_in_chunk_order_matches_the_pallas_kernel(shape):
    """The kernel's dw summation order (within chunks, then across them)
    against the Pallas kernel's dw under ``jax.grad`` in interpret mode,
    f32: max|diff| <= 1e-5 x max|Pallas| (hundreds of terms summed in
    another order, so a column that cancels to near zero carries the
    rounding of its large terms; the card tests' form)."""
    rows, f = DW_SHAPES[shape]
    x, w, g = _inputs((rows, f), seed=rows + f)
    got, chunks, per = _dw_in_chunk_order(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(g), EPS)
    assert (chunks - 1) * per < rows <= chunks * per
    if rows <= trn._SMS * trn._BWD_BLOCKS_PER_SM:
        assert (chunks, per) == (rows, 1)
    else:
        assert 1 < chunks < rows
    pallas = lambda a, b: pallas_rms_norm(  # noqa: E731
        a, b, EPS, block_rows=1 if rows % 8 else 8, interpret=True)
    _, _, want, _ = _jax(pallas, x, w, g, jnp.float32)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
