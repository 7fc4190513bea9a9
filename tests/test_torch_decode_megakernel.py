"""paddle_tpu_torch's decode megakernel module against
``paddle_tpu.kernels.decode_megakernel``.

The same numpy inputs (the reference's own fixture shapes: R 4, D 64,
H 4, Hkv 2, dh 16, kv_lens [5, 1, 9, 17]) go through the port's plain
layer body and through the reference's: its ``_reference_layer`` (the
jnp body the JAX engine runs off the TPU) in f32 within 1e-5, and its
Pallas kernel in interpret mode at the reference's own 1e-4. The whole
model step is held to the reference's ``fused_decode_model`` with the
fp ``append_fn`` and the int8 ``quant_append_fn``: hidden state, pools
and scales. The CUDA kernel itself is held to the plain version on the
card (``tests/test_torch_cuda_kernels.py``).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.kernels import decode_megakernel as jdmk
from paddle_tpu.quantization.low_bit import quantize_params as jquantize
from paddle_tpu.serving import engine as jengine
from paddle_tpu_torch.kernels import decode_megakernel as tdmk
from paddle_tpu_torch.quantization.low_bit import QuantizedWeight
from paddle_tpu_torch.serving import engine as tengine

KW = dict(eps=1e-6, theta=10000.0, num_heads=4)


def _fixture(seed=0, R=4, D=64, H=4, Hkv=2, dh=16, F=96, PPS=6, ps=4, P=12):
    """numpy arrays of the reference's ``_layer_fixture``."""
    rng = np.random.default_rng(seed)

    def arr(*s):
        return rng.standard_normal(s).astype(np.float32) * 0.3

    layer = {"ln1": arr(D) + 1.0, "ln2": arr(D) + 1.0,
             "q": arr(D, H * dh), "k": arr(D, Hkv * dh),
             "v": arr(D, Hkv * dh), "o": arr(H * dh, D),
             "gate": arr(D, F), "up": arr(D, F), "down": arr(F, D)}
    h = arr(R, D)
    Kp, Vp = arr(Hkv, P, ps, dh), arr(Hkv, P, ps, dh)
    tbls = rng.integers(1, P, (R, PPS)).astype(np.int32)
    kv_lens = np.asarray([5, 1, 9, 17], np.int32)
    return layer, h, Kp, Vp, tbls, kv_lens


def _int8_pages(Kp, Vp, seed=3):
    """The reference test's int8 pages: positive scales per (head, page)."""
    rng = np.random.default_rng(seed)
    Hkv, P = Kp.shape[:2]
    ks = (np.abs(rng.standard_normal((Hkv, P))) * 0.01 + 0.005) \
        .astype(np.float32)
    vs = (np.abs(rng.standard_normal((Hkv, P))) * 0.01 + 0.005) \
        .astype(np.float32)
    Kq = np.clip(np.round(Kp / ks[:, :, None, None]), -127, 127) \
        .astype(np.int8)
    Vq = np.clip(np.round(Vp / vs[:, :, None, None]), -127, 127) \
        .astype(np.int8)
    return Kq, Vq, ks, vs


def _both_layers(layer, quant_w):
    """The reference's layer dict (jnp, int8-quantized by its own
    ``quantize_params`` when asked) and the port's, byte for byte."""
    jl = {k: jnp.asarray(v) for k, v in layer.items()}
    if quant_w:
        D = layer["ln1"].shape[0]
        jl = jquantize({"embed": jnp.zeros((8, D), jnp.float32),
                        "norm": jnp.ones((D,), jnp.float32),
                        "layers": [jl]}, "weight_only_int8")["layers"][0]
    tl = {}
    for k, v in jl.items():
        if hasattr(v, "qdata"):
            tl[k] = QuantizedWeight.from_numpy(np.asarray(v.qdata),
                                               np.asarray(v.scale), v.bits,
                                               v.rows)
        else:
            tl[k] = torch.from_numpy(np.asarray(v).copy())
    return jl, tl


#: contract -> (int8 weights, int8 pages, self_kv)
CONTRACTS = {"fp_self_kv": (False, False, True),
             "fp_pages": (False, False, False),
             "int8_w": (True, False, True),
             "int8_kv": (False, True, False)}


def _case(contract):
    quant_w, quant_kv, self_kv = CONTRACTS[contract]
    layer, h, Kp, Vp, tbls, kv_lens = _fixture()
    ks = vs = None
    if quant_kv:
        Kp, Vp, ks, vs = _int8_pages(Kp, Vp)
    jl, tl = _both_layers(layer, quant_w)
    common = (h, Kp, Vp, tbls, kv_lens)
    jargs = [jnp.asarray(a) for a in common]
    targs = [torch.from_numpy(a.copy()) for a in common]
    jsc = dict(k_scales=None if ks is None else jnp.asarray(ks),
               v_scales=None if vs is None else jnp.asarray(vs))
    tsc = dict(k_scales=None if ks is None else torch.from_numpy(ks),
               v_scales=None if vs is None else torch.from_numpy(vs))
    return self_kv, (jl, jargs, jsc), (tl, targs, tsc)


def _assert_outputs(got, want, tol):
    for a, b in zip(got, want):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=tol,
                                       atol=tol)


@pytest.mark.parametrize("contract", sorted(CONTRACTS))
def test_plain_layer_matches_jax_reference_layer(contract):
    self_kv, (jl, jargs, jsc), (tl, targs, tsc) = _case(contract)
    want = jdmk._reference_layer(jl, *jargs, self_kv=self_kv, **jsc, **KW)
    got = tdmk.fused_decode_layer(tl, *targs, self_kv=self_kv, **tsc, **KW)
    assert got[0].dtype == torch.float32 and got[0].shape == (4, 64)
    assert (got[1] is None) == (not self_kv)
    _assert_outputs(got, want, 1e-5)


@pytest.mark.parametrize("contract", sorted(CONTRACTS))
def test_plain_layer_matches_jax_pallas_kernel_interpret(contract):
    """The reference's own kernel-vs-fallback tolerance (1e-4)."""
    self_kv, (jl, jargs, jsc), (tl, targs, tsc) = _case(contract)
    want = jdmk.fused_decode_layer(jl, *jargs, self_kv=self_kv,
                                   interpret=True, **jsc, **KW)
    got = tdmk.fused_decode_layer(tl, *targs, self_kv=self_kv, **tsc, **KW)
    _assert_outputs(got, want, 1e-4)


def _model_case(pool, L=3):
    """L layers over per-layer pools, and each row's append slot: the
    page and offset of position ``kv_len - 1``."""
    layers, Kps, Vps = [], [], []
    for li in range(L):
        layer, h, Kp, Vp, tbls, kv_lens = _fixture(seed=li)
        layers.append(layer)
        Kps.append(Kp)
        Vps.append(Vp)
    _, h, _, _, tbls, kv_lens = _fixture(seed=0)
    # distinct write pages per row (the copy-on-write guarantee)
    tbls = np.asarray([[1, 2, 0, 0, 0, 0], [3, 0, 0, 0, 0, 0],
                       [4, 5, 6, 0, 0, 0], [7, 8, 9, 10, 11, 0]], np.int32)
    pos = kv_lens - 1
    page = tbls[np.arange(4), pos // 4].astype(np.int32)
    off = (pos % 4).astype(np.int32)
    scales = None
    if pool == "int8":
        qs = [_int8_pages(k, v, seed=3 + i)
              for i, (k, v) in enumerate(zip(Kps, Vps))]
        Kps, Vps = [q[0] for q in qs], [q[1] for q in qs]
        scales = (np.stack([q[2] for q in qs]), np.stack([q[3] for q in qs]))
    return layers, h, np.stack(Kps), np.stack(Vps), scales, tbls, kv_lens, \
        page, off


@pytest.mark.parametrize("pool", ["fp", "int8"])
def test_fused_decode_model_matches_jax(pool):
    """Three stacked layers through the reference's scan and the port's
    layer loop, each with the caller's append callback: the hidden state,
    the pools and (int8) the scales."""
    layers, h, Kst, Vst, scales, tbls, kv_lens, page, off = _model_case(pool)
    ps, live = 4, np.ones(4, bool)
    jls, tls = zip(*(_both_layers(lyr, False) for lyr in layers))
    jstack = jdmk.stack_layer_params(list(jls))
    tstack = tdmk.stack_layer_params(list(tls))
    jp, jo, jlive = jnp.asarray(page), jnp.asarray(off), jnp.asarray(live)
    tp, to = torch.from_numpy(page.copy()), torch.from_numpy(off.copy())
    tlive = torch.from_numpy(live.copy())
    if pool == "fp":
        def japp(Kp, Vp, kc, vc):
            slot = jp * ps + jo
            Hkv, npg, _, d = Kp.shape
            Kp = Kp.reshape(Hkv, npg * ps, d).at[:, slot] \
                .set(jnp.transpose(kc, (1, 0, 2))).reshape(Kp.shape)
            Vp = Vp.reshape(Hkv, npg * ps, d).at[:, slot] \
                .set(jnp.transpose(vc, (1, 0, 2))).reshape(Vp.shape)
            return Kp, Vp

        def tapp(Kp, Vp, kc, vc):
            slot = (tp * ps + to).long()
            Hkv, npg, _, d = Kp.shape
            Kp.view(Hkv, npg * ps, d)[:, slot] = kc.transpose(0, 1)
            Vp.view(Hkv, npg * ps, d)[:, slot] = vc.transpose(0, 1)
            return Kp, Vp

        want = jdmk.fused_decode_model(
            jstack, jnp.asarray(h), jnp.asarray(Kst), jnp.asarray(Vst),
            jnp.asarray(tbls), jnp.asarray(kv_lens), self_kv=True,
            append_fn=japp, **KW)
        got = tdmk.fused_decode_model(
            tstack, torch.from_numpy(h), torch.from_numpy(Kst.copy()),
            torch.from_numpy(Vst.copy()), torch.from_numpy(tbls),
            torch.from_numpy(kv_lens), self_kv=True, append_fn=tapp, **KW)
        assert got[3] is None and got[4] is None
    else:
        def jqapp(Kp, Ks, Vp, Vs, kc, vc):
            Kp, Ks = jengine._quantized_append(
                Kp, Ks, jnp.transpose(kc, (1, 0, 2)), jp, jo, ps, jlive)
            Vp, Vs = jengine._quantized_append(
                Vp, Vs, jnp.transpose(vc, (1, 0, 2)), jp, jo, ps, jlive)
            return Kp, Ks, Vp, Vs

        def tqapp(Kp, Ks, Vp, Vs, kc, vc):
            tengine._quantized_append(Kp, Ks, kc.transpose(0, 1), tp, to,
                                      ps, tlive)
            tengine._quantized_append(Vp, Vs, vc.transpose(0, 1), tp, to,
                                      ps, tlive)
            return Kp, Ks, Vp, Vs

        want = jdmk.fused_decode_model(
            jstack, jnp.asarray(h), jnp.asarray(Kst), jnp.asarray(Vst),
            jnp.asarray(tbls), jnp.asarray(kv_lens), self_kv=False,
            k_scales=jnp.asarray(scales[0]), v_scales=jnp.asarray(scales[1]),
            quant_append_fn=jqapp, **KW)
        got = tdmk.fused_decode_model(
            tstack, torch.from_numpy(h), torch.from_numpy(Kst.copy()),
            torch.from_numpy(Vst.copy()), torch.from_numpy(tbls),
            torch.from_numpy(kv_lens), self_kv=False,
            k_scales=torch.from_numpy(scales[0].copy()),
            v_scales=torch.from_numpy(scales[1].copy()),
            quant_append_fn=tqapp, **KW)
    # 1e-5 of the largest value: h reaches ~50 after three layers of
    # 0.3-scaled weights, and f32 sums run in another order
    ref = np.asarray(want[0])
    np.testing.assert_allclose(got[0].numpy(), ref, rtol=1e-5,
                               atol=1e-5 * max(1.0, np.abs(ref).max()))
    assert got[1].shape == Kst.shape
    for a, b in zip(got[1:3], want[1:3]):
        if pool == "fp":
            b = np.asarray(b)
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-5,
                                       atol=1e-5 * max(1.0, np.abs(b).max()))
        else:       # one int8 step: K/V computed in another order
            assert np.abs(a.numpy().astype(int)
                          - np.asarray(b).astype(int)).max() <= 1
    if pool == "int8":
        for a, b in zip(got[3:], want[3:]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5)


@pytest.mark.parametrize("pool", ["fp", "int8"])
def test_fused_decode_model_append_at_equals_the_callbacks(pool):
    """The data form of the pool write (``append_at``, the kernel's) does
    what the engine's callbacks do, per-layer lists in place; a dead row
    (page 0) writes only the null page. ``appended`` records each layer's
    K/V."""
    layers, h, Kst, Vst, scales, tbls, kv_lens, page, off = _model_case(pool)
    tls = [_both_layers(lyr, False)[1] for lyr in layers]
    page = page.copy()
    page[1] = 0                                      # a dead row
    live = page != 0
    tp, to = torch.from_numpy(page), torch.from_numpy(off.copy())
    tlive = torch.from_numpy(live)
    L, ps = len(layers), 4
    runs = []
    for form in ("callback", "append_at"):
        K = [torch.from_numpy(k.copy()) for k in Kst]
        V = [torch.from_numpy(v.copy()) for v in Vst]
        kw = dict(KW)
        if pool == "int8":
            kw.update(self_kv=False,
                      k_scales=[torch.from_numpy(s.copy()) for s in scales[0]],
                      v_scales=[torch.from_numpy(s.copy()) for s in scales[1]])
        rec = torch.zeros((L, 2, 4, 2, 16))
        if form == "append_at":
            kw.update(append_at=(tp, to), appended=rec)
        elif pool == "fp":
            def tapp(Kp, Vp, kc, vc):
                slot = (tp * ps + to).long()
                Kp.view(2, -1, 16)[:, slot] = kc.transpose(0, 1)
                Vp.view(2, -1, 16)[:, slot] = vc.transpose(0, 1)
                return Kp, Vp
            kw.update(append_fn=tapp)
        else:
            def tqapp(Kp, Ks, Vp, Vs, kc, vc):
                tengine._quantized_append(Kp, Ks, kc.transpose(0, 1), tp, to,
                                          ps, tlive)
                tengine._quantized_append(Vp, Vs, vc.transpose(0, 1), tp, to,
                                          ps, tlive)
                return Kp, Ks, Vp, Vs
            kw.update(quant_append_fn=tqapp)
        out = tdmk.fused_decode_model(tls, torch.from_numpy(h), K, V,
                                      torch.from_numpy(tbls),
                                      torch.from_numpy(kv_lens), **kw)
        assert out[1] is K or out[1][0] is K[0]     # lists updated in place
        runs.append((out, rec))
    (a, _), (b, rec) = runs
    assert torch.equal(a[0], b[0])
    for x, y in zip(a[1:], b[1:]):
        if x is not None:
            for xi, yi in zip(x, y):
                assert torch.equal(xi, yi)
    assert rec[:, :, live].abs().sum() > 0
    # the recorded K of the last layer sits in its slot
    if pool == "fp":
        r = 0
        slot = b[1][L - 1][:, page[r], off[r]]
        assert torch.equal(slot, rec[L - 1, 0, r])


def test_stack_layer_params_slices_back_to_each_layer():
    layers = [_fixture(seed=s)[0] for s in range(3)]
    for quant in (False, True):
        tls = [_both_layers(lyr, quant)[1] for lyr in layers]
        st = tdmk.stack_layer_params(tls)
        for i, lyr in enumerate(tdmk._unstack_layers(st)):
            for k, v in lyr.items():
                if isinstance(v, QuantizedWeight):
                    assert torch.equal(v.qdata, tls[i][k].qdata)
                    assert torch.equal(v.scale, tls[i][k].scale)
                    assert (v.bits, v.rows) == (tls[i][k].bits,
                                                tls[i][k].rows)
                else:
                    assert torch.equal(v, tls[i][k])
    with pytest.raises(ValueError):
        tdmk.stack_layer_params([])


def test_rope_tables_match_jax():
    kv_lens = np.asarray([1, 5, 17, 633], np.int32)
    jc, js = jdmk._rope_tables(jnp.asarray(kv_lens), 10000.0, 128)
    tc, ts = tdmk._rope_tables(torch.from_numpy(kv_lens), 10000.0, 128)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6,
                               atol=1e-6)


def test_mode_reports_the_body_that_runs():
    _, tl = _both_layers(_fixture()[0], False)
    assert tdmk.megakernel_mode(tl, "cpu") == "plain"
    assert tdmk.megakernel_mode(tl, "cuda") == "cuda"
    int4 = dict(tl)
    from paddle_tpu_torch.quantization.low_bit import quantize_weight
    int4["q"] = quantize_weight(tl["q"], "weight_only_int4")
    assert tdmk.megakernel_mode(int4, "cuda") == "plain"
    assert tdmk.megakernel_fallback_tripped() is False
    assert tdmk._weights_kernel_ready(tl) == "fp"
    assert tdmk._weights_kernel_ready(int4) is None


def test_contract_errors_match_the_reference():
    self_kv, _, (tl, targs, _) = _case("fp_self_kv")
    with pytest.raises(ValueError, match="together"):
        tdmk.fused_decode_layer(tl, *targs, k_scales=torch.ones(2, 12), **KW)
    h, Kp, Vp, tbls, kv_lens = targs
    with pytest.raises(ValueError, match="append"):
        tdmk.fused_decode_model([tl], h, [Kp], [Vp], tbls, kv_lens, **KW)
    with pytest.raises(ValueError, match="scale"):
        tdmk.fused_decode_model([tl], h, [Kp], [Vp], tbls, kv_lens,
                                self_kv=False, **KW)


def test_k_split_keeps_the_grid_busy_with_bounded_chunks():
    # the 7B phases in strips of 512 columns (bf16 and int8 weights) on a
    # 132-block grid, in k tiles of 32 rows, chunks bounded by the x
    # window at 8 rows (129 tiles), and of 256 columns in 64-row tiles
    for (bk, win), strips in (((32, 129), (24, 8, 44, 8)),
                              ((64, 64), (48, 16, 86, 16))):
        for ntiles, K in zip(strips, (4096, 4096, 4096, 11008)):
            kt = -(-K // bk)
            ks = tdmk._k_split(ntiles, kt, 132, win)
            assert -(-kt // ks) <= win
            units = ntiles * ks
            assert units / (-(-units // 132) * 132) >= 0.9
            assert ks <= kt                          # no empty chunk
    assert tdmk._k_split(1, 9, 132, 129) <= 9
    assert tdmk._k_split(16, 344, 132, 20) >= 18     # bounded chunks first


@pytest.mark.parametrize("quant_w", [False, True], ids=["fp_w", "int8_w"])
@pytest.mark.parametrize("pool", ["fp", "int8"])
def test_layer_scope_append_at_equals_the_old_burst_sequence(pool, quant_w):
    """A layer-scope burst step is ``fused_decode_model([lyr], ...,
    append_at=...)`` (the kernel writes the pool): on the CPU it leaves h,
    the pages and the scales bitwise equal to the sequence the engine ran
    before, with a dead row on the null page. fp pool: the layer with
    ``self_kv`` then the slot scatter; int8 pool: the norm, k/v
    projections and rope, two ``_quantized_append`` and the layer over the
    appended pages."""
    from paddle_tpu_torch.models.generation import _rms_norm, _rope, _wmat
    layers, h, Kst, Vst, scales, tbls, kv_lens, page, off = _model_case(
        pool, L=1)
    lyr = _both_layers(layers[0], quant_w)[1]
    page = page.copy()
    page[1] = 0                                      # a dead row
    live = torch.from_numpy(page != 0)
    tp, to = torch.from_numpy(page), torch.from_numpy(off.copy())
    R, Hkv, ps, d = 4, 2, 4, 16
    th, tt, tk = (torch.from_numpy(a.copy()) for a in (h, tbls, kv_lens))
    quant = pool == "int8"
    runs = []
    for form in ("old", "append_at"):
        Kp, Vp = torch.from_numpy(Kst[0].copy()), torch.from_numpy(Vst[0].copy())
        Ks = Vs = None
        if quant:
            Ks = torch.from_numpy(scales[0][0].copy())
            Vs = torch.from_numpy(scales[1][0].copy())
        if form == "append_at":
            out = tdmk.fused_decode_model(
                [lyr], th, [Kp], [Vp], tt, tk, self_kv=not quant,
                k_scales=[Ks] if quant else None,
                v_scales=[Vs] if quant else None, append_at=(tp, to),
                rope_tables=tdmk._rope_tables(tk, KW["theta"], d), **KW)[0]
        elif quant:
            pos = tk - 1
            x = _rms_norm(th[None], lyr["ln1"], KW["eps"])[0]
            kc = _rope(_wmat(x, lyr["k"]).reshape(R, Hkv, d)[None],
                       pos[None], KW["theta"], d)[0]
            vc = _wmat(x, lyr["v"]).reshape(R, Hkv, d)
            tengine._quantized_append(Kp, Ks, kc.transpose(0, 1), tp, to, ps,
                                      live)
            tengine._quantized_append(Vp, Vs, vc.transpose(0, 1), tp, to, ps,
                                      live)
            out = tdmk.fused_decode_layer(lyr, th, Kp, Vp, tt, tk,
                                          self_kv=False, k_scales=Ks,
                                          v_scales=Vs, **KW)[0]
        else:
            out, kc, vc = tdmk.fused_decode_layer(lyr, th, Kp, Vp, tt, tk,
                                                  self_kv=True, **KW)
            slot = (tp * ps + to).long()
            Kp.view(Hkv, -1, d)[:, slot] = kc.transpose(0, 1)
            Vp.view(Hkv, -1, d)[:, slot] = vc.transpose(0, 1)
        runs.append((out, Kp, Vp, Ks, Vs))
    for a, b in zip(*runs):
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a, b)
    # the live rows' tokens went in: their slots moved
    kp0 = torch.from_numpy(Kst[0])
    assert not torch.equal(runs[1][1][:, page[0], off[0]],
                           kp0[:, page[0], off[0]])


@pytest.mark.parametrize("layers", [40, 80])
def test_device_tables_stay_cached_over_a_deep_layer_scope_burst(
        layers, monkeypatch):
    """A layer-scope burst takes a pointer table and a tensor-map table
    per layer and launch: over a 40- (13B) or 80-layer (70B) model every
    table is made in the first iteration and found in the cache after
    it, so no tensor map is encoded twice."""
    encoded = []

    class Lib:
        @staticmethod
        def decode_megakernel_encode(dt, qw, ptr, cols, rows, pitch, buf):
            encoded.append(ptr)
            return 0

    monkeypatch.setattr(tdmk, "_TABLES", type(tdmk._TABLES)())
    # no card here: the tables stay in host memory
    monkeypatch.setattr(torch.Tensor, "pin_memory", lambda self: self)
    dev = torch.device("cpu")
    key = (1, 0, 0)
    for it in range(3):
        for li in range(layers):
            base = (1 << 32) + (li << 16)
            ptrs = [base + 16 * j for j in range(20)]
            mats = [(base + 16 * j, 2, 4096, 4096) for j in range(7)]
            tdmk._pointer_table(ptrs, dev)
            tdmk._map_table(Lib, key, mats, dev)
        assert len(encoded) == 7 * layers, it
