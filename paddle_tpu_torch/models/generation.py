"""Forward and sampling math shared by the serving engine.

Counterpart of the subset of ``paddle_tpu/models/generation.py`` that
``LLMEngine`` runs: rope, rms_norm, the projection matmul, the logits
head, weight extraction and per-row sampling. The engine's ragged step
and the model's full-sequence forward both call these bodies, so the
two paths cannot drift apart.

Sampling randomness: the reference folds JAX keys
(``fold_in(base, seed, position, tag)``); torch cannot reproduce those
bits. The port keeps the reference's invariant instead: every draw is a
pure function of ``(engine seed, request seed, generation position,
tag)`` — one ``torch.Generator`` seeded per row from a splitmix64 mix of
the four — so a request's sampled tokens do not depend on what it is
batched with, how its prompt was chunked, or whether it was preempted.
Greedy rows take the argmax, exactly as the reference does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.flags import GLOBAL_FLAGS, define_flag
from ..quantization.low_bit import matmul


def _check_burst_tokens(v):
    if int(v) < 1:
        raise ValueError(
            f"FLAGS_decode_burst_tokens must be >= 1, got {v!r}")


define_flag("decode_burst_tokens", int, 1,
            "generation burst length: decode iterations run on the device "
            "per host dispatch. 1 (the default) is the per-token path",
            on_set=_check_burst_tokens)

_MEGAKERNEL_SCOPES = ("layer", "model")


def _check_megakernel_scope(v):
    if v not in _MEGAKERNEL_SCOPES:
        raise ValueError(
            f"FLAGS_decode_megakernel_scope must be one of "
            f"{_MEGAKERNEL_SCOPES}, got {v!r}")


define_flag("decode_megakernel_scope", str, "layer",
            "where the decode burst's layer loop lives: 'layer' (the "
            "default: one megakernel launch per layer) or 'model' (one "
            "launch per token for every layer)",
            on_set=_check_megakernel_scope)


def resolve_megakernel_scope(scope):
    """An explicit scope, or ``FLAGS_decode_megakernel_scope``."""
    if scope is None:
        scope = str(GLOBAL_FLAGS.get("decode_megakernel_scope"))
    _check_megakernel_scope(scope)
    return scope


_PREFILL_MEGAKERNEL_MODES = ("unfused", "fused")


def _check_prefill_megakernel(v):
    if v not in _PREFILL_MEGAKERNEL_MODES:
        raise ValueError(
            f"FLAGS_prefill_megakernel must be one of "
            f"{_PREFILL_MEGAKERNEL_MODES}, got {v!r}")


define_flag("prefill_megakernel", str, "unfused",
            "the ragged prefill chain's launch shape: 'unfused' (the "
            "default: the layer body op by op) or 'fused' (one prefill "
            "megakernel launch per layer)",
            on_set=_check_prefill_megakernel)


def resolve_prefill_megakernel(mode):
    """An explicit prefill launch shape, or ``FLAGS_prefill_megakernel``."""
    if mode is None:
        mode = str(GLOBAL_FLAGS.get("prefill_megakernel"))
    _check_prefill_megakernel(mode)
    return mode


# ---------------------------------------------------------------------------
# forward math
# ---------------------------------------------------------------------------

def _rope(x, pos, theta, head_dim):
    """x: [b, s, h, d]; pos: [b, s] absolute positions.

    Interleaved adjacent-pair convention (pairs ``(x[2i], x[2i+1])``
    rotate together), not rotate-half: the reference's training op and
    serving bodies both use it. Computed in f32, returned in x's dtype.
    """
    inv_freq = 1.0 / (theta ** (torch.arange(
        0, head_dim, 2, dtype=torch.float32, device=x.device) / head_dim))
    ang = pos.to(torch.float32)[..., None] * inv_freq         # [b, s, d/2]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1 = x[..., ::2].to(torch.float32)
    x2 = x[..., 1::2].to(torch.float32)
    o1 = x1 * cos - x2 * sin
    o2 = x2 * cos + x1 * sin
    return torch.stack([o1, o2], dim=-1).reshape(x.shape).to(x.dtype)


def _rms_norm(x, w, eps):
    """``x * rsqrt(mean(x^2) + eps)`` in f32, cast to x's dtype BEFORE
    the multiply by ``w`` — the reference's rounding order."""
    xf = x.to(torch.float32)
    var = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w


def _wmat(x, w):
    """Projection matmul. Weights keep the reference's ``[in, out]``
    layout, so a tensor is ``x @ w`` with no transpose anywhere; a
    ``QuantizedWeight`` goes to the dequant-matmul kernel."""
    return matmul(x, w)


def _logits(params, h, cfg):
    """The LM head: ``h @ lm_head`` ([hidden, vocab]), or the tied
    embedding ``h @ embed.T`` when the model has no separate head."""
    if "lm_head" in params:
        return h @ params["lm_head"]
    return h @ params["embed"].T


_LAYER_KEYS = {
    "ln1": "input_layernorm",
    "q": "self_attn.q_proj",
    "k": "self_attn.k_proj",
    "v": "self_attn.v_proj",
    "o": "self_attn.o_proj",
    "ln2": "post_attention_layernorm",
    "gate": "mlp.gate_proj",
    "up": "mlp.up_proj",
    "down": "mlp.down_proj",
}


def extract_params(model):
    """The LlamaForCausalLM weights as a plain dict of tensors (views of
    the module's parameters, no copies): ``embed``, ``norm``, ``layers``
    (one dict per layer keyed like the reference) and ``lm_head`` unless
    the embeddings are tied."""
    m = model.model
    layers = []
    for layer in m.layers:
        ent = {}
        for k, dotted in _LAYER_KEYS.items():
            obj = layer
            for part in dotted.split("."):
                obj = getattr(obj, part)
            ent[k] = obj.weight.detach()
        layers.append(ent)
    params = {"embed": m.embed_tokens.weight.detach(),
              "norm": m.norm.weight.detach(), "layers": layers}
    if model.lm_head is not None:
        params["lm_head"] = model.lm_head.weight.detach()
    return params


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------

def _masked_logits(logits, temps, top_ks, top_ps):
    """Per-row temperature scale, then top-k, then top-p masks, all as
    data-dependent ``where``s so rows with different knobs share one
    call. logits [b, V]; temps [b] (> 0); top_ks [b] (<= 0 disables,
    clamped to V); top_ps [b] (>= 1.0 disables). Disallowed entries are
    set to -1e30."""
    V = logits.shape[-1]
    logits = logits.to(torch.float32) / temps[:, None]
    k_eff = torch.clamp(torch.where(top_ks > 0, top_ks,
                                    torch.full_like(top_ks, V)), 1, V)
    desc = torch.sort(logits, dim=-1, descending=True).values
    kth = desc.gather(-1, (k_eff - 1).long()[:, None])
    logits = torch.where(logits < kth, torch.full_like(logits, -1e30),
                         logits)
    sorted_l = torch.sort(logits, dim=-1, descending=True).values
    cum = torch.cumsum(torch.softmax(sorted_l, -1), -1)
    cutoff_idx = torch.clamp((cum < top_ps[:, None]).sum(-1), max=V - 1)
    cutoff = sorted_l.gather(-1, cutoff_idx[:, None])
    apply_p = (top_ps < 1.0)[:, None]
    return torch.where(apply_p & (logits < cutoff),
                       torch.full_like(logits, -1e30), logits)


def sampling_probs(logits, temps, top_ks, top_ps):
    """Per-row sampling distribution [b, V]: a one-hot at the argmax for
    greedy rows (temp <= 0), the masked softmax otherwise."""
    logits = logits.to(torch.float32)
    greedy = F.one_hot(logits.argmax(-1), logits.shape[-1]) \
        .to(torch.float32)
    safe_t = torch.where(temps > 0, temps, torch.ones_like(temps))
    probs = torch.softmax(_masked_logits(logits, safe_t, top_ks, top_ps),
                          -1)
    return torch.where((temps > 0)[:, None], probs, greedy)


_MASK64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def stream_seed(base_seed, seed, position, tag) -> int:
    """The 63-bit generator seed of one draw: a splitmix64 chain over
    ``(engine seed, request seed, generation position, stream tag)``."""
    h = 0
    for v in (base_seed, seed, position, tag):
        h = _splitmix64(h ^ (int(v) & _MASK64))
    return h >> 1


def sample_rows(logits, temps, top_ks, top_ps, base_seed, seeds, positions,
                tag, hot=None):
    """Per-row sampling with per-row knobs and streams: greedy rows
    (temp <= 0) take the argmax; sampling rows draw from their masked
    distribution by the Gumbel-max rule, with noise from a generator
    seeded by :func:`stream_seed` (host ints ``seeds``/``positions`` per
    row). ``hot``: the sampling rows' indices as host ints, when the
    caller has them (then ``temps`` is never read back from the device).
    Returns int64 tokens [b] on the logits' device."""
    if hot is None:
        hot = [i for i, t in enumerate(temps.tolist()) if t > 0]
    if not hot:
        return logits.argmax(-1)
    u = torch.zeros(logits.shape, dtype=torch.float32, device=logits.device)
    draw_uniforms(u, base_seed, seeds, positions, tag, hot)
    return sample_rows_drawn(logits, temps, top_ks, top_ps, u)


def draw_uniforms(out, base_seed, seeds, positions, tag, rows):
    """The uniforms of :func:`sample_rows`, drawable ahead: for each row
    ``r`` of ``rows`` (host ints), ``out[r]`` (a ``[V]`` f32 row) takes
    ``torch.rand`` of the generator seeded by :func:`stream_seed` at the
    row's seed and position. The other rows of ``out`` keep whatever
    they hold."""
    for r in rows:
        g = torch.Generator(device=out.device)
        g.manual_seed(stream_seed(base_seed, seeds[r], positions[r], tag))
        torch.rand(out.shape[-1], generator=g, out=out[r])
    return out


def sample_rows_drawn(logits, temps, top_ks, top_ps, uniforms):
    """:func:`sample_rows` with its uniforms drawn ahead
    (:func:`draw_uniforms`): no host value is read, so a CUDA graph can
    hold it. Greedy rows (temp <= 0) take the argmax; sampling rows the
    Gumbel-max of their masked distribution with ``uniforms`` ``[b, V]``
    as the noise (rows are independent: a row's token is the one it
    takes sampled alone)."""
    tok = logits.argmax(-1)
    hot = temps > 0
    safe_t = torch.where(hot, temps, torch.ones_like(temps))
    logp = torch.log_softmax(
        _masked_logits(logits, safe_t, top_ks, top_ps), -1)
    gumbel = -torch.log(-torch.log(uniforms.clamp_min(1e-20)))
    return torch.where(hot, (logp + gumbel).argmax(-1), tok)


__all__ = ["draw_uniforms", "extract_params", "resolve_megakernel_scope",
           "resolve_prefill_megakernel", "sample_rows", "sample_rows_drawn",
           "sampling_probs", "stream_seed"]
