"""Llama-2 family on PyTorch — counterpart of ``paddle_tpu/models/llama.py``.

Parameter names and shapes are the reference's, so a ``paddle_tpu``
state dict moves over as numpy arrays (:func:`load_numpy_state_dict`)
and both packages compute the same function.

Layout choice: Paddle's ``Linear.weight`` is ``[in, out]`` and the LM
head is ``[hidden, vocab]``. The port KEEPS that layout and computes
``x @ w`` (``generation._wmat``), so loading is a plain copy with no
transpose, and the serving bodies read the same arrays as the model.

Parameters are trainable: ``forward(input_ids, labels)`` returns the
causal LM loss through autograd, with attention in the hand-written
flash kernels (``nn.functional.attention``) and every norm in the
hand-written rms_norm kernels (``nn.RMSNorm``). Under
``LlamaConfig(remat=True)`` or a ``remat_policy`` other than ``none``
each decoder layer is recomputed whole in backward
(``distributed.fleet.recompute``), as the reference's unrolled path
does; the selective ``dots_saveable`` policy belongs to the scanned
``LayerStack`` (ROADMAP item 'nn'). Serving reads the same parameters
through ``generation.extract_params`` (detached views) under
``torch.inference_mode``, so it records no graph, and normalises with
the serving bodies' own ``generation._rms_norm``.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from .. import nn as pnn
from ..core.place import resolve_device
from ..distributed.fleet.recompute import recompute
from ..nn import functional as F
from ..nn.scan_stack import effective_remat_policy
from .generation import _rope, _wmat


@dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    #: std of the N(0, std) init of every Linear/Embedding weight
    initializer_range: float = 0.02
    tie_word_embeddings: bool = False
    #: the reference picks its Pallas flash kernel with this; the port
    #: runs its flash kernel either way (both spellings compute the same
    #: attention), and keeps the field so configs move over unchanged
    use_flash_attention: bool = True
    #: > 0: the training loss uses the chunked matmul + CE head (full
    #: [tokens, vocab] logits never held; forward returns (None, loss))
    loss_chunk_size: int = 0
    #: recompute each decoder layer in backward (maps to the ``full``
    #: remat policy unless ``FLAGS_remat_policy`` names another)
    remat: bool = False

    def __post_init__(self):
        if self.num_attention_heads <= 0 or \
                self.hidden_size % self.num_attention_heads != 0:
            raise ValueError(
                f"LlamaConfig: hidden_size ({self.hidden_size}) must be "
                f"divisible by num_attention_heads "
                f"({self.num_attention_heads})")
        if self.num_key_value_heads <= 0 or \
                self.num_attention_heads % self.num_key_value_heads != 0:
            raise ValueError(
                f"LlamaConfig: num_attention_heads "
                f"({self.num_attention_heads}) must be divisible by "
                f"num_key_value_heads ({self.num_key_value_heads})")

    @property
    def head_dim(self):
        return self.hidden_size // self.num_attention_heads


def llama2_7b_config():
    return LlamaConfig()


def llama2_13b_config():
    return LlamaConfig(hidden_size=5120, intermediate_size=13824,
                       num_hidden_layers=40, num_attention_heads=40,
                       num_key_value_heads=40)


def llama_tiny_config(**kw):
    """Tiny config for tests."""
    base = dict(vocab_size=512, hidden_size=128, intermediate_size=256,
                num_hidden_layers=2, num_attention_heads=4,
                num_key_value_heads=4, max_position_embeddings=256)
    base.update(kw)
    return LlamaConfig(**base)


class _Weight(nn.Module):
    """A module holding one ``weight`` parameter, created uninitialised
    on its device (the model draws every value once, in order)."""

    def __init__(self, *shape, device, dtype):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(*shape, device=device, dtype=dtype))


class Linear(_Weight):
    """Bias-free projection with a Paddle-layout ``[in, out]`` weight."""

    def __init__(self, in_features, out_features, *, device, dtype):
        super().__init__(in_features, out_features, device=device,
                         dtype=dtype)

    def forward(self, x):
        return _wmat(x, self.weight)


class Embedding(_Weight):
    def __init__(self, num, dim, *, device, dtype):
        super().__init__(num, dim, device=device, dtype=dtype)

    def forward(self, ids):
        return self.weight[ids]


LlamaRMSNorm = pnn.RMSNorm


class LlamaAttention(nn.Module):
    """GQA attention with rope; ``[b, s, h, d]`` layout end to end."""

    def __init__(self, config, **kw):
        super().__init__()
        self.config = config
        h, hd = config.hidden_size, config.head_dim
        self.num_heads = config.num_attention_heads
        self.num_kv_heads = config.num_key_value_heads
        self.q_proj = Linear(h, self.num_heads * hd, **kw)
        self.k_proj = Linear(h, self.num_kv_heads * hd, **kw)
        self.v_proj = Linear(h, self.num_kv_heads * hd, **kw)
        self.o_proj = Linear(self.num_heads * hd, h, **kw)

    def forward(self, x, pos):
        b, s, _ = x.shape
        hd = self.config.head_dim
        theta = self.config.rope_theta
        q = _rope(self.q_proj(x).reshape(b, s, self.num_heads, hd), pos,
                  theta, hd)
        k = _rope(self.k_proj(x).reshape(b, s, self.num_kv_heads, hd), pos,
                  theta, hd)
        v = self.v_proj(x).reshape(b, s, self.num_kv_heads, hd)
        # GQA k/v keep their own head count: the kernel pairs query head
        # j with kv head j // group
        o, _ = F.flash_attention(q, k, v, causal=True)
        return self.o_proj(o.reshape(b, s, self.num_heads * hd))


class LlamaMLP(nn.Module):
    """SwiGLU MLP."""

    def __init__(self, config, **kw):
        super().__init__()
        h, i = config.hidden_size, config.intermediate_size
        self.gate_proj = Linear(h, i, **kw)
        self.up_proj = Linear(h, i, **kw)
        self.down_proj = Linear(i, h, **kw)

    def forward(self, x):
        return self.down_proj(torch.nn.functional.silu(self.gate_proj(x))
                              * self.up_proj(x))


class LlamaDecoderLayer(nn.Module):
    def __init__(self, config, **kw):
        super().__init__()
        eps = config.rms_norm_eps
        self.input_layernorm = LlamaRMSNorm(config.hidden_size, eps, **kw)
        self.self_attn = LlamaAttention(config, **kw)
        self.post_attention_layernorm = LlamaRMSNorm(config.hidden_size,
                                                     eps, **kw)
        self.mlp = LlamaMLP(config, **kw)

    def forward(self, h, pos):
        h = h + self.self_attn(self.input_layernorm(h), pos)
        return h + self.mlp(self.post_attention_layernorm(h))


class LlamaModel(nn.Module):
    def __init__(self, config, **kw):
        super().__init__()
        self.config = config
        self.embed_tokens = Embedding(config.vocab_size, config.hidden_size,
                                      **kw)
        self.layers = nn.ModuleList(
            [LlamaDecoderLayer(config, **kw)
             for _ in range(config.num_hidden_layers)])
        self.norm = LlamaRMSNorm(config.hidden_size, config.rms_norm_eps,
                                 **kw)

    def forward(self, input_ids):
        b, s = input_ids.shape
        pos = torch.arange(s, device=input_ids.device).expand(b, s)
        h = self.embed_tokens(input_ids)
        remat = effective_remat_policy(self.config.remat) != "none"
        # a layer draws no random numbers: the recompute keeps no RNG
        # state (reading it is refused inside a CUDA graph capture)
        for layer in self.layers:
            h = recompute(layer, h, pos, preserve_rng_state=False) \
                if remat else layer(h, pos)
        return self.norm(h)


class LlamaForCausalLM(nn.Module):
    """Llama causal LM. ``device=None`` places it on the current CUDA
    device and raises without one; ``device="cpu"`` places it on the
    CPU. Weights are drawn on that device from ``generator`` (or the
    default generator of the device): every Linear/Embedding weight
    ~ N(0, initializer_range), norm scales at one — the reference's
    recipe, though not its random bits."""

    def __init__(self, config: LlamaConfig, *, device=None,
                 dtype=torch.float32, generator=None):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        kw = dict(device=device, dtype=dtype)
        self.model = LlamaModel(config, **kw)
        self.lm_head = None if config.tie_word_embeddings else \
            Linear(config.hidden_size, config.vocab_size, **kw)
        std = config.initializer_range
        with torch.no_grad():
            for name, p in self.named_parameters():
                if name.endswith("layernorm.weight") or \
                        name == "model.norm.weight":
                    p.fill_(1.0)
                else:
                    p.normal_(0.0, std, generator=generator)

    @property
    def device(self):
        return self.model.norm.weight.device

    def forward(self, input_ids, labels=None):
        """Full-sequence forward over ``input_ids [b, s]`` (causal,
        positions 0..s-1), as ``paddle_tpu``'s ``forward`` (:256-283):

        - no labels: logits ``[b, s, vocab]``;
        - labels with ``loss_chunk_size > 0``: ``(None, loss)`` from the
          chunked matmul + CE head (no logits are formed);
        - labels otherwise: ``(logits, loss)``.

        The loss is next-token cross entropy: position ``i`` predicts
        ``labels[:, i + 1]`` (mean over the ``b * (s - 1)`` targets)."""
        h = self.model(input_ids)
        c = self.config
        w = self.model.embed_tokens.weight if self.lm_head is None \
            else self.lm_head.weight
        if labels is not None and c.loss_chunk_size:
            loss = F.fused_linear_cross_entropy(
                h[:, :-1].reshape(-1, c.hidden_size), w,
                labels[:, 1:].reshape(-1), chunk_size=c.loss_chunk_size,
                transpose_weight=self.lm_head is None)
            return None, loss
        logits = h @ w.T if self.lm_head is None else self.lm_head(h)
        if labels is None:
            return logits
        loss = F.cross_entropy(logits[:, :-1].reshape(-1, c.vocab_size),
                               labels[:, 1:].reshape(-1), reduction="mean")
        return logits, loss

    def flops_per_token(self, seq_len, remat_policy=None):
        """Approximate training FLOPs per token, for MFU: ``6 N`` for
        the parameters' matrix products (forward and backward) plus
        ``12 L h s`` for attention, the reference's count. Under the
        ``full`` policy (``remat_policy``, else the resolved flag and
        ``config.remat``) backward runs the decoder forward again: ``+2 N``
        and a third of the attention term. ``dots_saveable`` adds nothing,
        as in the reference, whose scanned stack recomputes only the
        elementwise tail under it (the port's unrolled loop, like the
        reference's, recomputes whole layers)."""
        c = self.config
        n_params = sum(p.numel() for p in self.parameters())
        attn = 12 * c.num_hidden_layers * c.hidden_size * seq_len
        total = 6 * n_params + attn
        policy = remat_policy if remat_policy is not None \
            else effective_remat_policy(c.remat)
        if policy == "full":
            total += 2 * n_params + attn // 3
        return total


def load_numpy_state_dict(model: nn.Module, arrays: dict):
    """Copy ``{name: np.ndarray}`` (a ``paddle_tpu`` state dict moved as
    numpy: ``{k: np.asarray(v) for k, v in m.state_dict().items()}``)
    into ``model``'s parameters, converting to each parameter's dtype
    and device. Names and shapes must match exactly."""
    params = dict(model.named_parameters())
    missing = set(params) - set(arrays)
    extra = set(arrays) - set(params)
    if missing or extra:
        raise KeyError(f"state dict mismatch: missing {sorted(missing)}, "
                       f"unexpected {sorted(extra)}")
    with torch.no_grad():
        for name, p in params.items():
            a = np.asarray(arrays[name])
            if a.dtype.name == "bfloat16":       # ml_dtypes: torch cannot view it
                a = a.astype(np.float32)
            if tuple(a.shape) != tuple(p.shape):
                raise ValueError(f"{name}: shape {tuple(a.shape)} != "
                                 f"{tuple(p.shape)}")
            p.copy_(torch.from_numpy(np.array(a)))    # a writable copy
    return model


__all__ = ["LlamaConfig", "LlamaForCausalLM", "LlamaRMSNorm",
           "llama2_13b_config", "llama2_7b_config", "llama_tiny_config",
           "load_numpy_state_dict"]
