"""Loss functionals — counterpart of the subset of ``paddle_tpu/nn/functional/loss.py`` that Llama training runs.

Both losses take integer labels with ``ignore_index`` and compute the
softmax in float32 whatever the autocast state (``cross_entropy`` is on
the autocast black list).
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0, name=None):
    """Softmax cross entropy of ``input [N, C]`` (f32 softmax) against
    integer ``label [N]``; ``reduction`` ``mean`` averages over the
    labels that are not ``ignore_index``, ``sum`` adds them."""
    if weight is not None or soft_label or not use_softmax or \
            label_smoothing or axis not in (-1, input.dim() - 1):
        raise NotImplementedError("cross_entropy: class weights, soft "
                                  "labels, label smoothing and other axes "
                                  "are not ported yet (ROADMAP item 'nn')")
    if reduction not in ("mean", "sum"):
        raise NotImplementedError(f"cross_entropy reduction {reduction!r} "
                                  f"is not ported yet (ROADMAP item 'nn')")
    logp = torch.log_softmax(input.float(), dim=-1)
    valid = label != ignore_index
    safe = torch.where(valid, label, torch.zeros_like(label)).long()
    loss = -logp.gather(-1, safe[..., None])[..., 0]
    total = torch.where(valid, loss, torch.zeros_like(loss)).sum()
    if reduction == "mean":
        return total / valid.sum().clamp_min(1)
    return total


def _chunk_loss(h, w, lbl, transpose_weight, ignore_index):
    """Summed token losses of one chunk; its logits live only here."""
    logits = h @ w.T if transpose_weight else h @ w
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    valid = lbl != ignore_index
    safe = torch.where(valid, lbl, torch.zeros_like(lbl)).long()
    gold = logits.gather(-1, safe[:, None])[:, 0]
    return torch.where(valid, lse - gold, torch.zeros_like(lse)).sum()


def fused_linear_cross_entropy(hidden, weight, label, chunk_size=1024,
                               transpose_weight=False, reduction="mean",
                               ignore_index=-100):
    """Chunked LM-head matmul + softmax cross entropy that never holds
    the full ``[tokens, vocab]`` logits: a loop over token chunks, each
    chunk's loss under ``torch.utils.checkpoint`` so backward recomputes
    its logits (the reference's ``jax.checkpoint`` inside ``lax.scan``).

    hidden ``[tokens, hidden]``; weight ``[hidden, vocab]``, or
    ``[vocab, hidden]`` with ``transpose_weight=True`` (the tied
    embedding); label ``[tokens]``. The head matmul follows autocast (in
    bf16 under O1, as the white list's ``matmul``); the softmax is f32.
    The recompute replays the forward's autocast state, so it yields the
    same logits; it keeps no RNG state (the chunk draws none, and reading
    it is refused inside a CUDA graph capture)."""
    if reduction not in ("mean", "sum"):
        raise ValueError(
            f"fused_linear_cross_entropy supports reduction='mean'|'sum', "
            f"got {reduction!r} (use cross_entropy for per-token losses)")
    n = hidden.shape[0]
    chunk = max(1, min(int(chunk_size), n))
    total = hidden.new_zeros((), dtype=torch.float32)
    for start in range(0, n, chunk):
        total = total + checkpoint(
            _chunk_loss, hidden[start:start + chunk], weight,
            label[start:start + chunk], bool(transpose_weight), ignore_index,
            use_reentrant=False, preserve_rng_state=False)
    if reduction == "mean":
        return total / (label != ignore_index).sum().clamp_min(1)
    return total


__all__ = ["cross_entropy", "fused_linear_cross_entropy"]
