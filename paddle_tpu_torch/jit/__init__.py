"""The training step — counterpart of ``paddle_tpu.jit.TrainStep``.

The reference traces forward, backward and optimizer into one XLA
executable. PyTorch runs eagerly, so here a step is the same sequence
run op by op: clear the gradients, run ``loss_fn`` (the forward), call
``backward()``, step the optimizer. The kernels on the way are the
port's hand-written ones (flash attention and rms_norm forward and
backward, fused AdamW). The step returns the loss tensor without
waiting for the device.

``accumulate_steps=K`` splits the batch into K equal micro-batches
along axis 0 and runs forward and backward on each; autograd adds each
micro-batch's gradients in place into the optimizer's flat gradient
buckets (never a new ``.grad``), the sum is divided by K in place, and
one optimizer step follows: the update of one step on the K× batch with
a mean loss, as the reference's scanned accumulator computes it. The
step returns the mean of the K losses. ``remat_policy`` pins the remat
policy for the step (``nn.scan_stack.remat_policy_scope``); None defers
to ``FLAGS_remat_policy`` and the model's ``config.remat``.

Not ported yet, each raising ``NotImplementedError``: CUDA-graph
capture of the whole step (ROADMAP item 'The compiled
``jit.TrainStep``'), GSPMD ``sharding`` (queue A's
distributed item), ``capture_hlo`` (no XLA here; the same
item).
"""
from __future__ import annotations

import warnings
from contextlib import nullcontext

import torch

from ..nn.scan_stack import REMAT_POLICIES, remat_policy_scope


class TrainStep:
    """``step = TrainStep(model, loss_fn, optimizer); loss = step(*batch)``
    where ``loss_fn(*batch)`` runs the model and returns a scalar loss."""

    def __init__(self, model, loss_fn, optimizer, accumulate_steps=1,
                 remat_policy=None, sharding=None, capture_hlo=False):
        self.accumulate_steps = int(accumulate_steps)
        if self.accumulate_steps < 1:
            raise ValueError("accumulate_steps must be >= 1")
        if remat_policy is not None and remat_policy not in REMAT_POLICIES:
            raise ValueError(
                f"remat_policy must be one of {REMAT_POLICIES} or None, "
                f"got {remat_policy!r}")
        if sharding is not None:
            raise NotImplementedError("TrainStep(sharding=...) comes with "
                                      "the distributed item of ROADMAP "
                                      "queue A")
        if capture_hlo:
            raise NotImplementedError("TrainStep(capture_hlo=True) has no "
                                      "counterpart without XLA (ROADMAP item "
                                      "'The compiled jit.TrainStep')")
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.remat_policy = remat_policy
        self._warned_ragged = False

    def _micro_batches(self, batch):
        """K when every batch tensor splits into K equal micro-batches
        along axis 0; 1 (with a one-time warning) for a ragged batch."""
        K = self.accumulate_steps
        if K == 1:
            return 1
        if any(True for _ in self.model.buffers()):
            raise RuntimeError(
                "TrainStep(accumulate_steps>1) cannot accumulate over a "
                "model with registered buffers: per-micro-batch buffer "
                "mutations have no single committed value. Use "
                "accumulate_steps=1 (or an outer accumulation loop) for "
                "buffer-mutating models.")
        if any(not b.shape or b.shape[0] % K for b in batch):
            if not self._warned_ragged:
                self._warned_ragged = True
                warnings.warn(
                    f"TrainStep(accumulate_steps={K}): batch axis 0 "
                    f"{[tuple(b.shape) for b in batch]} is not divisible by "
                    f"{K}; running this batch without accumulation "
                    "(expected for a drop_last=False tail batch — if every "
                    "batch hits this, fix the batch size)", stacklevel=3)
            return 1
        return K

    def __call__(self, *batch):
        K = self._micro_batches(batch)
        policy = remat_policy_scope(self.remat_policy) \
            if self.remat_policy else nullcontext()
        with policy:
            self.optimizer.clear_grad()
            if K == 1:
                loss = self.loss_fn(*batch)
                loss.backward()
                loss = loss.detach()
            else:
                loss = None
                for mb in zip(*(b.chunk(K) for b in batch)):
                    micro = self.loss_fn(*mb)
                    micro.backward()
                    micro = micro.detach().float()
                    loss = micro if loss is None else loss + micro
                self._divide_grads(K)
                loss = loss / K
            self.optimizer.step()
        return loss

    def _divide_grads(self, K):
        """The accumulated gradient sums divided by K, in place: one op
        per flat bucket of the fused optimizer (the parameters' ``.grad``
        are views of them)."""
        eng = self.optimizer._fused_engine
        with torch.no_grad():
            for b in eng.buckets if eng is not None else ():
                b.flat_g.div_(K)


__all__ = ["TrainStep"]
