"""Optimizer base, Adam and AdamW — counterpart of the subset of ``paddle_tpu/optimizer/optimizer.py`` that Llama training runs.

Every step goes through the fused engine (``optimizer/fused.py``): one
update launch per (dtype, device) bucket, the hand-written fused-AdamW
kernel for CUDA buckets and its plain version for CPU ones
(``kernels/fused_adamw.py``). Paddle's defaults hold: AdamW decays every
parameter by ``weight_decay=0.01``, decoupled; Adam's weight decay is
coupled (added to the gradient); the step count ``t`` starts at 1.

Not ported yet, each raising ``NotImplementedError`` and each part of
ROADMAP item 'optimizer/': learning-rate schedulers and
``grad_clip``, AdamW's ``lr_ratio`` and ``apply_decay_param_fun`` (the
fused path's per-element aux vectors), regularizer objects as
``weight_decay``.
"""
from __future__ import annotations

import torch

from ..kernels.fused_adamw import adamw_scalars, fused_adamw
from .fused import FusedOptimizerEngine


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        if isinstance(learning_rate, bool) or \
                not isinstance(learning_rate, (int, float)):
            raise NotImplementedError(
                "only a float learning rate is ported; LRScheduler is not "
                "yet (ROADMAP item 'optimizer/')")
        if parameters is None:
            raise ValueError("parameters must be provided")
        if grad_clip is not None:
            raise NotImplementedError("grad_clip is not ported yet "
                                      "(ROADMAP item 'optimizer/')")
        if weight_decay is not None and not isinstance(weight_decay,
                                                       (int, float)):
            raise NotImplementedError("regularizer objects as weight_decay "
                                      "are not ported yet (ROADMAP item "
                                      "'optimizer/')")
        self._lr = float(learning_rate)
        self._weight_decay = float(weight_decay or 0.0)
        self._parameter_list = list(parameters)
        self._step_count = 0
        params = [p for p in self._parameter_list if p.requires_grad]
        self._fused_engine = FusedOptimizerEngine(self, params) \
            if params else None

    # -- lr --
    def get_lr(self):
        return self._lr

    # -- state --
    def _state_names(self):
        """Names of this optimizer's flat f32 state buffers."""
        return ()

    def state_dict(self):
        """``{"step": t, "p{i}.<state>": tensor}``, keyed by position in
        the parameter list (the port's parameters carry no Paddle
        names). The tensors are views of the live flat state."""
        out = {"step": self._step_count}
        if self._fused_engine is None:
            return out
        views = self._fused_engine.state_views()
        for i, p in enumerate(self._parameter_list):
            for name in self._state_names():
                if (p, name) in views:
                    out[f"p{i}.{name}"] = views[(p, name)]
        return out

    # -- step --
    @torch.no_grad()
    def step(self):
        self._step_count += 1
        if self._fused_engine is not None:
            self._fused_engine.step(self.get_lr(), self._step_count)

    def _step_scalars(self, lr, t):
        """The f32 scalars a bucket update of step ``t`` reads."""
        raise NotImplementedError

    def _fused_flat_update(self, bucket, lr, t, spans=None):
        raise NotImplementedError

    def clear_grad(self, set_to_zero=True):
        """Zero every gradient. The fused buckets keep their flat
        gradient buffers (one fill each): ``set_to_zero=False`` is
        accepted and zeroes them as well."""
        if self._fused_engine is not None:
            self._fused_engine.zero_grad()


class Adam(Optimizer):
    _decoupled = False

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=True,
                 name=None):
        """Moments are always f32 (``multi_precision``); ``lazy_mode`` is
        accepted for parity, gradients being dense."""
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)

    def _state_names(self):
        return ("moment1", "moment2")

    def _step_scalars(self, lr, t):
        return adamw_scalars(lr, t, self._beta1, self._beta2)

    def _fused_flat_update(self, bucket, lr, t, spans=None):
        """One fused-AdamW launch over the bucket: the kernel (or, on the
        CPU, its plain version) reads the step's ``[lr, 1 - beta1^t,
        1 - beta2^t]`` from the bucket's device ``scalars`` (staged by
        the engine) and updates param and moments in place; ``spans``, a
        span table of the present parameters, masks the others."""
        if bucket.flat_p.dtype not in (torch.float32, torch.bfloat16):
            raise NotImplementedError(
                f"fused AdamW buckets are float32 or bfloat16, got "
                f"{bucket.flat_p.dtype}")
        fused_adamw(bucket.flat_p, bucket.flat_g, bucket.state["moment1"],
                    bucket.state["moment2"], bucket.scalars,
                    beta1=self._beta1, beta2=self._beta2, eps=self._eps,
                    weight_decay=self._weight_decay,
                    decoupled=self._decoupled, spans=spans)


class AdamW(Adam):
    """Decoupled weight decay (reference: python/paddle/optimizer/adamw.py)."""
    _decoupled = True

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=True, name=None):
        if lr_ratio is not None or apply_decay_param_fun is not None:
            raise NotImplementedError(
                "AdamW lr_ratio / apply_decay_param_fun (per-parameter aux "
                "vectors of the fused path) are not ported yet (ROADMAP "
                "item 'optimizer/')")
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, lazy_mode, multi_precision,
                         name)


__all__ = ["Adam", "AdamW", "Optimizer"]
