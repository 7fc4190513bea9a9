"""Autocast — counterpart of ``paddle_tpu/amp/auto_cast.py``.

``auto_cast(level="O1")`` runs the white-listed ops (matrix products,
attention) in the low-precision dtype and keeps the black-listed ones
(softmax, losses, norms, reductions) in float32. Underneath it enters
``torch.autocast`` for the CPU and, when there is one, the CUDA device:
torch's own op lists cast the matrix products; the port's attention
(``scaled_dot_product_attention``, white) casts its inputs through
:func:`amp_cast_inputs`, and its losses (black) compute in f32 always.

Only O1 with the default lists is ported. O2 (low-precision parameters
with f32 master weights) and custom lists raise ``NotImplementedError``
(ROADMAP item 'amp/').
"""
from __future__ import annotations

import threading

import torch

# matrix-unit-bound ops: computed in the low-precision dtype
WHITE_LIST = {
    "matmul", "mm", "bmm", "mv", "linear", "conv1d", "conv2d", "conv3d",
    "conv1d_transpose", "conv2d_transpose", "conv3d_transpose", "einsum",
    "addmm", "scaled_dot_product_attention", "lstm_scan", "rnn_scan",
    "lstm_cell", "gru_cell", "simple_rnn_cell",
}

# numerically sensitive ops: kept in float32
BLACK_LIST = {
    "exp", "square", "log", "log2", "log10", "log1p", "mean", "sum", "softmax",
    "log_softmax", "cross_entropy", "bce", "bce_with_logits", "nll_loss",
    "mse_loss", "l1_loss", "smooth_l1_loss", "kl_div", "layer_norm",
    "batch_norm", "group_norm", "instance_norm", "rms_norm", "norm",
    "logsumexp", "cumsum", "cumprod", "softmax_with_cross_entropy", "pow",
    "rsqrt", "sqrt", "divide", "ctc_loss", "sigmoid_focal_loss",
}

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16}


class _AmpState(threading.local):
    def __init__(self):
        self.enabled = False
        self.dtype = torch.bfloat16


_state = _AmpState()


class auto_cast:
    """``paddle.amp.auto_cast`` context manager (level O1 only)."""

    def __init__(self, enable=True, custom_white_list=None,
                 custom_black_list=None, level="O1", dtype="bfloat16"):
        if level == "O2":
            raise NotImplementedError(
                "auto_cast level O2 is not ported yet (ROADMAP item "
                "'amp/')")
        if level not in ("O0", "O1"):
            raise ValueError(f"auto_cast level must be O0, O1 or O2, got "
                             f"{level!r}")
        if custom_white_list or custom_black_list:
            raise NotImplementedError(
                "auto_cast custom op lists are not ported yet (ROADMAP "
                "item 'amp/')")
        if dtype not in _DTYPES:
            raise ValueError(f"auto_cast dtype must be one of "
                             f"{sorted(_DTYPES)}, got {dtype!r}")
        self.enable = bool(enable) and level == "O1"
        self.dtype = _DTYPES[dtype]
        self._contexts = []

    def __enter__(self):
        self._saved = (_state.enabled, _state.dtype)
        _state.enabled, _state.dtype = self.enable, self.dtype
        devices = ["cpu"] + (["cuda"] if torch.cuda.is_available() else [])
        # no weight-cast cache: a cached cast made in one CUDA graph
        # capture would be read by address after the context frees it
        self._contexts = [torch.autocast(d, dtype=self.dtype,
                                         enabled=self.enable,
                                         cache_enabled=False)
                          for d in devices]
        for c in self._contexts:
            c.__enter__()
        return self

    def __exit__(self, *exc):
        for c in reversed(self._contexts):
            c.__exit__(*exc)
        self._contexts = []
        _state.enabled, _state.dtype = self._saved
        return False


def snapshot_amp_state():
    """This thread's ``auto_cast`` state, as :func:`amp_state_scope`
    takes it (recompute replays the forward's state in backward)."""
    return (_state.enabled, _state.dtype)


class amp_state_scope:
    """Run a block under a :func:`snapshot_amp_state` state."""

    def __init__(self, snapshot):
        self.snapshot = snapshot

    def __enter__(self):
        self._saved = snapshot_amp_state()
        _state.enabled, _state.dtype = self.snapshot
        return self

    def __exit__(self, *exc):
        _state.enabled, _state.dtype = self._saved
        return False


def amp_cast_inputs(op_name, *tensors):
    """The inputs of port op ``op_name`` as autocast wants them: the
    low-precision dtype for a white-listed op, float32 for a
    black-listed one, unchanged otherwise or when autocast is off.
    Non-floating tensors pass through."""
    if not _state.enabled:
        return tensors
    if op_name in WHITE_LIST:
        tgt = _state.dtype
    elif op_name in BLACK_LIST:
        tgt = torch.float32
    else:
        return tensors
    return tuple(t.to(tgt) if t.is_floating_point() else t for t in tensors)


__all__ = ["BLACK_LIST", "WHITE_LIST", "amp_cast_inputs", "amp_state_scope",
           "auto_cast", "snapshot_amp_state"]
