"""Low-bit serving weights — counterpart of
``paddle_tpu/quantization/low_bit.py``.

``quantize_params`` converts an ``extract_params`` dict for weight-only
serving: every attention and MLP projection becomes a
:class:`QuantizedWeight` (per-out-channel int8, or nibble-packed int4,
plus float32 scales); embeddings, norms and ``lm_head`` stay fp. The
engine's projections go through :func:`matmul`, which sends a
``QuantizedWeight`` to the dequant-matmul kernel
(``kernels/int8_matmul.py``) and a plain tensor to ``x @ w``.
"""
from __future__ import annotations

import numpy as np
import torch

QUANT_MODES = ("weight_only_int8", "weight_only_int4")

#: per-layer projection keys of the extract_params dict that quantize;
#: ln1/ln2 (norms) and the top-level embed/norm/lm_head stay fp
_PROJ_KEYS = ("q", "k", "v", "o", "gate", "up", "down")


class QuantizedWeight:
    """A ``[K, N]`` projection stored low-bit: the int8 payload (``[K,
    N]``, or ``[ceil(K/2), N]`` nibble-packed for int4) and one float32
    scale per out channel (``[N]``). ``rows`` is the unpacked K."""

    def __init__(self, qdata, scale, bits, rows):
        self.qdata = qdata
        self.scale = scale
        self.bits = int(bits)
        self.rows = int(rows)

    @classmethod
    def from_numpy(cls, qdata, scale, bits, rows, device="cpu"):
        """A payload quantized elsewhere (e.g. by ``paddle_tpu``), carried
        over byte for byte."""
        q = torch.from_numpy(np.array(qdata, np.int8))
        s = torch.from_numpy(np.array(scale, np.float32))
        return cls(q.to(device), s.reshape(-1).to(device), bits, rows)

    @property
    def shape(self):
        return (self.rows, self.qdata.shape[-1])

    @property
    def nbytes(self) -> int:
        """Payload + scale bytes resident on the device."""
        return (self.qdata.numel() * self.qdata.element_size()
                + self.scale.numel() * self.scale.element_size())

    @classmethod
    def concat_columns(cls, ws):
        """Int8 weights sharing their input dimension, side by side: the
        payloads along axis 1 and the flattened scales, which is exact
        because every scale belongs to one output column."""
        if any(w.bits != 8 or w.rows != ws[0].rows for w in ws):
            raise ValueError("concat_columns takes int8 weights of equal rows")
        return cls(torch.cat([w.qdata for w in ws], 1),
                   torch.cat([w.scale.reshape(-1) for w in ws]), 8,
                   ws[0].rows)

    def dequantize(self, dtype=torch.float32):
        if self.bits == 8:
            w = self.qdata.to(dtype)
        else:
            from . import unpack_int4
            w = unpack_int4(self.qdata, self.rows).to(dtype)
        return w * self.scale.reshape(1, -1).to(dtype)

    def __repr__(self):
        return (f"QuantizedWeight(int{self.bits}, shape={self.shape}, "
                f"nbytes={self.qdata.numel() * self.qdata.element_size()})")


def quantize_weight(w, mode) -> QuantizedWeight:
    """Quantize one ``[K, N]`` projection per out channel (axis 1)."""
    from . import quantize_to_int4, quantize_to_int8
    if mode == "weight_only_int8":
        q, s = quantize_to_int8(w, axis=1)
        return QuantizedWeight(q, s.reshape(-1), 8, w.shape[0])
    if mode == "weight_only_int4":
        q, s = quantize_to_int4(w, axis=1)
        return QuantizedWeight(q, s.reshape(-1), 4, w.shape[0])
    raise ValueError(f"unknown quantized mode {mode!r}; "
                     f"expected one of {QUANT_MODES}")


def quantize_params(params, mode="weight_only_int8"):
    """An ``extract_params`` dict for low-bit serving: every per-layer
    projection becomes a :class:`QuantizedWeight`; everything else passes
    through untouched (the same tensors)."""
    if mode is None:
        return params
    if mode not in QUANT_MODES:
        raise ValueError(f"unknown quantized mode {mode!r}; "
                         f"expected one of {QUANT_MODES}")
    out = {k: v for k, v in params.items() if k != "layers"}
    out["layers"] = [
        {k: (quantize_weight(v, mode) if k in _PROJ_KEYS else v)
         for k, v in layer.items()}
        for layer in params["layers"]
    ]
    return out


def matmul(x, w):
    """``x @ w`` where ``w`` is a tensor or a :class:`QuantizedWeight` —
    the one dispatch point of every serving projection."""
    if isinstance(w, QuantizedWeight):
        from ..kernels.int8_matmul import dequant_matmul
        return dequant_matmul(x, w.qdata, w.scale, rows=w.rows, bits=w.bits)
    return x @ w


def params_weight_bytes(params) -> int:
    """Resident bytes of a (possibly quantized) params dict — the
    ``weight_bytes`` the engine reports."""
    leaves = [v for k, v in params.items() if k != "layers"]
    for layer in params.get("layers", []):
        leaves.extend(layer.values())
    return sum(v.nbytes if isinstance(v, QuantizedWeight)
               else v.numel() * v.element_size() for v in leaves)


__all__ = ["QUANT_MODES", "QuantizedWeight", "matmul", "params_weight_bytes",
           "quantize_params", "quantize_weight"]
