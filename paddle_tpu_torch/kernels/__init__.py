"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

``LAUNCHES`` counts, per kernel, the launches its wrapper made: a
wrapper adds one where it launches its kernel and nowhere else, so a
run that resets the counts and reads them after shows which kernels the
path went through. A call on CPU tensors runs the plain version and
counts nothing. A CUDA graph's replay runs no wrapper: the graph's owner
(``jit/_capture.py``) adds the counts its capture recorded at every
replay.

A wrapper that launches with a device table or scratch buffer it keeps
in a cache of its own hands each such object to :func:`keep_alive`:
while a CUDA graph is being captured, its owner collects them and keeps
them as long as the graph, which reads them by address.
"""
LAUNCHES = {"ragged_paged_attention": 0, "ragged_paged_attention_int8": 0,
            "ragged_paged_attention_merge": 0,
            "flash_attention_fwd": 0, "flash_attention_bwd_dq": 0,
            "flash_attention_bwd_dkv": 0, "flash_attention_bwd_dkv_sum": 0,
            "fused_adamw": 0,
            "int8_matmul": 0, "int4_matmul": 0, "decode_megakernel": 0,
            "prefill_megakernel": 0, "rms_norm_fwd": 0, "rms_norm_bwd": 0}

#: the lists collecting :func:`keep_alive` objects, innermost capture last
_KEEP: list = []


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def keep_alive(obj):
    """``obj``, recorded for the CUDA graph being captured, if any."""
    if _KEEP:
        _KEEP[-1].append(obj)
    return obj


def check_not_capturing(what):
    """Raise when a cached device object would be made inside a CUDA
    graph capture: its host-to-device copy would replay from a freed
    host buffer. The warm-up call of a key makes every such object."""
    import torch
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(f"{what} would be made during a CUDA graph "
                           f"capture; the warm-up call makes it")


__all__ = ["LAUNCHES", "check_not_capturing", "keep_alive",
           "reset_launch_counts"]
