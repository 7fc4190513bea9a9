"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

``LAUNCHES`` counts, per kernel, the launches its wrapper made: a
wrapper adds one where it launches its kernel and nowhere else, so a
run that resets the counts and reads them after shows which kernels the
path went through. A call on CPU tensors runs the plain version and
counts nothing.
"""
LAUNCHES = {"ragged_paged_attention": 0, "ragged_paged_attention_int8": 0,
            "ragged_paged_attention_merge": 0,
            "flash_attention_fwd": 0, "flash_attention_bwd_dq": 0,
            "flash_attention_bwd_dkv": 0, "flash_attention_bwd_dkv_sum": 0,
            "fused_adamw": 0,
            "int8_matmul": 0, "int4_matmul": 0, "decode_megakernel": 0,
            "prefill_megakernel": 0, "rms_norm_fwd": 0, "rms_norm_bwd": 0}


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


__all__ = ["LAUNCHES", "reset_launch_counts"]
