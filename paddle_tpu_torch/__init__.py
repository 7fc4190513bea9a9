"""paddle_tpu_torch — the PyTorch and CUDA port of paddle_tpu.

Each module has one counterpart in ``paddle_tpu`` (same path, same
names). The port imports torch and never JAX or ``paddle_tpu``. Its
entry points (``LLMEngine``, ``LlamaForCausalLM``) run on the current
CUDA device unless the caller passes ``device="cpu"``, and raise when
no device is named and no CUDA device exists.

Ported so far:

- serving a Llama model through ``LLMEngine`` (the default
  configuration), with the ragged paged-attention kernel written in CUDA
  for Hopper (``kernels/csrc/ragged_paged_attention.cu``);
- training it: ``jit.TrainStep(model, loss_fn, optimizer.AdamW(...))``
  under ``amp.auto_cast`` O1, with micro-batch accumulation and
  per-layer recompute (``remat``), through flash attention (forward and
  backward, ``kernels/csrc/flash_attention.cu``), RMSNorm (forward and
  backward, ``kernels/csrc/rms_norm.cu``) and the fused AdamW bucket
  update (``kernels/csrc/fused_adamw.cu``) written in CUDA.

On the card the training step, the engine's ragged step and its decode
bursts each replay a CUDA graph per shape key (``jit/_capture.py``);
``jit.enable_to_static(False)`` runs them eagerly.
"""
from . import amp, jit, nn, optimizer
from .amp import auto_cast
from .core.place import resolve_device
from .jit import TrainStep
from .models.llama import (LlamaConfig, LlamaForCausalLM, llama2_13b_config,
                           llama2_7b_config, llama_tiny_config,
                           load_numpy_state_dict)
from .optimizer import Adam, AdamW
from .serving.engine import LLMEngine, Request, RequestOutput, RequestRejected

__all__ = ["Adam", "AdamW", "LLMEngine", "LlamaConfig", "LlamaForCausalLM",
           "Request", "RequestOutput", "RequestRejected", "TrainStep", "amp",
           "auto_cast", "jit", "llama2_13b_config", "llama2_7b_config",
           "llama_tiny_config", "load_numpy_state_dict", "nn", "optimizer",
           "resolve_device"]
