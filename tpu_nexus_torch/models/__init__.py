"""Model zoo of the port: the Llama family (MoE and mnist are later slices)."""

from tpu_nexus_torch.models.generate import decode_step, generate, prefill
from tpu_nexus_torch.models.llama import LlamaConfig, LlamaParams, llama_forward, llama_init
from tpu_nexus_torch.models.registry import LlamaAdapter, ModelAdapter, adapter_for, get_adapter

__all__ = [
    "LlamaConfig",
    "LlamaParams",
    "generate",
    "prefill",
    "decode_step",
    "llama_forward",
    "llama_init",
    "ModelAdapter",
    "LlamaAdapter",
    "adapter_for",
    "get_adapter",
]
