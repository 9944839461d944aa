"""Model zoo of the port: the Llama and MoE families and the mnist demo."""

from tpu_nexus_torch.models.generate import decode_step, generate, prefill
from tpu_nexus_torch.models.llama import LlamaConfig, LlamaParams, llama_forward, llama_init
from tpu_nexus_torch.models.mnist import MnistConfig
from tpu_nexus_torch.models.moe import MoeConfig, moe_hidden, moe_init
from tpu_nexus_torch.models.registry import (
    LlamaAdapter,
    MnistAdapter,
    ModelAdapter,
    MoeAdapter,
    adapter_for,
    get_adapter,
)

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
    "MnistAdapter",
    "MnistConfig",
    "MoeAdapter",
    "MoeConfig",
    "moe_hidden",
    "moe_init",
    "adapter_for",
    "get_adapter",
]
