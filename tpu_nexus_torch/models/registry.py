"""Model registry: the port of ``tpu_nexus/models/registry.py`` for the
Llama family.

``NEXUS_MODEL_PRESET`` names a :class:`LlamaConfig` preset; the adapter
gives the serving loop its init and its synthetic prompt stream.  The MoE
and mnist presets raise ``KeyError`` until their slices land.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Iterator

import numpy as np
import torch

from tpu_nexus_torch.models.llama import LlamaConfig, LlamaParams, llama_init

#: MoeConfig presets of the JAX package (addressable bare or "moe_"-prefixed)
MOE_PRESETS = ("tiny", "nexus_moe", "mixtral_8x7b")


class ModelAdapter:
    """Contract the serving loop consumes."""

    name: str = ""
    config: Any = None

    def init(self, generator: torch.Generator, device: Any = "cuda") -> Any:
        raise NotImplementedError

    def data(self, batch: int, seq_len: int, seed: int) -> Iterator[Any]:
        raise NotImplementedError

    def items_in(self, batch: Any) -> int:
        raise NotImplementedError


@dataclass(frozen=True)
class LlamaAdapter(ModelAdapter):
    """Flagship decoder family.  Batches are int32 token arrays [B, S]."""

    config: LlamaConfig = field(default_factory=LlamaConfig.tiny)
    name: str = "llama"

    def init(self, generator: torch.Generator, device: Any = "cuda") -> LlamaParams:
        return llama_init(generator, self.config, device=device)

    def data(self, batch, seq_len, seed):
        from tpu_nexus_torch.workload.data import synthetic_tokens

        return synthetic_tokens(batch, seq_len, self.config.vocab_size, seed=seed)

    def items_in(self, batch):
        return int(np.prod(batch.shape))


def adapter_for(model_config: Any) -> ModelAdapter:
    """Dispatch a model config object to its adapter."""
    if isinstance(model_config, ModelAdapter):
        return model_config
    if isinstance(model_config, LlamaConfig):
        return LlamaAdapter(config=model_config)
    raise TypeError(f"no adapter for model config {type(model_config).__name__}")


def get_adapter(preset: str) -> ModelAdapter:
    """Resolve a preset name (``NEXUS_MODEL_PRESET``)."""
    factory = vars(LlamaConfig).get(preset)
    if isinstance(factory, staticmethod):
        return LlamaAdapter(config=getattr(LlamaConfig, preset)())
    if preset == "mnist":
        raise KeyError("model preset 'mnist' is not ported yet (ROADMAP.md: the training step)")
    if preset.removeprefix("moe_") in MOE_PRESETS:
        raise KeyError(f"model preset {preset!r} is not ported yet (ROADMAP.md: MoE)")
    known = [n for n in vars(LlamaConfig) if isinstance(vars(LlamaConfig)[n], staticmethod)]
    raise KeyError(f"unknown model preset {preset!r}; known: {sorted(known)}")
