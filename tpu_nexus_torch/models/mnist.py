"""MNIST MLP in PyTorch: the port of ``tpu_nexus/models/mnist.py``, the small
demo workload of the training harness.  Parameters keep the JAX tree's keys
and layouts (``params["hidden"]["w"]`` stacked ``[n_layers, H, H]``)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

import torch
from torch import nn


@dataclass(frozen=True)
class MnistConfig:
    input_dim: int = 784
    hidden: int = 512
    n_classes: int = 10
    n_layers: int = 2
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32


class MnistParams(nn.Module):
    """``params["in"|"hidden"|"out"]["w"|"b"]``, as the JAX tree."""

    GROUPS = ("in", "hidden", "out")

    def __init__(self, tree: Dict[str, Dict[str, torch.Tensor]]) -> None:
        super().__init__()
        self.groups = nn.ModuleDict(
            {g: nn.ParameterDict({k: nn.Parameter(v) for k, v in tree[g].items()}) for g in self.GROUPS}
        )

    def __getitem__(self, key: str):
        return self.groups[key]


def mnist_init(generator: torch.Generator, cfg: MnistConfig, device: Any = "cuda") -> MnistParams:
    """Plain normal init with fan-in scaling, zero biases (as the reference),
    drawn on ``device`` from ``generator``."""
    pd = cfg.param_dtype

    def normal(shape, fan_in):
        x = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
        return x.mul_(fan_in**-0.5).to(pd)

    def zeros(shape):
        return torch.zeros(shape, dtype=pd, device=device)

    return MnistParams({
        "in": {"w": normal((cfg.input_dim, cfg.hidden), cfg.input_dim), "b": zeros((cfg.hidden,))},
        "hidden": {
            "w": normal((cfg.n_layers, cfg.hidden, cfg.hidden), cfg.hidden),
            "b": zeros((cfg.n_layers, cfg.hidden)),
        },
        "out": {"w": normal((cfg.hidden, cfg.n_classes), cfg.hidden), "b": zeros((cfg.n_classes,))},
    })


def mnist_forward(params, x: torch.Tensor, cfg: MnistConfig) -> torch.Tensor:
    """Logits ``[B, n_classes]`` for flattened images ``[B, 784]``."""
    ct = cfg.dtype
    h = torch.relu(x.to(ct) @ params["in"]["w"].to(ct) + params["in"]["b"].to(ct))
    for li in range(params["hidden"]["w"].shape[0]):
        h = torch.relu(h @ params["hidden"]["w"][li].to(ct) + params["hidden"]["b"][li].to(ct))
    return h @ params["out"]["w"].to(ct) + params["out"]["b"].to(ct)
