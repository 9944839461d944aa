"""Model registry: the port of ``tpu_nexus/models/registry.py``.

``NEXUS_MODEL_PRESET`` names a :class:`LlamaConfig` preset, a
:class:`MoeConfig` preset (bare, or ``moe_``-prefixed: ``moe_tiny``,
``nexus_moe``, ``mixtral_8x7b``) or ``mnist``; the adapter gives the
serving and training loops their init, loss, batch layout and synthetic
data.  On a training mesh (``parallel/mesh.py::TrainMesh``) the Llama
adapter's loss runs on a rank's shards with the sequence-parallel
attention the mesh asks for (:func:`_sp_attn_fn`); what ROADMAP.md A6b-ii
brings (``pp``, pipeline microbatches, the MoE and MNIST adapters on a
mesh) raises, naming it.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from tpu_nexus_torch.models.llama import (
    LlamaConfig,
    LlamaParams,
    llama_axes,
    llama_head,
    llama_hidden,
    llama_init,
)
from tpu_nexus_torch.models.mnist import MnistConfig, MnistParams, mnist_forward, mnist_init
from tpu_nexus_torch.models.moe import MoeConfig, moe_head, moe_hidden, moe_init

LossFn = Callable[[Any, Any], Tuple[torch.Tensor, Dict[str, torch.Tensor]]]


def _sharded(mesh: Any) -> bool:
    return mesh is not None and mesh.world > 1


def _no_pipeline(train_cfg: Any, mesh: Any) -> None:
    """Pipeline parallelism is ROADMAP.md A6b-ii: ``pp > 1`` (ring under pp
    included) and pipeline microbatches raise, naming it."""
    if _sharded(mesh) and mesh.size("pp") > 1:
        raise NotImplementedError(
            f"pp={mesh.size('pp')}: pipeline parallelism (llama_hidden_pp; with sp, Ulysses only — "
            "ring under pp is refused in the reference) is not ported yet (ROADMAP.md: A6b-ii)"
        )
    if getattr(train_cfg, "pp_microbatches", 0):
        raise NotImplementedError(
            f"pp_microbatches={train_cfg.pp_microbatches}: pipeline microbatches are not ported yet "
            "(ROADMAP.md: A6b-ii)"
        )


def _one_device_only(what: str, mesh: Any) -> None:
    if _sharded(mesh):
        raise NotImplementedError(
            f"{what} training on a mesh of {mesh.world} ranks {mesh.describe()} is not ported yet "
            "(ROADMAP.md: A6b-ii)"
        )


def _sp_attn_fn(mesh: Any, sp_attn: str = "ring"):
    """Sequence-parallel attention when the mesh shards the sequence, else
    None (the model dispatches to flash/plain attention itself): "ring"
    (``parallel/ring.py``) or "ulysses" (``parallel/ulysses.py``)."""
    import functools

    if sp_attn not in ("ring", "ulysses"):
        raise ValueError(f"unknown sp_attn {sp_attn!r}; use 'ring' or 'ulysses'")
    if not _sharded(mesh) or mesh.size("sp") <= 1:
        return None
    if sp_attn == "ulysses":
        from tpu_nexus_torch.parallel.ulysses import ulysses_attention

        head_axis = "tp" if mesh.size("tp") > 1 else None
        return functools.partial(ulysses_attention, mesh=mesh, head_axis=head_axis)
    from tpu_nexus_torch.parallel.ring import ring_attention_sharded

    return functools.partial(ring_attention_sharded, mesh=mesh)


def host_to_device(array: Any, device: Any, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """A host (numpy) batch leaf on ``device``.  On the card the copy goes
    through pinned memory and does not wait: a pageable copy would block
    the host until the device had finished every step queued before it."""
    t = torch.from_numpy(np.ascontiguousarray(array))
    if dtype is not None:
        t = t.to(dtype)
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


class ModelAdapter:
    """Contract the serving and training loops consume.  A batch is a
    tensor or a dict of tensors; every method below agrees on it."""

    name: str = ""
    config: Any = None

    def init(self, generator: torch.Generator, device: Any = "cuda", leaf_fn: Any = None) -> Any:
        """Model parameters (an ``nn.Module``) on ``device``; ``leaf_fn(path,
        tensor)``, for a family that trains on a mesh, maps each leaf as it
        is drawn (a rank's part)."""
        raise NotImplementedError

    def axes(self) -> Any:
        """Logical-axis tree mirroring the params (the sharding rules' input)."""
        raise NotImplementedError

    def check_mesh(self, mesh: Any) -> None:
        """Raise if this adapter does not train on ``mesh``."""
        _one_device_only(self.name, mesh)

    def batch_axes(self) -> Any:
        """Logical axes of one batch (the reference's sharding contract)."""
        raise NotImplementedError

    def make_loss(self, train_cfg: Any, mesh: Any = None, rules: Any = None) -> LossFn:
        """(params, batch) -> (scalar loss, metrics dict); on a training mesh,
        over a rank's shards and rows."""
        raise NotImplementedError

    def data(self, batch: int, seq_len: int, seed: int) -> Iterator[Any]:
        """Infinite iterator of host (numpy) batches."""
        raise NotImplementedError

    def to_device(self, batch: Any, device: Any) -> Any:
        """A host batch as the loss's input tensors on ``device``."""
        raise NotImplementedError

    def items_in(self, batch: Any) -> int:
        """Throughput denominator: tokens (LM) or examples (classifier)."""
        raise NotImplementedError


class _TokenLMAdapter(ModelAdapter):
    """Batches of the decoder families: int32 token arrays [B, S]."""

    def batch_axes(self):
        return ("batch", "seq")

    def data(self, batch, seq_len, seed):
        from tpu_nexus_torch.workload.data import synthetic_tokens

        return synthetic_tokens(batch, seq_len, self.config.vocab_size, seed=seed)

    def to_device(self, batch, device):
        return host_to_device(batch, device, torch.long)

    def items_in(self, batch):
        return int(np.prod(batch.shape))


@dataclass(frozen=True)
class LlamaAdapter(_TokenLMAdapter):
    """Flagship decoder family."""

    config: LlamaConfig = field(default_factory=LlamaConfig.tiny)
    name: str = "llama"

    def init(self, generator: torch.Generator, device: Any = "cuda", leaf_fn: Any = None) -> LlamaParams:
        return llama_init(generator, self.config, device=device, leaf_fn=leaf_fn)

    def axes(self):
        return llama_axes(self.config)

    def check_mesh(self, mesh):
        _no_pipeline(None, mesh)

    def make_loss(self, train_cfg, mesh=None, rules=None):
        from tpu_nexus_torch.workload.train import chunked_next_token_loss

        _no_pipeline(train_cfg, mesh)
        attn_fn = _sp_attn_fn(mesh, getattr(train_cfg, "sp_attn", "ring"))
        cfg = self.config
        z_loss = getattr(train_cfg, "z_loss", 0.0)
        ce_chunk = getattr(train_cfg, "ce_chunk", 256)
        if _sharded(mesh):
            return self._sharded_loss(mesh, rules, attn_fn, z_loss, ce_chunk)

        def loss_fn(params, tokens):
            hidden = llama_hidden(params, tokens, cfg)
            return chunked_next_token_loss(hidden, llama_head(params, cfg), tokens, z_loss, chunk=ce_chunk)

        return loss_fn

    def _sharded_loss(self, mesh, rules, attn_fn, z_loss, ce_chunk):
        """The loss on a rank: ``tokens`` are its rows, whole sequences; it
        keeps its ``sp`` chunk and that chunk's next tokens."""
        from tpu_nexus_torch.workload.train import sharded_next_token_loss, train_layout

        cfg = self.config
        gather = train_layout(self, mesh, rules).fsdp_gather()
        sp, part = mesh.size("sp"), mesh.coords["sp"]

        def loss_fn(params, tokens):
            s = tokens.shape[1]
            if s % sp:
                raise ValueError(f"sequence length {s} not divisible by sp={sp}")
            width = s // sp
            lo, hi = part * width, (part + 1) * width
            targets = torch.cat([tokens[:, 1:], torch.zeros_like(tokens[:, :1])], dim=1)[:, lo:hi].long()
            weight = (torch.arange(lo, hi, device=tokens.device) < s - 1).float()[None, :]
            embed = gather("embed/tokens", params["embed"]["tokens"])
            hidden = llama_hidden(params, tokens[:, lo:hi], cfg, attn_impl=attn_fn or "auto", seq_offset=lo,
                                  gather=gather, embed_table=embed)
            head = embed.to(cfg.dtype).T if cfg.tied_embeddings else gather("lm_head", params["lm_head"]).to(cfg.dtype)
            return sharded_next_token_loss(hidden, head, targets, weight, mesh, z_loss, chunk=ce_chunk)

        return loss_fn


@dataclass(frozen=True)
class MoeAdapter(_TokenLMAdapter):
    """Mixture-of-Experts decoder (Mixtral-style).  The router's auxiliary
    losses (load balance + z) join the training loss here and surface in
    the metrics and heartbeats with the dropped-assignment share.  One
    device: the reference's refusals of ``sort`` and of an indivisible
    ``gmm`` on an ep-sharded mesh cannot arise until the multi-GPU slice."""

    config: MoeConfig = field(default_factory=MoeConfig.tiny)
    name: str = "moe"

    def init(self, generator: torch.Generator, device: Any = "cuda") -> LlamaParams:
        return moe_init(generator, self.config, device=device)

    def axes(self):
        from tpu_nexus_torch.models.moe import moe_axes

        return moe_axes(self.config)

    def make_loss(self, train_cfg, mesh=None, rules=None):
        from tpu_nexus_torch.workload.train import chunked_next_token_loss

        _no_pipeline(train_cfg, mesh)
        _one_device_only("MoE (_moe_ffn_gmm_ep under ep, kernels #7/#8)", mesh)
        cfg = self.config
        z_loss = getattr(train_cfg, "z_loss", 0.0)
        ce_chunk = getattr(train_cfg, "ce_chunk", 256)

        def loss_fn(params, tokens):
            hidden, aux = moe_hidden(params, tokens, cfg)
            loss, metrics = chunked_next_token_loss(hidden, moe_head(params, cfg), tokens, z_loss, chunk=ce_chunk)
            loss = loss + cfg.load_balance_coef * aux["load_balance"] + cfg.router_z_coef * aux["router_z"]
            metrics = dict(
                metrics,
                load_balance=aux["load_balance"],
                router_z=aux["router_z"],
                dropped_frac=aux["dropped_frac"],
            )
            return loss, metrics

        return loss_fn


@dataclass(frozen=True)
class MnistAdapter(ModelAdapter):
    """Small demo classifier.  Batches are ``{"x": [B, 784] f32, "y": [B]
    i32}`` dicts."""

    config: MnistConfig = field(default_factory=MnistConfig)
    name: str = "mnist"

    def init(self, generator: torch.Generator, device: Any = "cuda") -> MnistParams:
        return mnist_init(generator, self.config, device=device)

    def batch_axes(self):
        return {"x": ("batch", None), "y": ("batch",)}

    def make_loss(self, train_cfg, mesh=None, rules=None):
        _no_pipeline(train_cfg, mesh)
        _one_device_only("MNIST", mesh)
        cfg = self.config

        def loss_fn(params, batch):
            logits = mnist_forward(params, batch["x"], cfg).float()
            labels = batch["y"]
            logz = torch.logsumexp(logits, dim=-1)
            true_logit = torch.gather(logits, -1, labels[:, None])[:, 0]
            loss = (logz - true_logit).mean()
            accuracy = (logits.argmax(dim=-1) == labels).float().mean()
            return loss, {"ce_loss": loss, "accuracy": accuracy}

        return loss_fn

    def data(self, batch, seq_len, seed):
        from tpu_nexus_torch.workload.data import synthetic_mnist

        def gen():
            for images, labels in synthetic_mnist(batch, seed=seed):
                yield {"x": images, "y": labels}

        return gen()

    def to_device(self, batch, device):
        return {"x": host_to_device(batch["x"], device), "y": host_to_device(batch["y"], device, torch.long)}

    def items_in(self, batch):
        return int(np.shape(batch["y"])[0])


def adapter_for(model_config: Any) -> ModelAdapter:
    """Dispatch a model config object to its adapter."""
    if isinstance(model_config, ModelAdapter):
        return model_config
    if isinstance(model_config, LlamaConfig):
        return LlamaAdapter(config=model_config)
    if isinstance(model_config, MnistConfig):
        return MnistAdapter(config=model_config)
    if isinstance(model_config, MoeConfig):
        return MoeAdapter(config=model_config)
    raise TypeError(f"no adapter for model config {type(model_config).__name__}")


def _presets(cls) -> list:
    return [n for n, v in vars(cls).items() if isinstance(v, staticmethod)]


def get_adapter(preset: str) -> ModelAdapter:
    """Resolve a preset name (``NEXUS_MODEL_PRESET``): ``mnist``, any
    LlamaConfig preset, or a MoeConfig preset by its own name or with a
    ``moe_`` prefix.  Llama wins a bare name both define (``tiny``)."""
    if preset == "mnist":
        return MnistAdapter()
    if preset in _presets(LlamaConfig):
        return LlamaAdapter(config=getattr(LlamaConfig, preset)())
    moe_name = preset.removeprefix("moe_")
    if moe_name in _presets(MoeConfig):
        return MoeAdapter(config=getattr(MoeConfig, moe_name)())
    known = ["mnist"] + _presets(LlamaConfig) + [f"moe_{n}" for n in _presets(MoeConfig)]
    raise KeyError(f"unknown model preset {preset!r}; known: {sorted(known)}")
