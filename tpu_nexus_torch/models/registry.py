"""Model registry: the port of ``tpu_nexus/models/registry.py``.

``NEXUS_MODEL_PRESET`` names a :class:`LlamaConfig` preset, a
:class:`MoeConfig` preset (bare, or ``moe_``-prefixed: ``moe_tiny``,
``nexus_moe``, ``mixtral_8x7b``) or ``mnist``; the adapter gives the
serving and training loops their init, loss, batch layout and synthetic
data.  On a training mesh (``parallel/mesh.py::TrainMesh``) each
adapter's loss runs on a rank's shards: the decoder families with the
sequence-parallel attention the mesh asks for (:func:`_sp_attn_fn`), the
pipeline over ``pp`` (``llama_hidden_pp``, ``moe_hidden_pp``), the experts
over ``ep`` (``models/moe.py``); MNIST over the data axes.  The reference's
refusals stay, in its words: the ring under ``pp``, MoE under ``pp``
without scatter, ``sort`` on an ep mesh, ``gmm`` with experts the ep
extent does not divide.
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
    llama_hidden_pp,
    llama_init,
)
from tpu_nexus_torch.models.mnist import MnistConfig, MnistParams, mnist_axes, mnist_forward, mnist_init
from tpu_nexus_torch.models.moe import MoeConfig, moe_head, moe_hidden, moe_hidden_pp, moe_init

LossFn = Callable[[Any, Any], Tuple[torch.Tensor, Dict[str, torch.Tensor]]]


def _sharded(mesh: Any) -> bool:
    return mesh is not None and mesh.world > 1


def _pp(mesh: Any) -> int:
    return mesh.size("pp") if _sharded(mesh) else 1


def _no_ring_under_pp(mesh: Any, sp_attn: str, attn_fn: Any) -> None:
    if _pp(mesh) > 1 and attn_fn is not None and sp_attn == "ring":
        raise ValueError(
            "pp > 1 with sp > 1 is not supported for sp_attn='ring' "
            "(shard_map cannot run inside the pipeline's stage vmap); "
            "use TrainConfig.sp_attn='ulysses'"
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

    def make_loss(self, train_cfg, mesh=None, rules=None):
        from tpu_nexus_torch.workload.train import chunked_next_token_loss

        sp_attn = getattr(train_cfg, "sp_attn", "ring")
        attn_fn = _sp_attn_fn(mesh, sp_attn)
        _no_ring_under_pp(mesh, sp_attn, attn_fn)
        cfg = self.config
        if _sharded(mesh):
            return _sharded_lm_loss(self, train_cfg, mesh, rules, attn_fn, ("ce_loss", "perplexity"))
        z_loss = getattr(train_cfg, "z_loss", 0.0)
        ce_chunk = getattr(train_cfg, "ce_chunk", 256)

        def loss_fn(params, tokens):
            hidden = llama_hidden(params, tokens, cfg)
            return chunked_next_token_loss(hidden, llama_head(params, cfg), tokens, z_loss, chunk=ce_chunk)

        return loss_fn

    def hidden(self, params, tokens, mesh, **kw):
        """The final-norm hidden states of a rank's rows and sequence chunk
        and no aux (the MoE family's hook)."""
        return llama_hidden(params, tokens, self.config, **kw), {}

    def hidden_pp(self, params, tokens, mesh, **kw):
        return llama_hidden_pp(params, tokens, self.config, n_stages=mesh.size("pp"), mesh=mesh, **kw), {}


def _sharded_lm_loss(adapter, train_cfg, mesh, rules, attn_fn, keys):
    """The loss of a decoder family on a training mesh's rank: ``tokens`` are
    its rows (``workload/train.py::batch_rows``), whole sequences; it keeps
    its ``sp`` chunk and that chunk's next tokens, embeds with the gathered
    table, and runs the layers (through the pipeline when ``pp > 1``: the
    head and the loss on the last stage, the values broadcast).  The MoE
    family adds its router's aux losses."""
    from tpu_nexus_torch.parallel.pipeline import finish_on_last_stage
    from tpu_nexus_torch.parallel.sharding import batch_axes
    from tpu_nexus_torch.workload.train import sharded_next_token_loss, train_layout

    cfg = adapter.config
    z_loss = getattr(train_cfg, "z_loss", 0.0)
    ce_chunk = getattr(train_cfg, "ce_chunk", 256)
    gather = train_layout(adapter, mesh, rules).fsdp_gather()
    sp, part = mesh.size("sp"), mesh.coords["sp"]
    pp = mesh.size("pp")
    first, last = mesh.stage == 0, mesh.stage == pp - 1
    moe = isinstance(cfg, MoeConfig)

    def loss_fn(params, tokens):
        s = tokens.shape[1]
        if s % sp:
            raise ValueError(f"sequence length {s} not divisible by sp={sp}")
        width = s // sp
        lo, hi = part * width, (part + 1) * width
        targets = torch.cat([tokens[:, 1:], torch.zeros_like(tokens[:, :1])], dim=1)[:, lo:hi].long()
        weight = (torch.arange(lo, hi, device=tokens.device) < s - 1).float()[None, :]
        # the embedding (and the tied head) only where a stage uses it
        embed = gather("embed/tokens", params["embed"]["tokens"]) if first or last else None

        def finish(hidden, aux):
            if cfg.tied_embeddings:
                head = embed.to(cfg.dtype).T
            else:
                head = gather("lm_head", params["lm_head"]).to(cfg.dtype)
            loss, metrics = sharded_next_token_loss(hidden, head, targets, weight, mesh, z_loss, chunk=ce_chunk)
            if moe:
                loss = loss + cfg.load_balance_coef * aux["load_balance"] + cfg.router_z_coef * aux["router_z"]
                metrics = dict(metrics, load_balance=aux["load_balance"], router_z=aux["router_z"],
                               dropped_frac=aux["dropped_frac"])
            return loss, metrics

        kw = dict(attn_impl=attn_fn or "auto", seq_offset=lo, gather=gather, embed_table=embed)
        if pp == 1:
            return finish(*adapter.hidden(params, tokens[:, lo:hi], mesh, **kw))
        hidden, aux = adapter.hidden_pp(params, tokens[:, lo:hi], mesh, batch_axes=batch_axes(rules),
                                        microbatches=getattr(train_cfg, "pp_microbatches", 0), **kw)
        return finish_on_last_stage(mesh, (hidden, *aux.values()), keys,
                                    lambda c: finish(c[0], dict(zip(aux, c[1:]))))

    return loss_fn


@dataclass(frozen=True)
class MoeAdapter(_TokenLMAdapter):
    """Mixture-of-Experts decoder (Mixtral-style).  The router's auxiliary
    losses (load balance + z) join the training loss here and surface in
    the metrics and heartbeats with the dropped-assignment share.  On a
    training mesh the experts are cut over ``ep`` (``models/moe.py``)."""

    config: MoeConfig = field(default_factory=MoeConfig.tiny)
    name: str = "moe"

    def init(self, generator: torch.Generator, device: Any = "cuda", leaf_fn: Any = None) -> LlamaParams:
        return moe_init(generator, self.config, device=device, leaf_fn=leaf_fn)

    def axes(self):
        from tpu_nexus_torch.models.moe import moe_axes

        return moe_axes(self.config)

    def check_mesh(self, mesh):
        """The reference's refusals of the mesh (``registry.py:182-209``)."""
        cfg = self.config
        ep = mesh.size("ep") if _sharded(mesh) else 1
        if _pp(mesh) > 1 and cfg.dispatch != "scatter":
            raise ValueError(
                f"pipeline parallelism requires MoeConfig.dispatch='scatter' "
                f"(plainly stage-vmappable ops), got {cfg.dispatch!r}"
            )
        if cfg.dispatch == "sort" and ep > 1:
            raise ValueError(
                f"MoeConfig.dispatch='sort' is a single-chip/replicated-expert "
                f"optimization and cannot run on an ep-sharded mesh (ep={ep}); "
                "use dispatch='gmm' (dropless) or 'scatter' for expert parallelism"
            )
        if cfg.dispatch == "gmm" and ep > 1 and cfg.n_experts % ep:
            raise ValueError(
                f"dispatch='gmm' over ep={ep} needs n_experts ({cfg.n_experts}) "
                "divisible by the ep extent"
            )

    def make_loss(self, train_cfg, mesh=None, rules=None):
        from tpu_nexus_torch.workload.train import chunked_next_token_loss

        sp_attn = getattr(train_cfg, "sp_attn", "ring")
        attn_fn = _sp_attn_fn(mesh, sp_attn)
        _no_ring_under_pp(mesh, sp_attn, attn_fn)
        self.check_mesh(mesh)
        cfg = self.config
        if _sharded(mesh):
            keys = ("ce_loss", "perplexity", "load_balance", "router_z", "dropped_frac")
            return _sharded_lm_loss(self, train_cfg, mesh, rules, attn_fn, keys)
        z_loss = getattr(train_cfg, "z_loss", 0.0)
        ce_chunk = getattr(train_cfg, "ce_chunk", 256)

        def loss_fn(params, tokens):
            # a mesh of one rank matters only to NEXUS_MOE_FORCE_EP_PATH
            hidden, aux = moe_hidden(params, tokens, cfg, mesh=mesh)
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

    def hidden(self, params, tokens, mesh, **kw):
        return moe_hidden(params, tokens, self.config, mesh=mesh, **kw)

    def hidden_pp(self, params, tokens, mesh, **kw):
        return moe_hidden_pp(params, tokens, self.config, n_stages=mesh.size("pp"), mesh=mesh, **kw)


@dataclass(frozen=True)
class MnistAdapter(ModelAdapter):
    """Small demo classifier.  Batches are ``{"x": [B, 784] f32, "y": [B]
    i32}`` dicts."""

    config: MnistConfig = field(default_factory=MnistConfig)
    name: str = "mnist"

    def init(self, generator: torch.Generator, device: Any = "cuda", leaf_fn: Any = None) -> MnistParams:
        return mnist_init(generator, self.config, device=device, leaf_fn=leaf_fn)

    def axes(self):
        """The reference's ``mnist_axes``, under the module's ``groups``."""
        return {"groups": mnist_axes(self.config)}

    def batch_axes(self):
        return {"x": ("batch", None), "y": ("batch",)}

    def check_mesh(self, mesh):
        if _sharded(mesh) and any(mesh.size(a) > 1 for a in ("pp", "ep", "sp", "tp")):
            raise ValueError(f"MNIST trains on dp/fsdp meshes; got {mesh.describe()}")

    def make_loss(self, train_cfg, mesh=None, rules=None):
        """The mean CE over the batch; on a data mesh each rank's rows, the
        sums over the data ranks (each rank's gradient is its own rows'; the
        train step sums them), every fsdp-cut leaf gathered first."""
        from tpu_nexus_torch.parallel import collectives

        self.check_mesh(mesh)
        cfg = self.config
        gather, data, n_data = None, None, 1
        if _sharded(mesh):
            from tpu_nexus_torch.workload.train import train_layout

            gather = train_layout(self, mesh, rules).fsdp_gather()
            data, n_data = mesh.group("dp", "fsdp"), mesh.size("dp", "fsdp")

        def loss_fn(params, batch):
            if gather is not None:
                params = {g: {k: gather(f"groups/{g}/{k}", w) for k, w in params[g].items()}
                          for g in MnistParams.GROUPS}
            logits = mnist_forward(params, batch["x"], cfg).float()
            labels = batch["y"]
            logz = torch.logsumexp(logits, dim=-1)
            true_logit = torch.gather(logits, -1, labels[:, None])[:, 0]
            correct = (logits.argmax(dim=-1) == labels).float()
            if n_data == 1:
                loss = (logz - true_logit).mean()
                return loss, {"ce_loss": loss, "accuracy": correct.mean()}
            n = labels.shape[0] * n_data
            loss = collectives.reduce_sum((logz - true_logit).sum(), data, n_data) / n
            accuracy = collectives.reduce_sum(correct.sum(), data, n_data) / n
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
