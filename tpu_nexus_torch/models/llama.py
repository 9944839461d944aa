"""Llama-3 family in PyTorch: the port of ``tpu_nexus/models/llama.py``.

* :class:`LlamaParams` is an ``nn.Module`` that holds the parameters in
  the JAX package's layout — per-layer weights stacked on a leading
  ``[n_layers, ...]`` axis, e.g. ``wq [L, E, Hq, D]`` — and reads like the
  JAX parameter tree (``params["layers"]["wq"]``), so the blocks below and
  the converter (``models/convert.py``) share one set of key paths.
* The blocks are plain functions on tensors.  Weights are cast to the
  compute dtype at the use site (``weight_einsum``), as in the reference;
  a quantized tree (``models/quant.py::QuantizedParams``) runs through the
  same blocks, its weight products dispatched by ``weight_einsum``.
* Random init draws from an explicit ``torch.Generator``; it gives other
  numbers than ``jax.random`` for the same seed, so tests carry weights
  across with ``models/convert.py``.
* Under a training mesh (``workload/train.py``) the same blocks run on a
  rank's shards: ``gather`` all-gathers a layer's fsdp-cut weights inside
  the checkpointed layer (so the recompute gathers them again instead of
  keeping them), the tensor-parallel pair (``copy_to_tp`` before the
  column-parallel products, ``reduce_tp`` after the row-parallel ones)
  makes tp-sharded heads and MLP differentiable, and ``attn_impl`` may be
  the sequence-parallel attention (``parallel/ring.py``,
  ``parallel/ulysses.py``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict

import torch
from torch import nn

from tpu_nexus_torch.ops.attention import attention
from tpu_nexus_torch.parallel.collectives import copy_to_tp, embed_rows, gather_vocab, reduce_tp
from tpu_nexus_torch.ops.quant_matmul import weight_einsum
from tpu_nexus_torch.ops.rmsnorm import rms_norm

@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128256
    hidden: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    head_dim: int = 128
    intermediate: int = 14336
    rope_theta: float = 500_000.0
    norm_eps: float = 1e-5
    max_seq_len: int = 8192
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32
    #: activation checkpointing of each layer while gradients are taken
    #: (:func:`remat_layer`); the serving path runs without grad and
    #: ignores it
    remat: bool = True
    #: what a checkpointed layer keeps for the backward pass:
    #:  "dots"     — everything autograd saves (no recompute);
    #:  "attn_out" — the layer input plus the flash forward's out and lse,
    #:               so the backward recomputes the layer without
    #:               re-launching the flash forward kernel;
    #:  "qkv"      — "attn_out" plus the post-RoPE q/k/v;
    #:  "nothing"  — the layer input only (the flash forward re-runs).
    remat_policy: str = "dots"
    tied_embeddings: bool = False
    #: the reference's layer-scan unroll factor; eager PyTorch runs the
    #: layers as a Python loop, so it is kept for the presets and ignored
    scan_unroll: int = 1

    # -- presets (tpu_nexus/models/llama.py:68-130) -------------------------

    @staticmethod
    def llama3_8b() -> "LlamaConfig":
        return LlamaConfig()

    @staticmethod
    def llama3_70b() -> "LlamaConfig":
        return LlamaConfig(
            hidden=8192, n_layers=80, n_heads=64, n_kv_heads=8, intermediate=28672
        )

    @staticmethod
    def llama3_1b() -> "LlamaConfig":
        # Llama-3.2-1B shape
        return LlamaConfig(
            hidden=2048, n_layers=16, n_heads=32, n_kv_heads=8, head_dim=64,
            intermediate=8192, tied_embeddings=True,
        )

    @staticmethod
    def nexus_1b() -> "LlamaConfig":
        return LlamaConfig(
            vocab_size=32768, hidden=2048, n_layers=14, n_heads=16, n_kv_heads=8,
            head_dim=128, intermediate=8192, tied_embeddings=True,
            param_dtype=torch.bfloat16, max_seq_len=4096, remat_policy="attn_out",
            scan_unroll=2,
        )

    @staticmethod
    def nexus_1b_long() -> "LlamaConfig":
        return dataclasses.replace(LlamaConfig.nexus_1b(), max_seq_len=32768)

    @staticmethod
    def tiny(vocab_size: int = 256) -> "LlamaConfig":
        """Test/dry-run config: shapes small but structure identical."""
        return LlamaConfig(
            vocab_size=vocab_size, hidden=64, n_layers=2, n_heads=4, n_kv_heads=2,
            head_dim=16, intermediate=128, max_seq_len=256, remat=False,
        )

    @staticmethod
    def tiny_tp(vocab_size: int = 256) -> "LlamaConfig":
        return LlamaConfig(
            vocab_size=vocab_size, hidden=64, n_layers=2, n_heads=4, n_kv_heads=4,
            head_dim=16, intermediate=128, max_seq_len=256, remat=False,
        )


def _layer_shapes(cfg: LlamaConfig) -> Dict[str, tuple]:
    """Shape of every stacked per-layer leaf, in the JAX tree's order."""
    e, f, hq, hkv, d, l = (
        cfg.hidden, cfg.intermediate, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.n_layers,
    )
    return {
        "attn_norm": (l, e),
        "wq": (l, e, hq, d),
        "wk": (l, e, hkv, d),
        "wv": (l, e, hkv, d),
        "wo": (l, hq, d, e),
        "mlp_norm": (l, e),
        "w_gate": (l, e, f),
        "w_up": (l, e, f),
        "w_down": (l, f, e),
    }


class LlamaParams(nn.Module):
    """The parameter tree of one Llama model, in the reference's layout.

    ``params["embed"]["tokens"]``, ``params["layers"][name]`` (stacked
    ``[L, ...]``), ``params["out_norm"]`` and, untied,
    ``params["lm_head"]`` read like the JAX tree.  Parameters are
    trainable; serving runs them under ``torch.inference_mode()``."""

    def __init__(self, tree: Dict[str, Any]) -> None:
        super().__init__()

        def p(t):
            return nn.Parameter(t)

        self.embed = nn.ParameterDict({"tokens": p(tree["embed"]["tokens"])})
        self.layers = nn.ParameterDict({k: p(v) for k, v in tree["layers"].items()})
        self.out_norm = p(tree["out_norm"])
        self.lm_head = p(tree["lm_head"]) if "lm_head" in tree else None

    def __getitem__(self, key: str):
        if key not in self.keys():
            raise KeyError(key)
        return getattr(self, key)

    def __contains__(self, key: str) -> bool:
        return key in self.keys()

    def keys(self):
        return ["embed", "layers", "out_norm"] + (["lm_head"] if self.lm_head is not None else [])


def llama_axes(cfg: LlamaConfig) -> Dict[str, Any]:
    """Logical-axis tree mirroring :func:`llama_init`'s params (the JAX
    package's ``llama_axes``): the sharding rules' input."""
    layers = {
        "attn_norm": ("layers", "embed"),
        "wq": ("layers", "embed", "heads", "head_dim"),
        "wk": ("layers", "embed", "kv_heads", "head_dim"),
        "wv": ("layers", "embed", "kv_heads", "head_dim"),
        "wo": ("layers", "heads", "head_dim", "embed"),
        "mlp_norm": ("layers", "embed"),
        "w_gate": ("layers", "embed", "mlp"),
        "w_up": ("layers", "embed", "mlp"),
        "w_down": ("layers", "mlp", "embed"),
    }
    axes: Dict[str, Any] = {
        "embed": {"tokens": ("vocab", "embed")},
        "layers": layers,
        "out_norm": ("embed",),
    }
    if not cfg.tied_embeddings:
        axes["lm_head"] = ("embed", "vocab")
    return axes


def _init_tree(generator, cfg, device, shapes, leaf_fn) -> Dict[str, Any]:
    """The random init shared by the Llama and MoE families: each leaf in
    the JAX tree's order, passed through ``leaf_fn(path, tensor)`` as soon
    as it is drawn (a sharded executor keeps its rank's slice, so one full
    leaf at a time is ever alive)."""
    pd = cfg.param_dtype
    e = cfg.hidden
    keep = leaf_fn or (lambda path, t: t)

    def normal(shape, fan_in):
        x = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
        return (x.mul_(fan_in**-0.5)).to(pd)

    layers = {}
    for name, shape in shapes.items():
        if name.endswith("norm"):
            layers[name] = keep(f"layers/{name}", torch.ones(shape, dtype=pd, device=device))
        else:
            fan_in = {"wo": cfg.n_heads * cfg.head_dim, "w_down": cfg.intermediate}.get(name, e)
            layers[name] = keep(f"layers/{name}", normal(shape, fan_in))
    tree: Dict[str, Any] = {
        "embed": {"tokens": keep("embed/tokens", normal((cfg.vocab_size, e), e))},
        "layers": layers,
        "out_norm": keep("out_norm", torch.ones((e,), dtype=pd, device=device)),
    }
    if not cfg.tied_embeddings:
        tree["lm_head"] = keep("lm_head", normal((e, cfg.vocab_size), e))
    return tree


def llama_init(
    generator: torch.Generator, cfg: LlamaConfig, device: Any = "cuda", leaf_fn: Any = None,
) -> LlamaParams:
    """Random init (plain normal with fan-in scaling, as the reference),
    drawn on ``device`` from ``generator`` (which must live on the same
    device type).  ``leaf_fn(path, tensor)``, when given, maps each leaf
    as it is drawn (a rank's slice: the same draws, less kept)."""
    return LlamaParams(_init_tree(generator, cfg, device, _layer_shapes(cfg), leaf_fn))


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float):
    """cos/sin tables [B, S, 1, D/2], computed once per forward."""
    freqs = theta ** (
        -torch.arange(0, head_dim, 2, dtype=torch.float32, device=positions.device) / head_dim
    )
    angles = positions[..., None].float() * freqs  # [B, S, D/2]
    return torch.cos(angles)[:, :, None, :], torch.sin(angles)[:, :, None, :]


def _rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Apply rotary embedding, x [B, S, H, D]."""
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def layer_params(params, li: int) -> Dict[str, Any]:
    """Layer ``li``'s slice of the stacked per-layer leaves (views); a
    quantized leaf slices its values and scales together."""
    return {name: w[li] for name, w in params["layers"].items()}


def qkv_block(x, layer, cfg, cos, sin):
    """Norm → q/k/v projections → RoPE: the attention's inputs."""
    ct = cfg.dtype
    h = copy_to_tp(rms_norm(x, layer["attn_norm"], cfg.norm_eps))
    q = weight_einsum("bse,ehd->bshd", h, layer["wq"], ct)
    k = weight_einsum("bse,ehd->bshd", h, layer["wk"], ct)
    v = weight_einsum("bse,ehd->bshd", h, layer["wv"], ct)
    return _rope(q, cos, sin), _rope(k, cos, sin), v


def attend_block(x, q, k, v, layer, cfg, attn_impl: str = "auto"):
    """Attention → output projection → residual.  ``attn_impl`` is an
    implementation name (``ops/attention.py``) or an attention function
    ``fn(q, k, v, causal=...)`` (the sequence-parallel ones)."""
    if callable(attn_impl):
        o = attn_impl(q, k, v, causal=True)
    else:
        o = attention(q, k, v, causal=True, impl=attn_impl)
    return x + reduce_tp(weight_einsum("bshd,hde->bse", o, layer["wo"], cfg.dtype))


def attention_block(x, layer, cfg, cos, sin, attn_impl: str = "auto", *, collect_kv: bool = False):
    """Pre-norm GQA attention sub-block (norm → qkv → RoPE → attention →
    output projection → residual).  ``attn_impl`` picks the attention
    (ops/attention.py).  ``collect_kv=True`` also returns the post-RoPE K/V
    (the prefill path of KV-cache decoding)."""
    q, k, v = qkv_block(x, layer, cfg, cos, sin)
    x = attend_block(x, q, k, v, layer, cfg, attn_impl)
    if collect_kv:
        return x, (k, v)
    return x


def mlp_block(x: torch.Tensor, layer: Dict[str, Any], cfg: LlamaConfig) -> torch.Tensor:
    """Pre-norm SwiGLU MLP sub-block with residual."""
    ct = cfg.dtype
    h = copy_to_tp(rms_norm(x, layer["mlp_norm"], cfg.norm_eps))
    gate = weight_einsum("bse,ef->bsf", h, layer["w_gate"], ct)
    up = weight_einsum("bse,ef->bsf", h, layer["w_up"], ct)
    return x + reduce_tp(weight_einsum("bsf,fe->bse", torch.nn.functional.silu(gate) * up, layer["w_down"], ct))


def llama_head(params, cfg: LlamaConfig) -> torch.Tensor:
    """The output projection ``[E, vocab]`` (tied or untied)."""
    if cfg.tied_embeddings:
        return params["embed"]["tokens"].to(cfg.dtype).T
    return params["lm_head"].to(cfg.dtype)


REMAT_POLICIES = ("dots", "attn_out", "qkv", "nothing")


class _Gathered(dict):
    """A layer's weights, each gathered on first use by ``gather(name,
    shard)`` (the fsdp all-gather; the order of first uses is the
    blocks', the same on every rank)."""

    def __init__(self, layer, gather):
        super().__init__()
        self._shards, self._gather = layer, gather

    def __getitem__(self, name):
        if name not in self:
            self[name] = self._gather(name, self._shards[name])
        return super().__getitem__(name)


def _full(layer, gather):
    return layer if gather is None else _Gathered(layer, gather)


def _layer(x, layer, cfg, cos, sin, attn_impl, ffn, gather=None):
    layer = _full(layer, gather)
    return ffn(attention_block(x, layer, cfg, cos, sin, attn_impl), layer, cfg)


def _qkv(x, layer, cfg, cos, sin, gather=None):
    return qkv_block(x, _full(layer, gather), cfg, cos, sin)


def _after_qkv(x, q, k, v, layer, cfg, attn_impl, ffn, gather=None):
    layer = _full(layer, gather)
    return ffn(attend_block(x, q, k, v, layer, cfg, attn_impl), layer, cfg)


def _keep_flash_outputs():
    """Selective-checkpoint contexts that keep the flash forward op's
    outputs (out, lse) — and the ring attention's, whose forward is one
    op too — and recompute everything else."""
    from torch.utils.checkpoint import CheckpointPolicy, create_selective_checkpoint_contexts

    import tpu_nexus_torch.ops.flash_attention  # noqa: F401 - registers nexus::flash_fwd
    import tpu_nexus_torch.parallel.ring  # noqa: F401 - registers nexus::ring_fwd

    def policy(ctx, op, *args, **kwargs):
        if op is torch.ops.nexus.flash_fwd.default or op is torch.ops.nexus.ring_fwd.default:
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE

    return create_selective_checkpoint_contexts(policy)


def remat_layer(x, layer, cfg, cos, sin, attn_impl: str = "auto", ffn=mlp_block, gather=None):
    """One decoder layer under ``cfg.remat_policy`` (the reference's
    ``jax.checkpoint`` around the layer scan body).  Checkpointing applies
    only while gradients are taken; see :attr:`LlamaConfig.remat_policy`.
    ``ffn(x, layer, cfg)`` is the post-attention sub-block: the dense MLP,
    or the MoE family's routed experts (``models/moe.py::moe_block``, which
    also returns its router aux losses), recomputed like the rest.
    Unlike XLA, eager recompute cannot drop work whose outputs are saved:
    under "qkv" the backward still re-runs norm and projections for their
    own gradients, and only the attention inputs are kept.  ``gather``
    (a sharded train step's fsdp all-gather, ``gather(name, shard)``)
    runs inside the checkpointed functions: the recompute gathers again."""
    policy = cfg.remat_policy
    if policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat_policy {policy!r}; use {', '.join(REMAT_POLICIES)}")
    if not (cfg.remat and torch.is_grad_enabled()) or policy == "dots":
        return _layer(x, layer, cfg, cos, sin, attn_impl, ffn, gather)
    from torch.utils.checkpoint import checkpoint

    if policy == "nothing":
        return checkpoint(_layer, x, layer, cfg, cos, sin, attn_impl, ffn, gather, use_reentrant=False)
    if policy == "attn_out":
        return checkpoint(
            _layer, x, layer, cfg, cos, sin, attn_impl, ffn, gather, use_reentrant=False,
            context_fn=_keep_flash_outputs,
        )
    q, k, v = checkpoint(_qkv, x, layer, cfg, cos, sin, gather, use_reentrant=False)
    return checkpoint(
        _after_qkv, x, q, k, v, layer, cfg, attn_impl, ffn, gather, use_reentrant=False,
        context_fn=_keep_flash_outputs,
    )


def llama_hidden(
    params,
    tokens: torch.Tensor,
    cfg: LlamaConfig,
    *,
    attn_impl: Any = "auto",
    return_kv: bool = False,
    seq_offset: int = 0,
    gather: Any = None,
    embed_table: Any = None,
):
    """Final-norm hidden states ``[B, S, E]``.  ``return_kv=True`` →
    ``(hidden, (k, v))`` with K/V stacked per layer ``[L, B, S, Hkv, D]``
    (no activation checkpointing then: it is the no-grad prefill path).

    On a training mesh's rank: ``tokens`` is this rank's sequence shard,
    starting at global position ``seq_offset``; ``gather(name, shard)``
    all-gathers fsdp-cut weights (layer leaves by their layer key, the rest
    by path), and ``embed_table`` is the gathered embedding the caller also
    uses as the tied head."""
    if seq_offset + tokens.shape[1] > cfg.max_seq_len:
        raise ValueError(
            f"sequence length {seq_offset + tokens.shape[1]} exceeds the config's "
            f"max_seq_len {cfg.max_seq_len}"
        )
    positions = torch.arange(seq_offset, seq_offset + tokens.shape[1], device=tokens.device)[None, :]
    positions = positions.expand(tokens.shape)
    # gather, then cast: the same values as the reference's cast-then-gather
    # without materializing a compute-dtype copy of the whole table
    table = params["embed"]["tokens"] if embed_table is None else embed_table
    x = embed_rows(table, tokens).to(cfg.dtype)  # [B, S, E]
    cos, sin = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    ks, vs = [], []
    for li in range(params["layers"]["wq"].shape[0]):
        layer = layer_params(params, li)
        if not return_kv:
            x = remat_layer(x, layer, cfg, cos, sin, attn_impl, gather=gather)
            continue
        x, (k, v) = attention_block(x, layer, cfg, cos, sin, attn_impl, collect_kv=True)
        x = mlp_block(x, layer, cfg)
        ks.append(k)
        vs.append(v)
    out_norm = params["out_norm"] if gather is None else gather("out_norm", params["out_norm"])
    hidden = rms_norm(x, out_norm, cfg.norm_eps)
    if return_kv:
        return hidden, (torch.stack(ks), torch.stack(vs))
    return hidden


def llama_forward(
    params,
    tokens: torch.Tensor,
    cfg: LlamaConfig,
    *,
    attn_impl: str = "auto",
) -> torch.Tensor:
    """Logits ``[B, S, vocab]`` for token ids ``[B, S]``."""
    x = llama_hidden(params, tokens, cfg, attn_impl=attn_impl)
    return gather_vocab(torch.einsum("bse,ev->bsv", x, llama_head(params, cfg)))


def param_count(cfg: LlamaConfig) -> int:
    e, f, hq, hkv, d, l, v = (
        cfg.hidden, cfg.intermediate, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
        cfg.n_layers, cfg.vocab_size,
    )
    per_layer = 2 * e + e * hq * d + 2 * e * hkv * d + hq * d * e + 3 * e * f
    total = v * e + l * per_layer + e
    if not cfg.tied_embeddings:
        total += e * v
    return total
