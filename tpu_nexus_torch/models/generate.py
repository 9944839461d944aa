"""KV-cache autoregressive decoding: the port of ``tpu_nexus/models/generate.py``.

* **Prefill reuses the forward** (:func:`llama_hidden` with
  ``return_kv=True``): the flash kernel runs the whole prompt once per
  layer and hands back the post-RoPE K/V, which :func:`prefill` lays into a
  ``[L, B, max_len, Hkv, D]`` cache.
* **Decode attention is the split-KV kernel** (ops/decode_attention.py) on
  the card, once per layer per step; the plain masked einsum elsewhere.
* The cache is updated IN PLACE (the JAX package returns a new buffer):
  :func:`decode_step` writes each layer's new K/V row into the tensors it
  was given and returns the same dict.
* Rows decode in lockstep at shared cache slots; ragged batches RIGHT-pad
  to a common width and pass ``prompt_lengths`` (per-row RoPE positions,
  pad slots masked).  ``pos`` may also be a ``[B]`` tensor: per-slot
  cursors, the continuous-batching step.
* **Int8 KV cache** (``kv_quant="int8"``): K/V rows are quantized at
  write (int8 values + one f32 scale per slot and KV head, the recipe of
  the int8 weights) and read every later step as int8; the mode travels
  with the cache (``"k_s" in cache``).
* Quantized weight trees (``models/quant.py``) run through the same code:
  every weight product goes through ``weight_einsum``.
* The MoE family decodes through the same code: its configs are
  normalized by :func:`_decode_cfg` (scatter dispatch, dropless capacity)
  and its post-attention sub-block is the routed experts (:func:`_ffn_block`).

Left out of this slice, each raising where it would be asked for
(ROADMAP.md): ``decode_scan``, ``extend_step``, ``verify_step`` and the
paged cache (``block_tables``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple, Union

import torch

from tpu_nexus_torch.models.llama import (
    LlamaConfig,
    _rope,
    layer_params,
    llama_head,
    llama_hidden,
    mlp_block,
    rope_tables,
)
from tpu_nexus_torch.models.moe import MoeConfig, moe_block, moe_head, moe_hidden
from tpu_nexus_torch.models.quant import quantize_tensor
from tpu_nexus_torch.ops.decode_attention import decode_attention, decode_attention_plain
from tpu_nexus_torch.ops.quant_matmul import weight_einsum
from tpu_nexus_torch.ops.rmsnorm import rms_norm

ModelConfig = Union[LlamaConfig, MoeConfig]  # the same stacked-layer layout
_NEG_INF = -1e30
DECODE_IMPLS = ("auto", "plain")

#: {"k": [L, B, max_len, Hkv, D], "v": same}; int8 KV mode adds per-slot
#: scales {"k_s": [L, B, max_len, Hkv, 1] f32, "v_s": same}
Cache = Dict[str, torch.Tensor]


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md: {item})")


def _check_config(cfg: Any) -> None:
    if not isinstance(cfg, (LlamaConfig, MoeConfig)):
        raise TypeError(f"decoding needs a LlamaConfig or MoeConfig, got {type(cfg).__name__}")


def _decode_cfg(cfg):
    """Normalize a config for the decode path.  MoE always uses scatter
    dispatch here: the training-tuned gmm layout pads each call's
    assignments up to whole m-tiles, which at decode token counts inflates
    expert compute many times over.  Scatter is capacity-bounded, so the
    capacity factor rises to the dropless bound ``n_experts /
    experts_per_token`` (``expert_capacity >= T`` for any routing): a model
    trained dropless must not drop assignments at serve time."""
    if isinstance(cfg, MoeConfig):
        dropless = cfg.n_experts / cfg.experts_per_token
        if cfg.dispatch != "scatter" or cfg.capacity_factor < dropless:
            return dataclasses.replace(
                cfg, dispatch="scatter", capacity_factor=max(cfg.capacity_factor, dropless)
            )
    return cfg


def _prefill_hidden_kv(params, tokens, cfg, attn_impl: str = "auto"):
    """Family dispatch for the prompt pass (the router aux is dropped)."""
    if isinstance(cfg, MoeConfig):
        hidden, _aux, kv = moe_hidden(params, tokens, cfg, return_kv=True, attn_impl=attn_impl)
        return hidden, kv
    return llama_hidden(params, tokens, cfg, return_kv=True, attn_impl=attn_impl)


def _head(params, cfg):
    return moe_head(params, cfg) if isinstance(cfg, MoeConfig) else llama_head(params, cfg)


def _ffn_block(x, layer, cfg):
    """Post-attention sub-block: dense SwiGLU (Llama) or routed experts
    (MoE: a router over the step's tokens, aux discarded).  The config
    arrives normalized by :func:`_decode_cfg`."""
    if isinstance(cfg, MoeConfig):
        return moe_block(x, layer, cfg)[0]
    return mlp_block(x, layer, cfg)


def _quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-slot int8: amax over the head_dim of each (layer,
    batch, position, kv-head) cell / 127 — through the int8 weight recipe
    itself, so the two quantizations cannot drift."""
    t = quantize_tensor(x, (-1,))
    return t.q, t.s


def cached_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv_len: int,
    prompt_lengths: Optional[torch.Tensor] = None,
    prompt_width: Optional[int] = None,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    block_tables: Optional[torch.Tensor] = None,
    logical_limit: Optional[int] = None,
    q_starts: Optional[torch.Tensor] = None,
    impl: str = "auto",
) -> torch.Tensor:
    """GQA attention of a short query block against a fixed-size cache.

    ``q`` [B, q_len<=8, Hq, D]; ``k``/``v`` [B, max_len, Hkv, D];
    ``kv_len`` (host int) — the queries occupy cache slots ``[kv_len -
    q_len, kv_len)``; at q_len > 1 query row ``j`` sees slots ``<= kv_len
    - q_len + j``.  Ragged right-padded batches pass ``prompt_lengths`` [B]
    + the pad width ``prompt_width``.  Int8 cache mode passes
    ``k_scale``/``v_scale`` [B, max_len, Hkv, 1] with int8 ``k``/``v``: the
    dequantization is deferred past the dots (ops/decode_attention.py).

    ``impl``: ``"auto"`` runs the plain einsum on a CPU tensor and the
    decode kernel's wrapper on any other, which launches the kernel or
    raises on inputs it does not take; ``"plain"`` forces the plain
    einsum."""
    if impl not in DECODE_IMPLS:
        raise ValueError(f"unknown decode impl {impl!r}; use auto or plain")
    if logical_limit is not None:
        raise _not_ported("paged decode (logical_limit)", "serve-engine slice")
    if impl == "auto" and q.device.type != "cpu":
        return decode_attention(
            q, k, v, kv_len, prompt_lengths, prompt_width, k_scale, v_scale,
            block_tables=block_tables, q_starts=q_starts,
        )
    if block_tables is not None or q_starts is not None:
        raise _not_ported("paged / q_starts decode attention", "serve-engine slice")
    return decode_attention_plain(q, k, v, kv_len, prompt_lengths, prompt_width, k_scale, v_scale)


@torch.no_grad()  # decoding never differentiates: no graph over the trainable params
def prefill(
    params,
    tokens: torch.Tensor,
    cfg: ModelConfig,
    max_len: int,
    prompt_lengths: Optional[torch.Tensor] = None,
    kv_quant: str = "",
    attn_impl: str = "auto",
) -> Tuple[Cache, torch.Tensor]:
    """Run the prompt through the forward once; return the padded KV cache
    and each row's last REAL position's logits ``[B, vocab]``.
    ``kv_quant="int8"`` stores the cache as int8 with per-slot f32 scales
    (zero in the unwritten slots).  ``attn_impl`` picks the prefill
    attention (ops/attention.py)."""
    _check_config(cfg)
    cfg = _decode_cfg(cfg)
    b, s = tokens.shape
    if s > max_len:
        raise ValueError(f"prompt length {s} exceeds cache max_len {max_len}")
    if kv_quant not in ("", "int8"):
        raise ValueError(f"unknown kv_quant mode {kv_quant!r}; use 'int8' or ''")
    hidden, (k, v) = _prefill_hidden_kv(params, tokens, cfg, attn_impl)
    filled = {"k": k, "v": v}
    if kv_quant == "int8":
        (filled["k"], filled["k_s"]), (filled["v"], filled["v_s"]) = _quantize_kv(k), _quantize_kv(v)
    cache = {}
    for name, x in filled.items():
        cache[name] = torch.zeros((*x.shape[:2], max_len, *x.shape[3:]), dtype=x.dtype, device=x.device)
        cache[name][:, :, :s] = x
    if prompt_lengths is None:
        last = hidden[:, -1]
    else:
        # clamp at 0: a (buggy) zero length must not wrap to the last pad
        idx = (prompt_lengths.to(hidden.device).long() - 1).clamp_min(0)
        last = hidden[torch.arange(b, device=hidden.device), idx]
    logits = torch.einsum("be,ev->bv", last, _head(params, cfg))
    return cache, logits


@torch.no_grad()
def decode_step(
    params,
    cache: Cache,
    token: torch.Tensor,
    pos: Union[int, torch.Tensor],
    cfg: ModelConfig,
    prompt_lengths: Optional[torch.Tensor] = None,
    prompt_width: Optional[int] = None,
    decode_kernel: str = "auto",
    block_tables: Optional[torch.Tensor] = None,
    logical_limit: Optional[int] = None,
    write_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Cache]:
    """One autoregressive step: ``token`` [B] at WRITE position ``pos`` →
    (logits [B, vocab], the cache updated in place).

    * scalar ``pos`` (int or 0-d tensor): every row writes slot ``pos``;
    * ragged (``prompt_lengths`` [B] + the pad width ``prompt_width``):
      row ``b``'s RoPE position is ``len_b + (pos - width)`` and its pad
      slots ``[len_b, width)`` are masked;
    * per-slot (``pos`` a [B] tensor): row ``b`` writes at ``pos[b]``,
      rotates at ``pos[b]`` and attends ``[0, pos[b]]`` — through the same
      ragged mask with ``lens = pos + 1`` and ``width = max_len``.

    ``decode_kernel``: ``"auto"`` | ``"plain"`` (see
    :func:`cached_attention`)."""
    _check_config(cfg)
    cfg = _decode_cfg(cfg)
    if block_tables is not None or logical_limit is not None:
        raise _not_ported("paged decode (block_tables)", "serve-engine slice")
    if write_mask is not None:
        raise _not_ported("frozen-row decode (write_mask, decode_scan)", "serve-engine slice")
    kv_quant = "k_s" in cache  # int8 KV mode travels with the cache itself
    ct = cfg.dtype
    b = token.shape[0]
    max_len = cache["k"].shape[2]
    device = cache["k"].device
    per_slot = isinstance(pos, torch.Tensor) and pos.dim() == 1
    rows = torch.arange(b, device=device)
    if per_slot:
        if prompt_lengths is not None or prompt_width is not None:
            raise ValueError(
                "per-slot decode (vector pos) keeps each row's cache contiguous; "
                "prompt_lengths/prompt_width do not apply"
            )
        pos = pos.to(device=device, dtype=torch.long)
        deepest = int(pos.max())  # sizes the decode kernel's grid: one host read per step
        if deepest >= max_len or int(pos.min()) < 0:
            raise ValueError(f"per-slot positions outside [0, {max_len})")
        positions = pos[:, None]
        att_lens: Optional[torch.Tensor] = (pos + 1).to(torch.int32)
        att_width: Optional[int] = max_len
        att_kv_len = deepest + 1
        write_idx = (rows, pos)
    else:
        pos = int(pos)
        if not 0 <= pos < max_len:
            raise ValueError(f"decode position {pos} outside [0, {max_len})")
        if prompt_lengths is None:
            positions = torch.full((b, 1), pos, dtype=torch.long, device=device)
            att_lens, att_width = None, None
        else:
            if prompt_width is None:
                raise ValueError("ragged decode needs prompt_width")
            lens = prompt_lengths.to(device=device, dtype=torch.long)
            positions = (lens + (pos - prompt_width))[:, None]
            att_lens, att_width = lens.to(torch.int32), prompt_width
        att_kv_len = pos + 1
        write_idx = (rows, torch.full((b,), pos, dtype=torch.long, device=device))
    cos, sin = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    x = params["embed"]["tokens"][token.to(device)].to(ct)[:, None, :]  # [B, 1, E]
    for li in range(cache["k"].shape[0]):
        layer = layer_params(params, li)
        h = rms_norm(x, layer["attn_norm"], cfg.norm_eps)
        q = weight_einsum("bse,ehd->bshd", h, layer["wq"], ct)
        k = weight_einsum("bse,ehd->bshd", h, layer["wk"], ct)
        v = weight_einsum("bse,ehd->bshd", h, layer["wv"], ct)
        q = _rope(q, cos, sin)
        k = _rope(k, cos, sin)
        scales = {}
        if kv_quant:
            # quantize at write: the row is written once and re-read every
            # later step as int8, its scale at the same index
            (k, k_s), (v, v_s) = _quantize_kv(k), _quantize_kv(v)
            cks, cvs = cache["k_s"][li], cache["v_s"][li]
            cks[write_idx] = k_s[:, 0]
            cvs[write_idx] = v_s[:, 0]
            scales = dict(k_scale=cks, v_scale=cvs)
        ck, cv = cache["k"][li], cache["v"][li]
        ck[write_idx] = k[:, 0]
        cv[write_idx] = v[:, 0]
        o = cached_attention(
            q, ck, cv, att_kv_len, prompt_lengths=att_lens, prompt_width=att_width,
            impl=decode_kernel, **scales,
        )
        x = x + weight_einsum("bshd,hde->bse", o, layer["wo"], ct)
        x = _ffn_block(x, layer, cfg)
    hidden = rms_norm(x, params["out_norm"], cfg.norm_eps)
    logits = torch.einsum("be,ev->bv", hidden[:, 0], _head(params, cfg))
    return logits, cache


def decode_scan(*args, **kwargs):
    raise _not_ported("decode_scan (in-step multi-token decode)", "serve-engine slice")


def extend_step(*args, **kwargs):
    raise _not_ported("extend_step (paged partial prefill)", "serve-engine slice")


def verify_step(*args, **kwargs):
    raise _not_ported("verify_step (speculative verify)", "serve-engine slice")


@torch.no_grad()
def teacher_forced_decode_ce(
    params, tokens: torch.Tensor, cfg: ModelConfig, kv_quant: str = "", decode_kernel: str = "auto",
) -> torch.Tensor:
    """Mean next-token cross-entropy of ``tokens`` [B, S] scored THROUGH
    the decode path: prefill one token, then ``decode_step`` with teacher
    forcing.  The quality probe for the serving-side levers (int8/int4
    weights, int8 KV): it exercises exactly the code ``generate`` runs."""
    tokens = tokens.long()
    cache, logits = prefill(params, tokens[:, :1], cfg, max_len=tokens.shape[1], kv_quant=kv_quant)
    ces = []
    for pos in range(1, tokens.shape[1]):
        tok_next = tokens[:, pos].to(logits.device)
        lp = torch.log_softmax(logits.float(), dim=-1)
        ces.append(-torch.gather(lp, -1, tok_next[:, None])[:, 0])
        logits, cache = decode_step(params, cache, tok_next, pos, cfg, decode_kernel=decode_kernel)
    return torch.stack(ces).mean()


def sample_logits(
    logits: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    temperature: float = 0.0,
    top_k: int = 0,
    top_p: float = 1.0,
    dtype: torch.dtype = torch.int32,
) -> torch.Tensor:
    """Next-token sampling of ``logits`` [B, vocab] → tokens [B].
    ``temperature=0`` is greedy argmax (``generator`` unused); otherwise
    categorical with optional ``top_k`` / ``top_p`` truncation, drawn from
    ``generator``.  torch's random stream is not jax's: sampled tokens
    agree with the JAX package in distribution, not draw for draw."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1).to(dtype)
    logits = logits.float() / temperature
    if top_k:
        kth = torch.topk(logits, top_k, dim=-1).values[:, -1:]
        logits = torch.where(logits >= kth, logits, torch.full_like(logits, _NEG_INF))
    if top_p < 1.0:
        srt = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(srt, dim=-1), dim=-1)
        n_keep = (cum < top_p).sum(dim=-1, keepdim=True) + 1
        cutoff = torch.gather(srt, -1, n_keep - 1)
        logits = torch.where(logits >= cutoff, logits, torch.full_like(logits, _NEG_INF))
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(dtype)


@torch.inference_mode()
def generate(
    params,
    prompt: torch.Tensor,
    cfg: ModelConfig,
    *,
    max_new_tokens: int,
    temperature: float = 0.0,
    top_k: int = 0,
    top_p: float = 1.0,
    generator: Optional[torch.Generator] = None,
    max_len: Optional[int] = None,
    prompt_lengths: Optional[torch.Tensor] = None,
    kv_quant: str = "",
    decode_kernel: str = "auto",
    attn_impl: str = "auto",
) -> torch.Tensor:
    """Decode ``max_new_tokens`` continuations of ``prompt`` [B, S] →
    [B, max_new_tokens].  ``temperature=0`` is greedy; otherwise sampling
    from ``generator``, optionally truncated to ``top_k`` / the ``top_p``
    nucleus.  Ragged batches RIGHT-pad and pass ``prompt_lengths`` [B].
    ``kv_quant="int8"`` keeps the KV cache int8 with per-slot scales.
    ``attn_impl`` / ``decode_kernel`` pick the prefill and decode attention
    (``"plain"`` runs the whole path without the kernels)."""
    b, s = prompt.shape
    if (top_k or top_p < 1.0) and temperature == 0.0:
        raise ValueError("top_k/top_p truncation requires temperature > 0")
    if top_k and not (0 < top_k <= cfg.vocab_size):
        raise ValueError(f"top_k {top_k} outside (0, vocab_size={cfg.vocab_size}]")
    if not 0.0 < top_p <= 1.0:
        raise ValueError(f"top_p {top_p} outside (0, 1]")
    total = s + max_new_tokens
    max_len = max_len or total
    if total > max_len:
        raise ValueError(f"prompt {s} + {max_new_tokens} new tokens exceeds max_len {max_len}")
    if max_len > cfg.max_seq_len:
        raise ValueError(f"max_len {max_len} exceeds the config's context window {cfg.max_seq_len}")
    if temperature > 0.0 and generator is None:
        raise ValueError("sampling (temperature > 0) needs a torch.Generator")

    cache, logits = prefill(params, prompt, cfg, max_len, prompt_lengths, kv_quant, attn_impl)
    toks = []
    for i in range(max_new_tokens):
        tok = sample_logits(logits, generator, temperature, top_k, top_p, dtype=prompt.dtype)
        toks.append(tok)
        if i + 1 < max_new_tokens:  # the last token's logits would go unread
            logits, cache = decode_step(
                params, cache, tok, s + i, cfg,
                prompt_lengths=prompt_lengths, prompt_width=s, decode_kernel=decode_kernel,
            )
    return torch.stack(toks, dim=1)  # [B, max_new_tokens]
