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
* **The serving engine's entry points** (tpu_nexus_torch/serving): the
  paged cache (a block pool ``[L, NB, page, Hkv, D]`` addressed through
  per-row ``block_tables``), frozen rows (``write_mask``),
  :func:`decode_scan` (k steps per call, stop detection on the device),
  :func:`extend_step` (partial prefill through the paged cache) and
  :func:`verify_step` (speculative verify through the kernel's
  ``q_starts`` mode).  Given the host bounds (``max_pos``, ``start``)
  that size each kernel grid, none of them reads the device back.
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
from tpu_nexus_torch.ops.decode_attention import MAX_DECODE_Q_LEN, decode_attention, decode_attention_plain
from tpu_nexus_torch.ops.quant_matmul import weight_einsum
from tpu_nexus_torch.ops.rmsnorm import rms_norm
from tpu_nexus_torch.parallel.collectives import embed_rows, gather_vocab, reduce_tp

ModelConfig = Union[LlamaConfig, MoeConfig]  # the same stacked-layer layout
_NEG_INF = -1e30
DECODE_IMPLS = ("auto", "plain")

#: {"k": [L, B, max_len, Hkv, D], "v": same}; int8 KV mode adds per-slot
#: scales {"k_s": [L, B, max_len, Hkv, 1] f32, "v_s": same}.  The paged
#: cache has the same keys over a block pool [L, num_blocks, page, ...].
Cache = Dict[str, torch.Tensor]


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

    ``q`` [B, q_len, Hq, D]; ``k``/``v`` [B, max_len, Hkv, D];
    ``kv_len`` (host int) — the queries occupy cache slots ``[kv_len -
    q_len, kv_len)``; at q_len > 1 query row ``j`` sees slots ``<= kv_len
    - q_len + j``.  Ragged right-padded batches pass ``prompt_lengths`` [B]
    + the pad width ``prompt_width``.  Int8 cache mode passes
    ``k_scale``/``v_scale`` [B, max_len, Hkv, 1] with int8 ``k``/``v``: the
    dequantization is deferred past the dots (ops/decode_attention.py).

    Paged mode (``block_tables`` [B, n_log] int32): ``k``/``v`` are the
    block pool ``[num_blocks, page, Hkv, D]`` and row ``b``'s logical slot
    ``s`` lives at ``(block_tables[b, s // page], s % page)``; the plain
    path gathers each row's view cut at ``logical_limit`` (the engine's
    ``max_len``), so it reduces over the same width as a contiguous cache.
    Ragged-q mode (``q_starts`` [B]): row ``b``'s query ``j`` sits at
    ``q_starts[b] + j`` and sees exactly ``[0, q_starts[b] + j]`` within
    the ``prompt_lengths``/width window; ``kv_len`` only bounds the loop.

    ``impl``: ``"auto"`` runs the plain einsum on a CPU tensor and the
    decode kernel's wrapper on any other, which launches the kernel or
    raises on inputs it does not take; ``"plain"`` forces the plain
    einsum.  A query block wider than ``MAX_DECODE_Q_LEN`` (a long extend
    tail) is plain PyTorch on every device, as the JAX package computes it
    in XLA outside its kernel."""
    if impl not in DECODE_IMPLS:
        raise ValueError(f"unknown decode impl {impl!r}; use auto or plain")
    kw = dict(block_tables=block_tables, q_starts=q_starts, logical_limit=logical_limit)
    if impl == "auto" and q.device.type != "cpu" and q.shape[1] <= MAX_DECODE_Q_LEN:
        return decode_attention(q, k, v, kv_len, prompt_lengths, prompt_width, k_scale, v_scale, **kw)
    return decode_attention_plain(q, k, v, kv_len, prompt_lengths, prompt_width, k_scale, v_scale, **kw)


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
    logits = gather_vocab(torch.einsum("be,ev->bv", last, _head(params, cfg)))
    return cache, logits


def _write_columns(arr: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor, update: torch.Tensor,
                   keep: Optional[torch.Tensor] = None) -> None:
    """``arr[rows, cols[:, j]] = update[:, j]`` column by column, in place,
    where ``keep[:, j]`` is true (all of them without ``keep``); a column
    index past ``arr``'s slot axis is dropped.  A dropped or kept-out entry
    rewrites the slot's own value (the index is clamped into range), and
    the columns run in order, so a later dropped column can only rewrite
    what an earlier one wrote: no host read, no duplicate-index race."""
    n = arr.shape[1]
    for j in range(cols.shape[1]):
        col = cols[:, j]
        idx = col.clamp(0, n - 1)
        live = col < n if keep is None else keep[:, j] & (col < n)
        shape = (-1,) + (1,) * (update.dim() - 2)
        arr[rows, idx] = torch.where(live.view(shape), update[:, j], arr[rows, idx])


def _paged_address(block_tables: torch.Tensor, positions: torch.Tensor, page: int,
                   keep: Optional[torch.Tensor] = None):
    """(physical block, offset) of logical ``positions`` [B, W] through the
    table; positions past the table row, or where ``keep`` is false, go to
    the scratch block 0, which nothing reads unmasked."""
    n_log = block_tables.shape[1]
    lb = (positions // page).clamp(max=n_log - 1)
    phys = torch.gather(block_tables.long(), 1, lb)
    live = positions < n_log * page
    if keep is not None:
        live = live & keep
    return torch.where(live, phys, torch.zeros_like(phys)), positions % page


def _layers(params, cache: Cache, cfg, x: torch.Tensor, cos, sin, write, attend):
    """The decoder stack over one step's ``x`` [B, W, E]: each layer's new
    K/V rows go into the cache through ``write(arr, update)`` (int8-KV
    quantizes them first) and attention runs as ``attend(q, ck, cv,
    scales)``."""
    ct = cfg.dtype
    kv_quant = "k_s" in cache  # int8 KV mode travels with the cache itself
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
            write(cache["k_s"][li], k_s)
            write(cache["v_s"][li], v_s)
            scales = dict(k_scale=cache["k_s"][li], v_scale=cache["v_s"][li])
        write(cache["k"][li], k)
        write(cache["v"][li], v)
        o = attend(q, cache["k"][li], cache["v"][li], scales)
        x = x + reduce_tp(weight_einsum("bshd,hde->bse", o, layer["wo"], ct))
        x = _ffn_block(x, layer, cfg)
    return rms_norm(x, params["out_norm"], cfg.norm_eps)


def _host_max(pos: torch.Tensor, max_pos: Optional[int]) -> int:
    """The deepest cursor as a host int: ``max_pos`` when the caller knows
    it, else read from ``pos`` (free for a CPU tensor, one device read
    otherwise)."""
    return int(max_pos) if max_pos is not None else int(pos.max())


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
    max_pos: Optional[int] = None,
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
      ``max_pos`` is a host bound on ``max(pos)`` that sizes the kernel's
      grid; without it ``pos`` is read back once.  A write past the cache
      is dropped, as the JAX package's scatter drops it.

    Per-slot only: paged mode (``block_tables`` [B, n_log], the cache a
    block pool ``[L, NB, page, Hkv, D]``) writes and reads through the
    table (``logical_limit``: the engine's ``max_len``); frozen rows
    (``write_mask`` [B] bool false) write nothing — a contiguous row keeps
    its slot, a paged row writes to the scratch block — and their logits
    are garbage the caller discards.  Copy-on-write is the caller's job.

    ``decode_kernel``: ``"auto"`` | ``"plain"`` (see
    :func:`cached_attention`)."""
    _check_config(cfg)
    cfg = _decode_cfg(cfg)
    ct = cfg.dtype
    b = token.shape[0]
    device = cache["k"].device
    per_slot = isinstance(pos, torch.Tensor) and pos.dim() == 1
    paged = block_tables is not None
    if (paged or write_mask is not None) and not per_slot:
        raise ValueError("paged decode (block_tables) and write_mask (frozen rows) require per-slot vector pos")
    rows = torch.arange(b, device=device)
    if paged:
        page = cache["k"].shape[2]
        block_tables = block_tables.to(device=device, dtype=torch.int32)
        max_len = block_tables.shape[1] * page
    else:
        max_len = cache["k"].shape[2]
    if per_slot:
        if prompt_lengths is not None or prompt_width is not None:
            raise ValueError(
                "per-slot decode (vector pos) keeps each row's cache contiguous; "
                "prompt_lengths/prompt_width do not apply"
            )
        deepest = _host_max(pos, max_pos)  # sizes the decode kernel's grid
        pos = pos.to(device=device, dtype=torch.long)
        positions = pos[:, None]
        att_lens: Optional[torch.Tensor] = (pos + 1).to(torch.int32)
        att_width: Optional[int] = max_len
        att_kv_len = min(deepest, max_len - 1) + 1
        keep = None if write_mask is None else write_mask.to(device=device, dtype=torch.bool)[:, None]
        if paged:
            phys, off = _paged_address(block_tables, positions, page, keep)

            def write(arr, update):
                arr[phys[:, 0], off[:, 0]] = update[:, 0]
        else:
            def write(arr, update):
                _write_columns(arr, rows, positions, update, keep)
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

        def write(arr, update):
            arr[:, pos] = update[:, 0]

    def attend(q, ck, cv, scales):
        return cached_attention(
            q, ck, cv, att_kv_len, prompt_lengths=att_lens, prompt_width=att_width,
            block_tables=block_tables, logical_limit=logical_limit, impl=decode_kernel, **scales,
        )

    cos, sin = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    x = embed_rows(params["embed"]["tokens"], token.to(device).long()).to(ct)[:, None, :]  # [B, 1, E]
    hidden = _layers(params, cache, cfg, x, cos, sin, write, attend)
    logits = gather_vocab(torch.einsum("be,ev->bv", hidden[:, 0], _head(params, cfg)))
    return logits, cache


@torch.no_grad()
def decode_scan(
    params,
    cache: Cache,
    token: torch.Tensor,
    pos: torch.Tensor,
    limit: torch.Tensor,
    cfg: ModelConfig,
    *,
    num_steps: int,
    generator: Optional[torch.Generator] = None,
    temperature: float = 0.0,
    top_k: int = 0,
    top_p: float = 1.0,
    stop_token: int = -1,
    decode_kernel: str = "auto",
    block_tables: Optional[torch.Tensor] = None,
    logical_limit: Optional[int] = None,
    max_pos: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, Cache]:
    """Multi-step decode: ``num_steps`` per-slot :func:`decode_step` calls
    in one call, with no host read inside the loop (the JAX package's
    ``lax.scan``).  ``token`` [B] is each slot's last emitted token (its KV
    not yet written), ``pos`` [B] its cursor, ``limit`` [B] its emission
    budget for this call: a row emits ``min(limit[b], num_steps)`` tokens,
    fewer if it samples ``stop_token`` (>= 0: the stop token is emitted,
    then the row freezes).  Frozen rows write nothing (``write_mask``) and
    stop advancing.  ``max_pos`` bounds ``max(pos)`` on the host (read
    back once before the loop without it).

    Returns ``(tokens [B, num_steps], counts [B], last_token [B], last_pos
    [B], cache)``: row ``b``'s real emissions are its first ``counts[b]``
    columns.  Sampling draws from ``generator``."""
    if num_steps < 1:
        raise ValueError(f"num_steps must be >= 1, got {num_steps}")
    stop_token = int(stop_token)
    device = cache["k"].device
    b = token.shape[0]
    tok = token.to(device=device, dtype=torch.int32).reshape(b)
    p = pos.to(device=device, dtype=torch.int32).reshape(b)
    limit = limit.to(device=device, dtype=torch.int32).reshape(b)
    deepest = _host_max(pos, max_pos)
    emitted = torch.zeros(b, dtype=torch.int32, device=device)
    alive = torch.ones(b, dtype=torch.bool, device=device)
    toks = []
    for step in range(num_steps):
        active = alive & (emitted < limit)
        logits, cache = decode_step(
            params, cache, tok, p, cfg, decode_kernel=decode_kernel,
            block_tables=block_tables, logical_limit=logical_limit,
            write_mask=active, max_pos=deepest + step,
        )
        nxt = sample_logits(logits, generator, temperature, top_k, top_p)
        tok = torch.where(active, nxt, tok)
        if stop_token >= 0:
            alive = alive & ~(active & (nxt == stop_token))
        emitted = emitted + active.to(torch.int32)
        p = p + active.to(torch.int32)
        toks.append(nxt)
    return torch.stack(toks, dim=1), emitted, tok, p, cache


@torch.no_grad()
def extend_step(
    params,
    cache: Cache,
    tokens: torch.Tensor,
    start: int,
    length: torch.Tensor,
    block_tables: torch.Tensor,
    cfg: ModelConfig,
    decode_kernel: str = "auto",
    logical_limit: Optional[int] = None,
) -> Tuple[torch.Tensor, Cache]:
    """Partial prefill through the PAGED cache, the tail half of a
    prefix-sharing admission.  ``tokens`` [B, W] right-padded (``length``
    [B] real per row) run at logical positions ``start + [0, W)``, where
    ``start`` (host int) is the shared-prefix length.  Each row's new K/V
    rows go through its ``block_tables`` row (pad rows to the scratch
    block); query ``j`` attends the cached prefix plus the tail up to
    ``start + j`` — the uniform multi-query mode at ``kv_len = start + W``,
    the decode kernel's paged mode for W <= 8.  Returns each row's
    last-real-token logits [B, vocab] and the cache, updated in place.
    Copy-on-write is the caller's job."""
    _check_config(cfg)
    cfg = _decode_cfg(cfg)
    device = cache["k"].device
    b, w = tokens.shape
    start = int(start)
    page = cache["k"].shape[2]
    block_tables = block_tables.to(device=device, dtype=torch.int32)
    length = length.to(device=device, dtype=torch.long).reshape(b)
    idx = torch.arange(w, device=device)
    positions = (start + idx)[None, :].expand(b, w)
    phys, off = _paged_address(block_tables, positions, page, idx[None, :] < length[:, None])

    def write(arr, update):
        arr[phys, off] = update

    def attend(q, ck, cv, scales):
        return cached_attention(
            q, ck, cv, start + w, block_tables=block_tables, logical_limit=logical_limit,
            impl=decode_kernel, **scales,
        )

    cos, sin = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    x = embed_rows(params["embed"]["tokens"], tokens.to(device).long()).to(cfg.dtype)  # [B, W, E]
    hidden = _layers(params, cache, cfg, x, cos, sin, write, attend)
    # each row's last REAL token gives its first output logits (clamp at
    # 0: a buggy zero length must not wrap to the last pad row)
    last = hidden[torch.arange(b, device=device), (length - 1).clamp_min(0)]
    return gather_vocab(torch.einsum("be,ev->bv", last, _head(params, cfg))), cache


@torch.no_grad()
def verify_step(
    params,
    cache: Cache,
    tokens: torch.Tensor,
    pos: torch.Tensor,
    cfg: ModelConfig,
    decode_kernel: str = "auto",
    block_tables: Optional[torch.Tensor] = None,
    logical_limit: Optional[int] = None,
    max_pos: Optional[int] = None,
) -> Tuple[torch.Tensor, Cache]:
    """Multi-token verification, the target half of speculative decoding.
    ``tokens`` [B, W] is each slot's ``[last_accepted, d_1, ..., d_{W-1}]``
    and ``pos`` [B] its cursor: row ``b`` writes its W tokens' KV at
    ``pos[b] + [0, W)`` and query ``j`` attends ``[0, pos[b] + j]`` through
    the decode kernel's ``q_starts`` mode.  Returns logits [B, W, vocab]
    (row ``j``: the target's distribution after drafts ``<= j``) and the
    cache, updated in place.  Positions past the cache (contiguous) are
    dropped, past the table row (paged) go to the scratch block.
    ``max_pos`` is a host bound on ``max(pos)`` (read back without it).
    Rollback and copy-on-write are the caller's job."""
    _check_config(cfg)
    cfg = _decode_cfg(cfg)
    device = cache["k"].device
    b, w = tokens.shape
    deepest = _host_max(pos, max_pos)
    pos = pos.to(device=device, dtype=torch.long).reshape(b)
    positions = pos[:, None] + torch.arange(w, device=device)[None, :]  # [B, W]
    if block_tables is not None:
        page = cache["k"].shape[2]
        block_tables = block_tables.to(device=device, dtype=torch.int32)
        phys, off = _paged_address(block_tables, positions, page)

        def write(arr, update):
            arr[phys, off] = update
    else:
        rows = torch.arange(b, device=device)

        def write(arr, update):
            _write_columns(arr, rows, positions, update)

    # the mask is the per-row ragged-q clamp alone (lens 0, width 0)
    att_lens = torch.zeros(b, dtype=torch.int32, device=device)
    q_starts = pos.to(torch.int32)

    def attend(q, ck, cv, scales):
        return cached_attention(
            q, ck, cv, deepest + w, prompt_lengths=att_lens, prompt_width=0,
            block_tables=block_tables, logical_limit=logical_limit, q_starts=q_starts,
            impl=decode_kernel, **scales,
        )

    cos, sin = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    x = embed_rows(params["embed"]["tokens"], tokens.to(device).long()).to(cfg.dtype)  # [B, W, E]
    hidden = _layers(params, cache, cfg, x, cos, sin, write, attend)
    return gather_vocab(torch.einsum("bse,ev->bsv", hidden, _head(params, cfg))), cache


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


@torch.no_grad()
def teacher_forced_logits(
    params, cfg: ModelConfig, prompts: torch.Tensor, forced: torch.Tensor, kv_quant: str = "",
    decode_kernel: str = "auto", attn_impl: str = "auto",
) -> torch.Tensor:
    """Logits ``[B, T, vocab]`` along a forced continuation: ``prompts``
    [B, S] through :func:`prefill`, then ``forced`` [B, T] fed one token at
    a time through :func:`decode_step`; row ``j`` is the distribution that
    predicts ``forced[:, j]``.  Two runs given the same stream (one device
    and its shards, kernels and plain) compare step by step this way."""
    b, s = prompts.shape
    t = forced.shape[1]
    cache, logits = prefill(params, prompts, cfg, max_len=s + t, kv_quant=kv_quant, attn_impl=attn_impl)
    out = [logits]
    for j in range(t - 1):
        logits, cache = decode_step(params, cache, forced[:, j], s + j, cfg, decode_kernel=decode_kernel)
        out.append(logits)
    return torch.stack(out, dim=1)


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
