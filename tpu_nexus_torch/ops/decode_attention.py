"""Decode attention: the split-KV CUDA kernel's wrapper and its plain version.

Replaces ``tpu_nexus/ops/decode_attention.py::_decode_kernel`` (launched by
``decode_attention``) in all its modes: every decode, extend and verify step
runs it once per layer.  The kernel lives in ``csrc/decode_attention.cu``;
its source note says what bounds it on the H100 (device-memory bandwidth,
and latency at short contexts) and how the design answers that.  The
wrapper plans the KV splits (:func:`split_plan`: by the live length and the
CTAs the card holds) and keeps the merge's workspace, whose arrival counters
must stay zero between launches, per device and stream.

Contract (the same as the JAX package's ``decode_attention`` and XLA
fallback): ``q`` [B, q_len<=8, Hq, D]; ``k``/``v`` [B, max_len, Hkv, D];
``kv_len`` counts the live slots, the queries occupy slots ``[kv_len -
q_len, kv_len)``.  Slot ``s`` is live for batch row ``b`` and query row
``j`` iff ``s < lens[b] or (width <= s <= kv_len - q_len + j)``, where
``lens``/``width`` come from a ragged right-padded batch
(``prompt_lengths``/``prompt_width``; 0 and 0 otherwise).

Int8-KV mode (``k_scale``/``v_scale`` shaped like the cache with a last
dim of 1, f32, both or neither; ``k``/``v`` int8): the dequantization is
deferred past the dots, which is exact because a slot's scale is constant
along head_dim — ``k_scale`` multiplies the f32 scores, ``v_scale`` the
softmax weights before they are rounded to q's dtype.

Paged mode (``block_tables`` [B, n_log] int32): ``k``/``v`` are the block
pool [NB, page, Hkv, D] (scales [NB, page, Hkv, 1]) and row ``b``'s
logical slot ``s`` lives at ``(block_tables[b, s // page], s % page)``;
every position stays logical.  Any page size: the kernel addresses slots
one by one through the table.

Ragged-q mode (``q_starts`` [B] int32, speculative verify): row ``b``'s
query ``j`` sits at slot ``q_starts[b] + j`` and sees exactly the slots
``<= q_starts[b] + j`` that the ``prompt_lengths``/width window admits;
``kv_len`` only bounds the KV loop.  The three modes combine freely.

* :func:`decode_attention_plain` — the masked einsum of
  ``models/generate.py::cached_attention``'s XLA path (a paged cache is
  first gathered into each row's contiguous view, cut at
  ``logical_limit``): softmax, weights (times ``v_scale``) rounded to q's
  dtype, f32 accumulation.
* :func:`decode_attention` — the wrapper: a CPU tensor takes the plain
  version, a CUDA tensor launches the kernel or raises.  Launches are
  counted in ``decode_attention.launches`` and, by mode, in
  ``decode_attention.launches_by_mode`` (:func:`mode_name`).
"""

from __future__ import annotations

import threading
from typing import Optional

import torch

from tpu_nexus_torch.ops import _build

_LOG2E = 1.4426950408889634
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_DECODE_Q_LEN = 8
#: q_len * GQA group rows one CTA holds
MAX_ROWS = 64
#: KV slots per tile of the bf16 kernel (the M of its S^T = K.Q^T); its
#: splits are multiples of it
TILE = 64
#: a split holds at least this many tiles: a shorter live prefix is one split
MIN_SPLIT_TILES = 4
#: splits the bf16 kernel merges in its launch
MAX_SPLITS = 64
#: the f32 kernel's tile and the CTAs its split count aims for (two waves of
#: the H100's 132 SMs): the f32 kernel keeps its first plan
F32_TILE = 32
F32_TARGET_CTAS = 264


def mode_name(paged: bool, ragged: bool, int8: bool) -> str:
    """The :data:`MODES` key of one launch."""
    return f"{'paged' if paged else 'contiguous'}{'+ragged' if ragged else ''}{'+int8' if int8 else ''}"


#: the launch modes of the kernel: cache layout x query start x int8-KV
MODES = tuple(mode_name(p, r, i) for p in (False, True) for r in (False, True) for i in (False, True))


def _check_tables(q: torch.Tensor, block_tables, q_starts) -> None:
    b = q.shape[0]
    if block_tables is not None and (block_tables.dim() != 2 or block_tables.shape[0] != b):
        raise ValueError(f"block_tables {tuple(block_tables.shape)} must be [{b}, n_log]")
    if q_starts is not None and tuple(q_starts.shape) != (b,):
        raise ValueError(f"q_starts shape {tuple(q_starts.shape)} != ({b},)")


def _check_scales(k: torch.Tensor, k_scale, v_scale) -> None:
    """Int8-KV mode needs both scales, shaped like the cache with a last
    dim of 1; a mixed configuration is a caller bug."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError("int8-KV decode attention needs both k_scale and v_scale (or neither)")
    if k_scale is not None:
        want = (*k.shape[:3], 1)
        if tuple(k_scale.shape) != want or tuple(v_scale.shape) != want:
            raise ValueError(
                f"k_scale {tuple(k_scale.shape)} / v_scale {tuple(v_scale.shape)} must be {want}"
            )


def decode_supported(q: torch.Tensor, k: torch.Tensor, k_scale=None, v_scale=None) -> bool:
    """Inputs the CUDA kernel takes: the cache in q's dtype, or int8 with
    both f32 scales."""
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    if k_scale is None and v_scale is None:
        cache_ok = k.dtype == q.dtype
    else:
        cache_ok = (
            k_scale is not None and v_scale is not None and k.dtype == torch.int8
            and all(s.dtype == torch.float32 and s.device == q.device for s in (k_scale, v_scale))
        )
    return (
        q.is_cuda
        and k.device == q.device
        and d in (64, 128)
        and q.dtype in _DTYPES
        and cache_ok
        and 1 <= sq <= MAX_DECODE_Q_LEN
        and hq % hkv == 0
        and sq * (hq // hkv) <= MAX_ROWS
    )


def _lens_width(b, prompt_lengths, prompt_width, device):
    if prompt_lengths is None:
        return None, 0
    if prompt_width is None:
        raise ValueError("ragged decode needs prompt_width")
    return prompt_lengths.to(device=device, dtype=torch.int32), int(prompt_width)


def _gather_pages(pool: torch.Tensor, block_tables: torch.Tensor, limit: int) -> torch.Tensor:
    """Each row's contiguous logical view [B, limit, ...] of a block pool
    [NB, page, ...] through its table row."""
    b, n_log = block_tables.shape
    g = pool[block_tables.to(device=pool.device, dtype=torch.long)]  # [B, n_log, page, ...]
    return g.reshape(b, n_log * pool.shape[1], *pool.shape[2:])[:, :limit]


def decode_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv_len: int,
    prompt_lengths: Optional[torch.Tensor] = None, prompt_width: Optional[int] = None,
    k_scale: Optional[torch.Tensor] = None, v_scale: Optional[torch.Tensor] = None,
    *, block_tables: Optional[torch.Tensor] = None, q_starts: Optional[torch.Tensor] = None,
    logical_limit: Optional[int] = None, scale: Optional[float] = None,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel (see module docstring).  A paged
    cache is gathered into each row's view of ``logical_limit`` slots
    (default: the whole table row) before the masked einsum.  The sums are
    f32, or f64 for an f64 ``q`` (the on-card tests' exact reference)."""
    _check_scales(k, k_scale, v_scale)
    _check_tables(q, block_tables, q_starts)
    if block_tables is not None:
        limit = block_tables.shape[1] * k.shape[1] if logical_limit is None else int(logical_limit)
        k, v = _gather_pages(k, block_tables, limit), _gather_pages(v, block_tables, limit)
        if k_scale is not None:
            k_scale, v_scale = _gather_pages(k_scale, block_tables, limit), _gather_pages(v_scale, block_tables, limit)
    b, sq, hq, d = q.shape
    max_len, hkv = k.shape[1], k.shape[2]
    if hq % hkv:
        raise ValueError(f"q heads {hq} not divisible by kv heads {hkv}")
    if scale is None:
        scale = d**-0.5
    g = hq // hkv
    acc = torch.float64 if q.dtype == torch.float64 else torch.float32
    qg = q.reshape(b, sq, hkv, g, d)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.to(acc), k.to(q.dtype).to(acc))
    if k_scale is not None:
        # [B, max_len, Hkv, 1] -> [B, Hkv, 1, 1, max_len]
        scores = scores * k_scale[:, :, :, 0].transpose(1, 2)[:, :, None, None, :]
    scores = scores * scale
    k_pos = torch.arange(max_len, device=q.device)
    lens, width = _lens_width(b, prompt_lengths, prompt_width, q.device)
    if lens is None:
        mask = (k_pos < kv_len)[None, None, None, None, :]
    else:
        mask = (
            (k_pos[None, :] < lens[:, None]) | ((k_pos[None, :] >= width) & (k_pos[None, :] < kv_len))
        )[:, None, None, None, :]
    if q_starts is not None:
        # row b's query j was written at q_starts[b] + j and sees [0, q_starts[b] + j]
        row_last = q_starts.to(device=q.device, dtype=torch.long)[:, None] + torch.arange(sq, device=q.device)
        mask = mask & (k_pos[None, None, :] <= row_last[:, :, None])[:, None, None, :, :]
    elif sq > 1:
        row_last = kv_len - sq + torch.arange(sq, device=q.device)
        mask = mask & (k_pos[None, :] <= row_last[:, None])[None, None, None, :, :]
    scores = torch.where(mask, scores, torch.full((), -1e30, device=q.device))
    w = torch.softmax(scores, dim=-1)
    if v_scale is not None:
        w = w * v_scale[:, :, :, 0].transpose(1, 2)[:, :, None, None, :]
    w = w.to(q.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", w.to(acc), v.to(q.dtype).to(acc))
    return out.reshape(b, sq, hq, d).to(q.dtype)


def split_plan(b: int, hkv: int, live: int, resident: int):
    """(split_len, n_splits) of the bf16 kernel over ``live`` slots on a card
    that holds ``resident`` CTAs at once.  One split where the ``b·hkv`` CTAs
    already fill the card or the prefix is under ``2·MIN_SPLIT_TILES``
    tiles; else as many splits as the card holds beside each other (at most
    :data:`MAX_SPLITS`, each at least :data:`MIN_SPLIT_TILES` tiles), each a
    whole number of tiles, so every live slot lies in exactly one split."""
    n_tiles = -(-live // TILE)
    n = max(1, min(resident // (b * hkv), n_tiles // MIN_SPLIT_TILES, MAX_SPLITS))
    split_len = -(-n_tiles // n) * TILE
    return split_len, -(-live // split_len)


def f32_split_plan(b: int, hkv: int, live: int):
    """(split_len, n_splits) of the f32 kernel: enough splits that
    ``b·hkv·n_splits`` reaches :data:`F32_TARGET_CTAS`, each a whole number
    of its tiles."""
    n_tiles = -(-live // F32_TILE)
    want = max(1, -(-F32_TARGET_CTAS // (b * hkv)))
    tiles_per_split = max(1, -(-n_tiles // want))
    split_len = tiles_per_split * F32_TILE
    return split_len, -(-live // split_len)


def workspace_layout(b: int, hkv: int, n_splits: int, rows: int, d: int) -> dict:
    """32-bit words of a launch's workspace: the merge's arrival counters
    (one per (b, kv head)), then each split's (m, l) per query row, then its
    partial output rows (f32)."""
    return dict(counters=b * hkv, part_ml=b * hkv * n_splits * rows * 2, part_acc=b * hkv * n_splits * rows * d)


#: (device index, stream) -> (zeroed int32 buffer, counter words, partial words)
_WORKSPACES: dict = {}
_WORKSPACES_LOCK = threading.Lock()


def _workspace(device: torch.device, stream: int, layout: dict):
    """(part_acc, part_ml) addresses in the workspace of ``device`` and
    ``stream``.  The buffer starts with counter words, zeroed once: a launch
    that merges uses the ``counters`` words just before ``part_ml`` and
    leaves them 0, so the buffer is reused as it is and regrown (zeroed) only
    when a launch needs more.  Launches on one stream run in order; another
    stream gets its own buffer."""
    key = (device.index, stream)
    ml = -(-layout["part_ml"] // 4) * 4  # part_acc stays 16-byte aligned
    with _WORKSPACES_LOCK:
        buf, n_counters, n_parts = _WORKSPACES.get(key, (None, 0, 0))
        if buf is None or n_counters < layout["counters"] or n_parts < ml + layout["part_acc"]:
            n_counters = max(n_counters, -(-layout["counters"] // 256) * 256)
            n_parts = max(n_parts, ml + layout["part_acc"])
            buf = torch.zeros(n_counters + n_parts, dtype=torch.int32, device=device)
            _WORKSPACES[key] = (buf, n_counters, n_parts)
    part_ml = buf.data_ptr() + 4 * n_counters
    return part_ml + 4 * ml, part_ml


#: (device index, head dim, query rows, int8 cache) -> CTAs the card holds
_RESIDENT: dict = {}


def resident_ctas(device: torch.device, d: int, rows: int, int8: bool) -> int:
    """CTAs of the bf16 kernel that ``device`` holds at once for this head
    dim, q_len·G query rows and cache type: its SMs times the CTAs an SM
    holds (the library's occupancy query), cached."""
    key = (device.index, d, rows, int8)
    found = _RESIDENT.get(key)
    if found is None:
        with torch.cuda.device(device):
            per_sm = _build.library().nexus_decode_ctas_per_sm(d, rows, int(int8))
        if per_sm <= 0:
            raise RuntimeError(f"nexus_decode_ctas_per_sm({d}, {rows}, {int(int8)}) = {per_sm}")
        found = _RESIDENT[key] = per_sm * torch.cuda.get_device_properties(device).multi_processor_count
    return found


def decode_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv_len: int,
    prompt_lengths: Optional[torch.Tensor] = None, prompt_width: Optional[int] = None,
    k_scale: Optional[torch.Tensor] = None, v_scale: Optional[torch.Tensor] = None,
    *, block_tables: Optional[torch.Tensor] = None, q_starts: Optional[torch.Tensor] = None,
    logical_limit: Optional[int] = None, scale: Optional[float] = None,
) -> torch.Tensor:
    """Fused decode attention of a short query block against the cache.
    CPU tensors take :func:`decode_attention_plain`; CUDA tensors launch
    the kernel or raise.  ``k_scale``/``v_scale`` select the int8-KV mode,
    ``block_tables`` the paged mode, ``q_starts`` the ragged-q mode.
    ``kv_len`` is a host int: it sizes the kernel's grid (slots past
    ``logical_limit`` or the cache's logical length are never live)."""
    _check_scales(k, k_scale, v_scale)
    _check_tables(q, block_tables, q_starts)
    kv_len = int(kv_len)
    if q.device.type == "cpu":
        return decode_attention_plain(
            q, k, v, kv_len, prompt_lengths, prompt_width, k_scale, v_scale,
            block_tables=block_tables, q_starts=q_starts, logical_limit=logical_limit, scale=scale,
        )
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    paged = block_tables is not None
    if (not decode_supported(q, k, k_scale, v_scale) or v.shape != k.shape or v.dtype != k.dtype
            or v.device != k.device
            or any(t is not None and (t.device != q.device or t.dtype != torch.int32)
                   for t in (block_tables, q_starts))):
        raise ValueError(
            f"decode_attention kernel unsupported inputs: q {tuple(q.shape)} "
            f"{q.dtype} on {q.device}, k {tuple(k.shape)} {k.dtype}, v "
            f"{tuple(v.shape)} (needs CUDA tensors, head_dim 64|128, bf16|f32, "
            f"the cache in q's dtype or int8 with f32 scales, int32 tables and starts "
            f"on q's device, q_len 1-{MAX_DECODE_Q_LEN}, q_len*group <= {MAX_ROWS})"
        )
    if paged:
        n_log, page = block_tables.shape[1], k.shape[1]
        logical = n_log * page
    else:
        n_log, page = 0, 0
        logical = k.shape[1]
    limit = logical if logical_limit is None else min(int(logical_limit), logical)
    if kv_len < (1 if q_starts is not None else sq):
        raise ValueError(f"kv_len {kv_len} leaves no slot for the q_len {sq} query block")
    last_pos = min(kv_len, limit) - 1
    if scale is None:
        scale = d**-0.5
    lens, width = _lens_width(b, prompt_lengths, prompt_width, q.device)
    if lens is not None:
        lens = lens.contiguous()
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if k_scale is not None:
        k_scale, v_scale = k_scale.contiguous(), v_scale.contiguous()
    if paged:
        block_tables = block_tables.contiguous()
    if q_starts is not None:
        q_starts = q_starts.contiguous()
    rows = sq * (hq // hkv)
    if q.dtype == torch.bfloat16:
        split_len, n_splits = split_plan(b, hkv, last_pos + 1, resident_ctas(q.device, d, rows, k_scale is not None))
    else:
        split_len, n_splits = f32_split_plan(b, hkv, last_pos + 1)
    stream = _build.stream_ptr(q.device)
    part_acc = part_ml = None  # one bf16 split writes no partials
    if n_splits > 1 or q.dtype == torch.float32:
        part_acc, part_ml = _workspace(q.device, stream, workspace_layout(b, hkv, n_splits, rows, d))
    out = torch.empty_like(q)
    lib = _build.library()
    ptr = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
    with torch.cuda.device(q.device):  # the runtime launches on its current device
        status = lib.nexus_decode_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), ptr(k_scale), ptr(v_scale), ptr(lens),
            ptr(block_tables), ptr(q_starts), out.data_ptr(), part_acc, part_ml,
            b, sq, hq, hkv, d, logical, n_log, page, width, kv_len - sq, last_pos, split_len, n_splits,
            _DTYPES[q.dtype], float(scale * _LOG2E), stream,
        )
    _build.check(status, "nexus_decode_attention")
    decode_attention.launches += 1
    decode_attention.launches_by_mode[mode_name(paged, q_starts is not None, k_scale is not None)] += 1
    return out


def reset_launches() -> None:
    """Set every launch counter of the wrapper to 0."""
    decode_attention.launches = 0
    decode_attention.launches_by_mode = dict.fromkeys(MODES, 0)


#: launches of the kernel in any mode, and the launches of each of
#: :data:`MODES` (the int8-KV ones end in ``+int8``)
reset_launches()
