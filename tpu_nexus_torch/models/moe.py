"""Mixture-of-Experts decoder family (Mixtral-style): the port of
``tpu_nexus/models/moe.py``.

* The backbone is Llama's: the same attention sub-block, RoPE tables and
  activation-checkpoint policies (``models/llama.py``), with the dense MLP
  replaced by routed experts (:func:`moe_block`).  Parameters keep the
  reference's tree, in a :class:`LlamaParams` (its layer dict carries the
  extra ``router [L, E_model, n_experts]`` and expert stacks ``w_gate [L,
  n_experts, E_model, F]`` ...).
* The router runs in f32 throughout: top-k over the softmax, gates
  renormalized.  ``torch.topk`` does not promise the lower index on a tie
  as ``lax.top_k`` does; f32 scores from real inputs make exact ties
  unlikely, and no test is built on one.
* Three dispatches, as in the reference: ``scatter`` (capacity buffers
  built with ``index_put_(accumulate=True)``; every kept (expert, slot)
  pair is unique and only the sliced-off dumpster row takes more than one
  add, so the kept rows do not depend on the order of the adds), ``sort``
  and the dropless ``gmm`` (the grouped-matmul kernels,
  ``ops/grouped_matmul.py``).  The sort and gmm paths move their large
  ``[*, emb]`` arrays through gathers whose backward is a gather too
  (autograd Functions mirroring the reference's custom VJPs): no
  ``index_add_`` and no atomic float add anywhere, so results repeat run
  to run.
* Static shapes, no host syncs on the path: the gmm layout's ``m_pad`` and
  ``bm`` follow from the shapes alone; counts, starts and slot maps stay
  on the device (``searchsorted``, stable ``sort``, gathers); nothing
  calls ``.item()``, ``.tolist()``, ``nonzero`` or boolean masking.
* Under activation checkpointing the recompute re-runs the router on the
  same input on the same device, so it routes the same way.

Under a sharded serve mesh (``parallel/collectives.py`` active) the
scatter dispatch routes every token with the replicated router, computes
only this rank's ``n_experts / ep`` experts (under ``tp`` their stacks
hold an mlp slice) and sums the combine over the replica.  On a training
mesh (:func:`_moe_ffn_mesh`) the same holds for every dispatch: the
expert-parallel gmm path (``_gmm_ep_combine``, the reference's
``_moe_ffn_gmm_ep``, over kernels #7 and #8) when ``ep > 1`` or
``NEXUS_MOE_FORCE_EP_PATH``, the dropless gmm over each rank's tp slice
otherwise, and the scatter with its capacity over the global tokens; the
aux losses are over the global tokens too.  :func:`moe_hidden_pp` runs the
stack through the pipeline (scatter only, as the reference).
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Any, Dict

import torch
import torch.nn.functional as F

from tpu_nexus_torch.models.llama import (
    LlamaParams,
    _init_tree,
    attention_block,
    layer_params,
    llama_axes,
    remat_layer,
    rope_tables,
)
from tpu_nexus_torch.ops.grouped_matmul import BLOCK_M, gmm
from tpu_nexus_torch.ops.quant_matmul import weight_einsum
from tpu_nexus_torch.ops.rmsnorm import rms_norm
from tpu_nexus_torch.parallel import collectives


@dataclass(frozen=True)
class MoeConfig:
    vocab_size: int = 32000
    hidden: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    head_dim: int = 128
    intermediate: int = 14336  # PER-EXPERT ffn width
    n_experts: int = 8
    experts_per_token: int = 2
    capacity_factor: float = 1.25
    rope_theta: float = 500_000.0
    norm_eps: float = 1e-5
    max_seq_len: int = 8192
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32
    #: activation checkpointing per layer while gradients are taken, with
    #: the policies of :attr:`LlamaConfig.remat_policy`
    remat: bool = True
    remat_policy: str = "dots"
    #: the reference's layer-scan unroll factor, kept for the presets and
    #: ignored (the layers run as a Python loop)
    scan_unroll: int = 1
    tied_embeddings: bool = False
    load_balance_coef: float = 0.01
    router_z_coef: float = 1e-3
    #: token->expert dispatch: "scatter" (capacity buffers), "sort"
    #: (capacity buffers from contiguous slices of the sorted rows) or
    #: "gmm" (dropless, tile-aligned grouped matmul)
    dispatch: str = "scatter"
    #: the reference's per-shard row budget of the ep-sharded gmm path
    #: (multi-GPU slice); unused on one device
    ep_row_factor: float = 2.0

    # -- presets (tpu_nexus/models/moe.py:95-121) ----------------------------

    @staticmethod
    def mixtral_8x7b() -> "MoeConfig":
        return MoeConfig()

    @staticmethod
    def nexus_moe() -> "MoeConfig":
        return MoeConfig(
            vocab_size=32768, hidden=1024, n_layers=8, n_heads=8, n_kv_heads=4,
            head_dim=128, intermediate=2048, n_experts=8, experts_per_token=2,
            tied_embeddings=True, param_dtype=torch.bfloat16, max_seq_len=4096,
            remat_policy="attn_out", dispatch="gmm",
        )

    @staticmethod
    def tiny(vocab_size: int = 256) -> "MoeConfig":
        return MoeConfig(
            vocab_size=vocab_size, hidden=64, n_layers=2, n_heads=4, n_kv_heads=2,
            head_dim=16, intermediate=96, n_experts=4, experts_per_token=2,
            max_seq_len=256, remat=False,
        )


def _layer_shapes(cfg: MoeConfig) -> Dict[str, tuple]:
    """Shape of every stacked per-layer leaf, in the JAX tree's order."""
    e, f, hq, hkv, d, l, ne = (
        cfg.hidden, cfg.intermediate, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
        cfg.n_layers, cfg.n_experts,
    )
    return {
        "attn_norm": (l, e),
        "wq": (l, e, hq, d),
        "wk": (l, e, hkv, d),
        "wv": (l, e, hkv, d),
        "wo": (l, hq, d, e),
        "mlp_norm": (l, e),
        "router": (l, e, ne),
        "w_gate": (l, ne, e, f),
        "w_up": (l, ne, e, f),
        "w_down": (l, ne, f, e),
    }


def moe_axes(cfg: MoeConfig) -> Dict[str, Any]:
    """Logical-axis tree mirroring :func:`moe_init` (the JAX package's
    ``moe_axes``): expert stacks carry the "expert" axis (``ep``)."""
    axes = llama_axes(cfg)
    axes["layers"].update({
        "router": ("layers", "embed", None),  # [L, e, E]: E is tiny, replicated
        "w_gate": ("layers", "expert", "embed", "mlp"),
        "w_up": ("layers", "expert", "embed", "mlp"),
        "w_down": ("layers", "expert", "mlp", "embed"),
    })
    return axes


def moe_init(
    generator: torch.Generator, cfg: MoeConfig, device: Any = "cuda", leaf_fn: Any = None,
) -> LlamaParams:
    """Random init (plain normal with fan-in scaling, as the reference),
    drawn on ``device`` from ``generator``; the tree of ``moe_init`` :149.
    ``leaf_fn`` as in :func:`~tpu_nexus_torch.models.llama.llama_init`."""
    return LlamaParams(_init_tree(generator, cfg, device, _layer_shapes(cfg), leaf_fn))


def expert_capacity(n_tokens: int, cfg: MoeConfig) -> int:
    """Static per-expert buffer size, from the token count alone."""
    return max(
        1,
        int(math.ceil(cfg.capacity_factor * cfg.experts_per_token * n_tokens / cfg.n_experts)),
    )


def _router(flat: torch.Tensor, layer: Dict[str, Any], cfg: MoeConfig):
    """Top-k routing in f32 (inputs too: near-tied bf16 scores flap between
    steps).  Returns (logits, probs, gate, eidx)."""
    logits = torch.einsum("te,ek->tk", flat.float(), layer["router"].float())  # [T, E] f32
    probs = torch.softmax(logits, dim=-1)
    gate, eidx = torch.topk(probs, cfg.experts_per_token, dim=-1)  # [T, K]
    gate = gate / gate.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    return logits, probs, gate, eidx


def _one_hot(idx: torch.Tensor, n: int, dtype=torch.float32) -> torch.Tensor:
    """One-hot by comparison (no range check, so no host read on the card)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _expert_swiglu(buf: torch.Tensor, layer: Dict[str, Any], ct) -> torch.Tensor:
    """Per-expert SwiGLU as batched einsums over the expert axis:
    [E, C, e] -> [E, C, e]."""
    g = weight_einsum("Ece,Eef->Ecf", buf, layer["w_gate"], ct)
    u = weight_einsum("Ece,Eef->Ecf", buf, layer["w_up"], ct)
    return weight_einsum("Ecf,Efe->Ece", F.silu(g) * u, layer["w_down"], ct)


def _aux_losses(logits, probs, eidx, keep, cfg: MoeConfig):
    """Switch aux losses: load balance on ALL assignments, z-loss on logits."""
    ne, k = cfg.n_experts, cfg.experts_per_token
    density = _one_hot(eidx, ne).sum(dim=1).mean(dim=0)  # frac tokens/expert
    router_prob = probs.mean(dim=0)
    load_balance = ne * torch.sum(density / k * router_prob)
    z = torch.logsumexp(logits, dim=-1).square().mean()
    dropped = 1.0 - keep.float().mean()
    return {"load_balance": load_balance, "router_z": z, "dropped_frac": dropped}


def _blocks_from_sorted(padded, starts, counts, cap: int, ne: int):
    """[E, cap, e] blocks from a sorted-by-expert row array (padded by at
    least ``cap`` rows so no window runs off the end): rows ``starts[e] ..
    starts[e] + cap`` per expert, rows past the expert's count zeroed.  One
    gather with device-side starts (the reference's dynamic slices)."""
    ar = torch.arange(cap, device=padded.device)
    rows = starts[:, None] + ar[None, :]  # [E, cap]
    blocks = padded[rows]
    return blocks * (ar[None, :] < counts[:, None]).to(padded.dtype)[..., None]


class _SortedBlocks(torch.autograd.Function):
    """:func:`_blocks_from_sorted` on the sort path's padded rows, whose
    backward is a gather: row ``i`` of expert ``eidx_sorted[i]`` at position
    ``local[i]`` sits in exactly one kept window slot if ``local[i] < cap``
    and in none otherwise (the reference's dynamic-slice VJP has the same
    single nonzero term)."""

    @staticmethod
    def forward(ctx, padded, starts, counts, eidx_sorted, local, cap: int, ne: int):
        ctx.save_for_backward(eidx_sorted, local)
        ctx.cap, ctx.n_pad = cap, padded.shape[0]
        return _blocks_from_sorted(padded, starts, counts, cap, ne)

    @staticmethod
    def backward(ctx, d):
        eidx_sorted, local = ctx.saved_tensors
        cap = ctx.cap
        kept = (local < cap)[:, None]
        rows = d[eidx_sorted, local.clamp_max(cap - 1)]
        d_rows = torch.where(kept, rows, torch.zeros_like(rows))
        pad = d_rows.new_zeros((ctx.n_pad - d_rows.shape[0], d.shape[-1]))
        return torch.cat([d_rows, pad]), None, None, None, None, None, None


class _TakeByToken(torch.autograd.Function):
    """``src[idx]`` whose backward needs no scatter: every token has exactly
    K assignments, so the cotangent re-orders by token (a gather) and sums a
    static ``[T, K, e]``."""

    @staticmethod
    def forward(ctx, src, idx, by_token, t: int, k: int):
        ctx.save_for_backward(by_token)
        ctx.t, ctx.k = t, k
        return src[idx]

    @staticmethod
    def backward(ctx, d):
        (by_token,) = ctx.saved_tensors
        return d[by_token].reshape(ctx.t, ctx.k, d.shape[-1]).sum(dim=1), None, None, None, None


class _TakeSlots(torch.autograd.Function):
    """``out_all[slot]`` whose backward needs no scatter: re-sorted by expert
    (a gather by ``perm``), each expert's cotangent rows are one run aligned
    with its buffer block, built with the forward dispatch's windows."""

    @staticmethod
    def forward(ctx, out_all, slot, perm, starts, counts, cap: int, ne: int):
        ctx.save_for_backward(perm, starts, counts)
        ctx.cap, ctx.ne = cap, ne
        return out_all[slot]

    @staticmethod
    def backward(ctx, d):
        perm, starts, counts = ctx.saved_tensors
        d_pad = torch.cat([d[perm], d.new_zeros((ctx.cap, d.shape[-1]))])
        d_out_all = _blocks_from_sorted(d_pad, starts, counts, ctx.cap, ctx.ne)
        return d_out_all.reshape(ctx.ne * ctx.cap, d.shape[-1]), None, None, None, None, None, None


class _DispatchGather(torch.autograd.Function):
    """Token rows -> tile-padded dispatch layout in one gather
    (``flat[tok_of_slot]``, invalid slots zeroed); the backward is one
    gather by slot plus a static ``[T, K, e] -> [T, e]`` sum."""

    @staticmethod
    def forward(ctx, flat, tok_of_slot, valid, slot_by_token, t: int, k: int):
        ctx.save_for_backward(slot_by_token)
        ctx.t, ctx.k = t, k
        rows = flat[tok_of_slot]
        return torch.where(valid[:, None], rows, torch.zeros_like(rows))

    @staticmethod
    def backward(ctx, d):
        (slot_by_token,) = ctx.saved_tensors
        d_flat = d[slot_by_token].reshape(ctx.t, ctx.k, d.shape[-1]).sum(dim=1)
        return d_flat, None, None, None, None, None


class _CombineGather(torch.autograd.Function):
    """Expert outputs (padded layout) -> k-major assignment rows in one
    gather (``y[slot_km]``); the backward routes each valid slot's
    cotangent back from its unique assignment (``a_of_slot``), again one
    gather."""

    @staticmethod
    def forward(ctx, y, slot_km, a_of_slot, valid):
        ctx.save_for_backward(a_of_slot, valid)
        return y[slot_km]

    @staticmethod
    def backward(ctx, d):
        a_of_slot, valid = ctx.saved_tensors
        rows = d[a_of_slot]
        return torch.where(valid[:, None], rows, torch.zeros_like(rows)), None, None, None


def _sort_by_expert(eidx: torch.Tensor, t: int, k: int, ne: int):
    """Stable sort of the k-major assignment ids by expert.  Returns
    (eidx_sorted, perm, counts, starts, local, inv_perm, by_token), the
    prologue the sort and gmm paths share; ``by_token`` lists sorted
    assignment indices token-major (each token's K rows consecutive)."""
    eidx_flat = eidx.T.reshape(t * k)  # k-major: the k=0 block first
    a_idx = torch.arange(t * k, device=eidx.device)
    eidx_sorted, perm = torch.sort(eidx_flat, stable=True)
    counts = _one_hot(eidx_flat, ne, torch.long).sum(dim=0)  # [E]
    starts = torch.cumsum(counts, dim=0) - counts
    local = a_idx - starts[eidx_sorted]  # position within the expert
    # one small int scatter of unique indices builds the inverse permutation;
    # every original-order view gathers through it
    inv_perm = torch.empty_like(perm)
    inv_perm[perm] = a_idx
    by_token = inv_perm.reshape(k, t).T.reshape(t * k)
    return eidx_sorted, perm, counts, starts, local, inv_perm, by_token


def _moe_ffn_gmm(x: torch.Tensor, layer: Dict[str, Any], cfg: MoeConfig):
    """DROPLESS dispatch through the grouped-matmul kernels.  Each expert's
    sorted rows pad to a multiple of the m-tile (at least one tile, so an
    expert with no token still gets a defined, zero, weight gradient);
    every row tile then belongs to one expert.  Dispatch and combine are
    bijective gathers (slot <-> row) in the forward and the backward."""
    b, s, e = x.shape
    t = b * s
    flat = x.reshape(t, e)
    logits, probs, gate, eidx = _router(flat, layer, cfg)
    combined = _gmm_combine(flat, layer, cfg, gate, eidx)
    aux = _aux_losses(logits, probs, eidx, torch.ones((t, cfg.experts_per_token), device=x.device), cfg)
    return combined.reshape(b, s, e).to(x.dtype), aux


def _gmm_combine(flat: torch.Tensor, layer: Dict[str, Any], cfg: MoeConfig, gate, eidx) -> torch.Tensor:
    """The dropless gmm layout over every expert of ``layer``: the
    gate-weighted sum of each token's experts, ``[T, e]``."""
    ct = cfg.dtype
    t, e = flat.shape
    ne, k = cfg.n_experts, cfg.experts_per_token
    a = t * k
    eidx_sorted, perm, counts, starts, local, inv_perm, by_token = _sort_by_expert(eidx, t, k, ne)

    bm = BLOCK_M if a >= 8192 else 128  # from the shapes alone
    padded_counts = torch.clamp_min((counts + bm - 1) // bm * bm, bm)
    padded_starts = torch.cumsum(padded_counts, dim=0) - padded_counts
    # static worst case: every expert wastes < one tile (+ the ceil of A)
    m_pad = (a + bm - 1) // bm * bm + ne * bm

    slot_of_row = padded_starts[eidx_sorted] + local  # [A], in range
    slot_ids = torch.arange(m_pad, device=flat.device)
    slot_expert = torch.searchsorted(padded_starts, slot_ids, right=True) - 1
    slot_local = slot_ids - padded_starts[slot_expert]
    valid = slot_local < counts[slot_expert]
    row_of_slot = torch.clamp_max(starts[slot_expert] + slot_local, a - 1)
    tile_expert = slot_expert.reshape(-1, bm)[:, 0].to(torch.int32)  # constant within a tile

    # index composition (small ints) so the big [*, emb] arrays move
    # through exactly one gather per side per pass
    tok_sorted = perm % t
    tok_of_slot = tok_sorted[row_of_slot]  # slot -> token id
    slot_by_token = slot_of_row[by_token]  # token-major slots
    slot_km = slot_of_row[inv_perm]  # k-major slots
    a_of_slot = perm[row_of_slot]  # slot -> k-major assignment
    return _gmm_experts(flat, layer, ct, tok_of_slot, valid, slot_by_token, slot_km, a_of_slot, tile_expert, bm,
                        gate, t, k)


def _gmm_experts(flat, layer, ct, tok_of_slot, valid, slot_by_token, slot_km, a_of_slot, tile_expert, bm, gate, t, k):
    """Dispatch gather, the three grouped matmuls (#7; #8 and #7 again in
    the backward), combine gather and the gate-weighted sum over k."""
    e = flat.shape[1]
    x_padded = _DispatchGather.apply(flat.to(ct), tok_of_slot, valid, slot_by_token, t, k)  # [m_pad, e]
    g = gmm(x_padded, layer["w_gate"].to(ct), tile_expert, bm)
    u = gmm(x_padded, layer["w_up"].to(ct), tile_expert, bm)
    y = gmm(F.silu(g) * u, layer["w_down"].to(ct), tile_expert, bm)

    y_km = _CombineGather.apply(y, slot_km, a_of_slot, valid)  # [A, e], k-major
    picked = y_km.reshape(k, t, e).transpose(0, 1)
    return torch.sum(picked * gate[..., None].to(ct), dim=1)


def _gmm_ep_combine(flat: torch.Tensor, layer: Dict[str, Any], cfg: MoeConfig, gate, eidx, n_ep: int, ep_index: int):
    """The reference's ``_moe_ffn_gmm_ep`` body on one rank: the dropless gmm
    layout for this rank's ``n_experts / ep`` LOCAL experts under a static
    per-shard tile budget (``cfg.ep_row_factor`` x the fair share, plus one
    tile per local expert, plus one never-allocated dumpster tile).
    Non-local and over-budget assignments point their slots at the
    dumpster, whose rows are zero forward and whose cotangent rows are zero
    backward.  Returns (this rank's share of the combine ``[T, e]``, which
    assignments it kept ``[T, K]``, f32)."""
    ct = cfg.dtype
    t, e = flat.shape
    ne, k = cfg.n_experts, cfg.experts_per_token
    if ne % n_ep:
        raise ValueError(f"n_experts {ne} not divisible by ep={n_ep}")
    el = ne // n_ep
    a = t * k
    bm = BLOCK_M if a >= 8192 else 128
    fair = -(-a // n_ep)
    n_alloc_tiles = -(-int(fair * cfg.ep_row_factor) // bm) + el
    m_pad = (n_alloc_tiles + 1) * bm
    dev = flat.device

    eidx_sorted, perm, counts, starts, local, inv_perm, by_token = _sort_by_expert(eidx, t, k, ne)
    first = ep_index * el
    counts_l, starts_l = counts[first:first + el], starts[first:first + el]
    # tile allocation: each local expert wants ceil(count / bm) tiles (>= 1);
    # the cumulative allocation is capped so every later expert keeps at
    # least one tile
    want = torch.clamp_min((counts_l + bm - 1) // bm, 1)
    cum_want = torch.cumsum(want, dim=0)
    cap_cum = n_alloc_tiles - (el - 1 - torch.arange(el, device=dev))
    cum_alloc = torch.minimum(cum_want, cap_cum)
    t_alloc = cum_alloc - torch.cat([cum_alloc.new_zeros(1), cum_alloc[:-1]])
    padded_counts = t_alloc * bm
    padded_starts = (cum_alloc - t_alloc) * bm
    kept_counts = torch.minimum(counts_l, padded_counts)

    # slot side (this rank's padded layout)
    slot_ids = torch.arange(m_pad, device=dev)
    slot_e = torch.clamp(torch.searchsorted(padded_starts, slot_ids, right=True) - 1, 0, el - 1)
    slot_local = slot_ids - padded_starts[slot_e]
    valid = slot_local < kept_counts[slot_e]
    row_of_slot = torch.clamp_max(starts_l[slot_e] + slot_local, a - 1)
    tile_expert = slot_e.reshape(-1, bm)[:, 0].to(torch.int32)

    # assignment side: local and kept assignments get their slot, every
    # other one the dumpster (the always-invalid last slot)
    e_rel = eidx_sorted - first
    is_local = (e_rel >= 0) & (e_rel < el)
    e_rel_c = torch.clamp(e_rel, 0, el - 1)
    kept_sorted = is_local & (local < kept_counts[e_rel_c])
    slot_of_row = torch.where(kept_sorted, padded_starts[e_rel_c] + local, torch.full_like(local, m_pad - 1))

    tok_sorted = perm % t
    combined = _gmm_experts(flat, layer, ct, tok_sorted[row_of_slot], valid, slot_of_row[by_token],
                            slot_of_row[inv_perm], perm[row_of_slot], tile_expert, bm, gate, t, k)
    keep_tk = kept_sorted[inv_perm].float().reshape(k, t).T
    return combined, keep_tk


def _moe_ffn_sorted(x: torch.Tensor, layer: Dict[str, Any], cfg: MoeConfig):
    """Sort-based dispatch: assignments stable-sort by expert, each
    expert's tokens are one contiguous window of the sorted rows, and the
    ``[E, C, emb]`` buffers come from E windows with an underfill mask; the
    combine gathers each assignment's output row through its slot."""
    ct = cfg.dtype
    b, s, e = x.shape
    t = b * s
    ne, k = cfg.n_experts, cfg.experts_per_token
    cap = expert_capacity(t, cfg)
    flat = x.reshape(t, e)
    logits, probs, gate, eidx = _router(flat, layer, cfg)
    # k-major assignment order (a = kk*T + tok), as the scatter path, so
    # both paths drop the same overflow assignments
    eidx_sorted, perm, counts, starts, local, inv_perm, by_token = _sort_by_expert(eidx, t, k, ne)
    keep_sorted = local < cap

    tok_sorted = perm % t
    x_sorted = _TakeByToken.apply(flat.to(ct), tok_sorted, by_token, t, k)  # [T*K, e]
    # pad so the last expert's window never runs off the end
    x_pad = torch.cat([x_sorted, x_sorted.new_zeros((cap, e))])
    buf = _SortedBlocks.apply(x_pad, starts, counts, eidx_sorted, local, cap, ne)  # [E, C, e]

    out_all = _expert_swiglu(buf, layer, ct).reshape(ne * cap, e)

    # slot of each assignment in out_all, back in k-major order; overflow
    # clamps in range and is zeroed by `keep` at the combine
    slot_sorted = eidx_sorted * cap + torch.clamp_max(local, cap - 1)
    slot = slot_sorted[inv_perm]
    keep = keep_sorted[inv_perm]
    picked = _TakeSlots.apply(out_all, slot, perm, starts, counts, cap, ne)
    picked = picked.reshape(k, t, e).transpose(0, 1)
    keep_tk = keep.reshape(k, t).T.float()  # [T, K]
    combined = torch.sum(picked * (gate * keep_tk)[..., None].to(ct), dim=1)

    aux = _aux_losses(logits, probs, eidx, keep_tk, cfg)
    return combined.reshape(b, s, e).to(x.dtype), aux


def force_ep_path() -> bool:
    """``NEXUS_MOE_FORCE_EP_PATH``: run the expert-parallel gmm path even at
    ep 1 (a mesh needed).  Strict parse: "0"/"false" do not force it."""
    import os

    return os.environ.get("NEXUS_MOE_FORCE_EP_PATH", "").lower() in ("1", "true", "yes")


def _data_axes(mesh: Any):
    from tpu_nexus_torch.parallel.mesh import DATA_AXES

    return tuple(a for a in DATA_AXES if mesh.size(a) > 1)


def _on_mesh(mesh: Any, cfg: MoeConfig) -> bool:
    """Whether ``moe_ffn`` takes the training mesh's path: any axis but
    ``pp`` cuts the tokens or the experts, or the ep path is forced."""
    if mesh is None:
        return False
    spread = any(mesh.size(a) > 1 for a in ("dp", "fsdp", "ep", "sp", "tp"))
    return spread or (cfg.dispatch == "gmm" and force_ep_path())


def _positions(eidx: torch.Tensor, ne: int) -> torch.Tensor:
    """Each (token, k) assignment's slot within its expert's buffer: the
    cumsum of one-hot assignments in flattened (k-major) order.  ``eidx``
    and the result are ``[T, K]``."""
    t, k = eidx.shape
    flat_oh = _one_hot(eidx.T.reshape(t * k), ne, torch.long)  # [T*K, E], k-major
    pos_flat = torch.cumsum(flat_oh, dim=0) - flat_oh
    return (pos_flat * flat_oh).sum(dim=-1).reshape(k, t).T


def _global_positions(eidx: torch.Tensor, b: int, s: int, cfg: MoeConfig, mesh: Any):
    """Each assignment's slot in its expert's buffer over the GLOBAL token
    population (the reference's scatter runs on the global batch): the
    ranks' routing gathered over the data axes (``sp`` along the sequence,
    then ``(dp, fsdp)`` along the rows), the one-device positions over it,
    and this rank's part.  Returns (positions ``[t, K]``, the capacity)."""
    k = cfg.experts_per_token
    grid = eidx.reshape(b, s, k)
    grid = collectives.gather_dim(grid, 1, mesh.group("sp"), mesh.size("sp"))
    grid = collectives.gather_dim(grid, 0, mesh.group("dp", "fsdp"), mesh.size("dp", "fsdp"))
    gb, gs = grid.shape[:2]
    pos = _positions(grid.reshape(gb * gs, k), cfg.n_experts).reshape(gb, gs, k)
    r0, s0 = mesh.index("dp", "fsdp") * b, mesh.index("sp") * s
    return pos[r0:r0 + b, s0:s0 + s].reshape(b * s, k), expert_capacity(gb * gs, cfg)


def _scatter_experts(flat: torch.Tensor, layer: Dict[str, Any], cfg: MoeConfig, gate, eidx, pos, cap: int,
                     experts: range):
    """The scatter dispatch over slots ``pos`` ``[t, K]`` and capacity
    ``cap``: the tokens into ``[E, C, e]`` buffers (overflow lands, zeroed,
    in a dumpster row C that is sliced off), the experts in ``experts``
    computed (the others' outputs zero: a rank's share, which its caller
    sums), each assignment's output gathered through an in-range index
    (overflow is zeroed by ``keep``) and gated.  Returns (the combine
    ``[t, e]``, the kept assignments ``[t, K]``)."""
    ct = cfg.dtype
    t, e = flat.shape
    ne, k = cfg.n_experts, cfg.experts_per_token
    keep = (pos < cap).float()
    cap_idx = torch.clamp_max(pos, cap)
    updates = (flat.to(ct)[:, None, :] * keep[..., None].to(ct)).reshape(t * k, e)
    buf = torch.zeros((ne, cap + 1, e), dtype=ct, device=flat.device)
    buf = buf.index_put((eidx.reshape(-1), cap_idx.reshape(-1)), updates, accumulate=True)[:, :cap]
    out_buf = _expert_swiglu(buf[experts.start:experts.stop], layer, ct)
    if len(experts) < ne:
        out_buf = torch.cat([out_buf.new_zeros((experts.start, cap, e)), out_buf,
                             out_buf.new_zeros((ne - experts.stop, cap, e))])
    picked = out_buf[eidx.reshape(-1), torch.clamp_max(cap_idx, cap - 1).reshape(-1)].reshape(t, k, e)
    return torch.sum(picked * (gate * keep)[..., None].to(ct), dim=1), keep


def _moe_ffn_mesh(x: torch.Tensor, layer: Dict[str, Any], cfg: MoeConfig, mesh: Any):
    """The expert layer on a training mesh's rank (the reference's
    ``_moe_ffn_gmm_ep`` shard_map, and GSPMD's scatter and gmm): the tokens
    and the router weight enter the expert region ``(ep, tp)`` through
    :func:`~collectives.region_entry` (their gradients summed over it), the
    router runs replicated over the region, each rank computes its local
    experts (the gmm ep path when ``ep > 1`` or forced, the dropless gmm
    over every expert's tp slice otherwise, or the scatter), and the
    combine leaves through one sum over the region.  The aux losses are over
    the global tokens: density and router_prob averaged over the data axes
    BEFORE their product; every rank of the region computes them alike, so
    their gradient is counted once (:func:`~collectives.region_replicated`)."""
    ne, k = cfg.n_experts, cfg.experts_per_token
    n_ep = mesh.size("ep")
    n_region = mesh.size("ep", "tp")
    region = mesh.group("ep", "tp")
    data_axes = _data_axes(mesh)
    data, n_data = mesh.group(*data_axes), mesh.size(*data_axes)
    b, s, e = x.shape
    t = b * s
    flat = collectives.region_entry(x, region, n_region).reshape(t, e)
    router = {"router": collectives.region_entry(layer["router"], region, n_region)}
    logits, probs, gate, eidx = _router(flat, router, cfg)
    if cfg.dispatch == "gmm" and (n_ep > 1 or force_ep_path()):
        combined, keep_tk = _gmm_ep_combine(flat, layer, cfg, gate, eidx, n_ep, mesh.coords["ep"])
        if n_ep > 1:  # each assignment is kept on the one rank that holds its expert
            keep_tk = collectives._all_reduce(keep_tk, mesh.group("ep"), collectives.current(),
                                              name="region_all_reduce")
    elif cfg.dispatch == "gmm":
        combined, keep_tk = _gmm_combine(flat, layer, cfg, gate, eidx), torch.ones((t, k), device=x.device)
    else:  # scatter, and sort (the same assignments kept; refused under ep by the adapter)
        pos, cap = _global_positions(eidx, b, s, cfg, mesh)
        el = ne // n_ep
        experts = range(mesh.coords["ep"] * el, (mesh.coords["ep"] + 1) * el)
        combined, keep_tk = _scatter_experts(flat, layer, cfg, gate, eidx, pos, cap, experts)
    combined = collectives.region_exit(combined, region, n_region)

    density = collectives.data_mean(_one_hot(eidx, ne).sum(dim=1).mean(dim=0), data, n_data)
    router_prob = collectives.data_mean(probs.mean(dim=0), data, n_data)
    load_balance = ne * torch.sum(density / k * router_prob)
    z = collectives.data_mean(torch.logsumexp(logits, dim=-1).square().mean(), data, n_data)
    dropped = 1.0 - collectives.data_mean(keep_tk.mean(), data, n_data)
    aux = {"load_balance": collectives.region_replicated(load_balance, n_region),
           "router_z": collectives.region_replicated(z, n_region), "dropped_frac": dropped}
    return combined.reshape(b, s, e).to(x.dtype), aux


def moe_ffn(x: torch.Tensor, layer: Dict[str, Any], cfg: MoeConfig, mesh: Any = None):
    """The expert layer: [B, S, e] -> ([B, S, e], aux dict), dispatched per
    ``cfg.dispatch``.  Capacity-bounded paths drop overflow assignments
    (the residual carries those tokens through).  On a training mesh
    (``parallel/mesh.py::TrainMesh``) whose axes other than ``pp`` cut the
    tokens or the experts, or with ``NEXUS_MOE_FORCE_EP_PATH``, the rank's
    part (:func:`_moe_ffn_mesh`)."""
    if _on_mesh(mesh, cfg):
        if cfg.dispatch not in ("scatter", "sort", "gmm"):
            raise ValueError(f"unknown MoeConfig.dispatch {cfg.dispatch!r}; use 'scatter', 'sort', or 'gmm'")
        return _moe_ffn_mesh(x, layer, cfg, mesh)
    comm = collectives.current()
    sharded = comm is not None and comm.tp_size * comm.ep_size > 1
    if sharded and cfg.dispatch != "scatter":
        raise NotImplementedError(
            f"dispatch {cfg.dispatch!r} on a sharded serve mesh: serving decodes with scatter "
            "(generate normalizes MoE to it)"
        )
    if cfg.dispatch == "sort":
        return _moe_ffn_sorted(x, layer, cfg)
    if cfg.dispatch == "gmm":
        return _moe_ffn_gmm(x, layer, cfg)
    if cfg.dispatch != "scatter":
        raise ValueError(
            f"unknown MoeConfig.dispatch {cfg.dispatch!r}; use 'scatter', 'sort', or 'gmm'"
        )
    b, s, e = x.shape
    t = b * s
    ne = cfg.n_experts
    flat = x.reshape(t, e)
    logits, probs, gate, eidx = _router(flat, layer, cfg)
    # this rank's experts (all of them under tp alone, whose stacks hold an
    # mlp slice); the combine is summed over the replica
    experts = comm.expert_range(ne) if sharded else range(ne)
    combined, keep = _scatter_experts(flat, layer, cfg, gate, eidx, _positions(eidx, ne),
                                      expert_capacity(t, cfg), experts)
    if sharded:
        combined = collectives.reduce_experts(combined)

    aux = _aux_losses(logits, probs, eidx, keep, cfg)
    return combined.reshape(b, s, e).to(x.dtype), aux


def moe_block(x: torch.Tensor, layer: Dict[str, Any], cfg: MoeConfig, mesh: Any = None):
    """Post-attention sub-block: pre-norm routed experts plus the residual.
    Returns ``(x, aux)``; the ``ffn`` of :func:`remat_layer` (with the
    training mesh bound, ``functools.partial(moe_block, mesh=mesh)``)."""
    h = rms_norm(x, layer["mlp_norm"], cfg.norm_eps)
    out, aux = moe_ffn(h, layer, cfg, mesh=mesh)
    return x + out, aux


def moe_hidden(
    params,
    tokens: torch.Tensor,
    cfg: MoeConfig,
    *,
    attn_impl: Any = "auto",
    return_kv: bool = False,
    mesh: Any = None,
    seq_offset: int = 0,
    gather: Any = None,
    embed_table: Any = None,
):
    """Final-norm hidden states [B, S, e] and the router aux losses
    averaged over layers.  ``return_kv=True`` -> ``(hidden, aux, (k, v))``
    with K/V stacked per layer ``[L, B, S, Hkv, D]`` (the no-grad prefill
    path, no checkpointing).  On a training mesh's rank, as
    ``llama_hidden``: ``tokens`` its rows and sequence chunk from
    ``seq_offset``, ``gather`` the fsdp all-gather, ``embed_table`` the
    gathered embedding; each layer's experts take :func:`moe_ffn`'s mesh
    path."""
    if seq_offset + tokens.shape[1] > cfg.max_seq_len:
        raise ValueError(
            f"sequence length {seq_offset + tokens.shape[1]} exceeds the config's "
            f"max_seq_len {cfg.max_seq_len}"
        )
    positions = torch.arange(seq_offset, seq_offset + tokens.shape[1], device=tokens.device)[None, :]
    positions = positions.expand(tokens.shape)
    table = params["embed"]["tokens"] if embed_table is None else embed_table
    x = collectives.embed_rows(table, tokens).to(cfg.dtype)
    cos, sin = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    ffn = moe_block if mesh is None else functools.partial(moe_block, mesh=mesh)
    lb, rz, dropped, ks, vs = [], [], [], [], []
    for li in range(params["layers"]["wq"].shape[0]):
        layer = layer_params(params, li)
        if return_kv:
            x, (k, v) = attention_block(x, layer, cfg, cos, sin, attn_impl, collect_kv=True)
            x, aux = moe_block(x, layer, cfg)
            ks.append(k)
            vs.append(v)
        else:
            x, aux = remat_layer(x, layer, cfg, cos, sin, attn_impl, ffn=ffn, gather=gather)
        lb.append(aux["load_balance"])
        rz.append(aux["router_z"])
        dropped.append(aux["dropped_frac"])
    aux = {
        "load_balance": torch.stack(lb).sum() / cfg.n_layers,
        "router_z": torch.stack(rz).sum() / cfg.n_layers,
        "dropped_frac": torch.stack(dropped).mean(),
    }
    out_norm = params["out_norm"] if gather is None else gather("out_norm", params["out_norm"])
    hidden = rms_norm(x, out_norm, cfg.norm_eps)
    if return_kv:
        return hidden, aux, (torch.stack(ks), torch.stack(vs))
    return hidden, aux


def moe_hidden_pp(
    params,
    tokens: torch.Tensor,
    cfg: MoeConfig,
    *,
    n_stages: int,
    microbatches: int = 0,
    mesh: Any = None,
    batch_axes: Any = ("dp", "fsdp"),
    attn_impl: Any = "auto",
    seq_offset: int = 0,
    gather: Any = None,
    embed_table: Any = None,
):
    """:func:`moe_hidden` over a pipeline-parallel layer stack (the MoE
    counterpart of ``llama_hidden_pp``).  The router aux accumulators ride
    the pipeline in the carry, one f32 entry per row (a microbatch's aux is
    added to each of its rows), so the result averages over microbatches and
    layers.  Requires ``dispatch='scatter'``.  On a stage other than the
    last, hidden and aux are the pipeline's 0-d zeros."""
    from tpu_nexus_torch.models.llama import pipeline_input
    from tpu_nexus_torch.parallel.pipeline import pipeline_apply, rank_microbatches, stage_layers

    if cfg.dispatch != "scatter":
        raise ValueError(
            f"pipeline parallelism requires MoeConfig.dispatch='scatter', got {cfg.dispatch!r}"
        )
    microbatches = rank_microbatches(tokens.shape[0], n_stages, microbatches, mesh, batch_axes)
    x, cos, sin = pipeline_input(params, tokens, cfg, mesh, seq_offset, gather, embed_table)
    layers = params["layers"] if mesh is None else stage_layers(dict(params["layers"]), cfg.n_layers, mesh)
    ffn = functools.partial(moe_block, mesh=mesh)

    def layer_fn(carry, layer):
        x, lb, rz, dr = carry
        x, aux = remat_layer(x, layer, cfg, cos, sin, attn_impl, ffn=ffn, gather=gather)
        return x, lb + aux["load_balance"], rz + aux["router_z"], dr + aux["dropped_frac"]

    zeros = torch.zeros(tokens.shape[0], dtype=torch.float32, device=tokens.device)
    x, lb, rz, dr = pipeline_apply(layer_fn, dict(layers), (x, zeros, zeros, zeros), n_stages=n_stages,
                                   microbatches=microbatches, mesh=mesh)
    if mesh is not None and mesh.stage != n_stages - 1:
        return x, {"load_balance": lb, "router_z": rz, "dropped_frac": dr}
    aux = {
        "load_balance": lb.mean() / cfg.n_layers,
        "router_z": rz.mean() / cfg.n_layers,
        "dropped_frac": dr.mean() / cfg.n_layers,
    }
    out_norm = params["out_norm"] if gather is None else gather("out_norm", params["out_norm"])
    return rms_norm(x, out_norm, cfg.norm_eps), aux


def moe_head(params, cfg: MoeConfig) -> torch.Tensor:
    if cfg.tied_embeddings:
        return params["embed"]["tokens"].to(cfg.dtype).T
    return params["lm_head"].to(cfg.dtype)


def moe_param_count(cfg: MoeConfig) -> int:
    e, f, hq, hkv, d, l, v, ne = (
        cfg.hidden, cfg.intermediate, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
        cfg.n_layers, cfg.vocab_size, cfg.n_experts,
    )
    per_layer = 2 * e + e * hq * d + 2 * e * hkv * d + hq * d * e + e * ne + ne * 3 * e * f
    total = v * e + l * per_layer + e
    if not cfg.tied_embeddings:
        total += e * v
    return total

