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
hold an mlp slice) and sums the combine over the replica.  Left out,
raising where they would be asked for: the expert-parallel gmm path
(``_moe_ffn_gmm_ep``), gmm and sort under a mesh, the pipeline-parallel
stack (``moe_hidden_pp``) and ``NEXUS_MOE_FORCE_EP_PATH`` (ROADMAP.md: A6b-ii).
"""

from __future__ import annotations

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
    ct = cfg.dtype
    b, s, e = x.shape
    t = b * s
    ne, k = cfg.n_experts, cfg.experts_per_token
    a = t * k
    flat = x.reshape(t, e)
    logits, probs, gate, eidx = _router(flat, layer, cfg)
    eidx_sorted, perm, counts, starts, local, inv_perm, by_token = _sort_by_expert(eidx, t, k, ne)

    bm = BLOCK_M if a >= 8192 else 128  # from the shapes alone
    padded_counts = torch.clamp_min((counts + bm - 1) // bm * bm, bm)
    padded_starts = torch.cumsum(padded_counts, dim=0) - padded_counts
    # static worst case: every expert wastes < one tile (+ the ceil of A)
    m_pad = (a + bm - 1) // bm * bm + ne * bm

    slot_of_row = padded_starts[eidx_sorted] + local  # [A], in range
    slot_ids = torch.arange(m_pad, device=x.device)
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

    x_padded = _DispatchGather.apply(flat.to(ct), tok_of_slot, valid, slot_by_token, t, k)  # [m_pad, e]
    g = gmm(x_padded, layer["w_gate"].to(ct), tile_expert, bm)
    u = gmm(x_padded, layer["w_up"].to(ct), tile_expert, bm)
    y = gmm(F.silu(g) * u, layer["w_down"].to(ct), tile_expert, bm)

    y_km = _CombineGather.apply(y, slot_km, a_of_slot, valid)  # [A, e], k-major
    picked = y_km.reshape(k, t, e).transpose(0, 1)
    combined = torch.sum(picked * gate[..., None].to(ct), dim=1)

    aux = _aux_losses(logits, probs, eidx, torch.ones((t, k), device=x.device), cfg)
    return combined.reshape(b, s, e).to(x.dtype), aux


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


def _ep_not_ported() -> NotImplementedError:
    return NotImplementedError(
        "expert parallelism (a mesh for moe_ffn: _moe_ffn_gmm_ep, NEXUS_MOE_FORCE_EP_PATH) "
        "and the pipeline-parallel MoE stack (moe_hidden_pp) are not ported yet "
        "(ROADMAP.md: A6b-ii)"
    )


def moe_ffn(x: torch.Tensor, layer: Dict[str, Any], cfg: MoeConfig, mesh: Any = None):
    """The expert layer: [B, S, e] -> ([B, S, e], aux dict), dispatched per
    ``cfg.dispatch``.  Capacity-bounded paths drop overflow assignments
    (the residual carries those tokens through)."""
    if mesh is not None:
        raise _ep_not_ported()
    comm = collectives.current()
    sharded = comm is not None and comm.tp_size * comm.ep_size > 1
    if sharded and cfg.dispatch != "scatter":
        raise NotImplementedError(
            f"dispatch {cfg.dispatch!r} on a sharded serve mesh: the gmm and sort paths under a mesh "
            "are not ported yet (ROADMAP.md: A6b-ii); serving decodes with scatter"
        )
    if cfg.dispatch == "sort":
        return _moe_ffn_sorted(x, layer, cfg)
    if cfg.dispatch == "gmm":
        return _moe_ffn_gmm(x, layer, cfg)
    if cfg.dispatch != "scatter":
        raise ValueError(
            f"unknown MoeConfig.dispatch {cfg.dispatch!r}; use 'scatter', 'sort', or 'gmm'"
        )
    ct = cfg.dtype
    b, s, e = x.shape
    t = b * s
    ne, k = cfg.n_experts, cfg.experts_per_token
    cap = expert_capacity(t, cfg)
    flat = x.reshape(t, e)
    logits, probs, gate, eidx = _router(flat, layer, cfg)

    # position of each (token, k) assignment within its expert's buffer:
    # cumsum of one-hot assignments in flattened (k-major) order
    flat_oh = _one_hot(eidx.T.reshape(t * k), ne, torch.long)  # [T*K, E], k-major
    pos_flat = torch.cumsum(flat_oh, dim=0) - flat_oh
    pos = (pos_flat * flat_oh).sum(dim=-1).reshape(k, t).T  # [T, K]
    keep = (pos < cap).float()

    # scatter tokens into [E, C, e] buffers; overflow lands (zeroed) in a
    # dumpster row C that is sliced off
    cap_idx = torch.clamp_max(pos, cap)
    updates = (flat.to(ct)[:, None, :] * keep[..., None].to(ct)).reshape(t * k, e)
    buf = torch.zeros((ne, cap + 1, e), dtype=ct, device=x.device)
    buf = buf.index_put((eidx.reshape(-1), cap_idx.reshape(-1)), updates, accumulate=True)[:, :cap]

    if sharded:
        # this rank's experts (all of them under tp alone, whose stacks
        # hold an mlp slice): the others' outputs stay zero, and the
        # combine is summed over the replica below
        local = comm.expert_range(ne)
        out_buf = torch.zeros_like(buf)
        out_buf[local.start:local.stop] = _expert_swiglu(buf[local.start:local.stop], layer, ct)
    else:
        out_buf = _expert_swiglu(buf, layer, ct)
    # gather each assignment's output through an in-range index (overflow
    # is zeroed by `keep`)
    gather_idx = torch.clamp_max(cap_idx, cap - 1)
    picked = out_buf[eidx.reshape(-1), gather_idx.reshape(-1)].reshape(t, k, e)
    combined = torch.sum(picked * (gate * keep)[..., None].to(ct), dim=1)
    if sharded:
        combined = collectives.reduce_experts(combined)

    aux = _aux_losses(logits, probs, eidx, keep, cfg)
    return combined.reshape(b, s, e).to(x.dtype), aux


def moe_block(x: torch.Tensor, layer: Dict[str, Any], cfg: MoeConfig):
    """Post-attention sub-block: pre-norm routed experts plus the residual.
    Returns ``(x, aux)``; the ``ffn`` of :func:`remat_layer`."""
    h = rms_norm(x, layer["mlp_norm"], cfg.norm_eps)
    out, aux = moe_ffn(h, layer, cfg)
    return x + out, aux


def moe_hidden(
    params,
    tokens: torch.Tensor,
    cfg: MoeConfig,
    *,
    attn_impl: str = "auto",
    return_kv: bool = False,
    mesh: Any = None,
):
    """Final-norm hidden states [B, S, e] and the router aux losses
    averaged over layers.  ``return_kv=True`` -> ``(hidden, aux, (k, v))``
    with K/V stacked per layer ``[L, B, S, Hkv, D]`` (the no-grad prefill
    path, no checkpointing)."""
    if mesh is not None:
        raise _ep_not_ported()
    if tokens.shape[1] > cfg.max_seq_len:
        raise ValueError(
            f"sequence length {tokens.shape[1]} exceeds the config's "
            f"max_seq_len {cfg.max_seq_len}"
        )
    positions = torch.arange(tokens.shape[1], device=tokens.device)[None, :].expand(tokens.shape)
    x = collectives.embed_rows(params["embed"]["tokens"], tokens).to(cfg.dtype)
    cos, sin = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    lb, rz, dropped, ks, vs = [], [], [], [], []
    for li in range(params["layers"]["wq"].shape[0]):
        layer = layer_params(params, li)
        if return_kv:
            x, (k, v) = attention_block(x, layer, cfg, cos, sin, attn_impl, collect_kv=True)
            x, aux = moe_block(x, layer, cfg)
            ks.append(k)
            vs.append(v)
        else:
            x, aux = remat_layer(x, layer, cfg, cos, sin, attn_impl, ffn=moe_block)
        lb.append(aux["load_balance"])
        rz.append(aux["router_z"])
        dropped.append(aux["dropped_frac"])
    aux = {
        "load_balance": torch.stack(lb).sum() / cfg.n_layers,
        "router_z": torch.stack(rz).sum() / cfg.n_layers,
        "dropped_frac": torch.stack(dropped).mean(),
    }
    hidden = rms_norm(x, params["out_norm"], cfg.norm_eps)
    if return_kv:
        return hidden, aux, (torch.stack(ks), torch.stack(vs))
    return hidden, aux


def moe_hidden_pp(*args, **kwargs):
    raise _ep_not_ported()


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

