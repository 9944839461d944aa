"""The training step: the port of ``tpu_nexus/workload/train.py``, on one
device or on a rank of a training mesh.

* :func:`make_optimizer` builds ``adamw``, ``adamw-bf16`` and ``adafactor``
  as tensor code that mirrors optax's chains op for op — clip by global
  norm first, the schedule read at the count *before* it increments,
  moments in the dtypes optax keeps them in, weight decay on every leaf —
  so the port's updates are optax's (the tests hold them to it).
  ``torch.optim`` is not used: its AdamW orders decay, bias correction and
  dtypes differently.
* :func:`chunked_next_token_loss` projects the final hidden states to the
  vocabulary one sequence chunk at a time and recomputes each chunk's f32
  logits in the backward, so ``[B, S, V]`` f32 logits never exist.
* :func:`make_train_step` returns ``step_fn(state, batch) -> (state,
  metrics)``: loss and grads, the global grad norm, the on-device health
  sentinel, and the optimizer update gated on the sentinel's verdict by a
  ``torch.where`` select.  Nothing in the step reads a value back to the
  host; the metrics are device scalars the harness reads later.

Unlike the reference's pure ``jit`` step, the port updates the state in
place (params, moments, counters): one copy of each lives on the card.
The optimizer walks the parameters one leaf at a time, so its
temporaries are one leaf's, never a whole tree's.

Leaves are visited in the JAX tree's order (sorted key paths), so sums
across leaves (the global norm) add in the reference's order.

On a training mesh (``parallel/mesh.py::TrainMesh``, the reference's
``state_shardings`` / ``batch_shardings`` under ``LOGICAL_RULES_FSDP_TP``)
each rank holds its shard of every parameter and of the optimizer state
that mirrors it (:class:`Layout`), drawn one leaf at a time and cut, so
its shard equals the slice of the one-device init from the same seed.
The step all-gathers fsdp-cut weights a layer at a time
(``collectives.FsdpGather``: reduce-scatter of the gradient in the
backward), runs tp-sharded heads, MLP and the vocabulary-parallel loss
with the tp pair, sums gradients over the data axes (``dp``, ``sp``, and
``fsdp`` for a leaf it does not cut), and takes the global grad norm over
every shard, counting a replicated leaf once.  Adafactor's factored
statistics are replicated; their row and column means are summed across
the axes that cut them.  The batch a rank receives is its rows (cut over
``(dp, fsdp)``) with the whole sequence; the loss cuts its ``sp`` chunk,
whose targets reach one token into the next rank's chunk.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from tpu_nexus_torch.workload.health import HealthConfig, gate_update, health_init, sentinel_update

OPTIMIZERS = ("adamw", "adamw-bf16", "adafactor")


@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    weight_decay: float = 0.1
    grad_clip_norm: float = 1.0
    z_loss: float = 1e-4  # logit normalizer regularizer, stabilizes bf16 heads
    b1: float = 0.9
    b2: float = 0.95
    #: sequence-chunk width of the chunked CE loss: each chunk's [B, chunk,
    #: V] f32 logits are the loss's only vocabulary-sized transient
    ce_chunk: int = 256
    #: pipeline microbatches (mesh pp > 1; not ported: ROADMAP.md A6b-ii
    #: refuses a non-zero value) and the sequence-parallel attention when
    #: the mesh shards sp: "ring" (parallel/ring.py) or "ulysses"
    #: (parallel/ulysses.py, heads divisible by sp·tp)
    pp_microbatches: int = 0
    sp_attn: str = "ring"
    #: optimizer family / state precision:
    #:  "adamw"      — moments in the params' dtype (optax ``adamw``);
    #:  "adamw-bf16" — moments STORED bf16, math in f32;
    #:  "adafactor"  — factored second moment, no first moment.
    optimizer: str = "adamw"

    def __post_init__(self) -> None:
        if self.optimizer not in OPTIMIZERS:
            raise ValueError(
                f"unknown TrainConfig.optimizer {self.optimizer!r}; use {', '.join(map(repr, OPTIMIZERS))}"
            )
        if self.sp_attn not in ("ring", "ulysses"):
            raise ValueError(f"unknown sp_attn {self.sp_attn!r}; use 'ring' or 'ulysses'")


# -- schedule ------------------------------------------------------------------


def warmup_cosine_schedule(cfg: TrainConfig) -> Callable[[torch.Tensor], torch.Tensor]:
    """``optax.warmup_cosine_decay_schedule(0, lr, warmup, max(total,
    warmup + 1), lr / 10)`` on an int32 count tensor, in f32 as optax
    computes it; returns an f32 0-d tensor on the count's device."""
    peak = cfg.learning_rate
    warmup = cfg.warmup_steps
    decay_steps = max(cfg.total_steps, cfg.warmup_steps + 1) - warmup
    end = cfg.learning_rate * 0.1
    alpha = 0.0 if peak == 0.0 else end / peak

    def schedule(count: torch.Tensor) -> torch.Tensor:
        c = count.float()
        if warmup > 0:
            frac = 1 - torch.clamp(c, 0, warmup) / warmup
            linear = (0.0 - peak) * frac + peak
        else:
            linear = torch.zeros_like(c)
        t = torch.minimum(c - warmup, torch.full_like(c, float(decay_steps)))
        cosine = 0.5 * (1 + torch.cos(math.pi * t / decay_steps))
        decayed = peak * ((1 - alpha) * cosine + alpha)
        return torch.where(c < warmup, linear, decayed)

    return schedule


# -- optimizers ----------------------------------------------------------------


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """``optax.global_norm``: sqrt of the sum over leaves of each leaf's sum
    of squares, each in the leaf's dtype (a bf16 tree gives a bf16 norm)."""
    total = None
    for t in tensors:
        s = torch.square(t).sum()
        total = s if total is None else total + s
    return torch.sqrt(total)


def _clip(g: torch.Tensor, g_norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    """``optax.clip_by_global_norm`` on one leaf: unchanged below the norm,
    else ``(g / norm) * max_norm`` (no epsilon)."""
    return torch.where(g_norm < max_norm, g, (g / g_norm.to(g.dtype)) * max_norm)


def _weak(x: float, t: torch.Tensor) -> float:
    """A Python scalar as JAX's weak typing applies it to array ``t``: rounded
    to ``t``'s dtype first (0.1 meets a bf16 array as bf16's 0.1)."""
    return float(torch.tensor(x, dtype=t.dtype)) if t.dtype != torch.float32 else x


def _write(dst: torch.Tensor, new: torch.Tensor, applied: Optional[torch.Tensor]) -> None:
    """Install ``new`` into ``dst`` in place, gated on the sentinel."""
    dst.copy_(new if applied is None else gate_update(applied, new.to(dst.dtype), dst))


class Optimizer:
    """One of the reference's optax chains, as state init plus an in-place
    update over the leaves.  ``update`` writes params and state; with
    ``applied`` (a bool 0-d tensor) every write is a select between the new
    and the old value, so a rejected step leaves them bit-untouched."""

    def __init__(self, cfg: TrainConfig, layout: Optional["Layout"] = None,
                 specs: Optional[List[Tuple]] = None) -> None:
        self.cfg = cfg
        self.schedule = warmup_cosine_schedule(cfg)
        #: on a training mesh: the layout and each leaf's spec, in the
        #: parameters' flatten order (None: one device, whole leaves)
        self.layout = layout
        self.specs = specs

    def _spec(self, i: int) -> Tuple:
        return self.specs[i] if self.specs is not None else ()

    def _global_shape(self, p: torch.Tensor, i: int) -> Tuple[int, ...]:
        if self.layout is None:
            return tuple(p.shape)
        return self.layout.global_shape(p.shape, self._spec(i))

    def init(self, params: List[torch.Tensor]) -> Dict[str, Any]:
        device = params[0].device if params else "cpu"
        return {"count": torch.zeros((), dtype=torch.int32, device=device),
                "leaves": [self._init_leaf(p, i) for i, p in enumerate(params)]}

    def _init_leaf(self, p: torch.Tensor, i: int) -> Dict[str, torch.Tensor]:
        raise NotImplementedError

    @torch.no_grad()
    def update(
        self, grads: List[torch.Tensor], params: List[torch.Tensor], state: Dict[str, Any],
        applied: Optional[torch.Tensor] = None, g_norm: Optional[torch.Tensor] = None,
    ) -> None:
        """One step over the leaves; ``g_norm`` is :func:`global_norm` of
        ``grads`` when the caller has it already."""
        if g_norm is None:
            g_norm = global_norm(grads)
        count = state["count"]
        count_inc = count + 1
        lr = self.schedule(count)
        for i, (g, p, leaf) in enumerate(zip(grads, params, state["leaves"])):
            self._update_leaf(_clip(g, g_norm, self.cfg.grad_clip_norm), p, leaf, count_inc, lr, applied, i)
        _write(count, count_inc, applied)


class AdamW(Optimizer):
    """``optax.adamw(schedule, b1, b2, weight_decay)`` after
    ``clip_by_global_norm``: ``scale_by_adam`` (moments in the params'
    dtype, bias correction by ``1 - b**count`` cast to that dtype, eps
    1e-8), ``add_decayed_weights`` on every leaf, then ``-lr(count)`` cast
    to the update's dtype."""

    eps = 1e-8

    def _init_leaf(self, p, i):
        return {"mu": torch.zeros_like(p), "nu": torch.zeros_like(p)}

    def _update_leaf(self, g, p, leaf, count_inc, lr, applied, i):
        b1, b2 = self.cfg.b1, self.cfg.b2
        mu = _weak(1 - b1, g) * g + _weak(b1, g) * leaf["mu"]
        nu = _weak(1 - b2, g) * (g**2) + _weak(b2, g) * leaf["nu"]
        c = count_inc.float()
        mu_hat = mu / (1 - b1**c).to(mu.dtype)
        nu_hat = nu / (1 - b2**c).to(nu.dtype)
        u = mu_hat / (torch.sqrt(nu_hat) + _weak(self.eps, nu_hat))
        u = u + _weak(self.cfg.weight_decay, p) * p
        u = (-lr).to(u.dtype) * u
        _write(p, p + u, applied)
        _write(leaf["mu"], mu, applied)
        _write(leaf["nu"], nu, applied)


class AdamWBf16(Optimizer):
    """The reference's ``adamw-bf16`` chain: ``_scale_by_adam_bf16`` (bf16
    moment storage, f32 math, f32 update), ``add_decayed_weights``, then
    ``scale_by_learning_rate``."""

    eps = 1e-8

    def _init_leaf(self, p, i):
        return {"mu": torch.zeros_like(p, dtype=torch.bfloat16),
                "nu": torch.zeros_like(p, dtype=torch.bfloat16)}

    def _update_leaf(self, g, p, leaf, count_inc, lr, applied, i):
        b1, b2 = self.cfg.b1, self.cfg.b2
        c = count_inc.float()
        c1 = 1.0 - b1**c
        c2 = 1.0 - b2**c
        g32 = g.float()
        m32 = b1 * leaf["mu"].float() + (1.0 - b1) * g32
        n32 = b2 * leaf["nu"].float() + (1.0 - b2) * torch.square(g32)
        u = (m32 / c1) / (torch.sqrt(n32 / c2) + self.eps)
        u = u + _weak(self.cfg.weight_decay, p) * p
        u = (-lr).to(u.dtype) * u
        _write(p, (p + u).to(p.dtype), applied)
        _write(leaf["mu"], m32.to(torch.bfloat16), applied)
        _write(leaf["nu"], n32.to(torch.bfloat16), applied)


def _factored_dims(shape, min_dim_size_to_factor: int = 128) -> Optional[Tuple[int, int]]:
    """optax's choice: the two largest axes, when the second largest has at
    least ``min_dim_size_to_factor`` entries (stable order on ties)."""
    if len(shape) < 2:
        return None
    order = sorted(range(len(shape)), key=lambda i: shape[i])
    if shape[order[-2]] < min_dim_size_to_factor:
        return None
    return order[-2], order[-1]


class Adafactor(Optimizer):
    """``optax.adafactor(learning_rate=schedule)`` after
    ``clip_by_global_norm``, with optax's defaults: factored second moment
    (threshold 128, decay 0.8, eps 1e-30), ``clip_by_block_rms(1.0)``,
    ``lr(count)``, parameter-scale by the block RMS (min 1e-3), negated.

    On a training mesh the factoring follows the GLOBAL shape, ``v_row``
    and ``v_col`` are replicated (their shapes fit no parameter sharding,
    as in the reference's ``state_shardings``), their means and the two
    block RMS means are summed across the axes that cut the leaf, and each
    rank scales its shard by its slice of the factors."""

    decay_rate = 0.8
    eps = 1e-30
    min_scale = 1e-3

    def _init_leaf(self, p, i):
        shape = self._global_shape(p, i)
        dims = _factored_dims(shape)
        if dims is None:
            return {"v": torch.zeros_like(p)}
        d1, d0 = dims
        row = [n for j, n in enumerate(shape) if j != d0]
        col = [n for j, n in enumerate(shape) if j != d1]
        return {"v_row": torch.zeros(row, dtype=p.dtype, device=p.device),
                "v_col": torch.zeros(col, dtype=p.dtype, device=p.device)}

    def _mean(self, x, spec, numel):
        """``mean(x)`` over the whole leaf (its shards' sums, on a mesh)."""
        return torch.mean(x) if self.layout is None else self.layout.leaf_mean(x, spec, numel).to(x.dtype)

    def _update_leaf(self, g, p, leaf, count_inc, lr, applied, i):
        dtype = p.dtype
        spec, shape = self._spec(i), self._global_shape(p, i)
        numel = math.prod(shape)
        t = count_inc.float()  # (count - offset) + 1
        decay = 1.0 - t ** (-self.decay_rate)
        grad_sqr = g * g + _weak(self.eps, g)
        dims = _factored_dims(shape)
        if dims is not None:
            d1, d0 = dims
            if self.layout is None:
                row_mean, col_mean = grad_sqr.mean(dim=d0).float(), grad_sqr.mean(dim=d1).float()
            else:
                row_mean = self.layout.dim_mean(grad_sqr.float(), d0, spec, shape[d0])
                col_mean = self.layout.dim_mean(grad_sqr.float(), d1, spec, shape[d1])
            # decay is an f32 array in optax, so these sums promote to f32
            new_row = (decay * leaf["v_row"].float() + (1.0 - decay) * row_mean).to(dtype)
            new_col = (decay * leaf["v_col"].float() + (1.0 - decay) * col_mean).to(dtype)
            reduced_d1 = d1 - 1 if d1 > d0 else d1
            row_col_mean = new_row.mean(dim=reduced_d1, keepdim=True)
            row_factor = (new_row / row_col_mean) ** -0.5
            col_factor = new_col ** -0.5
            if self.layout is not None:
                row_factor = self.layout.local(row_factor, spec, d0)
                col_factor = self.layout.local(col_factor, spec, d1)
            u = g * row_factor.unsqueeze(d0) * col_factor.unsqueeze(d1)
            _write(leaf["v_row"], new_row, applied)
            _write(leaf["v_col"], new_col, applied)
        else:
            new_v = (decay * leaf["v"].float() + (1.0 - decay) * grad_sqr.float()).to(dtype)
            u = g * new_v ** -0.5
            _write(leaf["v"], new_v, applied)
        u = u / torch.clamp(torch.sqrt(self._mean(u * u, spec, numel)), min=1.0)  # clip_by_block_rms(1.0)
        u = lr.to(u.dtype) * u
        rms = torch.sqrt(self._mean(p * p, spec, numel))
        min_scale = _weak(self.min_scale, rms)
        u = u * torch.where(rms <= min_scale, torch.full_like(rms, min_scale), rms)
        u = -1 * u
        _write(p, p + u, applied)


def make_optimizer(cfg: TrainConfig, layout: Optional["Layout"] = None,
                   specs: Optional[List[Tuple]] = None) -> Optimizer:
    """The optimizer of ``cfg``; on a training mesh, over the leaves' shards
    with their specs (the parameters' flatten order)."""
    return {"adamw": AdamW, "adamw-bf16": AdamWBf16, "adafactor": Adafactor}[cfg.optimizer](cfg, layout, specs)


# -- the training mesh's layout -------------------------------------------------


class Layout:
    """The train state's sharding on one rank of a :class:`TrainMesh`.

    ``specs`` maps each parameter's path (``layers/wq``, ``embed/tokens``)
    to its effective spec under the rule table (size-1 axes dropped).
    Adam's moments and Adafactor's unfactored ``v`` take their parameter's
    spec; Adafactor's ``v_row``/``v_col``, the counters and the sentinel's
    scalars are replicated."""

    def __init__(self, mesh: Any, axes_tree: Any, rules: Any) -> None:
        from tpu_nexus_torch.parallel.sharding import spec_tree

        self.mesh = mesh
        self.specs: Dict[str, Tuple] = {}

        def walk(node, prefix):
            if isinstance(node, dict):
                for k, v in node.items():
                    walk(v, f"{prefix}/{k}" if prefix else k)
            else:
                self.specs[prefix] = node

        walk(spec_tree(axes_tree, rules, mesh.sizes), "")

    # -- specs and slices ----------------------------------------------------

    def param_spec(self, name: str) -> Tuple:
        """The spec of a parameter by its dotted or slashed name."""
        return self.specs[name.replace(".", "/")]

    def state_spec(self, path: str, names: List[str]) -> Tuple:
        """The spec of a train-state leaf by its checkpoint path
        (``params/layers/wq``, ``opt_state/leaves/3/mu``, ``step``, ...);
        ``names`` is the parameters' flatten order.  A replicated leaf's
        spec is empty."""
        parts = path.split("/")
        if parts[0] == "params":
            return self.specs["/".join(parts[1:])]
        if parts[0] == "opt_state" and len(parts) == 4 and parts[3] in ("mu", "nu", "v"):
            return self.param_spec(names[int(parts[2])])
        return ()

    def _part(self, entry) -> Tuple[int, int]:
        from tpu_nexus_torch.parallel.sharding import shard_index

        return shard_index(entry, self.mesh.coords, self.mesh.sizes)

    def cut(self, t: torch.Tensor, spec: Tuple) -> torch.Tensor:
        """This rank's part of a whole leaf ``t`` (a contiguous copy)."""
        from tpu_nexus_torch.parallel.sharding import shard_leaf

        if not spec or all(e is None for e in spec):
            return t
        return shard_leaf(t, spec, self.mesh.coords, self.mesh.sizes).contiguous()

    def global_shape(self, shape, spec: Tuple) -> Tuple[int, ...]:
        if not spec:
            return tuple(shape)
        return tuple(int(n) * self._part(e)[1] for n, e in zip(shape, spec))

    def gather_full(self, t: torch.Tensor, spec: Tuple) -> torch.Tensor:
        """The whole leaf from this rank's part, on every rank (collective:
        every rank of the mesh calls it for the same leaf)."""
        from tpu_nexus_torch.parallel import collectives

        for dim, entry in enumerate(spec or ()):
            if entry is None:
                continue
            axes = entry if isinstance(entry, tuple) else (entry,)
            t = collectives.gather_dim(t, dim, self.mesh.group(*axes), self.mesh.size(*axes))
        return t

    def fsdp_gather(self) -> Callable[[str, torch.Tensor], torch.Tensor]:
        """``gather(name, shard)`` for the model: the dim a leaf's spec cuts
        over ``fsdp`` all-gathered (autograd: reduce-scatter backward).
        ``name`` is a path (``out_norm``, ``embed/tokens``) or a layer key
        (``wq``: a per-layer view, the leading ``layers`` dim dropped)."""
        from tpu_nexus_torch.parallel import collectives

        size, group = self.mesh.size("fsdp"), self.mesh.group("fsdp")

        def gather(name: str, shard: torch.Tensor) -> torch.Tensor:
            spec = self.specs.get(name) or self.specs[f"layers/{name}"]
            spec = spec[len(spec) - shard.dim():]
            for dim, entry in enumerate(spec):
                if entry == "fsdp":
                    return collectives.FsdpGather.apply(shard, dim, group, size, collectives.current())
            return shard

        return gather

    # -- reductions across shards --------------------------------------------

    def _sum_over(self, x: torch.Tensor, axes: Tuple[str, ...]) -> torch.Tensor:
        from tpu_nexus_torch.parallel import collectives

        axes = tuple(a for a in axes if self.mesh.size(a) > 1)
        if not axes:
            return x
        return collectives._all_reduce(x, self.mesh.group(*axes), self.mesh.comm(), name="stat_all_reduce")

    def leaf_sum(self, x: torch.Tensor, spec: Tuple) -> torch.Tensor:
        """A per-shard partial sum (0-d) made the whole leaf's."""
        from tpu_nexus_torch.parallel.sharding import spec_axes

        return self._sum_over(x, spec_axes(spec))

    def leaf_mean(self, x: torch.Tensor, spec: Tuple, numel: int) -> torch.Tensor:
        """``mean(x)`` over the whole leaf whose shard ``x`` is."""
        return self.leaf_sum(x.sum(), spec) / numel

    def dim_mean(self, x: torch.Tensor, dim: int, spec: Tuple, size: int) -> torch.Tensor:
        """``x.mean(dim)`` over the whole leaf, replicated on every rank:
        summed across the axes that cut ``dim``, gathered along the others."""
        from tpu_nexus_torch.parallel.sharding import spec_axes

        out = self._sum_over(x.sum(dim=dim), spec_axes(spec[dim:dim + 1])) / size
        rest = spec[:dim] + spec[dim + 1:]
        return self.gather_full(out, rest)

    def local(self, full: torch.Tensor, spec: Tuple, dropped: int) -> torch.Tensor:
        """This rank's part of a replicated statistic that lacks dim
        ``dropped`` of a leaf with ``spec``."""
        return self.cut(full, spec[:dropped] + spec[dropped + 1:])


def sharded_global_norm(grads: List[torch.Tensor], specs: List[Tuple], layout: "Layout") -> torch.Tensor:
    """The global norm over every shard: each leaf's sum of squares summed
    across the axes that cut it (so a replicated leaf counts once), in
    f32, then over the leaves; returned in the grads' dtype."""
    from tpu_nexus_torch.parallel.sharding import spec_axes

    by_axes: Dict[Tuple[str, ...], List[torch.Tensor]] = {}
    for g, spec in zip(grads, specs):
        by_axes.setdefault(spec_axes(spec), []).append(torch.square(g).sum().float())
    total = None
    for axes, sums in by_axes.items():
        part = layout._sum_over(torch.stack(sums), axes).sum()
        total = part if total is None else total + part
    return torch.sqrt(total).to(grads[0].dtype)


# -- losses ----------------------------------------------------------------------


def next_token_loss(
    logits: torch.Tensor, tokens: torch.Tensor, z_loss: float = 0.0
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Causal LM loss: predict token t+1 from prefix ≤ t.  f32 throughout."""
    logits = logits[:, :-1].float()
    targets = tokens[:, 1:].long()
    logz = torch.logsumexp(logits, dim=-1)
    true_logit = torch.gather(logits, -1, targets[..., None])[..., 0]
    ce = (logz - true_logit).mean()
    loss = ce
    if z_loss:
        loss = loss + z_loss * torch.square(logz).mean()
    return loss, {"ce_loss": ce, "perplexity": torch.exp(ce)}


def _chunk_terms(h, head32, targets, weight):
    """One chunk's (sum of CE, sum of logz²) over its weighted positions."""
    logits = torch.einsum("bce,ev->bcv", h.float(), head32)
    logz = torch.logsumexp(logits, dim=-1)
    true_logit = torch.gather(logits, -1, targets[..., None])[..., 0]
    return ((logz - true_logit) * weight).sum(), (torch.square(logz) * weight).sum()


def chunked_next_token_loss(
    hidden: torch.Tensor,
    head: torch.Tensor,
    tokens: torch.Tensor,
    z_loss: float = 0.0,
    chunk: int = 256,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Same loss as :func:`next_token_loss`, projecting to the vocabulary
    chunk by chunk over the sequence.  Each chunk's f32 logits (products of
    the bf16 operands, summed in f32, as the reference's
    ``preferred_element_type=f32``) are recomputed in the backward
    (activation checkpointing per chunk), so ``[B, S, V]`` f32 logits and
    their gradient never exist.

    hidden ``[B, S, E]`` (final-norm), head ``[E, V]``, tokens ``[B, S]``.
    Position s predicts token s+1; the last position is masked out."""
    b, s, _ = hidden.shape
    if s % chunk:
        chunk = s  # one chunk for ragged sequence lengths, as the reference
    targets = torch.cat([tokens[:, 1:], torch.zeros_like(tokens[:, :1])], dim=1).long()
    pos = torch.arange(s, device=hidden.device)
    weight_all = (pos < s - 1).float()[None, :]
    head32 = head.float()
    remat = torch.is_grad_enabled()
    ce_sum = z_sum = n = None
    for c0 in range(0, s, chunk):
        h, t, w = hidden[:, c0:c0 + chunk], targets[:, c0:c0 + chunk], weight_all[:, c0:c0 + chunk]
        if remat:
            from torch.utils.checkpoint import checkpoint

            ce_c, z_c = checkpoint(_chunk_terms, h, head32, t, w, use_reentrant=False)
        else:
            ce_c, z_c = _chunk_terms(h, head32, t, w)
        n_c = w.sum() * b
        ce_sum = ce_c if ce_sum is None else ce_sum + ce_c
        z_sum = z_c if z_sum is None else z_sum + z_c
        n = n_c if n is None else n + n_c
    ce = ce_sum / n
    loss = ce
    if z_loss:
        loss = loss + z_loss * z_sum / n
    return loss, {"ce_loss": ce, "perplexity": torch.exp(ce)}


def sharded_next_token_loss(
    hidden: torch.Tensor,
    head: torch.Tensor,
    targets: torch.Tensor,
    weight: torch.Tensor,
    mesh: Any,
    z_loss: float = 0.0,
    chunk: int = 256,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """:func:`chunked_next_token_loss` on a rank of a training mesh:
    ``hidden`` ``[B_l, S_l, E]`` is the rank's rows and sequence chunk,
    ``head`` ``[E, V / tp]`` its vocabulary slice, ``targets``/``weight``
    ``[B_l, S_l]`` the next tokens and the mask of the last global
    position.  The logsumexp and the true logit are summed over ``tp``
    (vocabulary-parallel CE; the max is taken over tp first), and the CE
    and z sums over the data ranks, so every rank holds the global loss;
    each rank's gradient is its own terms' (the sums' backward is the
    identity), and the train step sums them over the data axes."""
    from tpu_nexus_torch.parallel import collectives

    comm = collectives.current()
    tp = comm.tp_size if comm is not None else 1
    b, s, _ = hidden.shape
    if s % chunk:
        chunk = s
    vocab = head.shape[1]
    first = (comm.tp_rank if comm is not None else 0) * vocab
    hidden = collectives.copy_to_tp(hidden)
    head32 = head.float()

    def terms(h, t, w):
        logits = torch.einsum("bce,ev->bcv", h.float(), head32)
        m = logits.detach().amax(dim=-1)
        if tp > 1:
            m = collectives._all_reduce(m, comm.tp_group, comm, op="max")
        sumexp = collectives.reduce_tp(torch.exp(logits - m[..., None]).sum(dim=-1))
        logz = m + torch.log(sumexp)
        local = t - first
        inside = (local >= 0) & (local < vocab)
        picked = torch.gather(logits, -1, local.clamp(0, vocab - 1)[..., None])[..., 0]
        true_logit = collectives.reduce_tp(torch.where(inside, picked, torch.zeros_like(picked)))
        return ((logz - true_logit) * w).sum(), (torch.square(logz) * w).sum()

    remat = torch.is_grad_enabled()
    ce_sum = z_sum = None
    for c0 in range(0, s, chunk):
        h, t, w = hidden[:, c0:c0 + chunk], targets[:, c0:c0 + chunk], weight[:, c0:c0 + chunk]
        if remat:
            from torch.utils.checkpoint import checkpoint

            ce_c, z_c = checkpoint(terms, h, t, w, use_reentrant=False)
        else:
            ce_c, z_c = terms(h, t, w)
        ce_sum = ce_c if ce_sum is None else ce_sum + ce_c
        z_sum = z_c if z_sum is None else z_sum + z_c
    data = mesh.group(*_data_axes(mesh))
    size = mesh.size(*_data_axes(mesh))
    ce_sum = collectives.reduce_sum(ce_sum, data, size, comm, name="loss_all_reduce")
    z_sum = collectives.reduce_sum(z_sum, data, size, comm, name="loss_all_reduce")
    n = weight.sum() * b
    if size > 1:
        n = collectives._all_reduce(n.detach(), data, comm, name="loss_all_reduce")
    ce = ce_sum / n
    loss = ce
    if z_loss:
        loss = loss + z_loss * z_sum / n
    return loss, {"ce_loss": ce, "perplexity": torch.exp(ce)}


def _data_axes(mesh: Any) -> Tuple[str, ...]:
    """The mesh's data-bearing axes of size > 1 (the loss's and the
    gradients' sums)."""
    from tpu_nexus_torch.parallel.mesh import DATA_AXES

    return tuple(a for a in DATA_AXES if mesh.size(a) > 1)


# -- state and steps -----------------------------------------------------------


def _as_adapter(model: Any):
    from tpu_nexus_torch.models.registry import adapter_for

    return adapter_for(model)


def param_leaves(params: torch.nn.Module) -> List[Tuple[str, torch.Tensor]]:
    """The parameters in the JAX tree's flatten order (sorted key paths)."""
    return sorted(params.named_parameters(), key=lambda kv: kv[0])


def _sharded(mesh: Any) -> bool:
    return mesh is not None and mesh.world > 1


def train_layout(model: Any, mesh: Any, rules: Any = None) -> Layout:
    """The :class:`Layout` of ``model``'s train state on ``mesh`` under
    ``rules`` (default: ``LOGICAL_RULES_FSDP_TP``, the reference's)."""
    from tpu_nexus_torch.parallel.sharding import LOGICAL_RULES_FSDP_TP

    adapter = _as_adapter(model)
    adapter.check_mesh(mesh)
    return Layout(mesh, adapter.axes(), rules or LOGICAL_RULES_FSDP_TP)


def init_train_state(
    generator: torch.Generator, model: Any, train_cfg: TrainConfig, device: Any = "cuda",
    mesh: Any = None, rules: Any = None,
) -> Dict[str, Any]:
    """State = {params, opt_state, step, health} on ``device``; the params
    are drawn from ``generator`` (which lives on the same device type).
    On a training mesh each leaf is drawn whole and cut to this rank's
    part at once, so one whole leaf at a time is ever alive."""
    adapter = _as_adapter(model)
    layout = specs = leaf_fn = None
    if _sharded(mesh):
        layout = train_layout(adapter, mesh, rules)
        leaf_fn = lambda path, t: layout.cut(t, layout.specs[path])  # noqa: E731
    params = adapter.init(generator, device) if leaf_fn is None else adapter.init(generator, device, leaf_fn=leaf_fn)
    named = param_leaves(params)
    if layout is not None:
        specs = [layout.param_spec(name) for name, _ in named]
    return {
        "params": params,
        "opt_state": make_optimizer(train_cfg, layout, specs).init([p for _, p in named]),
        "step": torch.zeros((), dtype=torch.int32, device=device),
        # numerical-health sentinel state (workload/health.py), carried on
        # the device with the rest of the train state
        "health": health_init(device),
    }


def make_eval_step(
    model: Any, train_cfg: TrainConfig, mesh: Any = None, rules: Any = None,
) -> Callable[[Dict[str, Any], Any], Dict[str, torch.Tensor]]:
    """Loss-only step (no grads, no state mutation) for periodic held-out
    evaluation."""
    loss_fn = _as_adapter(model).make_loss(train_cfg, mesh, rules)

    @torch.no_grad()
    def eval_fn(state, batch):
        with _active(mesh):
            loss, metrics = loss_fn(state["params"], batch)
        return dict(metrics, loss=loss)

    return eval_fn


def _active(mesh: Any):
    from tpu_nexus_torch.parallel import collectives

    return collectives.active(mesh.comm() if _sharded(mesh) else None)


def _reduce_grads(grads: List[torch.Tensor], specs: List[Tuple], mesh: Any) -> None:
    """Sum each gradient over the data axes its parameter is not cut on
    (``fsdp`` already summed by the gather's reduce-scatter where it cuts
    the leaf): one coalesced all-reduce per group and dtype."""
    from tpu_nexus_torch.parallel import collectives
    from tpu_nexus_torch.parallel.sharding import spec_axes

    by_axes: Dict[Tuple[str, ...], List[torch.Tensor]] = {}
    for g, spec in zip(grads, specs):
        axes = tuple(a for a in _data_axes(mesh) if a not in spec_axes(spec))
        if axes:
            by_axes.setdefault(axes, []).append(g)
    for axes, same in by_axes.items():
        collectives.all_reduce_grads(same, mesh.group(*axes), mesh.comm())


def make_train_step(
    model: Any,
    train_cfg: TrainConfig,
    health: Optional[HealthConfig] = None,
    mesh: Any = None,
    rules: Any = None,
) -> Callable[[Dict[str, Any], Any], Tuple[Dict[str, Any], Dict[str, torch.Tensor]]]:
    """``step_fn(state, batch) -> (state, metrics)``, updating ``state`` in
    place.

    ``health`` adds the on-device numerical sentinel: finite-flags and an
    EMA spike detector over (loss, grad_norm), and the optimizer update is
    GATED on the verdict — a NaN/Inf or spiking step leaves params and
    optimizer state bit-untouched (``torch.where`` selects, never
    arithmetic over the rejected branch), while an applied step installs
    exactly the computed update.  The verdict rides the metrics dict as
    device scalars (health_nonfinite/health_spike/health_applied) for the
    harness's delayed readback.  ``health=None`` gives the ungated step.

    On a training mesh (``mesh`` of more than one rank) ``state`` is this
    rank's shards (:func:`init_train_state` with the same mesh) and
    ``batch`` its rows; loss, grad norm and the sentinel's verdict are
    global, the same on every rank.
    """
    adapter = _as_adapter(model)
    loss_fn = adapter.make_loss(train_cfg, mesh, rules)
    health_cfg = health if health is not None else HealthConfig(enabled=False)
    layout = specs = None
    optimizer = None

    def step_fn(state, batch):
        nonlocal layout, specs, optimizer
        named = param_leaves(state["params"])
        leaves = [p for _, p in named]
        if optimizer is None:
            if _sharded(mesh):
                layout = train_layout(adapter, mesh, rules)
                specs = [layout.param_spec(name) for name, _ in named]
            optimizer = make_optimizer(train_cfg, layout, specs)
        with torch.enable_grad(), _active(mesh):
            loss, metrics = loss_fn(state["params"], batch)
            grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            if layout is not None:
                _reduce_grads(grads, specs, mesh)
                grad_norm = sharded_global_norm(grads, specs, layout)
            else:
                grad_norm = global_norm(grads)
            metrics = {k: v.detach() for k, v in metrics.items()}
            metrics.update(loss=loss.detach(), grad_norm=grad_norm)
            applied = None
            if health_cfg.enabled:
                new_health, flags = sentinel_update(
                    state["health"], loss.detach(), grad_norm,
                    ema_beta=health_cfg.ema_beta,
                    spike_factor=health_cfg.spike_factor,
                    warmup_steps=health_cfg.warmup_steps,
                )
                applied = flags["health_applied"] > 0
                for key, value in new_health.items():
                    state["health"][key].copy_(value)
                metrics.update(flags)
            optimizer.update(list(grads), leaves, state["opt_state"], applied, g_norm=grad_norm)
            # the step counter always advances — it counts data consumed
            state["step"] += 1
        return state, metrics

    return step_fn
