"""Plain PyTorch reference of the training step: the reference model's loss
and gradients in float32, then optax's AdamW chain (clip by global norm,
Adam with bias correction, decoupled weight decay on every leaf, the
warmup-cosine rate read at the count before it increments), in float32.
The model runs in float32 over the parameters as stored; the optimizer
runs as optax runs it over a tree of the dtype the configuration states
for the parameters (``run.param_dtype``): the gradients, the global norm,
both moments and every update operation in that dtype, Python scalars
rounded to it.

The parameters start from the seed's weights (``weights.py``), each layer's
slice of a stacked leaf a tensor of its own, so no gradient of a whole
stack is ever built for one layer.  It imports nothing of the program.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from benchmark.reference import model
from benchmark.roofline import dims
from benchmark.weights import leaves, make_leaf

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def learning_rate(tcfg: Dict, count: int) -> float:
    """optax ``warmup_cosine_decay_schedule(0, lr, warmup, total, lr / 10)``
    at ``count``."""
    peak, warmup = tcfg["learning_rate"], tcfg["warmup_steps"]
    decay = max(tcfg["total_steps"], warmup + 1) - warmup
    if count < warmup:
        return peak * count / warmup
    t = min(count - warmup, decay)
    return peak * (0.9 * 0.5 * (1 + math.cos(math.pi * t / decay)) + 0.1)


def _weak(x: float, dtype: torch.dtype) -> float:
    """A Python scalar as it meets an array of ``dtype`` in optax's
    arithmetic (JAX's weak typing): rounded to ``dtype`` first."""
    return float(torch.tensor(x, dtype=dtype))


def _global_norm(grads: Dict[str, List[torch.Tensor]], dtype: torch.dtype) -> torch.Tensor:
    """``optax.global_norm`` over leaves of ``dtype``: each leaf's squares in
    ``dtype``, summed in float32 and stored in ``dtype``, the leaves' sums
    added and rooted in ``dtype``."""
    total = None
    for parts in grads.values():
        s = torch.stack([(x * x).float().sum() for x in parts]).sum().to(dtype)
        total = s if total is None else total + s
    return torch.sqrt(total)


def embed_witness(grad_x: torch.Tensor, tokens: torch.Tensor, vocab: int) -> Dict[str, float]:
    """The embedding's gradient summed from the gradient of its output
    ``grad_x [B, S, E]`` two ways: in float32, and as a bf16 table summing
    each row's repeats in bf16 (``index_put_`` with ``accumulate``).
    Returns the signed relative gap of the bf16 sum's norm, and the largest
    count of one token in the batch."""
    ids = tokens.reshape(-1)
    g = grad_x.reshape(ids.numel(), -1)
    f32 = torch.zeros(vocab, g.shape[1], device=g.device).index_add_(0, ids, g)
    low = torch.zeros(vocab, g.shape[1], device=g.device, dtype=torch.bfloat16)
    low.index_put_((ids,), g.to(torch.bfloat16), accumulate=True)
    n32 = float(f32.double().norm())
    return {"bf16_sum_gap": (float(low.double().norm()) - n32) / n32,
            "top_token_count": int(torch.bincount(ids, minlength=vocab).max())}


def reference_steps(cfg: Dict, seed: int, batches: List[np.ndarray], n_steps: int, device,
                    prec: str = "f32", look: bool = False) -> Dict:
    """Run ``n_steps`` reference steps on ``batches`` from the seed's
    weights; returns each step's loss, each leaf's norm of the clipped first
    gradient, and each leaf's norm of its change after the last step.  With
    ``look``, also the embedding's gradient summed in bf16 beside float32
    (:func:`embed_witness`) on the first step."""
    model.strict_f32()
    tcfg = cfg["train"]
    dt = DTYPES[cfg["run"]["param_dtype"]]
    g = dims(cfg)
    # the parameters as the configured run stores them, each layer's slice
    # of a stacked leaf a tensor of its own
    store: Dict[str, List[torch.Tensor]] = {}
    for path, _, _ in leaves(cfg):
        t = make_leaf(cfg, seed, path, device, dt)
        store[path] = list(t.unbind(0)) if path.startswith("layers/") else [t]
    mu = {path: [torch.zeros_like(x) for x in parts] for path, parts in store.items()}
    nu = {path: [torch.zeros_like(x) for x in parts] for path, parts in store.items()}
    b1, b2, eps, wd, clip = tcfg["b1"], tcfg["b2"], 1e-8, tcfg["weight_decay"], tcfg["grad_clip_norm"]
    losses, grad1, witness = [], {}, {}
    for step in range(n_steps):
        # the model in float32 over the stored values
        work = {path: [x.float().requires_grad_() for x in parts] for path, parts in store.items()}
        tree = {"embed": {"tokens": work["embed/tokens"][0]}, "out_norm": work["out_norm"][0]}
        lw = lambda li: {path.split("/")[1]: parts[li] for path, parts in work.items()  # noqa: E731
                         if path.startswith("layers/")}
        tokens = torch.from_numpy(np.ascontiguousarray(batches[step])).to(device).long()
        seen: List[torch.Tensor] = []
        hook = seen.append if look and step == 0 else None
        h, lb, rz = model.hidden(tree, tokens, cfg, prec, grad=True, layer_weights=lw, embed_hook=hook)
        loss, _ = model.next_token_loss(h, work["lm_head"][0], tokens, tcfg["z_loss"], prec, grad=True)
        if g["ne"]:
            loss = loss + cfg["router_aux_loss_coef"] * lb + cfg["run"].get("router_z_coef", 0.0) * rz
        flat = [x for parts in work.values() for x in parts]
        raw = iter(torch.autograd.grad(loss, flat))
        del h, lb, rz, tree, lw, flat
        grads = {path: [next(raw).to(dt) for _ in parts] for path, parts in work.items()}
        del work, raw
        if seen:
            witness = embed_witness(seen.pop(), tokens, g["v"])
        losses.append(float(loss.detach()))
        # optax: clip_by_global_norm, then adamw (scale_by_adam, decayed
        # weights, the rate at the count before it increments), every
        # operation in the parameters' dtype
        gnorm = _global_norm(grads, dt)
        c = step + 1
        c1 = torch.tensor(1 - b1 ** c, dtype=torch.float32).to(dt)
        c2 = torch.tensor(1 - b2 ** c, dtype=torch.float32).to(dt)
        rate = torch.tensor(-learning_rate(tcfg, step), dtype=torch.float32).to(dt)
        clipped = not bool(gnorm < clip)
        with torch.no_grad():
            for path, parts in grads.items():
                for i, gr in enumerate(parts):
                    if clipped:
                        gr = (gr / gnorm) * _weak(clip, dt)
                    if step == 0:
                        grad1.setdefault(path, []).append(gr.double().square().sum())
                    m = _weak(1 - b1, dt) * gr + _weak(b1, dt) * mu[path][i]
                    v = _weak(1 - b2, dt) * (gr * gr) + _weak(b2, dt) * nu[path][i]
                    p = store[path][i]
                    u = (m / c1) / (torch.sqrt(v / c2) + _weak(eps, dt)) + _weak(wd, dt) * p
                    store[path][i] = p + rate * u
                    mu[path][i], nu[path][i] = m, v
        del grads
    del mu, nu
    change = {}
    with torch.no_grad():
        for path, parts in store.items():
            t0 = make_leaf(cfg, seed, path, device, dt).float()
            now = torch.stack(parts).float() if path.startswith("layers/") else parts[0].float()
            change[path] = float((now - t0).double().norm())
            del t0, now
    return {"loss": losses, "grad1": {k: math.sqrt(float(sum(v))) for k, v in grad1.items()},
            "change": change, "steps": n_steps, "prec": prec, "embed_witness": witness}
