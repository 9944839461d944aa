"""Plain PyTorch reference of the two families the benchmark runs: Mistral
(dense SwiGLU) and Mixtral (top-2 of 8 SwiGLU experts, dropless), both
pre-norm GQA decoders with rotary embeddings on halves (Hugging Face's
``rotate_half``), RMSNorm and an untied head.

It computes in float32 with TF32 off, layer by layer, attention in blocks
of queries, so that it fits beside nothing else on the card.  ``prec="fp8"``
rounds both operands of every weight product (projections, experts, router
and head) to float8 e4m3 with a per-tensor scale: the control that has to
come out as not correct (and, in the backward, the output gradient of each
in e5m2).  It imports nothing of the program: it reads the
weight tree the benchmark made (``weights.py``), in the port's layout.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from benchmark.roofline import dims

QUERY_BLOCK = 512
LOSS_CHUNK = 1024


def strict_f32() -> None:
    """float32 products in float32: no TF32 anywhere."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _round(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t`` rounded to a float8 type under a per-tensor scale."""
    scale = t.abs().amax().clamp_min(1e-30) / torch.finfo(dtype).max
    return (t / scale).to(dtype).float() * scale


def _fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to e4m3, gradient passed straight through."""
    return t + (_round(t.detach(), torch.float8_e4m3fn) - t.detach())


class _GradFp8(torch.autograd.Function):
    """Identity whose backward rounds the incoming gradient to e5m2, so the
    backward's products take float8 operands as the forward's do."""

    @staticmethod
    def forward(ctx, y):
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2)


def wprod(spec: str, x: torch.Tensor, w: torch.Tensor, prec: str) -> torch.Tensor:
    """A weight product in the reference's precision: under ``fp8`` both
    operands in e4m3 and, in the backward, the output's gradient in e5m2
    (the usual float8 training recipe), everything else in float32."""
    if prec != "fp8":
        return torch.einsum(spec, x, w)
    y = torch.einsum(spec, _fp8(x), _fp8(w))
    return _GradFp8.apply(y) if y.requires_grad else y


def rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x ``[B, S, H, D]``, pos ``[S]``: rotary embedding on the two halves."""
    d = x.shape[-1]
    freqs = theta ** (-torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d)
    ang = pos.float()[:, None] * freqs
    cos, sin = torch.cos(ang)[None, :, None, :], torch.sin(ang)[None, :, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attend_block(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, q0: int) -> torch.Tensor:
    """Queries ``q0 .. q0 + bq`` against keys ``0 .. q0 + bq`` (causal):
    q ``[B, bq, Hkv, G, D]``, k/v ``[B, S', Hkv, D]``."""
    bq, d = q.shape[1], q.shape[-1]
    s = torch.einsum("bqhgd,bkhd->bhgqk", q, k) * d ** -0.5
    qi = torch.arange(q0, q0 + bq, device=q.device)[:, None]
    ki = torch.arange(k.shape[1], device=q.device)[None, :]
    s = s.masked_fill(ki > qi, float("-inf"))
    return torch.einsum("bhgqk,bkhd->bqhgd", torch.softmax(s, dim=-1), v)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, grad: bool) -> torch.Tensor:
    """Causal GQA attention in blocks of queries, q ``[B, S, Hq, D]`` and
    k/v ``[B, S, Hkv, D]``; under ``grad`` each block is recomputed in the
    backward, so no ``[S, S]`` matrix outlives its block."""
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, s, hkv, hq // hkv, d)
    outs = []
    for q0 in range(0, s, QUERY_BLOCK):
        q1 = min(s, q0 + QUERY_BLOCK)
        args = (qg[:, q0:q1], k[:, :q1], v[:, :q1], q0)
        outs.append(checkpoint(_attend_block, *args, use_reentrant=False) if grad else _attend_block(*args))
    return torch.cat(outs, dim=1).reshape(b, s, hq, d)


def swiglu(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor, wd: torch.Tensor, prec: str) -> torch.Tensor:
    g = wprod("...e,ef->...f", x, wg, prec)
    u = wprod("...e,ef->...f", x, wu, prec)
    return wprod("...f,fe->...e", F.silu(g) * u, wd, prec)


def experts(x: torch.Tensor, lw: Dict[str, torch.Tensor], k: int, prec: str):
    """Top-k of the softmax over the router's f32 logits, gates renormalized,
    every assignment computed (dropless); returns (out, load balance,
    router z) over x ``[T, E]``."""
    ne = lw["router"].shape[-1]
    logits = wprod("te,en->tn", x, lw["router"], prec)
    probs = torch.softmax(logits, dim=-1)
    gate, idx = torch.topk(probs, k, dim=-1)
    gate = gate / gate.sum(-1, keepdim=True)
    out = torch.zeros_like(x)
    for ei in range(ne):
        tok, slot = torch.nonzero(idx == ei, as_tuple=True)
        if tok.numel():
            y = swiglu(x[tok], lw["w_gate"][ei], lw["w_up"][ei], lw["w_down"][ei], prec)
            out = out.index_add(0, tok, y * gate[tok, slot][:, None])
    density = F.one_hot(idx, ne).float().sum(1).mean(0)
    load_balance = ne * torch.sum(density / k * probs.mean(0))
    router_z = torch.logsumexp(logits, dim=-1).square().mean()
    return out, load_balance, router_z


def layer(x: torch.Tensor, lw: Dict[str, torch.Tensor], cfg: Dict, pos: torch.Tensor, prec: str, grad: bool):
    """One decoder layer over x ``[B, S, E]``; returns (x, load balance,
    router z) (zeros for a dense layer)."""
    g = dims(cfg)
    eps, theta = cfg["rms_norm_eps"], cfg["rope_theta"]
    h = rms(x, lw["attn_norm"], eps)
    q = rope(wprod("bse,ehd->bshd", h, lw["wq"], prec), pos, theta)
    k = rope(wprod("bse,ehd->bshd", h, lw["wk"], prec), pos, theta)
    v = wprod("bse,ehd->bshd", h, lw["wv"], prec)
    x = x + wprod("bshd,hde->bse", attention(q, k, v, grad), lw["wo"], prec)
    h = rms(x, lw["mlp_norm"], eps)
    zero = x.new_zeros(())
    if g["ne"]:
        b, s, e = h.shape
        out, lb, rz = experts(h.reshape(b * s, e), lw, g["k"], prec)
        return x + out.reshape(b, s, e), lb, rz
    return x + swiglu(h, lw["w_gate"], lw["w_up"], lw["w_down"], prec), zero, zero


def hidden(tree: Dict, tokens: torch.Tensor, cfg: Dict, prec: str = "f32", grad: bool = False,
           layer_weights: Optional[Callable[[int], Dict[str, torch.Tensor]]] = None,
           embed_hook: Optional[Callable[[torch.Tensor], None]] = None):
    """Final-norm hidden states ``[B, S, E]`` of tokens ``[B, S]`` and the
    router losses averaged over the layers.  ``layer_weights(li)`` gives
    layer ``li``'s f32 weights (default: slices of ``tree``'s layer
    stacks, as f32); under ``grad`` each layer is recomputed in the
    backward, and ``embed_hook`` receives the gradient of the embedded
    tokens."""
    g = dims(cfg)
    get = layer_weights or (lambda li: {n: w[li].float() for n, w in tree["layers"].items()})
    pos = torch.arange(tokens.shape[1], device=tokens.device)
    x = tree["embed"]["tokens"][tokens].float()
    if embed_hook is not None:
        x.register_hook(embed_hook)
    lb = rz = x.new_zeros(())
    for li in range(g["l"]):
        lw = get(li)
        if grad:
            x, lb_i, rz_i = checkpoint(layer, x, lw, cfg, pos, prec, True, use_reentrant=False)
        else:
            x, lb_i, rz_i = layer(x, lw, cfg, pos, prec, False)
        lb, rz = lb + lb_i, rz + rz_i
    return rms(x, tree["out_norm"].float(), cfg["rms_norm_eps"]), lb / g["l"], rz / g["l"]


def _loss_chunk(h, head, targets, prec):
    logits = wprod("bce,ev->bcv", h, head, prec)
    logz = torch.logsumexp(logits, dim=-1)
    true = torch.gather(logits, -1, targets[..., None])[..., 0]
    return (logz - true).sum(), logz.square().sum()


def next_token_loss(h: torch.Tensor, head: torch.Tensor, tokens: torch.Tensor, z_loss: float, prec: str,
                    grad: bool):
    """Mean next-token cross entropy over positions 0 .. S-2, plus
    ``z_loss`` times the mean squared log-normalizer, in chunks of
    positions (recomputed in the backward under ``grad``)."""
    b, s, _ = h.shape
    ce = zz = h.new_zeros(())
    for c0 in range(0, s - 1, LOSS_CHUNK):
        c1 = min(s - 1, c0 + LOSS_CHUNK)
        args = (h[:, c0:c1], head, tokens[:, c0 + 1:c1 + 1].long(), prec)
        ce_c, z_c = checkpoint(_loss_chunk, *args, use_reentrant=False) if grad else _loss_chunk(*args)
        ce, zz = ce + ce_c, zz + z_c
    n = b * (s - 1)
    return ce / n + z_loss * zz / n, ce / n


@torch.no_grad()
def logits(tree: Dict, tokens: torch.Tensor, cfg: Dict, prec: str = "f32") -> torch.Tensor:
    """f32 logits ``[T, V]`` of one sequence ``tokens [T]`` at every
    position."""
    h, _, _ = hidden(tree, tokens[None], cfg, prec)
    return wprod("se,ev->sv", h[0], tree["lm_head"].float(), prec)
