"""Ulysses sequence parallelism: the port of ``tpu_nexus/parallel/ulysses.py``.

Outside attention the activations are sequence-sharded over ``sp``;
inside it they are head-sharded with the whole sequence local.  The
sequence <-> heads transposition is one all-to-all over ``sp`` a tensor
(:class:`collectives.AllToAll`: q, k and v in, the output back), and the
flash kernel (#1 forward, #2/#3 backward, ``ops/attention.py``) runs
unmodified on the full local sequence of ``Hq / (sp·tp)`` heads.  The
JAX package gets its all-to-alls from two sharding constraints; the port
issues them.

Heads: a rank at ``(sp=i, tp=j)`` holds heads ``j·H/tp .. (j+1)·H/tp``
outside attention (tp-sharded) and, inside, the ``i``-th ``H/(sp·tp)``
of those.  The JAX layout orders the inner head shards ``(sp, tp)``, the
port's ``(tp, sp)``; attention is per head and a q head's KV head is in
the same chunk either way (``Hq`` and ``Hkv`` both divide by ``sp·tp``),
so the values are the same.
"""

from __future__ import annotations

from typing import Any

import torch

from tpu_nexus_torch.ops.attention import attention
from tpu_nexus_torch.parallel import collectives


def ulysses_supported(n_heads: int, n_kv_heads: int, mesh: Any, seq_axis: str = "sp", head_axis: str = "tp") -> bool:
    """Head-divisibility feasibility (the GQA KV heads bind): ``Hq`` and
    ``Hkv`` divisible by ``sp·tp``."""
    extent = mesh.size(seq_axis) * (mesh.size(head_axis) if head_axis else 1)
    return n_heads % extent == 0 and n_kv_heads % extent == 0


def ulysses_attention(q, k, v, *, mesh: Any, causal: bool = True, seq_axis: str = "sp",
                      head_axis: str = "tp", impl: str = "auto") -> torch.Tensor:
    """Attention over a sequence sharded on ``seq_axis``: this rank's
    ``[B, S/sp, H/tp, D]`` shards in, the output in the same layout.  The
    head counts are the GLOBAL ones' local share: ``Hq``/``Hkv`` here are
    ``H/tp``, and the cap is checked on the global counts."""
    tp = mesh.size(head_axis) if head_axis else 1
    hq, hkv = q.shape[2] * tp, k.shape[2] * tp
    if not ulysses_supported(hq, hkv, mesh, seq_axis, head_axis):
        extent = mesh.size(seq_axis) * tp
        raise ValueError(
            f"ulysses needs head counts divisible by sp·tp={extent}; got "
            f"Hq={hq}, Hkv={hkv} — use sp_attn='ring' for this layout"
        )
    sp = mesh.size(seq_axis)
    if sp == 1:
        return attention(q, k, v, causal=causal, impl=impl)
    group, comm = mesh.group(seq_axis), collectives.current()
    # in: scatter heads (dim 2), gather the sequence (dim 1)
    q, k, v = (collectives.AllToAll.apply(t, 2, 1, group, sp, comm) for t in (q, k, v))
    o = attention(q, k, v, causal=causal, impl=impl)
    # out: back to the sequence-sharded layout the rest of the layer uses
    return collectives.AllToAll.apply(o, 1, 2, group, sp, comm)
