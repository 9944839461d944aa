"""Dequant-inside-matmul for weight-only-quantized decode: the CUDA kernels'
wrapper, their plain version, and the models' weight-matmul call site.

Replaces ``tpu_nexus/ops/quant_matmul.py``: ``_int8_kernel`` and
``_int4_kernel`` (launched by ``quant_matmul``) and ``weight_einsum``.  The
kernels live in ``csrc/quant_matmul.cu``; the source note there says what
bounds them on the H100 (the packed weight's bytes at decode-sized M) and
what each design does about it.  int4 with bf16 activations takes the ring
kernel, one launch over a stream-K partition of the packed weight into
equal runs, one a persistent CTA (:func:`int4_plan`, :func:`int4_partition`),
the K split merged in the launch through a per-device workspace of arrival
counters and partials (:func:`_ring_workspace`); an int4 shape it does not
take (:func:`int4_ring_route`: N or the group not a multiple of 16, an
unaligned operand) takes the first design, a partial pass over a
:func:`split_plan` and a finalize launch, as int8 and f32 activations do.

* :func:`quant_matmul_plain` — the kernels' arithmetic in PyTorch, in
  their operation order.  int8: ``x · q8`` accumulated in f32, the
  per-output-channel scale applied once to the sum, cast to x's dtype.
  int4: nibbles unpacked, ``vals · s`` in f32, ROUNDED to x's dtype, then
  the product accumulated in f32.
* :func:`quant_matmul` — the wrapper for a 2D ``x [M, K]``: validation
  that names every violated clause; a CPU tensor takes the plain version,
  a CUDA tensor launches the kernel (counted in ``launches_int8`` /
  ``launches_int4``) or raises.
* :func:`weight_einsum` — ``einsum(spec, x, w)`` with the weight consumed
  at the compute dtype.  Plain tensors take the unchanged ``torch.einsum``.
  Quantized weights go to :func:`quant_matmul` on the card when
  :func:`quant_matmul_supported` holds (decode-sized M, no lead dims) and
  otherwise to ``einsum(spec, x, w.to(ct))``, dequantize-then-matmul — the
  prefill path, expert stacks and the CPU, as in the reference outside its
  kernels.  ``impl="plain"`` (or ``NEXUS_QUANT_KERNEL=plain``, which
  replaces the ``auto`` default) forces the latter everywhere.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, List, Tuple

import torch

from tpu_nexus_torch.ops import _build
from tpu_nexus_torch.ops.qtensor import QTensor, QTensor4, _prod, _unpack_nibbles

IMPLS = ("auto", "plain")
#: cap on the activation rows of the fused path: decode-sized M (batch ·
#: q_len); prefill's M = batch · seq belongs on the dense matmul
MAX_FUSED_M = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: weight columns per CTA (one 4-byte load per lane), activation rows per
#: CTA, and weight rows (packed rows for int4) per staged tile in the kernel
COLS = 128
ROWS_M = 8
TILE_ROWS = 128
#: CTAs the K-split fills (four resident CTAs on each of the H100's 132 SMs)
TARGET_CTAS = 528
#: the int4 ring kernel: packed rows a ring stage holds (one 8-row mma k block
#: for each of its 8 consumer warps), the most scale rows a stage stages, and
#: the fewest units a CTA takes (so a tile is not cut into more partials
#: than its merge can read back quickly)
RING_ROWS = 64
RING_SCALE_ROWS = 8
MIN_RING_UNITS = 2


def _geometry(w) -> Tuple[tuple, tuple, tuple]:
    """``(lead, contract, out)`` sub-shapes of a quantized weight.
    ``QTensor4`` carries its split beside the data.  ``QTensor`` stores q in
    the ORIGINAL weight shape; its contraction dims are exactly the dims
    its keepdim scale collapsed to 1 — a contiguous run, anything before it
    a batching lead (expert stacks), anything after it the output dims."""
    if isinstance(w, QTensor4):
        nl = w.q.ndim - 2
        return tuple(w.q.shape[:nl]), w.contract_shape, w.out_shape
    dims = [d for d in range(w.q.ndim) if w.s.shape[d] == 1 and w.q.shape[d] != 1]
    first, last = dims[0], dims[-1]
    shape = tuple(w.q.shape)
    return shape[:first], shape[first : last + 1], shape[last + 1 :]


def quant_matmul_supported(x: torch.Tensor, w) -> bool:
    """Inputs :func:`weight_einsum` sends to :func:`quant_matmul` when ``x``
    is on a card: a quantized weight with no batching lead dims; x's
    trailing dims are the weight's contraction dims; decode-sized M
    (:data:`MAX_FUSED_M`).  Any K and N: the kernels mask ragged edges
    themselves.  An activation dtype the kernels do not take, or a weight
    on another device, is NOT a reason to dequantize instead:
    :func:`quant_matmul` raises on it and names the clause."""
    if not isinstance(w, (QTensor, QTensor4)):
        return False
    lead, contract, _ = _geometry(w)
    if lead:
        return False
    nc = len(contract)
    if x.ndim <= nc or tuple(x.shape[x.ndim - nc :]) != tuple(contract):
        return False
    if _prod(x.shape[: x.ndim - nc]) > MAX_FUSED_M:
        return False
    return x.device.type != "cpu"


def quant_matmul_plain(x: torch.Tensor, w) -> torch.Tensor:
    """Plain PyTorch version of the kernels for ``x [M, K]`` and a
    lead-dim-free quantized weight (see the module docstring)."""
    _, contract, out = _geometry(w)
    k, n = _prod(contract), _prod(out)
    if isinstance(w, QTensor4):
        vals = _unpack_nibbles(w.q.reshape(k // 2, n), w.group).float()
        wd = (vals.reshape(k // w.group, w.group, n) * w.s.reshape(k // w.group, 1, n).float())
        wd = wd.reshape(k, n).to(x.dtype)
        return (x.float() @ wd.float()).to(x.dtype)
    acc = x.float() @ w.q.reshape(k, n).float()
    return (acc * w.s.reshape(1, n).float()).to(x.dtype)


def split_plan(rows: int, n: int, m: int) -> Tuple[int, int]:
    """(rows_per_split, n_splits) over the weight's rows (packed rows for
    int4): as many K-splits as keep column strips · M tiles · splits within
    :data:`TARGET_CTAS` (the CTAs resident at once, so the grid is one even
    wave and not a full wave plus a thin one), each a whole number of
    kernel tiles."""
    strips = -(-n // COLS) * -(-m // ROWS_M)
    n_tiles = -(-rows // TILE_ROWS)
    max_splits = max(1, TARGET_CTAS // strips)
    tiles_per_split = -(-n_tiles // max_splits)
    rows_per_split = tiles_per_split * TILE_ROWS
    return rows_per_split, -(-rows // rows_per_split)


def int4_ring_route(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor, n: int, group: int) -> bool:
    """Whether a bf16 int4 call takes the ring kernel: N a multiple of 16
    (TMA's 16-byte row pitch), the group a multiple of 16 (an 8-row k block
    in one group, a 16-byte activation copy in one group half) and the
    operands 16-byte aligned.  Anything else is the pitch branch, the first
    design's partial pass and finalize launch: chosen from the shape before
    launch, never after a failed one."""
    return n % 16 == 0 and group % 16 == 0 and all(t.data_ptr() % 16 == 0 for t in (x, q, s))


def int4_scale_rows(group: int) -> int:
    """The most groups (scale rows) the 64 packed rows of one ring stage
    touch, for a group that is a multiple of 16: the rows of the scale box
    the kernel's producer stages with each packed tile."""
    h8 = group // 16  # 8-row k blocks in half a group
    if RING_SCALE_ROWS % h8 == 0:
        return RING_SCALE_ROWS // h8
    if h8 % RING_SCALE_ROWS == 0:
        return 1
    return min(RING_SCALE_ROWS, (RING_SCALE_ROWS - 1) // h8 + 2)


def int4_plan(rows: int, n: int, m: int, resident: int) -> Tuple[int, int]:
    """``(units, grid)`` of the ring kernel for ``rows`` packed rows, N
    columns and M activation rows: a unit is one stage (:data:`RING_ROWS`
    packed rows of a 128-column strip, for an 8-row M chunk).  Where the
    tiles are fewer than the CTAs the card holds (``resident``), each tile
    is cut into the most equal runs that divide its stages and fit, so no
    run straddles two tiles: a CTA then merges at most one tile, and the
    merge's round trips come once a run (measured faster at every decode
    shape, ``chip_smoke.py --phases build,int4_probe``).  Else the grid is
    the resident CTAs, no more than the units allow at
    :data:`MIN_RING_UNITS` each."""
    tiles, n_kb = -(-n // COLS) * -(-m // ROWS_M), -(-rows // RING_ROWS)
    if tiles < resident:
        runs = resident // tiles
        while n_kb % runs:
            runs -= 1
        return tiles * n_kb, tiles * runs
    return tiles * n_kb, max(1, min(resident, tiles * n_kb // MIN_RING_UNITS))


def int4_partition(rows: int, n: int, m: int, grid: int) -> Dict[int, List[Tuple[int, int, int, int]]]:
    """The ring kernel's work, as its CTAs derive it: CTA c takes units
    ``[c·units/grid, (c+1)·units/grid)`` of the walk (k block fastest, then
    the M chunk, then the strip).  Returns, for every tile (strip · M chunks
    + chunk), its runs in merge order: ``(cta, slot, first packed row,
    end packed row)``.  A tile of one run is written by its CTA; otherwise
    each CTA writes its partial into workspace slot ``(cta, slot)`` (0: the
    run's first tile, 1: its last) and the last to arrive adds them in this
    order.  The partition is the kernel's contract, held by a CPU test."""
    units, _ = int4_plan(rows, n, m, grid)
    n_kb = -(-rows // RING_ROWS)
    tiles: Dict[int, List[Tuple[int, int, int, int]]] = {}
    for c in range(grid):
        begin, end = c * units // grid, (c + 1) * units // grid
        u = begin
        while u < end:
            tile = u // n_kb
            seg_end = min(end, (tile + 1) * n_kb)
            slot = 0 if begin >= tile * n_kb else 1
            kb0, kb1 = u - tile * n_kb, seg_end - tile * n_kb
            tiles.setdefault(tile, []).append((c, slot, kb0 * RING_ROWS, min(kb1 * RING_ROWS, rows)))
            u = seg_end
    return tiles


#: (device index, stream) -> (workspace, counter words, partial floats)
_RING_WORKSPACES: dict = {}
_RING_LOCK = threading.Lock()
#: device index -> CTAs of the ring kernel the card holds
_RING_RESIDENT: dict = {}


def _ring_resident(device: torch.device) -> int:
    """SMs times the ring kernel's CTAs an SM holds (the library's occupancy
    query), cached per device."""
    found = _RING_RESIDENT.get(device.index)
    if found is None:
        with torch.cuda.device(device):
            per_sm = _build.library().nexus_quant_int4_ctas_per_sm()
        if per_sm <= 0:
            raise RuntimeError(f"nexus_quant_int4_ctas_per_sm: the ring kernel fits no CTA on {device}")
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        found = _RING_RESIDENT[device.index] = per_sm * sms
    return found


def _ring_workspace(device: torch.device, stream: int, tiles: int, grid: int) -> Tuple[int, int]:
    """``(partials, counters)`` addresses in the ring kernel's workspace of
    ``device`` and ``stream``: ``tiles`` arrival counters, zeroed once (a
    launch leaves them 0), then ``grid · 2 · 8 · 128`` f32 partials.  Regrown
    (zeroed) when a launch needs more; launches on one stream run in order,
    another stream gets its own buffer."""
    key = (device.index, stream)
    need = grid * 2 * ROWS_M * COLS
    with _RING_LOCK:
        buf, n_counters, n_parts = _RING_WORKSPACES.get(key, (None, 0, 0))
        if buf is None or n_counters < tiles or n_parts < need:
            n_counters = max(n_counters, -(-tiles // 256) * 256)
            n_parts = max(n_parts, need)
            buf = torch.zeros(n_counters + n_parts, dtype=torch.int32, device=device)
            _RING_WORKSPACES[key] = (buf, n_counters, n_parts)
    return buf.data_ptr() + 4 * n_counters, buf.data_ptr()


def quant_matmul(x: torch.Tensor, w) -> torch.Tensor:
    """Fused ``x @ dequant(w)`` for a 2D activation ``x`` [M, K] against a
    lead-dim-free :class:`QTensor` (int8, per-output-channel scales) or
    :class:`QTensor4` (packed int4, group scales).  Returns [M, N] in x's
    dtype with f32 accumulation.  A CPU tensor takes
    :func:`quant_matmul_plain`; a CUDA tensor launches the kernel or
    raises."""
    if not isinstance(w, (QTensor, QTensor4)):
        raise TypeError(f"quant_matmul needs a QTensor or QTensor4 weight, got {type(w).__name__}")
    int4 = isinstance(w, QTensor4)
    lead, contract, out = _geometry(w)
    k, n = _prod(contract), _prod(out)
    problems = []
    if lead:
        problems.append(
            f"weight has batching lead dims {tuple(lead)} (MoE expert stack) — the kernel is 2D"
        )
    if x.ndim != 2:
        problems.append(f"x must be 2D [M, K], got {tuple(x.shape)}")
    elif x.shape[1] != k:
        problems.append(f"x K {x.shape[1]} != weight contraction width {k}")
    if x.ndim == 2 and x.shape[0] > MAX_FUSED_M:
        problems.append(
            f"M {x.shape[0]} > MAX_FUSED_M {MAX_FUSED_M} (prefill-sized "
            "activations belong on the dense matmul path)"
        )
    if x.ndim == 2 and x.shape[0] < 1:
        problems.append("M must be >= 1")
    if x.device.type != "cpu":
        if not x.is_cuda or w.q.device != x.device or w.s.device != x.device:
            problems.append(
                f"x on {x.device}, weight on {w.q.device} (the kernel needs both on one CUDA device)"
            )
        if x.dtype not in _DTYPES:
            problems.append(f"x dtype {x.dtype} (the kernel takes bfloat16 or float32)")
    if problems:
        raise ValueError(
            "quant_matmul unsupported inputs: " + "; ".join(problems)
            + " — use the dequantize-then-einsum path (weight_einsum auto dispatch)"
        )
    if x.device.type == "cpu":
        return quant_matmul_plain(x, w)

    m = x.shape[0]
    x = x.contiguous()
    if int4:
        q2 = w.q.reshape(k // 2, n).contiguous()
        s2 = w.s.reshape(k // w.group, n).float().contiguous()
        rows, half_group = k // 2, w.group // 2
    else:
        q2 = w.q.reshape(k, n).contiguous()
        s2 = w.s.reshape(n).float().contiguous()
        rows, half_group = k, 0
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    lib = _build.library()
    if int4 and x.dtype == torch.bfloat16 and int4_ring_route(x, q2, s2, n, w.group):
        _, grid = int4_plan(rows, n, m, _ring_resident(x.device))
        stream = _build.stream_ptr(x.device)
        part, arrivals = _ring_workspace(x.device, stream, -(-n // COLS) * -(-m // ROWS_M), grid)
        with torch.cuda.device(x.device):  # the runtime launches on its current device
            status = lib.nexus_quant_int4_ring(
                x.data_ptr(), q2.data_ptr(), s2.data_ptr(), y.data_ptr(), part, arrivals,
                m, k, n, half_group, int4_scale_rows(w.group), grid, stream,
            )
        _build.check(status, "nexus_quant_int4_ring")
    else:
        rows_per_split, n_splits = split_plan(rows, n, m)
        part = torch.empty((n_splits, m, n), dtype=torch.float32, device=x.device)
        with torch.cuda.device(x.device):
            status = lib.nexus_quant_matmul(
                x.data_ptr(), q2.data_ptr(), s2.data_ptr(), y.data_ptr(), part.data_ptr(),
                m, k, n, half_group, rows_per_split, n_splits, _DTYPES[x.dtype],
                _build.stream_ptr(x.device),
            )
        _build.check(status, "nexus_quant_matmul")
    if int4:
        quant_matmul.launches_int4 += 1
    else:
        quant_matmul.launches_int8 += 1
    return y


quant_matmul.launches_int8 = 0
quant_matmul.launches_int4 = 0


def weight_einsum(spec: str, x: torch.Tensor, w, ct: torch.dtype, *, impl: str = "auto") -> torch.Tensor:
    """The models' weight-matmul call site: ``einsum(spec, x, w)`` with the
    weight consumed at compute dtype ``ct`` (see the module docstring for
    the dispatch).  The fused path assumes the spec's standard
    weight-matmul shape: ``x``'s trailing dims are exactly the weight's
    contraction dims and the output appends the weight's out dims (true of
    every projection/MLP spec of the model zoo)."""
    if impl not in IMPLS:
        raise ValueError(f"unknown weight_einsum impl {impl!r}; use 'auto' or 'plain'")
    if not isinstance(w, (QTensor, QTensor4)):
        return torch.einsum(spec, x, w.to(ct))
    if impl == "auto":
        impl = os.environ.get("NEXUS_QUANT_KERNEL", "") or "auto"
        if impl not in IMPLS:
            raise ValueError(
                f"NEXUS_QUANT_KERNEL={impl!r} is not a weight-matmul impl; "
                "use 'plain' (unset = auto)"
            )
    x = x.to(ct)
    if impl == "plain" or not quant_matmul_supported(x, w):
        return torch.einsum(spec, x, w.to(ct))
    _, contract, out = _geometry(w)
    batch = x.shape[: x.ndim - len(contract)]
    return quant_matmul(x.reshape(_prod(batch), _prod(contract)), w).reshape(*batch, *out)
