"""Dequant-inside-matmul for weight-only-quantized decode: the CUDA kernels'
wrapper, their plain version, and the models' weight-matmul call site.

Replaces ``tpu_nexus/ops/quant_matmul.py``: ``_int8_kernel`` and
``_int4_kernel`` (launched by ``quant_matmul``) and ``weight_einsum``.  The
kernels live in ``csrc/quant_matmul.cu``; the source note there says what
bounds them on the H100 (the packed weight's bytes at decode-sized M) and
what each design does about it.  With bf16 activations int8 and int4 each
take a ring kernel, one launch over a stream-K partition of the weight into
equal runs, one a persistent CTA (:func:`ring_plan`, :func:`int8_plan`,
:func:`ring_partition`), the K split merged in the launch: for int8 with few
tiles in the shared memory of a cluster of a tile's CTAs, otherwise through
a per-device workspace of arrival counters and partials
(:func:`_ring_workspace`).  A shape a ring kernel does not take
(:func:`int8_ring_route`, :func:`int4_ring_route`: N, K or the group off its
pitch, an unaligned operand) and f32 activations take the first design, a
partial pass over a :func:`split_plan` and a finalize launch.

* :func:`quant_matmul_plain` — the kernels' arithmetic in PyTorch, in
  their operation order.  int8: ``x · q8`` accumulated in f32, the
  per-output-channel scale applied once to the sum, cast to x's dtype.
  int4: nibbles unpacked, ``vals · s`` in f32, ROUNDED to x's dtype, then
  the product accumulated in f32.
* :func:`quant_matmul` — the wrapper for a 2D ``x [M, K]``: validation
  that names every violated clause; a CPU tensor takes the plain version,
  a CUDA tensor launches the kernel (counted in ``launches_int8`` /
  ``launches_int4``, and by route in ``launches_by_route``) or raises.
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
#: the int8 ring kernel: weight rows a ring stage holds and a tile's columns
#: (``kI8Rows`` and ``kI8Cols`` of ``csrc/quant_matmul.cu``; the launch
#: refuses a plan made with other values), and the most runs of one tile it
#: launches as a thread block cluster (their sums merged in the cluster's
#: shared memory; 8 is the portable cluster size)
INT8_RING_ROWS = 128
INT8_RING_COLS = 128
INT8_MAX_CLUSTER = 8
#: the longest run (stages) the int8 plan lengthens to launch a tile's runs
#: as a cluster (at the decode step's wk/wv launch, 8 runs in clusters beat
#: 16 merged through L2: ``chip_smoke.py --phases build,int8_probe``)
INT8_SHORT_RUN = 8


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


def int8_ring_route(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor, n: int) -> bool:
    """Whether an int8 call takes the ring kernel: bf16 activations, N a
    multiple of 16 (TMA's 16-byte row pitch), K a multiple of 8 (16-byte
    activation copies) and the operands 16-byte aligned.  Anything else
    (f32 activations, N 200 or 71, an unaligned operand) takes the first
    design's partial pass and finalize launch: chosen from the shape before
    launch, never after a failed one."""
    return (x.dtype == torch.bfloat16 and n % 16 == 0 and x.shape[-1] % 8 == 0
            and all(t.data_ptr() % 16 == 0 for t in (x, q, s)))


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


def ring_plan(rows: int, n: int, m: int, resident: int, stage_rows: int, cols: int = COLS) -> Tuple[int, int]:
    """``(units, grid)`` of a ring kernel for ``rows`` weight rows (packed
    rows for int4), N columns and M activation rows: a unit is one stage
    (``stage_rows`` rows of a ``cols``-column strip, for an 8-row M chunk;
    int4: :data:`RING_ROWS`, int8: :data:`INT8_RING_ROWS` and
    :data:`INT8_RING_COLS`).  Where the tiles are fewer than the CTAs the
    card holds (``resident``), each tile is cut into the most equal runs
    that divide its stages and fit, so no run straddles two tiles: a CTA
    then merges at most one tile, and the merge's round trips come once a
    run (measured faster at every int4 decode shape, ``chip_smoke.py
    --phases build,int4_probe``).  Else the grid is the resident CTAs, no
    more than the units allow at :data:`MIN_RING_UNITS` each."""
    tiles, n_kb = -(-n // cols) * -(-m // ROWS_M), -(-rows // stage_rows)
    if tiles < resident:
        runs = resident // tiles
        while n_kb % runs:
            runs -= 1
        return tiles * n_kb, tiles * runs
    return tiles * n_kb, max(1, min(resident, tiles * n_kb // MIN_RING_UNITS))


def int8_plan(
    k: int, n: int, m: int, resident: int, cluster_capacity, max_cluster: int
) -> Tuple[int, int, int]:
    """``(units, grid, cluster)`` of the int8 ring kernel: :func:`ring_plan`'s
    plan (its K split merged through the workspace, ``cluster`` 1), unless a
    tile's runs can be launched as one thread block cluster (``cluster`` c:
    the runs' sums meet in the cluster's shared memory, no round trips to
    L2).  ``cluster_capacity(c)``: how many clusters of c CTAs the card
    holds at once; every tile's cluster must be resident together.  The
    cluster takes the plan's own runs where they fit (at most
    ``max_cluster``); fewer, longer runs only where each stays within
    :data:`INT8_SHORT_RUN` stages, where a launch is mostly its merge."""
    units, grid = ring_plan(k, n, m, resident, INT8_RING_ROWS, INT8_RING_COLS)
    tiles, n_kb = -(-n // INT8_RING_COLS) * -(-m // ROWS_M), -(-k // INT8_RING_ROWS)
    runs = grid // tiles
    if tiles >= resident or runs < 2 or max_cluster < 2:
        return units, grid, 1
    c = min(runs, max_cluster)
    while c > 1 and (n_kb % c or cluster_capacity(c) < tiles):
        c -= 1
    if c == runs or (c > 1 and n_kb // c <= INT8_SHORT_RUN):
        return units, tiles * c, c
    return units, grid, 1


def ring_partition(
    rows: int, n: int, m: int, grid: int, stage_rows: int, cols: int = COLS
) -> Dict[int, List[Tuple[int, int, int, int]]]:
    """A ring kernel's work, as its CTAs derive it: CTA c takes units
    ``[c·units/grid, (c+1)·units/grid)`` of the walk (k block fastest, then
    the M chunk, then the strip).  Returns, for every tile (strip · M chunks
    + chunk), its runs in merge order: ``(cta, slot, first row, end row)``.
    A tile of one run is written by its CTA; otherwise each CTA writes its
    partial into workspace slot ``(cta, slot)`` (0: the run's first tile,
    1: its last) and the last to arrive adds them in this order.  The
    partition is the kernels' contract, held by a CPU test."""
    units = -(-n // cols) * -(-m // ROWS_M) * -(-rows // stage_rows)
    n_kb = -(-rows // stage_rows)
    tiles: Dict[int, List[Tuple[int, int, int, int]]] = {}
    for c in range(grid):
        begin, end = c * units // grid, (c + 1) * units // grid
        u = begin
        while u < end:
            tile = u // n_kb
            seg_end = min(end, (tile + 1) * n_kb)
            slot = 0 if begin >= tile * n_kb else 1
            kb0, kb1 = u - tile * n_kb, seg_end - tile * n_kb
            tiles.setdefault(tile, []).append((c, slot, kb0 * stage_rows, min(kb1 * stage_rows, rows)))
            u = seg_end
    return tiles


#: (device index, stream) -> (workspace, counter words, partial floats)
_RING_WORKSPACES: dict = {}
_RING_LOCK = threading.Lock()
#: (kernel, device index) -> CTAs of that ring kernel the card holds;
#: ("int8_clusters", size, device index) -> clusters of the int8 kernel it holds
_RING_RESIDENT: dict = {}


def _ring_resident(device: torch.device, kernel: str) -> int:
    """SMs times the CTAs of ring kernel ``kernel`` ("int4" or "int8") an
    SM holds (the library's occupancy query), cached per kernel and
    device."""
    found = _RING_RESIDENT.get((kernel, device.index))
    if found is None:
        query = f"nexus_quant_{kernel}_ctas_per_sm"
        with torch.cuda.device(device):
            per_sm = getattr(_build.library(), query)()
        if per_sm <= 0:
            raise RuntimeError(f"{query}: the {kernel} ring kernel fits no CTA on {device}")
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        found = _RING_RESIDENT[(kernel, device.index)] = per_sm * sms
    return found


def _int8_cluster_capacity(device: torch.device, cluster: int) -> int:
    """Clusters of ``cluster`` CTAs of the int8 ring kernel the card holds at
    once (the library's occupancy query), cached per size and device."""
    key = ("int8_clusters", cluster, device.index)
    found = _RING_RESIDENT.get(key)
    if found is None:
        with torch.cuda.device(device):
            found = _RING_RESIDENT[key] = _build.library().nexus_quant_int8_max_clusters(cluster)
    return found


def _ring_workspace(device: torch.device, stream: int, tiles: int, part_floats: int) -> Tuple[int, int]:
    """``(partials, counters)`` addresses in the ring kernels' workspace of
    ``device`` and ``stream``: ``tiles`` arrival counters, zeroed once (a
    launch leaves them 0), then ``part_floats`` f32 partials (grid · 2 · 8 ·
    the tile's columns).  Regrown (zeroed) when a launch needs more;
    launches on one stream run in order, so the int4 and int8 kernels share
    it, and another stream gets its own buffer."""
    key = (device.index, stream)
    with _RING_LOCK:
        buf, n_counters, n_parts = _RING_WORKSPACES.get(key, (None, 0, 0))
        if buf is None or n_counters < tiles or n_parts < part_floats:
            n_counters = max(n_counters, -(-tiles // 256) * 256)
            n_parts = max(n_parts, part_floats)
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
        _, grid = ring_plan(rows, n, m, _ring_resident(x.device, "int4"), RING_ROWS)
        stream = _build.stream_ptr(x.device)
        part, arrivals = _ring_workspace(
            x.device, stream, -(-n // COLS) * -(-m // ROWS_M), grid * 2 * ROWS_M * COLS
        )
        with torch.cuda.device(x.device):  # the runtime launches on its current device
            status = lib.nexus_quant_int4_ring(
                x.data_ptr(), q2.data_ptr(), s2.data_ptr(), y.data_ptr(), part, arrivals,
                m, k, n, half_group, int4_scale_rows(w.group), grid, stream,
            )
        _build.check(status, "nexus_quant_int4_ring")
        route = "int4_ring"
    elif not int4 and int8_ring_route(x, q2, s2, n):
        _, grid, cluster = int8_plan(
            k, n, m, _ring_resident(x.device, "int8"), lambda c: _int8_cluster_capacity(x.device, c),
            INT8_MAX_CLUSTER,
        )
        stream = _build.stream_ptr(x.device)
        part, arrivals = _ring_workspace(
            x.device, stream, -(-n // INT8_RING_COLS) * -(-m // ROWS_M), grid * 2 * ROWS_M * INT8_RING_COLS
        )
        with torch.cuda.device(x.device):
            status = lib.nexus_quant_int8_ring(
                x.data_ptr(), q2.data_ptr(), s2.data_ptr(), y.data_ptr(), part, arrivals,
                m, k, n, INT8_RING_ROWS, INT8_RING_COLS, grid, cluster, stream,
            )
        _build.check(status, "nexus_quant_int8_ring")
        route = "int8_ring"
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
        route = "int4_first_design" if int4 else "int8_first_design"
    if int4:
        quant_matmul.launches_int4 += 1
    else:
        quant_matmul.launches_int8 += 1
    quant_matmul.launches_by_route[route] += 1
    return y


quant_matmul.launches_int8 = 0
quant_matmul.launches_int4 = 0
#: launches by kernel: the ring kernels and the first design (with its finalize pass)
quant_matmul.launches_by_route = dict.fromkeys(
    ("int8_ring", "int8_first_design", "int4_ring", "int4_first_design"), 0
)


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
