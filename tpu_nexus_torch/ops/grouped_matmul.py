"""Grouped matmul for MoE experts: the CUDA kernels' wrappers, their plain
versions, and the autograd functions that train through them.

Replaces ``tpu_nexus/ops/grouped_matmul.py``: ``_gmm_kernel`` (launched by
``_gmm_raw``) and ``_tgmm_kernel`` (launched by ``_tgmm_raw`` inside
``_gmm_bwd``).  The kernels live in ``csrc/grouped_matmul.cu``; the source
note there says what bounds them on the H100 (the tensor cores, at the
MoE train step's shapes) and what the design does about it: in bf16,
persistent CTAs whose producer warp feeds a TMA ring of 64-deep slabs to
two consumer warpgroups running ``wgmma`` on 128 × 256 output tiles,
operands read in place through tensor maps (``rhs`` by expert, and
transposed for ``d_lhs``, without a copy); tgmm's units run heaviest
expert first and each writes its f32 block once.  f32 runs on the CUDA
cores.

Rows of ``lhs [M, K]`` are sorted by expert and each expert's run is
padded to a multiple of the m-tile ``block_m``, so every ``block_m``-row
tile belongs to one expert, named by ``tile_expert [M / block_m]``.

* :func:`gmm_plain` / :func:`tgmm_plain` — the functions in plain PyTorch
  (the reference's ``_gmm_ref`` / ``_tgmm_ref``), as a loop over experts:
  ``out[tile] = lhs[tile] · rhs[tile_expert[tile]]`` with an f32 sum and
  the result in lhs's dtype; ``d_rhs[e]`` = the f32 sum of
  ``lhs_tileᵀ · d_out_tile`` over the tiles of ``e`` (zero for an expert
  with no tile).  Each selects its tiles with ``nonzero``, a host read the
  plain version may make: on the card it is only the kernels' reference.
* :func:`gmm_kernel_call` / :func:`tgmm_kernel_call` — the wrappers: a CPU
  tensor takes the plain version, a CUDA tensor launches the kernel
  (counted in the wrapper's ``launches``) or raises.  Nothing falls back.
* :func:`gmm` — differentiable (:class:`GroupedMatmul`): the forward is
  kernel #7 through the dispatcher op ``nexus::gmm`` (so selective
  checkpointing sees the call); the backward runs kernel #7 again on
  ``rhsᵀ`` for ``d_lhs`` (the kernel reads ``rhs`` transposed in place, no
  copy) and kernel #8 for ``d_rhs``, cast to ``rhs.dtype``.
  :func:`gmm_checked` zeroes the ``d_rhs`` blocks of experts absent from
  ``tile_expert``.

``BLOCK_M`` (``NEXUS_GMM_BLOCK_M``, default 512) sets the MoE dispatch's
layout and must agree with the JAX package.  The reference's
``NEXUS_GMM_BLOCK_N`` / ``NEXUS_GMM_BLOCK_K`` are TPU tile sizes: the CUDA
kernels choose their own tiles and the port does not read them.  The
kernels take bf16 or f32 (lhs and rhs in one dtype), ``block_m`` a
multiple of 128, K and N whose rows are 16-byte aligned, and operands
whose first element is 16-byte aligned (as every fresh allocation is).
"""

from __future__ import annotations

import os

import torch

from tpu_nexus_torch.ops import _build

BLOCK_M = int(os.environ.get("NEXUS_GMM_BLOCK_M", 512))
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the kernels' CTA row tile: ``block_m`` must be a multiple of it
KERNEL_ROWS = 128


def _check_tiles(m: int, bm: int, tile_expert: torch.Tensor) -> None:
    """The tile→expert map must cover exactly the m-tiles: a silently
    shrunk tile would read te[] out of bounds (kernel) or pick the wrong
    expert (plain version)."""
    if m % bm or tile_expert.shape[0] != m // bm:
        raise ValueError(
            f"tile_expert has {tile_expert.shape[0]} entries but lhs has "
            f"{m} rows / {bm}-row tiles = {m / bm:g}; rows must be padded "
            "to a tile multiple with one entry per tile"
        )


def _tiles_of(tile_expert: torch.Tensor, e: int) -> torch.Tensor:
    return (tile_expert == e).nonzero()[:, 0]


def gmm_plain(
    lhs: torch.Tensor, rhs: torch.Tensor, tile_expert: torch.Tensor, block_m: int
) -> torch.Tensor:
    """``[M, K] × [E, K, N] → [M, N]`` in lhs's dtype, f32 sums; a tile
    whose expert is outside ``[0, E)`` comes out zero, as in the kernel."""
    m, k = lhs.shape
    _check_tiles(m, block_m, tile_expert)
    nt = m // block_m
    lt = lhs.reshape(nt, block_m, k)
    out = torch.zeros((nt, block_m, rhs.shape[2]), dtype=lhs.dtype, device=lhs.device)
    for e in range(rhs.shape[0]):
        tiles = _tiles_of(tile_expert, e)
        if tiles.numel():
            out[tiles] = (lt[tiles].float() @ rhs[e].float()).to(lhs.dtype)
    return out.reshape(m, rhs.shape[2])


def tgmm_plain(
    lhs: torch.Tensor, d_out: torch.Tensor, tile_expert: torch.Tensor, n_experts: int, block_m: int
) -> torch.Tensor:
    """f32 ``[E, K, N]``: ``out[e]`` = Σ over the tiles of ``e`` of
    ``lhs_tileᵀ · d_out_tile``; zero for an expert with no tile."""
    m, k = lhs.shape
    n = d_out.shape[1]
    _check_tiles(m, block_m, tile_expert)
    nt = m // block_m
    lt, dt = lhs.reshape(nt, block_m, k), d_out.reshape(nt, block_m, n)
    out = torch.zeros((n_experts, k, n), dtype=torch.float32, device=lhs.device)
    for e in range(n_experts):
        tiles = _tiles_of(tile_expert, e)
        if tiles.numel():
            out[e] = lt[tiles].reshape(-1, k).float().T @ dt[tiles].reshape(-1, n).float()
    return out


def _check_kernel_inputs(what: str, lhs, other, tile_expert, block_m, k, n) -> None:
    """Raise, naming every clause, on CUDA inputs the kernels do not take
    (``lhs`` and ``other`` as the kernel will read them: contiguous)."""
    problems = []
    if lhs.dtype not in _DTYPES or other.dtype != lhs.dtype:
        problems.append(f"dtypes {lhs.dtype} / {other.dtype} (both bfloat16 or both float32)")
    if other.device != lhs.device or tile_expert.device != lhs.device:
        problems.append(
            f"devices {lhs.device} / {other.device} / tile_expert {tile_expert.device} (one CUDA device)"
        )
    if tile_expert.dtype not in (torch.int32, torch.int64):
        problems.append(f"tile_expert dtype {tile_expert.dtype} (an integer tensor)")
    if block_m % KERNEL_ROWS:
        problems.append(f"block_m {block_m} (a multiple of {KERNEL_ROWS})")
    align = 16 // lhs.element_size() if lhs.dtype in _DTYPES else 8
    for name, width in (("K", k), ("N", n)):
        if width < 1 or width % align:
            problems.append(f"{name} {width} (16-byte rows: a multiple of {align} in {lhs.dtype})")
    offsets = [t.data_ptr() % 16 for t in (lhs, other)]
    if any(offsets):
        problems.append(f"base addresses at {offsets[0]} / {offsets[1]} bytes past 16 (16-byte aligned)")
    if problems:
        raise ValueError(f"{what} kernel unsupported inputs: " + "; ".join(problems))


def gmm_kernel_call(
    lhs: torch.Tensor, rhs: torch.Tensor, tile_expert: torch.Tensor, block_m: int,
    *, transpose_rhs: bool = False,
) -> torch.Tensor:
    """Kernel #7's wrapper.  ``rhs [E, K, N]``, or with ``transpose_rhs``
    ``[E, N, K]`` read as its transpose (the backward's ``d_lhs``).  A CPU
    tensor takes :func:`gmm_plain`; a CUDA tensor launches the kernel
    (``gmm_kernel_call.launches``) or raises."""
    if lhs.dim() != 2 or rhs.dim() != 3:
        raise ValueError(f"gmm needs lhs [M, K] and rhs [E, K, N], got {tuple(lhs.shape)}, {tuple(rhs.shape)}")
    e, k_r, n_r = rhs.shape
    k, n = (n_r, k_r) if transpose_rhs else (k_r, n_r)
    if lhs.shape[1] != k:
        raise ValueError(f"lhs K {lhs.shape[1]} != rhs contraction width {k}")
    m = lhs.shape[0]
    _check_tiles(m, block_m, tile_expert)
    if lhs.device.type == "cpu":
        return gmm_plain(lhs, rhs.transpose(1, 2) if transpose_rhs else rhs, tile_expert, block_m)
    lhs, rhs = lhs.contiguous(), rhs.contiguous()
    _check_kernel_inputs("gmm", lhs, rhs, tile_expert, block_m, k, n)
    te = tile_expert.to(torch.int32).contiguous()
    out = torch.empty((m, n), dtype=lhs.dtype, device=lhs.device)
    if m == 0:
        return out
    with torch.cuda.device(lhs.device):  # the runtime launches on its current device
        status = _build.library().nexus_gmm(
            lhs.data_ptr(), rhs.data_ptr(), te.data_ptr(), out.data_ptr(), m, k, n, e, block_m,
            int(bool(transpose_rhs)), _DTYPES[lhs.dtype], _build.stream_ptr(lhs.device),
        )
    _build.check(status, "nexus_gmm")
    gmm_kernel_call.launches += 1
    return out


def tgmm_kernel_call(
    lhs: torch.Tensor, d_out: torch.Tensor, tile_expert: torch.Tensor, n_experts: int, block_m: int
) -> torch.Tensor:
    """Kernel #8's wrapper: f32 ``[E, K, N]`` from ``lhs [M, K]`` and
    ``d_out [M, N]``.  A CPU tensor takes :func:`tgmm_plain`; a CUDA tensor
    launches the kernel (``tgmm_kernel_call.launches``) or raises."""
    if lhs.dim() != 2 or d_out.dim() != 2 or lhs.shape[0] != d_out.shape[0]:
        raise ValueError(f"tgmm needs lhs [M, K] and d_out [M, N], got {tuple(lhs.shape)}, {tuple(d_out.shape)}")
    m, k = lhs.shape
    n = d_out.shape[1]
    _check_tiles(m, block_m, tile_expert)
    if lhs.device.type == "cpu":
        return tgmm_plain(lhs, d_out, tile_expert, n_experts, block_m)
    lhs, d_out = lhs.contiguous(), d_out.contiguous()
    _check_kernel_inputs("tgmm", lhs, d_out, tile_expert, block_m, k, n)
    te = tile_expert.to(torch.int32).contiguous()
    if m == 0:
        return torch.zeros((n_experts, k, n), dtype=torch.float32, device=lhs.device)
    out = torch.empty((n_experts, k, n), dtype=torch.float32, device=lhs.device)
    with torch.cuda.device(lhs.device):
        status = _build.library().nexus_tgmm(
            lhs.data_ptr(), d_out.data_ptr(), te.data_ptr(), out.data_ptr(), m, k, n, n_experts,
            block_m, _DTYPES[lhs.dtype], _build.stream_ptr(lhs.device),
        )
    _build.check(status, "nexus_tgmm")
    tgmm_kernel_call.launches += 1
    return out


gmm_kernel_call.launches = 0
tgmm_kernel_call.launches = 0


# -- autograd ------------------------------------------------------------------


@torch.library.custom_op("nexus::gmm", mutates_args=())
def gmm_op(lhs: torch.Tensor, rhs: torch.Tensor, tile_expert: torch.Tensor, block_m: int) -> torch.Tensor:
    """:func:`gmm_kernel_call` as one dispatcher op, so that selective
    activation checkpointing (``models/llama.py``) can name it."""
    return gmm_kernel_call(lhs, rhs, tile_expert, block_m)


class GroupedMatmul(torch.autograd.Function):
    """The reference's ``gmm`` custom VJP.  INVARIANT for the backward, as
    there: ``tile_expert`` names every expert at least once, or that
    expert's ``d_rhs`` block is zero here (undefined on the TPU); the MoE
    dispatch gives every expert a tile.  :class:`GroupedMatmulChecked`
    zeroes absent experts' blocks explicitly."""

    @staticmethod
    def forward(ctx, lhs, rhs, tile_expert, block_m: int):
        ctx.save_for_backward(lhs, rhs, tile_expert)
        ctx.block_m = block_m
        return gmm_op(lhs, rhs, tile_expert, block_m)

    @staticmethod
    def backward(ctx, d_out):
        lhs, rhs, tile_expert = ctx.saved_tensors
        d_out = d_out.contiguous()
        d_lhs = gmm_kernel_call(d_out, rhs, tile_expert, ctx.block_m, transpose_rhs=True)
        d_rhs = tgmm_kernel_call(lhs, d_out, tile_expert, rhs.shape[0], ctx.block_m)
        return d_lhs.to(lhs.dtype), d_rhs.to(rhs.dtype), None, None


class GroupedMatmulChecked(GroupedMatmul):
    """:class:`GroupedMatmul` whose backward zero-masks the ``d_rhs``
    blocks of experts absent from ``tile_expert`` (the reference's
    ``_gmm_checked_bwd``)."""

    @staticmethod
    def backward(ctx, d_out):
        d_lhs, d_rhs, _, _ = GroupedMatmul.backward(ctx, d_out)
        tile_expert = ctx.saved_tensors[2]
        ne = d_rhs.shape[0]
        present = (tile_expert.long()[:, None] == torch.arange(ne, device=tile_expert.device)).any(0)
        return d_lhs, torch.where(present[:, None, None], d_rhs, torch.zeros_like(d_rhs)), None, None


def gmm(lhs: torch.Tensor, rhs: torch.Tensor, tile_expert: torch.Tensor, block_m: int = BLOCK_M) -> torch.Tensor:
    """Grouped matmul ``[M, K] × [E, K, N] → [M, N]`` with tile-aligned
    expert runs, differentiable (:class:`GroupedMatmul`)."""
    return GroupedMatmul.apply(lhs, rhs, tile_expert, int(block_m))


def gmm_checked(
    lhs: torch.Tensor, rhs: torch.Tensor, tile_expert: torch.Tensor, block_m: int = BLOCK_M
) -> torch.Tensor:
    """:func:`gmm` for callers that cannot guarantee every expert a tile."""
    return GroupedMatmulChecked.apply(lhs, rhs, tile_expert, int(block_m))
