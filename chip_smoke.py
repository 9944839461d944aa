#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``tpu_nexus_torch``) on one GPU.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py                      # every phase
    python3 chip_smoke.py --phases build,parity  # a subset, for quick checks

Phases, one JSON line each (in the order of ``PHASES``); any failure
raises and exits non-zero:

1. device       — the card's name, count and power limit; TF32 is switched
   off for matmuls and cuDNN so f32 comparisons mean f32.
2. build        — compile the CUDA kernels from ``tpu_nexus_torch/csrc``
   (one ``nvcc`` per source, all started together); the bf16 flash
   kernels' (forward, dQ, dK/dV) and kernel #4's bf16 and int8-KV
   instantiations' (at D 64 and 128), the bf16 grouped-matmul kernels'
   (#7 with either rhs layout, #8), #5's int8 and #6's int4 ring kernels'
   (and the first design they keep for other shapes) and #9's registers, local memory
   (spills and stack), shared memory and the count of ``HGMMA`` (wgmma),
   ``HMMA`` (mma.sync), ``UTMALDG`` (TMA load), ``LDGSTS`` (cp.async),
   ``I2F``/``I2FP`` (int -> float) and 128-bit global load and store
   instructions in their SASS, read by the toolkit's ``cuobjdump``; fails
   without it, where a flash or grouped-matmul kernel lacks wgmma or TMA
   or has mma.sync, where #4 or a ring kernel of #5 or #6 lacks an
   asynchronous ring or tensor-core dots, where #5's ring kernel converts
   weights with I2F, where #9 lacks 128-bit loads or stores, or where any of
   them (every instantiation of #4 and #9) spills.
3. parity       — the forward and decode kernels against their plain
   PyTorch versions at the training and serving paths' shapes, bf16 and
   f32 (the forward also at S 1, 127, 129 and 383, GQA groups 1, 4 and 8,
   D 64, causal and full; each forward case run twice, bit-identical);
   the int8 and int4 dequant-matmul kernels at the Llama-3-8B decode
   step's (K, N) with M = 8, at M = 1, 40 and 256 and at unaligned shapes,
   int4 at groups 64 and 128 (and 2 and K), each run twice bit-identical,
   each case naming the kernel its launch counter saw (int8 bf16: the ring
   kernel, or the first design for N 200 and 71; int4 bf16: the ring
   kernel, or the pitch branch for N 200 and 71 and group 2; each of the
   four must be reached);
   the decode kernel's int8-KV mode at the serve shape, kv_len 4096, q_len
   4 and ragged.  Every decode case runs twice, bit-identical; they cover
   q_len 8 x GQA 8 (64 query rows), GQA 1 and 8, D 64, and one row's 8 kv
   heads over 4096 slots (a launch that merges >= 8 splits).
4. train_parity — the backward kernels (dQ, dK/dV) against the plain
   backward: nexus_1b's B8 S2048 Hq16 Hkv8 D128, Llama-3-8B heads at S512,
   S200 (unaligned), D64 and non-causal, and S 64, 65, 127, 129 and 200 at
   GQA groups 1, 2 and 4, D 64 and 128, causal and not; bf16 and f32; each
   backward run twice is bit-identical.
5. moe_parity   — the grouped-matmul kernels (#7 gmm, also on rhsᵀ as the
   backward's d_lhs call; #8 tgmm) against their plain versions at the
   nexus_moe train step's shapes (m_pad 36864, bm 512, uneven expert runs,
   one expert holding only its padding tile), a bm-128 layout and
   Mixtral-8x7B's gate (K 4096, N 14336), bf16 and f32, each run twice
   bit-identical; tgmm writes zeros for an expert with no tile.  Edge
   cases, all three calls in bf16 and f32, each twice bit-identical: K and
   N not multiples of 64 (K 200 N 72; K 1000 N 1336), K of one slab (64)
   and under one (8), M of one tile (fewer work units than SMs), an
   unsorted tile_expert, expert ids outside [0, E) (gmm writes zeros),
   and 300 experts (tgmm past its ranked table).
6. times        — per-launch time (CUDA events) at the main paths' shapes
   (the kernels line reports the flash forward and backward at nexus_1b's
   training shape, decode at the serve step's), the bound, the plain
   version's time and the ``library_ms`` yardstick
   (``scaled_dot_product_attention`` and its backward, timed here only;
   the port never calls them).  The backward is also timed whole
   (``flash_attention_bwd``: dsum, q̃ and both kernels) and at nexus_moe's
   attention shape (Hq8 Hkv4).  For the dequant-matmul kernels the shape is
   the step's largest launch (K4096 x N14336, M8; both also at w_down,
   wq/wo and wk/wv) and the yardstick is ``torch.matmul`` with the
   pre-dequantized bf16 weight; for int8-KV
   decode, ``scaled_dot_product_attention`` on a dequantized cache.  For
   the grouped matmul, the nexus_moe train step's four products and
   Mixtral's gate; the yardstick is ``torch._grouped_mm`` with group
   offsets where this PyTorch takes the layout, else a loop of
   ``torch.matmul`` over the expert runs.
7. e2e          — Llama-3-8B widths at 2 layers in f32: greedy ``generate``
   with the kernels is token-identical to ``generate`` with the plain
   versions — with plain weights, with int8 weights + an int8 KV cache,
   and with int4 weights.
8. train_e2e    — nexus_1b widths at 2 layers in f32: 3 training steps
   through the kernels agree with 3 steps through dense attention.
9. moe_train_e2e — nexus_moe widths at 2 layers in f32, dispatch gmm: 3
   training steps through the kernels agree with 3 steps through the
   plain versions (dense attention, plain grouped matmul); nothing dropped;
   the derived launches.
10. serve        — ``run_serving`` on ``llama3_8b`` at full width and depth
   with bf16 params (batch 8, prompt 128, 32 new tokens, 3 rounds) into an
   in-memory ledger; the launch counters, zeroed just before, show the
   path went through the forward and decode kernels.
11. serve_quant  — ``run_serving`` on ``llama3_8b`` at full width and depth
   (bf16 params, batch 8, prompt 128, 32 new tokens, 3 rounds), once with
   ``quantize="int8", quantize_kv="int8"`` and once with
   ``quantize="int4"``: COMPLETED, exactly 7 x layers x decode-steps
   dequant-matmul launches each, all of the int8 or int4 ring kernel,
   decoded tokens/s, weight bytes, peak memory.
12. serve_moe   — ``run_serving`` on ``nexus_moe`` at full width and depth
   (batch 8, prompt 128, 32 new tokens, 3 rounds): COMPLETED with exact
   flash and decode launches; greedy ``generate`` at 2 layers in f32 is
   token-identical between kernels and plain.
13. train       — ``run_workload`` on ``nexus_1b`` at full width and depth
   (bf16, adamw, remat attn_out, batch 8, seq 2048, 20 steps) into an
   in-memory ledger: COMPLETED, tokens/s, MFU against the 989 TFLOP/s bf16
   peak, peak memory, and 14 launches per step of each of the flash
   forward, dQ and dK/dV kernels.
14. train_moe   — ``run_workload`` on ``nexus_moe`` at full width and depth
   (bf16, dispatch gmm, adamw, remat attn_out, batch 8, seq 2048, 20
   steps): COMPLETED, exactly 72 gmm, 24 tgmm and 8 of each flash kernel
   per step, ``dropped_frac`` 0, tokens/s, MFU, peak memory.
15. engine_parity — kernel #4's paged (block-table) and ``q_starts`` modes
   against ``decode_attention_plain`` at Llama-3-8B heads: pages 4, 16, 32
   and 64, shuffled tables with a scratch block, staggered per-row lengths,
   q_len 1-5, every combination of paged x ragged x int8-KV in bf16 and
   f32, each run twice bit-identical, and f32 at 4096 slots and q_len 5
   against the plain version evaluated in f64; kernel #9 (RMSNorm) at [1024, 4096]
   and [16384, 2048], H 8192, H 100 and 2056, one row and 100 rows, an f32
   and a bf16 weight, bf16 and f32 x, each run twice bit-identical.
   (``times`` adds paged decode and ragged verify at q_len 5, each at
   kv_len 144 and 4096, and RMSNorm at [16384, 2048] and [1024, 4096].)
16. engine_e2e  — Llama-3-8B widths at 2 layers in f32, greedy:
   ``ServingEngine`` is token-identical to one-shot ``generate`` through
   the kernels and through the plain path — contiguous, paged (page 16),
   paged + int8-KV, speculative (spec_k 4, ngram) and decode_steps 4.
17. serve_engine — ``run_serve_engine`` on ``llama3_8b`` at full width and
   depth, bf16 (8 slots, prompt 128, 32 new tokens, 3 rounds): (a)
   contiguous, (b) page 32 with a shared 120-token prefix (prefix hits,
   extend through the paged kernel), (c) page 32 with spec_k 4 (ngram):
   COMPLETED, tokens/s, TTFT/TPOT p50/p99, prefix hits and kernel #4's
   launches by mode (paged > 0 in (b) and (c), ragged > 0 in (c)).

Opt-in: ``profile`` — one warm ``generate`` round of the serve shape under
``torch.profiler``: device time by kernel group and the device's busy
share (``python3 chip_smoke.py --phases build,profile``); ``train_profile``
— the same for two warm steps of the train phase's shape
(``--phases build,train_profile``); ``profile_int8`` and ``profile_int4`` —
``profile`` with the serve_quant phase's two configurations (no finalize
kernel may be among their top kernels);
``train_moe_profile`` — ``train_profile`` for train_moe's shape;
``decode_probe`` — kernel #4 (bf16, contiguous) across q_len x GQA at kv_len
144 and 4096, then built again from copies of its source with one and two
producer warps in place of four, timed at the serve step's and kv 4096's
shapes in every mode (``--phases build,decode_probe``); ``quant_rms_times``
— only the dequant-matmul and RMSNorm rows of ``times``, to compare two
trees of the package in one call (``--phases device,quant_rms_times``);
``int4_probe`` and ``int8_probe`` — what sets the pace of #6's and #5's ring
kernels: edited rebuilds (stage geometries, ring-only streams) timed beside
the shipped build (``--phases build,int8_probe``).

Then a ``{"kernels": [...]}`` line, the card's ``nvidia-smi`` name and
power limit, and last ``{"ok": true, "device": {...}}``.  Without a CUDA
device, or without the repository's ``tpu_nexus_torch`` beside it, it
exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import logging
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PHASES = ("device", "build", "parity", "train_parity", "moe_parity", "engine_parity", "times", "e2e", "train_e2e",
          "moe_train_e2e", "engine_e2e", "serve", "serve_quant", "serve_moe", "serve_engine", "train", "train_moe")
#: phases run only when named in --phases
OPT_IN = ("profile", "profile_int8", "profile_int4", "train_profile", "train_moe_profile", "decode_probe",
          "quant_rms_times", "int4_probe", "int8_probe")
# H100 SXM peaks (NVIDIA data sheet): dense bf16 tensor-core rate, f32 CUDA
# core rate, HBM3 bandwidth
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
TOL = {  # dtype -> (out, lse) max-abs tolerance
    "bfloat16": (2e-2, 1e-3),
    "float32": (1e-5, 1e-5),
}
#: bf16 limit on the worst query row's relative L2 error, |out-ref|/|ref|
#: over head_dim.  At long KV the outputs are averages over thousands of
#: rows and shrink to ~0.02, where the max-abs limit is a typical value;
#: dropping or mis-rescaling one 64-row KV tile moves a row by ~10%.
ROW_REL_TOL = 1e-2


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}, default=str), flush=True)


def nvidia_smi() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {proc.stderr}")
    return proc.stdout.strip().splitlines()[0]


def spin_cycles_per_ms() -> float:
    """Cycles of ``torch.cuda._sleep`` per millisecond on this card, measured
    once with CUDA events (the spin counts clock cycles, and the clock is
    the card's own)."""
    import torch

    if spin_cycles_per_ms.value is None:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1_000_000)
        torch.cuda.synchronize()
        start.record()
        torch.cuda._sleep(20_000_000)
        end.record()
        torch.cuda.synchronize()
        spin_cycles_per_ms.value = 20_000_000 / start.elapsed_time(end)
    return spin_cycles_per_ms.value


spin_cycles_per_ms.value = None


def timed(fns, iters: int = 40, warmup: int = 4):
    """``(ms, enqueue_ms)`` per call over ``iters`` calls, cycling through
    ``fns`` (one closure per input copy, so a working set larger than L2
    stays cold the way a per-layer caller finds it).  ``ms`` is time on the
    card: a spin kernel holds the stream while the host enqueues all the
    timed calls, so a wrapper whose host side takes longer than its kernel
    (allocations, the ctypes call) is not timed by its host side.
    ``enqueue_ms`` is that host side, per call.  The reading is kept only if
    the spin was still running when the last call had been enqueued;
    otherwise the spin is lengthened and the run repeated, and a reading
    that cannot be taken that way raises."""
    import torch

    for i in range(warmup):
        fns[i % len(fns)]()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fns[0]()
    spin_ms = 2.0 * (time.perf_counter() - t0) * 1e3 * iters + 1.0
    for _ in range(4):
        torch.cuda.synchronize()
        gate, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        torch.cuda._sleep(int(spin_ms * spin_cycles_per_ms()))
        gate.record()
        start.record()
        t0 = time.perf_counter()
        for i in range(iters):
            fns[i % len(fns)]()
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        held = not gate.query()  # the spin outlasted the enqueueing
        end.record()
        torch.cuda.synchronize()
        if held:
            return start.elapsed_time(end) / iters, enqueue_ms / iters
        spin_ms = 2.0 * enqueue_ms + 1.0
    raise RuntimeError(
        f"enqueueing {iters} calls ({enqueue_ms:.1f} ms) outlasted the spin four times: "
        "the reading would be the host's time, not the card's"
    )


def cuda_ms(fns, iters: int = 40, warmup: int = 4) -> float:
    """Mean ms on the card per call (see :func:`timed`)."""
    return timed(fns, iters, warmup)[0]


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def row_rel_err(out, ref, floor_frac: float = 0.0) -> float:
    """Worst relative L2 error over the last (head_dim) axis.  With
    ``floor_frac`` each row's norm is floored at that fraction of the
    largest row norm: a gradient row that cancels to ~0 in exact arithmetic
    (dQ of the first causal query, where dP equals dsum) has no scale of
    its own, and the max-abs limit judges it."""
    diff = (out.float() - ref.float()).norm(dim=-1)
    norms = ref.float().norm(dim=-1)
    floor = max(floor_frac * float(norms.max()), 1e-30)
    return float((diff / norms.clamp_min(floor)).max())


# -- kernels: inputs, parity and bounds ---------------------------------------


def flash_inputs(b, s, hq, hkv, d, dtype, seed):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((b, s, hq, d), generator=g, device="cuda").to(dtype)
    k = torch.randn((b, s, hkv, d), generator=g, device="cuda").to(dtype)
    v = torch.randn((b, s, hkv, d), generator=g, device="cuda").to(dtype)
    return q, k, v


def decode_inputs(b, sq, max_len, hq, hkv, d, dtype, seed):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((b, sq, hq, d), generator=g, device="cuda").to(dtype)
    k = torch.randn((b, max_len, hkv, d), generator=g, device="cuda").to(dtype)
    v = torch.randn((b, max_len, hkv, d), generator=g, device="cuda").to(dtype)
    return q, k, v


def flash_bound(b, s, hq, hkv, d, dtype, causal=True):
    import torch

    itemsize = torch.empty((), dtype=dtype).element_size()
    flops = 4 * b * hq * s * s * d / (2 if causal else 1)
    nbytes = (2 * b * s * hq * d + 2 * b * s * hkv * d) * itemsize + b * hq * s * 4
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def decode_bound(b, sq, kv_len, hq, hkv, d, dtype):
    import torch

    itemsize = torch.empty((), dtype=dtype).element_size()
    nbytes = (b * kv_len * hkv * d * 2 + 2 * b * sq * hq * d) * itemsize
    flops = 4 * b * hq * sq * kv_len * d
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def decode_splits(b, sq, hq, hkv, d, kv_len, dtype, int8=False) -> int:
    """The split count kernel #4's wrapper plans for a contiguous launch of
    these shapes (bf16: by the CTAs the card holds)."""
    import torch

    from tpu_nexus_torch.ops.decode_attention import f32_split_plan, resident_ctas, split_plan

    if dtype == torch.bfloat16:
        device = torch.device("cuda", torch.cuda.current_device())
        return split_plan(b, hkv, kv_len, resident_ctas(device, d, sq * (hq // hkv), int8))[1]
    return f32_split_plan(b, hkv, kv_len)[1]


def zero_rms_norm_launches() -> None:
    """Kernel #9 (RMSNorm) is on no main path, as in the JAX package: every
    main-path run sets its count to 0 just before and reads it just after
    (:func:`read_rms_norm_launches`), so the kernels line's 0 is measured."""
    from tpu_nexus_torch.ops.rmsnorm import rms_norm_kernel

    rms_norm_kernel.launches = 0


def read_rms_norm_launches(results, path: str) -> None:
    from tpu_nexus_torch.ops.rmsnorm import rms_norm_kernel

    results.setdefault("rms_norm_launches", {})[path] = rms_norm_kernel.launches


#: the Hopper kernels the build phase reads from the library's SASS: report
#: key -> (mangled-name prefix with {v} for the instantiation, the dynamic
#: shared memory of a launch of instantiation v, the instructions its path
#: needs, the instantiations read: row label -> v).  "tma+wgmma": wgmma
#: (HGMMA) fed by TMA loads (UTMALDG) and no mma.sync (HMMA);
#: "ring+tensor": an asynchronous ring (UTMALDG or LDGSTS) and tensor-core
#: dots (HGMMA or HMMA); "vector": 128-bit global loads and stores
#: (LDG.E.128, STG.E.128); "report": read, nothing required.  The attention
#: kernels are read at head dims 64 and 128, #4 at the serve step's shape,
#: q_len 1 x GQA 4 (N 8); #7 with rhs [E,K,N] (read MN-major) and [E,N,K]
#: (d_lhs, K-major), #8 once; #5's and #6's ring kernels (bf16 activations)
#: and the first design they keep for other shapes; #9 at the widths of its
#: timed rows (bf16 and f32 x, 16-byte accesses).  ``sass_i2f`` counts the
#: int -> float conversions (I2F, I2FP).
HEAD_DIMS = {"d64": 64, "d128": 128}
HOPPER_KERNELS = {
    "flash_forward_bf16": ("flash_fwd_bf16_kernelILi{v}E", lambda lib, d: lib.nexus_flash_fwd_smem_bytes(d),
                           "tma+wgmma", HEAD_DIMS),
    "flash_bwd_dq_bf16": ("flash_bwd_dq_bf16_kernelILi{v}E", lambda lib, d: lib.nexus_flash_bwd_smem_bytes(0, d),
                          "tma+wgmma", HEAD_DIMS),
    "flash_bwd_dkv_bf16": ("flash_bwd_dkv_bf16_kernelILi{v}E", lambda lib, d: lib.nexus_flash_bwd_smem_bytes(1, d),
                           "tma+wgmma", HEAD_DIMS),
    "decode_bf16": ("decode_hopper_kernelILi{v}ELb0ELi8E", lambda lib, d: lib.nexus_decode_smem_bytes(d, 4, 0),
                    "ring+tensor", HEAD_DIMS),
    "decode_int8kv": ("decode_hopper_kernelILi{v}ELb1ELi8E", lambda lib, d: lib.nexus_decode_smem_bytes(d, 4, 1),
                      "ring+tensor", HEAD_DIMS),
    "gmm_bf16": ("gmm_bf16_kernelILb{v}E", lambda lib, _: lib.nexus_gmm_smem_bytes(0), "tma+wgmma",
                 {"rhs_ekn": 0, "rhs_enk_transposed": 1}),
    "tgmm_bf16": ("tgmm_bf16_kernel{v}", lambda lib, _: lib.nexus_gmm_smem_bytes(1), "tma+wgmma", {"all": ""}),
    "quant_int4_ring": ("quant_int4_ring_kernel{v}", lambda lib, _: lib.nexus_quant_int4_smem_bytes(), "ring+tensor",
                        {"bf16": ""}),
    "quant_int4_pitch_branch": ("quant_matmul_mma_kernelILb{v}E", lambda lib, _: 0, "report", {"bf16": 1}),
    "quant_int8_ring": ("quant_int8_ring_kernel{v}", lambda lib, _: lib.nexus_quant_int8_smem_bytes(),
                        "ring+tensor", {"bf16": ""}),
    "quant_int8_first_design": ("quant_matmul_mma_kernelILb{v}E", lambda lib, _: 0, "report", {"bf16": 0}),
    "rms_norm": ("rms_kernelI{v}", lambda lib, _: 0, "vector",
                 {"bf16_h2048": "13__nv_bfloat16Li2ELb1E", "bf16_h4096": "13__nv_bfloat16Li4ELb1E",
                  "f32_h2048": "fLi2ELb1E", "f32_h8192": "fLi8ELb1E"}),
}
#: kernels whose every instantiation must be free of local memory and stack: name -> how many
ALL_INSTANTIATIONS = {"decode_hopper_kernel": 16, "rms_kernel": 16, "quant_int4_ring_kernel": 1,
                      "quant_int8_ring_kernel": 1}
#: the most int -> float conversions the int8 ring kernel may hold: those of its run bounds' 32-bit
#: divisions (a conversion on the weights would be one a widened value, hundreds in the SASS)
INT8_RING_MAX_I2F = 16


def hopper_kernel_resources(_build):
    """The kernels of :data:`HOPPER_KERNELS` (the bf16 flash kernels, #4's
    bf16 and int8-KV instantiations, the bf16 grouped matmul kernels, #6's
    int4 ring kernel and the first design it keeps, #9) read from the built
    library by the toolkit's ``cuobjdump -res-usage -sass``: registers a
    thread at entry, stack and local memory (spills) a thread, static shared
    memory, and the SASS counts that show the path — wgmma (``HGMMA``),
    ``mma.sync`` (``HMMA``), TMA loads (``UTMALDG``), cp.async (``LDGSTS``),
    int -> float conversions (``I2F``/``I2FP``), 128-bit global loads and
    stores; and the dynamic shared memory a launch asks for, from the
    library's own layouts.  Fails without cuobjdump, where a kernel lacks
    what its path needs, where any of them but a "report" row has local
    memory or stack, or where any instantiation of a kernel in
    :data:`ALL_INSTANTIATIONS` has."""
    import re

    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    if not cuobjdump.exists():
        raise RuntimeError(f"no cuobjdump beside nvcc ({cuobjdump}): the build phase reads the kernels' SASS")
    dump = subprocess.run([str(cuobjdump), "-res-usage", "-sass", str(_build.library_path())],
                          capture_output=True, text=True, timeout=300, check=True).stdout
    lib = _build.library()
    report = {}
    for key, (pattern, dynamic_smem, needs, variants) in HOPPER_KERNELS.items():
        for label, v in variants.items():
            name = pattern.format(v=v)
            usage = re.search(rf"Function \S*{name}\S*:\s*\n(.*)", dump)
            fields = dict(re.findall(r"(\w+):(\d+)", usage.group(1))) if usage else {}
            sass = next((f for f in dump.split("Function : ")[1:] if re.match(rf"\S*{name}", f)), "")
            row = dict(
                registers=int(fields.get("REG", 0)), stack_bytes=int(fields.get("STACK", 0)),
                local_bytes=int(fields.get("LOCAL", 0)), static_smem=int(fields.get("SHARED", 0)),
                dynamic_smem=dynamic_smem(lib, v),
                sass_hgmma=len(re.findall(r"\bHGMMA\.", sass)),
                sass_hmma=len(re.findall(r"\bHMMA\.", sass)),
                sass_utmaldg=len(re.findall(r"\bUTMALDG\b", sass)),
                sass_ldgsts=len(re.findall(r"\bLDGSTS\b", sass)),
                sass_i2f=len(re.findall(r"\bI2FP?(?:\.|\s)", sass)),
                sass_ldg128=len(re.findall(r"\bLDG\.E(?:\.\w+)*\.128\b", sass)),
                sass_stg128=len(re.findall(r"\bSTG\.E(?:\.\w+)*\.128\b", sass)),
            )
            report.setdefault(key, {})[label] = row
            if needs == "tma+wgmma":
                path_ok = row["sass_hgmma"] and row["sass_utmaldg"] and not row["sass_hmma"]
            elif needs == "ring+tensor":
                path_ok = (row["sass_utmaldg"] or row["sass_ldgsts"]) and (row["sass_hgmma"] or row["sass_hmma"])
            elif needs == "vector":
                path_ok = row["sass_ldg128"] and row["sass_stg128"]
            else:
                path_ok = True
            spills = needs != "report" and (row["local_bytes"] or row["stack_bytes"])  # "report": as it is
            if not (fields and path_ok) or spills:
                raise AssertionError(f"{name}: no resource usage, its path ({needs}) missing, or local memory or "
                                     f"stack in cuobjdump's output: {row}\n{dump[:4000]}")
    # every instantiation of #4's Hopper kernel (D x int8-KV x N 8/16/32/64), of #9 (x dtype x warps a
    # row x aligned) and #6's ring kernel: none spills
    for kernel, count in ALL_INSTANTIATIONS.items():
        spills = {f: dict(re.findall(r"(\w+):(\d+)", u)) for f, u in
                  re.findall(rf"Function (\S*{kernel}\S*):\s*\n(.*)", dump)}
        worst = {f: (int(u.get("REG", 0)), int(u.get("LOCAL", 0)), int(u.get("STACK", 0))) for f, u in spills.items()}
        if len(worst) != count or any(local or stack for _, local, stack in worst.values()):
            raise AssertionError(f"{kernel}: {len(worst)} instantiations (want {count}), or one spills: {worst}")
        report[f"{kernel}_all_instantiations"] = dict(
            count=len(worst), max_registers=max(r for r, _, _ in worst.values()), local_or_stack_bytes=0)
    i2f = report["quant_int8_ring"]["bf16"]["sass_i2f"]
    if i2f > INT8_RING_MAX_I2F:
        raise AssertionError(f"quant_int8_ring_kernel: {i2f} I2F, more than its run bounds need "
                             f"({INT8_RING_MAX_I2F}): a conversion on the weights?")
    return report


def phase_parity(results):
    import torch

    from tpu_nexus_torch.ops.decode_attention import decode_attention, decode_attention_plain
    from tpu_nexus_torch.ops.flash_attention import flash_attention, flash_attention_plain

    worst = {"flash_attention": 0.0, "decode_attention": 0.0}
    flash_cases = [  # (B, S, Hq, Hkv, D, dtype, causal)
        (8, 2048, 16, 8, 128, torch.bfloat16, True),  # the train phase's shape (GQA group 2)
        (8, 2048, 16, 8, 128, torch.float32, True),
        (8, 128, 32, 8, 128, torch.bfloat16, True),  # the serve phase's prefill
        (1, 2048, 32, 8, 128, torch.bfloat16, True),
        (1, 200, 32, 8, 128, torch.bfloat16, True),
        (2, 256, 32, 8, 64, torch.bfloat16, True),
        (2, 128, 32, 8, 128, torch.bfloat16, False),
        (8, 128, 32, 8, 128, torch.float32, True),
        (1, 2048, 32, 8, 128, torch.float32, True),
        (1, 200, 32, 8, 128, torch.float32, True),
        (2, 256, 32, 8, 64, torch.float32, False),
        # the 128-row tiles' edges: one row, a tile short of full, a tile
        # and one row, three tiles with a ragged end; GQA groups 1, 4, 8; D 64
        (2, 1, 32, 8, 128, torch.bfloat16, True),
        (2, 127, 32, 8, 128, torch.bfloat16, True),
        (2, 129, 32, 8, 128, torch.bfloat16, True),
        (2, 383, 32, 8, 128, torch.bfloat16, True),
        (2, 383, 32, 8, 128, torch.bfloat16, False),
        (2, 383, 32, 8, 64, torch.bfloat16, True),
        (2, 129, 32, 8, 64, torch.bfloat16, True),
        (1, 383, 8, 8, 128, torch.bfloat16, True),
        (1, 383, 64, 8, 128, torch.bfloat16, False),
        (2, 1, 32, 8, 64, torch.bfloat16, False),
        (2, 1, 32, 8, 128, torch.float32, True),
        (2, 383, 32, 8, 64, torch.float32, True),
    ]
    for i, (b, s, hq, hkv, d, dtype, causal) in enumerate(flash_cases):
        q, k, v = flash_inputs(b, s, hq, hkv, d, dtype, seed=10 + i)
        out, lse = flash_attention(q, k, v, causal=causal)
        out2, lse2 = flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        same = bool(torch.equal(out, out2) and torch.equal(lse, lse2))
        ref_out, ref_lse = flash_attention_plain(q, k, v, causal=causal)
        e_out, e_lse = max_err(out, ref_out), max_err(lse, ref_lse)
        e_row = row_rel_err(out, ref_out)
        tol_out, tol_lse = TOL[str(dtype).split(".")[-1]]
        tol_row = ROW_REL_TOL if dtype == torch.bfloat16 else None
        ok = (same and e_out <= tol_out and e_lse <= tol_lse and (tol_row is None or e_row <= tol_row)
              and bool(torch.isfinite(out).all()))
        emit("parity", kernel="flash_attention", shape=[b, s, hq, hkv, d], dtype=str(dtype),
             causal=causal, max_abs_err_out=e_out, max_abs_err_lse=e_lse, max_row_rel_err=e_row,
             tol_out=tol_out, tol_lse=tol_lse, tol_row_rel=tol_row, bit_identical_twice=same, ok=ok)
        if not ok:
            raise AssertionError(f"flash_attention kernel disagrees with its plain version: {flash_cases[i]}")
        if dtype == torch.bfloat16 and (b, s, hq) == (8, 2048, 16):
            worst["flash_attention"] = e_out
        del q, k, v, out, lse, out2, lse2, ref_out, ref_lse
        torch.cuda.empty_cache()

    # (B, q_len, max_len, kv_len, ragged, dtype, Hq, Hkv, D): Llama-3-8B heads (32, 8, 128) unless named
    decode_cases = []
    for max_len, kv_lens in ((160, (4, 100, 160)), (4096, (129, 2000, 4096))):
        for sq in (1, 4):
            for kv_len in kv_lens:
                decode_cases.append((8, sq, max_len, kv_len, False, torch.bfloat16, 32, 8, 128))
        decode_cases.append((8, 1, max_len, max_len // 2 + 7, True, torch.bfloat16, 32, 8, 128))
        decode_cases.append((8, 4, max_len, max_len - 3, True, torch.float32, 32, 8, 128))
        decode_cases.append((8, 1, max_len, max_len, False, torch.float32, 32, 8, 128))
    decode_cases += [
        # q_len 8 x GQA 8: 64 query rows (wgmma N 64)
        (8, 8, 4096, 4096, False, torch.bfloat16, 64, 8, 128), (8, 8, 160, 150, True, torch.bfloat16, 64, 8, 128),
        (2, 8, 4096, 4096, False, torch.float32, 64, 8, 128),
        # GQA 1 and 8
        (8, 1, 4096, 4000, True, torch.bfloat16, 8, 8, 128), (8, 5, 4096, 4096, False, torch.bfloat16, 8, 8, 128),
        (8, 1, 4096, 4096, False, torch.bfloat16, 64, 8, 128), (8, 2, 160, 144, False, torch.bfloat16, 64, 8, 128),
        # one row's 8 kv heads over 4096 slots: the launch merges >= 8 splits
        (1, 1, 4096, 4096, False, torch.bfloat16, 32, 8, 128), (1, 4, 4096, 3001, True, torch.bfloat16, 32, 8, 128),
        # head_dim 64 (nexus_moe's attention is 128; D 64 is the kernel's other width)
        (8, 1, 4096, 4096, False, torch.bfloat16, 32, 8, 64), (8, 3, 160, 144, False, torch.bfloat16, 16, 8, 64),
    ]
    for i, (b, sq, max_len, kv_len, ragged, dtype, hq, hkv, d) in enumerate(decode_cases):
        q, k, v = decode_inputs(b, sq, max_len, hq, hkv, d, dtype, seed=100 + i)
        lens = width = None
        if ragged:
            width = max_len // 2
            g = torch.Generator(device="cuda").manual_seed(500 + i)
            lens = torch.randint(1, width + 1, (b,), generator=g, device="cuda", dtype=torch.int32)
        before = decode_attention.launches
        out = decode_attention(q, k, v, kv_len, lens, width)
        again = decode_attention(q, k, v, kv_len, lens, width)
        torch.cuda.synchronize()
        same = bool(torch.equal(out, again)) and decode_attention.launches == before + 2
        ref = decode_attention_plain(q, k, v, kv_len, lens, width)
        err, e_row = max_err(out, ref), row_rel_err(out, ref)
        tol = TOL[str(dtype).split(".")[-1]][0]
        tol_row = ROW_REL_TOL if dtype == torch.bfloat16 else None
        n_splits = decode_splits(b, sq, hq, hkv, d, kv_len, dtype)
        merged = n_splits >= 8 if (b, max_len, sq) == (1, 4096, 1) else True
        ok = (same and merged and err <= tol and (tol_row is None or e_row <= tol_row)
              and bool(torch.isfinite(out).all()))
        emit("parity", kernel="decode_attention", b=b, q_len=sq, max_len=max_len, kv_len=kv_len, heads=[hq, hkv, d],
             ragged=ragged, dtype=str(dtype), n_splits=n_splits, max_abs_err=err, max_row_rel_err=e_row, tol=tol,
             tol_row_rel=tol_row, bit_identical_twice=same, ok=ok)
        if not ok:
            raise AssertionError(f"decode_attention kernel disagrees with its plain version: {decode_cases[i]}")
        if dtype == torch.bfloat16 and max_len == 160 and sq == 1 and hq == 32:
            worst["decode_attention"] = max(worst["decode_attention"], err)
        del q, k, v, out, again, ref
    results.setdefault("max_abs_err", {}).update(worst)
    quant_matmul_parity(results)
    decode_int8kv_parity(results)


#: limits of the dequant-matmul and int8-KV cases: f32 max-abs relative to
#: the reference's largest magnitude (the sums differ in order only), bf16
#: the worst row's relative L2 (one rounding of the output apart)
QUANT_F32_MAXABS_REL = 1e-4
#: the llama3_8b decode step's distinct weight shapes (K, N): wq/wo, wk/wv,
#: w_gate/w_up, w_down
LLAMA8B_KN = ((4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096))


def quant_weight(k, n, mode, group, seed):
    """A random [K, N] weight quantized on the card: QTensor or QTensor4."""
    import torch

    from tpu_nexus_torch.models.quant import quantize_tensor, quantize_tensor_int4

    g = torch.Generator(device="cuda").manual_seed(seed)
    w = torch.randn((k, n), generator=g, device="cuda") * k**-0.5
    return quantize_tensor(w, (-2,)) if mode == "int8" else quantize_tensor_int4(w, (-2,), group, name="w")


def quant_bound(m, k, n, w, dtype):
    """Least time: the packed weight, its scales, x and y moved once at the
    HBM rate, or 2MKN operations at the peak of x's type."""
    import torch

    itemsize = torch.empty((), dtype=dtype).element_size()
    nbytes = w.q.numel() + w.s.numel() * 4 + (m * k + m * n) * itemsize
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS
    t_ops, t_bytes = 2 * m * k * n / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def quant_matmul_parity(results):
    """Kernels #5 (int8) and #6 (int4) against ``quant_matmul_plain``."""
    import torch

    from tpu_nexus_torch.ops.quant_matmul import (
        int4_ring_route, int8_ring_route, quant_matmul, quant_matmul_plain,
    )

    cases = [(8, k, n, (64, 128)) for k, n in LLAMA8B_KN]  # (M, K, N, int4 groups)
    cases += [(1, 4096, 4096, (64,)), (256, 4096, 4096, (64,)), (40, 4096, 14336, (64,)), (256, 4096, 14336, (64,)),
              (8, 4096, 1024, (4096, 2)), (5, 448, 200, (64, 2)), (3, 640, 71, (128, 640))]
    worst = {"quant_matmul_int8": 0.0, "quant_matmul_int4": 0.0}
    routes = {}
    seed = 2000
    for m, k, n, groups in cases:
        for mode, group in [("int8", 0)] + [("int4", g) for g in groups]:
            w = quant_weight(k, n, mode, group, seed)
            for dtype in (torch.bfloat16, torch.float32):
                seed += 1
                x = torch.randn((m, k), generator=torch.Generator(device="cuda").manual_seed(seed),
                                device="cuda").to(dtype)
                before = dict(quant_matmul.launches_by_route)
                out, again = quant_matmul(x, w), quant_matmul(x, w)
                torch.cuda.synchronize()
                launched = {r: c - before[r] for r, c in quant_matmul.launches_by_route.items()
                            if c != before[r]}
                ref = quant_matmul_plain(x, w)
                same = bool(torch.equal(out, again))
                err, ref_max, e_row = max_err(out, ref), float(ref.float().abs().max()), row_rel_err(out, ref)
                ok = same and bool(torch.isfinite(out).all()) and (
                    e_row <= ROW_REL_TOL if dtype == torch.bfloat16 else err <= QUANT_F32_MAXABS_REL * ref_max)
                # the kernel that ran: int4 bf16 takes the ring kernel or the pitch branch, int8 the ring
                # kernel or the first design (as f32 does)
                if mode == "int4" and dtype == torch.bfloat16:
                    route = "ring" if int4_ring_route(x, w.q, w.s, n, group) else "pitch_branch"
                elif mode == "int8":
                    route = "ring" if int8_ring_route(x, w.q, w.s, n) else "first_design"
                else:
                    route = "first_design"
                ok = ok and launched == {f"{mode}_{'ring' if route == 'ring' else 'first_design'}": 2}
                routes.setdefault(f"{mode}_{str(dtype)[6:]}_{route}", []).append([m, k, n, group or None])
                emit("parity", kernel=f"quant_matmul_{mode}", m=m, k=k, n=n, group=group or None,
                     dtype=str(dtype), route=route, launches_by_route=launched, max_abs_err=err,
                     ref_max_abs=ref_max, max_row_rel_err=e_row,
                     bit_identical_twice=same, tol_f32_max_abs_rel=QUANT_F32_MAXABS_REL,
                     tol_bf16_row_rel=ROW_REL_TOL, ok=ok)
                if not ok:
                    raise AssertionError(f"quant_matmul {mode} kernel disagrees with its plain version: "
                                         f"M{m} K{k} N{n} group {group} {dtype}")
                if dtype == torch.bfloat16 and (m, k, n) == (8, 4096, 14336) and group in (0, 64):
                    worst[f"quant_matmul_{mode}"] = err
            del w
    torch.cuda.empty_cache()
    emit("parity", kernel="quant_matmul", routes=routes)
    if not routes.get("int4_bfloat16_ring") or not routes.get("int4_bfloat16_pitch_branch"):
        raise AssertionError(f"the int4 bf16 cases missed the ring kernel or the pitch branch: {routes}")
    if not routes.get("int8_bfloat16_ring") or not routes.get("int8_bfloat16_first_design"):
        raise AssertionError(f"the int8 bf16 cases missed the ring kernel or the first design: {routes}")
    results.setdefault("max_abs_err", {}).update(worst)


def int8_cache(k, v):
    """(k8, v8, k_scale, v_scale): a cache quantized the way decode writes it."""
    from tpu_nexus_torch.models.generate import _quantize_kv

    (k8, ks), (v8, vs) = _quantize_kv(k), _quantize_kv(v)
    return k8, v8, ks, vs


def decode_int8kv_parity(results):
    """Kernel #4's int8-KV mode against ``decode_attention_plain`` with scales."""
    import torch

    from tpu_nexus_torch.ops.decode_attention import decode_attention, decode_attention_plain

    cases = []  # (B, q_len, max_len, kv_len, ragged, dtype, Hq, Hkv, D)
    for dtype in (torch.bfloat16, torch.float32):
        cases += [(8, 1, 160, 144, False, dtype), (8, 1, 4096, 4096, False, dtype), (8, 4, 160, 144, False, dtype),
                  (8, 4, 4096, 3000, False, dtype), (8, 1, 160, 150, True, dtype), (8, 4, 4096, 4000, True, dtype)]
    cases = [c + (32, 8, 128) for c in cases] + [
        (8, 8, 4096, 4096, False, torch.bfloat16, 64, 8, 128),  # 64 query rows
        (8, 1, 4096, 4000, True, torch.bfloat16, 8, 8, 128),  # GQA 1
        (1, 1, 4096, 4096, False, torch.bfloat16, 32, 8, 128),  # a merge of >= 8 splits
        (8, 1, 4096, 4096, False, torch.bfloat16, 32, 8, 64),  # D 64
    ]
    worst = 0.0
    for i, (b, sq, max_len, kv_len, ragged, dtype, hq, hkv, d) in enumerate(cases):
        q, k, v = decode_inputs(b, sq, max_len, hq, hkv, d, dtype, seed=3000 + i)
        k8, v8, ks, vs = int8_cache(k, v)
        lens = width = None
        if ragged:
            width = max_len // 2
            g = torch.Generator(device="cuda").manual_seed(3500 + i)
            lens = torch.randint(1, width + 1, (b,), generator=g, device="cuda", dtype=torch.int32)
        before = decode_attention.launches_by_mode["contiguous+int8"]
        out = decode_attention(q, k8, v8, kv_len, lens, width, ks, vs)
        again = decode_attention(q, k8, v8, kv_len, lens, width, ks, vs)
        torch.cuda.synchronize()
        ref = decode_attention_plain(q, k8, v8, kv_len, lens, width, ks, vs)
        same = bool(torch.equal(out, again)) and decode_attention.launches_by_mode["contiguous+int8"] == before + 2
        err, ref_max, e_row = max_err(out, ref), float(ref.float().abs().max()), row_rel_err(out, ref)
        if dtype == torch.bfloat16:
            ok = err <= TOL["bfloat16"][0] and e_row <= ROW_REL_TOL
        else:
            ok = err <= QUANT_F32_MAXABS_REL * ref_max
        n_splits = decode_splits(b, sq, hq, hkv, d, kv_len, dtype, int8=True)
        merged = n_splits >= 8 if (b, max_len, sq) == (1, 4096, 1) else True
        ok = ok and same and merged and bool(torch.isfinite(out).all())
        emit("parity", kernel="decode_attention_int8kv", b=b, q_len=sq, max_len=max_len, kv_len=kv_len,
             heads=[hq, hkv, d], ragged=ragged, dtype=str(dtype), n_splits=n_splits, max_abs_err=err,
             ref_max_abs=ref_max, max_row_rel_err=e_row,
             bit_identical_twice=same, tol_bf16_max_abs=TOL["bfloat16"][0], tol_bf16_row_rel=ROW_REL_TOL,
             tol_f32_max_abs_rel=QUANT_F32_MAXABS_REL, ok=ok)
        if not ok:
            raise AssertionError(f"int8-KV decode kernel disagrees with its plain version: {cases[i]}")
        if dtype == torch.bfloat16 and (sq, max_len, hq) == (1, 160, 32) and not ragged:
            worst = err
    results.setdefault("max_abs_err", {})["decode_attention_int8kv"] = worst


#: bf16 backward limits: max-abs relative to the reference's largest
#: magnitude (gradients have no fixed scale), and the worst row's relative L2
BWD_BF16_MAXABS_REL = 2e-2
BWD_F32_MAXABS = 1e-5
#: row norms below this fraction of the largest are floored to it in the
#: row-relative check (see row_rel_err)
BWD_ROW_FLOOR = 1e-3


def bwd_inputs(b, s, hq, hkv, d, dtype, causal, seed):
    """q, k, v, dout and the forward kernel's (out, lse) on them."""
    import torch

    from tpu_nexus_torch.ops.flash_attention import flash_attention

    q, k, v = flash_inputs(b, s, hq, hkv, d, dtype, seed)
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    dout = torch.randn((b, s, hq, d), generator=g, device="cuda").to(dtype)
    out, lse = flash_attention(q, k, v, causal=causal)
    return q, k, v, out, lse, dout


def phase_train_parity(results):
    """Kernels #2 (dQ) and #3 (dK/dV) against the plain backward, and the
    backward run twice is bit-identical: the training shapes, and every
    tile edge at GQA groups 1, 2 and 4, D 64 and 128, causal and not."""
    import torch

    from tpu_nexus_torch.ops.flash_attention import flash_attention_bwd, flash_attention_bwd_plain

    worst = {"flash_attention_bwd_dq": 0.0, "flash_attention_bwd_dkv": 0.0}
    cases = []  # (B, S, Hq, Hkv, D, causal, dtype)
    for dtype in (torch.bfloat16, torch.float32):
        cases += [(8, 2048, 16, 8, 128, True, dtype), (2, 512, 32, 8, 128, True, dtype),
                  (2, 200, 16, 8, 128, True, dtype), (2, 256, 16, 8, 64, True, dtype),
                  (2, 384, 16, 8, 128, False, dtype)]
        # the tile edges of the bf16 kernels' 64-row streamed and 128-row
        # resident tiles, GQA groups 1, 2 and 4, D 64 and 128, causal and not
        cases += [(2, s, 2 * group, 2, d, causal, dtype) for s in (64, 65, 127, 129, 200)
                  for group in (1, 2, 4) for d in (64, 128) for causal in (True, False)]
    for i, (b, s, hq, hkv, d, causal, dtype) in enumerate(cases):
        q, k, v, out, lse, dout = bwd_inputs(b, s, hq, hkv, d, dtype, causal, seed=200 + i)
        got = flash_attention_bwd(q, k, v, out, lse, dout, causal=causal)
        again = flash_attention_bwd(q, k, v, out, lse, dout, causal=causal)
        torch.cuda.synchronize()
        deterministic = all(torch.equal(a, b_) for a, b_ in zip(got, again))
        ref = flash_attention_bwd_plain(q, k, v, out, lse, dout, causal=causal)
        row = {}
        ok = deterministic
        for name, a, r in zip(("dq", "dk", "dv"), got, ref):
            e_abs, ref_max = max_err(a, r), float(r.float().abs().max())
            e_row = row_rel_err(a, r, BWD_ROW_FLOOR)
            finite = bool(torch.isfinite(a).all())
            if dtype == torch.bfloat16:
                good = e_abs <= BWD_BF16_MAXABS_REL * ref_max and e_row <= ROW_REL_TOL
            else:
                good = e_abs <= BWD_F32_MAXABS
            ok = ok and good and finite
            row[name] = {"max_abs_err": e_abs, "ref_max_abs": ref_max, "max_row_rel_err": e_row}
        emit("train_parity", shape=[b, s, hq, hkv, d], dtype=str(dtype), causal=causal,
             deterministic=deterministic, tol_bf16_max_abs_rel=BWD_BF16_MAXABS_REL,
             tol_bf16_row_rel=ROW_REL_TOL, row_norm_floor=BWD_ROW_FLOOR, tol_f32_max_abs=BWD_F32_MAXABS, ok=ok, **row)
        if not ok:
            raise AssertionError(f"flash backward kernels disagree with the plain version: {cases[i]}")
        if dtype == torch.bfloat16 and (b, s, hq) == (8, 2048, 16):
            worst["flash_attention_bwd_dq"] = row["dq"]["max_abs_err"]
            worst["flash_attention_bwd_dkv"] = max(row["dk"]["max_abs_err"], row["dv"]["max_abs_err"])
        del q, k, v, out, lse, dout, got, again, ref
        torch.cuda.empty_cache()
    results.setdefault("max_abs_err", {}).update(worst)


def phase_times(results):
    import torch
    import torch.nn.functional as F

    from tpu_nexus_torch.ops.decode_attention import decode_attention, decode_attention_plain
    from tpu_nexus_torch.ops.flash_attention import flash_attention, flash_attention_plain

    times = {}
    dt = torch.bfloat16
    # prefill, bf16 causal: the train phase's shape (the kernels line's row),
    # the serve phase's prefill and a long Llama-3-8B prompt; one input set
    # per layer-sized copy, so inputs come from HBM as a per-layer caller finds them
    for b, s, hq, hkv, d, n_sets, iters, key in ((8, 2048, 16, 8, 128, 2, 20, "flash_attention"),
                                                 (8, 128, 32, 8, 128, 8, 40, None),
                                                 (1, 2048, 32, 8, 128, 1, 20, None)):
        sets = [flash_inputs(b, s, hq, hkv, d, dt, seed=900 + i) for i in range(n_sets)]
        kern = [lambda x=x: flash_attention(*x, causal=True) for x in sets]
        plain = [lambda x=x: flash_attention_plain(*x, causal=True) for x in sets]
        lib_sets = [(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)) for q, k, v in sets]
        lib = [lambda x=x: F.scaled_dot_product_attention(*x, is_causal=True, enable_gqa=True)
               for x in lib_sets]
        bound, by = flash_bound(b, s, hq, hkv, d, dt)
        ms, enqueue_ms = timed(kern, iters=iters)
        row = dict(shape=[b, s, hq, hkv, d], dtype="bfloat16", ms=ms, enqueue_ms=enqueue_ms,
                   plain_ms=cuda_ms(plain, iters=max(iters // 4, 4)), library_ms=cuda_ms(lib, iters=iters),
                   bound_ms=bound, bound_by=by)
        if key:
            times[key] = row
        emit("times", kernel="flash_attention", **row)
        del sets, lib_sets, kern, plain, lib
        torch.cuda.empty_cache()

    # decode: the serve phase's step (B 8, q_len 1, cache 160 = 128 + 32) at
    # its mean live length, cycling 32 per-layer caches so K/V come from HBM
    hq, hkv, d = 32, 8, 128
    for b, max_len, kv_len, n_layers, key in ((8, 160, 144, 32, "decode_attention"), (8, 4096, 4096, 4, None)):
        layers = [decode_inputs(b, 1, max_len, hq, hkv, d, dt, seed=1000 + i) for i in range(n_layers)]
        kern = [lambda x=x: decode_attention(*x, kv_len) for x in layers]
        plain = [lambda x=x: decode_attention_plain(*x, kv_len) for x in layers]
        lib_sets = [
            (q.transpose(1, 2), k[:, :kv_len].transpose(1, 2), v[:, :kv_len].transpose(1, 2))
            for q, k, v in layers
        ]
        lib = [lambda x=x: F.scaled_dot_product_attention(*x, enable_gqa=True) for x in lib_sets]
        bound, by = decode_bound(b, 1, kv_len, hq, hkv, d, dt)
        ms, enqueue_ms = timed(kern, iters=64)
        row = dict(
            shape=[b, 1, max_len, kv_len, hq, hkv, d], dtype="bfloat16", ms=ms, enqueue_ms=enqueue_ms,
            plain_ms=cuda_ms(plain, iters=32), library_ms=cuda_ms(lib, iters=64),
            bound_ms=bound, bound_by=by,
        )
        if key:
            times[key] = row
        emit("times", kernel="decode_attention", **row)
        del layers, lib_sets
    bwd_times(times)
    quant_times(times)
    moe_times(times)
    engine_times(times)
    results["times"] = times


#: the timed dequant-matmul launches: (times key, M, K, N, mode, group).  The
#: first two are the kernels line's rows (the decode step's largest launch,
#: w_gate/w_up); #5 and #6 also at w_down, wq/wo and wk/wv.
QUANT_TIMED = (("quant_matmul_int8", 8, 4096, 14336, "int8", 0), ("quant_matmul_int4", 8, 4096, 14336, "int4", 64),
               ("quant_matmul_int8_down", 8, 14336, 4096, "int8", 0),
               ("quant_matmul_int8_wq", 8, 4096, 4096, "int8", 0),
               ("quant_matmul_int8_wk", 8, 4096, 1024, "int8", 0),
               ("quant_matmul_int4_down", 8, 14336, 4096, "int4", 64),
               ("quant_matmul_int4_wq", 8, 4096, 4096, "int4", 64),
               ("quant_matmul_int4_wk", 8, 4096, 1024, "int4", 64))


def quant_times(times):
    """Kernels #5 (int8) and #6 (int4, group 64) at the Llama-3-8B decode
    step's four launches, M 8, bf16 (:data:`QUANT_TIMED`), cycling enough weight
    copies (at least four, over 128 MB in all) that the packed bytes come
    from HBM as a per-layer caller finds them; and kernel #4's int8-KV mode
    at the two decode shapes.  ``library_ms``: ``torch.matmul`` with the
    pre-dequantized bf16 weight, ``scaled_dot_product_attention`` on a
    dequantized cache."""
    import torch
    import torch.nn.functional as F

    from tpu_nexus_torch.ops.decode_attention import decode_attention, decode_attention_plain
    from tpu_nexus_torch.ops.quant_matmul import quant_matmul, quant_matmul_plain

    dt = torch.bfloat16
    for key, m, k, n, mode, group in QUANT_TIMED:
        x = torch.randn((m, k), generator=torch.Generator(device="cuda").manual_seed(4000), device="cuda").to(dt)
        first = quant_weight(k, n, mode, group, 4001)
        copies = max(4, -(-128 * 2**20 // (first.q.numel() + first.s.numel() * 4)))
        weights = [first] + [quant_weight(k, n, mode, group, 4001 + i) for i in range(1, copies)]
        dense = [w.to(dt) for w in weights[: max(4, -(-copies // 4))]]  # 4x the bytes each: as many over L2
        bound, by = quant_bound(m, k, n, weights[0], dt)
        ms, enqueue_ms = timed([lambda w=w: quant_matmul(x, w) for w in weights], iters=64)
        row = dict(
            shape=[m, k, n], group=group or None, dtype="bfloat16", ms=ms, enqueue_ms=enqueue_ms,
            plain_ms=cuda_ms([lambda w=w: quant_matmul_plain(x, w) for w in weights[:4]], iters=8, warmup=2),
            library_ms=cuda_ms([lambda w=w: torch.matmul(x, w) for w in dense], iters=64),
            bound_ms=bound, bound_by=by, weight_copies=copies,
        )
        times[key] = row
        emit("times", kernel=key, library_ms_is="torch.matmul, pre-dequantized bf16 weight", **row)
        del weights, dense, first
        torch.cuda.empty_cache()

    hq, hkv, d = 32, 8, 128
    for b, max_len, kv_len, n_layers, key in ((8, 160, 144, 32, "decode_attention_int8kv"), (8, 4096, 4096, 4, None)):
        layers = []
        for i in range(n_layers):
            q, kk, vv = decode_inputs(b, 1, max_len, hq, hkv, d, dt, seed=4100 + i)
            layers.append((q, *int8_cache(kk, vv)))
        kern = [lambda a=a: decode_attention(a[0], a[1], a[2], kv_len, None, None, a[3], a[4]) for a in layers]
        plain = [lambda a=a: decode_attention_plain(a[0], a[1], a[2], kv_len, None, None, a[3], a[4])
                 for a in layers]
        lib_sets = [(q.transpose(1, 2), (k8[:, :kv_len].to(dt) * ks[:, :kv_len].to(dt)).transpose(1, 2),
                     (v8[:, :kv_len].to(dt) * vs[:, :kv_len].to(dt)).transpose(1, 2))
                    for q, k8, v8, ks, vs in layers]
        lib = [lambda a=a: F.scaled_dot_product_attention(*a, enable_gqa=True) for a in lib_sets]
        nbytes = 2 * b * kv_len * hkv * (d + 4) + 2 * b * hq * d * 2  # int8 K/V + f32 scales, q and out
        flops = 4 * b * hq * kv_len * d
        t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
        ms, enqueue_ms = timed(kern, iters=64)
        row = dict(shape=[b, 1, max_len, kv_len, hq, hkv, d], dtype="bfloat16 q, int8 cache",
                   ms=ms, enqueue_ms=enqueue_ms, plain_ms=cuda_ms(plain, iters=32), library_ms=cuda_ms(lib, iters=64),
                   bound_ms=max(t_ops, t_bytes), bound_by="operations" if t_ops > t_bytes else "bytes")
        if key:
            times[key] = row
        emit("times", kernel="decode_attention_int8kv",
             library_ms_is="scaled_dot_product_attention, dequantized bf16 cache", **row)
        del layers, lib_sets
    torch.cuda.empty_cache()


def bwd_bound(b, s, hq, hkv, d, dtype, n_matmuls, outputs, causal=True):
    """Least time for the backward or a kernel's share of it: ``n_matmuls``
    products of S·S·D per head (halved by causality) at the tensor-core peak, or its bytes
    (q, k, v, dO and the lse/dsum rows read once, ``outputs`` written once)
    at the HBM rate, whichever is larger."""
    import torch

    itemsize = torch.empty((), dtype=dtype).element_size()
    flops = n_matmuls * 2 * b * hq * s * s * d / (2 if causal else 1)
    out_elems = {"dq": b * s * hq * d, "dkv": 2 * b * s * hkv * d,
                 "all": b * s * hq * d + 2 * b * s * hkv * d}[outputs]
    nbytes = (2 * b * s * hq * d + 2 * b * s * hkv * d + out_elems) * itemsize + 2 * b * hq * s * 4
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def bwd_times(times):
    """Kernels #2 (dQ) and #3 (dK/dV) at the nexus_1b training shape (B8
    S2048 Hq16 Hkv8 D128 causal, bf16) and at nexus_moe's (Hq8 Hkv4): ms per
    launch (q̃ made beforehand), the whole ``flash_attention_bwd`` (dsum, q̃
    and both kernels: the number to set beside the library's), the plain
    backward's ms (dQ, dK and dV together) and, as a yardstick only, the
    backward of ``scaled_dot_product_attention`` on the same inputs (all
    three grads, its own preprocessing included)."""
    import torch
    import torch.nn.functional as F

    from tpu_nexus_torch.ops.flash_attention import (
        flash_attention_bwd,
        flash_attention_bwd_dkv,
        flash_attention_bwd_dq,
        flash_attention_bwd_plain,
        flash_bwd_qt,
        flash_dsum,
    )

    b, s, d, dt = 8, 2048, 128, torch.bfloat16
    for hq, hkv, suffix in ((16, 8, ""), (8, 4, "_moe")):
        sets = [bwd_inputs(b, s, hq, hkv, d, dt, True, seed=1200 + i) for i in range(2)]
        pre = [(flash_dsum(x[3], x[5]), flash_bwd_qt(x[0], d**-0.5)) for x in sets]
        dq_fns = [lambda x=x, p=p: flash_attention_bwd_dq(x[0], x[1], x[2], x[5], x[4], p[0], qt=p[1])
                  for x, p in zip(sets, pre)]
        dkv_fns = [lambda x=x, p=p: flash_attention_bwd_dkv(x[0], x[1], x[2], x[5], x[4], p[0], qt=p[1])
                   for x, p in zip(sets, pre)]
        whole_fns = [lambda x=x: flash_attention_bwd(*x) for x in sets]
        plain = [lambda x=sets[0]: flash_attention_bwd_plain(*x)]
        lib = []
        for q, k, v, _, _, dout in sets:
            ql, kl, vl = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
            out = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True, enable_gqa=True)
            g = dout.transpose(1, 2)
            lib.append(lambda out=out, g=g, leaves=(ql, kl, vl): torch.autograd.grad(
                out, leaves, g, retain_graph=True))
        plain_ms = cuda_ms(plain, iters=3, warmup=1)
        lib_ms = cuda_ms(lib, iters=20)
        # the function's 5 products split between the kernels: dQ = dS·K and one
        # of the two both kernels need (S = q̃·Kᵀ, dP = dO·Vᵀ); dV, dK and the
        # other.  The split design recomputes both shared products in each
        # kernel (3 and 4 products), which the bound does not count.
        for key, fns, n_matmuls, outputs in (
            ("flash_attention_bwd_dq", dq_fns, 2, "dq"), ("flash_attention_bwd_dkv", dkv_fns, 3, "dkv"),
        ):
            bound, by = bwd_bound(b, s, hq, hkv, d, dt, n_matmuls, outputs)
            ms, enqueue_ms = timed(fns, iters=20)
            times[key + suffix] = dict(shape=[b, s, hq, hkv, d], dtype="bfloat16", ms=ms, enqueue_ms=enqueue_ms,
                                       plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound, bound_by=by,
                                       bound_matmuls=f"{n_matmuls} of the function's 5")
            emit("times", kernel=key, plain_ms_is="plain backward, dQ+dK+dV",
                 library_ms_is="scaled_dot_product_attention backward, dQ+dK+dV", **times[key + suffix])
        whole, whole_by = bwd_bound(b, s, hq, hkv, d, dt, 5, "all")
        wrapper_ms, wrapper_enqueue_ms = timed(whole_fns, iters=20)
        times["flash_attention_bwd" + suffix] = dict(
            shape=[b, s, hq, hkv, d], dtype="bfloat16",
            ms=times["flash_attention_bwd_dq" + suffix]["ms"] + times["flash_attention_bwd_dkv" + suffix]["ms"],
            wrapper_ms=wrapper_ms, wrapper_enqueue_ms=wrapper_enqueue_ms,
            bound_ms=whole, bound_by=whole_by, library_ms=lib_ms, plain_ms=plain_ms)
        emit("times", kernel="flash_attention_bwd (ms: dQ + dK/dV; wrapper_ms: flash_attention_bwd, "
             "dsum + q̃ + both kernels)", **times["flash_attention_bwd" + suffix])
        del sets, pre, lib, dq_fns, dkv_fns, whole_fns, plain
        torch.cuda.empty_cache()


def phase_e2e(results):
    import torch

    from tpu_nexus_torch.models.generate import generate
    from tpu_nexus_torch.models.llama import LlamaConfig, llama_init
    from tpu_nexus_torch.ops.decode_attention import decode_attention
    from tpu_nexus_torch.ops.flash_attention import flash_attention

    cfg = dataclasses.replace(
        LlamaConfig.llama3_8b(), n_layers=2, dtype=torch.float32, param_dtype=torch.float32
    )
    params = llama_init(torch.Generator(device="cuda").manual_seed(0), cfg, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (4, 128), generator=g, device="cuda", dtype=torch.int32)
    f0, d0 = flash_attention.launches, decode_attention.launches
    with_kernels = generate(params, prompt, cfg, max_new_tokens=32)
    launched = (flash_attention.launches - f0, decode_attention.launches - d0)
    plain = generate(params, prompt, cfg, max_new_tokens=32, attn_impl="plain", decode_kernel="plain")
    torch.cuda.synchronize()
    same = bool(torch.equal(with_kernels, plain))
    mismatch = int((with_kernels != plain).sum())
    emit("e2e", config="llama3_8b widths, 2 layers, f32", batch=4, prompt=128, new_tokens=32,
         token_identical=same, mismatched_tokens=mismatch, flash_launches=launched[0],
         decode_launches=launched[1])
    if not same or launched[0] != cfg.n_layers or launched[1] != cfg.n_layers * 31:
        raise AssertionError("kernel path is not token-identical to the plain path (or skipped a kernel)")

    # quantized trees: the dequant-matmul kernels (and the int8-KV decode
    # mode) against the dequantize-then-einsum path and the plain attention
    from tpu_nexus_torch.models.quant import quantize_params
    from tpu_nexus_torch.ops.quant_matmul import quant_matmul

    for mode, kv_quant, counter in (("int8", "int8", "launches_int8"), ("int4", "", "launches_int4")):
        qparams = quantize_params(params, mode=mode)
        counts = lambda: (getattr(quant_matmul, counter), decode_attention.launches_by_mode["contiguous+int8"])  # noqa: E731
        before = counts()
        with_kernels = generate(qparams, prompt, cfg, max_new_tokens=32, kv_quant=kv_quant)
        launched = tuple(n - b for n, b in zip(counts(), before))
        os.environ["NEXUS_QUANT_KERNEL"] = "plain"
        try:
            plain = generate(qparams, prompt, cfg, max_new_tokens=32, kv_quant=kv_quant, attn_impl="plain",
                             decode_kernel="plain")
        finally:
            del os.environ["NEXUS_QUANT_KERNEL"]
        torch.cuda.synchronize()
        same = bool(torch.equal(with_kernels, plain))
        emit("e2e", config=f"llama3_8b widths, 2 layers, f32, {mode} weights, kv_quant={kv_quant!r}", batch=4,
             prompt=128, new_tokens=32, token_identical=same, mismatched_tokens=int((with_kernels != plain).sum()),
             quant_matmul_launches=launched[0], int8kv_decode_launches=launched[1])
        want_kv = cfg.n_layers * 31 if kv_quant else 0
        if not same or launched != (7 * cfg.n_layers * 31, want_kv):
            raise AssertionError(f"{mode} kernel path is not token-identical to the plain path (or skipped a kernel)")
        del qparams
    del params
    torch.cuda.empty_cache()


def _bwd_counters():
    from tpu_nexus_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_bwd_dkv,
        flash_attention_bwd_dq,
    )

    return flash_attention, flash_attention_bwd_dq, flash_attention_bwd_dkv


def phase_train_e2e(results):
    """nexus_1b widths at 2 layers in f32: 3 train steps through the
    kernels against 3 steps through dense attention under autograd
    (``attn_impl="plain"``) on the card, same init and batches.  Loss and
    grad norm agree within 1e-4 and 1e-3 relative: the f32 kernels differ
    from dense attention only in summation order (~1e-6 relative), which
    Adam can amplify on near-zero gradient elements over the steps."""
    import torch

    from tpu_nexus_torch.models.llama import LlamaConfig, llama_head, llama_hidden
    from tpu_nexus_torch.models.registry import LlamaAdapter
    from tpu_nexus_torch.workload.data import synthetic_tokens
    from tpu_nexus_torch.workload.train import (
        TrainConfig,
        chunked_next_token_loss,
        init_train_state,
        make_train_step,
    )

    class DenseAttentionAdapter(LlamaAdapter):
        """LlamaAdapter whose loss runs the model on dense attention."""

        def make_loss(self, train_cfg):
            def loss_fn(params, tokens):
                hidden = llama_hidden(params, tokens, self.config, attn_impl="plain")
                return chunked_next_token_loss(hidden, llama_head(params, self.config), tokens,
                                               train_cfg.z_loss, chunk=train_cfg.ce_chunk)

            return loss_fn

    cfg = dataclasses.replace(LlamaConfig.nexus_1b(), n_layers=2, dtype=torch.float32,
                              param_dtype=torch.float32)
    runs = {}
    counters = _bwd_counters()
    tcfg = TrainConfig(warmup_steps=1, total_steps=3)
    for impl, model in (("auto", LlamaAdapter(config=cfg)), ("plain", DenseAttentionAdapter(config=cfg))):
        state = init_train_state(torch.Generator(device="cuda").manual_seed(0), model, tcfg, device="cuda")
        step_fn = make_train_step(model, tcfg)
        data = synthetic_tokens(2, 512, cfg.vocab_size, seed=3)
        before = [c.launches for c in counters]
        rows = []
        for _ in range(3):
            state, m = step_fn(state, torch.as_tensor(next(data), device="cuda").long())
            rows.append((float(m["loss"]), float(m["grad_norm"])))
        runs[impl] = (rows, [c.launches - b for c, b in zip(counters, before)])
        del state
    (got, launched), (ref, plain_launched) = runs["auto"], runs["plain"]
    loss_rel = max(abs(a[0] - b[0]) / abs(b[0]) for a, b in zip(got, ref))
    gn_rel = max(abs(a[1] - b[1]) / abs(b[1]) for a, b in zip(got, ref))
    emit("train_e2e", config="nexus_1b widths, 2 layers, f32; batch 2, seq 512, 3 adamw steps",
         kernels=got, plain=ref, max_loss_rel_err=loss_rel, max_grad_norm_rel_err=gn_rel,
         tol_loss_rel=1e-4, tol_grad_norm_rel=1e-3, launches_fwd_dq_dkv=launched,
         plain_launches=plain_launched)
    if loss_rel > 1e-4 or gn_rel > 1e-3:
        raise AssertionError("kernel training steps disagree with the plain path")
    if launched != [cfg.n_layers * 3] * 3 or plain_launched != [0, 0, 0]:
        raise AssertionError(f"launches {launched} (plain {plain_launched}) != {cfg.n_layers} x 3 each")
    torch.cuda.empty_cache()


def phase_train(results):
    """``run_workload`` on nexus_1b at full width and depth: bf16 params,
    adamw, remat attn_out, batch 8, seq 2048, 20 steps, in-memory ledger.
    The counters, zeroed just before, must show 14 launches per step of
    each of the flash forward, dQ and dK/dV kernels: the remat keeps the
    forward's outputs, so the backward never re-runs it."""
    import torch

    from tpu_nexus_torch.checkpoint.models import LifecycleStage
    from tpu_nexus_torch.checkpoint.store import InMemoryCheckpointStore
    from tpu_nexus_torch.core.telemetry import NullMetrics
    from tpu_nexus_torch.models.llama import LlamaConfig, param_count
    from tpu_nexus_torch.models.registry import LlamaAdapter
    from tpu_nexus_torch.parallel.distributed import ProcessContext
    from tpu_nexus_torch.workload.goodput import model_flops_per_token
    from tpu_nexus_torch.workload.harness import WorkloadConfig, run_workload
    from tpu_nexus_torch.workload.train import TrainConfig

    torch.cuda.empty_cache()
    model = LlamaConfig.nexus_1b()
    steps, batch, seq = 20, 8, 2048
    cfg = WorkloadConfig(model=LlamaAdapter(config=model),
                         train=TrainConfig(warmup_steps=10, total_steps=steps, optimizer="adamw"),
                         batch_size=batch, seq_len=seq, steps=steps, heartbeat_every=5, device="cuda")
    store = InMemoryCheckpointStore()
    ctx = ProcessContext(run_id="chip-smoke-train", algorithm="train", process_id=0, num_processes=1,
                         coordinator=None)
    counters = _bwd_counters()
    torch.cuda.reset_peak_memory_stats()
    for c in counters:
        c.launches = 0
    zero_rms_norm_launches()
    t0 = time.perf_counter()
    summary = run_workload(cfg, store=store, ctx=ctx, telemetry=NullMetrics())
    wall = time.perf_counter() - t0
    read_rms_norm_launches(results, "train")
    launches = {c.__name__: c.launches for c in counters}
    row = store.read_checkpoint("train", "chip-smoke-train")
    stage = row.lifecycle_stage if row else None
    flops_per_token = model_flops_per_token(model, seq)
    # steady state: the goodput meter books the first step (allocator and
    # library warm-up) under init_compile; steps 2..N are data + step time
    buckets = summary["goodput"]["buckets_s"]
    steady_tps = (steps - 1) * batch * seq / (buckets["data_draw"] + buckets["step_dispatch"])
    emit("train", config="nexus_1b full width and depth, bf16 params, adamw, remat attn_out",
         batch=batch, seq=seq, steps=steps, params=param_count(model), stage=stage,
         per_chip_steps=row.per_chip_steps if row else None, wall_s=wall,
         max_memory_allocated=torch.cuda.max_memory_allocated(), launches=launches,
         model_flops_per_token=flops_per_token, peak_flops=PEAK_BF16_FLOPS,
         steady_tokens_per_second=steady_tps,
         steady_mfu=steady_tps * flops_per_token / PEAK_BF16_FLOPS, **summary)
    if stage != LifecycleStage.COMPLETED:
        raise AssertionError(f"ledger row is {stage}, not COMPLETED")
    want = model.n_layers * steps
    if any(n != want for n in launches.values()):
        raise AssertionError(f"launches {launches} != {model.n_layers} x {steps} each")
    results.setdefault("launches", {})["train"] = launches
    results["train"] = summary


def phase_serve(results):
    import torch

    from tpu_nexus_torch.checkpoint.models import LifecycleStage
    from tpu_nexus_torch.checkpoint.store import InMemoryCheckpointStore
    from tpu_nexus_torch.models.llama import LlamaConfig
    from tpu_nexus_torch.ops.decode_attention import decode_attention
    from tpu_nexus_torch.ops.flash_attention import flash_attention
    from tpu_nexus_torch.parallel.distributed import ProcessContext
    from tpu_nexus_torch.workload.serve import ServeConfig, run_serving

    torch.cuda.empty_cache()
    model = dataclasses.replace(LlamaConfig.llama3_8b(), param_dtype=torch.bfloat16)
    cfg = ServeConfig(model=model, batch_size=8, prompt_len=128, gen_tokens=32, rounds=3, device="cuda")
    store = InMemoryCheckpointStore()
    ctx = ProcessContext(run_id="chip-smoke", algorithm="serve", process_id=0, num_processes=1, coordinator=None)
    torch.cuda.reset_peak_memory_stats()
    flash_attention.launches = 0
    decode_attention.launches = 0
    zero_rms_norm_launches()
    t0 = time.perf_counter()
    summary = run_serving(cfg, store=store, ctx=ctx)
    wall = time.perf_counter() - t0
    read_rms_norm_launches(results, "serve")
    launches = {"flash_attention": flash_attention.launches, "decode_attention": decode_attention.launches}
    row = store.read_checkpoint("serve", "chip-smoke")
    stage = row.lifecycle_stage if row else None
    emit("serve", config="llama3_8b full width and depth, bf16 params", stage=stage,
         per_chip_steps=row.per_chip_steps if row else None, wall_s=wall,
         max_memory_allocated=torch.cuda.max_memory_allocated(), launches=launches, **summary)
    n_layers = model.n_layers
    if stage != LifecycleStage.COMPLETED:
        raise AssertionError(f"ledger row is {stage}, not COMPLETED")
    if launches["flash_attention"] != n_layers * summary["prefill_calls"]:
        raise AssertionError(f"flash launches {launches['flash_attention']} != {n_layers} x prefill calls")
    if launches["decode_attention"] < n_layers * summary["decode_steps"]:
        raise AssertionError(f"decode launches {launches['decode_attention']} < {n_layers} x decode steps")
    results.setdefault("launches", {})["serve"] = launches


def phase_serve_quant(results):
    """``run_serving`` on llama3_8b at full width and depth with quantized
    weights: int8 weights + int8 KV cache, then int4 weights (group 64).
    The counters, zeroed just before each run, must show exactly 7
    dequant-matmul launches per layer per decode step (wq, wk, wv, wo,
    w_gate, w_up, w_down; prefill's M = 1024 rows take the dense matmul),
    all of them of the int8 or int4 ring kernel."""
    import torch

    from tpu_nexus_torch.checkpoint.models import LifecycleStage
    from tpu_nexus_torch.checkpoint.store import InMemoryCheckpointStore
    from tpu_nexus_torch.models.llama import LlamaConfig
    from tpu_nexus_torch.ops.decode_attention import decode_attention, reset_launches
    from tpu_nexus_torch.ops.flash_attention import flash_attention
    from tpu_nexus_torch.ops.quant_matmul import quant_matmul
    from tpu_nexus_torch.parallel.distributed import ProcessContext
    from tpu_nexus_torch.workload.serve import ServeConfig, run_serving

    class WeightBytes(logging.Handler):
        """Reads the quantized tree's footprint from the line the workload logs."""

        def emit(self, record):
            if "weight bytes" in str(record.msg):
                self.value = record.args[1]

    serve_log = logging.getLogger("tpu_nexus_torch.workload.serve")
    model = dataclasses.replace(LlamaConfig.llama3_8b(), param_dtype=torch.bfloat16)
    n_layers = model.n_layers
    for name, quantize, quantize_kv in (("serve_int8", "int8", "int8"), ("serve_int4", "int4", "")):
        torch.cuda.empty_cache()
        cfg = ServeConfig(model=model, batch_size=8, prompt_len=128, gen_tokens=32, rounds=3, device="cuda",
                          quantize=quantize, quantize_kv=quantize_kv)
        store = InMemoryCheckpointStore()
        ctx = ProcessContext(run_id=name, algorithm="serve", process_id=0, num_processes=1, coordinator=None)
        torch.cuda.reset_peak_memory_stats()
        flash_attention.launches = 0
        reset_launches()
        quant_matmul.launches_int8 = quant_matmul.launches_int4 = 0
        quant_matmul.launches_by_route.update(dict.fromkeys(quant_matmul.launches_by_route, 0))
        weight_bytes = WeightBytes(level=logging.INFO)
        serve_log.addHandler(weight_bytes)
        level = serve_log.level
        serve_log.setLevel(logging.INFO)
        zero_rms_norm_launches()
        t0 = time.perf_counter()
        try:
            summary = run_serving(cfg, store=store, ctx=ctx)
        finally:
            serve_log.removeHandler(weight_bytes)
            serve_log.setLevel(level)
        wall = time.perf_counter() - t0
        read_rms_norm_launches(results, name)
        launches = {
            "flash_attention": flash_attention.launches, "decode_attention": decode_attention.launches,
            "decode_attention_int8kv": decode_attention.launches_by_mode["contiguous+int8"],
            "quant_matmul_int8": quant_matmul.launches_int8, "quant_matmul_int4": quant_matmul.launches_int4,
            **{f"quant_matmul_{r}": c for r, c in quant_matmul.launches_by_route.items()},
        }
        row = store.read_checkpoint("serve", name)
        stage = row.lifecycle_stage if row else None
        emit("serve_quant", config=f"llama3_8b full width and depth ({n_layers} layers), bf16 params, "
             f"quantize={quantize!r} quantize_kv={quantize_kv!r}", stage=stage,
             per_chip_steps=row.per_chip_steps if row else None, wall_s=wall,
             max_memory_allocated=torch.cuda.max_memory_allocated(), launches=launches,
             weight_bytes=weight_bytes.value, **summary)
        if stage != LifecycleStage.COMPLETED:
            raise AssertionError(f"{name}: ledger row is {stage}, not COMPLETED")
        want = {
            "flash_attention": n_layers * summary["prefill_calls"],
            "decode_attention_int8kv": n_layers * summary["decode_steps"] if quantize_kv else 0,
            "quant_matmul_int8": 7 * n_layers * summary["decode_steps"] if quantize == "int8" else 0,
            "quant_matmul_int4": 7 * n_layers * summary["decode_steps"] if quantize == "int4" else 0,
            # every decode-step product of the quantized configurations goes through a ring kernel
            "quant_matmul_int8_ring": 7 * n_layers * summary["decode_steps"] if quantize == "int8" else 0,
            "quant_matmul_int4_ring": 7 * n_layers * summary["decode_steps"] if quantize == "int4" else 0,
        }
        wrong = {k: (launches[k], v) for k, v in want.items() if launches[k] != v}
        if wrong or launches["decode_attention"] < n_layers * summary["decode_steps"]:
            raise AssertionError(f"{name}: launches (got, want) {wrong or launches}")
        results.setdefault("launches", {})[name] = launches


def phase_profile(results, quantize="", kv_quant=""):
    """Opt-in (``--phases build,profile``): one warm ``generate`` round of
    the serve phase's shape under ``torch.profiler``; device time by
    kernel group and the device's busy share of the window.
    ``profile_int8`` and ``profile_int4`` do the same with the serve_quant
    phase's two configurations (int8 weights + int8 KV; int4 weights)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tpu_nexus_torch.models.generate import generate
    from tpu_nexus_torch.models.llama import LlamaConfig, llama_init
    from tpu_nexus_torch.models.quant import quantize_params
    from tpu_nexus_torch.workload.data import synthetic_tokens

    cfg = dataclasses.replace(LlamaConfig.llama3_8b(), param_dtype=torch.bfloat16)
    params = llama_init(torch.Generator(device="cuda").manual_seed(0), cfg, device="cuda")
    if quantize:
        params = quantize_params(params, mode=quantize)
        torch.cuda.empty_cache()
    prompts = synthetic_tokens(8, 128, cfg.vocab_size, seed=101)
    generate(params, torch.as_tensor(next(prompts), device="cuda"), cfg, max_new_tokens=32, kv_quant=kv_quant)
    batch = torch.as_tensor(next(prompts), device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    generate(params, batch, cfg, max_new_tokens=32, kv_quant=kv_quant)
    torch.cuda.synchronize()
    plain_wall_ms = (time.perf_counter() - t0) * 1e3  # the same round, no profiler
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        generate(params, batch, cfg, max_new_tokens=32, kv_quant=kv_quant)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    def group_of(low):
        if "flash_fwd" in low:
            return "flash_attention kernel"
        if "decode_hopper" in low or "decode_partial" in low or "decode_combine" in low:
            return "decode_attention kernel"
        if "quant_matmul" in low or "quant_int4_ring" in low or "quant_int8_ring" in low:
            return "quant_matmul kernels (int8 ring, int4 ring; first design's partial + finalize)"
        if any(s in low for s in ("nvjet", "gemm", "xmma", "cutlass", "cublas", "sm90")):
            return "matmul (cuBLAS)"
        return "other (elementwise, copies, reductions)"

    groups, top = _group_device_time(prof, group_of)
    device_ms = sum(groups.values())
    emit("profile", config=f"llama3_8b full depth, bf16 params, quantize={quantize!r} kv_quant={kv_quant!r}; "
         "one generate round: batch 8, prompt 128, 32 new tokens", wall_ms=wall_ms, unprofiled_wall_ms=plain_wall_ms, device_ms=device_ms,
         device_busy_share=device_ms / wall_ms, idle_share=1 - device_ms / wall_ms,
         busy_share_of_unprofiled_round=device_ms / plain_wall_ms,
         groups_ms=groups, top=[{"ms": t, "calls": c, "name": n} for t, c, n in top[:12]])
    del params
    # the quantized rounds' decode-sized products are one launch each: no finalize pass among the kernels
    finalize = [n for _, _, n in top[:12] if "finalize" in n.lower()]
    if quantize and finalize:
        raise AssertionError(f"profile quantize={quantize!r}: a finalize kernel in the top list: {finalize}")


def _group_device_time(prof, groups_of):
    """Device ms by group and the top kernels of a profiler run."""
    groups, top = {}, []
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "self_cuda_time_total", 0.0)
        if not dev_us or "cuda" not in str(getattr(evt, "device_type", "")).lower():
            continue
        group = groups_of(evt.key.lower())
        groups[group] = groups.get(group, 0.0) + dev_us / 1e3
        top.append((dev_us / 1e3, evt.count, evt.key[:90]))
    top.sort(reverse=True)
    return groups, top


def phase_train_profile(results):
    """Opt-in (``--phases build,train_profile``): two warm training steps of
    the train phase's shape (nexus_1b, bf16, adamw, attn_out, batch 8, seq
    2048) under ``torch.profiler``; device time by kernel group, the top
    kernels, and the device's busy share of the profiled window."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tpu_nexus_torch.models.llama import LlamaConfig
    from tpu_nexus_torch.models.registry import host_to_device
    from tpu_nexus_torch.workload.data import synthetic_tokens
    from tpu_nexus_torch.workload.health import HealthConfig
    from tpu_nexus_torch.workload.train import TrainConfig, init_train_state, make_train_step

    cfg = LlamaConfig.nexus_1b()
    tcfg = TrainConfig(warmup_steps=10, total_steps=20)
    state = init_train_state(torch.Generator(device="cuda").manual_seed(0), cfg, tcfg, device="cuda")
    step_fn = make_train_step(cfg, tcfg, health=HealthConfig())
    data = synthetic_tokens(8, 2048, cfg.vocab_size, seed=0)
    batches = [host_to_device(next(data), "cuda", torch.long) for _ in range(6)]
    for batch in batches[:2]:
        step_fn(state, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for batch in batches[2:4]:
        step_fn(state, batch)
    torch.cuda.synchronize()
    plain_wall_ms = (time.perf_counter() - t0) * 1e3 / 2
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for batch in batches[4:]:
            step_fn(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / 2

    def group_of(low):
        if "flash_bwd_dq" in low:
            return "flash backward dQ kernel"
        if "flash_bwd_dkv" in low:
            return "flash backward dK/dV kernel"
        if "flash_fwd" in low:
            return "flash forward kernel"
        if any(k in low for k in ("nvjet", "gemm", "xmma", "cutlass", "cublas", "sm90")):
            return "matmul (cuBLAS)"
        return "other (elementwise, reductions, copies)"

    groups, top = _group_device_time(prof, group_of)
    groups = {k: v / 2 for k, v in groups.items()}
    device_ms = sum(groups.values())
    emit("train_profile", config="nexus_1b full depth, bf16, adamw, attn_out; batch 8, seq 2048; "
         "ms per step, mean of 2 profiled steps", wall_ms=wall_ms, unprofiled_wall_ms=plain_wall_ms,
         device_ms=device_ms, device_busy_share=device_ms / wall_ms,
         busy_share_of_unprofiled_step=device_ms / plain_wall_ms, groups_ms=groups,
         top=[{"ms_per_step": t / 2, "calls": c // 2, "name": n} for t, c, n in top[:20]])
    del state, batches


# -- the MoE slice: grouped matmul (kernels #7 and #8), MoE training and serving --


#: grouped-matmul cases of moe_parity: (M, K, N, block_m, tiles per expert,
#: dtypes).  The nexus_moe train step's shapes (gate/up and down, bm 512,
#: m_pad 36864 = 72 tiles; expert 1 holds only its padding tile), a bm-128
#: layout, and Mixtral-8x7B's gate at one layer (K 4096, N 14336).
GMM_PARITY_CASES = [
    (36864, 1024, 2048, 512, (20, 1, 8, 12, 9, 7, 10, 5), ("bfloat16", "float32")),
    (36864, 2048, 1024, 512, (20, 1, 8, 12, 9, 7, 10, 5), ("bfloat16", "float32")),
    (4096, 1024, 2048, 128, (1, 10, 3, 4, 6, 2, 5, 1), ("bfloat16", "float32")),
    (12288, 4096, 14336, 512, (3, 3, 4, 2, 3, 3, 3, 3), ("bfloat16",)),
]
#: f32 limit on max-abs error relative to the reference's largest magnitude
#: (kernel and plain version differ in the order of the f32 sums only)
GMM_F32_MAXABS_REL = 1e-5
#: edge cases of moe_parity, each through gmm, gmm on rhsᵀ and tgmm in bf16
#: and f32: (what, M, K, N, block_m, E, tile_expert)
GMM_EDGE_CASES = [
    ("K and N not multiples of 64", 1024, 200, 72, 128, 4, (0, 0, 0, 1, 2, 2, 3, 3)),
    ("a ragged last slab and column tile", 2048, 1000, 1336, 256, 3, (0, 0, 0, 1, 1, 2, 2, 2)),
    ("K of one slab", 1024, 64, 512, 128, 2, (0, 0, 0, 0, 1, 1, 1, 1)),
    ("K under one slab", 512, 8, 256, 128, 2, (0, 1, 1, 1)),
    ("M of one tile: fewer units than SMs", 128, 1024, 2048, 128, 1, (0,)),
    ("an unsorted tile_expert", 1024, 256, 384, 128, 4, (2, 0, 3, 1, 0, 2, 3, 0)),
    ("expert ids outside [0, E): gmm writes zeros, tgmm skips them", 1024, 256, 384, 128, 3,
     (0, -1, 1, 3, 1, 2, 7, 0)),
    ("300 experts: tgmm past the ranked table, in expert order", 2048, 128, 256, 128, 300,
     (0, 299, 5, 5, 150, 299, 0, 7, 8, 9, 10, 11, 12, 13, 14, 15)),
]


def tile_map(tiles_per_expert):
    import torch

    return torch.repeat_interleave(
        torch.arange(len(tiles_per_expert), dtype=torch.int32), torch.tensor(tiles_per_expert)
    ).to("cuda")


def gmm_inputs(m, k, n, e, dtype, seed, transpose=False):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    lhs = torch.randn((m, k), generator=g, device="cuda").to(dtype)
    rhs = (torch.randn((e, n, k) if transpose else (e, k, n), generator=g, device="cuda") * k**-0.5).to(dtype)
    return lhs, rhs


def _gmm_check(out, again, ref, dtype):
    """(ok, fields): bit-identical twice, finite, and within the limits."""
    import torch

    same = bool(torch.equal(out, again))
    err, ref_max, e_row = max_err(out, ref), float(ref.float().abs().max()), row_rel_err(out, ref)
    good = e_row <= ROW_REL_TOL if dtype == torch.bfloat16 else err <= GMM_F32_MAXABS_REL * ref_max
    ok = same and good and bool(torch.isfinite(out).all())
    return ok, dict(max_abs_err=err, ref_max_abs=ref_max, max_row_rel_err=e_row, bit_identical_twice=same,
                    tol_f32_max_abs_rel=GMM_F32_MAXABS_REL, tol_bf16_row_rel=ROW_REL_TOL, ok=ok)


def phase_moe_parity(results):
    """Kernels #7 (forward and the transposed-rhs d_lhs call) and #8 against
    ``gmm_plain`` / ``tgmm_plain`` on the card, each run twice."""
    import torch

    from tpu_nexus_torch.ops.grouped_matmul import gmm_kernel_call, gmm_plain, tgmm_kernel_call, tgmm_plain

    worst = {"nexus_gmm": 0.0, "nexus_tgmm": 0.0}
    seed = 6000
    for m, k, n, bm, tiles, dtypes in GMM_PARITY_CASES:
        te = tile_map(tiles)
        e = len(tiles)
        for name in dtypes:
            dtype = getattr(torch, name)
            for kind in ("gmm", "gmm_transposed_rhs", "tgmm"):
                if kind == "tgmm" and k * n > 1024 * 2048:
                    continue  # the weight gradient runs at the train step's shapes only
                seed += 1
                transpose = kind == "gmm_transposed_rhs"
                lhs, rhs = gmm_inputs(m, k, n, e, dtype, seed, transpose)
                if kind == "tgmm":
                    d_out = torch.randn((m, n), generator=torch.Generator(device="cuda").manual_seed(seed + 1),
                                        device="cuda").to(dtype)
                    out, again = (tgmm_kernel_call(lhs, d_out, te, e, bm) for _ in range(2))
                    torch.cuda.synchronize()
                    ref = tgmm_plain(lhs, d_out, te, e, bm)
                else:
                    out, again = (gmm_kernel_call(lhs, rhs, te, bm, transpose_rhs=transpose) for _ in range(2))
                    torch.cuda.synchronize()
                    ref = gmm_plain(lhs, rhs.transpose(1, 2) if transpose else rhs, te, bm)
                ok, fields = _gmm_check(out, again, ref, dtype)
                emit("moe_parity", kernel=kind, m=m, k=k, n=n, block_m=bm, tiles_per_expert=list(tiles),
                     dtype=name, **fields)
                if not ok:
                    raise AssertionError(f"{kind} kernel disagrees with its plain version: M{m} K{k} N{n} {name}")
                key = "nexus_tgmm" if kind == "tgmm" else "nexus_gmm"
                if dtype == torch.bfloat16 and (m, k, n) == (36864, 1024, 2048):
                    worst[key] = max(worst[key], fields["max_abs_err"])
                del lhs, rhs, out, again, ref
                torch.cuda.empty_cache()
    for what, m, k, n, bm, e, te_list in GMM_EDGE_CASES:
        te = torch.tensor(te_list, dtype=torch.int32, device="cuda")
        outside = torch.tensor([not 0 <= x < e for x in te_list], device="cuda").repeat_interleave(bm)
        for name in ("bfloat16", "float32"):
            dtype = getattr(torch, name)
            for kind in ("gmm", "gmm_transposed_rhs", "tgmm"):
                seed += 1
                transpose = kind == "gmm_transposed_rhs"
                lhs, rhs = gmm_inputs(m, k, n, e, dtype, seed, transpose)
                if kind == "tgmm":
                    d_out = torch.randn((m, n), generator=torch.Generator(device="cuda").manual_seed(seed + 1),
                                        device="cuda").to(dtype)
                    out, again = (tgmm_kernel_call(lhs, d_out, te, e, bm) for _ in range(2))
                    torch.cuda.synchronize()
                    ref = tgmm_plain(lhs, d_out, te, e, bm)
                    zeros_ok = True
                else:
                    out, again = (gmm_kernel_call(lhs, rhs, te, bm, transpose_rhs=transpose) for _ in range(2))
                    torch.cuda.synchronize()
                    ref = gmm_plain(lhs, rhs.transpose(1, 2) if transpose else rhs, te, bm)
                    zeros_ok = not bool(out[outside].any())
                ok, fields = _gmm_check(out, again, ref, dtype)
                emit("moe_parity", kernel=kind, case=what, m=m, k=k, n=n, block_m=bm, experts=e,
                     tile_expert=list(te_list), dtype=name, rows_of_outside_ids_zero=zeros_ok, **fields)
                if not (ok and zeros_ok):
                    raise AssertionError(f"{kind} kernel disagrees with its plain version: {what}, {name}")
                del lhs, rhs, out, again, ref
    torch.cuda.empty_cache()
    # an expert with no tile at all: tgmm writes its block as zeros
    te = tile_map((2, 0, 2))
    lhs, _ = gmm_inputs(512, 256, 256, 3, torch.bfloat16, 6500)
    d_out = torch.randn((512, 256), device="cuda").to(torch.bfloat16)
    out = tgmm_kernel_call(lhs, d_out, te, 3, 128)
    torch.cuda.synchronize()
    emit("moe_parity", kernel="tgmm", case="expert 1 owns no tile", max_abs_of_absent_block=float(out[1].abs().max()))
    if float(out[1].abs().max()) != 0.0:
        raise AssertionError("tgmm wrote a nonzero block for an expert with no tile")
    results.setdefault("max_abs_err", {}).update(worst)


def gmm_bound(m, k, n, e, dtype, tgmm=False):
    """Least time: 2MKN operations at the peak of the inputs' type, or the
    inputs read once and the output written once at the HBM rate."""
    import torch

    itemsize = torch.empty((), dtype=dtype).element_size()
    if tgmm:  # lhs [M,K], d_out [M,N] -> f32 [E,K,N]
        nbytes = (m * k + m * n) * itemsize + e * k * n * 4
    else:  # lhs [M,K], rhs [E,K,N] -> [M,N]
        nbytes = (m * k + e * k * n + m * n) * itemsize
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS
    t_ops, t_bytes = 2 * m * k * n / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def event_ms(fn, iters=3):
    """Mean ms per call between CUDA events around ``iters`` calls, host
    gaps included: for the plain versions, which read tile_expert on the
    host (``nonzero``) and so cannot be enqueued behind a spin."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def grouped_library(lhs, rhs, tiles, bm, tgmm_out=None):
    """``(fn, what)``: one PyTorch call for the same grouped product, as a
    yardstick the port never calls.  ``torch._grouped_mm`` with group
    offsets where this PyTorch has it and takes the layout; else a loop of
    E ``torch.matmul`` over the expert runs (host offsets)."""
    import torch

    ends = [bm * sum(tiles[: i + 1]) for i in range(len(tiles))]
    offs = torch.tensor(ends, dtype=torch.int32, device="cuda")
    starts = [0] + ends[:-1]
    grouped = getattr(torch, "_grouped_mm", None)
    if tgmm_out is None:
        candidates = [("torch._grouped_mm(lhs, rhs, offs)", lambda: grouped(lhs, rhs, offs=offs)),
                      ("torch._grouped_mm(lhs, rhs column-major, offs)",
                       (lambda rc=rhs.transpose(1, 2).contiguous().transpose(1, 2): grouped(lhs, rc, offs=offs)))]
        loop = ("loop of E torch.matmul over the expert runs",
                lambda: [torch.matmul(lhs[s:t], rhs[i]) for i, (s, t) in enumerate(zip(starts, ends))])
    else:
        d_out = tgmm_out
        candidates = [("torch._grouped_mm(lhs.T, d_out, offs)", lambda: grouped(lhs.T, d_out, offs=offs,
                                                                                  out_dtype=torch.float32)),
                      ("torch._grouped_mm(lhs.T contiguous, d_out, offs)",
                       (lambda lt=lhs.T.contiguous(): grouped(lt, d_out, offs=offs, out_dtype=torch.float32)))]
        loop = ("loop of E torch.matmul over the expert runs (bf16 out)",
                lambda: [torch.matmul(lhs[s:t].T, d_out[s:t]) for s, t in zip(starts, ends)])
    if grouped is not None:
        for what, fn in candidates:
            try:
                fn()
                torch.cuda.synchronize()
                return fn, what
            except (RuntimeError, TypeError, ValueError):
                continue
    return loop[1], loop[0]


def moe_times(times):
    """Kernels #7 and #8 at the nexus_moe train step's shapes (B8 S2048:
    T 16384, A 32768, bm 512, m_pad 36864; gate/up, down, the d_lhs call,
    the weight gradient) and #7 at Mixtral-8x7B's gate for one layer (T
    4096, m_pad 12288, K 4096, N 14336), bf16, uneven expert runs.  Two
    input sets per shape, cycled, so operands come from HBM."""
    import torch

    from tpu_nexus_torch.ops.grouped_matmul import gmm_kernel_call, gmm_plain, tgmm_kernel_call, tgmm_plain

    dt = torch.bfloat16
    tiles_nexus, tiles_mixtral = (9, 8, 10, 9, 8, 9, 10, 9), (3, 3, 4, 2, 3, 3, 3, 3)
    rows = (
        ("nexus_gmm", "gmm gate/up (nexus_moe train step)", 36864, 1024, 2048, tiles_nexus, "gmm"),
        (None, "gmm down (nexus_moe train step)", 36864, 2048, 1024, tiles_nexus, "gmm"),
        (None, "gmm d_lhs of gate/up, rhs read transposed", 36864, 2048, 1024, tiles_nexus, "gmm_t"),
        ("nexus_tgmm", "tgmm d_rhs of gate/up (nexus_moe train step)", 36864, 1024, 2048, tiles_nexus, "tgmm"),
        ("nexus_gmm_mixtral", "gmm gate (mixtral_8x7b, one layer)", 12288, 4096, 14336, tiles_mixtral, "gmm"),
    )
    for key, what, m, k, n, tiles, kind in rows:
        te, e, bm = tile_map(tiles), len(tiles), 512
        if kind == "tgmm":
            sets = []
            for i in range(2):
                g = torch.Generator(device="cuda").manual_seed(7000 + i)
                sets.append((torch.randn((m, k), generator=g, device="cuda").to(dt),
                             torch.randn((m, n), generator=g, device="cuda").to(dt)))
            kern = [lambda s=s: tgmm_kernel_call(s[0], s[1], te, e, bm) for s in sets]
            plain = lambda s=sets[0]: tgmm_plain(s[0], s[1], te, e, bm)  # noqa: E731
            lib, lib_what = grouped_library(sets[0][0], None, tiles, bm, tgmm_out=sets[0][1])
            bound, by = gmm_bound(m, k, n, e, dt, tgmm=True)
        else:
            transpose = kind == "gmm_t"
            sets = [gmm_inputs(m, k, n, e, dt, 7200 + i, transpose) for i in range(2)]
            kern = [lambda s=s: gmm_kernel_call(s[0], s[1], te, bm, transpose_rhs=transpose) for s in sets]
            plain = (lambda s=sets[0]: gmm_plain(s[0], s[1].transpose(1, 2) if transpose else s[1], te, bm))  # noqa: E731
            lib, lib_what = grouped_library(sets[0][0], sets[0][1].transpose(1, 2) if transpose else sets[0][1],
                                            tiles, bm)
            bound, by = gmm_bound(m, k, n, e, dt)
        ms, enqueue_ms = timed(kern, iters=20)
        row = dict(shape=[m, k, n, e], block_m=bm, tiles_per_expert=list(tiles), dtype="bfloat16", ms=ms,
                   enqueue_ms=enqueue_ms, plain_ms=event_ms(plain), library_ms=cuda_ms([lib], iters=20),
                   library_ms_is=lib_what, bound_ms=bound, bound_by=by, share=bound / ms)
        emit("times", kernel=what, plain_ms_is="events around calls that read tile_expert on the host", **row)
        if key:
            times[key] = row
        del sets, kern, plain, lib
        torch.cuda.empty_cache()


class plain_grouped_matmul:
    """Within the block, ``ops.grouped_matmul``'s two wrappers are replaced
    by their plain versions, so the model runs the same code with the
    kernels' arithmetic in plain PyTorch (what ``attn_impl="plain"`` is to
    attention)."""

    def __enter__(self):
        from tpu_nexus_torch.ops import grouped_matmul as gm

        self.saved = gm.gmm_kernel_call, gm.tgmm_kernel_call
        gm.gmm_kernel_call = lambda lhs, rhs, te, bm, transpose_rhs=False: gm.gmm_plain(
            lhs, rhs.transpose(1, 2) if transpose_rhs else rhs, te, bm)
        gm.tgmm_kernel_call = gm.tgmm_plain
        return self

    def __exit__(self, *exc):
        from tpu_nexus_torch.ops import grouped_matmul as gm

        gm.gmm_kernel_call, gm.tgmm_kernel_call = self.saved
        return False


def _moe_counters():
    from tpu_nexus_torch.ops.grouped_matmul import gmm_kernel_call, tgmm_kernel_call

    return (gmm_kernel_call, tgmm_kernel_call) + _bwd_counters()


def moe_launches_per_step(cfg):
    """(gmm, tgmm, flash fwd, dQ, dK/dV) launches of one MoE train step.
    Per layer the forward runs three gmm (gate, up, down); under a
    checkpointing policy the backward re-runs them (the "attn_out" and
    "qkv" policies keep the flash outputs, so attention's forward does not
    re-run, while "nothing" re-runs it); the backward adds one gmm on rhsᵀ
    (d_lhs) and one tgmm (d_rhs) per product."""
    recompute = cfg.remat and cfg.remat_policy != "dots"
    l = cfg.n_layers
    flash_fwd = l * (2 if recompute and cfg.remat_policy == "nothing" else 1)
    return (l * 3 * (3 if recompute else 2), 3 * l, flash_fwd, l, l)


def phase_moe_train_e2e(results):
    """nexus_moe widths at 2 layers in f32, dispatch gmm: 3 adamw steps
    through the kernels against 3 through the plain versions (dense
    attention, ``plain_grouped_matmul``) on the card, same init and
    batches; the limits of ``train_e2e``; nothing dropped."""
    import torch

    from tpu_nexus_torch.models.moe import MoeConfig, moe_head, moe_hidden
    from tpu_nexus_torch.models.registry import MoeAdapter
    from tpu_nexus_torch.workload.data import synthetic_tokens
    from tpu_nexus_torch.workload.train import TrainConfig, chunked_next_token_loss, init_train_state, make_train_step

    class PlainMoeAdapter(MoeAdapter):
        """MoeAdapter whose loss runs dense attention."""

        def make_loss(self, train_cfg):
            cfg = self.config

            def loss_fn(params, tokens):
                hidden, aux = moe_hidden(params, tokens, cfg, attn_impl="plain")
                loss, metrics = chunked_next_token_loss(hidden, moe_head(params, cfg), tokens, train_cfg.z_loss,
                                                        chunk=train_cfg.ce_chunk)
                loss = loss + cfg.load_balance_coef * aux["load_balance"] + cfg.router_z_coef * aux["router_z"]
                return loss, dict(metrics, dropped_frac=aux["dropped_frac"])

            return loss_fn

    cfg = dataclasses.replace(MoeConfig.nexus_moe(), n_layers=2, dtype=torch.float32, param_dtype=torch.float32)
    tcfg = TrainConfig(warmup_steps=1, total_steps=3)
    counters = _moe_counters()
    runs = {}
    for impl, model in (("kernels", MoeAdapter(config=cfg)), ("plain", PlainMoeAdapter(config=cfg))):
        state = init_train_state(torch.Generator(device="cuda").manual_seed(0), model, tcfg, device="cuda")
        step_fn = make_train_step(model, tcfg)
        data = synthetic_tokens(2, 512, cfg.vocab_size, seed=3)
        before = [c.launches for c in counters]
        rows = []
        with plain_grouped_matmul() if impl == "plain" else contextlib.nullcontext():
            for _ in range(3):
                state, m = step_fn(state, torch.as_tensor(next(data), device="cuda").long())
                rows.append((float(m["loss"]), float(m["grad_norm"]), float(m["dropped_frac"])))
        runs[impl] = (rows, [c.launches - b for c, b in zip(counters, before)])
        del state
    (got, launched), (ref, plain_launched) = runs["kernels"], runs["plain"]
    loss_rel = max(abs(a[0] - b[0]) / abs(b[0]) for a, b in zip(got, ref))
    gn_rel = max(abs(a[1] - b[1]) / abs(b[1]) for a, b in zip(got, ref))
    dropped = max(r[2] for r in got + ref)
    want = [3 * n for n in moe_launches_per_step(cfg)]
    emit("moe_train_e2e", config="nexus_moe widths, 2 layers, f32, dispatch gmm; batch 2, seq 512, 3 adamw steps",
         kernels=got, plain=ref, max_loss_rel_err=loss_rel, max_grad_norm_rel_err=gn_rel, max_dropped_frac=dropped,
         tol_loss_rel=1e-4, tol_grad_norm_rel=1e-3, launches_gmm_tgmm_fwd_dq_dkv=launched, want=want,
         plain_launches=plain_launched)
    if loss_rel > 1e-4 or gn_rel > 1e-3 or dropped != 0.0:
        raise AssertionError("MoE kernel training steps disagree with the plain path (or dropped tokens)")
    if launched != want or plain_launched != [0] * len(counters):
        raise AssertionError(f"launches {launched} (plain {plain_launched}) != {want}")
    torch.cuda.empty_cache()


def phase_train_moe(results):
    """``run_workload`` on nexus_moe at full width and depth (bf16 params,
    dispatch gmm, remat attn_out; adamw, batch 8, seq 2048, 20 steps) into
    an in-memory ledger: COMPLETED, exactly the derived gmm, tgmm and flash
    launches, nothing dropped; steady tokens/s, MFU, peak memory and the
    goodput buckets."""
    import torch

    from tpu_nexus_torch.checkpoint.models import LifecycleStage
    from tpu_nexus_torch.checkpoint.store import InMemoryCheckpointStore
    from tpu_nexus_torch.core.telemetry import NullMetrics
    from tpu_nexus_torch.models.moe import MoeConfig, moe_param_count
    from tpu_nexus_torch.models.registry import MoeAdapter
    from tpu_nexus_torch.parallel.distributed import ProcessContext
    from tpu_nexus_torch.workload.goodput import model_flops_per_token
    from tpu_nexus_torch.workload.harness import WorkloadConfig, run_workload
    from tpu_nexus_torch.workload.train import TrainConfig

    torch.cuda.empty_cache()
    model = MoeConfig.nexus_moe()
    steps, batch, seq = 20, 8, 2048
    cfg = WorkloadConfig(model=MoeAdapter(config=model),
                         train=TrainConfig(warmup_steps=10, total_steps=steps, optimizer="adamw"),
                         batch_size=batch, seq_len=seq, steps=steps, heartbeat_every=5, device="cuda")
    store = InMemoryCheckpointStore()
    ctx = ProcessContext(run_id="chip-smoke-train-moe", algorithm="train", process_id=0, num_processes=1,
                         coordinator=None)
    counters = _moe_counters()
    names = ("nexus_gmm", "nexus_tgmm", "flash_attention", "flash_attention_bwd_dq", "flash_attention_bwd_dkv")
    torch.cuda.reset_peak_memory_stats()
    for c in counters:
        c.launches = 0
    zero_rms_norm_launches()
    t0 = time.perf_counter()
    summary = run_workload(cfg, store=store, ctx=ctx, telemetry=NullMetrics())
    wall = time.perf_counter() - t0
    read_rms_norm_launches(results, "train_moe")
    launches = {name: c.launches for name, c in zip(names, counters)}
    row = store.read_checkpoint("train", "chip-smoke-train-moe")
    stage = row.lifecycle_stage if row else None
    flops_per_token = model_flops_per_token(model, seq)
    buckets = summary["goodput"]["buckets_s"]
    steady_tps = (steps - 1) * batch * seq / (buckets["data_draw"] + buckets["step_dispatch"])
    want = {name: n * steps for name, n in zip(names, moe_launches_per_step(model))}
    emit("train_moe", config="nexus_moe full width and depth, bf16 params, dispatch gmm, adamw, remat attn_out",
         batch=batch, seq=seq, steps=steps, params=moe_param_count(model), stage=stage,
         per_chip_steps=row.per_chip_steps if row else None, wall_s=wall,
         max_memory_allocated=torch.cuda.max_memory_allocated(), launches=launches, want_launches=want,
         model_flops_per_token=flops_per_token, peak_flops=PEAK_BF16_FLOPS, steady_tokens_per_second=steady_tps,
         steady_mfu=steady_tps * flops_per_token / PEAK_BF16_FLOPS, **summary)
    if stage != LifecycleStage.COMPLETED:
        raise AssertionError(f"ledger row is {stage}, not COMPLETED")
    if launches != want:
        raise AssertionError(f"launches {launches} != {want}")
    if summary.get("dropped_frac") != 0.0:
        raise AssertionError(f"dropped_frac {summary.get('dropped_frac')} != 0 on the dropless path")
    results.setdefault("launches", {})["train_moe"] = launches
    results["train_moe"] = summary


def phase_serve_moe(results):
    """``run_serving`` on nexus_moe at full width and depth (bf16 params;
    decode dispatches by scatter at a dropless capacity, as the reference):
    batch 8, prompt 128, 32 new tokens, 3 rounds; COMPLETED with exactly
    layers x prefill calls flash and layers x decode steps decode launches.
    Then greedy ``generate`` at 2 layers in f32, kernels against plain:
    token-identical."""
    import torch

    from tpu_nexus_torch.checkpoint.models import LifecycleStage
    from tpu_nexus_torch.checkpoint.store import InMemoryCheckpointStore
    from tpu_nexus_torch.models.generate import generate
    from tpu_nexus_torch.models.moe import MoeConfig, moe_init
    from tpu_nexus_torch.ops.decode_attention import decode_attention
    from tpu_nexus_torch.ops.flash_attention import flash_attention
    from tpu_nexus_torch.parallel.distributed import ProcessContext
    from tpu_nexus_torch.workload.serve import ServeConfig, run_serving

    torch.cuda.empty_cache()
    model = MoeConfig.nexus_moe()
    cfg = ServeConfig(model=model, batch_size=8, prompt_len=128, gen_tokens=32, rounds=3, device="cuda")
    store = InMemoryCheckpointStore()
    ctx = ProcessContext(run_id="chip-smoke-moe", algorithm="serve", process_id=0, num_processes=1, coordinator=None)
    torch.cuda.reset_peak_memory_stats()
    flash_attention.launches = decode_attention.launches = 0
    zero_rms_norm_launches()
    t0 = time.perf_counter()
    summary = run_serving(cfg, store=store, ctx=ctx)
    wall = time.perf_counter() - t0
    read_rms_norm_launches(results, "serve_moe")
    launches = {"flash_attention": flash_attention.launches, "decode_attention": decode_attention.launches}
    row = store.read_checkpoint("serve", "chip-smoke-moe")
    stage = row.lifecycle_stage if row else None
    want = {"flash_attention": model.n_layers * summary["prefill_calls"],
            "decode_attention": model.n_layers * summary["decode_steps"]}
    emit("serve_moe", config="nexus_moe full width and depth, bf16 params", stage=stage,
         per_chip_steps=row.per_chip_steps if row else None, wall_s=wall,
         max_memory_allocated=torch.cuda.max_memory_allocated(), launches=launches, want_launches=want, **summary)
    if stage != LifecycleStage.COMPLETED:
        raise AssertionError(f"ledger row is {stage}, not COMPLETED")
    if launches != want:
        raise AssertionError(f"launches {launches} != {want}")
    results.setdefault("launches", {})["serve_moe"] = launches

    small = dataclasses.replace(model, n_layers=2, dtype=torch.float32, param_dtype=torch.float32)
    params = moe_init(torch.Generator(device="cuda").manual_seed(0), small, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(1)
    prompt = torch.randint(0, small.vocab_size, (4, 128), generator=g, device="cuda", dtype=torch.int32)
    f0, d0 = flash_attention.launches, decode_attention.launches
    with_kernels = generate(params, prompt, small, max_new_tokens=32)
    launched = (flash_attention.launches - f0, decode_attention.launches - d0)
    plain = generate(params, prompt, small, max_new_tokens=32, attn_impl="plain", decode_kernel="plain")
    torch.cuda.synchronize()
    same = bool(torch.equal(with_kernels, plain))
    emit("serve_moe", config="nexus_moe widths, 2 layers, f32: greedy generate, kernels vs plain", batch=4,
         prompt=128, new_tokens=32, token_identical=same, mismatched_tokens=int((with_kernels != plain).sum()),
         flash_launches=launched[0], decode_launches=launched[1])
    if not same or launched != (small.n_layers, small.n_layers * 31):
        raise AssertionError("MoE kernel decode is not token-identical to the plain path (or skipped a kernel)")
    del params


def _decode_probe_times():
    """Kernel #4 (bf16) at the serve step's and kv 4096's shapes: contiguous
    and int8-KV at B8 q_len 1, paged (page 32) per-slot decode and the
    q_len-5 verify; ms on the card per launch."""
    import numpy as np
    import torch

    from tpu_nexus_torch.ops.decode_attention import decode_attention

    dt, times = torch.bfloat16, {}
    for label, max_len, kv_len, n_layers, int8 in (("contiguous_144", 160, 144, 32, False),
                                                   ("contiguous_4096", 4096, 4096, 4, False),
                                                   ("int8_144", 160, 144, 32, True),
                                                   ("int8_4096", 4096, 4096, 4, True)):
        layers = []
        for i in range(n_layers):
            q, k, v = decode_inputs(8, 1, max_len, 32, 8, 128, dt, seed=1000 + i)
            layers.append((q, *int8_cache(k, v)) if int8 else (q, k, v, None, None))
        times[label] = cuda_ms([lambda a=a: decode_attention(a[0], a[1], a[2], kv_len, None, None, a[3], a[4])
                                for a in layers], iters=64)
        del layers
    for label, sq, kv_len in (("paged_144", 1, 144), ("verify_q5_144", 5, 144)):
        n_log = -(-(kv_len + 16) // 32)
        starts = np.full(8, kv_len - 1, np.int32) if sq == 1 else (kv_len - sq - np.arange(8) * 7).astype(np.int32)
        layers = [paged_case(8, sq, 32, n_log, starts + sq, dt, 7000 + i) for i in range(32)]
        if sq == 1:
            kw = dict(prompt_lengths=torch.from_numpy(starts + sq).cuda(), prompt_width=n_log * 32)
        else:
            kw = dict(prompt_lengths=torch.zeros(8, dtype=torch.int32, device="cuda"), prompt_width=0,
                      q_starts=torch.from_numpy(starts).cuda())
        deepest = int((starts + sq).max())
        times[label] = cuda_ms([lambda x=x: decode_attention(x[0], x[1], x[2], deepest, block_tables=x[3], **kw)
                                for x in layers], iters=64)
        del layers
    torch.cuda.empty_cache()
    return times


def phase_decode_probe(results):
    """Opt-in: what sets kernel #4's pace.  (1) bf16 contiguous B8 across
    q_len x GQA (query rows 4-64, so wgmma N 8-64) at kv_len 144 and 4096;
    (2) the library built again from copies of ``csrc`` whose
    ``kProducerThreads`` is 32 and 64 (one and two producer warps; the
    kernel ships four) and timed beside the shipped build in every mode."""
    import re
    import shutil

    import torch

    from tpu_nexus_torch.ops import _build
    from tpu_nexus_torch.ops import decode_attention as dec

    sweep = {}
    for sq, hq in ((1, 32), (2, 32), (3, 32), (5, 32), (8, 32), (5, 8), (1, 64), (8, 64)):
        for max_len, kv_len, n_layers in ((160, 144, 32), (4096, 4096, 4)):
            layers = [decode_inputs(8, sq, max_len, hq, 8, 128, torch.bfloat16, seed=1000 + i)
                      for i in range(n_layers)]
            sweep[f"q_len{sq}_hq{hq}_kv{kv_len}"] = cuda_ms([lambda a=a: dec.decode_attention(*a, kv_len)
                                                            for a in layers], iters=64)
            del layers
    emit("decode_probe", sweep_ms=sweep, rows="q_len x Hq/Hkv; wgmma N = rows rounded up to 8, 16, 32 or 64")
    by_producer = {128: _decode_probe_times()}
    shipped = (_build.CSRC, _build.BUILD_DIR, _build._library)
    source = (_build.CSRC / "decode_attention.cu").read_text()
    try:
        for threads in (32, 64):
            probe = ROOT / "build" / f"decode_probe_producer{threads}"
            shutil.rmtree(probe, ignore_errors=True)
            shutil.copytree(shipped[0], probe / "csrc")
            edited, n = re.subn(r"constexpr int kProducerThreads = \d+;",
                                f"constexpr int kProducerThreads = {threads};", source)
            if n != 1:
                raise RuntimeError("decode_probe: kProducerThreads not found once in decode_attention.cu")
            (probe / "csrc" / "decode_attention.cu").write_text(edited)
            _build.CSRC, _build.BUILD_DIR, _build._library = probe / "csrc", probe / "build", None
            dec._RESIDENT.clear()
            by_producer[threads] = _decode_probe_times()
    finally:
        _build.CSRC, _build.BUILD_DIR, _build._library = shipped
        dec._RESIDENT.clear()
    emit("decode_probe", ms_by_producer_threads=by_producer)
    results["decode_probe"] = dict(sweep_ms=sweep, ms_by_producer_threads=by_producer)


#: int4_probe's builds of #6's ring kernel: label -> textual edits of csrc/quant_matmul.cu (each must
#: match once).  "truncating_pack" packs two f32 into bf16 by keeping their high halves (a byte
#: permute) instead of cvt.rn.bf16x2; "no_dequant" also skips the nibble decode and scale; "no_x_reads"
#: zero-fills the activation copies instead of reading x; "stages5_two_ctas" has a 5-stage ring at two
#: CTAs an SM (shipped: 8 stages, one CTA), "stages12" a 12-stage ring; "l2_promotion_128b" fills L2 in 128-byte lines; "consumers_skip" releases each stage as
#: soon as it lands; "ring_only" also drops the end of every run (sums, partials, merge); "no_merge"
#: writes every tile as if whole (no partials, no merge); "merge_reads_nothing" keeps the partials and
#: arrivals but the last CTA adds no partial.  Only times: most edits change results.
_TRUNC_PACK = [("__device__ __forceinline__ float int4_value(",
                "__device__ __forceinline__ uint32_t pack_trunc(float lo, float hi) {\n"
                "  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);\n}\n"
                "__device__ __forceinline__ float int4_value("),
               ("pack_bf16(int4_value(", "pack_trunc(int4_value(")]
_SKIP_STAGE = [("        mbar_wait(&full[st], phase);\n",
                "        mbar_wait(&full[st], phase);\n        if (kb >= 0) {  // the stage arrived: release it\n"
                "          __syncwarp();\n          if (lane == 0) mbar_arrive(&empty[st]);\n"
                "          if (++st == kRingStages) st = 0, phase ^= 1;\n          continue;\n        }\n")]
INT4_PROBE_EDITS = {
    "truncating_pack": _TRUNC_PACK,
    "no_dequant": _TRUNC_PACK + [
        ("return (__uint_as_float(__byte_perm(nibbles, kTwoPow23Bits, 0x7650 + j)) - 8388616.f) * s;",
         "return __uint_as_float(nibbles ^ j);")],
    "no_x_reads": [("ok ? 16 : 0);", "0);")],
    "stages5_two_ctas": [("constexpr int kRingStages = 8;", "constexpr int kRingStages = 5;"),
                         ("constexpr int kRingCtasPerSm = 1;", "constexpr int kRingCtasPerSm = 2;")],
    "stages12": [("constexpr int kRingStages = 8;", "constexpr int kRingStages = 12;")],
    "l2_promotion_128b": [("CU_TENSOR_MAP_L2_PROMOTION_L2_256B", "CU_TENSOR_MAP_L2_PROMOTION_L2_128B")],
    "consumers_skip": _SKIP_STAGE,
    "ring_only": _SKIP_STAGE + [("      // The tile's sums: the eight warps added in a fixed order",
                                 "      if (u > 0) continue;  // no end of the run\n"
                                 "      // The tile's sums: the eight warps added in a fixed order")],
    "no_merge": [("      if (seg_begin == tile_begin && seg_end == tile_begin + n_kb) {",
                  "      if (true) {  // every tile written as if whole: no partials, no merge")],
    "merge_reads_nothing": [("        for (int c0 = first; c0 <= last; c0 += 16) {",
                             "        for (int c0 = first; c0 < first; c0 += 16) {")],
}


#: quant_matmul.cu's int8 ring kernel section (its constants, layout and kernel): int4_probe's edits
#: are made outside it, int8_probe's inside it
_INT8_SECTION = ("// ---- int8, bf16 activations: the ring kernel", "// A row-major matrix [rows, cols]")


def _edit_source(source, edits, label, inside_int8):
    """``source`` with ``edits`` made either only inside :data:`_INT8_SECTION` or only outside it;
    each ``old`` must be found there once (int4's four ``pack_bf16(int4`` calls: four times)."""
    i = source.index(_INT8_SECTION[0])
    j = source.index(_INT8_SECTION[1], i)
    head, section, tail = source[:i], source[i:j], source[j:]
    text = section if inside_int8 else head + "\x00" + tail
    for old, new in edits:
        if text.count(old) != (4 if old.startswith("pack_bf16(int4") else 1):
            raise RuntimeError(f"{label}: {old!r} not found as expected in quant_matmul.cu")
        text = text.replace(old, new)
    return head + text + tail if inside_int8 else text.replace("\x00", section)


def _streamk_plan(rows, n, m, resident, stage_rows, cols=128):
    """A plan for the probes: every shape cut into runs over all the CTAs the card holds (at least
    two units each), runs free to straddle tiles, as the shipped plan does only for many tiles."""
    from tpu_nexus_torch.ops import quant_matmul as qmm

    units = -(-n // cols) * -(-m // qmm.ROWS_M) * -(-rows // stage_rows)
    return units, max(1, min(resident, units // qmm.MIN_RING_UNITS))


def _int4_probe_times(hot=False):
    """#6's bf16 launches of :data:`QUANT_TIMED` (int4 rows), kernel time only (ms): weight copies
    over 128 MB (from HBM), or with ``hot`` one copy, left in L2 by the call before."""
    import torch

    from tpu_nexus_torch.ops.quant_matmul import quant_matmul

    out = {}
    for key, m, k, n, mode, group in QUANT_TIMED:
        if mode != "int4":
            continue
        x = torch.randn((m, k), generator=torch.Generator(device="cuda").manual_seed(4000), device="cuda")
        x = x.to(torch.bfloat16)
        first = quant_weight(k, n, mode, group, 4001)
        copies = 1 if hot else max(4, -(-128 * 2**20 // (first.q.numel() + first.s.numel() * 4)))
        weights = [first] + [quant_weight(k, n, mode, group, 4001 + i) for i in range(1, copies)]
        out[key] = cuda_ms([lambda w=w: quant_matmul(x, w) for w in weights], iters=64)
        del weights, first
    torch.cuda.empty_cache()
    return out


def phase_int4_probe(results):
    """Opt-in: what sets the pace of #6's ring kernel.  The shipped build
    with the plan of :func:`_streamk_plan`; then the library built
    again from copies of ``csrc`` edited as :data:`INT4_PROBE_EDITS` says;
    each timed beside the shipped build at the four int4 rows of
    ``quant_times``, the weights from HBM and (``*_hot``) left in L2 by the
    call before (``--phases build,int4_probe``)."""
    import shutil

    from tpu_nexus_torch.ops import _build
    from tpu_nexus_torch.ops import quant_matmul as qmm

    by_build = {"shipped": _int4_probe_times(), "shipped_hot": _int4_probe_times(hot=True)}
    plan = qmm.ring_plan
    try:  # the shipped build with runs free to straddle tiles at every shape
        qmm.ring_plan = _streamk_plan
        by_build["streamk_runs"] = _int4_probe_times()
    finally:
        qmm.ring_plan = plan
    shipped = (_build.CSRC, _build.BUILD_DIR, _build._library)
    source = (_build.CSRC / "quant_matmul.cu").read_text()
    try:
        for label, edits in INT4_PROBE_EDITS.items():
            edited = _edit_source(source, edits, f"int4_probe {label}", inside_int8=False)
            probe = ROOT / "build" / f"int4_probe_{label}"
            shutil.rmtree(probe, ignore_errors=True)
            shutil.copytree(shipped[0], probe / "csrc")
            (probe / "csrc" / "quant_matmul.cu").write_text(edited)
            _build.CSRC, _build.BUILD_DIR, _build._library = probe / "csrc", probe / "build", None
            qmm._RING_RESIDENT.clear()
            by_build[label] = _int4_probe_times()
            by_build[label + "_hot"] = _int4_probe_times(hot=True)
    finally:
        _build.CSRC, _build.BUILD_DIR, _build._library = shipped
        qmm._RING_RESIDENT.clear()
    by_build["shipped_again"] = _int4_probe_times()
    emit("int4_probe", ms_by_build=by_build)
    results["int4_probe"] = by_build


#: the int8 ring kernel with consumers that release each stage as soon as it lands and skip the end
#: of every run (sums, partials, merge): the producer's stream alone.  Only times: y is not written.
_I8_SKIP_STAGE = [("          mbar_wait(&full[st], phase);\n",
                   "          mbar_wait(&full[st], phase);\n          if (u >= 0) {  // the stage arrived: release it\n"
                   "            __syncwarp();\n            if (lane == 0) mbar_arrive(&empty[st]);\n"
                   "            if (++st == kI8Stages) st = 0, phase ^= 1;\n            continue;\n          }\n")]
_I8_NO_TILE_END = [("      // The tile's sums: the warps of each box added in warp order",
                    "      if (u > 0) continue;  // no end of the run\n"
                    "      // The tile's sums: the warps of each box added in warp order")]
_I8_64x128 = dict(kI8Rows=64, kI8Boxes=1, kI8Stages=16, kI8CtasPerSm=1)
_I8_128x128 = dict(kI8Rows=128, kI8Boxes=1, kI8Stages=8, kI8CtasPerSm=1)
_I8_64x256 = dict(kI8Rows=64, kI8Boxes=2, kI8Stages=8, kI8CtasPerSm=1)
_I8_TWO_CTAS = dict(kI8Rows=64, kI8Boxes=1, kI8Stages=8, kI8CtasPerSm=2)
_I8_WALK_ROWS = [("  const int cta = blockIdx.x;\n",
                  "  const int n_tiles = units / n_kb, n_runs = gridDim.x / n_tiles;\n"
                  "  const int cta = gridDim.x % n_tiles ? blockIdx.x\n"
                  "                                      : (blockIdx.x % n_tiles) * n_runs + blockIdx.x / n_tiles;\n")]
#: int8_probe's builds of #5's ring kernel: label -> (the section's constants, textual edits inside it,
#: each matching once).  The stage geometries: 128 rows x 128 columns (16 KB a stage, shipped), 64 x
#: 128 (8 KB, as #6's), 64 x 256 (two 128-byte swizzled boxes side by side), 64 x 128 at two CTAs an
#: SM; "walk_rows": the blocks renumbered so that CTAs with neighbouring indices read the same rows of
#: neighbouring strips.  "ring_only": the consumers release each stage as it lands and skip the end of every run
#: (the producer's stream alone); "consumers_skip": only the release; "no_tile_end": the consumers'
#: products, no end of a run (sums, partials, merge, y); "no_widen": one shift in place of the
#: byte permute and FADD of each weight value; "lop_widen": each value by a mask-and-or (LOP3) and an
#: FFMA, each pair packed by a shift-add, no byte permute; "no_mma": an XOR and an FADD in place of
#: each mma;
#: "no_merge": every tile written as if whole; "consumers_only": no weight streamed (each stage
#: complete at once, the consumers at their own pace); "_sN": an N-stage ring.  Only
#: times: most edits change results.
INT8_PROBE_BUILDS = {
    # the shipped geometry (128 x 128, 8 stages) with parts taken away
    "128x128_s8_ring_only": (_I8_128x128, _I8_SKIP_STAGE + _I8_NO_TILE_END),
    "128x128_s8_consumers_skip": (_I8_128x128, _I8_SKIP_STAGE),
    "128x128_s8_consumers_only": (_I8_128x128, [
        ("        mbar_arrive_expect_tx(&full[st], Int8RingSmem::kStageBytes);",
         "        mbar_arrive(&full[st]);  // no weight: the consumers at their own pace"),
        ("          tma_load_3d(tile + b * kI8Rows * kCols, &tm_q,",
         "          if (kb < 0) tma_load_3d(tile + b * kI8Rows * kCols, &tm_q,")]),
    "128x128_s8_no_tile_end": (_I8_128x128, _I8_NO_TILE_END),
    "128x128_s8_no_merge": (_I8_128x128, [
        ("      if (seg_begin == tile_begin && seg_end == tile_begin + n_kb) {",
         "      if (true) {  // every tile written as if whole: no partials, no merge")]),
    "128x128_s8_no_widen": (_I8_128x128, [
        ("return __uint_as_float(__byte_perm(u, kTwoPow23Bits, 0x7650 + j)) - 8388736.f;",
         "return __uint_as_float(u << (8 * j));")]),
    "128x128_s8_lop_widen": (_I8_128x128, [
        ("  return __uint_as_float(__byte_perm(u, kTwoPow23Bits, 0x7650 + j)) - 8388736.f;",
         "  if (j == 0) return __uint_as_float((u & 0xFFu) | 0x4B000000u) - 8388736.f;\n"
         "  if (j == 1) return fmaf(__uint_as_float((u & 0xFF00u) | 0x4F000000u), 0x1p-8f, -8388736.f);\n"
         "  if (j == 2) return fmaf(__uint_as_float((u & 0xFF0000u) | 0x53000000u), 0x1p-16f, -8388736.f);\n"
         "  return __uint_as_float((u >> 24) + 0x4B000000u) - 8388736.f;"),
        ("  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);",
         "  return (__float_as_uint(lo) >> 16) + __float_as_uint(hi);")]),
    "128x128_s8_no_mma": (_I8_128x128, [
        ("for (int cp = 0; cp < 8; ++cp) mma_bf16_16816(acc[cp], a[cp], b0, b1);",
         "for (int cp = 0; cp < 8; ++cp)\n"
         "              acc[cp][0] += __uint_as_float(a[cp][0] ^ a[cp][1] ^ a[cp][2] ^ a[cp][3] ^ b0 ^ b1);")]),
    # other stage geometries, ring depths and walks
    "128x128_s10_ring_only": (dict(_I8_128x128, kI8Stages=10), _I8_SKIP_STAGE + _I8_NO_TILE_END),
    "64x128_s16": (_I8_64x128, []),
    "64x128_s16_ring_only": (_I8_64x128, _I8_SKIP_STAGE + _I8_NO_TILE_END),
    "64x128_s12_ring_only": (dict(_I8_64x128, kI8Stages=12), _I8_SKIP_STAGE + _I8_NO_TILE_END),
    "64x128_s20_ring_only": (dict(_I8_64x128, kI8Stages=20), _I8_SKIP_STAGE + _I8_NO_TILE_END),
    "64x256_s8": (_I8_64x256, []),
    "64x256_s8_ring_only": (_I8_64x256, _I8_SKIP_STAGE + _I8_NO_TILE_END),
    "64x128_s8_two_ctas": (_I8_TWO_CTAS, []),
    "64x128_s8_two_ctas_ring_only": (_I8_TWO_CTAS, _I8_SKIP_STAGE + _I8_NO_TILE_END),
    "64x128_s16_walk_rows_ring_only": (_I8_64x128, _I8_WALK_ROWS + _I8_SKIP_STAGE + _I8_NO_TILE_END),
}


def _sass_mix(library, kernel):
    """Opcode counts in the SASS of ``kernel`` in ``library`` (the toolkit's cuobjdump): the mix of
    instructions a probe build compiled to."""
    import re

    from tpu_nexus_torch.ops import _build

    dump = subprocess.run([str(Path(_build._nvcc()).parent / "cuobjdump"), "-sass", str(library)],
                          capture_output=True, text=True, timeout=300, check=True).stdout
    body = next((f for f in dump.split("Function : ")[1:] if re.match(rf"\S*{kernel}", f)), "")
    mix = {}
    for op in re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", body):
        mix[op] = mix.get(op, 0) + 1
    return dict(sorted(mix.items(), key=lambda kv: -kv[1]))


def phase_int8_probe(results):
    """Opt-in: the int8 weight's stream, measured before and beside #5's ring kernel's consumers.
    At the four int8 rows of ``quant_times`` (weights from HBM), kernel time (ms) of: the parent
    design (the partial pass and its finalize, forced), ``torch.matmul`` on the bf16 weight, the
    shipped build with the plan it ships, with every shared tile merged through the workspace
    (``*_global_merge``), with runs over every resident CTA free to straddle tiles
    (``*_streamk``) and with clusters of up to 16 CTAs (``*_clusters16``), and the library built again from copies of ``csrc`` edited as each
    entry of :data:`INT8_PROBE_BUILDS` says (stage geometries, the stream alone, parts of the
    consumers taken away).  ``TBps`` divides each launch's bytes (the
    int8 weight, its scales, x and y) by its time (``--phases build,int8_probe``)."""
    import re
    import shutil

    import torch

    from tpu_nexus_torch.ops import _build
    from tpu_nexus_torch.ops import quant_matmul as qmm

    dt = torch.bfloat16
    rows = [(key, m, k, n) for key, m, k, n, mode, _ in QUANT_TIMED if mode == "int8"]
    inputs, nbytes = {}, {}
    for key, m, k, n in rows:
        x = torch.randn((m, k), generator=torch.Generator(device="cuda").manual_seed(4000), device="cuda").to(dt)
        first = quant_weight(k, n, "int8", 0, 4001)
        copies = max(4, -(-128 * 2**20 // (first.q.numel() + first.s.numel() * 4)))
        weights = [first] + [quant_weight(k, n, "int8", 0, 4001 + i) for i in range(1, copies)]
        inputs[key] = (x, weights)
        nbytes[key] = first.q.numel() + first.s.numel() * 4 + (m * k + m * n) * 2

    def times():
        return {key: cuda_ms([lambda w=w, x=x: qmm.quant_matmul(x, w) for w in weights], iters=64)
                for key, (x, weights) in inputs.items()}

    by_build = {}
    route = qmm.int8_ring_route
    try:  # the parent's design, as the wrapper launches it for the shapes the ring kernel does not take
        qmm.int8_ring_route = lambda *a: False
        by_build["parent_first_design"] = times()
    finally:
        qmm.int8_ring_route = route
    library = {}
    for key, (x, weights) in inputs.items():
        dense = [w.to(dt) for w in weights[: max(4, -(-len(weights) // 4))]]
        library[key] = cuda_ms([lambda w=w, x=x: torch.matmul(x, w) for w in dense], iters=64)
        del dense
    by_build["library_torch_matmul_bf16"] = library
    by_build["shipped"] = times()
    sass = {"shipped": _sass_mix(_build.library_path(), "quant_int8_ring_kernel")}
    plan, max_cluster = qmm.ring_plan, qmm.INT8_MAX_CLUSTER
    try:
        qmm.INT8_MAX_CLUSTER = 1  # every shared tile merged through the workspace, as #6 does
        by_build["shipped_global_merge"] = times()
        qmm.ring_plan = _streamk_plan
        by_build["shipped_streamk"] = times()
        qmm.ring_plan, qmm.INT8_MAX_CLUSTER = plan, 16  # non-portable clusters of up to 16 CTAs
        by_build["shipped_clusters16"] = times()
    finally:
        qmm.ring_plan, qmm.INT8_MAX_CLUSTER = plan, max_cluster
    capacity = {c: qmm._int8_cluster_capacity(torch.device("cuda", torch.cuda.current_device()), c)
                for c in (1, 2, 4, 8, 16)}

    shipped = (_build.CSRC, _build.BUILD_DIR, _build._library)
    geometry = (qmm.INT8_RING_ROWS, qmm.INT8_RING_COLS)
    source = (_build.CSRC / "quant_matmul.cu").read_text()
    errors = {}
    try:
        for label, (consts, extra) in INT8_PROBE_BUILDS.items():
            edits = []
            for name, value in consts.items():
                found = re.search(rf"constexpr int {name} = \d+;", source)
                if found is None:
                    raise RuntimeError(f"int8_probe {label}: no {name} in quant_matmul.cu")
                edits.append((found.group(0), f"constexpr int {name} = {value};"))
            edited = _edit_source(source, edits + extra, f"int8_probe {label}", inside_int8=True)
            probe = ROOT / "build" / f"int8_probe_{label}"
            shutil.rmtree(probe, ignore_errors=True)
            shutil.copytree(shipped[0], probe / "csrc")
            (probe / "csrc" / "quant_matmul.cu").write_text(edited)
            _build.CSRC, _build.BUILD_DIR, _build._library = probe / "csrc", probe / "build", None
            qmm.INT8_RING_ROWS, qmm.INT8_RING_COLS = consts["kI8Rows"], 128 * consts["kI8Boxes"]
            qmm._RING_RESIDENT.clear()
            try:
                by_build[label] = times()
                sass[label] = _sass_mix(_build.library_path(), "quant_int8_ring_kernel")
            except RuntimeError as err:  # a geometry that does not build or launch is a reading too
                errors[label] = str(err)[-2000:]
    finally:
        _build.CSRC, _build.BUILD_DIR, _build._library = shipped
        qmm.INT8_RING_ROWS, qmm.INT8_RING_COLS = geometry
        qmm._RING_RESIDENT.clear()
    by_build["shipped_again"] = times()
    rates = {label: {key: nbytes[key] / ms / 1e9 for key, ms in row.items()} for label, row in by_build.items()}
    emit("int8_probe", bytes=nbytes, ms_by_build=by_build, TBps_by_build=rates, errors=errors,
         shipped_cluster_capacity=capacity, sass_opcodes_by_build=sass)
    results["int8_probe"] = dict(ms_by_build=by_build, TBps_by_build=rates, errors=errors)


def phase_train_moe_profile(results):
    """Opt-in (``--phases build,train_moe_profile``): two warm training
    steps of train_moe's shape under ``torch.profiler``: device ms by group
    and the busy share of the profiled window."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tpu_nexus_torch.models.moe import MoeConfig
    from tpu_nexus_torch.models.registry import host_to_device
    from tpu_nexus_torch.workload.data import synthetic_tokens
    from tpu_nexus_torch.workload.health import HealthConfig
    from tpu_nexus_torch.workload.train import TrainConfig, init_train_state, make_train_step

    cfg = MoeConfig.nexus_moe()
    tcfg = TrainConfig(warmup_steps=10, total_steps=20)
    state = init_train_state(torch.Generator(device="cuda").manual_seed(0), cfg, tcfg, device="cuda")
    step_fn = make_train_step(cfg, tcfg, health=HealthConfig())
    data = synthetic_tokens(8, 2048, cfg.vocab_size, seed=0)
    batches = [host_to_device(next(data), "cuda", torch.long) for _ in range(6)]
    for batch in batches[:2]:
        step_fn(state, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for batch in batches[2:4]:
        step_fn(state, batch)
    torch.cuda.synchronize()
    plain_wall_ms = (time.perf_counter() - t0) * 1e3 / 2
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for batch in batches[4:]:
            step_fn(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / 2

    def group_of(low):
        if "tgmm" in low:
            return "tgmm kernel (#8)"
        if "gmm_" in low:
            return "gmm kernel (#7)"
        if "flash_bwd_dq" in low:
            return "flash backward dQ kernel"
        if "flash_bwd_dkv" in low:
            return "flash backward dK/dV kernel"
        if "flash_fwd" in low:
            return "flash forward kernel"
        if any(k in low for k in ("nvjet", "gemm", "xmma", "cutlass", "cublas", "sm90")):
            return "matmul (cuBLAS)"
        if any(k in low for k in ("index", "gather", "scatter", "sort", "radix", "searchsorted", "cumsum", "scan")):
            return "dispatch/combine gathers, sort and index maps"
        return "other (elementwise, reductions, copies)"

    groups, top = _group_device_time(prof, group_of)
    groups = {k: v / 2 for k, v in groups.items()}
    device_ms = sum(groups.values())
    emit("train_moe_profile", config="nexus_moe full depth, bf16, dispatch gmm, adamw, attn_out; batch 8, seq 2048; "
         "ms per step, mean of 2 profiled steps", wall_ms=wall_ms, unprofiled_wall_ms=plain_wall_ms,
         device_ms=device_ms, device_busy_share=device_ms / wall_ms,
         busy_share_of_unprofiled_step=device_ms / plain_wall_ms, groups_ms=groups,
         top=[{"ms_per_step": t / 2, "calls": c // 2, "name": n} for t, c, n in top[:24]])
    del state, batches


# -- the serve-engine slice: kernel #4's paged and q_starts modes, kernel #9 ----


def paged_case(b, sq, page, n_log, live, dtype, seed, int8=False):
    """q [B, sq, 32, 128] and a pooled cache [NB, page, 8, 128] with
    shuffled block tables: block 0 is the scratch block, each row's live
    logical blocks get distinct shuffled physical blocks, and the entries
    past a row's live length point at the scratch block.  With ``int8``
    the pool is quantized the way decode writes it."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    nb = 1 + b * n_log
    phys = rng.permutation(np.arange(1, nb)).reshape(b, n_log).astype(np.int32)
    live_blocks = -(-np.asarray(live) // page)
    tables = np.where(np.arange(n_log)[None, :] < live_blocks[:, None], phys, 0).astype(np.int32)
    q, k, v = decode_inputs(nb, sq, page, 32, 8, 128, dtype, seed=seed)
    q = q[:b].contiguous()
    scales = {}
    if int8:
        k, v, ks, vs = int8_cache(k, v)
        scales = dict(k_scale=ks, v_scale=vs)
    return q, k, v, torch.from_numpy(tables).cuda(), scales


def _gather_rows(pool, tables):
    b, n_log = tables.shape
    return pool[tables.long()].reshape(b, n_log * pool.shape[1], *pool.shape[2:])


def phase_engine_parity(results):
    """Kernel #4's paged and ``q_starts`` modes against
    ``decode_attention_plain`` at Llama-3-8B heads (Hq 32, Hkv 8, D 128):
    pages 4, 16, 32 and 64, shuffled tables with a scratch block, staggered
    per-row lengths, q_len 1-5, every combination of paged x ragged x
    int8-KV in bf16 and f32, and the shapes of the serve_engine runs (the
    8-token extend tail, per-slot decode and verify at page 32, max_len
    160), each run twice bit-identical; f32 at 4096 slots and q_len 5
    against the plain version in f64; then kernel #9 (RMSNorm) against its
    plain version at [1024, 4096] and [16384, 2048]."""
    import numpy as np
    import torch

    from tpu_nexus_torch.ops.decode_attention import decode_attention, decode_attention_plain, mode_name
    from tpu_nexus_torch.ops.rmsnorm import rms_norm, rms_norm_kernel

    # (B, page, q_len, n_log, per-row starts, logical_limit, (paged, ragged, int8) combinations)
    every = [(p, r, q) for p in (False, True) for r in (False, True) for q in (False, True) if p or r]
    cases = []

    def page_cases(page):
        for sq in (1, 3, 5):
            n_log = -(-(4096 if page == 32 and sq == 1 else 160) // page)
            rng = np.random.default_rng(page * 10 + sq)
            starts = rng.integers(0, n_log * page - sq, size=8).astype(np.int32)
            starts[0], starts[1] = 0, n_log * page - sq  # the shortest and the deepest row
            cases.append((8, page, sq, n_log, starts, None, every))

    for page in (4, 16, 32):
        page_cases(page)
    # the shapes the serve_engine runs give the kernel: page 32, max_len 160
    # (n_log 5) and logical_limit 160 — an admission's 8-token extend tail at
    # one start (q_len 8, kv_len 128; B 1 as the engine runs it, and B 8),
    # the per-slot decode of 8 slots and spec_k 4's verify (q_len 5)
    for bb in (1, 8):
        cases.append((bb, 32, 8, 5, np.full(bb, 120, np.int32), 160, [(True, False, False), (True, False, True)]))
    for sq, ragged in ((1, False), (5, True)):
        starts = np.random.default_rng(900 + sq).integers(0, 160 - sq, size=8).astype(np.int32)
        starts[0], starts[1] = 0, 160 - sq
        cases.append((8, 32, sq, 5, starts, 160, [(True, ragged, False), (True, ragged, True)]))
    page_cases(64)  # last, so the cases above keep their inputs (seeds follow the case order)

    worst = {"decode_attention_paged": 0.0, "decode_attention_ragged": 0.0}
    i = 0
    for b, page, sq, n_log, starts, limit, combos in cases:
        logical = n_log * page
        for paged, ragged, int8 in combos:
            for dtype in (torch.bfloat16, torch.float32):
                i += 1
                q, k, v, tables, scales = paged_case(b, sq, page, n_log, starts + sq, dtype, 6000 + i, int8)
                if not paged:
                    k, v = _gather_rows(k, tables), _gather_rows(v, tables)
                    scales = {n: _gather_rows(s, tables) for n, s in scales.items()}
                kv_len = int(starts.max()) + sq
                if ragged:
                    kw = dict(prompt_lengths=torch.zeros(b, dtype=torch.int32, device="cuda"), prompt_width=0,
                              q_starts=torch.from_numpy(starts).cuda())
                elif sq == 1:  # per-slot decode
                    kw = dict(prompt_lengths=torch.from_numpy(starts + 1).cuda(), prompt_width=logical)
                else:  # a shared-start extend
                    kw = {}
                if paged:
                    kw.update(block_tables=tables, logical_limit=limit)
                mode = mode_name(paged, ragged, int8)
                before = decode_attention.launches_by_mode[mode]
                out = decode_attention(q, k, v, kv_len, **scales, **kw)
                again = decode_attention(q, k, v, kv_len, **scales, **kw)
                torch.cuda.synchronize()
                ref = decode_attention_plain(q, k, v, kv_len, **scales, **kw)
                same = bool(torch.equal(out, again)) and decode_attention.launches_by_mode[mode] == before + 2
                err, ref_max, e_row = max_err(out, ref), float(ref.float().abs().max()), row_rel_err(out, ref)
                if dtype == torch.bfloat16:
                    ok = err <= TOL["bfloat16"][0] and e_row <= ROW_REL_TOL
                elif int8:
                    ok = err <= QUANT_F32_MAXABS_REL * ref_max
                else:
                    ok = err <= TOL["float32"][0]
                ok = ok and same and bool(torch.isfinite(out).all())
                emit("engine_parity", kernel="decode_attention", mode=mode, page=page, q_len=sq, b=b,
                     logical_len=logical, logical_limit=limit, kv_len=kv_len, dtype=str(dtype), max_abs_err=err,
                     ref_max_abs=ref_max, max_row_rel_err=e_row, bit_identical_twice=same, ok=ok)
                if not ok:
                    raise AssertionError(f"decode kernel mode {mode} disagrees with its plain version: "
                                         f"B {b} page {page} q_len {sq} kv_len {kv_len} {dtype}")
                if dtype == torch.bfloat16 and page == 32 and mode in ("paged", "paged+ragged"):
                    key = "decode_attention_" + ("ragged" if ragged else "paged")
                    worst[key] = max(worst[key], err)
                del q, k, v, tables, scales, out, again, ref
    # f32 at 4096 slots, q_len 5 (B4, pages 4 and 32): the kernel against the plain version
    # evaluated in f64, with the plain version's own f32 error beside it (at this depth it passes
    # the f32 limit, which the kernel stays inside)
    for page in (4, 32):
        starts = np.array([0, 7, 4096 - 7, 19], dtype=np.int32)
        q, k, v, tables, _ = paged_case(4, 5, page, 4096 // page, starts + 5, torch.float32, 6500 + page)
        kv_len = int(starts.max()) + 5
        out = decode_attention(q, k, v, kv_len, block_tables=tables)
        ref64 = decode_attention_plain(q.double(), k.double(), v.double(), kv_len, block_tables=tables)
        ref32 = decode_attention_plain(q, k, v, kv_len, block_tables=tables)
        err = float((out.double() - ref64).abs().max())
        plain_err = float((ref32.double() - ref64).abs().max())
        ok = err <= TOL["float32"][0] and bool(torch.isfinite(out).all())
        emit("engine_parity", kernel="decode_attention", mode="paged", page=page, q_len=5, b=4, kv_len=kv_len,
             dtype="torch.float32", reference="decode_attention_plain in f64", max_abs_err=err,
             plain_f32_max_abs_err=plain_err, tol=TOL["float32"][0], ok=ok)
        if not ok:
            raise AssertionError(f"f32 decode kernel at page {page}, 4096 slots, q_len 5: {err} from the f64 reference")
        del q, k, v, tables, out, ref64, ref32
    torch.cuda.empty_cache()

    worst["rms_norm"] = 0.0
    # the timed rows, H 8192 (eight warps a row), H 100 and 2056 (element accesses, a ragged warp), one
    # row, fewer rows than SMs, and a bf16 weight
    for rows, hidden, w_dtype in ((1024, 4096, torch.float32), (16384, 2048, torch.float32),
                                  (64, 8192, torch.float32), (37, 100, torch.float32), (1, 4096, torch.float32),
                                  (100, 2048, torch.float32), (7, 2056, torch.bfloat16),
                                  (1024, 4096, torch.bfloat16)):
        for dtype in (torch.bfloat16, torch.float32):
            g = torch.Generator(device="cuda").manual_seed(rows + hidden)
            x = (torch.randn((rows, hidden), generator=g, device="cuda") * 3).to(dtype)
            w = (torch.randn((hidden,), generator=g, device="cuda") + 1).to(w_dtype)
            before = rms_norm_kernel.launches
            out, again = rms_norm_kernel(x, w), rms_norm_kernel(x, w)
            torch.cuda.synchronize()
            ref = rms_norm(x, w)
            same = bool(torch.equal(out, again)) and rms_norm_kernel.launches == before + 2
            err, ref_max = max_err(out, ref), float(ref.float().abs().max())
            if dtype == torch.bfloat16:  # one rounding of the same f32 value apart: one bf16 ulp
                ok = bool(((out.float() - ref.float()).abs() <= 2**-7 * ref.float().abs()).all())
            else:
                ok = err <= 1e-5 * ref_max
            ok = ok and same and out.dtype == dtype
            emit("engine_parity", kernel="rms_norm", shape=[rows, hidden], dtype=str(dtype),
                 weight_dtype=str(w_dtype), max_abs_err=err,
                 ref_max_abs=ref_max, bit_identical_twice=same, tol="f32: 1e-5 x max|ref|; bf16: one ulp", ok=ok)
            if not ok:
                raise AssertionError(f"rms_norm kernel disagrees with its plain version: {rows}x{hidden} {dtype}")
            if dtype == torch.bfloat16 and rows == 16384 and w_dtype == torch.float32:
                worst["rms_norm"] = err
    results.setdefault("max_abs_err", {}).update(worst)


def engine_times(times):
    """Kernel #4's paged decode (B8, per-slot cursors at kv_len 144 and
    4096, page 32) and its ragged verify (B8, q_len 5, page 32, staggered
    starts, at kv_len 144 and 4096), cycling per-layer pools so K/V come
    from HBM; then kernel #9 (:func:`rms_times`).  ``bound_ms``: the live
    K/V bytes read once at 3.35 TB/s.  ``library_ms``:
    ``scaled_dot_product_attention`` on the pre-gathered contiguous cache
    with the boolean mask, which the port never calls."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from tpu_nexus_torch.ops.decode_attention import decode_attention, decode_attention_plain

    dt, b, page, hq, hkv, d = torch.bfloat16, 8, 32, 32, 8, 128
    for key, sq, kv_len, n_layers in (("decode_attention_paged", 1, 144, 32), (None, 1, 4096, 4),
                                      ("decode_attention_ragged", 5, 144, 32), (None, 5, 4096, 4)):
        n_log = -(-(kv_len + 16) // page)
        if sq == 1:  # every slot at cursor kv_len - 1
            starts = np.full(b, kv_len - 1, np.int32)
        else:  # verify windows at staggered cursors ending at or before kv_len
            starts = (kv_len - sq - np.arange(b) * 7).astype(np.int32)
        live = starts + sq
        layers = [paged_case(b, sq, page, n_log, live, dt, 7000 + i) for i in range(n_layers)]
        if sq == 1:
            kw = dict(prompt_lengths=torch.from_numpy(live).cuda(), prompt_width=n_log * page)
        else:
            kw = dict(prompt_lengths=torch.zeros(b, dtype=torch.int32, device="cuda"), prompt_width=0,
                      q_starts=torch.from_numpy(starts).cuda())
        deepest = int(live.max())
        kern = [lambda x=x: decode_attention(x[0], x[1], x[2], deepest, block_tables=x[3], **kw) for x in layers]
        plain = [lambda x=x: decode_attention_plain(x[0], x[1], x[2], deepest, block_tables=x[3], **kw)
                 for x in layers]
        # the yardstick: SDPA over each row's gathered contiguous view, masked to its live slots
        k_pos = torch.arange(deepest, device="cuda")
        row_last = torch.from_numpy(starts).cuda()[:, None] + torch.arange(sq, device="cuda")[None, :]
        mask = (k_pos[None, None, :] <= row_last[:, :, None])[:, None]  # [B, 1, sq, deepest]
        lib_sets = [(x[0].transpose(1, 2), _gather_rows(x[1], x[3])[:, :deepest].transpose(1, 2),
                     _gather_rows(x[2], x[3])[:, :deepest].transpose(1, 2)) for x in layers]
        lib = [lambda x=x: F.scaled_dot_product_attention(*x, attn_mask=mask, enable_gqa=True) for x in lib_sets]
        nbytes = (int(live.sum()) * hkv * d * 2 + 2 * b * sq * hq * d) * 2 + b * n_log * 4
        flops = 4 * hq * d * sq * int(live.sum())
        t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
        ms, enqueue_ms = timed(kern, iters=64)
        row = dict(shape=[b, sq, page, n_log, kv_len, hq, hkv, d], dtype="bfloat16", ms=ms, enqueue_ms=enqueue_ms,
                   plain_ms=cuda_ms(plain, iters=16), library_ms=cuda_ms(lib, iters=64),
                   bound_ms=max(t_ops, t_bytes), bound_by="operations" if t_ops > t_bytes else "bytes",
                   library_ms_is="scaled_dot_product_attention, pre-gathered contiguous cache with the mask")
        if key:
            times[key] = row
        emit("times", kernel="decode_attention_" + ("ragged" if sq > 1 else "paged"), **row)
        del layers, lib_sets, kern, plain, lib
        torch.cuda.empty_cache()

    rms_times(times)


def rms_times(times):
    """Kernel #9 at [16384, 2048] (the kernels line's row) and [1024, 4096]
    (Llama-3-8B's prefill rows at batch 8, prompt 128), bf16 x and an f32
    weight, cycling input copies over 128 MB so x comes from HBM.
    ``bound_ms``: x read and y written once, the weight read once, at 3.35
    TB/s.  ``library_ms``: ``torch.nn.functional.rms_norm`` with the weight
    in bf16 (it takes one dtype), which the port never calls."""
    import torch
    import torch.nn.functional as F

    from tpu_nexus_torch.ops.rmsnorm import rms_norm, rms_norm_kernel

    dt = torch.bfloat16
    library = getattr(F, "rms_norm", None)  # PyTorch >= 2.4
    for key, rows, hidden in (("rms_norm", 16384, 2048), ("rms_norm_1024x4096", 1024, 4096)):
        g = torch.Generator(device="cuda").manual_seed(7500)
        xs = [torch.randn((rows, hidden), generator=g, device="cuda").to(dt)
              for _ in range(max(4, -(-128 * 2**20 // (rows * hidden * 2))))]
        w = torch.randn((hidden,), generator=g, device="cuda") + 1
        w_lib = w.to(dt)
        nbytes = 2 * rows * hidden * 2 + hidden * 4
        ms, enqueue_ms = timed([lambda x=x: rms_norm_kernel(x, w) for x in xs], iters=64)
        row = dict(shape=[rows, hidden], dtype="bfloat16 x, f32 weight", ms=ms, enqueue_ms=enqueue_ms,
                   plain_ms=cuda_ms([lambda x=x: rms_norm(x, w) for x in xs], iters=32),
                   library_ms=(cuda_ms([lambda x=x: library(x, (hidden,), w_lib, 1e-5) for x in xs], iters=64)
                               if library is not None else None),
                   bound_ms=nbytes / PEAK_BYTES * 1e3, bound_by="bytes",
                   library_ms_is="torch.nn.functional.rms_norm, bf16 weight")
        times[key] = row
        emit("times", kernel=key, **row)
        del xs
        torch.cuda.empty_cache()


def phase_quant_rms_times(results):
    """Only kernel #6's and #9's timed rows and #5's control (``quant_times``
    and ``rms_times``): the opt-in phase that compares two trees of the
    package in one call, parent and change in turns."""
    times = results.setdefault("times", {})
    quant_times(times)
    rms_times(times)


def _engine_prompts(vocab, seed):
    """Prompts of the engine_e2e phase: varied lengths, repetitive ones (the
    ngram drafter's proposals get accepted), and a shared 100-token prefix
    with 5 distinct tokens each (prefix hits, COW, the kernel's extend)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    shared = rng.integers(0, vocab, size=100).astype(np.int32)
    prompts = [rng.integers(0, vocab, size=n).astype(np.int32) for n in (128, 77, 100)]
    prompts += [np.tile(rng.integers(0, vocab, size=8).astype(np.int32), 12)]
    prompts += [np.concatenate([shared, rng.integers(0, vocab, size=5).astype(np.int32)]) for _ in range(3)]
    return prompts


def phase_engine_e2e(results):
    """Llama-3-8B widths at 2 layers in f32, greedy: ``ServingEngine`` is
    token-identical to one-shot ``generate`` (per request) through the
    kernels and through the plain path — contiguous, paged (page 16),
    paged with int8-KV, speculative (spec_k 4, ngram, paged) and
    ``decode_steps`` 4 with overlap; the counters show the kernel modes
    each ran."""
    import torch

    from tpu_nexus_torch.models.generate import generate
    from tpu_nexus_torch.models.llama import LlamaConfig, llama_init
    from tpu_nexus_torch.ops.decode_attention import decode_attention, reset_launches
    from tpu_nexus_torch.serving import ModelExecutor, NGramDrafter, PagedModelExecutor, ServingEngine

    cfg = dataclasses.replace(LlamaConfig.llama3_8b(), n_layers=2, dtype=torch.float32, param_dtype=torch.float32)
    params = llama_init(torch.Generator(device="cuda").manual_seed(0), cfg, device="cuda")
    prompts = _engine_prompts(cfg.vocab_size, seed=2)
    new = 24
    refs = {}
    for impl in ("auto", "plain"):
        for kv_quant in ("", "int8"):
            refs[impl, kv_quant] = [
                generate(params, torch.from_numpy(p).cuda()[None], cfg, max_new_tokens=new, max_len=160,
                         kv_quant=kv_quant, attn_impl=impl, decode_kernel=impl)[0].tolist()
                for p in prompts
            ]
    cases = {
        "contiguous": dict(), "paged16": dict(page=16), "paged16_int8kv": dict(page=16, kv_quant="int8"),
        "spec4_ngram_paged16": dict(page=16, spec=4), "decode_steps4_overlap": dict(steps=4, overlap=True),
    }
    for name, case in cases.items():
        for impl in ("auto", "plain"):
            kw = dict(num_slots=3, max_len=160, kv_quant=case.get("kv_quant", ""), decode_kernel=impl, attn_impl=impl,
                      decode_steps=case.get("steps", 1))
            if case.get("page"):
                ex = PagedModelExecutor(params, cfg, page_size=case["page"], **kw)
            else:
                ex = ModelExecutor(params, cfg, **kw)
            spec = case.get("spec", 0)
            eng = ServingEngine(ex, spec_k=spec, drafter=NGramDrafter(3) if spec else None,
                                overlap=case.get("overlap", False))
            reset_launches()
            for i, p in enumerate(prompts):
                eng.submit(p, new, request_id=f"r{i}")
            eng.run_until_drained()
            torch.cuda.synchronize()
            modes = {m: n for m, n in decode_attention.launches_by_mode.items() if n}
            got = {r.request_id: [int(t) for t in r.output_tokens] for r in eng.retired}
            want = refs[impl, case.get("kv_quant", "")]
            mismatched = sum(got[f"r{i}"] != want[i] for i in range(len(prompts)))
            emit("engine_e2e", config=f"llama3_8b widths, 2 layers, f32: {name}", impl=impl, requests=len(prompts),
                 new_tokens=new, token_identical=mismatched == 0, mismatched_requests=mismatched,
                 decode_launches_by_mode=modes, prefix_hits=eng.metrics.prefix_hits,
                 spec_accepted=eng.metrics.spec_accepted)
            if mismatched:
                raise AssertionError(f"engine_e2e {name} ({impl}): {mismatched} requests differ from generate")
            if impl == "auto":
                need = {"contiguous": "contiguous", "paged16": "paged", "paged16_int8kv": "paged+int8",
                        "spec4_ngram_paged16": "paged+ragged", "decode_steps4_overlap": "contiguous"}[name]
                if not modes.get(need):
                    raise AssertionError(f"engine_e2e {name}: no {need} decode launch ({modes})")
            elif modes:
                raise AssertionError(f"engine_e2e {name}: the plain path launched {modes}")
            del eng, ex
    del params
    torch.cuda.empty_cache()


def _shared_prefix_prompts(vocab, batch, prompt_len, seed, shared_len=120):
    """An endless stream of [batch, prompt_len] rounds: one fixed random
    prefix of ``shared_len`` tokens, then distinct random tokens per row."""
    import numpy as np

    rng = np.random.default_rng(seed)
    shared = rng.integers(0, vocab, size=shared_len).astype(np.int32)
    while True:
        tail = rng.integers(0, vocab, size=(batch, prompt_len - shared_len)).astype(np.int32)
        yield np.concatenate([np.broadcast_to(shared, (batch, shared_len)), tail], axis=1)


def phase_serve_engine(results):
    """``run_serve_engine`` on llama3_8b at full width and depth, bf16: 8
    slots, prompt 128, 32 new tokens, 3 rounds (24 requests) plus the
    warm-up, into an in-memory ledger — (a) contiguous, (b) page 32 with
    prompts that share a 120-token prefix (8 distinct tokens each), so
    admissions hit the prefix index and run ``extend_step`` through the
    kernel's paged mode, (c) page 32 with spec_k 4 (ngram).  Each lands
    COMPLETED; the counters, zeroed just before each run, give kernel #4's
    launches by mode (``decode_attention_paged`` counts every launch on the
    paged layout, ``decode_attention_ragged`` every launch in the q_starts
    mode)."""
    import torch

    from tpu_nexus_torch.checkpoint.models import LifecycleStage
    from tpu_nexus_torch.checkpoint.store import InMemoryCheckpointStore
    from tpu_nexus_torch.models.llama import LlamaConfig
    from tpu_nexus_torch.ops.decode_attention import decode_attention, reset_launches
    from tpu_nexus_torch.ops.flash_attention import flash_attention
    from tpu_nexus_torch.parallel.distributed import ProcessContext
    from tpu_nexus_torch.workload.serve import ServeConfig, run_serve_engine

    model = dataclasses.replace(LlamaConfig.llama3_8b(), param_dtype=torch.bfloat16)
    runs = (("serve_engine_contiguous", {}, False), ("serve_engine_paged", dict(page_size=32), True),
            ("serve_engine_spec", dict(page_size=32, spec_k=4), False))
    for name, extra, shared in runs:
        torch.cuda.empty_cache()
        cfg = ServeConfig(model=model, batch_size=8, prompt_len=128, gen_tokens=32, rounds=3, device="cuda", **extra)
        prompts = _shared_prefix_prompts(model.vocab_size, 8, 128, seed=8) if shared else None
        store = InMemoryCheckpointStore()
        ctx = ProcessContext(run_id=name, algorithm="serve", process_id=0, num_processes=1, coordinator=None)
        torch.cuda.reset_peak_memory_stats()
        flash_attention.launches = 0
        reset_launches()
        zero_rms_norm_launches()
        t0 = time.perf_counter()
        summary = run_serve_engine(cfg, store=store, ctx=ctx, prompts=prompts)
        wall = time.perf_counter() - t0
        read_rms_norm_launches(results, name)
        modes = dict(decode_attention.launches_by_mode)
        # by flag: the paged layout (decode, extend and, with spec_k, verify)
        # and the q_starts mode (verify)
        launches = {"flash_attention": flash_attention.launches, "decode_attention": decode_attention.launches,
                    "decode_attention_paged": sum(n for m, n in modes.items() if m.startswith("paged")),
                    "decode_attention_ragged": sum(n for m, n in modes.items() if "ragged" in m)}
        row = store.read_checkpoint("serve", name)
        stage = row.lifecycle_stage if row else None
        keys = ("requests", "finished", "engine_steps", "elapsed_s", "decoded_tokens_per_second", "ttft_p50_s",
                "ttft_p99_s", "tpot_p50_s", "tpot_p99_s", "prefix_hits", "prefix_shared_tokens", "blocks_cow",
                "spec_proposed", "spec_accepted", "spec_acceptance_rate")
        emit("serve_engine", run=name, config=f"llama3_8b full width and depth, bf16 params, {extra or 'contiguous'}",
             stage=stage, per_chip_steps=row.per_chip_steps if row else None, wall_s=wall,
             max_memory_allocated=torch.cuda.max_memory_allocated(), launches=launches,
             decode_launches_by_mode={m: n for m, n in modes.items() if n}, **{k: summary[k] for k in keys})
        if stage != LifecycleStage.COMPLETED or summary["finished"] != 24:
            raise AssertionError(f"{name}: ledger row is {stage}, {summary['finished']} of 24 finished")
        if extra.get("page_size") and not launches["decode_attention_paged"]:
            raise AssertionError(f"{name}: no paged decode launch ({modes})")
        if extra.get("spec_k") and not launches["decode_attention_ragged"]:
            raise AssertionError(f"{name}: no ragged (q_starts) launch ({modes})")
        if shared and not summary["prefix_hits"]:
            raise AssertionError(f"{name}: no prefix hit")
        if not extra and (modes["contiguous"] < model.n_layers * summary["engine_steps"]):
            raise AssertionError(f"{name}: {modes['contiguous']} contiguous launches < layers x steps")
        results.setdefault("launches", {})[name] = launches


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument(
        "--phases", default=",".join(PHASES),
        help="comma-separated phases among " + ",".join(PHASES + OPT_IN) + " (default: all but the opt-in "
        + ",".join(OPT_IN) + ")",
    )
    args = parser.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(PHASES) - set(OPT_IN)
    if unknown:
        parser.error(f"unknown phases {sorted(unknown)}")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; nothing to test", file=sys.stderr)
        return 2
    if not (ROOT / "tpu_nexus_torch" / "csrc").is_dir():
        print(f"chip_smoke: no tpu_nexus_torch package beside {__file__}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from tpu_nexus_torch.ops import _build

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    emit("device", name=kind, count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda,
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)

    results = {}
    if "build" in phases:
        t0 = time.perf_counter()
        _build.library()
        emit("build", seconds=time.perf_counter() - t0, library=str(_build.library_path().name),
             sources=[str(p.relative_to(ROOT)) for p in _build.sources()],
             **hopper_kernel_resources(_build))
    runners = {
        "parity": phase_parity, "train_parity": phase_train_parity, "times": phase_times,
        "e2e": phase_e2e, "train_e2e": phase_train_e2e, "serve": phase_serve, "serve_quant": phase_serve_quant,
        "train": phase_train, "moe_parity": phase_moe_parity, "moe_train_e2e": phase_moe_train_e2e,
        "serve_moe": phase_serve_moe, "train_moe": phase_train_moe,
        "engine_parity": phase_engine_parity, "engine_e2e": phase_engine_e2e, "serve_engine": phase_serve_engine,
        "profile": phase_profile, "train_profile": phase_train_profile,
        "train_moe_profile": phase_train_moe_profile, "decode_probe": phase_decode_probe,
        "profile_int8": lambda r: phase_profile(r, "int8", "int8"),
        "profile_int4": lambda r: phase_profile(r, "int4", ""),
        "quant_rms_times": phase_quant_rms_times, "int4_probe": phase_int4_probe, "int8_probe": phase_int8_probe,
    }
    for name in PHASES + OPT_IN:
        if name in runners and name in phases:
            t0 = time.perf_counter()
            runners[name](results)
            emit(name + "_done", seconds=time.perf_counter() - t0)

    if set(PHASES) <= set(phases):
        # (source, TPU kernel it replaces, the main path whose run counts it)
        meta = {
            "flash_attention": ("tpu_nexus_torch/csrc/flash_attention.cu",
                                "tpu_nexus/ops/flash_attention.py:127", "train"),
            "flash_attention_bwd_dq": ("tpu_nexus_torch/csrc/flash_attention_bwd.cu",
                                       "tpu_nexus/ops/flash_attention.py:242", "train"),
            "flash_attention_bwd_dkv": ("tpu_nexus_torch/csrc/flash_attention_bwd.cu",
                                        "tpu_nexus/ops/flash_attention.py:297", "train"),
            "decode_attention": ("tpu_nexus_torch/csrc/decode_attention.cu",
                                 "tpu_nexus/ops/decode_attention.py:125", "serve"),
            "decode_attention_int8kv": ("tpu_nexus_torch/csrc/decode_attention.cu",
                                        "tpu_nexus/ops/decode_attention.py:125", "serve_int8"),
            "quant_matmul_int8": ("tpu_nexus_torch/csrc/quant_matmul.cu",
                                  "tpu_nexus/ops/quant_matmul.py:131", "serve_int8"),
            "quant_matmul_int4": ("tpu_nexus_torch/csrc/quant_matmul.cu",
                                  "tpu_nexus/ops/quant_matmul.py:154", "serve_int4"),
            "nexus_gmm": ("tpu_nexus_torch/csrc/grouped_matmul.cu",
                          "tpu_nexus/ops/grouped_matmul.py:68", "train_moe"),
            "nexus_tgmm": ("tpu_nexus_torch/csrc/grouped_matmul.cu",
                           "tpu_nexus/ops/grouped_matmul.py:84", "train_moe"),
            # kernel #4's paged mode (decode, extend) and its paged + q_starts
            # mode (speculative verify), on the serve-engine runs
            "decode_attention_paged": ("tpu_nexus_torch/csrc/decode_attention.cu",
                                       "tpu_nexus/ops/decode_attention.py:125", "serve_engine_paged"),
            "decode_attention_ragged": ("tpu_nexus_torch/csrc/decode_attention.cu",
                                        "tpu_nexus/ops/decode_attention.py:125", "serve_engine_spec"),
            # kernel #9: no path of the JAX package launches it; its launches
            # are summed over every main-path run of this script
            "rms_norm": ("tpu_nexus_torch/csrc/rmsnorm.cu", "tpu_nexus/ops/rmsnorm.py:27", None),
        }
        kernels = []
        whole_bwd = results["times"]["flash_attention_bwd"]
        for name, (source, replaces, path) in meta.items():
            t = results["times"][name]
            by_path = ({p: n[name] for p, n in results["launches"].items() if name in n} if path
                       else results["rms_norm_launches"])
            entry = {
                "name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": results["launches"][path][name] if path else sum(by_path.values()),
                "launches_by_path": by_path,
                "max_abs_err": results["max_abs_err"][name],
                "ms": t["ms"], "enqueue_ms": t["enqueue_ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": t["library_ms"], "shape": t["shape"],
            }
            if name in ("flash_attention", "flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
                entry.update(design="wgmma+tma")
            if name in ("nexus_gmm", "nexus_tgmm"):
                entry.update(design="wgmma+tma, persistent")
            if name.startswith("decode_attention"):
                entry.update(design="wgmma+cp.async ring, merge in the launch")
            if name in ("quant_matmul_int8", "quant_matmul_int4"):
                entry.update(design="stream-K, TMA ring fed by a producer warp, mma.sync, merge in the launch",
                             other_shapes={k: {f: results["times"][k][f] for f in ("shape", "ms", "bound_ms",
                                                                                    "library_ms")}
                                           for k in (f"{name}_down", f"{name}_wq", f"{name}_wk")})
            if name == "rms_norm":
                entry.update(design="16-byte vector streams, persistent, next row prefetched",
                             other_shapes={"rms_norm_1024x4096": {f: results["times"]["rms_norm_1024x4096"][f]
                                                                  for f in ("shape", "ms", "bound_ms",
                                                                            "library_ms")}})
            if name == "nexus_gmm":
                entry.update(library_ms_is=t["library_ms_is"],
                             mixtral_8x7b_gate={k: results["times"]["nexus_gmm_mixtral"][k]
                                                for k in ("shape", "ms", "bound_ms", "plain_ms", "library_ms")})
            if name in ("nexus_tgmm", "decode_attention_paged", "decode_attention_ragged", "rms_norm"):
                entry.update(library_ms_is=t["library_ms_is"])
            if path is None:
                entry.update(on_a_main_path=False)
            if name.startswith("flash_attention_bwd"):
                # plain_ms and library_ms are of the whole backward; so is this pair
                entry.update(bound_matmuls=t["bound_matmuls"], backward_ms=whole_bwd["ms"],
                             backward_wrapper_ms=whole_bwd["wrapper_ms"], backward_bound_ms=whole_bwd["bound_ms"])
            kernels.append(entry)
        print(json.dumps({"kernels": kernels}), flush=True)
    emit("total", seconds=time.perf_counter() - t_start)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
