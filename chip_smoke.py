#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``tpu_nexus_torch``) on one GPU.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py                      # every phase
    python3 chip_smoke.py --phases build,parity  # a subset, for quick checks

Phases, one JSON line each; any failure raises and exits non-zero:

1. device  — the card's name, count and power limit; TF32 is switched off
   for matmuls and cuDNN so f32 comparisons mean f32.
2. build   — compile the CUDA kernels from ``tpu_nexus_torch/csrc``.
3. parity  — each kernel against its plain PyTorch version at the serving
   path's shapes (Llama-3-8B heads: Hq 32, Hkv 8, D 128), bf16 and f32.
4. times   — per-launch time (CUDA events), the bound, the plain version's
   time and the ``library_ms`` yardstick (``scaled_dot_product_attention``,
   timed here only; the port never calls it).
5. e2e     — Llama-3-8B widths at 2 layers in f32: greedy ``generate``
   with the kernels is token-identical to ``generate`` with the plain
   versions.
6. serve   — ``run_serving`` on ``llama3_8b`` at full width and depth with
   bf16 params (batch 8, prompt 128, 32 new tokens, 3 rounds) into an
   in-memory ledger; the launch counters, zeroed just before, show the
   path went through both kernels.

Opt-in: ``profile`` — one warm ``generate`` round of the serve shape under
``torch.profiler``: device time by kernel group and the device's busy
share (``python3 chip_smoke.py --phases build,profile``).

Then a ``{"kernels": [...]}`` line, the card's ``nvidia-smi`` name and
power limit, and last ``{"ok": true, "device": {...}}``.  Without a CUDA
device, or without the repository's ``tpu_nexus_torch`` beside it, it
exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PHASES = ("device", "build", "parity", "times", "e2e", "serve")
#: phases run only when named in --phases
OPT_IN = ("profile",)
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


def cuda_ms(fns, iters: int = 40, warmup: int = 4) -> float:
    """Mean ms per call over ``iters`` calls, cycling through ``fns`` (one
    closure per input copy, so a working set larger than L2 stays cold the
    way a per-layer caller finds it)."""
    import torch

    for i in range(warmup):
        fns[i % len(fns)]()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fns[i % len(fns)]()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def row_rel_err(out, ref) -> float:
    """Worst relative L2 error over the last (head_dim) axis."""
    diff = (out.float() - ref.float()).norm(dim=-1)
    return float((diff / ref.float().norm(dim=-1).clamp_min(1e-30)).max())


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


def phase_parity(results):
    import torch

    from tpu_nexus_torch.ops.decode_attention import decode_attention, decode_attention_plain
    from tpu_nexus_torch.ops.flash_attention import flash_attention, flash_attention_plain

    worst = {"flash_attention": 0.0, "decode_attention": 0.0}
    flash_cases = [  # (B, S, Hq, Hkv, D, dtype, causal)
        (8, 128, 32, 8, 128, torch.bfloat16, True),
        (1, 2048, 32, 8, 128, torch.bfloat16, True),
        (1, 200, 32, 8, 128, torch.bfloat16, True),
        (2, 256, 32, 8, 64, torch.bfloat16, True),
        (2, 128, 32, 8, 128, torch.bfloat16, False),
        (8, 128, 32, 8, 128, torch.float32, True),
        (1, 2048, 32, 8, 128, torch.float32, True),
        (1, 200, 32, 8, 128, torch.float32, True),
        (2, 256, 32, 8, 64, torch.float32, False),
    ]
    for i, (b, s, hq, hkv, d, dtype, causal) in enumerate(flash_cases):
        q, k, v = flash_inputs(b, s, hq, hkv, d, dtype, seed=10 + i)
        out, lse = flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        ref_out, ref_lse = flash_attention_plain(q, k, v, causal=causal)
        e_out, e_lse = max_err(out, ref_out), max_err(lse, ref_lse)
        e_row = row_rel_err(out, ref_out)
        tol_out, tol_lse = TOL[str(dtype).split(".")[-1]]
        tol_row = ROW_REL_TOL if dtype == torch.bfloat16 else None
        ok = (e_out <= tol_out and e_lse <= tol_lse and (tol_row is None or e_row <= tol_row)
              and bool(torch.isfinite(out).all()))
        emit("parity", kernel="flash_attention", shape=[b, s, hq, hkv, d], dtype=str(dtype),
             causal=causal, max_abs_err_out=e_out, max_abs_err_lse=e_lse, max_row_rel_err=e_row,
             tol_out=tol_out, tol_lse=tol_lse, tol_row_rel=tol_row, ok=ok)
        if not ok:
            raise AssertionError(f"flash_attention kernel disagrees with its plain version: {b, s, d, dtype}")
        if dtype == torch.bfloat16 and d == 128 and causal and s == 128:
            worst["flash_attention"] = max(worst["flash_attention"], e_out)

    decode_cases = []  # (B, q_len, max_len, kv_len, ragged, dtype)
    for max_len, kv_lens in ((160, (4, 100, 160)), (4096, (129, 2000, 4096))):
        for sq in (1, 4):
            for kv_len in kv_lens:
                decode_cases.append((8, sq, max_len, kv_len, False, torch.bfloat16))
        decode_cases.append((8, 1, max_len, max_len // 2 + 7, True, torch.bfloat16))
        decode_cases.append((8, 4, max_len, max_len - 3, True, torch.float32))
        decode_cases.append((8, 1, max_len, max_len, False, torch.float32))
    for i, (b, sq, max_len, kv_len, ragged, dtype) in enumerate(decode_cases):
        q, k, v = decode_inputs(b, sq, max_len, 32, 8, 128, dtype, seed=100 + i)
        lens = width = None
        if ragged:
            width = max_len // 2
            g = torch.Generator(device="cuda").manual_seed(500 + i)
            lens = torch.randint(1, width + 1, (b,), generator=g, device="cuda", dtype=torch.int32)
        out = decode_attention(q, k, v, kv_len, lens, width)
        torch.cuda.synchronize()
        ref = decode_attention_plain(q, k, v, kv_len, lens, width)
        err, e_row = max_err(out, ref), row_rel_err(out, ref)
        tol = TOL[str(dtype).split(".")[-1]][0]
        tol_row = ROW_REL_TOL if dtype == torch.bfloat16 else None
        ok = err <= tol and (tol_row is None or e_row <= tol_row) and bool(torch.isfinite(out).all())
        emit("parity", kernel="decode_attention", b=b, q_len=sq, max_len=max_len, kv_len=kv_len,
             ragged=ragged, dtype=str(dtype), max_abs_err=err, max_row_rel_err=e_row, tol=tol,
             tol_row_rel=tol_row, ok=ok)
        if not ok:
            raise AssertionError(f"decode_attention kernel disagrees with its plain version: {decode_cases[i]}")
        if dtype == torch.bfloat16 and max_len == 160 and sq == 1:
            worst["decode_attention"] = max(worst["decode_attention"], err)
    results["max_abs_err"] = worst


def phase_times(results):
    import torch
    import torch.nn.functional as F

    from tpu_nexus_torch.ops.decode_attention import decode_attention, decode_attention_plain
    from tpu_nexus_torch.ops.flash_attention import flash_attention, flash_attention_plain

    times = {}
    # prefill: the serve phase's shape, one input set per layer-sized copy
    b, s, hq, hkv, d, dt = 8, 128, 32, 8, 128, torch.bfloat16
    sets = [flash_inputs(b, s, hq, hkv, d, dt, seed=900 + i) for i in range(8)]
    kern = [lambda x=x: flash_attention(*x, causal=True) for x in sets]
    plain = [lambda x=x: flash_attention_plain(*x, causal=True) for x in sets]
    lib_sets = [(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)) for q, k, v in sets]
    lib = [lambda x=x: F.scaled_dot_product_attention(*x, is_causal=True, enable_gqa=True) for x in lib_sets]
    bound, by = flash_bound(b, s, hq, hkv, d, dt)
    times["flash_attention"] = dict(
        shape=[b, s, hq, hkv, d], dtype="bfloat16", ms=cuda_ms(kern), plain_ms=cuda_ms(plain),
        library_ms=cuda_ms(lib), bound_ms=bound, bound_by=by,
    )
    emit("times", kernel="flash_attention", **times["flash_attention"])
    # a long prompt, where the tensor cores have work to do
    b2, s2 = 1, 2048
    x = flash_inputs(b2, s2, hq, hkv, d, dt, seed=950)
    xl = tuple(t.transpose(1, 2) for t in x)
    bound2, by2 = flash_bound(b2, s2, hq, hkv, d, dt)
    emit("times", kernel="flash_attention", shape=[b2, s2, hq, hkv, d], dtype="bfloat16",
         ms=cuda_ms([lambda: flash_attention(*x, causal=True)], iters=20),
         plain_ms=cuda_ms([lambda: flash_attention_plain(*x, causal=True)], iters=10),
         library_ms=cuda_ms([lambda: F.scaled_dot_product_attention(*xl, is_causal=True, enable_gqa=True)], iters=20),
         bound_ms=bound2, bound_by=by2)

    # decode: the serve phase's step (B 8, q_len 1, cache 160 = 128 + 32) at
    # its mean live length, cycling 32 per-layer caches so K/V come from HBM
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
        row = dict(
            shape=[b, 1, max_len, kv_len, hq, hkv, d], dtype="bfloat16", ms=cuda_ms(kern, iters=64),
            plain_ms=cuda_ms(plain, iters=32), library_ms=cuda_ms(lib, iters=64),
            bound_ms=bound, bound_by=by,
        )
        if key:
            times[key] = row
        emit("times", kernel="decode_attention", **row)
        del layers, lib_sets
    results["times"] = times


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
    del params


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
    t0 = time.perf_counter()
    summary = run_serving(cfg, store=store, ctx=ctx)
    wall = time.perf_counter() - t0
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
    results["launches"] = launches


def phase_profile(results):
    """Opt-in (``--phases build,profile``): one warm ``generate`` round of
    the serve phase's shape under ``torch.profiler``; device time by
    kernel group and the device's busy share of the window."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tpu_nexus_torch.models.generate import generate
    from tpu_nexus_torch.models.llama import LlamaConfig, llama_init
    from tpu_nexus_torch.workload.data import synthetic_tokens

    cfg = dataclasses.replace(LlamaConfig.llama3_8b(), param_dtype=torch.bfloat16)
    params = llama_init(torch.Generator(device="cuda").manual_seed(0), cfg, device="cuda")
    prompts = synthetic_tokens(8, 128, cfg.vocab_size, seed=101)
    generate(params, torch.as_tensor(next(prompts), device="cuda"), cfg, max_new_tokens=32)
    batch = torch.as_tensor(next(prompts), device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    generate(params, batch, cfg, max_new_tokens=32)
    torch.cuda.synchronize()
    plain_wall_ms = (time.perf_counter() - t0) * 1e3  # the same round, no profiler
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        generate(params, batch, cfg, max_new_tokens=32)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    groups, top = {}, []
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "self_cuda_time_total", 0.0)
        if not dev_us or "cuda" not in str(getattr(evt, "device_type", "")).lower():
            continue
        name = evt.key
        low = name.lower()
        if "flash_fwd" in low:
            group = "flash_attention kernel"
        elif "decode_partial" in low or "decode_combine" in low:
            group = "decode_attention kernel"
        elif any(s in low for s in ("nvjet", "gemm", "xmma", "cutlass", "cublas", "sm90")):
            group = "matmul (cuBLAS)"
        else:
            group = "other (elementwise, copies, reductions)"
        groups[group] = groups.get(group, 0.0) + dev_us / 1e3
        top.append((dev_us / 1e3, evt.count, name[:90]))
    top.sort(reverse=True)
    device_ms = sum(groups.values())
    emit("profile", config="llama3_8b full depth, bf16 params; one generate round: batch 8, prompt 128, "
         "32 new tokens", wall_ms=wall_ms, unprofiled_wall_ms=plain_wall_ms, device_ms=device_ms,
         device_busy_share=device_ms / wall_ms, idle_share=1 - device_ms / wall_ms,
         busy_share_of_unprofiled_round=device_ms / plain_wall_ms,
         groups_ms=groups, top=[{"ms": t, "calls": c, "name": n} for t, c, n in top[:12]])
    del params


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
             sources=[str(p.relative_to(ROOT)) for p in _build.sources()])
    runners = {
        "parity": phase_parity, "times": phase_times, "e2e": phase_e2e, "serve": phase_serve,
        "profile": phase_profile,
    }
    for name in PHASES + OPT_IN:
        if name in runners and name in phases:
            t0 = time.perf_counter()
            runners[name](results)
            emit(name + "_done", seconds=time.perf_counter() - t0)

    if set(PHASES) <= set(phases):
        meta = {
            "flash_attention": ("tpu_nexus_torch/csrc/flash_attention.cu", "tpu_nexus/ops/flash_attention.py:127"),
            "decode_attention": ("tpu_nexus_torch/csrc/decode_attention.cu", "tpu_nexus/ops/decode_attention.py:125"),
        }
        kernels = []
        for name, (source, replaces) in meta.items():
            t = results["times"][name]
            kernels.append({
                "name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": results["launches"][name], "max_abs_err": results["max_abs_err"][name],
                "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            })
        print(json.dumps({"kernels": kernels}), flush=True)
    emit("total", seconds=time.perf_counter() - t_start)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
