"""What every cell's run shares: the cell's files found by name, the
environment a run keeps to, the port's configuration object built from a
configuration file, the device's description, the profiler trace read back
and the result line."""

from __future__ import annotations

import gzip
import json
import os
import subprocess
import sys
from pathlib import Path
from typing import Any, Dict, List, Optional

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent
#: top-level module names the benchmark's process may never hold
FORBIDDEN = ("jax", "jaxlib", "flax", "tpu_nexus")


def keep_environment() -> None:
    """Build and kernel caches at fixed paths inside the checkout, one host
    thread for tensor work, and no library loading JAX behind the port's
    back.  Call before importing torch."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CHECKOUT / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CHECKOUT / "build" / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    # one process with few threads: the host loop is single-threaded, and
    # an OpenMP pool on the host's small tensor work only adds jitter
    os.environ["OMP_NUM_THREADS"] = "1"
    os.environ["MKL_NUM_THREADS"] = "1"


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def find_cell(name: str) -> Dict[str, Any]:
    """The cell ``name`` of ``BENCHMARK.json`` with its configuration,
    traffic mix, limits and the per-layer metrics it reports."""
    manifest = load_json(CHECKOUT / "BENCHMARK.json")
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; known: {sorted(cells)}")
    cell = cells[name]
    config = next(c for c in manifest["configs"] if c["name"] == cell["config"])
    return {
        "cell": cell,
        "config": load_json(CHECKOUT / config["file"]),
        "traffic": load_json(HERE / "traffic" / f"{cell['traffic']}.json"),
        "limits": load_json(HERE / "limits" / f"{name}.json"),
        "end_to_end": [m for m in manifest["end_to_end"] if name in m.get("workloads", [name])],
        "per_layer": [m for m in manifest["per_layer"] if name in m.get("workloads", [name])],
    }


def port_config(cfg: Dict):
    """The port's model configuration for a configuration file."""
    import torch

    from tpu_nexus_torch.models.llama import LlamaConfig
    from tpu_nexus_torch.models.moe import MoeConfig

    dt = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    run = cfg["run"]
    common = dict(
        vocab_size=cfg["vocab_size"], hidden=cfg["hidden_size"], n_layers=cfg["num_hidden_layers"],
        n_heads=cfg["num_attention_heads"], n_kv_heads=cfg["num_key_value_heads"],
        head_dim=cfg.get("head_dim") or cfg["hidden_size"] // cfg["num_attention_heads"],
        intermediate=cfg["intermediate_size"], rope_theta=float(cfg["rope_theta"]),
        norm_eps=cfg["rms_norm_eps"], max_seq_len=run["max_seq_len"], dtype=dt[run["dtype"]],
        param_dtype=dt[run["param_dtype"]], tied_embeddings=cfg.get("tie_word_embeddings", False),
        remat_policy=run.get("remat_policy", "dots"),
    )
    if cfg["family"] == "moe":
        return MoeConfig(
            n_experts=cfg["num_local_experts"], experts_per_token=cfg["num_experts_per_tok"],
            load_balance_coef=cfg["router_aux_loss_coef"], router_z_coef=run.get("router_z_coef", 0.0),
            dispatch=run.get("dispatch", "scatter"), **common,
        )
    return LlamaConfig(**common)


def require_cards(n: int) -> None:
    """Exit non-zero, printing no result, without ``n`` CUDA cards."""
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: needs {n} CUDA card(s), found {count}", file=sys.stderr)
        raise SystemExit(3)


def forbidden_modules() -> List[str]:
    """Top-level names in ``sys.modules`` that the run may not hold, each
    compared whole (``tpu_nexus_torch`` is not ``tpu_nexus``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def device_info(count: int) -> Dict[str, Any]:
    import torch

    return {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": count,
        "memory_peak_bytes": int(max(torch.cuda.max_memory_allocated(i) for i in range(count))),
    }


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def read_trace(path: str) -> Dict[str, Any]:
    """A ``torch.profiler`` Chrome trace read back: every device event
    (kernels, copies, sets) with the CPU operator that launched it (by
    External id: its name, input dims and types), the busy seconds (the
    union of device intervals), the idle gaps between them and the
    benchmark's host spans."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X" and "dur" in e]
    ops = {}
    for e in events:
        if e.get("cat") == "cpu_op":
            ext = e.get("args", {}).get("External id")
            if ext is not None:
                ops[ext] = e
    device = []
    for e in events:
        if e.get("cat") not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        op = ops.get(e.get("args", {}).get("External id"), {})
        a = op.get("args", {})
        device.append({"name": e["name"], "cat": e["cat"], "ts": e["ts"], "dur": e["dur"],
                       "op": op.get("name", ""), "dims": a.get("Input Dims"), "types": a.get("Input type")})
    device.sort(key=lambda d: d["ts"])
    spans = [{"name": e["name"], "start": e["ts"], "end": e["ts"] + e["dur"]} for e in events
             if e.get("cat") == "user_annotation" and e["name"].startswith("bench.")]
    busy, end = 0.0, None
    gaps = []
    for d in device:
        lo, hi = d["ts"], d["ts"] + d["dur"]
        if end is None or lo > end:
            if end is not None:
                gaps.append((end, lo))
            busy += hi - lo
            end = hi
        elif hi > end:
            busy += hi - end
            end = hi
    return {"device": device, "busy_s": busy / 1e6, "gaps": gaps, "spans": spans}


def breakdown(trace: Dict[str, Any]) -> Dict[str, List]:
    """The ten device operations that took most time, and the ten longest
    idle gaps, each named by the innermost of the benchmark's host spans
    that held its middle."""
    by_name: Dict[str, float] = {}
    for d in trace["device"]:
        by_name[d["name"][:120]] = by_name.get(d["name"][:120], 0.0) + d["dur"] / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(trace["gaps"], key=lambda g: g[0] - g[1])[:10]
    named = []
    for lo, hi in gaps:
        mid = (lo + hi) / 2
        held = [s for s in trace["spans"] if s["start"] <= mid <= s["end"]]
        label = min(held, key=lambda s: s["end"] - s["start"])["name"] if held else "outside the spans"
        named.append([label, (hi - lo) / 1e6])
    return {"device_ops": [[n, s] for n, s in top], "idle_gaps": named}


def free(on_card: bool) -> None:
    """Collect what the program left and give the card its memory back."""
    import gc

    gc.collect()
    if on_card:
        import torch

        torch.cuda.empty_cache()


def driver(kind: str):
    """The driver of a mix's ``kind``: ``drive_<kind>.py``, with
    ``setup``, ``window``, ``traced``, ``after_window``, ``check``,
    ``control`` and ``FAULTS``."""
    import importlib

    return importlib.import_module(f"benchmark.drive_{kind}")


def load_reader(metric: str):
    """The per-layer metric's reader, ``metrics/<name>.py``'s ``read``."""
    import importlib.util

    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def emit(correct: bool, attempted: int, failed: int, metrics: Dict[str, Dict], device: Dict,
         checks: Dict[str, Dict], extra: Optional[Dict] = None) -> None:
    """The result: each compared number beside its limit as the last lines
    of standard error, then the one JSON line last on standard output, its
    ``checks`` key last."""
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    out = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics, "device": device}
    if extra:
        out.update(extra)
    out["checks"] = checks
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
