"""Device events of a read-back trace, picked by kernel name or by the
operator that launched them (``common.read_trace``)."""

from __future__ import annotations

from typing import Dict, Iterable, List

MATMUL_OPS = ("aten::mm", "aten::bmm", "aten::addmm", "aten::baddbmm")


def kernels(trace: Dict, *parts: str) -> List[Dict]:
    """Kernels whose name holds any of ``parts``."""
    return [d for d in trace["device"] if d["cat"] == "kernel" and any(p in d["name"] for p in parts)]


def device_ms(events: Iterable[Dict]) -> float:
    return sum(d["dur"] for d in events) / 1e3


def f32_gemms(trace: Dict) -> List[Dict]:
    """Kernels of matrix products over float32 operands: launched by a
    matmul operator whose first input is float32, or, where the trace names
    no operator, a cuBLAS kernel named for single precision."""
    out = []
    for d in trace["device"]:
        if d["cat"] != "kernel":
            continue
        if d["op"]:
            if d["op"] in MATMUL_OPS and d["types"] and d["types"][0] == "float":
                out.append(d)
        elif "sgemm" in d["name"] or "f32f32_f32f32" in d["name"] or "nvjet_sss" in d["name"]:
            out.append(d)
    return out
