"""The port's benchmark: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything is found by name: the cell in ``BENCHMARK.json``, its
configuration file, ``traffic/<mix>.json``, the driver of the mix's
``kind`` (``drive_<kind>.py``), ``limits/<cell>.json`` and, with
``--trace 1``, ``metrics/<metric>.py`` for each per-layer metric the cell
reports.  The run makes its weights and traffic from the seed, warms
up, measures for ``--seconds``, checks what the timed path produced against
the plain reference and prints one JSON line last on standard output.
"""

from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

_HERE = Path(__file__).resolve().parent
if sys.path and Path(sys.path[0]).resolve() == _HERE:
    sys.path.pop(0)
sys.path.insert(0, str(_HERE.parent))

from benchmark import common  # noqa: E402


def _traced_records(ctx, w, traced) -> dict:
    """What the per-layer readers read: the parsed trace of the profiled
    steps, the window's own numbers and what the driver adds of the traced
    steps."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        traced["prof"].export_chrome_trace(path)
        trace = common.read_trace(path)
    finally:
        os.unlink(path)
    rec = {k: v for k, v in traced.items() if k not in ("prof", "window_s")}
    rec.update(kind=ctx["traffic"]["kind"], config=ctx["config"], traffic=ctx["traffic"], trace=trace,
               traced_window_s=traced["window_s"], window=w)
    return rec


def run_cell(ctx, seed: int, seconds: float, trace: bool, device, hooks: dict = None) -> dict:
    """Set-up, window, per-layer reading and check of one run; returns the
    result's fields.  The mix's ``kind`` names the driver,
    ``drive_<kind>.py``.  ``hooks`` break the timed path underneath
    (tests)."""
    import torch

    hooks = hooks or {}
    driver = common.driver(ctx["traffic"]["kind"])
    on_card = torch.device(device).type == "cuda"
    setup = driver.setup(ctx, seed, device, hooks)
    setup_s = time.monotonic() - hooks.get("t_start", T_START)
    w = driver.window(setup, ctx, seconds, device)
    dev = common.device_info(ctx["cell"]["chips"]) if on_card else {"platform": "cpu", "count": 1}

    metrics, extra = {}, {}
    if not trace:
        values = dict(setup_s=setup_s, **{k: w[k] for k in w if isinstance(w[k], float)})
        for m in ctx["end_to_end"]:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        rec = _traced_records(ctx, w, driver.traced(setup, ctx, device))
        dev["busy_s"] = rec["trace"]["busy_s"]
        dev["window_s"] = rec["traced_window_s"]
        for m in ctx["per_layer"]:
            value = common.load_reader(m["name"])(rec)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        extra["breakdown"] = common.breakdown(rec["trace"])
        del rec

    # the program's state goes before the reference runs
    kept = driver.after_window(setup, w)
    del setup, w
    common.free(on_card)
    numbers, attempted, failed = driver.check(kept, ctx, seed, device)
    lim = ctx["limits"]
    compared = {k: numbers[k] for k in lim if k != "ref_steps"}
    checks = {k: {"value": v, "limit": lim[k]} for k, v in compared.items()}
    correct = all(v == v and v <= lim[k] for k, v in compared.items())
    return {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics,
            "device": dev, "checks": checks, "extra": extra, "readings": numbers}


def main(argv=None) -> int:
    common.keep_environment()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    ctx = common.find_cell(args.workload)
    common.require_cards(ctx["cell"]["chips"])
    print(f"benchmark: {args.workload} seed {args.seed} on {common.power_limit()}", file=sys.stderr)
    out = run_cell(ctx, args.seed, args.seconds, bool(args.trace), "cuda:0")
    found = common.forbidden_modules()
    if found:
        print(f"benchmark: the process holds {', '.join(found)}", file=sys.stderr)
        return 4
    common.emit(out["correct"], out["attempted"], out["failed"], out["metrics"], out["device"], out["checks"],
                out["extra"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
