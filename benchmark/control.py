"""The control of a cell's correctness check: the reference put in the
program's place and computed in float8, a precision below the bf16 the
configurations state.  It has to come out as not correct.

    python3 benchmark/control.py --workload <cell> --seeds 11,12,13 [--faults half_batch]

For each seed it prints one JSON line with the program's numbers (as a run
of the cell reads them) and the control's, each beside the cell's limit,
and the look behind them (each step's and each leaf's gap).  With
``--faults`` it reads the program with each named fault of the cell's
driver planted in its timed path instead.  The mix's ``kind`` names the
driver (``drive_<kind>.py::control``).  The benchmark's own runs never run
this.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

_HERE = Path(__file__).resolve().parent
if sys.path and Path(sys.path[0]).resolve() == _HERE:
    sys.path.pop(0)
sys.path.insert(0, str(_HERE.parent))

from benchmark import common  # noqa: E402


def main(argv=None) -> int:
    common.keep_environment()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--faults", default="", help="comma-separated faults of the driver's FAULTS, read on every "
                                                 "seed instead of the control")
    args = ap.parse_args(argv)
    ctx = common.find_cell(args.workload)
    common.require_cards(ctx["cell"]["chips"])
    driver = common.driver(ctx["traffic"]["kind"])
    seeds = [int(s) for s in args.seeds.split(",")]
    faults = [f for f in args.faults.split(",") if f]
    unknown = set(faults) - set(driver.FAULTS)
    if unknown:
        raise SystemExit(f"unknown faults {sorted(unknown)}; the driver has {sorted(driver.FAULTS)}")
    compared = [k for k in ctx["limits"] if k != "ref_steps"]
    for seed, fault in [(s, f) for f in faults for s in seeds] if faults else [(s, "") for s in seeds]:
        out = driver.control(ctx, seed, "cuda:0", fault)
        out.update(seed=seed, limits=ctx["limits"], card=common.power_limit())
        low = out.get("control", out["program"])
        out["program_passes"] = all(out["program"][k] <= ctx["limits"][k] for k in compared)
        out["control_fails"] = any(low[k] > ctx["limits"][k] for k in compared)
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
