"""A training cell: the port's train step (``workload/train.py::
make_train_step`` over ``init_train_state``) fed the mix's packed
documents, timed over the window, and checked against the reference's
first steps.

Set-up builds the one state object the window trains, drives it through
the mix's first steps with the window's own call and feed (each batch new)
and reads, as it goes, each step's loss, each leaf's first gradient as the
optimizer got it (its first moment after one step, over ``1 - b1`` as the
optimizer rounded it) and each leaf's change after the reference's steps
(the seed's weights drawn again, one leaf at a time).  After the window the
state is freed and the reference runs the same steps from the same seed.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from benchmark import traffic
from benchmark.common import free, port_config
from benchmark.weights import leaves, make_leaf, make_tree, param_name


def _adapter(mcfg, tree):
    """The port's adapter for ``mcfg`` whose ``init`` hands over the
    benchmark's seeded tree (``init_train_state`` calls it)."""
    from tpu_nexus_torch.models.llama import LlamaParams
    from tpu_nexus_torch.models.moe import MoeConfig
    from tpu_nexus_torch.models.registry import LlamaAdapter, MoeAdapter

    base = MoeAdapter if isinstance(mcfg, MoeConfig) else LlamaAdapter

    class Seeded(base):
        def init(self, generator, device="cuda", leaf_fn=None):
            return LlamaParams(tree)

    return Seeded(config=mcfg)


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def half_batch(step: Callable) -> Callable:
    """A planted fault: the step takes the mean over half of the batch and
    leaves the rest out."""
    def wrapped(state, batch):
        return step(state, batch[: batch.shape[0] // 2])
    return wrapped


#: faults ``control.py --faults`` can plant in the step (``hooks["wrap_step"]``)
FAULTS = {"half_batch": half_batch}


def setup(ctx: Dict[str, Any], seed: int, device: Any, hooks: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Set-up of a training cell: the state, its step and feed after the
    mix's first steps, the readings taken on the way and the host batches
    the reference replays.  ``hooks["wrap_step"]`` wraps the port's step
    (a planted fault)."""
    import torch

    from tpu_nexus_torch.workload.health import HealthConfig
    from tpu_nexus_torch.workload.train import TrainConfig, init_train_state, make_train_step, param_leaves

    cfg, mix, lim = ctx["config"], ctx["traffic"], ctx["limits"]
    tcfg = cfg["train"]
    mcfg = port_config(cfg)
    adapter = _adapter(mcfg, make_tree(cfg, seed, device, mcfg.param_dtype))
    train_cfg = TrainConfig(
        learning_rate=tcfg["learning_rate"], warmup_steps=tcfg["warmup_steps"], total_steps=tcfg["total_steps"],
        weight_decay=tcfg["weight_decay"], grad_clip_norm=tcfg["grad_clip_norm"], z_loss=tcfg["z_loss"],
        b1=tcfg["b1"], b2=tcfg["b2"], ce_chunk=tcfg["ce_chunk"], optimizer=tcfg["optimizer"],
    )
    state = init_train_state(torch.Generator(device=device), adapter, train_cfg, device=device)
    step_fn = make_train_step(adapter, train_cfg, health=HealthConfig() if tcfg["health"] else None)
    wrap_step = (hooks or {}).get("wrap_step")
    if wrap_step is not None:
        step_fn = wrap_step(step_fn)
    batches = traffic.train_batches(mix, cfg["vocab_size"], seed)
    names = [n for n, _ in param_leaves(state["params"])]
    one_minus_b1 = float(torch.tensor(1 - tcfg["b1"], dtype=mcfg.param_dtype))

    # set-up: the first steps through the window's own call and feed
    ref_steps = lim["ref_steps"]
    replay: List[np.ndarray] = []
    losses, grad1, change = [], {}, {}
    for k in range(mix["set_up_steps"]):
        host = next(batches)
        if k < ref_steps:
            replay.append(host.copy())
        state, m = step_fn(state, adapter.to_device(host, device))
        losses.append(m["loss"].float())
        with torch.no_grad():
            if k == 0:
                for name, leaf in zip(names, state["opt_state"]["leaves"]):
                    grad1[name] = torch.linalg.vector_norm(leaf["mu"].float()) / one_minus_b1
            if k + 1 == ref_steps:
                params = dict(param_leaves(state["params"]))
                for path, _, _ in leaves(cfg):
                    p0 = make_leaf(cfg, seed, path, device, mcfg.param_dtype)
                    change[param_name(path)] = torch.linalg.vector_norm(
                        params[param_name(path)].float() - p0.float())
                    del p0
    _sync(device)
    readings = {"loss": [float(x) for x in losses[:ref_steps]],
                "grad1": {n: float(v) for n, v in grad1.items()},
                "change": {n: float(v) for n, v in change.items()}}
    return {"state": state, "step_fn": step_fn, "adapter": adapter, "batches": batches,
            "readings": readings, "replay": replay}


def window(prepared: Dict[str, Any], ctx: Dict[str, Any], seconds: float, device: Any) -> Dict[str, Any]:
    """The timed window: steps until one completes past ``seconds``; the
    window ends at the sync after the last step that completed inside it."""
    mix = ctx["traffic"]
    tokens_per_step = mix["batch"] * mix["seq_len"]
    done = 0
    t_open = t_last = time.monotonic()
    while True:
        _one_step(prepared, device)
        t = time.monotonic()
        if t - t_open > seconds:
            break
        done += 1
        t_last = t
    if done == 0:
        raise RuntimeError(f"no step completed inside the {seconds}-s window")
    window_s = t_last - t_open
    return {"steps": done, "window_s": window_s, "tokens": done * tokens_per_step,
            "train_tokens_per_s": done * tokens_per_step / window_s}


def _one_step(prepared: Dict[str, Any], device: Any) -> None:
    with _span("bench.data"):
        tokens = prepared["adapter"].to_device(next(prepared["batches"]), device)
    with _span("bench.step"):
        prepared["state"], _ = prepared["step_fn"](prepared["state"], tokens)
    with _span("bench.sync"):
        _sync(device)


def traced(prepared: Dict[str, Any], ctx: Dict[str, Any], device: Any) -> Dict[str, Any]:
    """The mix's ``profile_steps`` further steps under the profiler, after
    the window has closed."""
    prof = _profiler(device)
    prof.__enter__()
    t0 = time.monotonic()
    for _ in range(ctx["traffic"]["profile_steps"]):
        _one_step(prepared, device)
    window_s = time.monotonic() - t0
    prof.__exit__(None, None, None)
    return {"prof": prof, "window_s": window_s, "traced_steps": ctx["traffic"]["profile_steps"]}


def after_window(prepared: Dict[str, Any], w: Dict[str, Any]) -> Dict[str, Any]:
    """What the check keeps once the program's state is freed: the
    readings and the batches the reference replays."""
    return {"readings": prepared["readings"], "replay": prepared["replay"]}


def check(kept: Dict[str, Any], ctx: Dict[str, Any], seed: int, device: Any):
    """The reference's steps from the seed against the program's readings:
    (numbers, attempted, failed)."""
    from benchmark.reference.train import reference_steps

    ref = reference_steps(ctx["config"], seed, kept["replay"], ctx["limits"]["ref_steps"], device)
    return numbers(kept["readings"], ref), 1, 0


def control(ctx: Dict[str, Any], seed: int, device: Any, fault: str = "") -> Dict[str, Any]:
    """Program, reference and control readings of one seed; with ``fault``,
    the program's readings with that fault planted in its step (and no
    control).  ``look`` holds each step's and each leaf's signed gap, and
    the embedding's gradient summed in bf16 beside float32."""
    import torch

    from benchmark.reference.train import reference_steps

    lim = ctx["limits"]
    t0 = time.monotonic()
    prepared = setup(ctx, seed, device, {"wrap_step": FAULTS[fault]} if fault else None)
    kept = after_window(prepared, {})
    del prepared
    free(torch.device(device).type == "cuda")
    t1 = time.monotonic()
    ref = reference_steps(ctx["config"], seed, kept["replay"], lim["ref_steps"], device, look=not fault)
    t2 = time.monotonic()
    times = {"program_s": t1 - t0, "reference_s": t2 - t1}
    readings = kept["readings"]
    if fault:
        return {"program": numbers(readings, ref), "fault": fault, "look": look(readings, ref), "times": times}
    low = reference_steps(ctx["config"], seed, kept["replay"], lim["ref_steps"], device, prec="fp8")
    times["control_s"] = time.monotonic() - t2
    low = {"loss": low["loss"], "grad1": {param_name(k): v for k, v in low["grad1"].items()},
           "change": {param_name(k): v for k, v in low["change"].items()}}
    return {"program": numbers(readings, ref), "control": numbers(low, ref),
            "look": {"program": look(readings, ref), "control": look(low, ref),
                     "embed_witness": ref["embed_witness"]},
            "times": times}


class _span:
    """A benchmark host span, visible in the profiler's trace."""

    def __init__(self, name: str) -> None:
        import torch

        self._rf = torch.profiler.record_function(name)

    def __enter__(self):
        self._rf.__enter__()
        return self

    def __exit__(self, *exc):
        self._rf.__exit__(*exc)
        return False


def _profiler(device):
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts, record_shapes=True)


def _grad_gaps(prog: Dict, ref: Dict) -> Dict[str, float]:
    """Each leaf's gap of its first-gradient norm, against the larger of the
    reference leaf's norm and the median leaf's."""
    gref = {param_name(k): v for k, v in ref["grad1"].items()}
    gmed = float(np.median(list(gref.values())))
    return {n: abs(prog["grad1"][n] - g) / max(g, gmed) for n, g in gref.items()}


def _grad_residuals(prog: Dict, ref: Dict) -> Dict[str, float]:
    """Each leaf's signed relative gap of its first-gradient norm, less the
    median leaf's: the clip scales every leaf by one global norm, so a
    rounding step of that norm moves every leaf alike.  Leaves whose
    reference gradient is under a thousandth of the median leaf's are left
    out."""
    gref = {param_name(k): v for k, v in ref["grad1"].items()}
    gmed = float(np.median(list(gref.values())))
    gaps = {n: (prog["grad1"][n] - g) / g for n, g in gref.items() if g >= 1e-3 * gmed}
    common = float(np.median(list(gaps.values())))
    return {n: abs(v - common) for n, v in gaps.items()}


def _change_gaps(prog: Dict, ref: Dict) -> Dict[str, float]:
    """Each leaf's gap of its change norm after the reference's steps,
    against the larger of the reference leaf's and the median kept leaf's.
    Leaves whose reference gradient is under a thousandth of the median
    leaf's are left out (they move by round-off alone)."""
    gref = {param_name(k): v for k, v in ref["grad1"].items()}
    cref = {param_name(k): v for k, v in ref["change"].items()}
    gmed = float(np.median(list(gref.values())))
    kept = [n for n, g in gref.items() if g >= 1e-3 * gmed]
    cmed = float(np.median([cref[n] for n in kept]))
    return {n: abs(prog["change"][n] - cref[n]) / max(cref[n], cmed) for n in kept}


def numbers(prog: Dict, ref: Dict) -> Dict[str, float]:
    """The numbers a run can compare: each step's relative loss gap
    (``loss1_gap``, ``loss2_gap`` ...); the worst leaf's gap of the first
    gradient's norm, and the median leaf's against the leaves' common
    factor (:func:`_grad_residuals`); the worst leaf's gap of the change
    after the reference's steps.  A cell's limits file names the ones it
    compares."""
    out = {f"loss{k}_gap": abs(p - r) / abs(r) for k, (p, r) in enumerate(zip(prog["loss"], ref["loss"]), 1)}
    out["grad_gap"] = max(_grad_gaps(prog, ref).values())
    out["grad_gap_median"] = float(np.median(list(_grad_residuals(prog, ref).values())))
    out["change_gap"] = max(_change_gaps(prog, ref).values())
    return out


def look(prog: Dict, ref: Dict) -> Dict[str, object]:
    """Where each number comes from: every step's signed loss gap, and each
    leaf's signed first-gradient and change gaps (the look behind a
    reading)."""
    gref = {param_name(k): v for k, v in ref["grad1"].items()}
    cref = {param_name(k): v for k, v in ref["change"].items()}
    return {"loss_gaps": [(p - r) / abs(r) for p, r in zip(prog["loss"], ref["loss"])],
            "grad_leaf_gaps": {n: (prog["grad1"][n] - g) / g for n, g in gref.items()},
            "grad_gaps": _grad_gaps(prog, ref),
            "change_gaps": _change_gaps(prog, ref),
            "change_leaf_gaps": {n: (prog["change"][n] - c) / c for n, c in cref.items() if c}}
