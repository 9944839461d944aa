"""Training goodput + MFU accounting: the port of
``tpu_nexus/workload/goodput.py``.

"Of the wall-clock this run burned, how much trained the model?"  A
supervised run spends real time in places that are NOT the train step —
state init and the first step's warm-up, batch draws, eval passes, health
recovery, emergency saves — and without named accounting they all launder
into one tokens/s number nobody can act on.

:class:`GoodputMeter` is a single-stopwatch attributor: every span of wall
time between :meth:`start` and :meth:`stop` lands in EXACTLY one named
bucket (:data:`BUCKETS`), attributed by ``lap(bucket)`` calls at the
harness's phase boundaries, with a residual ``host_other`` bucket catching
everything between phases — so the buckets PROVABLY sum to elapsed wall
time (the sums telescope, so the only slack is float rounding).  On top of the buckets it computes:

* **productive-step fraction** — step-dispatch seconds / elapsed (the
  goodput headline: everything else is overhead by definition);
* **tokens/s** — training items consumed per wall second;
* **MFU** — model-FLOPs utilization: the standard 6·N-matmul + causal-
  attention per-token FLOP model (forward + 2× backward, remat recompute
  deliberately EXCLUDED; MoE counts ACTIVE params — router + top-k
  experts) against the card's peak dense bf16 FLOP/s (device-name lookup,
  ``NEXUS_PEAK_TFLOPS`` override; the CPU and unknown cards report MFU 0
  rather than a wrong number).

Host-side timing honesty: CUDA launches are asynchronous, so device
compute surfaces at the next *blocking* point (a metrics pull, the
sentinel's delayed readback, the end-of-run sync) — the meter attributes
each wait to the bucket whose code performed it, which on the card means
``step_dispatch`` absorbs the step-chain waits.  The meter never touches
the step's arithmetic.
"""

from __future__ import annotations

import os
import time
from typing import Any, Callable, Dict, Optional

# -- wall-time buckets ----------------------------------------------------------

BUCKET_INIT = "init_compile"
BUCKET_DATA = "data_draw"
BUCKET_STEP = "step_dispatch"
BUCKET_EVAL = "eval"
BUCKET_CKPT = "checkpoint"
BUCKET_RECOVERY = "recovery"
BUCKET_EMERGENCY = "emergency"
BUCKET_OTHER = "host_other"

#: every bucket a lap may name — ``lap()`` indexes this set's dict, so an
#: unnamed bucket is a loud KeyError at the call site, never a silently
#: mis-attributed span
BUCKETS = (
    BUCKET_INIT,
    BUCKET_DATA,
    BUCKET_STEP,
    BUCKET_EVAL,
    BUCKET_CKPT,
    BUCKET_RECOVERY,
    BUCKET_EMERGENCY,
    BUCKET_OTHER,
)


# -- the per-step FLOPs estimator (dense + MoE) ---------------------------------

#: card-name substring -> peak dense bf16 TFLOP/s, from NVIDIA's data
#: sheets: the H100 SXM (``torch.cuda.get_device_name`` reads "NVIDIA H100
#: 80GB HBM3") at 989.  Other H100 parts (PCIe, NVL) have other peaks and
#: are not listed: they report MFU 0.
PEAK_BF16_TFLOPS = (("h100 80gb hbm3", 989.0),)


def chip_peak_flops(device: Any, env: Optional[Dict[str, str]] = None) -> float:
    """Peak dense bf16 FLOP/s of one device, from its CUDA device name (the
    table above) or the ``NEXUS_PEAK_TFLOPS`` override; 0.0 for the CPU and
    unknown cards — MFU then reports 0 rather than a number computed
    against a made-up peak."""
    e = os.environ if env is None else env
    override = e.get("NEXUS_PEAK_TFLOPS") or e.get("NEXUS_BENCH_PEAK_TFLOPS")
    if override:
        return float(override) * 1e12
    import torch

    device = torch.device(device)
    if device.type != "cuda":
        return 0.0
    kind = torch.cuda.get_device_name(device).lower()
    for sub, peak in PEAK_BF16_TFLOPS:
        if sub in kind:
            return peak * 1e12
    return 0.0


def model_flops_per_token(cfg: Any, seq: int) -> float:
    """Training FLOPs per token: 6 × matmul params + causal attention.

    Per layer/token forward: 2×(wq + wk + wv + wo + ffn) matmul FLOPs;
    attention scores QK^T + PV add 4·s·hq·d, halved by causality.  Training
    = 3× forward (fwd + 2× backward); remat recompute deliberately excluded
    (the MFU convention).  Embedding lookup is a gather (no FLOPs); the
    (tied or untied) head projection is a real matmul.

    MoE configs (detected by ``n_experts``) count ACTIVE parameters — the
    router projection plus top-k experts' SwiGLU per token — so dispatch
    scatter/gather bookkeeping counts as overhead, not useful work.

    Returns 0.0 for configs without the transformer shape fields (the
    mnist adapter): no estimate beats a fabricated one."""
    for name in ("hidden", "intermediate", "n_heads", "n_kv_heads",
                 "head_dim", "n_layers", "vocab_size"):
        if getattr(cfg, name, None) is None:
            return 0.0
    e, f, hq, hkv, d, l, v = (
        cfg.hidden, cfg.intermediate, cfg.n_heads, cfg.n_kv_heads,
        cfg.head_dim, cfg.n_layers, cfg.vocab_size,
    )
    if getattr(cfg, "n_experts", 0):
        ffn = cfg.experts_per_token * 3 * e * f + e * cfg.n_experts
    else:
        ffn = 3 * e * f
    matmul_params = l * (e * hq * d + 2 * e * hkv * d + hq * d * e + ffn) + e * v
    attn = 2 * seq * hq * d * l  # causal: 4*s*hq*d / 2, per layer
    return 3.0 * (2.0 * matmul_params + attn)


# -- the meter ------------------------------------------------------------------


class GoodputMeter:
    """Single-stopwatch wall-time attributor (module doc).  ``start()``
    opens the run; each ``lap(bucket)`` attributes everything since the
    previous attribution point to ``bucket``; ``stop()`` laps the residual
    into ``host_other`` and freezes ``elapsed``.  ``note_step(tokens)``
    counts one dispatched train step's items for the tokens/s and MFU
    numerators.  All host-side, no device interaction."""

    enabled = True

    def __init__(
        self,
        clock: Callable[[], float] = time.perf_counter,
        flops_per_token: float = 0.0,
        peak_flops: float = 0.0,
    ) -> None:
        self._clock = clock
        self.buckets: Dict[str, float] = {b: 0.0 for b in BUCKETS}
        self.flops_per_token = float(flops_per_token)
        #: aggregate peak FLOP/s of the devices the run spans (one card in
        #: this slice) — the MFU denominator
        self.peak_flops = float(peak_flops)
        self.steps = 0
        self.tokens = 0
        self._start: Optional[float] = None
        self._mark: Optional[float] = None
        self._stopped: Optional[float] = None

    def start(self) -> None:
        if self._start is not None:
            raise RuntimeError("GoodputMeter.start() called twice")
        self._start = self._mark = self._clock()

    def lap(self, bucket: str) -> None:
        """Attribute wall time since the previous attribution point to
        ``bucket`` (a :data:`BUCKETS` member — unknown names KeyError)."""
        if self._mark is None:
            raise RuntimeError("GoodputMeter.lap() before start()")
        now = self._clock()
        self.buckets[bucket] += now - self._mark
        self._mark = now

    def note_step(self, tokens: int) -> None:
        self.steps += 1
        self.tokens += int(tokens)

    def stop(self) -> None:
        """Close the run: the residual since the last lap lands in
        ``host_other``.  Idempotent — a finally-block stop after a clean
        stop changes nothing."""
        if self._start is None or self._stopped is not None:
            return
        self.lap(BUCKET_OTHER)
        self._stopped = self._mark

    @property
    def elapsed_s(self) -> float:
        if self._start is None:
            return 0.0
        end = self._stopped if self._stopped is not None else self._clock()
        return end - self._start

    # -- derived numbers -------------------------------------------------------

    def productive_fraction(self) -> float:
        """Step-dispatch seconds / elapsed: the goodput headline."""
        elapsed = self.elapsed_s
        return self.buckets[BUCKET_STEP] / elapsed if elapsed > 0 else 0.0

    def tokens_per_second(self) -> float:
        elapsed = self.elapsed_s
        return self.tokens / elapsed if elapsed > 0 else 0.0

    def model_flops_per_second(self) -> float:
        return self.tokens_per_second() * self.flops_per_token

    def mfu(self) -> float:
        """Model-FLOPs utilization in [0, 1]; 0 when the peak is unknown
        (no estimate beats a wrong one)."""
        if not self.peak_flops:
            return 0.0
        return self.model_flops_per_second() / self.peak_flops

    def summary(self) -> Dict[str, Any]:
        return {
            "elapsed_s": round(self.elapsed_s, 6),
            "buckets_s": {b: round(v, 6) for b, v in self.buckets.items()},
            "steps": self.steps,
            "tokens": self.tokens,
            "productive_fraction": round(self.productive_fraction(), 6),
            "tokens_per_second": round(self.tokens_per_second(), 3),
            "model_tflops_per_second": round(
                self.model_flops_per_second() / 1e12, 6
            ),
            "mfu": round(self.mfu(), 6),
        }

    def table(self) -> str:
        """The goodput table for the run summary log: one line per
        non-empty bucket with its share of elapsed, then the derived
        numbers."""
        elapsed = self.elapsed_s
        lines = ["goodput (wall-time accounting):"]
        for bucket in BUCKETS:
            seconds = self.buckets[bucket]
            if seconds <= 0.0:
                continue
            share = 100.0 * seconds / elapsed if elapsed > 0 else 0.0
            lines.append(f"  {bucket:<13} {seconds:10.3f}s  {share:5.1f}%")
        lines.append(f"  {'elapsed':<13} {elapsed:10.3f}s  100.0%")
        lines.append(
            f"  productive {100.0 * self.productive_fraction():.1f}%  "
            f"tokens/s {self.tokens_per_second():.1f}  "
            f"mfu {100.0 * self.mfu():.2f}%"
        )
        return "\n".join(lines)

    # -- emission --------------------------------------------------------------

    def gauges(self, telemetry: Any) -> None:
        """Heartbeat gauges: the goodput fraction, tokens/s, and MFU an
        on-call watches.  The
        ledger-side twin is ``summary()`` in the terminal details column
        (COMPLETED/PREEMPTED) — ``per_chip_steps`` stays chip-keys-only
        by contract, so goodput never rides the heartbeat map."""
        telemetry.gauge("train.goodput", self.productive_fraction())
        telemetry.gauge("train.tokens_per_second", self.tokens_per_second())
        telemetry.gauge("train.mfu", self.mfu())


class NullGoodputMeter:
    """Goodput accounting disabled (``NEXUS_GOODPUT=0``): the same surface,
    every hook a no-op — the bit-parity test's off side, and the escape
    hatch if a clock-heavy environment ever makes the laps measurable."""

    enabled = False
    steps = 0
    tokens = 0

    def start(self) -> None:
        pass

    def lap(self, bucket: str) -> None:
        pass

    def note_step(self, tokens: int) -> None:
        pass

    def stop(self) -> None:
        pass

    @property
    def elapsed_s(self) -> float:
        return 0.0

    def productive_fraction(self) -> float:
        return 0.0

    def tokens_per_second(self) -> float:
        return 0.0

    def model_flops_per_second(self) -> float:
        return 0.0

    def mfu(self) -> float:
        return 0.0

    def summary(self) -> Dict[str, Any]:
        return {}

    def table(self) -> str:
        return ""

    def gauges(self, telemetry: Any) -> None:
        pass


def build_meter(
    enabled: bool,
    model_cfg: Any,
    seq_len: int,
    device: Any = "cpu",
    clock: Callable[[], float] = time.perf_counter,
    cards: int = 1,
):
    """The harness's constructor: FLOPs from the model config (0 for
    non-transformer adapters), peak from the run's device times ``cards``,
    the distinct cards under the run's ranks (the reference multiplies one
    chip's peak by the device count; ranks sharing one card under the
    rehearsal map count it once)."""
    if not enabled:
        return NullGoodputMeter()
    return GoodputMeter(
        clock=clock,
        flops_per_token=model_flops_per_token(model_cfg, seq_len),
        peak_flops=chip_peak_flops(device) * cards,
    )
