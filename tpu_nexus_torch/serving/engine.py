"""The continuous-batching step loop: admit, prefill, decode, retire.

The port of ``tpu_nexus/serving/engine.py``.  :class:`ServingEngine` — the
host state machine (queue, slots, cursors, per-request lifecycle, fault
isolation, overlap, speculative decoding, drain, quiesce, swap) — is the
reference's code verbatim apart from its imports.  The two executors are
rewritten in PyTorch:

* :class:`ModelExecutor` owns the device state (params, the contiguous
  ``[L, num_slots, max_len, Hkv, D]`` cache, the sampling generator) and
  the entry points: bucketed prefill through the flash kernel with the
  slot copy, the per-slot decode step, the multi-step ``step_scan`` and
  the speculative ``verify`` — each through the split-KV decode kernel on
  the card (``models/generate.py``).
* :class:`PagedModelExecutor` does the same over the paged pool
  ``[L, num_blocks, page, Hkv, D]``: block scatter at prefill, COW copies,
  ``extend_step`` for prefix hits, and the decode kernel's paged mode
  (its ``q_starts`` mode in ``verify``).

There is no ``jit``: each entry point is a plain method on tensors on the
executor's device, and the cache is updated in place.  Results cross to
the host only at the seams where the reference calls ``np.asarray``: the
executors return host copies there (``step_scan`` returns device results
that the engine's readback seam copies).  A CUDA out-of-memory error at
the executor boundary is re-worded into the taxonomy's HBM-OOM wording, so
the engine's fault policy retires exactly one request; a sticky CUDA
error reinitializes the cache and raises :class:`DeviceStateLost`.  The KV
handoff seam (``extract_blocks``/``install_blocks``) copies a request's
blocks through the host, as between two processes: remote prefill
(``prefill_remote``) and its install (``admit_prefilled``) run on it.

Retirement is dispatched through :data:`RETIREMENT_ACTIONS`, total over
``request.TERMINAL_STATES``.
"""

from __future__ import annotations

import itertools
import logging
import re
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from tpu_nexus_torch.models.generate import (
    DECODE_IMPLS,
    decode_scan,
    decode_step,
    extend_step,
    prefill,
    sample_logits,
    verify_step,
)
from tpu_nexus_torch.models.quant import QTensor, QTensor4, quantize_params, quantized_bytes

from tpu_nexus_torch.serving.cache_manager import (
    SCRATCH_BLOCK,
    AdmitPlan,
    KVSlotManager,
    PagedCacheManager,
    init_cache,
    init_paged_cache,
)
from tpu_nexus_torch.serving.loadstats import LoadSnapshot
from tpu_nexus_torch.serving.metrics import ServingMetrics
from tpu_nexus_torch.serving.overlap import DispatchPipeline, PendingStep
from tpu_nexus_torch.serving.recovery import DeviceStateLost, StepFault, StepFaultPolicy
from tpu_nexus_torch.serving.request import (
    Request,
    RequestState,
)
from tpu_nexus_torch.serving.handoff import (
    HandoffError,
    KVHandoffPayload,
    PayloadCorrupt,
    validate_payload,
)
from tpu_nexus_torch.serving.scheduler import FifoScheduler, QueueFull, SchedulerConfig
from tpu_nexus_torch.serving.speculative import accept_tokens
from tpu_nexus_torch.workload.harness import classified_error_text
from tpu_nexus_torch.serving.tracing import (
    EV_ADMITTED,
    EV_DECODE_DISPATCH,
    EV_FAULT,
    EV_HANDOFF_INSTALL,
    EV_MATERIALIZE,
    EV_PREFILL_COMPLETE,
    EV_PREFILL_DISPATCH,
    EV_SPEC_ACCEPT,
    EV_SPEC_PROPOSE,
    EngineTracer,
)

logger = logging.getLogger(__name__)

#: terminal state -> retirement action tag (metrics ``state:`` tag + log
#: verb).  TOTAL over request.TERMINAL_STATES — enforced by nxlint NX005;
#: the dispatch in :meth:`ServingEngine._retire` indexes this dict, so an
#: unmapped terminal state cannot ship.
RETIREMENT_ACTIONS: Dict[str, str] = {
    RequestState.FINISHED: "completed",
    RequestState.CANCELLED: "cancelled",
    RequestState.EVICTED: "evicted",
    RequestState.FAILED: "failed",
}

#: canonical ``Request.cause`` strings for EVICTED retirements — matched by
#: tests and aggregated per-cause into the drain ledger report.  "deadline
#: exceeded" deliberately mirrors the reference's SCHEDULING_TIMEOUT class
#: wording.
CAUSE_DEADLINE = "deadline exceeded"
CAUSE_STARVATION = "starvation guard reclaimed slot"
CAUSE_OVERFLOW = "cache overflow backstop"
CAUSE_DRAIN_SHED = "drain: shed before admission"
CAUSE_DRAIN_GRACE = "drain: grace budget exhausted"
CAUSE_RELOAD_GRACE = "weight reload: quiesce grace exhausted"


def _prefill_buckets(max_len: int) -> List[int]:
    """Static prompt pad widths: powers of two from 8 up to ``max_len``
    (inclusive).  Prefill retraces once per DISTINCT width, so bucketing
    bounds compile count at ~log2(max_len) regardless of traffic."""
    buckets: List[int] = []
    w = 8
    while w < max_len:
        buckets.append(w)
        w *= 2
    buckets.append(max_len)
    return buckets


class _DeviceResult:
    """A result of :meth:`ModelExecutor.step_scan` still on the device: the
    engine's readback seam calls ``np.asarray`` on it (a host copy, the
    one place the scan's results cross), and the next dispatch takes the
    tensor back as its carry.  ``bound`` (cursor results only) is a host
    upper bound on the values, which sizes the next scan's kernel grid
    without a readback."""

    __slots__ = ("tensor", "bound")

    def __init__(self, tensor: Any, bound: Optional[np.ndarray] = None) -> None:
        self.tensor = tensor
        self.bound = bound

    def __array__(self, dtype=None, copy=None):
        host = self.tensor.cpu().numpy()
        return host if dtype is None else host.astype(dtype)


#: CUDA errors that leave the context unusable: nothing on the device can
#: be trusted (or even reached) after them
_STICKY_CUDA_RE = re.compile(
    r"illegal memory access|illegal instruction|misaligned address|unspecified launch failure|"
    r"device-side assert",
    re.IGNORECASE,
)


def _param_spec(tree: Any, prefix: str = "") -> List[Tuple[str, str, Tuple[int, ...], str]]:
    """(path, leaf type, shape, dtype) of every leaf of a params tree —
    QTensor/QTensor4 leaves by their parts — the structure a swap must
    keep."""
    if isinstance(tree, torch.Tensor):
        return [(prefix, "tensor", tuple(tree.shape), str(tree.dtype))]
    if isinstance(tree, (QTensor, QTensor4)):
        kind = type(tree).__name__
        return [(f"{prefix}.{part}", kind, tuple(t.shape), str(t.dtype))
                for part, t in (("q", tree.q), ("s", tree.s))]
    out = []
    for key in sorted(tree.keys()):
        out += _param_spec(tree[key], f"{prefix}/{key}")
    return out


class _ExecutorCommon:
    """Shared device-side plumbing of the two executors: sampling setup,
    the torch generator, prefill-width bucketing, the weight swap and the
    fault guard at the executor boundary.  Subclasses install
    ``self.cache`` and implement :meth:`_fresh_cache` (what to reinstall
    after a fault lost the device state).  Every entry point is a plain
    method over tensors on ``self.device``; results cross to the host only
    where the engine reads them (the JAX package's ``np.asarray`` seams)."""

    def _init_common(
        self,
        params: Any,
        cfg: Any,
        *,
        num_slots: int,
        max_len: int,
        kv_quant: str,
        decode_kernel: str,
        temperature: float,
        top_k: int,
        top_p: float,
        seed: int,
        decode_steps: int = 1,
        stop_token: int = -1,
        quantize: str = "",
        quant_group: int = 0,
        attn_impl: str = "auto",
    ) -> None:
        if decode_kernel not in DECODE_IMPLS:
            raise ValueError(
                f"unknown decode_kernel mode {decode_kernel!r}; use {', '.join(DECODE_IMPLS)}"
            )
        if quantize not in ("", "int8", "int4"):
            raise ValueError(
                f"unknown quantize mode {quantize!r}; use 'int8' or 'int4'"
            )
        if temperature < 0.0:
            raise ValueError(f"temperature must be >= 0, got {temperature}")
        if (top_k or top_p < 1.0) and temperature == 0.0:
            raise ValueError("top_k/top_p truncation requires temperature > 0")
        if decode_steps < 1:
            raise ValueError(f"decode_steps must be >= 1, got {decode_steps}")
        #: weight-quantization mode the executor SERVES at, applied here
        #: (idempotently: pre-quantized trees pass through) and again to
        #: every :meth:`swap_params` tree, so rolling updates hand the
        #: executor plain checkpoints
        self.quantize = quantize
        self.quant_group = int(quant_group)
        if quantize:
            params = quantize_params(params, mode=quantize, group=self.quant_group)
        self.params = params
        #: stored weight-tree bytes (packed widths), surfaced per replica
        #: in ``ServingEngine.load_snapshot``
        self.weight_bytes = int(quantized_bytes(self.params))
        self.cfg = cfg
        self.device = params["embed"]["tokens"].device
        self.num_slots = num_slots
        self.max_len = max_len
        self.kv_quant = kv_quant
        self.decode_kernel = decode_kernel
        self.attn_impl = attn_impl
        #: multi-step decode: tokens per ``step_scan`` dispatch
        self.decode_steps = decode_steps
        #: stop detection on the device: a row that samples this token
        #: emits it and freezes mid-scan (-1 disables)
        self.stop_token = int(stop_token)
        self.temperature = temperature
        self.top_k = top_k
        self.top_p = top_p
        self._buckets = _prefill_buckets(max_len)
        self._generator = torch.Generator(device=self.device).manual_seed(seed)

    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        generator = self._generator if self.temperature > 0.0 else None
        return sample_logits(logits, generator, self.temperature, self.top_k, self.top_p)

    def _tensor(self, x: Any, dtype: torch.dtype = torch.int32) -> torch.Tensor:
        """A host array, or a previous dispatch's device result, as a
        tensor on the executor's device."""
        if isinstance(x, _DeviceResult):
            x = x.tensor
        if isinstance(x, torch.Tensor):
            return x.to(device=self.device, dtype=dtype)
        return torch.from_numpy(np.ascontiguousarray(x)).to(device=self.device, dtype=dtype)

    def _bucket(self, prompt_len: int) -> int:
        for w in self._buckets:
            if w >= prompt_len:
                return w
        raise ValueError(
            f"prompt length {prompt_len} exceeds cache max_len {self.max_len}"
        )

    def _fresh_cache(self):
        raise NotImplementedError  # pragma: no cover - subclass contract

    def swap_params(self, params: Any) -> None:
        """Hot-swap the model weights.  The incoming tree is quantized
        here under ``self.quantize`` (so rolling updates ship plain
        checkpoints), then checked against the serving tree — same leaves,
        shapes and dtypes — because a mismatched swap would fail deep in
        the next step.  Contract (as in the JAX package): the caller
        resolved ``params`` from a VERIFIED checkpoint step."""
        if self.quantize:
            params = quantize_params(params, mode=self.quantize, group=self.quant_group)
        if _param_spec(self.params) != _param_spec(params):
            raise ValueError(
                "swap_params: new weights' pytree structure/shapes/dtypes "
                "differ from the serving params — wrong checkpoint or "
                "missing quantization transform"
            )
        self.params = params
        self.weight_bytes = int(quantized_bytes(self.params))

    def _guarded(self, fn: Callable[[], Any]) -> Any:
        """Run one entry point's device work.  A CUDA out-of-memory error
        is re-raised in the taxonomy's HBM-OOM wording (the engine's fault
        policy retires the implicated request); any other RuntimeError goes
        to :meth:`_guard_cache`."""
        try:
            return fn()
        except torch.OutOfMemoryError as exc:
            raise RuntimeError(classified_error_text(exc)) from exc
        except RuntimeError as exc:  # noqa: BLE001 - _guard_cache ALWAYS raises: the original (classified downstream) or DeviceStateLost
            self._guard_cache(exc)

    def _guard_cache(self, exc: RuntimeError) -> None:
        """After a faulted entry point.  torch updates the cache in place
        and donates nothing, so with the CUDA context intact the state is
        whole and the error is re-raised for normal recovery.  A sticky
        CUDA error (an illegal memory access) poisons the context: the
        cache is reinitialized so the engine can keep serving NEW
        admissions, and the non-retryable :class:`DeviceStateLost` raised
        instead."""
        if _STICKY_CUDA_RE.search(str(exc)):
            self.cache = self._fresh_cache()
            raise DeviceStateLost(exc) from exc
        raise exc

    def _prefill(self, padded: np.ndarray, n: int, max_len: int):
        return prefill(
            self.params, self._tensor(padded), self.cfg, max_len=max_len,
            prompt_lengths=self._tensor(np.asarray([n], np.int32)),
            kv_quant=self.kv_quant, attn_impl=self.attn_impl,
        )

    def _scan(self, prev_tokens, prev_cursors, override, tokens, cursors, limits, tables=None):
        """The multi-step dispatch shared by both executors: merge the host
        overrides (refilled slots) into the previous dispatch's device
        carries, then :func:`decode_scan` with per-row budgets and stop
        detection.  No host readback: the results stay on the device."""
        ov = self._tensor(np.asarray(override, bool), torch.bool)
        tok0 = torch.where(ov, self._tensor(tokens), self._tensor(prev_tokens))
        pos0 = torch.where(ov, self._tensor(cursors), self._tensor(prev_cursors))
        prev_bound = (
            prev_cursors.bound if isinstance(prev_cursors, _DeviceResult)
            else np.asarray(prev_cursors, np.int64)
        )
        bound = np.where(np.asarray(override, bool), np.asarray(cursors, np.int64), prev_bound)
        toks, counts, last_tok, last_pos, self.cache = decode_scan(
            self.params, self.cache, tok0, pos0, self._tensor(limits), self.cfg,
            num_steps=self.decode_steps,
            generator=self._generator if self.temperature > 0.0 else None,
            temperature=self.temperature, top_k=self.top_k, top_p=self.top_p,
            stop_token=self.stop_token, decode_kernel=self.decode_kernel,
            block_tables=None if tables is None else self._tensor(tables),
            logical_limit=None if tables is None else self.max_len,
            max_pos=int(bound.max()),
        )
        bound = bound + np.asarray(limits, np.int64)
        return (_DeviceResult(toks), _DeviceResult(counts), _DeviceResult(last_tok),
                _DeviceResult(last_pos, bound))

    def _verify(self, tokens, cursors, drafts, tables=None) -> np.ndarray:
        if self.temperature != 0.0:
            raise RuntimeError(
                "speculative verify is greedy-only (temperature == 0); "
                "rejection sampling has not landed"
            )
        block = np.concatenate(
            [np.asarray(tokens, np.int32)[:, None], np.asarray(drafts, np.int32)],
            axis=1,
        )
        cursors = np.asarray(cursors, np.int32)

        def run():
            logits, self.cache = verify_step(
                self.params, self.cache, self._tensor(block), self._tensor(cursors), self.cfg,
                decode_kernel=self.decode_kernel,
                block_tables=None if tables is None else self._tensor(tables),
                logical_limit=None if tables is None else self.max_len,
                max_pos=int(cursors.max()),
            )
            return torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()

        return self._guarded(run)

    def _step(self, tokens, cursors, tables=None) -> np.ndarray:
        cursors = np.asarray(cursors, np.int32)

        def run():
            logits, self.cache = decode_step(
                self.params, self.cache, self._tensor(tokens), self._tensor(cursors), self.cfg,
                decode_kernel=self.decode_kernel,
                block_tables=None if tables is None else self._tensor(tables),
                logical_limit=None if tables is None else self.max_len,
                max_pos=int(cursors.max()),
            )
            return self._sample(logits).cpu().numpy()

        return self._guarded(run)


class ModelExecutor(_ExecutorCommon):
    """Device half of the engine: cache + params + the entry points.

    ``begin(slot, prompt)`` prefills one request (prompt right-padded to a
    bucket width, per-row ``prompt_lengths`` — exactly ``generate``'s
    ragged semantics, through the flash kernel on the card) and copies its
    KV rows into the slot; returns the request's FIRST output token,
    sampled from the prefill logits.

    ``step(tokens, cursors)`` advances all ``num_slots`` rows one token
    with the per-slot (vector-``pos``) ``decode_step`` and returns the
    sampled next token per slot.  Inactive slots decode garbage that the
    host discards.  ``step_scan`` runs ``decode_steps`` of them per call,
    ``verify`` the speculative verify (q_len = k + 1).

    ``attn_impl``/``decode_kernel`` pick the prefill and decode attention
    (``"plain"`` runs the whole path without the kernels)."""

    def __init__(
        self,
        params: Any,
        cfg: Any,
        *,
        num_slots: int,
        max_len: int,
        kv_quant: str = "",
        decode_kernel: str = "auto",
        temperature: float = 0.0,
        top_k: int = 0,
        top_p: float = 1.0,
        seed: int = 0,
        decode_steps: int = 1,
        stop_token: int = -1,
        quantize: str = "",
        quant_group: int = 0,
        attn_impl: str = "auto",
    ) -> None:
        self._init_common(
            params, cfg, num_slots=num_slots, max_len=max_len,
            kv_quant=kv_quant, decode_kernel=decode_kernel,
            temperature=temperature, top_k=top_k, top_p=top_p, seed=seed,
            decode_steps=decode_steps, stop_token=stop_token,
            quantize=quantize, quant_group=quant_group, attn_impl=attn_impl,
        )
        self.cache = self._fresh_cache()

    def _fresh_cache(self):
        return init_cache(self.cfg, self.num_slots, self.max_len, self.kv_quant, device=self.device)

    def begin(self, slot: int, prompt: np.ndarray) -> int:
        """Prefill ``prompt`` into ``slot``; returns the first token."""
        n = int(prompt.shape[0])
        width = self._bucket(n)
        padded = np.zeros((1, width), np.int32)
        padded[0, :n] = prompt

        def run():
            # prefill + slot copy + first-token sample; the prefill's
            # zero-padded row overwrites the slot's previous tenant
            row_cache, logits = self._prefill(padded, n, self.max_len)
            for name, arr in self.cache.items():
                arr[:, slot] = row_cache[name][:, 0]
            return self._sample(logits).cpu()

        return int(self._guarded(run)[0])

    def step(self, tokens: np.ndarray, cursors: np.ndarray) -> np.ndarray:
        """One decode iteration over all slots -> next token per slot."""
        return self._step(tokens, cursors)

    def step_scan(
        self,
        prev_tokens: Any,
        prev_cursors: Any,
        override: np.ndarray,
        tokens: np.ndarray,
        cursors: np.ndarray,
        limits: np.ndarray,
    ):
        """One deferred/multi-step decode dispatch: ``decode_steps``
        per-slot steps in one call.  ``prev_*`` are the PREVIOUS dispatch's
        device results (or host arrays for a cold start); rows where
        ``override`` is True take the host ``tokens``/``cursors`` instead
        (admission refilled the slot).  ``limits`` [B] caps each row's
        emissions (0 = frozen dead lane).

        Returns device results ``(tokens [B, k], counts [B], last_token
        [B], last_pos [B])`` with NO host readback — the engine's
        ``_materialize_one`` seam owns the ``np.asarray``."""
        return self._guarded(
            lambda: self._scan(prev_tokens, prev_cursors, override, tokens, cursors, limits)
        )

    def verify(self, tokens: np.ndarray, cursors: np.ndarray, drafts: np.ndarray) -> np.ndarray:
        """Speculative verify over all slots: score ``[tokens[b], drafts
        [b]]`` (q_len = k+1) at each slot's cursor in ONE call; returns the
        target's greedy tokens [num_slots, k+1] — row j is the argmax
        conditioned on drafts < j (the acceptance oracle)."""
        return self._verify(tokens, cursors, drafts)


class PagedModelExecutor(_ExecutorCommon):
    """Device half of the PAGED engine: the KV cache is a pool of
    ``page_size``-token blocks ``[L, num_blocks, page_size, Hkv, D]`` and
    each slot reaches its rows through a per-slot block-table row —
    occupancy tracks actual tokens, and shared-prefix admissions reuse
    already-prefilled blocks by reference (the host-side accounting lives
    in :class:`~tpu_nexus_torch.serving.cache_manager.PagedCacheManager`,
    owned by the engine).

    * ``begin(slot, prompt, table_row=..., tail_start=..., copies=...)`` —
      apply the admission's COW block copies, then prefill ONLY the
      non-shared tail: ``tail_start == 0`` runs the flash prefill and
      scatters the rows through the table, a prefix hit runs
      :func:`~tpu_nexus_torch.models.generate.extend_step`, which attends
      to the shared blocks in place (the decode kernel's paged mode for
      tails of <= 8 tokens).  Returns the first sampled token.
    * ``step(tokens, cursors, tables)`` / ``step_scan(..., tables)`` /
      ``verify(..., tables)`` — the contiguous executor's entry points
      through the kernel's paged mode.

    * ``extract_blocks(block_ids)`` / ``install_blocks(payload,
      block_ids)`` — the KV handoff seam of disaggregated serving: a
      request's blocks gathered to the host, and installed from a validated
      payload into freshly allocated blocks.

    ``prefilled_tokens`` counts the prompt tokens that actually ran
    through a forward pass (shared-prefix tokens never count)."""

    def __init__(
        self,
        params: Any,
        cfg: Any,
        *,
        num_slots: int,
        max_len: int,
        page_size: int,
        num_blocks: int = 0,
        kv_quant: str = "",
        decode_kernel: str = "auto",
        temperature: float = 0.0,
        top_k: int = 0,
        top_p: float = 1.0,
        seed: int = 0,
        decode_steps: int = 1,
        stop_token: int = -1,
        quantize: str = "",
        quant_group: int = 0,
        attn_impl: str = "auto",
    ) -> None:
        self._init_common(
            params, cfg, num_slots=num_slots, max_len=max_len,
            kv_quant=kv_quant, decode_kernel=decode_kernel,
            temperature=temperature, top_k=top_k, top_p=top_p, seed=seed,
            decode_steps=decode_steps, stop_token=stop_token,
            quantize=quantize, quant_group=quant_group, attn_impl=attn_impl,
        )
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.page_size = page_size
        self.blocks_per_slot = -(-max_len // page_size)
        if num_blocks == 0:
            # full-occupancy default: every slot can hold max_len tokens
            # at once (+ the scratch block), the contiguous cache's budget
            num_blocks = 1 + num_slots * self.blocks_per_slot
        self.num_blocks = num_blocks
        self.cache = self._fresh_cache()
        #: prompt tokens that actually ran through a prefill/extend
        #: forward; shared-prefix tokens never count here
        self.prefilled_tokens = 0

    def _fresh_cache(self):
        return init_paged_cache(
            self.cfg, self.num_blocks, self.page_size, self.kv_quant, device=self.device
        )

    def begin(
        self,
        slot: int,
        prompt: np.ndarray,
        *,
        table_row: Optional[np.ndarray] = None,
        tail_start: int = 0,
        copies: Sequence[Tuple[int, int, int]] = (),
    ) -> int:
        """Prefill ``prompt``'s non-shared tail through ``table_row``;
        returns the first token.  ``copies`` are the admission's COW
        ``(src, dst, logical)`` block copies, applied before any write.
        ``slot`` is accepted for executor-contract compatibility — the
        paged cache addresses rows by block, not by slot."""
        del slot  # the block table, not the lane id, addresses the cache
        if table_row is None:
            raise ValueError("paged begin requires the admission's table_row")
        tail = np.asarray(prompt, np.int32).reshape(-1)[tail_start:]
        t = int(tail.shape[0])
        width = self._bucket(max(t, 1))
        padded = np.zeros((1, width), np.int32)
        padded[0, :t] = tail
        row = np.asarray(table_row, np.int32)

        def run():
            for src, dst, _logical in copies:
                # copy-on-write: one whole-block copy per leaf
                for arr in self.cache.values():
                    arr[:, dst] = arr[:, src]
            if tail_start == 0:
                # no prefix hit: the flash prefill at the BUCKET width,
                # then one scatter of the rows through the table row (pad
                # rows go to the scratch block)
                row_cache, logits = self._prefill(padded, t, width)
                idx = np.arange(width)
                phys = self._tensor(np.where(idx < t, row[idx // self.page_size], SCRATCH_BLOCK), torch.long)
                off = self._tensor(idx % self.page_size, torch.long)
                for name, arr in self.cache.items():
                    arr[:, phys, off] = row_cache[name][:, 0]
            else:
                # prefix hit: run only the tail, attending to the shared
                # blocks through the table (kernel for tails <= 8 tokens)
                logits, self.cache = extend_step(
                    self.params, self.cache, self._tensor(padded), tail_start,
                    self._tensor(np.asarray([t], np.int32)), self._tensor(row[None]), self.cfg,
                    decode_kernel=self.decode_kernel, logical_limit=self.max_len,
                )
            return self._sample(logits).cpu()

        first = self._guarded(run)
        self.prefilled_tokens += t
        return int(first[0])

    def step(
        self, tokens: np.ndarray, cursors: np.ndarray, tables: np.ndarray
    ) -> np.ndarray:
        """One decode iteration over all slots -> next token per slot."""
        return self._step(tokens, cursors, tables)

    def step_scan(
        self,
        prev_tokens: Any,
        prev_cursors: Any,
        override: np.ndarray,
        tokens: np.ndarray,
        cursors: np.ndarray,
        limits: np.ndarray,
        tables: np.ndarray,
    ):
        """Paged deferred/multi-step decode dispatch: same contract as
        :meth:`ModelExecutor.step_scan` plus the per-slot block tables."""
        return self._guarded(
            lambda: self._scan(prev_tokens, prev_cursors, override, tokens, cursors, limits, tables)
        )

    def verify(
        self,
        tokens: np.ndarray,
        cursors: np.ndarray,
        drafts: np.ndarray,
        tables: np.ndarray,
    ) -> np.ndarray:
        """Paged speculative verify: same contract as
        :meth:`ModelExecutor.verify` plus the per-slot block tables."""
        return self._verify(tokens, cursors, drafts, tables)

    # -- KV handoff (serving/handoff.py) -----------------------------------------

    def kv_leaf_specs(self) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
        """Per-BLOCK slice geometry of this executor's cache, the receiver
        side of :func:`~tpu_nexus_torch.serving.handoff.validate_payload`:
        leaf name -> ``((layers, page_size, *trailing), dtype)``."""
        return {
            name: ((int(arr.shape[0]), int(arr.shape[2]), *map(int, arr.shape[3:])), arr.dtype)
            for name, arr in self.cache.items()
        }

    def extract_blocks(self, block_ids: Sequence[int]) -> Dict[str, torch.Tensor]:
        """Gather the physical blocks of one prefilled request to HOST, in
        block-table order — the sender half of a KV handoff.  Each leaf is
        one index gather into a NEW device tensor, then one copy to a
        contiguous CPU tensor of the pool's dtype (the payload's host form,
        serving/handoff.py).  The pool is only read: the request may be
        re-extracted after a dropped transfer."""
        ids = np.asarray(block_ids, np.int64).reshape(-1)
        if ids.shape[0] < 1:
            raise ValueError("extract_blocks requires at least one block id")
        idx = self._tensor(ids, torch.long)
        return self._guarded(
            lambda: {name: arr[:, idx].cpu() for name, arr in self.cache.items()}
        )

    def install_blocks(
        self, payload: "KVHandoffPayload", block_ids: Sequence[int]
    ) -> None:
        """Scatter a handed-off payload's blocks into freshly-allocated
        physical ids — the receiver half of a KV handoff.  VALIDATES first
        (per-block shape/dtype/count against THIS executor's geometry, then
        the sealed CRCs, then the allocated count): a corrupted payload
        raises :class:`~tpu_nexus_torch.serving.handoff.PayloadCorrupt`
        before any device write, so bad bytes never land in the pool, which
        is written in place."""
        ids = np.asarray(block_ids, np.int64).reshape(-1)
        validate_payload(
            payload, page_size=self.page_size, leaf_specs=self.kv_leaf_specs()
        )
        if ids.shape[0] != payload.n_blocks:
            raise PayloadCorrupt(
                f"kv handoff payload for {payload.request_id}: receiver "
                f"allocated {ids.shape[0]} blocks != payload n_blocks {payload.n_blocks}"
            )
        idx = self._tensor(ids, torch.long)

        def run():
            for name, arr in self.cache.items():
                arr[:, idx] = torch.as_tensor(payload.blocks[name]).to(self.device)

        self._guarded(run)


class ServingEngine:
    """Host half: the continuous-batching state machine (see module doc).

    ``executor`` must expose ``num_slots``, ``max_len``, ``begin(slot,
    prompt) -> first_token`` and ``step(tokens, cursors) -> tokens`` —
    :class:`ModelExecutor` in production, a fake in the invariant tests.

    PAGED mode: an executor additionally exposing ``page_size``
    and ``num_blocks`` (:class:`PagedModelExecutor`) flips the engine to
    block-granular admission — it owns a
    :class:`~tpu_nexus_torch.serving.cache_manager.PagedCacheManager`, gates the
    scheduler on block availability instead of slot count, builds each
    admission's block-table row (sharing cached prefix blocks by
    reference, reserving + applying copy-on-write for a partial match),
    registers successful prompts in the prefix index, and releases block
    references at retirement.  ``begin``/``step`` then carry the table
    operands (``table_row``/``tail_start``/``copies`` kwargs and the
    ``tables`` step argument).
    """

    def __init__(
        self,
        executor: Any,
        *,
        scheduler: Optional[FifoScheduler] = None,
        metrics: Optional[ServingMetrics] = None,
        clock: Callable[[], float] = time.monotonic,
        fault_policy: Optional[StepFaultPolicy] = None,
        retired_log_limit: int = 10_000,
        spec_k: int = 0,
        drafter: Optional[Any] = None,
        overlap: bool = False,
        tracer: Optional[Any] = None,
    ) -> None:
        self.executor = executor
        #: request-span tracing + flight recorder
        #: (serving/tracing.py) — DEFAULT ON: pass a
        #: :class:`~tpu_nexus_torch.serving.tracing.NullTracer` to disable (the
        #: bench's tracer-off side; NEXUS_TRACE=0 in the serve loop).
        #: Host-side only, never touches tokens — the token-identity
        #: matrices run tracer-on, which is the proof.
        self.tracer = EngineTracer(clock=clock) if tracer is None else tracer
        #: speculative decoding: propose spec_k draft tokens
        #: per slot each step, verify them in ONE q_len=spec_k+1 call,
        #: emit the accepted prefix + correction.  0 keeps the decode
        #: loop EXACTLY as before (the k=0 path is byte-identical).
        if spec_k < 0:
            raise ValueError(f"spec_k must be >= 0, got {spec_k}")
        if spec_k:
            from tpu_nexus_torch.ops.decode_attention import MAX_DECODE_Q_LEN

            if drafter is None:
                raise ValueError("spec_k > 0 requires a drafter")
            if spec_k + 1 > MAX_DECODE_Q_LEN:
                raise ValueError(
                    f"spec_k {spec_k} exceeds the decode kernel's verify "
                    f"width (q_len = spec_k + 1 <= {MAX_DECODE_Q_LEN})"
                )
            if getattr(executor, "temperature", 0.0) != 0.0:
                raise ValueError(
                    "speculative decoding is greedy-only for now "
                    "(temperature must be 0 until rejection sampling lands)"
                )
        elif drafter is not None:
            raise ValueError("a drafter without spec_k > 0 would never run")
        self.spec_k = spec_k
        self.drafter = drafter
        #: overlapped dispatch + in-jit multi-step decode: the
        #: executor owns the TRACED knobs (decode_steps selects the scan
        #: length, stop_token the in-device stop detection — both baked
        #: into its step_scan jit); the engine only mirrors them for host
        #: bookkeeping, so the two sides can never disagree
        self.decode_steps = int(getattr(executor, "decode_steps", 1) or 1)
        self.overlap = bool(overlap)
        _stop = int(getattr(executor, "stop_token", -1))
        self.stop_token: Optional[int] = _stop if _stop >= 0 else None
        if self.overlap or self.decode_steps > 1:
            if spec_k:
                # the acceptance rule (accept_tokens over the verify
                # readback) runs on HOST — exactly the per-step readback
                # the deferral exists to hide.  Composing them needs
                # in-device acceptance; refuse until that lands.
                raise ValueError(
                    "speculative decoding (spec_k > 0) is mutually exclusive "
                    "with overlap/multi-step decode until in-device "
                    "acceptance lands"
                )
            if not hasattr(executor, "step_scan"):
                raise ValueError(
                    "overlap/multi-step decode requires an executor exposing "
                    "step_scan (ModelExecutor/PagedModelExecutor, or a fake "
                    "implementing the same contract)"
                )
        if self.stop_token is not None and spec_k:
            raise ValueError(
                "stop_token with speculative decoding is not composed yet: "
                "the acceptance rule would emit past an accepted stop token"
            )
        self.slots = KVSlotManager(executor.num_slots, executor.max_len)
        #: block-granular accounting when the executor is paged (exposes
        #: page_size/num_blocks); None keeps the slot-granular contract
        page_size = int(getattr(executor, "page_size", 0) or 0)
        self.paged: Optional[PagedCacheManager] = (
            PagedCacheManager(executor.num_blocks, page_size, executor.max_len)
            if page_size
            else None
        )
        #: per-slot logical->physical block rows (scratch-padded), the
        #: decode step's table operand; all-scratch for inactive slots
        self._tables = (
            np.full(
                (executor.num_slots, self.paged.blocks_per_slot),
                SCRATCH_BLOCK,
                np.int32,
            )
            if self.paged is not None
            else None
        )
        #: admission plans built by the scheduler gate, consumed by
        #: _admit; the generation snapshot detects plans that straddled a
        #: DeviceStateLost reset (their shared blocks' device content is
        #: gone, so they re-plan against the cleared index)
        self._plans: Dict[str, Tuple[AdmitPlan, int]] = {}
        #: (cow copies, shared tokens) per prepared admission, emitted to
        #: metrics only after its begin SUCCEEDS
        self._pending_stats: Dict[str, Tuple[int, int]] = {}
        #: (request_id, probe) handed from _paged_cost to _paged_gate so
        #: one head's budget pricing and admission share a single trie walk
        self._gate_probe: Optional[Tuple[str, Any]] = None
        self.scheduler = scheduler or FifoScheduler()
        self.metrics = metrics or ServingMetrics()
        self._clock = clock
        self.fault_policy = fault_policy or StepFaultPolicy()
        #: set by :meth:`drain`: admission is over, the engine only finishes
        #: (or evicts) what is already in flight
        self.draining = False
        #: set by :meth:`pause_admission` (weight-reload quiesce):
        #: NEW submits shed and the queue stops feeding slots, but — unlike
        #: ``draining`` — queued requests are KEPT: they have no KV state
        #: yet, so they simply wait through the swap and run on the new
        #: weights; the pause is temporary by design
        self.admission_paused = False
        #: completed hot weight swaps (rolling updates land here)
        self.weight_swaps = 0
        self._retired_log_limit = retired_log_limit
        #: LIVE requests only (queued + in flight): retirement removes the
        #: entry, so a long-running engine's memory is bounded by what is
        #: actually in the system, and a retired request_id may be reused
        self.requests: Dict[str, Request] = {}
        self._active: Dict[int, Request] = {}  # slot -> DECODING request
        self._tokens = np.zeros(executor.num_slots, np.int32)
        self._cursors = np.zeros(executor.num_slots, np.int32)
        self._counter = itertools.count()
        #: deferred-dispatch ledgers (serving/overlap.py): pending decode
        #: scans + override/inflight accounting.  Allocated in every mode
        #: (cheap) so the chaos fuzz can assert it stays empty when the
        #: synchronous oracle path runs.
        self._pipeline = DispatchPipeline(executor.num_slots)
        self.steps = 0
        #: per-step observability accumulators (reset at the top of every
        #: step, rung into the flight recorder by _finish_step): host
        #: seconds spent inside jitted dispatches, fault-cause markers,
        #: transient retries spent
        self._step_dispatch_s = 0.0
        self._step_fault_marks: List[str] = []
        self._step_retry_marks = 0
        #: flight-recorder sampling cadence for the paged pool's
        #: reclaimable count — a full prefix-trie walk, priced every Nth
        #: step instead of on the per-step hot path.  load_snapshot()
        #: reads the SAMPLED value through the same cadence (never a
        #: per-snapshot walk): self._blocks_reclaimable holds the latest
        #: sample, _reclaimable_sampled_at the step it was taken
        self._reclaimable_sample_every = 16
        self._blocks_reclaimable = 0
        self._reclaimable_sampled_at = -1
        #: retirement log in order — what the bench and tests audit;
        #: trimmed from the FRONT past ``retired_log_limit`` so a serving
        #: process that never restarts cannot grow it without bound
        self.retired: List[Request] = []
        #: monotonic retirement counter (never trimmed): the incident
        #: seams mark it before retiring and slice the log tail by the
        #: DELTA — a ``len(self.retired)`` mark would misalign the moment
        #: the front-trim fires on a long-lived engine
        self.retired_total = 0

    # -- admission interface ---------------------------------------------------

    def submit(
        self,
        prompt: np.ndarray,
        max_new_tokens: int,
        request_id: Optional[str] = None,
        stream: Optional[Callable[[Request, int], None]] = None,
        deadline_s: Optional[float] = None,
    ) -> Request:
        """Enqueue one generation request; returns its live Request record.
        Raises ValueError when the request can never fit a cache slot
        (prompt + budget > max_len) — a config error, not a lifecycle —
        and :class:`~tpu_nexus_torch.serving.scheduler.QueueFull` when admission
        sheds it (bounded queue at capacity, or the engine is draining);
        sheds are counted on ``serving.shed`` and the client owns the
        retry."""
        rid = request_id if request_id is not None else f"req-{next(self._counter)}"
        if rid in self.requests:
            raise ValueError(f"duplicate request id {rid!r}")
        req = Request(
            request_id=rid,
            prompt=prompt,
            max_new_tokens=max_new_tokens,
            stream=stream,
            deadline_s=deadline_s,
            submitted_at=self._clock(),
        )
        if not self.slots.fits(req.total_len):
            raise ValueError(
                f"request {rid}: prompt {req.prompt_len} + max_new_tokens "
                f"{max_new_tokens} exceeds cache max_len {self.slots.max_len}"
            )
        if self.paged is not None and not self.paged.fits(req.total_len):
            raise ValueError(
                f"request {rid}: {self.paged.blocks_needed(req.total_len)} KV "
                f"blocks needed exceeds the pool's {self.paged.usable_blocks} "
                "usable blocks — it could never be admitted"
            )
        if self.draining:
            self.metrics.shed("draining")
            raise QueueFull(f"request {rid} shed: engine is draining")
        if self.admission_paused:
            self.metrics.shed("reloading")
            raise QueueFull(
                f"request {rid} shed: admission paused for weight reload"
            )
        if self.scheduler.full:
            self.metrics.shed("queue-full")
            raise QueueFull(
                f"request {rid} shed: queue at capacity "
                f"({self.scheduler.cfg.max_queue})"
            )
        self.requests[rid] = req
        self.scheduler.submit(req)
        self.tracer.begin(req)
        return req

    # -- disaggregated serving (serving/handoff.py) ------------------

    def prefill_remote(
        self,
        prompt: np.ndarray,
        request_id: str,
        *,
        source_replica: str = "",
    ) -> "KVHandoffPayload":
        """PREFILL-role entry point: run the fused prefill+insert jit for
        ``prompt`` in a TRANSIENT tenancy (slot + blocks sized to the
        prompt only — no decode budget, no queue, no Request lifecycle),
        gather the written KV blocks to host, and return them as a sealed
        :class:`~tpu_nexus_torch.serving.handoff.KVHandoffPayload` for a decode
        replica to install.  The tenancy is released before returning on
        EVERY path — success hands the bytes off, failure re-raises for
        the fleet's handoff decision tables; either way this engine holds
        nothing for the request afterwards (its prefix index keeps the
        prompt's full blocks cached, so a re-prefill of a shared prefix
        here is a block reference, not recompute).

        Sheds with :class:`QueueFull` when draining/paused or out of
        slot/block capacity — the fleet tries the next prefill replica."""
        if self.paged is None:
            raise ValueError(
                "prefill_remote requires a paged executor (KV handoff is "
                "block-addressed)"
            )
        rid = request_id
        prompt = np.array(prompt, np.int32).reshape(-1)
        prompt_len = int(prompt.shape[0])
        if prompt_len < 1:
            raise ValueError(f"request {rid}: empty prompt")
        if not self.slots.fits(prompt_len) or not self.paged.fits(prompt_len):
            raise ValueError(
                f"request {rid}: prompt {prompt_len} exceeds this replica's "
                f"cache geometry (max_len {self.slots.max_len})"
            )
        if self.draining:
            self.metrics.shed("draining")
            raise QueueFull(f"request {rid} shed: prefill replica is draining")
        if self.admission_paused:
            self.metrics.shed("reloading")
            raise QueueFull(
                f"request {rid} shed: prefill replica paused for weight reload"
            )
        slot = self.slots.allocate(rid)
        if slot is None:
            self.metrics.shed("no-slot")
            raise QueueFull(f"request {rid} shed: no free prefill slot")
        probe = self.paged.index.lookup(prompt)
        if not self.paged.can_admit(prompt, prompt_len, probe=probe):
            self.slots.free(slot)
            self.metrics.shed("no-blocks")
            raise QueueFull(
                f"request {rid} shed: prefill replica lacks free KV blocks"
            )
        plan = self.paged.admit(rid, prompt, prompt_len, probe=probe)
        copies = self.paged.prepare_write(
            rid,
            plan.block_row,
            range(plan.tail_start // self.paged.page_size, plan.n_blocks),
        )
        self._tables[slot] = plan.block_row
        self._pending_stats[rid] = (len(copies), plan.shared_tokens)
        row = plan.block_row
        try:
            first_token = self._dispatch(
                lambda: self.executor.begin(
                    slot, prompt,
                    table_row=row, tail_start=plan.tail_start, copies=copies,
                )
            )
            # cache the prompt for future prefills on THIS replica (only
            # after success — the _admit discipline), count reuse telemetry
            self.paged.register_prompt(rid, prompt, self._tables[slot])
            n_cow, shared = self._pending_stats.pop(rid, (0, 0))
            if n_cow:
                self.metrics.blocks_cow(n_cow)
            if shared:
                self.metrics.prefix_hit(shared)
            # gather BEFORE releasing the tenancy: the blocks stay pinned
            # (and their device content live) until the host copy lands
            blocks = self.executor.extract_blocks(row[: plan.n_blocks])
        except DeviceStateLost as lost:
            self._release_handoff(rid, slot)
            self._fail_batch(lost)
            raise
        except (StepFault, HandoffError):
            self._release_handoff(rid, slot)
            raise
        self._release_handoff(rid, slot)
        return KVHandoffPayload(
            request_id=rid,
            prompt=tuple(int(t) for t in prompt),
            first_token=int(first_token),
            page_size=self.paged.page_size,
            n_blocks=plan.n_blocks,
            blocks=blocks,
            source_replica=source_replica,
        ).seal()

    def admit_prefilled(
        self,
        payload: "KVHandoffPayload",
        max_new_tokens: int,
        *,
        stream: Optional[Callable[[Request, int], None]] = None,
        deadline_s: Optional[float] = None,
        submitted_at: Optional[float] = None,
    ) -> Request:
        """DECODE-role entry point: validate + install a handed-off
        payload's KV blocks into this replica's pool and take OWNERSHIP of
        the request (lifecycle, decode, retirement — from here on it is
        indistinguishable from a locally-prefilled request).  The payload's
        first token is emitted here, so TTFT spans the whole disaggregated
        path when the caller threads the ORIGINAL ``submitted_at`` through.

        Failure semantics: a :class:`~tpu_nexus_torch.serving.handoff.
        HandoffError` (validation reject, injected transfer fault) releases
        the tenancy and re-raises with nothing admitted — the fleet's
        decision tables pick the next hop; capacity refusals shed with
        :class:`QueueFull` exactly like :meth:`submit`."""
        if self.paged is None:
            raise ValueError(
                "admit_prefilled requires a paged executor (KV handoff is "
                "block-addressed)"
            )
        rid = payload.request_id
        if rid in self.requests:
            raise ValueError(f"duplicate request id {rid!r}")
        prompt = np.array(payload.prompt, np.int32)
        req = Request(
            request_id=rid,
            prompt=prompt,
            max_new_tokens=max_new_tokens,
            stream=stream,
            deadline_s=deadline_s,
            submitted_at=self._clock() if submitted_at is None else submitted_at,
        )
        if not self.slots.fits(req.total_len):
            raise ValueError(
                f"request {rid}: prompt {req.prompt_len} + max_new_tokens "
                f"{max_new_tokens} exceeds cache max_len {self.slots.max_len}"
            )
        if not self.paged.fits(req.total_len):
            raise ValueError(
                f"request {rid}: {self.paged.blocks_needed(req.total_len)} KV "
                f"blocks needed exceeds the pool's {self.paged.usable_blocks} "
                "usable blocks — it could never be installed"
            )
        if self.draining:
            self.metrics.shed("draining")
            raise QueueFull(f"request {rid} shed: decode replica is draining")
        if self.admission_paused:
            self.metrics.shed("reloading")
            raise QueueFull(
                f"request {rid} shed: decode replica paused for weight reload"
            )
        slot = self.slots.allocate(rid)
        if slot is None:
            self.metrics.shed("no-slot")
            raise QueueFull(f"request {rid} shed: no free decode slot")
        probe = self.paged.index.lookup(prompt)
        if not self.paged.can_admit(prompt, req.total_len, probe=probe):
            self.slots.free(slot)
            self.metrics.shed("no-blocks")
            raise QueueFull(
                f"request {rid} shed: decode replica lacks free KV blocks"
            )
        plan = self.paged.admit(rid, prompt, req.total_len, probe=probe)
        # the install overwrites every payload block WHOLESALE, so any
        # index-shared block in the written span is swapped for a fresh
        # exclusive one (COW sweep) — but the device-side content copies
        # are skipped: there is nothing to preserve under a full overwrite
        self.paged.prepare_write(rid, plan.block_row, range(plan.n_blocks))
        row = plan.block_row
        self._tables[slot] = row
        req.slot = slot
        req.transition(RequestState.PREFILLING)
        self.tracer.begin(req)
        self.tracer.event(
            req, EV_ADMITTED,
            {"step": self.steps, "slot": slot, "handoff": True,
             "source": payload.source_replica},
        )
        try:
            self._dispatch(
                lambda: self.executor.install_blocks(
                    payload, row[: payload.n_blocks]
                )
            )
        except DeviceStateLost as lost:
            self._release_handoff(rid, slot)
            self._fail_batch(lost)
            raise
        except HandoffError as exc:
            self.tracer.event(
                req, EV_FAULT,
                {"cause": exc.cause, "phase": "handoff-install"},
            )
            self._release_handoff(rid, slot)
            raise
        except StepFault:
            self._release_handoff(rid, slot)
            raise
        self.requests[rid] = req
        # the payload's blocks now ARE this prompt's KV: cache them for
        # future admissions here (fused-fallback reuse included)
        self.paged.register_prompt(rid, prompt, self._tables[slot])
        self.tracer.event(
            req, EV_HANDOFF_INSTALL,
            {"step": self.steps, "n_blocks": payload.n_blocks,
             "source": payload.source_replica, "hops": list(payload.hops)},
        )
        if self.drafter is not None:
            # drafter parity with _admit: a draft-side failure degrades
            # this slot to no-draft proposals, never the admission
            try:
                self.drafter.begin(slot, req.prompt)
                self.drafter.observe(slot, [payload.first_token])
            except (RuntimeError, DeviceStateLost) as exc:  # noqa: BLE001 - drafts are hints: a failed draft prefill degrades that slot to no-draft proposals (counted + logged), the installed admission proceeds untouched
                logger.warning(
                    "drafter %s failed to begin slot %d (%s); the "
                    "request decodes with degraded drafts",
                    getattr(self.drafter, "name", "?"), slot, exc,
                )
                self.metrics.draft_fault()
        req.emit(payload.first_token, self._clock())
        self.metrics.first_token(req)
        if req.done or (
            self.stop_token is not None
            and payload.first_token == self.stop_token
        ):
            self._retire(req, RequestState.FINISHED)
            return req
        req.transition(RequestState.DECODING)
        self._active[slot] = req
        self._cursors[slot] = req.prompt_len
        self._tokens[slot] = req.output_tokens[-1]
        self._pipeline.note_override(slot)
        if self.spec_k:
            self.slots.set_length(slot, req.prompt_len)
        return req

    def _release_handoff(self, rid: str, slot: int) -> None:
        """Tear down a handoff tenancy (prefill-side always; decode-side
        on install failure): free the slot, scrub the table row, drop the
        block references.  The request was never in ``self.requests`` /
        ``_active`` at these seams, so there is nothing to retire — the
        FLEET owns the request's fate and its cause accounting."""
        if self.slots.owner(slot) == rid:
            self.slots.free(slot)
            self._tokens[slot] = 0
            self._cursors[slot] = 0
            if self._tables is not None:
                self._tables[slot] = SCRATCH_BLOCK
        self._pending_stats.pop(rid, None)
        if self.paged is not None and self.paged.owns(rid):
            self.paged.release(rid)

    def cancel(self, request_id: str) -> bool:
        """Flag a request for cancellation; honored at the next step
        boundary.  False when unknown or already terminal."""
        req = self.requests.get(request_id)
        if req is None or req.is_terminal():
            return False
        req.cancel_requested = True
        return True

    @property
    def has_work(self) -> bool:
        return bool(self._active) or self.scheduler.pending > 0

    # -- the step loop ---------------------------------------------------------

    def step(self) -> Dict[str, int]:
        """One engine iteration: cancellations → deadlines →
        admission/prefill → starvation guard → one fault-isolated decode
        step over every live slot.  Returns counts for observability
        ({admitted, decoded, retired})."""
        self.steps += 1
        retired_before = self.retired_total
        deferred_tokens = 0
        self._step_dispatch_s = 0.0
        self._step_fault_marks = []
        self._step_retry_marks = 0

        # 0. a pending dispatch that FAULTED at the call (overlap mode)
        # must resolve BEFORE any scheduling decision below: the sweeps
        # and admission would otherwise run against state the fault
        # already invalidated — in the DeviceStateLost case the executor
        # has silently reinstalled a fresh cache and the paged prefix
        # index is still stale, so a request admitted in the gap would
        # prefill against zeroed shared blocks and then be failed by
        # _fail_batch despite the device being healthy again
        latest = self._pipeline.latest
        if latest is not None and latest.error is not None:
            deferred_tokens = self._materialize_one()

        # 1. cancellations, queued and in-flight — BEFORE the deadline
        # sweep: a request that is both cancel-requested and past-deadline
        # retires CANCELLED (the user's intent), not as an SLO violation
        # an operator would chase
        for req in self.scheduler.remove_cancelled():
            self._retire(req, RequestState.CANCELLED)
        for slot, req in list(self._active.items()):
            if req.cancel_requested:
                self._retire(req, RequestState.CANCELLED)

        # 2. deadline sweep, queued and in-flight: past-deadline requests
        # retire EVICTED with the SCHEDULING_TIMEOUT-mirror cause — checked
        # BEFORE admission so an expired queued request never wastes a
        # prefill, and before decode so a blown latency budget stops
        # burning slot time this very step
        now = self._clock()
        for req in self.scheduler.remove_expired(now):
            self._retire(req, RequestState.EVICTED, cause=CAUSE_DEADLINE)
        for slot, req in list(self._active.items()):
            if req.past_deadline(now):
                self._retire(req, RequestState.EVICTED, cause=CAUSE_DEADLINE)

        # 3. admission: prefill into free slots under the token budget
        # (suspended while draining — nothing new starts during shutdown —
        # and while paused for a weight swap: a prefill run now would pin
        # old-weight KV into a request meant to ride the new weights)
        admitted = (
            0 if (self.draining or self.admission_paused) else self._admit()
        )

        # 4. starvation guard: reclaim the youngest slot for a starving head
        if (
            not self.draining
            and not self.admission_paused
            and self.scheduler.head_starving()
            and self._admission_blocked()
        ):
            victim_slot = self.slots.eviction_candidate()
            if victim_slot is not None:
                self._retire(
                    self._active[victim_slot],
                    RequestState.EVICTED,
                    cause=CAUSE_STARVATION,
                )
                admitted += self._admit()

        # 5. one decode step over every live slot, fault-isolated: a
        # transient fault retries inside the policy (the jitted step is a
        # pure function of its inputs, so a successful retry is
        # token-identical); an unrecoverable fault retires the implicated
        # request — the youngest admission, whose arrival changed the
        # device footprint — and re-attempts with the survivors.  Bounded:
        # each pass either succeeds or shrinks the batch by one.
        # Speculative mode (spec_k > 0) swaps the single-token dispatch
        # for propose → multi-query verify → accept-and-roll-back; the
        # k=0 branch below is untouched, byte-for-byte today's loop.
        if self.spec_k:
            decoded = self._spec_decode()
            return self._finish_step(admitted, decoded, retired_before)
        if self.overlap or self.decode_steps > 1:
            # overlapped dispatch / in-jit multi-step: dispatch
            # step N over the live slots, then materialize step N-1 —
            # emissions, stop detection, retirement — exactly one step
            # late while N executes.  The synchronous k=1 loop below stays
            # byte-identical as the oracle.
            return self._finish_step(
                admitted,
                deferred_tokens + self._pipelined_decode(),
                retired_before,
            )
        decoded = 0
        next_tokens = None
        if self.tracer.enabled:  # don't build attrs dicts for a NullTracer
            for req in self._active.values():
                # sync mode: dispatch and readback are the same point, so
                # ONE span event covers the step (overlap mode records
                # distinct dispatch/materialize events — the deferral
                # made visible)
                self.tracer.event(req, EV_DECODE_DISPATCH, {"step": self.steps})
        while self._active:
            try:
                next_tokens = self._dispatch(self._step_thunk)
                break
            except DeviceStateLost as lost:
                self._fail_batch(lost)
                break
            except StepFault as fault:
                victim_slot = self.slots.eviction_candidate()
                assert victim_slot is not None  # _active nonempty => owned slot
                victim = self._active[victim_slot]
                logger.warning(
                    "step fault [%s] retired request %s (slot %d); "
                    "%d request(s) keep decoding: %s",
                    fault.cause, victim.request_id, victim_slot,
                    len(self._active) - 1, fault.original,
                )
                self.tracer.event(
                    victim, EV_FAULT,
                    {"cause": fault.cause, "retries": fault.retries},
                )
                self._retire(victim, RequestState.FAILED, cause=fault.cause)
                self._dump_incident("step-fault", fault.cause, [victim])
        if next_tokens is not None:
            now = self._clock()
            for slot, req in list(self._active.items()):
                tok = int(next_tokens[slot])
                self._cursors[slot] += 1
                self._tokens[slot] = tok
                self.metrics.token_interval(req.emit(tok, now))
                decoded += 1
                if req.done or (
                    self.stop_token is not None and tok == self.stop_token
                ):
                    self._retire(req, RequestState.FINISHED)
                elif int(self._cursors[slot]) >= self.slots.max_len:
                    # cache overflow — unreachable when submit() enforced
                    # total_len <= max_len, kept as the runtime backstop
                    self._retire(req, RequestState.EVICTED, cause=CAUSE_OVERFLOW)

        return self._finish_step(admitted, decoded, retired_before)

    def _finish_step(
        self, admitted: int, decoded: int, retired_before: int
    ) -> Dict[str, int]:
        """Shared tail of one engine iteration: scheduler tick, occupancy
        gauges, the observability counts."""
        self.scheduler.tick()
        if self.paged is not None:
            # HBM actually held: blocks in use (live requests + cached
            # prefixes), block-granular — the number paging shrinks
            live_tokens = self.paged.used_blocks * self.paged.page_size
            token_capacity = self.paged.token_capacity
        else:
            # rows actually written vs the slots × max_len the slot-
            # granular cache RESERVES — the gap is the paging headroom
            live_tokens = int(self._cursors.sum())
            token_capacity = self.slots.num_slots * self.slots.max_len
        self.metrics.step_gauges(
            self.scheduler.pending, self.slots.used_count, self.slots.num_slots,
            live_tokens=live_tokens, token_capacity=token_capacity,
            deferred_slots=self._pipeline.deferred_slots,
        )
        self.metrics.dispatch_time(self._step_dispatch_s)
        summary = {
            "admitted": admitted,
            "decoded": decoded,
            "retired": self.retired_total - retired_before,
        }
        if not self.tracer.enabled:
            return summary
        # one flight-recorder ring entry per engine step: what the engine
        # was doing in the steps before an incident (the dump seams
        # serialize this ring) — plain host ints only, NX014-clean
        record: Dict[str, Any] = {
            "step": self.steps,
            "t": self._clock(),
            "queue_depth": self.scheduler.pending,
            "batch": {
                int(slot): req.request_id for slot, req in self._active.items()
            },
            "slots_used": self.slots.used_count,
            "slots_free": self.slots.free_count,
            "deferred_slots": self._pipeline.deferred_slots,
            "dispatch_s": round(self._step_dispatch_s, 6),
            **summary,
        }
        if self.paged is not None:
            record["blocks_free"] = self.paged.manager.free_count
            record["blocks_used"] = self.paged.used_blocks
            # reclaimable is a full prefix-trie walk (O(cached blocks)) —
            # too expensive for every step of the dispatch loop NX014
            # keeps lean; SAMPLE it instead.  Rows without the field are
            # between samples, not zero (nxtrace renders it as a stepped
            # counter either way).
            if self.steps % self._reclaimable_sample_every == 0:
                record["blocks_reclaimable"] = self._sample_reclaimable(
                    force=True
                )
        if self._step_fault_marks:
            record["faults"] = list(self._step_fault_marks)
        if self._step_retry_marks:
            record["retries"] = self._step_retry_marks
        self.tracer.record_step(**record)
        return summary

    # -- overlapped dispatch / in-jit multi-step decode -------------

    def _pipelined_decode(self) -> int:
        """One engine iteration of the deferred path: dispatch a k-step
        decode scan over the live slots, then materialize the PREVIOUS
        dispatch (one step late — the readback overlaps with step N's
        device execution).  ``overlap=False`` with ``decode_steps > 1``
        materializes immediately: still one host dispatch per k device
        steps, just without the dispatch-ahead.

        A pending that FAULTED at the dispatch call was already resolved
        at the TOP of :meth:`step` (phase 0) — before the sweeps and
        admission, which must never act on state the fault invalidated —
        so any pending still here has device carries to feed the next
        dispatch."""
        decoded = 0
        dispatched = False
        if self._active:
            limits = self._dispatch_limits()
            if limits.any():
                self._dispatch_scan(limits)
                dispatched = True
        keep = 1 if (self.overlap and dispatched) else 0
        while self._pipeline.depth > keep:
            decoded += self._materialize_one()
        if not self._active and self._pipeline.depth:
            # materializing N-1 retired the last request (stop token /
            # final budget) while dispatch N was already out: N's lanes
            # are all dead (snapshot-identity skip), but leaving it
            # pending would retain its device arrays + request snapshot
            # on an idle engine indefinitely — drain it now
            decoded += self._fence()
        return decoded

    def _dispatch_limits(self) -> np.ndarray:
        """Per-slot emission budget for the next dispatch: the request's
        remaining ``max_new_tokens`` net of tokens already riding
        unmaterialized dispatches, capped at ``decode_steps``.  Inactive
        lanes stay 0 — frozen in-device, they write nothing at all."""
        limits = np.zeros(self.executor.num_slots, np.int32)
        for slot, req in self._active.items():
            remaining = (
                req.max_new_tokens
                - len(req.output_tokens)
                - int(self._pipeline.inflight[slot])
            )
            limits[slot] = max(0, min(remaining, self.decode_steps))
        return limits

    def _dispatch_scan(self, limits: np.ndarray) -> None:
        """Dispatch one ``step_scan`` WITHOUT blocking on its results: the
        previous dispatch's DEVICE outputs carry the token/cursor state
        forward (merged with host overrides for refilled slots inside the
        jit), and the host snapshot needed to reconcile the results one
        step later rides a :class:`PendingStep`.  A dispatch-time fault
        (sync backends, the chaos wrapper) is CAPTURED, not handled — it
        surfaces at materialization through the same recovery policy."""
        prev = self._pipeline.latest
        tokens = self._tokens.copy()
        cursors = self._cursors.copy()
        if prev is None:
            # cold start (or post-fence): no device carries — host state
            # is authoritative for every lane
            override = np.ones(self.executor.num_slots, bool)
            prev_tok: Any = tokens
            prev_pos: Any = cursors
        else:
            override = self._pipeline.override_mask()
            prev_tok, prev_pos = prev.result[2], prev.result[3]
        executor = self.executor
        if self.paged is None:
            def thunk(
                _pt=prev_tok, _pp=prev_pos, _ov=override,
                _t=tokens, _c=cursors, _l=limits,
            ):
                return executor.step_scan(_pt, _pp, _ov, _t, _c, _l)
        else:
            tables = self._tables.copy()
            def thunk(
                _pt=prev_tok, _pp=prev_pos, _ov=override,
                _t=tokens, _c=cursors, _l=limits, _tab=tables,
            ):
                return executor.step_scan(_pt, _pp, _ov, _t, _c, _l, _tab)
        snapshot = dict(self._active)
        pending = PendingStep(
            thunk=thunk,
            snapshot=snapshot,
            # admission order at DISPATCH time: the fault path's victim is
            # the youngest request the faulted step actually contained
            order=[s for s in self.slots.owners() if s in snapshot],
            # where this dispatch's write window STARTS: the host cursor
            # is stale by whatever the still-unmaterialized previous
            # dispatch covers — a lane that survives to materialize here
            # necessarily got its full assumed budget from that dispatch
            # (an early-stop retires it first), so the offset is exact
            cursor_base=cursors.astype(np.int64) + self._pipeline.inflight,
            assumed=limits.copy(),
            step_no=self.steps,
            dispatched_at=self._clock(),
        )
        if self.tracer.enabled:  # don't build attrs dicts for a NullTracer
            for slot in pending.order:
                # deferred mode: dispatch and materialization are DISTINCT
                # span events — this one marks when the request's tokens
                # left the host; EV_MATERIALIZE (one step later) marks
                # when they came back, carrying dispatch_step so the
                # deferral is visible
                self.tracer.event(
                    pending.snapshot[slot], EV_DECODE_DISPATCH,
                    {"step": self.steps, "deferred": True},
                )
        t0 = time.perf_counter()
        try:
            pending.result = pending.thunk()
        except (RuntimeError, DeviceStateLost) as exc:  # noqa: BLE001 - deferred seam: the fault is HELD on the pending record and re-raised at materialization through the SAME recovery policy, one step late by design (the chaos contract)
            pending.error = exc
        self._step_dispatch_s += time.perf_counter() - t0
        self._pipeline.push(pending)

    def _materialize_one(self) -> int:
        """THE sanctioned blocking-readback seam (nxlint NX014): pop the
        oldest pending dispatch, force its device results to host, and
        apply its emissions — stop detection, retirement sweeps — one step
        late.  Faults (captured at dispatch, or surfacing only now at the
        deferred readback on async backends) route through the SAME
        :class:`StepFaultPolicy` as the synchronous loop: transient causes
        re-run the captured thunk (a pure function of its operands —
        token-identical for surviving rows), unrecoverable causes retire
        the DISPATCH-time youngest request and re-run for the rest."""
        pending = self._pipeline.pop()
        first = [True]

        def attempt():
            if first[0]:
                first[0] = False
                if pending.error is not None:
                    raise pending.error
                result = pending.result
            else:
                result = pending.thunk()
            # the deferred readback: np.asarray forces the device values —
            # on async backends this is where a dispatch fault surfaces
            return tuple(np.asarray(x) for x in result)

        while True:
            try:
                toks, counts, _last_tok, _last_pos = self._dispatch(attempt)
                break
            except DeviceStateLost as lost:
                self._fail_batch(lost)
                return 0
            except StepFault as fault:
                victim = None
                for slot in reversed(pending.order):
                    if self._active.get(slot) is pending.snapshot[slot]:
                        victim = pending.snapshot[slot]
                        break
                if victim is None:
                    return 0  # every request of that dispatch already retired
                survivors = (
                    sum(
                        1
                        for s, r in pending.snapshot.items()
                        if self._active.get(s) is r
                    )
                    - 1
                )
                logger.warning(
                    "deferred step fault [%s] retired request %s (slot %d); "
                    "%d request(s) keep decoding: %s",
                    fault.cause, victim.request_id, victim.slot,
                    survivors, fault.original,
                )
                self.tracer.event(
                    victim, EV_FAULT,
                    {
                        "cause": fault.cause,
                        "retries": fault.retries,
                        # surfaced at materialization, one step after the
                        # dispatch that captured it — the held-fault
                        # timeline the chaos tests pin
                        "held": True,
                        "dispatch_step": pending.step_no,
                    },
                )
                self._retire(victim, RequestState.FAILED, cause=fault.cause)
                self._dump_incident("step-fault", fault.cause, [victim])
        decoded = 0
        now = self._clock()
        for slot in pending.order:
            req = pending.snapshot[slot]
            if self._active.get(slot) is not req:
                continue  # retired (cancel/deadline/fault) since dispatch
            self._pipeline.credit(pending, slot)
            n = int(counts[slot])
            if n <= 0:
                continue
            if self.tracer.enabled:
                self.tracer.event(
                    req, EV_MATERIALIZE,
                    {"step": self.steps, "dispatch_step": pending.step_no,
                     "n": n},
                )
            dt = None if req.last_token_at is None else now - req.last_token_at
            emitted = [int(t) for t in toks[slot, :n]]
            for tok in emitted:
                req.emit(tok, now)
            self._cursors[slot] = int(pending.cursor_base[slot]) + n
            self._tokens[slot] = emitted[-1]
            # mean-preserving multi-token accounting: n samples of dt/n
            self.metrics.batch_tokens(dt, n)
            decoded += n
            stopped = (
                self.stop_token is not None and emitted[-1] == self.stop_token
            )
            if req.done or stopped:
                self._retire(req, RequestState.FINISHED)
            elif int(self._cursors[slot]) >= self.slots.max_len:
                # cache overflow — unreachable when submit() enforced
                # total_len <= max_len, kept as the runtime backstop
                self._retire(req, RequestState.EVICTED, cause=CAUSE_OVERFLOW)
        return decoded

    def _fence(self) -> int:
        """Materialize EVERY pending dispatch — the admission/swap/drain
        boundary fence.  Lifecycle decisions that must not act on stale
        state (drain shedding, quiesce eviction, weight swaps, abandon
        accounting) call this first, so no request can lose an in-flight
        token to a decision that pretended the token didn't exist."""
        decoded = 0
        while self._pipeline.depth:
            decoded += self._materialize_one()
        return decoded

    def _propose_safe(self, k: int) -> np.ndarray:
        """Run the drafter's proposal round with the fault boundary drafts
        deserve: they are HINTS — correctness never depends on them (the
        verify's own argmax decides every emitted token) — so a drafter
        failure (a draft MODEL's device fault, a desynced lookup) must
        never cost a request, let alone the step.  Degrade to zero drafts
        for this step (the verify still emits >= 1 correct token per
        slot), count it, and keep serving; a drafter that faults every
        step shows up as serving.draft_faults + acceptance 0, not an
        outage.  This is deliberately NOT the StepFaultPolicy: retrying a
        draft buys nothing a zero draft doesn't."""
        try:
            return self.drafter.propose(
                self._tokens, self._cursors, tuple(self._active), k
            )
        except (RuntimeError, DeviceStateLost) as exc:  # noqa: BLE001 - drafts are hints: a draft-side fault degrades to no-draft (counted + logged), never to a failed request — the verify argmax alone decides emitted tokens
            logger.warning(
                "drafter %s failed to propose (%s); decoding this step "
                "without drafts", getattr(self.drafter, "name", "?"), exc,
            )
            self.metrics.draft_fault()
            return np.zeros((self.executor.num_slots, k), np.int32)

    def _verify_thunk(self, drafts: np.ndarray):
        """The speculative verify dispatch the fault policy retries —
        paged mode adds the per-slot block tables."""
        if self.paged is None:
            return self.executor.verify(self._tokens, self._cursors, drafts)
        return self.executor.verify(
            self._tokens, self._cursors, drafts, self._tables
        )

    def _spec_decode(self) -> int:
        """One speculative engine iteration over the live slots:
        drafter proposes k candidates per slot, ONE multi-query
        verify dispatch scores them all (fault-isolated exactly like the
        plain step), and each slot emits its longest accepted prefix plus
        the target's correction token — by construction the same tokens
        greedy decoding would emit, just fewer device steps apart.

        Rollback: the per-slot cursor advances only past ACCEPTED tokens;
        rejected rows sit above it, masked and overwritten (contiguous) or
        released back to the pool with regrowth credits (paged —
        :meth:`PagedCacheManager.truncate`/``extend``, audited by
        ``verify_consistent``)."""
        if not self._active:
            return 0
        k = self.spec_k
        drafts = self._propose_safe(k)
        if self.tracer.enabled:  # don't build attrs dicts for a NullTracer
            drafter_name = getattr(self.drafter, "name", "?")
            for req in self._active.values():
                # propose + the verify dispatch it feeds, one span event
                # (the acceptance outcome lands as EV_SPEC_ACCEPT after
                # readback)
                self.tracer.event(
                    req, EV_SPEC_PROPOSE,
                    {"step": self.steps, "k": k, "drafter": drafter_name},
                )
        if self.paged is not None:
            # the verify window writes positions [cursor, cursor + k]; a
            # prior rollback may have released the request's tail blocks,
            # so regrow coverage (guaranteed: regrowth consumes the
            # request's own truncate credits) before the dispatch.  The
            # window is clamped to total_len — positions past the
            # request's allocation divert to the scratch sink in-kernel.
            for slot, req in self._active.items():
                need = min(int(self._cursors[slot]) + 1 + k, req.total_len)
                for logical, block in self.paged.extend(req.request_id, need):
                    self._tables[slot][logical] = block
        greedy = None
        while self._active:
            try:
                greedy = self._dispatch(lambda: self._verify_thunk(drafts))
                break
            except DeviceStateLost as lost:
                self._fail_batch(lost)
                break
            except StepFault as fault:
                victim_slot = self.slots.eviction_candidate()
                assert victim_slot is not None  # _active nonempty => owned slot
                victim = self._active[victim_slot]
                logger.warning(
                    "verify fault [%s] retired request %s (slot %d); "
                    "%d request(s) keep decoding: %s",
                    fault.cause, victim.request_id, victim_slot,
                    len(self._active) - 1, fault.original,
                )
                self.tracer.event(
                    victim, EV_FAULT,
                    {"cause": fault.cause, "retries": fault.retries},
                )
                self._retire(victim, RequestState.FAILED, cause=fault.cause)
                self._dump_incident("step-fault", fault.cause, [victim])
        decoded = 0
        if greedy is None:
            return 0
        now = self._clock()
        for slot, req in list(self._active.items()):
            c = int(self._cursors[slot])
            remaining = req.max_new_tokens - len(req.output_tokens)
            emitted, n_draft = accept_tokens(drafts[slot], greedy[slot], remaining)
            e = len(emitted)
            dt = None if req.last_token_at is None else now - req.last_token_at
            for tok in emitted:
                req.emit(tok, now)
            self._cursors[slot] = c + e
            self._tokens[slot] = emitted[-1]
            self.metrics.spec_tokens(dt, e)
            self.metrics.spec_verify(proposed=k, accepted=n_draft)
            if self.tracer.enabled:
                self.tracer.event(
                    req, EV_SPEC_ACCEPT,
                    {"step": self.steps, "proposed": k, "accepted": n_draft,
                     "emitted": e},
                )
            self.drafter.observe(slot, emitted)
            decoded += e
            # rollback audit: the verify wrote KV through position c + k
            # (draft overshoot); only [.., c + e) survives as live state.
            # Contiguous: record high-water then clamp (verify_consistent
            # checks the books).  Paged: additionally release garbage-only
            # tail blocks with regrowth credits and scrub the table row.
            written = min(c + 1 + k, self.slots.max_len)
            self.slots.set_length(slot, written)
            self.slots.truncate(slot, c + e)
            if self.paged is not None:
                released = self.paged.truncate(req.request_id, c + e)
                if released:
                    keep = len(self.paged.manager.request_blocks(req.request_id))
                    row = self._tables[slot]
                    for i in range(keep, keep + len(released)):
                        row[i] = SCRATCH_BLOCK
                    self.metrics.spec_rollback_blocks(len(released))
            if req.done:
                self._retire(req, RequestState.FINISHED)
            elif int(self._cursors[slot]) >= self.slots.max_len:
                # cache overflow — unreachable when submit() enforced
                # total_len <= max_len, kept as the runtime backstop
                self._retire(req, RequestState.EVICTED, cause=CAUSE_OVERFLOW)
        return decoded

    def run_until_drained(self, max_steps: int = 1_000_000) -> None:
        """Step until queue and slots are empty; ``max_steps`` is the
        liveness backstop (a bug that wedges a request must fail the run,
        not spin it).  The failure message names WHICH requests are stuck
        and in what state — the first thing an on-call needs."""
        while self.has_work:
            if self.steps >= max_steps:
                stuck = [
                    f"{r.request_id}[{r.state}]"
                    for r in (*self.scheduler.queued_requests(), *self._active.values())
                ]
                shown = ", ".join(stuck[:16]) + (
                    f", ... ({len(stuck) - 16} more)" if len(stuck) > 16 else ""
                )
                raise RuntimeError(
                    f"engine not drained after {max_steps} steps: "
                    f"{self.scheduler.pending} queued, {len(self._active)} active; "
                    f"stuck requests: {shown}"
                )
            self.step()

    def drain(self, grace_s: float, max_steps: int = 1_000_000) -> Dict[str, int]:
        """Graceful shutdown (SIGTERM / preemption): stop admission, shed
        the queue immediately (nothing queued can ever run again), keep
        decoding in-flight requests under the ``grace_s`` budget, then
        evict whatever remains — every request lands a terminal state with
        an honest cause, never a hang.  Returns a summary for the final
        ledger report; per-cause counts live in
        ``metrics.retired_causes``."""
        self.draining = True
        drain_mark = self.retired_total
        # fence BEFORE any shedding decision: in-flight dispatches carry
        # real tokens (possibly a request's final one) — materialize them
        # so the drain never evicts a request that had already finished
        self._fence()
        for req in self.scheduler.remove_cancelled():
            self._retire(req, RequestState.CANCELLED)
        shed_queue = 0
        for req in self.scheduler.drain_queue():
            self._retire(req, RequestState.EVICTED, cause=CAUSE_DRAIN_SHED)
            shed_queue += 1
        deadline = self._clock() + max(0.0, grace_s)
        finished_before = self.metrics.retired.get(RequestState.FINISHED, 0)
        steps = 0
        while self._active and steps < max_steps and self._clock() < deadline:
            self.step()
            steps += 1
        evicted = 0
        for req in list(self._active.values()):
            self._retire(req, RequestState.EVICTED, cause=CAUSE_DRAIN_GRACE)
            evicted += 1
        logger.info(
            "drain complete: %d steps, %d finished in grace, %d evicted, "
            "%d shed from queue",
            steps,
            self.metrics.retired.get(RequestState.FINISHED, 0) - finished_before,
            evicted, shed_queue,
        )
        # drain/SIGTERM incident seam: one artifact carrying the final
        # flight-recorder window + every timeline the drain retired, so
        # the PREEMPTED ledger row's per-cause counts have a drill-down
        self._dump_incident("drain", "drain", self._retired_since(drain_mark))
        return {
            "drain_steps": steps,
            "drain_finished": self.metrics.retired.get(RequestState.FINISHED, 0)
            - finished_before,
            "drain_evicted": evicted,
            "drain_shed_queue": shed_queue,
        }

    # -- load snapshot: the pressure plane's input ------------------

    def _sample_reclaimable(self, force: bool = False) -> int:
        """The paged pool's reclaimable-block count, SAMPLED: the full
        prefix-trie walk runs at most once per ``_reclaimable_sample_every``
        engine steps (``force`` re-walks now — the flight recorder's
        cadence slot), and both the recorder and :meth:`load_snapshot`
        read the cached sample in between.  0 on a non-paged engine."""
        if self.paged is None:
            return 0
        if force or (
            self.steps - self._reclaimable_sampled_at
            >= self._reclaimable_sample_every
        ):
            self._blocks_reclaimable = self.paged.index.reclaimable(
                self.paged.manager
            )
            self._reclaimable_sampled_at = self.steps
        return self._blocks_reclaimable

    def load_snapshot(self, replica: str = "") -> LoadSnapshot:
        """This engine's load state as plain host ints/floats — the
        pressure plane's per-replica signal (serving/loadstats.py,
        docs/OBSERVABILITY.md).  NX014-clean by the flight recorder's
        materialized-state discipline: every field is host state the
        engine already owned (scheduler counts, slot/block books, metric
        counters, windowed percentiles) — taking a snapshot performs no
        device readback and cannot perturb the token stream.  Percentiles
        are the RECENT window (``ServingMetrics.slo_window``), the
        reclaimable-block count the sampled one (never a fresh full-trie
        walk per snapshot).  ``replica`` names the snapshot at
        construction — the per-step observation path would otherwise pay
        a full frozen-dataclass rebuild (``dataclasses.replace``) just to
        stamp the name."""
        if self.paged is not None:
            blocks_used = self.paged.used_blocks
            blocks_free = self.paged.manager.free_count
            reclaimable = self._sample_reclaimable()
        else:
            blocks_used = blocks_free = reclaimable = 0
        return LoadSnapshot(
            replica=replica,
            queue_depth=self.scheduler.pending,
            live_requests=len(self._active),
            slots_used=self.slots.used_count,
            slots_free=self.slots.free_count,
            deferred_slots=self._pipeline.deferred_slots,
            token_occupancy=self.metrics.token_occupancy,
            blocks_used=blocks_used,
            blocks_free=blocks_free,
            blocks_reclaimable=reclaimable,
            weight_bytes=getattr(self.executor, "weight_bytes", 0),
            weight_swaps=self.weight_swaps,
            shed_total=self.metrics.shed_total,
            requests_retired=self.retired_total,
            tokens_out=self.metrics.tokens_out,
            engine_steps=self.steps,
            **self.metrics.slo_window(),
        )

    def prefix_shared_len(self, prompt: Any) -> int:
        """Router affinity probe (serving/router.py): how many leading
        prompt tokens THIS replica already holds as cached KV.  Strictly
        read-only — the probe runs against every candidate replica per
        routed request, so it must not refresh LRU clocks on replicas the
        request never lands on (``PrefixIndex.lookup(touch=False)``).
        0 on a non-paged engine (no prefix cache, no affinity signal)."""
        if self.paged is None:
            return 0
        return int(self.paged.index.lookup(prompt, touch=False).shared_len)

    def dump_pressure(self, reason: str) -> Optional[Dict[str, Any]]:
        """SLO-saturation incident seam: serialize the flight
        recorder + every LIVE request's timeline when the pressure monitor
        grades this replica SATURATED — a saturation incident gets the
        same drill-down a fault does (what was queued, how long requests
        waited, where the dispatch time went).  Returns the new artifact's
        inventory entry, or None when tracing is off / the dump budget is
        spent / an earlier artifact would be passed off as this incident's
        (the fleet's kill_replica identity rule)."""
        before = self.last_incident_dump
        self._dump_incident("saturation", reason, list(self.requests.values()))
        after = self.last_incident_dump
        return after if after is not before else None

    # -- rolling weight updates --------------------------------------

    @property
    def in_flight(self) -> int:
        """Requests currently holding a slot (prefilled — their KV embeds
        the CURRENT weights).  What the quiesce protocol must finish before
        a swap; queued requests are not in flight."""
        return len(self._active)

    def pause_admission(self) -> None:
        """Stop accepting NEW submits (they shed ``QueueFull`` with reason
        ``reloading`` — the fleet router retries another replica) AND stop
        feeding queued requests into slots.  Unlike :meth:`drain`, the
        queue is KEPT: a queued request has no KV state, so it safely waits
        through the weight swap and runs entirely on the new weights —
        which is exactly why a reload never needs to drop it."""
        self.admission_paused = True

    def resume_admission(self) -> None:
        self.admission_paused = False

    def evict_in_flight(self, cause: str) -> int:
        """Evict every IN-FLIGHT (slotted) request with the honest
        ``cause`` — the grace-expiry backstop of the quiesce protocol (and
        of the fleet's rolling update).  Queued requests are untouched:
        they can still run on whatever weights come next.  Returns how
        many were evicted."""
        self._fence()  # a deferred final token must land before eviction
        evicted = 0
        for req in list(self._active.values()):
            self._retire(req, RequestState.EVICTED, cause=cause)
            evicted += 1
        return evicted

    def abandon(self, cause: str) -> int:
        """The replica's PROCESS is gone (serving pod killed): every live
        request died with it, so the fleet accounts them here — decoding
        requests retire ``FAILED`` with the classified ``cause`` (device
        time was lost mid-generation), queued ones ``EVICTED`` (they never
        got device time — same wording contract as a drain shed).  Returns
        how many requests were accounted."""
        # the process is going away — account whatever already made it
        # back from the device before writing the requests off
        self._fence()
        mark = self.retired_total
        n = 0
        for req in self.scheduler.drain_queue():
            self._retire(req, RequestState.EVICTED, cause=cause)
            n += 1
        for req in list(self._active.values()):
            self._retire(req, RequestState.FAILED, cause=cause)
            n += 1
        # fleet replica-lost incident seam: the controller merges this
        # artifact's path into the ledger incident record it writes
        self._dump_incident("replica-lost", cause, self._retired_since(mark))
        return n

    def quiesce(self, grace_s: float, max_steps: int = 1_000_000) -> Dict[str, int]:
        """Weight-swap preamble: pause admission, keep stepping until every
        IN-FLIGHT request finishes on the current weights, bounded by the
        ``grace_s`` budget — stragglers past the budget evict with cause
        :data:`CAUSE_RELOAD_GRACE` so the swap can never hang behind one
        slow generation.  Queued requests are deliberately NOT drained:
        they carry no KV, so they wait through the swap and run on the new
        weights — a deep queue costs a reload nothing.  Admission STAYS
        paused on return: the caller swaps params and then
        :meth:`resume_admission`."""
        self.pause_admission()
        deadline = self._clock() + max(0.0, grace_s)
        finished_before = self.metrics.retired.get(RequestState.FINISHED, 0)
        steps = 0
        while self._active and steps < max_steps and self._clock() < deadline:
            self.step()
            steps += 1
        evicted = self.evict_in_flight(CAUSE_RELOAD_GRACE)
        return {
            "quiesce_steps": steps,
            "quiesce_finished": self.metrics.retired.get(RequestState.FINISHED, 0)
            - finished_before,
            "quiesce_evicted": evicted,
        }

    def swap_params(self, params: Any) -> None:
        """Install new weights into the quiesced engine (the rolling-update
        seam).  Refuses while requests are in flight — a mid-generation
        swap would emit tokens from MIXED weights, which no client asked
        for; callers hold :meth:`quiesce` first.  Queued-but-unstarted
        requests are fine: their prefill has not run, so they execute
        entirely on the new weights.

        In paged mode the prefix index is RESET: every cached prefix block
        holds KV computed with the old weights, and serving one as a
        shared prefix of a new-weights prompt would mix weights through
        the cache instead of the params.  NX008 holds the verified-step
        contract (see the executor-level docstring)."""
        # fence first: a pending dispatch is literally a device step on the
        # OLD weights — materialize it (possibly finishing its requests)
        # before judging whether anything is still in flight
        self._fence()
        if self._active:
            raise RuntimeError(
                f"swap_params with {len(self._active)} request(s) in flight "
                "— quiesce() the engine first (a mid-generation swap would "
                "serve tokens from mixed weights)"
            )
        self.executor.swap_params(params)
        if self.paged is not None:
            # old-weight KV must never be served as a cached prefix of a
            # new-weight prompt: drop the index, invalidate plans
            self.paged.reset()
        self.weight_swaps += 1
        self.metrics.weight_swap()

    # -- internals -------------------------------------------------------------

    @property
    def last_incident_dump(self) -> Optional[Dict[str, Any]]:
        """Path/reason/causes of the most recent flight-recorder artifact
        (None when tracing is off or nothing dumped) — what the serve loop
        and the fleet controller merge into ledger details."""
        return self.tracer.last_dump

    def _retired_since(self, mark: int) -> List[Request]:
        """Requests retired since ``mark`` (a ``retired_total`` snapshot),
        read off the log's TAIL — correct across the front-trim that a
        plain ``len(self.retired)`` slice index is not (the trim shifts
        every index; the tail delta is invariant).  Retirements beyond
        ``retired_log_limit`` since the mark are gone from the log and
        honestly absent here."""
        since = self.retired_total - mark
        keep = min(since, len(self.retired))
        return self.retired[len(self.retired) - keep:]

    def _dump_incident(self, seam: str, reason: str, reqs: Sequence[Request]) -> None:
        """Serialize the flight-recorder ring + the implicated requests'
        timelines at one of the incident seams (step-fault escalation,
        device-state-lost, drain/SIGTERM, replica-lost).  ``seam`` is the
        bounded metrics tag; ``reason`` the specific cause baked into the
        artifact name.  Best-effort by the recorder's contract — a failed
        write is counted, never raised."""
        full = (
            reason
            if reason == seam or reason.startswith(f"{seam}:")
            else f"{seam}:{reason}"
        )
        path = self.tracer.dump(
            full,
            reqs,
            extra={"engine_steps": self.steps, "seam": seam},
        )
        if path is not None:
            self.metrics.trace_dump(seam)
            logger.warning(
                "flight recorder dumped %d step record(s) to %s (%s)",
                len(self.tracer.recorder.records), path, reason,
            )

    def _dispatch(self, fn: Callable[[], Any]) -> Any:
        """Run one jitted dispatch through the fault policy; feed the
        policy's audit counters into metrics.  Raises :class:`StepFault`
        for unrecoverable classified faults (caller retires the implicated
        request), re-raises unclassified errors."""
        retries_before = self.fault_policy.retries_used
        t0 = time.perf_counter()
        try:
            result = self.fault_policy.run(fn)
        except StepFault as fault:
            self.metrics.step_fault(fault.cause, fault.retries)
            self._step_fault_marks.append(fault.cause)
            raise
        except DeviceStateLost:
            self._step_fault_marks.append("device-state-lost")
            raise
        finally:
            # host dispatch latency, accumulated per step for the flight
            # recorder + serving.dispatch_seconds (faulted attempts count:
            # a step that burned its budget in retries IS slow)
            self._step_dispatch_s += time.perf_counter() - t0
        recovered = self.fault_policy.retries_used - retries_before
        if recovered:
            self.metrics.step_recovered(recovered)
            self._step_retry_marks += recovered
        return result

    def _step_thunk(self):
        """The decode dispatch the fault policy retries — paged mode adds
        the per-slot block tables as the third step operand."""
        if self.paged is None:
            return self.executor.step(self._tokens, self._cursors)
        return self.executor.step(self._tokens, self._cursors, self._tables)

    def _admission_blocked(self) -> bool:
        """Why is the starving queue head not getting in — no free slot,
        or (paged) not enough free/reclaimable blocks for it?  Gates the
        starvation guard: reclaiming the youngest running request frees
        both its slot and its block references."""
        if self.slots.free_count == 0:
            return True
        if self.paged is None:
            return False
        head = self.scheduler.head()
        assert head is not None  # head_starving() => nonempty
        return not self.paged.can_admit(head.prompt, head.total_len)

    def _paged_gate(self, req: Request) -> bool:
        """Scheduler admission gate in paged mode: admit iff the block
        pool can host the request, EAGERLY building its admission plan
        (pinning shared prefix blocks, reserving the COW copy, allocating
        the exclusive tail) so consecutive admissions of one batch see
        each other's allocations.  Safe to be side-effectful: a True
        return guarantees the scheduler pops the request this call
        (scheduler.admit contract), and _prepare_begin consumes the plan."""
        assert self.paged is not None
        if self._gate_probe is not None and self._gate_probe[0] == req.request_id:
            probe = self._gate_probe[1]  # _paged_cost already walked the trie
        else:
            probe = self.paged.index.lookup(req.prompt)
        if not self.paged.can_admit(req.prompt, req.total_len, probe=probe):
            return False
        plan = self.paged.admit(req.request_id, req.prompt, req.total_len, probe=probe)
        self._plans[req.request_id] = (plan, self.paged.generation)
        return True

    def _paged_cost(self, req: Request) -> int:
        """Budget price of one head = the prefill work it would ACTUALLY
        run: its prompt minus the cached shared prefix (shared tokens are
        served by block reference, not prefill).  The probe is cached for
        :meth:`_paged_gate`, which the scheduler calls immediately after
        for the same head — nothing touches the trie in between."""
        assert self.paged is not None
        probe = self.paged.index.lookup(req.prompt)
        self._gate_probe = (req.request_id, probe)
        return req.prompt_len - probe.shared_len

    def _prepare_begin(self, slot: int, req: Request) -> Optional[Callable[[], int]]:
        """Build the executor.begin thunk for one admission.  Slot-
        granular: the classic (slot, prompt) call.  Paged: consume the
        gate's plan — re-planning first if a DeviceStateLost reset
        invalidated it (shared device content is gone; None when even a
        shareless re-plan no longer fits, the caller retires) — install
        the slot's block-table row, copy-on-write any shared block the
        tail prefill will land in, and hand the executor the table
        operands.  The COW copies re-apply idempotently under the fault
        policy's retries.

        The plan is also RE-PROBED against the prefix index here: gate
        plans for one admission batch are all built before any prefill
        runs, so when an earlier admission of the SAME batch registered
        this prompt's prefix (the burst fan-out case — N copies of one
        system prompt submitted together), the stale plan would prefill
        tokens that are now cached.  A strictly longer match releases the
        plan and re-admits: the re-plan shares more and owns less, so it
        can only need FEWER blocks than the ones just released."""
        if self.paged is None:
            return lambda: self.executor.begin(slot, req.prompt)
        plan, generation = self._plans.pop(req.request_id)
        if generation != self.paged.generation:
            self.paged.release(req.request_id)
            if not self.paged.can_admit(req.prompt, req.total_len):
                return None
            plan = self.paged.admit(req.request_id, req.prompt, req.total_len)
        else:
            probe = self.paged.index.lookup(req.prompt)
            if probe.shared_len > plan.shared_tokens:
                # release only touches the allocator, never the trie, so
                # the probe stays current across it
                self.paged.release(req.request_id)
                plan = self.paged.admit(
                    req.request_id, req.prompt, req.total_len, probe=probe
                )
        copies = self.paged.prepare_write(
            req.request_id,
            plan.block_row,
            range(plan.tail_start // self.paged.page_size, plan.n_blocks),
        )
        self._tables[slot] = plan.block_row
        # reuse metrics are emitted by _admit only AFTER the begin
        # succeeds (same discipline as register_prompt): a FAILED prefill
        # must not count shared tokens that were never served
        self._pending_stats[req.request_id] = (len(copies), plan.shared_tokens)
        row = plan.block_row
        return lambda: self.executor.begin(
            slot, req.prompt,
            table_row=row, tail_start=plan.tail_start, copies=copies,
        )

    def _spec_cost(self, req: Request) -> int:
        """Admission cost with a PREFILLING drafter (speculative mode,
        ``drafter.prefills_prompt``): the draft model prefills the FULL
        prompt into its own contiguous cache inside the same admission,
        so the scheduler's prefill-token budget must price BOTH forward
        passes — target (paged: the unshared tail) + draft (always the
        whole prompt; the draft cache has no prefix sharing)."""
        base = (
            self._paged_cost(req) if self.paged is not None else req.prompt_len
        )
        return base + req.prompt_len

    def _admit(self) -> int:
        gate = self._paged_gate if self.paged is not None else None
        cost = self._paged_cost if self.paged is not None else None
        if self.spec_k and getattr(self.drafter, "prefills_prompt", False):
            cost = self._spec_cost
        admitted = self.scheduler.admit(self.slots.free_count, gate, cost)
        for req in admitted:
            slot = self.slots.allocate(req.request_id)
            assert slot is not None, "scheduler admitted beyond free slots"
            req.slot = slot
            req.transition(RequestState.PREFILLING)
            wait_s = self._clock() - req.submitted_at
            self.metrics.queue_wait(wait_s)
            self.tracer.event(
                req, EV_ADMITTED,
                {"step": self.steps, "slot": slot,
                 "queue_wait_s": round(wait_s, 6)},
            )
            begin = self._prepare_begin(slot, req)
            if begin is None:
                # the admission plan straddled a device reset and the
                # shareless re-plan no longer fits the pool
                self._retire(req, RequestState.FAILED, cause="device-state-lost")
                continue
            self.tracer.event(req, EV_PREFILL_DISPATCH, {"step": self.steps})
            try:
                # same recovery policy as the decode step; a prefill fault
                # implicates exactly ONE request — this one.  Transient
                # causes re-run the begin itself (backoff + jitter inside).
                first_token = self._dispatch(begin)
            except DeviceStateLost as lost:
                self._fail_batch(lost, extra=req)
                continue
            except StepFault as fault:
                logger.warning(
                    "prefill fault [%s] retired request %s (slot %d); "
                    "engine keeps serving: %s",
                    fault.cause, req.request_id, slot, fault.original,
                )
                self.tracer.event(
                    req, EV_FAULT,
                    {"cause": fault.cause, "retries": fault.retries,
                     "phase": "prefill"},
                )
                self._retire(req, RequestState.FAILED, cause=fault.cause)
                self._dump_incident("step-fault", fault.cause, [req])
                continue
            shared = n_cow = 0
            if self.paged is not None:
                # cache the prompt's full blocks for future admissions —
                # only now, after the prefill that filled them succeeded —
                # and only now count the admission's reuse telemetry
                self.paged.register_prompt(
                    req.request_id, req.prompt, self._tables[slot]
                )
                n_cow, shared = self._pending_stats.pop(req.request_id, (0, 0))
                if n_cow:
                    self.metrics.blocks_cow(n_cow)
                if shared:
                    self.metrics.prefix_hit(shared)
            self.tracer.event(
                req, EV_PREFILL_COMPLETE,
                {"step": self.steps, "prefilled": req.prompt_len - shared,
                 "shared_tokens": shared, "cow_blocks": n_cow},
            )
            if self.drafter is not None:
                # the drafter's slot state mirrors the request's tenancy:
                # begin BEFORE any retire path can run, observe the
                # prefill's first token like every later accepted token.
                # Same hint boundary as _propose_safe: a draft-side fault
                # here (the draft MODEL's prefill hitting a device error)
                # costs this request its drafts, never its admission —
                # stale/absent draft state only yields rejected proposals.
                try:
                    self.drafter.begin(slot, req.prompt)
                    self.drafter.observe(slot, [first_token])
                except (RuntimeError, DeviceStateLost) as exc:  # noqa: BLE001 - drafts are hints: a failed draft prefill degrades that slot to no-draft proposals (counted + logged), the TARGET admission proceeds untouched
                    logger.warning(
                        "drafter %s failed to begin slot %d (%s); the "
                        "request decodes with degraded drafts",
                        getattr(self.drafter, "name", "?"), slot, exc,
                    )
                    self.metrics.draft_fault()
            req.emit(first_token, self._clock())
            self.metrics.first_token(req)
            if req.done or (
                self.stop_token is not None and first_token == self.stop_token
            ):  # max_new_tokens == 1, or the prefill sampled the stop token
                self._retire(req, RequestState.FINISHED)
                continue
            req.transition(RequestState.DECODING)
            self._active[slot] = req
            self._cursors[slot] = req.prompt_len
            self._tokens[slot] = req.output_tokens[-1]
            # deferred dispatch: this lane's HOST token/cursor is now
            # authoritative — the next step_scan merges it over whatever
            # the device still carries for the slot's previous tenant
            self._pipeline.note_override(slot)
            if self.spec_k:
                # seed the rollback audit: prompt + the pending first
                # token's future write = the slot's live coverage
                self.slots.set_length(slot, req.prompt_len)
        return len(admitted)

    def _fail_batch(self, lost: DeviceStateLost, extra: Optional[Request] = None) -> None:
        """A fault consumed the executor's device state (donated cache):
        every in-flight request's KV is gone, so ALL of them retire FAILED
        with the classified cause — and the engine keeps serving, because
        the executor already reinstalled a fresh cache for new
        admissions."""
        cause = self.fault_policy.classify(lost.original) or "device-state-lost"
        victims = list(self._active.values())
        if extra is not None:
            victims.append(extra)
        logger.error(
            "device state lost [%s]: failing %d in-flight request(s); "
            "engine continues on a fresh cache: %s",
            cause, len(victims), lost.original,
        )
        self.metrics.step_fault(cause, 0)
        self._step_fault_marks.append(cause)
        for req in victims:
            self.tracer.event(req, EV_FAULT, {"cause": cause, "batch_wide": True})
            self._retire(req, RequestState.FAILED, cause=cause)
        self._dump_incident("device-state-lost", cause, victims)
        # every pending result references the CONSUMED device state — drop
        # them all; the next dispatch starts from host state wholesale
        self._pipeline.clear()
        if self.paged is not None:
            # the executor reinstalled a ZEROED cache: every cached prefix
            # is garbage now — drop the whole index and invalidate any
            # outstanding admission plan (generation bump), or the next
            # prefix hit would serve zeros as a shared prompt
            self.paged.reset()

    def _retire(self, req: Request, terminal_state: str, cause: str = "") -> None:
        """Retire ``req`` into ``terminal_state``: transition, release the
        slot, emit metrics.  Dispatch is through RETIREMENT_ACTIONS —
        total over TERMINAL_STATES by nxlint NX005.  ``cause`` records WHY
        for non-FINISHED outcomes (failure classification, deadline, drain
        — see the CAUSE_* constants)."""
        action = RETIREMENT_ACTIONS[terminal_state]
        req.transition(terminal_state)
        if cause:
            req.cause = cause
        req.finished_at = self._clock()
        if req.slot is not None and self.slots.owner(req.slot) == req.request_id:
            self._active.pop(req.slot, None)
            self.slots.free(req.slot)
            self._tokens[req.slot] = 0
            self._cursors[req.slot] = 0
            # deferred ledger: nothing of this request rides the device
            # any more for budgeting purposes, and whatever a pending
            # dispatch still carries for the lane is skipped (snapshot
            # identity check) at materialization
            self._pipeline.note_retired(req.slot)
            if self._tables is not None:
                self._tables[req.slot] = SCRATCH_BLOCK
            if self.drafter is not None:
                self.drafter.retire(req.slot)
        if self.paged is not None:
            self._plans.pop(req.request_id, None)  # un-begun admission
            self._pending_stats.pop(req.request_id, None)  # failed begin
            if self.paged.owns(req.request_id):
                # drop every block reference: exclusive blocks free now,
                # index-cached prefix blocks stay for future admissions
                self.paged.release(req.request_id)
        # terminal span event: state/action/cause + the TTFT/TPOT summary,
        # computed from the SAME Request timestamps the metrics histograms
        # read — tracing and metrics cannot disagree
        self.tracer.terminal(req, action)
        self.metrics.retired_request(req, action)
        self.requests.pop(req.request_id, None)  # bound live-request memory
        self.retired.append(req)
        self.retired_total += 1
        if len(self.retired) > self._retired_log_limit:
            del self.retired[: len(self.retired) - self._retired_log_limit]
        logger.info(
            "request %s %s after %d tokens",
            req.request_id,
            action,
            len(req.output_tokens),
        )
