"""Speculative multi-token decoding: the drafting subsystem.

The engine's plain decode loop emits ONE token per device step, so the
per-step fixed costs (host dispatch, kernel launch, weight streaming) are
paid per token.  Speculative decoding amortizes them: a cheap *drafter*
proposes ``k`` candidate continuations per slot, the target model scores
``[last_token, d_1, ..., d_k]`` in ONE multi-query verify call (q_len =
k+1 through the decode kernel's in-block causal masking, per-slot
ragged via ``q_starts``), and the engine accepts the longest prefix whose
candidates match the target's own greedy argmax — emitting up to k+1
tokens per device step while staying TOKEN-IDENTICAL to one-shot greedy
``generate`` (the acceptance oracle; drafts can only change HOW FAST the
greedy stream is produced, never which tokens it contains).

Drafters (the :data:`DRAFTERS` registry — nxlint NX013 requires every
entry to be named by a parity test under ``tests/``):

* ``ngram`` — :class:`NGramDrafter`, self-speculative prompt-lookup
  (Saxena 2023 / Yang et al. 2023 "LLMA"-style): no extra model; the
  draft for a slot is the continuation of the most recent earlier
  occurrence of the slot's current suffix n-gram inside its own prompt +
  generated tokens.  Free to propose, strong on repetitive/extractive
  traffic (code, quoting, templated text), useless on novelty — which is
  fine, a rejected draft costs only the verify row it rode in.
* ``model`` — :class:`ModelDrafter`, a small draft model run through the
  EXISTING :class:`~tpu_nexus_torch.serving.engine.ModelExecutor` jits (its own
  contiguous KV cache, slot-aligned with the target engine): k greedy
  per-slot decode steps per proposal round.  Draft-side rollback is free:
  the next proposal round passes the target's clamped cursors, so stale
  draft KV above them is masked and overwritten — no separate sync
  protocol.

Acceptance (:func:`accept_tokens`) is deliberately a tiny pure function:
it IS the correctness core of the subsystem, so it is unit-tested
directly and the engine consumes it unchanged.  Greedy-only for now —
``ServeConfig`` rejects temperature > 0 with speculation at parse until
rejection sampling lands.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple, Type

import numpy as np


def accept_tokens(
    drafts: Sequence[int], greedy: Sequence[int], limit: int
) -> Tuple[List[int], int]:
    """Longest-prefix verify-k acceptance for one slot.

    ``drafts`` are the k proposed candidates, ``greedy`` the target
    model's k+1 greedy tokens from the verify call — ``greedy[j]`` is the
    argmax CONDITIONED on drafts ``< j`` having been consumed, i.e. the
    token that truly follows there.  Draft ``j`` is accepted iff
    ``drafts[j] == greedy[j]`` and every earlier draft was accepted; the
    emitted stream is the accepted drafts plus the one correction/bonus
    token ``greedy[m]`` — by construction exactly the tokens one-shot
    greedy decoding would emit, which is the whole safety argument.
    ``limit`` caps emission at the request's remaining token budget.

    Returns ``(emitted, n_draft)`` — the tokens to emit (1 <= len <=
    min(k+1, limit)) and how many of them came from the draft (the honest
    ``spec_accepted`` numerator: a draft token counts only if it was both
    accepted AND emitted)."""
    if limit < 1:
        raise ValueError(f"acceptance limit must be >= 1, got {limit}")
    if len(greedy) != len(drafts) + 1:
        raise ValueError(
            f"verify returned {len(greedy)} greedy tokens for "
            f"{len(drafts)} drafts — expected k+1"
        )
    m = 0
    while m < len(drafts) and int(drafts[m]) == int(greedy[m]):
        m += 1
    e = min(m + 1, limit)
    return [int(t) for t in greedy[:e]], min(m, e)


class Drafter:
    """Interface the speculative engine drives.  Slot-aligned with the
    target engine: ``begin``/``observe``/``retire`` track one request's
    tenancy of a slot, ``propose`` runs once per engine step over ALL
    slots (batched — a model-backed drafter turns it into k device
    steps).  Implementations must be deterministic: the engine's replay
    and parity tests assume a fixed request set drafts identically."""

    #: registry key; also the ``NEXUS_SPEC_DRAFTER`` value
    name = "abstract"
    #: True when :meth:`begin` runs a draft-model prefill of the full
    #: prompt — the engine then CHARGES that work against the scheduler's
    #: prefill-token budget too (admission cost accounting must price the
    #: work actually interleaved with the decode step, and a draft
    #: prefill is exactly as real as the target's)
    prefills_prompt = False

    def begin(self, slot: int, prompt: np.ndarray) -> None:
        """A request was admitted to ``slot`` with ``prompt`` (its first
        output token follows via :meth:`observe`)."""
        raise NotImplementedError

    def observe(self, slot: int, tokens: Sequence[int]) -> None:
        """``tokens`` were emitted (accepted) for ``slot``'s request —
        the drafter's only view of the target's progress."""
        raise NotImplementedError

    def retire(self, slot: int) -> None:
        """``slot``'s tenant retired; drop its draft state.  Must
        tolerate slots it never saw (a begin that faulted before the
        drafter heard about it)."""
        raise NotImplementedError

    def propose(
        self,
        tokens: np.ndarray,
        cursors: np.ndarray,
        slots: Sequence[int],
        k: int,
    ) -> np.ndarray:
        """Propose ``k`` candidate tokens per slot: ``tokens`` [num_slots]
        are the engine's last emitted tokens, ``cursors`` [num_slots] its
        per-slot write positions, ``slots`` the ACTIVE subset.  Returns
        int32 [num_slots, k]; inactive rows are don't-care (the engine
        discards them).  Every returned row is a full k-wide guess — a
        weak guess is fine (mismatches are rejected by verify), a short
        row is not (shapes stay static so the verify jit compiles once)."""
        raise NotImplementedError


class NGramDrafter(Drafter):
    """Self-speculative prompt-lookup drafter: propose the continuation of
    the most recent earlier occurrence of the slot's current suffix
    n-gram inside its own context (prompt + generated).  Tries suffix
    lengths ``max_ngram`` down to ``min_ngram`` (longer matches are
    stronger evidence); when no suffix recurs — or the match's
    continuation is shorter than k — pads by repeating the context's last
    token, the weakest honest guess (still submitted to verify; the
    acceptance rate reports it truthfully)."""

    name = "ngram"

    def __init__(
        self,
        num_slots: int,
        max_ngram: int = 3,
        min_ngram: int = 1,
        window: int = 256,
    ) -> None:
        if not 1 <= min_ngram <= max_ngram:
            raise ValueError(
                f"need 1 <= min_ngram <= max_ngram, got {min_ngram}/{max_ngram}"
            )
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self.num_slots = num_slots
        self.max_ngram = max_ngram
        self.min_ngram = min_ngram
        #: how far back the suffix search looks.  Proposals run on the
        #: host BEFORE every verify dispatch, so an unbounded scan would
        #: grow the per-step host cost linearly with generation length
        #: (quadratic over a request's life) — and the repetition n-gram
        #: drafting feeds on is recent-local anyway
        self.window = window
        self._ctx: Dict[int, List[int]] = {}

    def begin(self, slot: int, prompt: np.ndarray) -> None:
        self._ctx[slot] = [int(t) for t in np.asarray(prompt).reshape(-1)]

    def observe(self, slot: int, tokens: Sequence[int]) -> None:
        ctx = self._ctx.get(slot)
        if ctx is not None:
            ctx.extend(int(t) for t in tokens)

    def retire(self, slot: int) -> None:
        self._ctx.pop(slot, None)

    def lookup(self, ctx: Sequence[int], k: int) -> List[int]:
        """The prompt-lookup core, exposed for unit tests: longest-suffix
        / most-recent-occurrence match (within the last ``window``
        tokens), continuation truncated to k.  Element-wise comparison,
        no per-position slice allocations — this runs per slot per engine
        step on the host, ahead of the verify dispatch."""
        n_hi = min(self.max_ngram, len(ctx) - 1)
        for n in range(n_hi, self.min_ngram - 1, -1):
            tail = ctx[-n:]
            # most recent earlier occurrence: scan right-to-left over
            # start positions strictly before the suffix itself, bounded
            # by the recency window
            lo = max(0, len(ctx) - n - self.window)
            for i in range(len(ctx) - n - 1, lo - 1, -1):
                hit = True
                for j in range(n):
                    if ctx[i + j] != tail[j]:
                        hit = False
                        break
                if hit:
                    return [int(t) for t in ctx[i + n : i + n + k]]
        return []

    def propose(
        self,
        tokens: np.ndarray,
        cursors: np.ndarray,
        slots: Sequence[int],
        k: int,
    ) -> np.ndarray:
        del cursors  # context lists, not cache cursors, drive the lookup
        out = np.zeros((self.num_slots, k), np.int32)
        for slot in slots:
            ctx = self._ctx.get(slot)
            if not ctx:
                continue
            if int(tokens[slot]) != ctx[-1]:
                raise RuntimeError(
                    f"ngram drafter out of sync on slot {slot}: engine last "
                    f"token {int(tokens[slot])} != observed {ctx[-1]}"
                )
            guess = self.lookup(ctx, k)
            guess += [ctx[-1]] * (k - len(guess))  # weakest honest pad
            out[slot] = np.asarray(guess[:k], np.int32)
        return out


class ModelDrafter(Drafter):
    """Small-draft-model drafter: ``executor`` is a greedy
    :class:`~tpu_nexus_torch.serving.engine.ModelExecutor` over the DRAFT
    model's params, slot-for-slot aligned with the target engine (same
    ``num_slots``/``max_len``, same vocab).  One proposal round = k
    per-slot decode steps through the draft jits.  Draft-side rollback
    needs no protocol: each round starts from the target's (possibly
    clamped) cursors, so draft KV above them is masked stale and
    overwritten in place — the same free-rollback property the target's
    contiguous cache has."""

    name = "model"
    prefills_prompt = True  # begin() prefills the draft cache — budget it

    def __init__(self, executor) -> None:
        if getattr(executor, "temperature", 0.0) != 0.0:
            raise ValueError(
                "ModelDrafter requires a greedy draft executor "
                "(temperature == 0): drafts must be deterministic"
            )
        self.executor = executor

    def begin(self, slot: int, prompt: np.ndarray) -> None:
        # prefill the draft cache; the draft's own first-token sample is
        # discarded — the TARGET's prefill decides the first token
        self.executor.begin(slot, np.asarray(prompt, np.int32))

    def observe(self, slot: int, tokens: Sequence[int]) -> None:
        # nothing to do: the next propose() receives the engine's
        # post-acceptance (token, cursor) state, which resyncs the draft
        # cache by overwriting from the clamped cursor
        del slot, tokens

    def retire(self, slot: int) -> None:
        del slot  # the next tenant's begin() overwrites the slot row

    def propose(
        self,
        tokens: np.ndarray,
        cursors: np.ndarray,
        slots: Sequence[int],
        k: int,
    ) -> np.ndarray:
        del slots  # the draft step is batched over every lane anyway
        toks = np.asarray(tokens, np.int32).copy()
        curs = np.asarray(cursors, np.int32).copy()
        out = np.zeros((toks.shape[0], k), np.int32)
        for j in range(k):
            nxt = np.asarray(self.executor.step(toks, curs), np.int32)
            out[:, j] = nxt
            toks = nxt
            curs = curs + 1
        # one extra WRITE-ONLY step (prediction discarded): it lands
        # d_k's draft KV at cursor + k, so when the target accepts ALL k
        # drafts (advancing k+1 positions) the next round's attention
        # window is fully covered — without it the draft cache carries a
        # zero-KV hole that silently craters later acceptance
        self.executor.step(toks, curs)
        return out


#: registered drafters: ``NEXUS_SPEC_DRAFTER`` values → implementations.
#: nxlint NX013 fails the repo gate when an entry here is not named by a
#: parity test under tests/ (the NX009 chaos-coverage pattern applied to
#: the acceptance oracle).
#: keys are LITERAL strings (matching each class's ``name``) so nxlint can
#: read the registry as plain AST, the NX001/NX005 table convention
DRAFTERS: Dict[str, Type[Drafter]] = {
    "ngram": NGramDrafter,
    "model": ModelDrafter,
}
