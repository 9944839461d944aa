"""Data streams: a copy of ``tpu_nexus/workload/data.py`` (numpy only), so
the same seed gives the same batches in both packages — the synthetic
token and mnist streams, the memory-mapped ``.npy`` token corpus, and the
:class:`DataCursor` that makes restarts and health skips replay the exact
schedule."""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Optional, Sequence

import numpy as np


def synthetic_tokens(
    batch: int,
    seq_len: int,
    vocab_size: int,
    seed: int = 0,
) -> Iterator[np.ndarray]:
    """Zipf-ish token stream: structured enough that a model can reduce loss,
    cheap enough to never bottleneck the device step."""
    rng = np.random.default_rng(seed)
    # static unigram distribution ~ 1/(rank+10)
    ranks = np.arange(vocab_size, dtype=np.float64)
    probs = 1.0 / (ranks + 10.0)
    probs /= probs.sum()
    while True:
        yield rng.choice(vocab_size, size=(batch, seq_len), p=probs).astype(np.int32)


def token_corpus_len(path: str) -> int:
    """Token count of a corpus file (mmap header read only)."""
    return int(np.load(path, mmap_mode="r").shape[0])


def token_file_batches(
    path: str,
    batch: int,
    seq_len: int,
    seed: int = 0,
    start: int = 0,
    end: Optional[int] = None,
) -> Iterator[np.ndarray]:
    """Batches of random seq_len windows from a memory-mapped token corpus.

    The corpus format is a 1-D integer ``.npy`` array of token ids —
    self-describing (dtype + length in the header), memory-mapped so a
    multi-gigabyte corpus costs no RSS and no startup time.  Sampling is
    epochless uniform random windows, deterministic in ``seed``: the
    harness hands each process ``seed + process_id`` (disjoint shards, no
    data service) and restart-from-step fast-forwards the stream by
    drawing and discarding, which reproduces exactly the batches the
    interrupted run saw — the same contract :func:`synthetic_tokens`
    established.

    ``start``/``end`` restrict sampling to a token range — the train/eval
    split of one corpus file (windows are drawn wholly inside the range).
    """
    # validate eagerly (this wrapper is not a generator, so a bad corpus
    # fails at construction, not at the first batch draw)
    corpus = np.load(path, mmap_mode="r")
    if corpus.ndim != 1 or not np.issubdtype(corpus.dtype, np.integer):
        raise ValueError(
            f"token corpus {path} must be a 1-D integer .npy array, got "
            f"shape {corpus.shape} dtype {corpus.dtype}"
        )
    end = corpus.shape[0] if end is None else min(end, corpus.shape[0])
    if end - start < seq_len:
        raise ValueError(
            f"token corpus {path} range [{start}, {end}) has "
            f"{end - start} tokens < seq_len {seq_len}"
        )

    def gen() -> Iterator[np.ndarray]:
        rng = np.random.default_rng(seed)
        # inclusive hi: the final window [end - seq_len, end) is reachable
        hi = end - seq_len
        while True:
            starts = rng.integers(start, hi + 1, size=batch)
            yield np.stack(
                [corpus[s : s + seq_len] for s in starts]
            ).astype(np.int32)

    return gen()


def write_token_npy(path: str, tokens: np.ndarray) -> str:
    """Persist a 1-D token-id array as the corpus format above (helper for
    tests and corpus-prep scripts)."""
    tokens = np.asarray(tokens)
    if tokens.ndim != 1 or not np.issubdtype(tokens.dtype, np.integer):
        raise ValueError("tokens must be a 1-D integer array")
    np.save(path, tokens)
    return path if path.endswith(".npy") else path + ".npy"


class DataCursor:
    """Deterministic batch cursor over a seeded stream.

    The harness's restart contract ("restart-from-step must also
    restart-from-*data*") used to be a bare fast-forward by step count.
    Health-policy recovery (workload/health.py) adds a second requirement:
    after a rollback the run must *skip* the poisoned batch window and a
    later restart must reproduce exactly that skipped schedule.  The cursor
    makes both explicit:

    * ``position`` counts every batch drawn from the underlying stream —
      including discarded ones — so ``fast_forward(position)`` on a fresh
      stream lands at the identical point (PRNG streams are deterministic
      in their seed; draws are the only state);
    * ``skips`` records ``[start, end)`` windows in draw-index space.
      A window recorded *behind* the cursor (the rollback case: those
      draws already happened) is pure bookkeeping; a window *ahead* of the
      cursor (a restored run, or a fault-free comparator replaying a
      recovered run's schedule) is discarded draw-by-draw when the cursor
      reaches it.

    ``state()``/``fast_forward`` round-trip through the checkpoint cursor
    sidecar (tensor_checkpoint.save_cursor), which the commit manifest
    covers like any other payload file.
    """

    def __init__(self, stream: Iterator[Any], skips: Optional[Sequence[Sequence[int]]] = None) -> None:
        self._stream = stream
        self.position = 0
        self.skips: List[List[int]] = []
        for window in skips or ():
            self.skip_window(int(window[0]), int(window[1]))

    def _draw(self) -> Any:
        batch = next(self._stream)
        self.position += 1
        return batch

    def __iter__(self) -> "DataCursor":
        return self

    def __next__(self) -> Any:
        # discard through any pending window covering the current position;
        # windows may abut, so re-check until the position is clear
        advanced = True
        while advanced:
            advanced = False
            for start, end in self.skips:
                if start <= self.position < end:
                    while self.position < end:
                        self._draw()
                    advanced = True
        return self._draw()

    def skip_window(self, start: int, end: int) -> None:
        """Register ``[start, end)`` (draw indices) as skipped.  Recording a
        window that was already consumed (``end <= position``) only
        documents it for the sidecar/ledger; a future window is enforced
        during iteration."""
        start, end = int(start), int(end)
        if not 0 <= start < end:
            raise ValueError(f"invalid skip window [{start}, {end})")
        self.skips.append([start, end])
        self.skips.sort()

    def fast_forward(self, position: int) -> None:
        """Draw-and-discard until ``position`` draws have happened — the
        restart replay.  ``position`` already counts skipped draws, so this
        is a raw replay with no window logic."""
        if position < self.position:
            raise ValueError(
                f"cannot rewind a stream: at draw {self.position}, asked for {position}"
            )
        while self.position < position:
            self._draw()

    def state(self) -> Dict[str, Any]:
        return {"position": self.position, "skips": [list(w) for w in self.skips]}

    @staticmethod
    def restore(stream: Iterator[Any], state: Dict[str, Any]) -> "DataCursor":
        """Rebuild the cursor over a FRESH seeded stream from sidecar state:
        replay the draws, re-register the windows."""
        cursor = DataCursor(stream)
        cursor.fast_forward(int(state.get("position", 0)))
        for window in state.get("skips", ()):
            cursor.skip_window(int(window[0]), int(window[1]))
        return cursor


def synthetic_mnist(batch: int, seed: int = 0) -> Iterator[tuple]:
    """(images [B, 784] f32, labels [B] i32) pairs with class-dependent means
    so training actually separates them."""
    rng = np.random.default_rng(seed)
    class_means = rng.normal(0.0, 1.0, size=(10, 784)).astype(np.float32)
    while True:
        labels = rng.integers(0, 10, size=(batch,))
        images = class_means[labels] + rng.normal(0, 0.5, size=(batch, 784)).astype(np.float32)
        yield images.astype(np.float32), labels.astype(np.int32)
