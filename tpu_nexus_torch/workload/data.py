"""Synthetic token stream: a copy of ``tpu_nexus/workload/data.py::
synthetic_tokens`` (numpy only), so the same seed gives the same prompts
in both packages."""

from __future__ import annotations

from typing import Iterator

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
