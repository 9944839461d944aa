"""The one general generator of the benchmark's traffic, driven by a mix's
data file (``traffic/<mix>.json``) and the run's seed.

Sizes come from a fixed set per mix and only their order from the seed:
each length is a quantile of the mix's clipped lognormal at evenly spaced
probabilities, and the seed permutes them.  So two seeds give the same work
in another order, and runs with different seeds differ no more than two runs
of one seed would.  Token ids come from the seed.
"""

from __future__ import annotations

from statistics import NormalDist
from typing import Dict, Iterator

import numpy as np

_NORMAL = NormalDist()


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """An independent generator for one stream of one seed (any whole seed,
    negative or past 64 bits)."""
    return np.random.default_rng([stream, seed % (1 << 64), abs(seed) >> 64])


def lognormal_set(n: int, spec: Dict) -> np.ndarray:
    """``n`` lengths: the clipped lognormal's quantiles at (i + 1/2) / n."""
    u = (np.arange(n) + 0.5) / n
    z = np.array([_NORMAL.inv_cdf(p) for p in u])
    x = np.exp(np.log(spec["median"]) + spec["sigma"] * z)
    return np.clip(np.rint(x), spec["min"], spec["max"]).astype(np.int64)


def token_ids(rng: np.random.Generator, n: int, vocab: int, offset: float = 10.0) -> np.ndarray:
    """``n`` token ids with unigram weights 1 / (rank + offset)."""
    w = 1.0 / (np.arange(vocab) + offset)
    cdf = np.cumsum(w / w.sum())
    return np.minimum(np.searchsorted(cdf, rng.random(n)), vocab - 1).astype(np.int32)


def train_batches(mix: Dict, vocab: int, seed: int) -> Iterator[np.ndarray]:
    """Endless ``[batch, seq_len]`` int32 batches of packed documents: each
    row is filled with documents of the mix's lengths, each ended by the
    EOS id, the last cut at the row's end.  Every row differs."""
    b, s = mix["batch"], mix["seq_len"]
    docs = mix["documents"]
    lengths = lognormal_set(4096, docs)
    rng = rng_for(seed, 1)
    offset = mix.get("tokens", {}).get("zipf_offset", 10)
    order = rng.permutation(lengths)
    i = 0
    while True:
        rows = token_ids(rng, b * s, vocab, offset).reshape(b, s)
        rows[rows == docs["eos"]] += 1  # EOS only ends documents
        for r in range(b):
            pos = 0
            while pos < s:
                pos += int(order[i % len(order)])
                i += 1
                if pos <= s:
                    rows[r, pos - 1] = docs["eos"]
        yield rows
