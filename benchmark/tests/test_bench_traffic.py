"""The traffic generator: the same seed gives the same traffic, two seeds
the same sizes in another order, and the sizes and token ids follow the
mix's stated distributions."""

import numpy as np

from benchmark import traffic
from benchmark.common import HERE, load_json

SEEDS = [0, 7, 2**31 + 11, 3 * 2**32 + 5]


def _mix(name):
    return load_json(HERE / "traffic" / f"{name}.json")


def test_train_batches_are_deterministic_distinct_and_packed():
    mix = _mix("s8k")
    a, b = traffic.train_batches(mix, 32768, SEEDS[2]), traffic.train_batches(mix, 32768, SEEDS[2])
    first = [next(a) for _ in range(3)]
    assert all((x == next(b)).all() for x in first)
    assert first[0].shape == (mix["batch"], mix["seq_len"]) and first[0].dtype == np.int32
    rows = np.concatenate(first)
    assert len({r.tobytes() for r in rows}) == len(rows)
    eos = (rows == mix["documents"]["eos"]).sum(axis=1)
    per_row = mix["seq_len"] / np.mean(traffic.lognormal_set(4096, mix["documents"]))
    assert (abs(eos - per_row) < 0.5 * per_row + 3).all()
    assert rows.min() >= 0 and rows.max() < 32768


def _doc_lengths(rows, eos):
    """Lengths of the documents that end inside each row."""
    out = []
    for r in rows:
        ends = np.flatnonzero(r == eos)
        out += np.diff(np.concatenate([[-1], ends])).tolist()
    return out


def test_two_seeds_draw_the_same_document_lengths_in_another_order():
    lengths = traffic.lognormal_set(4096, _mix("s8k")["documents"])
    # one row holding every length of the set once
    mix = dict(_mix("s8k"), seq_len=int(lengths.sum()), batch=1)
    eos = mix["documents"]["eos"]
    a = _doc_lengths(next(traffic.train_batches(mix, 32768, SEEDS[1])), eos)
    b = _doc_lengths(next(traffic.train_batches(mix, 32768, SEEDS[3])), eos)
    assert a != b
    assert sorted(a) == sorted(b) == sorted(lengths.tolist())


def test_token_ids_follow_the_stated_unigram_weights():
    offset = _mix("s8k")["tokens"]["zipf_offset"]
    ids = traffic.token_ids(traffic.rng_for(SEEDS[2], 1), 2_000_000, 32768, offset)
    counts = np.bincount(ids, minlength=32768)
    w = 1.0 / (np.arange(32768) + offset)
    want = 2_000_000 * w / w.sum()
    assert np.allclose(counts[:20], want[:20], rtol=0.05)
    assert abs(counts[:1000].sum() - want[:1000].sum()) / want[:1000].sum() < 0.01


def test_lognormal_set():
    x = traffic.lognormal_set(1000, {"median": 100, "sigma": 1.0, "min": 10, "max": 1000})
    assert x.min() == 10 and x.max() == 1000 and np.median(x) == 100
    q84 = np.quantile(x, 0.8413)
    assert abs(q84 - 100 * np.e) / (100 * np.e) < 0.02
