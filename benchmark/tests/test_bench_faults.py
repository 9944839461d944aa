"""A run of each cell, its look for a chip skipped, on the CPU at a tiny
size, held to the cell's own limits: with the timed path broken
underneath, ``correct`` comes out false, once for each fault the cell can
have, and the fault reads well above the sound run of the same seed."""

import copy
import time

import pytest
import torch

from benchmark.common import HERE, load_json
from benchmark.drive_train import half_batch
from benchmark.run import run_cell
from benchmark.tests.tiny import tiny_ctx

SEED = 2**31 + 77


def _run(cell, hooks=None):
    ctx = tiny_ctx(cell, limits=load_json(HERE / "limits" / f"{cell}.json"))
    return run_cell(ctx, SEED, 0.5, False, "cpu", hooks=dict(hooks or {}, t_start=time.monotonic()))


def unchanged_state(step):
    """The step computes, and returns the state it was given untouched."""
    def wrapped(state, batch):
        _, metrics = step(copy.deepcopy(state), batch)
        return state, metrics
    return wrapped


TRAIN = [w["name"] for w in load_json(HERE.parent / "BENCHMARK.json")["workloads"]
         if load_json(HERE / "traffic" / f"{w['traffic']}.json")["kind"] == "train"]


_SOUND = {}


def _sound(cell):
    if cell not in _SOUND:
        _SOUND[cell] = _run(cell)
    return _SOUND[cell]


@pytest.mark.parametrize("cell", TRAIN)
def test_sound_run_reads_finite_numbers_near_the_limits(cell):
    out = _sound(cell)
    assert out["checks"] and all(0 <= c["value"] < 10 * c["limit"] for c in out["checks"].values()), out["checks"]


def _broken(cell, hooks):
    out, sound = _run(cell, hooks), _sound(cell)["readings"]
    assert not out["correct"], out["checks"]
    assert any(v > 3 * sound[k] for k, v in out["readings"].items()), (out["readings"], sound)


@pytest.mark.parametrize("fault", [unchanged_state, half_batch], ids=lambda f: f.__name__)
@pytest.mark.parametrize("cell", TRAIN)
def test_training_faults_are_not_correct(cell, fault):
    _broken(cell, {"wrap_step": fault})


def test_the_faults_break_what_they_claim():
    tokens = torch.zeros((4, 8), dtype=torch.long)
    seen = []
    half_batch(lambda s, b: seen.append(b.shape[0]) or (s, {}))({}, tokens)
    assert seen == [2]
    state = {"w": torch.ones(2)}

    def step(s, b):
        s["w"] += 1
        return s, {"loss": torch.tensor(1.0)}
    assert unchanged_state(step)(state, tokens)[0]["w"].tolist() == [1.0, 1.0]
