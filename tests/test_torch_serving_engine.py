"""The port's continuous-batching engine against the JAX package's.

* **Engine fuzz** — the port's ``ServingEngine`` and the JAX package's,
  each driven by the same numpy fake executor (``FakeExecutor``, mirroring
  ``tests/test_serving_engine.py``) and the same fake clock over 50 seeded
  arrival patterns (bursts and trickles, cancels, deadlines, a bounded
  queue, the starvation guard, multi-step and overlapped dispatch,
  speculative decoding with the ngram drafter): identical retirement order,
  tokens, terminal states and causes, and identical sheds.
* **Host modules** — ``accept_tokens`` and the ngram drafter on random
  inputs, side by side.
* **Real tiny executors** — the port's engine over the port's
  ``ModelExecutor`` against the JAX engine over the JAX executor, greedy,
  f32 ``tiny``: contiguous, int8-KV, speculative (ngram, and a self-draft
  model drafter) and ``decode_steps`` > 1 with overlap are token-identical,
  with the same retirement order.
* **Chaos** — a ``step-hbm-oom`` fault, and a CUDA out-of-memory error at
  the executor boundary, each retire exactly one request FAILED (cause
  ``hbm-oom``); ``drain-sigterm`` lands the ledger row PREEMPTED.
* **Entry point** — ``NEXUS_MODE=serve-engine`` lands COMPLETED with the
  reference's summary keys (in a subprocess with ``jax`` and ``tpu_nexus``
  blocked from import); each knob that is still unported raises at parse
  and names its ROADMAP.md item.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import tpu_nexus.serving as jax_serving
import tpu_nexus_torch.serving as port_serving
import tpu_nexus_torch.serving.engine as port_engine
from tpu_nexus.checkpoint.store import InMemoryCheckpointStore as JaxInMemoryStore
from tpu_nexus.parallel.distributed import ProcessContext as JaxProcessContext
from tpu_nexus.workload.serve import ServeConfig as JaxServeConfig
from tpu_nexus.workload.serve import run_serve_engine as jax_run_serve_engine
from tpu_nexus_torch.checkpoint.models import LifecycleStage
from tpu_nexus_torch.checkpoint.store import InMemoryCheckpointStore, SqliteCheckpointStore
from tpu_nexus_torch.core.signals import LifecycleContext
from tpu_nexus_torch.parallel.distributed import ProcessContext
from tpu_nexus_torch.workload.serve import ServeConfig, run_serve_engine
from test_torch_llama import carried, tiny_configs

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
SMALL = dict(batch_size=2, prompt_len=8, gen_tokens=4, rounds=3, heartbeat_every=1)


class FakeExecutor:
    """Deterministic device stand-in (``tests/test_serving_engine.py``'s):
    first token = last prompt token + 1, every decode step increments;
    ``step_scan`` merges host overrides over the previous carries and
    freezes rows at their budget or the stop token; ``verify`` returns the
    increment of every block column."""

    def __init__(self, num_slots, max_len, decode_steps=1, stop_token=-1):
        self.num_slots = num_slots
        self.max_len = max_len
        self.decode_steps = decode_steps
        self.stop_token = stop_token
        self.temperature = 0.0

    def begin(self, slot, prompt):
        return (int(prompt[-1]) + 1) % 1000

    def step(self, tokens, cursors):
        return np.asarray(tokens) + 1

    def verify(self, tokens, cursors, drafts):
        block = np.concatenate([np.asarray(tokens)[:, None], np.asarray(drafts)], axis=1)
        return (block + 1).astype(np.int32)

    def step_scan(self, prev_tokens, prev_cursors, override, tokens, cursors, limits, *args):
        tok = np.where(override, tokens, prev_tokens).astype(np.int64)
        pos = np.where(override, cursors, prev_cursors).astype(np.int64)
        limits = np.asarray(limits)
        toks = np.zeros((self.num_slots, self.decode_steps), np.int64)
        counts = np.zeros(self.num_slots, np.int64)
        alive = np.ones(self.num_slots, bool)
        for i in range(self.decode_steps):
            active = alive & (counts < limits)
            nxt = tok + 1
            toks[:, i] = np.where(active, nxt, tok)
            tok = np.where(active, nxt, tok)
            if self.stop_token >= 0:
                alive &= ~(active & (nxt == self.stop_token))
            counts += active
            pos += active
        return toks, counts, tok, pos


class FakeClock:
    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now


def _retirements(engine):
    return [
        (r.request_id, r.state, r.cause, [int(t) for t in r.output_tokens]) for r in engine.retired
    ]


def _drive(pkg, seed):
    """One seeded scenario through ``pkg``'s engine: returns (retirements,
    sheds).  Every random draw is made in the same order for both
    packages."""
    rng = np.random.default_rng(seed)
    num_slots = int(rng.integers(1, 5))
    max_len = int(rng.integers(10, 48))
    variant = seed % 5  # 0 sync, 1 multi-step, 2 overlap, 3 spec, 4 overlap + multi-step + stop
    decode_steps = {1: 3, 4: 2}.get(variant, 1)
    stop_token = int(rng.integers(2, 90)) if variant == 4 else -1
    fake = FakeExecutor(num_slots, max_len, decode_steps, stop_token)
    clock = FakeClock()
    sched = pkg.SchedulerConfig(
        prefill_token_budget=int(rng.integers(1, 2 * max_len)),
        evict_after_steps=int(rng.choice([0, 0, 2, 5])),
        max_queue=int(rng.choice([0, 0, 3])),
    )
    spec_k = int(rng.integers(1, 4)) if variant == 3 else 0
    engine = pkg.ServingEngine(
        fake, scheduler=pkg.FifoScheduler(sched), clock=clock,
        spec_k=spec_k, drafter=pkg.NGramDrafter(num_slots) if spec_k else None,
        overlap=variant in (2, 4),
        fault_policy=pkg.StepFaultPolicy(sleep=lambda s: None),
    )
    n_requests = int(rng.integers(1, 20))
    arrivals = sorted(int(a) for a in rng.integers(0, 30, size=n_requests))
    to_cancel = set(int(i) for i in rng.choice(n_requests, size=n_requests // 4, replace=False))
    sheds = []
    step = idx = 0
    while idx < len(arrivals) or engine.has_work:
        while idx < len(arrivals) and arrivals[idx] <= step:
            prompt_len = int(rng.integers(1, max_len - spec_k))
            max_new = int(rng.integers(1, max_len - prompt_len - spec_k + 1))
            deadline = float(rng.integers(3, 40)) if rng.random() < 0.3 else None
            prompt = rng.integers(1, 100, size=prompt_len)
            try:
                req = engine.submit(prompt, max_new, request_id=f"r{idx}", deadline_s=deadline)
                if idx in to_cancel:
                    engine.cancel(req.request_id)
            except pkg.QueueFull:
                sheds.append(idx)
            idx += 1
        if engine.has_work:
            engine.step()
        clock.now += 1.0
        step += 1
        assert step < 5000, f"seed {seed}: engine did not drain"
    return _retirements(engine), sheds


@pytest.mark.parametrize("block", range(5))
def test_engine_fuzz_matches_the_jax_engine(block):
    """50 arrival patterns (10 per case): the two engines retire the same
    requests in the same order with the same tokens, states and causes."""
    for seed in range(block * 10, block * 10 + 10):
        assert _drive(port_serving, seed) == _drive(jax_serving, seed), f"seed {seed}"


def test_accept_tokens_and_ngram_drafter_match():
    rng = np.random.default_rng(11)
    for _ in range(300):
        k = int(rng.integers(1, 6))
        drafts = rng.integers(0, 4, size=k).astype(np.int32)
        greedy = rng.integers(0, 4, size=k + 1).astype(np.int32)
        remaining = int(rng.integers(1, k + 3))
        ours = port_serving.accept_tokens(drafts, greedy, remaining)
        ref = jax_serving.accept_tokens(drafts, greedy, remaining)
        assert [list(map(int, ours[0])), ours[1]] == [list(map(int, ref[0])), ref[1]]
    drafters = port_serving.NGramDrafter(3), jax_serving.NGramDrafter(3)
    tokens = np.zeros(3, np.int32)
    for slot in range(3):
        prompt = rng.integers(0, 5, size=12).astype(np.int32)
        tokens[slot] = prompt[-1]
        for d in drafters:
            d.begin(slot, prompt)
    cursors = np.array([12, 12, 12], np.int32)
    for _ in range(5):
        ours, ref = (d.propose(tokens, cursors, (0, 1, 2), 3) for d in drafters)
        np.testing.assert_array_equal(ours, ref)
        for slot in range(3):
            emitted = [int(t) for t in rng.integers(0, 5, size=2)]
            for d in drafters:
                d.observe(slot, emitted)
            tokens[slot] = emitted[-1]
        cursors = cursors + 2


# -- real tiny executors --------------------------------------------------------


def _prompts(vocab, seed=0):
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, vocab, size=int(n)).astype(np.int32) for n in rng.integers(3, 14, size=6)]
    # repetitive prompts so the ngram drafter's proposals get accepted
    prompts += [np.tile(rng.integers(0, vocab, size=3).astype(np.int32), 4) for _ in range(2)]
    return prompts


def _engine_run(pkg, params, cfg, *, kv_quant="", spec=0, drafter="ngram", steps=1, overlap=False, **extra):
    kw = dict(num_slots=3, max_len=40, kv_quant=kv_quant, decode_steps=steps, **extra)
    if pkg is jax_serving:
        kw["decode_kernel"] = "xla"
    ex = pkg.ModelExecutor(params, cfg, **kw)
    if spec and drafter == "model":
        draft = pkg.ModelDrafter(pkg.ModelExecutor(params, cfg, **dict(kw, kv_quant="", decode_steps=1)))
    else:
        draft = pkg.NGramDrafter(3) if spec else None
    eng = pkg.ServingEngine(ex, spec_k=spec, drafter=draft, overlap=overlap)
    for i, p in enumerate(_prompts(cfg.vocab_size)):
        eng.submit(p, 12, request_id=f"r{i}")
    eng.run_until_drained()
    return _retirements(eng)


@pytest.mark.parametrize(
    "case",
    [dict(), dict(kv_quant="int8"), dict(spec=3), dict(spec=2, drafter="model"), dict(steps=4, overlap=True)],
    ids=["contiguous", "int8kv", "spec-ngram", "spec-model", "multistep-overlap"],
)
def test_real_tiny_engine_is_token_identical_to_the_jax_engine(case):
    jcfg, pcfg = tiny_configs()
    jparams, pparams = carried(jcfg, pcfg)
    ours = _engine_run(port_serving, pparams, pcfg, **case)
    assert ours == _engine_run(jax_serving, jparams, jcfg, **case)
    assert all(state == "Finished" for _, state, _, _ in ours) and len(ours) == 8


# -- chaos ----------------------------------------------------------------------


def _engine_cfg(**kw):
    cfg = ServeConfig.from_env({"NEXUS_MODEL_PRESET": "tiny", "NEXUS_DEVICE": "cpu"})
    return dataclasses.replace(cfg, **dict(SMALL, **kw))


def test_step_hbm_oom_retires_exactly_one_request(monkeypatch):
    monkeypatch.setenv("NEXUS_FAULT_MODE", "step-hbm-oom")
    monkeypatch.setenv("NEXUS_FAULT_STEP", "2")
    store = InMemoryCheckpointStore()
    ctx = ProcessContext(run_id="oom", algorithm="serve", process_id=0, num_processes=1, coordinator=None)
    out = run_serve_engine(_engine_cfg(page_size=4), store=store, ctx=ctx, lifecycle=LifecycleContext())
    assert out["requests"] == 6 and out["finished"] == 5
    assert out["requests_retired"].get("Failed") == 1 and out["retired_causes"] == {"hbm-oom": 1}
    assert store.read_checkpoint("serve", "oom").lifecycle_stage == LifecycleStage.COMPLETED


def test_cuda_oom_at_the_executor_boundary_retires_one_request(monkeypatch):
    """A ``torch.OutOfMemoryError`` from the device work is re-worded into
    the taxonomy's HBM-OOM wording: the fault policy retires exactly the
    youngest request FAILED and the rest finish."""
    real = port_engine.decode_step
    calls = {"n": 0}

    def oom_once(*args, **kwargs):
        calls["n"] += 1
        if calls["n"] == 3:
            raise torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB")
        return real(*args, **kwargs)

    monkeypatch.setattr(port_engine, "decode_step", oom_once)
    jcfg, pcfg = tiny_configs()
    _, pparams = carried(jcfg, pcfg)
    eng = port_serving.ServingEngine(port_serving.ModelExecutor(pparams, pcfg, num_slots=3, max_len=32))
    for i, p in enumerate(_prompts(pcfg.vocab_size)[:3]):
        eng.submit(p, 6, request_id=f"r{i}")
    eng.run_until_drained()
    states = {r.request_id: (r.state, r.cause) for r in eng.retired}
    failed = [rid for rid, (state, _) in states.items() if state == "Failed"]
    assert failed == ["r2"] and states["r2"][1] == "hbm-oom"
    assert sum(state == "Finished" for state, _ in states.values()) == 2


def test_drain_sigterm_lands_preempted(monkeypatch):
    monkeypatch.setenv("NEXUS_FAULT_MODE", "drain-sigterm")
    monkeypatch.setenv("NEXUS_FAULT_STEP", "2")
    store = InMemoryCheckpointStore()
    ctx = ProcessContext(run_id="drain", algorithm="serve", process_id=0, num_processes=1, coordinator=None)
    out = run_serve_engine(_engine_cfg(drain_grace_s=0.0), store=store, ctx=ctx)
    row = store.read_checkpoint("serve", "drain")
    assert out["drained"] and row.lifecycle_stage == LifecycleStage.PREEMPTED
    details = json.loads(row.algorithm_failure_details)
    assert details["retired_causes"] == out["retired_causes"] and "flight_recorder" in details


# -- the entry point --------------------------------------------------------------


def test_run_serve_engine_lands_completed_with_the_reference_summary():
    store = InMemoryCheckpointStore()
    ctx = ProcessContext(run_id="eng", algorithm="serve", process_id=0, num_processes=1, coordinator=None)
    out = run_serve_engine(_engine_cfg(page_size=4, spec_k=2), store=store, ctx=ctx, lifecycle=LifecycleContext())
    row = store.read_checkpoint("serve", "eng")
    assert row.lifecycle_stage == LifecycleStage.COMPLETED
    assert out["requests"] == out["finished"] == 6 and out["device"] == "cpu"
    jcfg = dataclasses.replace(JaxServeConfig.from_env({"NEXUS_MODEL_PRESET": "tiny"}), page_size=4, spec_k=2, **SMALL)
    ref = jax_run_serve_engine(
        jcfg, store=JaxInMemoryStore(), ctx=JaxProcessContext(run_id="eng", algorithm="serve", process_id=0, num_processes=1, coordinator=None),
        lifecycle=__import__("tpu_nexus.core.signals", fromlist=["LifecycleContext"]).LifecycleContext(),
    )
    assert set(ref) <= set(out) and set(out) - set(ref) == {"device"}
    assert out["load_snapshot"].keys() == ref["load_snapshot"].keys()


_BLOCKED_ENTRY = """
import sys
class _Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "tpu_nexus"):
            raise ImportError(f"blocked: {name}")
sys.meta_path.insert(0, _Block())
from tpu_nexus_torch.workload.__main__ import main
sys.exit(main())
"""


def test_entrypoint_serve_engine_lands_completed_with_jax_blocked(tmp_path):
    env = dict(
        os.environ, PYTHONPATH=str(ROOT), NEXUS_MODE="serve-engine", NEXUS_DEVICE="cpu",
        NEXUS_MODEL_PRESET="tiny", NEXUS_BATCH="2", NEXUS_STEPS="2", NEXUS_PROMPT_LEN="8",
        NEXUS_GEN_TOKENS="4", NEXUS_PAGE_SIZE="4", NEXUS_RUN_ID="eng", NEXUS_ALGORITHM="serve",
        NEXUS__CQL_STORE_TYPE="sqlite", NEXUS__SQLITE_STORE_PATH=str(tmp_path / "ledger.db"),
    )
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED_ENTRY], env=env, cwd=tmp_path,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    store = SqliteCheckpointStore(str(tmp_path / "ledger.db"))
    try:
        row = store.read_checkpoint("serve", "eng")
    finally:
        store.close()
    assert row.lifecycle_stage == LifecycleStage.COMPLETED


@pytest.mark.parametrize("key", ["NEXUS_SERVE_MESH"])
def test_unported_engine_knobs_raise_naming_their_roadmap_item(key):
    """No engine knob is left unported: the last one, ``NEXUS_SERVE_MESH``,
    parses, and a mesh that cannot be met — more ranks than devices, the
    rehearsal map not asked for — raises at parse with the reference's
    words."""
    with pytest.raises(ValueError, match="wants 2 devices"):
        ServeConfig.from_env({key: "tp=2", "NEXUS_DEVICE": "cpu"})
    cfg = ServeConfig.from_env({key: "tp=2", "NEXUS_DEVICE": "cpu", "NEXUS_RANK_DEVICE_MAP": "shared"})
    assert (cfg.serve_mesh, cfg.rank_map) == ("tp=2", "shared")


def test_reload_check_knob_parses_with_the_reference_wording():
    """NEXUS_RELOAD_CHECK_S is ported: it parses beside a checkpoint
    directory, and without one both packages refuse it alike."""
    env = {"NEXUS_RELOAD_CHECK_S": "2.5", "NEXUS_CHECKPOINT_DIR": "/ckpt"}
    assert ServeConfig.from_env(env).reload_check_interval_s == JaxServeConfig.from_env(env).reload_check_interval_s
    with pytest.raises(ValueError) as mine:
        ServeConfig.from_env({"NEXUS_RELOAD_CHECK_S": "2.5"})
    with pytest.raises(ValueError) as ref:
        JaxServeConfig.from_env({"NEXUS_RELOAD_CHECK_S": "2.5"})
    assert str(mine.value) == str(ref.value)


@pytest.mark.parametrize(
    "env,match",
    [
        ({"NEXUS_SPEC_K": "2", "NEXUS_OVERLAP": "1"}, "mutually exclusive"),
        ({"NEXUS_SPEC_K": "8"}, "verify width"),
        ({"NEXUS_SPEC_K": "2", "NEXUS_SPEC_DRAFTER": "oracle"}, "unknown spec_drafter"),
        ({"NEXUS_KV_BLOCKS": "8"}, "requires page_size"),
        ({"NEXUS_PAGE_SIZE": "4", "NEXUS_KV_BLOCKS": "1"}, "kv_blocks must be 0"),
        ({"NEXUS_DECODE_STEPS": "0"}, "decode_steps"),
        ({"NEXUS_SLO_TTFT_S": "1", "NEXUS_HEARTBEAT_EVERY": "0"}, "heartbeat cadence"),
    ],
)
def test_engine_knobs_validate_with_the_reference_wording(env, match):
    with pytest.raises(ValueError, match=match):
        ServeConfig.from_env(dict(env, NEXUS_MODEL_PRESET="tiny"))
    with pytest.raises(ValueError, match=match):
        JaxServeConfig.from_env(dict(env, NEXUS_MODEL_PRESET="tiny"))


def test_engine_knobs_parse():
    cfg = ServeConfig.from_env({
        "NEXUS_PAGE_SIZE": "32", "NEXUS_KV_BLOCKS": "64", "NEXUS_SPEC_K": "4", "NEXUS_DEADLINE_S": "2",
        "NEXUS_QUEUE_LIMIT": "5", "NEXUS_SLO_TPOT_S": "0.5", "NEXUS_FAULT_MODE": "step-ici",
    })
    assert (cfg.page_size, cfg.kv_blocks, cfg.spec_k, cfg.deadline_s, cfg.queue_limit) == (32, 64, 4, 2.0, 5)
    assert cfg.slo_targets().tpot_p99_s == 0.5
    cfg = ServeConfig.from_env({"NEXUS_OVERLAP": "1", "NEXUS_DECODE_STEPS": "4", "NEXUS_STOP_TOKEN": "2"})
    assert (cfg.overlap_dispatch, cfg.decode_steps, cfg.stop_token) == (True, 4, 2)
