"""The port's paged serving path against the JAX package's.

* **Allocator and prefix-index fuzz** — the same random admission /
  copy-on-write / register / truncate / extend / release / reset traffic
  through both packages' ``PagedCacheManager`` (the engine's lifecycle
  order, ``tests/test_paged_cache.py``'s fuzz): every plan, copy list,
  truncate and extend result, probe and pool count is identical, and
  ``verify_consistent`` holds after every operation on both.
* **Paged engine fuzz** — both ``ServingEngine``\\ s over the same numpy
  fake paged executor with shared-prefix traffic and an overcommitted pool:
  identical retirements (order, tokens, states, causes), identical
  admission tables, prefix hits and copy-on-write counts.
* **Real tiny paged executors** — port engine over the port's
  ``PagedModelExecutor`` against the JAX engine over the JAX one, greedy
  f32 ``tiny``, pages of 4 (the port's kernel takes any page): plain,
  int8-KV, shared prefixes with COW in an overcommitted pool, speculative
  verify and multi-step decode are token-identical, with equal prefix-hit
  and prefilled-token counts.
"""

import numpy as np
import pytest
import torch

import tpu_nexus.serving as jax_serving
import tpu_nexus_torch.serving as port_serving
from test_torch_llama import carried, tiny_configs

torch.set_num_threads(1)


def _manager_trace(pkg, seed):
    """Random traffic through ``pkg``'s PagedCacheManager; returns the log
    of every observable result."""
    rng = np.random.default_rng(seed)
    page = int(rng.integers(1, 5))
    max_len = page * int(rng.integers(2, 9))
    pool = 1 + int(rng.integers(2, 24))
    pm = pkg.PagedCacheManager(num_blocks=pool, page_size=page, max_len=max_len)
    live, log, counter = {}, [], 0
    for _ in range(120):
        pm.verify_consistent()
        op = int(rng.integers(0, 6))
        if op == 0 and len(live) < 8:
            counter += 1
            rid = f"r{counter}"
            if live and rng.integers(0, 2):
                base = list(live[str(rng.choice(sorted(live)))][0])
                cut = int(rng.integers(1, len(base) + 1))
                prompt = base[:cut] + [int(t) for t in rng.integers(100, 120, 3)]
            else:
                prompt = [int(t) for t in rng.integers(0, 9, rng.integers(1, max_len))]
            prompt = prompt[: max_len - 1]
            total = min(max_len, len(prompt) + int(rng.integers(1, 5)))
            probe = pm.index.lookup(prompt, touch=False)
            log.append(("probe", probe.shared_len, list(probe.full_blocks), probe.partial_block))
            ok = pm.fits(total) and pm.can_admit(prompt, total)
            log.append(("can_admit", ok))
            if not ok:
                continue
            plan = pm.admit(rid, prompt, total)
            log.append(("plan", list(map(int, plan.block_row)), plan.n_blocks, plan.tail_start))
            copies = pm.prepare_write(rid, plan.block_row, range(plan.tail_start // page, plan.n_blocks))
            log.append(("copies", [tuple(map(int, c)) for c in copies]))
            live[rid] = (prompt, plan, total)
        elif op == 1 and live:
            rid = str(rng.choice(sorted(live)))
            prompt, plan, _ = live[rid]
            if not any(b == pkg.SCRATCH_BLOCK for b in plan.block_row[: len(prompt) // page]):
                log.append(("register", pm.register_prompt(rid, prompt, plan.block_row)))
        elif op == 2 and live:
            rid = str(rng.choice(sorted(live)))
            pm.release(rid)
            del live[rid]
        elif op == 3 and live:
            # speculative rollback then regrowth within the request's budget
            rid = str(rng.choice(sorted(live)))
            prompt, plan, total = live[rid]
            keep = int(rng.integers(len(prompt), total + 1))
            log.append(("truncate", list(map(int, pm.truncate(rid, keep)))))
            log.append(("extend", [tuple(map(int, e)) for e in pm.extend(rid, total)]))
        elif op == 4 and rng.integers(0, 8) == 0 and not live:
            pm.reset()
        log.append(("pool", pm.manager.free_count, pm.manager.used_count, pm.used_blocks))
    for rid in sorted(live):
        pm.release(rid)
    pm.verify_consistent()
    log.append(("reclaimable", pm.index.reclaimable(pm.manager)))
    return log


@pytest.mark.parametrize("block", range(4))
def test_paged_manager_fuzz_matches_the_jax_package(block):
    """40 seeds of allocator + prefix-index traffic, 10 per case."""
    for seed in range(block * 10, block * 10 + 10):
        assert _manager_trace(port_serving, seed) == _manager_trace(jax_serving, seed), f"seed {seed}"


class FakePagedExecutor:
    """A numpy stand-in for the paged executor: first token = last prompt
    token + 1, every decode step increments; it exposes the paged contract
    (``page_size``/``num_blocks``, ``begin(..., table_row, tail_start,
    copies)``, ``step(tokens, cursors, tables)``) and records every
    admission's table and tail."""

    def __init__(self, num_slots, max_len, page_size, num_blocks):
        self.num_slots = num_slots
        self.max_len = max_len
        self.page_size = page_size
        self.num_blocks = num_blocks
        self.temperature = 0.0
        self.begins = []

    def begin(self, slot, prompt, *, table_row=None, tail_start=0, copies=()):
        self.begins.append((slot, list(map(int, table_row)), tail_start, [tuple(map(int, c)) for c in copies]))
        return (int(prompt[-1]) + 1) % 1000

    def step(self, tokens, cursors, tables):
        return np.asarray(tokens) + 1

    def verify(self, tokens, cursors, drafts, tables):
        block = np.concatenate([np.asarray(tokens)[:, None], np.asarray(drafts)], axis=1)
        return (block + 1).astype(np.int32)


def _paged_engine_trace(pkg, seed):
    rng = np.random.default_rng(seed)
    num_slots = int(rng.integers(1, 5))
    page = int(rng.integers(1, 6))
    max_len = page * int(rng.integers(3, 10))
    blocks_per_slot = -(-max_len // page)
    # an overcommitted pool half the time: admission waits on blocks
    num_blocks = 1 + (num_slots * blocks_per_slot if rng.integers(0, 2) else max(blocks_per_slot, 2))
    spec_k = int(rng.integers(1, 3)) if seed % 3 == 0 else 0
    fake = FakePagedExecutor(num_slots, max_len, page, num_blocks)
    engine = pkg.ServingEngine(
        fake, spec_k=spec_k, drafter=pkg.NGramDrafter(num_slots) if spec_k else None,
        fault_policy=pkg.StepFaultPolicy(sleep=lambda s: None),
    )
    shared = [int(t) for t in rng.integers(1, 50, size=max_len)]
    n_requests = int(rng.integers(1, 16))
    arrivals = sorted(int(a) for a in rng.integers(0, 20, size=n_requests))
    step = idx = 0
    # a bounded run: a pool too small for a head's blocks plus its COW
    # reservation stalls admission (in both packages alike), so the trace
    # compares the engines' state after at most 400 steps
    while (idx < len(arrivals) or engine.has_work) and step < 400:
        while idx < len(arrivals) and arrivals[idx] <= step:
            prompt_len = int(rng.integers(1, max_len - spec_k))
            cut = int(rng.integers(0, prompt_len + 1))
            prompt = np.asarray(shared[:cut] + [int(t) for t in rng.integers(50, 99, size=prompt_len - cut)])
            max_new = int(rng.integers(1, max_len - prompt_len - spec_k + 1))
            engine.submit(prompt, max_new, request_id=f"r{idx}")
            idx += 1
        if engine.has_work:
            engine.step()
        engine.paged.verify_consistent()
        step += 1
    retired = [(r.request_id, r.state, r.cause, [int(t) for t in r.output_tokens]) for r in engine.retired]
    live = sorted((rid, r.state, len(r.output_tokens)) for rid, r in engine.requests.items())
    return retired, live, fake.begins, engine.metrics.prefix_hits, engine.metrics.blocks_cow_total


@pytest.mark.parametrize("block", range(3))
def test_paged_engine_fuzz_matches_the_jax_engine(block):
    """30 seeds of shared-prefix traffic (every third speculative) over a
    fake paged executor, 10 per case."""
    for seed in range(block * 10, block * 10 + 10):
        assert _paged_engine_trace(port_serving, seed) == _paged_engine_trace(jax_serving, seed), f"seed {seed}"


def _prompts(vocab, seed=0):
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, vocab, size=10).astype(np.int32)
    prompts = [rng.integers(0, vocab, size=int(n)).astype(np.int32) for n in rng.integers(3, 14, size=4)]
    # shared-prefix traffic: full shared blocks, a mid-page divergence (COW)
    prompts += [np.concatenate([shared, rng.integers(0, vocab, size=k).astype(np.int32)]) for k in (2, 3, 9)]
    prompts += [np.concatenate([shared[:6], rng.integers(0, vocab, size=4).astype(np.int32)])]
    return prompts


def _paged_run(pkg, params, cfg, *, kv_quant="", spec=0, steps=1, num_blocks=0):
    kw = dict(num_slots=3, max_len=40, page_size=4, num_blocks=num_blocks, kv_quant=kv_quant, decode_steps=steps)
    if pkg is jax_serving:
        kw["decode_kernel"] = "xla"
    ex = pkg.PagedModelExecutor(params, cfg, **kw)
    eng = pkg.ServingEngine(ex, spec_k=spec, drafter=pkg.NGramDrafter(3) if spec else None)
    for i, p in enumerate(_prompts(cfg.vocab_size)):
        eng.submit(p, 12, request_id=f"r{i}")
    eng.run_until_drained()
    retired = [(r.request_id, r.state, [int(t) for t in r.output_tokens]) for r in eng.retired]
    return retired, eng.metrics.prefix_hits, eng.metrics.blocks_cow_total, ex.prefilled_tokens


@pytest.mark.parametrize(
    "case",
    [dict(), dict(kv_quant="int8"), dict(num_blocks=20), dict(spec=3), dict(steps=3)],
    ids=["paged", "int8kv", "overcommitted", "spec", "multistep"],
)
def test_real_tiny_paged_engine_is_token_identical_to_the_jax_engine(case):
    jcfg, pcfg = tiny_configs()
    jparams, pparams = carried(jcfg, pcfg)
    ours = _paged_run(port_serving, pparams, pcfg, **case)
    assert ours == _paged_run(jax_serving, jparams, jcfg, **case)
    retired, prefix_hits, _, prefilled = ours
    assert len(retired) == 8 and all(state == "Finished" for _, state, _ in retired)
    assert prefix_hits > 0 and prefilled < sum(len(p) for p in _prompts(pcfg.vocab_size))


def test_paged_executor_handoff_seam_names_its_roadmap_item():
    """The handoff seam works (the JAX package's ``kv_leaf_specs``, a
    gather of whole blocks in table order, an install into other ids); a
    sharded cache takes only a KV cache sharding, and holds the rank's
    heads."""
    jcfg, pcfg = tiny_configs()
    jparams, pparams = carried(jcfg, pcfg)
    ex = port_serving.PagedModelExecutor(pparams, pcfg, num_slots=2, max_len=16, page_size=4)
    jex = jax_serving.PagedModelExecutor(jparams, jcfg, num_slots=2, max_len=16, page_size=4, decode_kernel="xla")
    assert ex.cache["k"].shape == (pcfg.n_layers, 1 + 2 * 4, 4, pcfg.n_kv_heads, pcfg.head_dim)
    specs = ex.kv_leaf_specs()
    assert {k: (s, str(d).removeprefix("torch.")) for k, (s, d) in specs.items()} == {
        k: (s, str(d)) for k, (s, d) in jex.kv_leaf_specs().items()}
    gen = torch.Generator().manual_seed(0)
    for arr in ex.cache.values():
        arr.copy_(torch.randn(arr.shape, generator=gen))
    blocks = ex.extract_blocks([2, 1])
    for name, arr in ex.cache.items():
        assert torch.equal(blocks[name], arr[:, [2, 1]])
    payload = port_serving.KVHandoffPayload(
        request_id="r", prompt=tuple(range(8)), first_token=1, page_size=4, n_blocks=2, blocks=blocks).seal()
    ex.install_blocks(payload, [5, 6])
    for name, arr in ex.cache.items():
        assert torch.equal(arr[:, [5, 6]], arr[:, [2, 1]])
    with pytest.raises(TypeError, match="KV cache sharding"):
        port_serving.init_paged_cache(pcfg, 4, 4, shardings=object(), device="cpu")
    from tpu_nexus_torch.serving.sharded import build_serve_mesh, kv_cache_sharding

    sharding = kv_cache_sharding(build_serve_mesh({"tp": 2}, ranks=range(2)))
    local = port_serving.init_paged_cache(pcfg, 4, 4, shardings=sharding, device="cpu")
    assert local["k"].shape == (pcfg.n_layers, 4, 4, pcfg.n_kv_heads // 2, pcfg.head_dim)
