"""Disaggregated prefill/decode serving and the KV handoff of the port, on
the CPU (tiny model in f32, carried across with ``models/convert.py``).

Against the JAX package:

* the same prompts through a JAX disaggregated fleet (two prefill and two
  decode replicas, ``tests/test_disagg_serving.py::_disagg_fleet``'s
  topology, its XLA kernel path) and the port's give identical greedy
  tokens, both equal to the port's ``generate``, with and without an int8
  KV cache;
* both packages' ``prefill_remote`` on the same prompt give equal
  ``first_token`` and ``n_blocks`` and blocks within 1e-5 (f32), and a
  leaf of the same bf16 values has the same CRC in both packages (the CRC
  covers the raw 2-byte patterns).

The port alone (the cases of ``tests/test_disagg_serving.py``): payload
validation, the transfer retry policy, the fault wrapper's step counter on
the handoff dispatches, role plumbing, the three handoff fault modes, the
multi-seed fuzz with zero silent drops, and the fleet supervisor's roles
(adoption reads them from the pod env, a crash-looping prefill pod comes
back as prefill, scale-down never drains a role's last replica); the
executor's seam itself: extract is a copy (the pool survives it), install
round-trips the bytes, a corrupt payload writes nothing to the receiver's
pool, and a bf16 payload's CRC catches a one-byte flip.

Tolerances: tokens, states, causes and bytes exactly; the JAX-vs-port
prefill blocks 1e-5 max-abs in f32.
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_nexus.serving as jax_serving
from tpu_nexus.serving.handoff import leaf_checksum as jax_leaf_checksum
from tpu_nexus_torch.core.telemetry import RecordingMetrics
from tpu_nexus_torch.models.generate import generate
from tpu_nexus_torch.serving import (
    HANDOFF_FAULT_CAUSES,
    ROLE_DECODE,
    ROLE_FUSED,
    ROLE_PREFILL,
    DisaggConfig,
    HandoffAction,
    HandoffPolicy,
    KVHandoffPayload,
    PagedModelExecutor,
    PayloadCorrupt,
    PeerLost,
    RequestState,
    ServingEngine,
    ServingFleet,
    TransferDropped,
    validate_payload,
)
from tpu_nexus_torch.serving.fleet import REPLICA_DOWN, FleetError
from tpu_nexus_torch.serving.handoff import (
    CAUSE_HANDOFF_CORRUPT,
    CAUSE_HANDOFF_EXHAUSTED,
    CAUSE_HANDOFF_PEER_LOST,
    leaf_bytes,
    leaf_checksum,
)
from tpu_nexus_torch.serving.tracing import EV_DISAGG_FALLBACK, EV_HANDOFF_HOP
from tpu_nexus_torch.supervisor.taxonomy import DecisionAction
from tpu_nexus_torch.workload.faults import HANDOFF_FAULT_MODES, FaultPlan, FaultyExecutor, wrap_executor
from test_torch_llama import carried, tiny_configs

torch.set_num_threads(1)

JCFG, PCFG = tiny_configs()
JPARAMS, PARAMS = carried(JCFG, PCFG)
S, T = 12, 5


def _engine(slots=2, kv_quant="", wrap=None, params=PARAMS, cfg=PCFG, dtype=None):
    if dtype is not None:
        import dataclasses

        cfg = dataclasses.replace(cfg, dtype=dtype)
    executor = PagedModelExecutor(params, cfg, num_slots=slots, max_len=S + T, page_size=4, kv_quant=kv_quant)
    if wrap is not None:
        executor = wrap(executor)
    return ServingEngine(executor)


def _prompts(seed=7, lens=(5, 8, 3, 11, 6)):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, PCFG.vocab_size, size=n).astype(np.int32) for n in lens]


def _disagg_fleet(n_prefill=2, n_decode=2, decode_slots=3, wrap=None, wrap_name=None, kv_quant="", **kw):
    """2x2 role-typed fleet; ``wrap`` wraps the named replica's executor
    (the chaos drills' injection seam)."""
    fleet = ServingFleet(disagg=DisaggConfig(**kw), handoff_sleep=lambda s: None)
    for i in range(n_prefill):
        name = f"pf-{i}"
        fleet.add_replica(name, _engine(2, kv_quant, wrap if name == wrap_name else None), step=1,
                          role=ROLE_PREFILL)
    for i in range(n_decode):
        name = f"dc-{i}"
        fleet.add_replica(name, _engine(decode_slots, kv_quant, wrap if name == wrap_name else None), step=1,
                          role=ROLE_DECODE)
    return fleet


def _drain_verifying(fleet, max_steps=3000):
    """Drain with ``verify_consistent`` after EVERY tick."""
    steps = 0
    while fleet.has_work:
        assert steps < max_steps, "fleet failed to drain"
        fleet.tick()
        steps += 1
        for rep in fleet.replicas.values():
            if rep.state != REPLICA_DOWN:
                rep.engine.paged.verify_consistent()


def _fused_expect(prompts, kv_quant=""):
    eng = _engine(slots=4, kv_quant=kv_quant)
    reqs = [eng.submit(p, T) for p in prompts]
    eng.run_until_drained(max_steps=3000)
    return [list(r.output_tokens) for r in reqs]


# -- against the JAX package ----------------------------------------------------


def _jax_disagg_tokens(prompts, kv_quant):
    fleet = jax_serving.ServingFleet(disagg=jax_serving.DisaggConfig(), handoff_sleep=lambda s: None)
    for i in range(2):
        fleet.add_replica(
            f"pf-{i}",
            jax_serving.ServingEngine(jax_serving.PagedModelExecutor(
                JPARAMS, JCFG, num_slots=2, max_len=S + T, page_size=4, kv_quant=kv_quant, decode_kernel="xla")),
            step=1, role=jax_serving.ROLE_PREFILL,
        )
        fleet.add_replica(
            f"dc-{i}",
            jax_serving.ServingEngine(jax_serving.PagedModelExecutor(
                JPARAMS, JCFG, num_slots=3, max_len=S + T, page_size=4, kv_quant=kv_quant, decode_kernel="xla")),
            step=1, role=jax_serving.ROLE_DECODE,
        )
    reqs = [fleet.submit(p, T) for p in prompts]
    fleet.run_until_drained(max_steps=3000)
    assert fleet.handoffs_completed == len(prompts) and fleet.disagg_fallbacks == 0
    return [[int(t) for t in r.output_tokens] for r in reqs]


@pytest.mark.parametrize("kv_quant", ["", "int8"])
def test_disagg_fleet_is_token_identical_to_the_jax_fleet_and_generate(kv_quant):
    prompts = _prompts()
    fleet = _disagg_fleet(decode_slots=3, kv_quant=kv_quant)
    reqs = [fleet.submit(p, T) for p in prompts]
    _drain_verifying(fleet)
    assert fleet.handoffs_completed == len(prompts) and fleet.disagg_fallbacks == 0
    ours = [[int(t) for t in r.output_tokens] for r in reqs]
    assert all(r.state == RequestState.FINISHED for r in reqs)
    assert ours == _jax_disagg_tokens(prompts, kv_quant)
    for p, got in zip(prompts, ours):
        solo = generate(PARAMS, torch.from_numpy(p)[None], PCFG, max_new_tokens=T, max_len=S + T, kv_quant=kv_quant)
        assert got == solo[0].tolist()
    for name, rep in fleet.replicas.items():
        if rep.role == ROLE_PREFILL:
            assert not rep.engine.retired, f"{name} decoded"


def test_prefill_remote_payload_matches_the_jax_package():
    prompt = _prompts(lens=(11,))[0]
    ours = _engine(slots=2).prefill_remote(prompt, "r0", source_replica="pf-0")
    ref = jax_serving.ServingEngine(jax_serving.PagedModelExecutor(
        JPARAMS, JCFG, num_slots=2, max_len=S + T, page_size=4, decode_kernel="xla",
    )).prefill_remote(prompt, "r0", source_replica="pf-0")
    assert (ours.first_token, ours.n_blocks, ours.page_size, ours.prompt) == (
        ref.first_token, ref.n_blocks, ref.page_size, ref.prompt)
    assert sorted(ours.blocks) == sorted(ref.blocks) == ["k", "v"]
    for name in ours.blocks:
        assert isinstance(ours.blocks[name], torch.Tensor) and ours.blocks[name].device.type == "cpu"
        assert tuple(ours.blocks[name].shape) == ref.blocks[name].shape
        np.testing.assert_allclose(ours.blocks[name].numpy(), np.asarray(ref.blocks[name]), rtol=0, atol=1e-5)
        assert ours.checksums[name] == leaf_checksum(ours.blocks[name])


def test_bf16_leaf_crc_equals_the_jax_package():
    """The host form keeps bf16's raw 2-byte patterns: a leaf of the same
    bf16 values has the same CRC in both packages."""
    values = np.random.default_rng(0).standard_normal((2, 3, 4, 2, 8)).astype(np.float32)
    ours = torch.from_numpy(values).to(torch.bfloat16)
    ref = jnp.asarray(values, dtype=jnp.bfloat16)
    assert leaf_bytes(ours).nbytes == values.size * 2
    assert leaf_checksum(ours) == jax_leaf_checksum(ref)


# -- payload validation ---------------------------------------------------------


def _payload(prompt_len=6, page_size=4, leaves=("k", "v"), dtype=torch.float32):
    n_blocks = -(-prompt_len // page_size)
    blocks = {
        name: torch.arange(2 * n_blocks * page_size * 3).reshape(2, n_blocks, page_size, 3).to(dtype)
        for name in leaves
    }
    return KVHandoffPayload(
        request_id="r1",
        prompt=tuple(range(1, prompt_len + 1)),
        first_token=7,
        page_size=page_size,
        n_blocks=n_blocks,
        blocks=blocks,
    ).seal()


def _specs(page_size=4, leaves=("k", "v"), dtype=torch.float32):
    return {name: ((2, page_size, 3), dtype) for name in leaves}


class TestValidatePayload:
    def test_sealed_payload_validates(self):
        validate_payload(_payload(), page_size=4, leaf_specs=_specs())

    @pytest.mark.parametrize(
        "mutate, field",
        [
            (lambda p: setattr(p, "page_size", 8), "page_size"),
            (lambda p: setattr(p, "n_blocks", 3), "block count"),
            (lambda p: p.blocks.pop("v"), "leaf set"),
            (lambda p: setattr(p, "checksums", {}), "unsealed"),
        ],
    )
    def test_field_mismatches_reject_with_the_field_named(self, mutate, field):
        payload = _payload()
        mutate(payload)
        with pytest.raises(PayloadCorrupt, match=field):
            validate_payload(payload, page_size=4, leaf_specs=_specs())

    def test_shape_and_dtype_checked_per_leaf(self):
        payload = _payload()
        payload.blocks["k"] = payload.blocks["k"][:, :, :2]
        with pytest.raises(PayloadCorrupt, match="leaf 'k' shape"):
            validate_payload(payload, page_size=4, leaf_specs=_specs())
        payload = _payload()
        with pytest.raises(PayloadCorrupt, match="leaf 'k' dtype float32 != expected int8"):
            validate_payload(payload, page_size=4, leaf_specs=_specs(dtype=torch.int8))
        payload = _payload(dtype=torch.bfloat16)
        with pytest.raises(PayloadCorrupt, match="leaf 'k' dtype bfloat16 != expected float32"):
            validate_payload(payload, page_size=4, leaf_specs=_specs())

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
    def test_single_byte_corruption_is_caught(self, dtype):
        payload = _payload(dtype=dtype)
        flat = leaf_bytes(payload.blocks["v"])
        flat[len(flat) // 2] ^= 0xFF
        with pytest.raises(PayloadCorrupt, match="leaf 'v' crc32"):
            validate_payload(payload, page_size=4, leaf_specs=_specs(dtype=dtype))

    def test_corrupt_cause_token_rides_the_error(self):
        payload = _payload()
        payload.checksums["k"] = 0
        with pytest.raises(PayloadCorrupt) as err:
            validate_payload(payload, page_size=4, leaf_specs=_specs())
        assert err.value.cause == CAUSE_HANDOFF_CORRUPT


# -- bounded transient retry -----------------------------------------------------


class TestHandoffPolicy:
    def test_drop_retries_then_reraises(self):
        naps = []
        policy = HandoffPolicy(max_retries=2, sleep=naps.append)
        calls = {"n": 0}

        def flaky():
            calls["n"] += 1
            raise TransferDropped("kv handoff transfer dropped in transit")

        with pytest.raises(TransferDropped):
            policy.run(flaky)
        assert calls["n"] == 3
        assert policy.retries_used == 2 and policy.faults_seen == 3
        assert len(naps) == 2 and all(s >= 0 for s in naps)

    def test_drop_heals_within_budget(self):
        policy = HandoffPolicy(max_retries=2, sleep=lambda s: None)
        calls = {"n": 0}

        def heals():
            calls["n"] += 1
            if calls["n"] < 2:
                raise TransferDropped("dropped")
            return "payload"

        assert policy.run(heals) == "payload"
        assert policy.retries_used == 1

    def test_corrupt_and_peer_lost_never_retry_in_place(self):
        for exc in (PayloadCorrupt("bad"), PeerLost("gone")):
            policy = HandoffPolicy(max_retries=5, sleep=lambda s: None)
            with pytest.raises(type(exc)):
                policy.run(lambda exc=exc: (_ for _ in ()).throw(exc))
            assert policy.retries_used == 0

    def test_disagg_config_env_and_validation(self):
        cfg = DisaggConfig.from_env({
            "NEXUS_DISAGG_TRANSFER_RETRIES": "5",
            "NEXUS_DISAGG_MAX_HOPS": "1",
            "NEXUS_DISAGG_BACKOFF_BASE_S": "0.001",
            "NEXUS_DISAGG_BACKOFF_MAX_S": "0.002",
        })
        assert cfg.transfer_retries == 5 and cfg.max_hops == 1
        assert cfg.policy(sleep=lambda s: None).max_retries == 5
        with pytest.raises(ValueError, match="transfer_retries"):
            DisaggConfig(transfer_retries=-1)
        with pytest.raises(ValueError, match="max_hops"):
            DisaggConfig(max_hops=-1)
        with pytest.raises(ValueError, match="backoff"):
            DisaggConfig(backoff_base_s=0.5, backoff_max_s=0.1)


# -- the fault wrapper on the handoff dispatches ----------------------------------


class _DispatchRecorder:
    """Inner-executor stand-in recording dispatch order."""

    num_slots = 2
    max_len = 16

    def __init__(self):
        self.dispatches = []

    def begin(self, slot, prompt, **kwargs):
        self.dispatches.append("begin")
        return 1

    def step(self, tokens, cursors, *args):
        self.dispatches.append("step")
        return tokens

    def extract_blocks(self, block_ids):
        self.dispatches.append("extract")
        return {}

    def install_blocks(self, payload, block_ids):
        self.dispatches.append("install")
        return 0


class TestFaultStepParity:
    def test_handoff_dispatches_share_the_step_counter(self):
        wrapped = FaultyExecutor(_DispatchRecorder(), "handoff-drop", at_step=2, times=1)
        wrapped.extract_blocks([1])
        wrapped.step([1], [1])
        with pytest.raises(TransferDropped):
            wrapped.extract_blocks([1])
        assert wrapped.step_calls == 3 and wrapped.injected == 1

    def test_install_counts_and_kill_fires_there(self):
        wrapped = FaultyExecutor(_DispatchRecorder(), "kill-mid-handoff", at_step=1, times=1)
        wrapped.step([1], [1])
        with pytest.raises(PeerLost, match="mid kv-handoff at install"):
            wrapped.install_blocks(_payload(), [1])
        assert wrapped.install_blocks(_payload(), [1]) == 0
        assert wrapped.inner.dispatches == ["step", "install"]

    def test_executor_modes_fire_on_handoff_dispatches_too(self):
        wrapped = FaultyExecutor(_DispatchRecorder(), "step-hbm-oom", at_step=0, times=1)
        with pytest.raises(RuntimeError, match="RESOURCE_EXHAUSTED"):
            wrapped.extract_blocks([1])

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_corrupt_mutates_a_copy_of_the_leaf_and_proceeds(self, dtype):
        wrapped = FaultyExecutor(_DispatchRecorder(), "handoff-corrupt", at_step=0, times=1)
        payload = _payload(dtype=dtype)
        sent = payload.blocks["k"]
        before = sent.clone()
        assert wrapped.install_blocks(payload, [1]) == 0
        assert wrapped.injected == 1
        assert torch.equal(sent, before)  # the sender's leaf is intact
        with pytest.raises(PayloadCorrupt, match="crc32"):
            validate_payload(payload, page_size=4, leaf_specs=_specs(dtype=dtype))

    def test_corrupt_at_extract_is_a_vacuous_drill(self):
        wrapped = FaultyExecutor(_DispatchRecorder(), "handoff-corrupt", at_step=0, times=1)
        with pytest.raises(ValueError, match="install seam"):
            wrapped.extract_blocks([1])

    def test_wrap_executor_routes_handoff_modes(self):
        plan = FaultPlan.from_env({"NEXUS_FAULT_MODE": "handoff-drop", "NEXUS_FAULT_STEP": "3"})
        wrapped = wrap_executor(plan, _DispatchRecorder())
        assert isinstance(wrapped, FaultyExecutor)
        assert wrapped.mode in HANDOFF_FAULT_MODES and wrapped.at_step == 3


# -- the executor's seam ------------------------------------------------------------


def _prefilled(kv_quant="", dtype=None):
    """A prefill engine's payload of one 11-token prompt and a receiver."""
    sender = _engine(slots=2, kv_quant=kv_quant, dtype=dtype)
    payload = sender.prefill_remote(_prompts(lens=(11,))[0], "r0")
    return sender, payload, _engine(slots=2, kv_quant=kv_quant, dtype=dtype)


@pytest.mark.parametrize("kv_quant,dtype", [("", None), ("", torch.bfloat16), ("int8", None)])
def test_install_round_trips_the_extracted_bytes(kv_quant, dtype):
    sender, payload, receiver = _prefilled(kv_quant, dtype)
    leaves = {"k", "v"} | ({"k_s", "v_s"} if kv_quant else set())
    assert set(payload.blocks) == leaves
    for name, arr in payload.blocks.items():
        assert arr.dtype == sender.executor.cache[name].dtype and arr.is_contiguous()
    ids = [3, 1, 5]
    receiver.executor.install_blocks(payload, ids)
    again = receiver.executor.extract_blocks(ids)
    for name in leaves:
        assert bytes(leaf_bytes(again[name])) == bytes(leaf_bytes(payload.blocks[name]))


def test_extract_is_a_copy_and_the_pool_survives_it():
    sender, payload, _ = _prefilled()
    pool = {k: v.clone() for k, v in sender.executor.cache.items()}
    payload.blocks["k"].zero_()  # writing the payload touches no pool byte
    for name, arr in sender.executor.cache.items():
        assert torch.equal(arr, pool[name])
    # the prefix index kept the prompt's blocks: a re-extract (the retry
    # after a dropped transfer) reads the same bytes again
    ids = sender.paged.index.lookup(np.asarray(payload.prompt)).full_blocks
    assert len(ids) > 0


class _FaultingLeaf:
    """A cache leaf whose every index raises ``message`` (a device fault
    at the seam's gather or scatter)."""

    def __init__(self, like, message):
        self.shape, self.dtype, self.message = like.shape, like.dtype, message

    def __getitem__(self, key):
        raise RuntimeError(self.message)

    def __setitem__(self, key, value):
        raise RuntimeError(self.message)


@pytest.mark.parametrize("seam", ["extract", "install"])
def test_seam_faults_go_through_the_executors_guard(seam):
    """A sticky CUDA error at the seam reinitializes the pool and raises
    ``DeviceStateLost``; any other device error is re-raised as is."""
    from tpu_nexus_torch.serving import DeviceStateLost

    _, payload, receiver = _prefilled()
    ex = receiver.executor

    def call():
        if seam == "extract":
            return ex.extract_blocks([1, 2, 3])
        return ex.install_blocks(payload, [1, 2, 3])

    ex.cache["k"] = _FaultingLeaf(ex.cache["k"], "CUDA error: an illegal memory access was encountered")
    with pytest.raises(DeviceStateLost):
        call()
    assert isinstance(ex.cache["k"], torch.Tensor) and not ex.cache["k"].any()  # a fresh pool
    ex.cache["k"] = _FaultingLeaf(ex.cache["k"], "CUDA error: out of resources")
    with pytest.raises(RuntimeError, match="out of resources"):
        call()


@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
def test_corrupt_payload_leaves_the_receivers_pool_as_it_was(dtype):
    _, payload, receiver = _prefilled(dtype=dtype)
    pool = {k: bytes(leaf_bytes(v)) for k, v in receiver.executor.cache.items()}
    bad = copy.deepcopy(payload)
    flat = leaf_bytes(bad.blocks["v"])
    flat[flat.shape[0] // 2] ^= 0xFF
    with pytest.raises(PayloadCorrupt, match="leaf 'v' crc32"):
        receiver.admit_prefilled(bad, T)
    for name, arr in receiver.executor.cache.items():
        assert bytes(leaf_bytes(arr)) == pool[name], name
    receiver.paged.verify_consistent()
    assert not receiver.requests and receiver.slots.used_count == 0
    # the intact payload still installs and decodes
    req = receiver.admit_prefilled(payload, T)
    receiver.run_until_drained(max_steps=100)
    assert req.state == RequestState.FINISHED


# -- role plumbing ---------------------------------------------------------------


class TestRolePlumbing:
    def test_unknown_role_rejected(self):
        fleet = ServingFleet()
        with pytest.raises(FleetError, match="role"):
            fleet.add_replica("r", _engine(), step=1, role="gpu")

    def test_fused_replicas_bypass_the_handoff_path(self):
        fleet = ServingFleet(disagg=DisaggConfig())
        fleet.add_replica("f-0", _engine(slots=4), step=1, role=ROLE_FUSED)
        reqs = [fleet.submit(p, T) for p in _prompts(lens=(5, 8))]
        fleet.run_until_drained(max_steps=3000)
        assert all(r.state == RequestState.FINISHED for r in reqs)
        assert fleet.handoffs_completed == 0 and fleet.disagg_fallbacks == 0

    def test_pool_down_degrades_to_fused_with_cause(self):
        prompts = _prompts(lens=(5, 8))
        expect = _fused_expect(prompts)
        fleet = _disagg_fleet(n_prefill=1, n_decode=1)
        fleet.kill_replica("pf-0", "replica-lost:test")
        reqs = [fleet.submit(p, T) for p in prompts]
        fleet.run_until_drained(max_steps=3000)
        assert fleet.disagg_fallbacks == len(prompts)
        assert [e["cause"] for e in fleet.handoff_log] == ["prefill-pool-down"] * len(prompts)
        for i, req in enumerate(reqs):
            assert req.state == RequestState.FINISHED
            assert list(req.output_tokens) == expect[i]
            assert any(ev[1] == EV_DISAGG_FALLBACK for ev in req.trace.events)

    def test_summary_reports_roles_and_handoffs(self):
        fleet = _disagg_fleet(n_prefill=1, n_decode=1)
        fleet.submit(_prompts(lens=(5,))[0], T)
        fleet.run_until_drained(max_steps=3000)
        summary = fleet.summary()
        roles = {n: r["role"] for n, r in summary["replicas"].items()}
        assert roles == {"pf-0": ROLE_PREFILL, "dc-0": ROLE_DECODE}
        assert summary["handoffs_completed"] == 1
        assert summary["disagg_fallbacks"] == 0


# -- chaos: the three handoff fault modes ----------------------------------------


class TestHandoffChaos:
    def _drill(self, mode, faulty, prompts, at_step=0, times=1, **kw):
        metrics = RecordingMetrics()
        fleet = _disagg_fleet(
            wrap=lambda ex: FaultyExecutor(ex, mode, at_step=at_step, times=times), wrap_name=faulty, **kw,
        )
        fleet._metrics = metrics
        reqs = [fleet.submit(p, T) for p in prompts]
        _drain_verifying(fleet)
        return fleet, reqs, metrics

    def test_transient_drop_heals_in_place(self):
        prompts = _prompts(seed=9, lens=(5, 8, 6))
        expect = _fused_expect(prompts)
        fleet, reqs, metrics = self._drill("handoff-drop", "pf-0", prompts)
        for i, req in enumerate(reqs):
            assert req.state == RequestState.FINISHED
            assert list(req.output_tokens) == expect[i]
        assert fleet.handoffs_completed == len(prompts)
        assert fleet.disagg_fallbacks == 0 and not fleet.handoff_log
        assert metrics.counters.get("serving.handoff_retry", 0) >= 1

    def test_decode_death_mid_handoff_hops_to_next_decode(self):
        prompts = _prompts(seed=9, lens=(5, 8, 6))
        expect = _fused_expect(prompts)
        fleet, reqs, _ = self._drill("kill-mid-handoff", "dc-0", prompts)
        assert fleet.replicas["dc-0"].state == REPLICA_DOWN
        assert fleet.replicas["dc-0"].down_cause == f"replica-lost:{DecisionAction.TO_FAIL_KV_HANDOFF_REPLICA_LOST}"
        hop = fleet.handoff_log[0]
        assert hop["stage"] == "decode" and hop["replica"] == "dc-0"
        assert hop["cause"] == CAUSE_HANDOFF_PEER_LOST
        assert hop["decision"] == HandoffAction.NEXT_DECODE
        assert fleet.handoffs_completed == len(prompts)
        for i, req in enumerate(reqs):
            assert req.state == RequestState.FINISHED
            assert list(req.output_tokens) == expect[i]
        landed = next(r for r in reqs if any(ev[1] == EV_HANDOFF_HOP for ev in r.trace.events))
        ev = next(e for e in landed.trace.events if e[1] == EV_HANDOFF_HOP)
        assert ev[2]["cause"] == CAUSE_HANDOFF_PEER_LOST

    def test_prefill_death_mid_handoff_reprefills_elsewhere(self):
        prompts = _prompts(seed=9, lens=(5, 8, 6))
        expect = _fused_expect(prompts)
        fleet, reqs, _ = self._drill("kill-mid-handoff", "pf-0", prompts)
        assert fleet.replicas["pf-0"].state == REPLICA_DOWN
        hop = fleet.handoff_log[0]
        assert hop["stage"] == "prefill"
        assert hop["cause"] == CAUSE_HANDOFF_PEER_LOST
        assert hop["decision"] == HandoffAction.RE_PREFILL
        for i, req in enumerate(reqs):
            assert req.state == RequestState.FINISHED
            assert list(req.output_tokens) == expect[i]

    def test_corruption_exhausts_hops_then_degrades_to_fused(self):
        prompts = _prompts(seed=9, lens=(5,))
        expect = _fused_expect(prompts)
        fleet, reqs, metrics = self._drill("handoff-corrupt", "dc-0", prompts, max_hops=1)
        assert fleet.disagg_fallbacks == 1
        causes = [e["cause"] for e in fleet.handoff_log]
        assert CAUSE_HANDOFF_CORRUPT in causes
        assert fleet.handoff_log[-1]["stage"] == "fallback"
        assert fleet.handoff_log[-1]["cause"] == CAUSE_HANDOFF_EXHAUSTED
        assert metrics.counters.get("serving.disagg_fallback", 0) == 1
        req = reqs[0]
        assert req.state == RequestState.FINISHED
        assert list(req.output_tokens) == expect[0]
        fallback_ev = next(e for e in req.trace.events if e[1] == EV_DISAGG_FALLBACK)
        assert fallback_ev[2]["cause"] == CAUSE_HANDOFF_EXHAUSTED
        assert fallback_ev[2]["hops"]


# -- multi-seed fuzz -------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_fuzz_kills_mid_handoff_zero_silent_drops(seed):
    rng = np.random.default_rng(seed)
    mode = str(rng.choice(sorted(HANDOFF_FAULT_MODES)))
    faulty = str(rng.choice(["pf-0", "pf-1", "dc-0", "dc-1"]))
    if mode == "handoff-corrupt" and faulty.startswith("pf"):
        faulty = "dc-0"  # corrupt is an install-seam drill by contract
    at_step = int(rng.integers(0, 3))
    lens = [int(n) for n in rng.integers(3, S, size=4)]
    prompts = [rng.integers(1, PCFG.vocab_size, size=n).astype(np.int32) for n in lens]
    expect = _fused_expect(prompts)
    fleet = _disagg_fleet(
        wrap=lambda ex: FaultyExecutor(ex, mode, at_step=at_step, times=1), wrap_name=faulty,
    )
    reqs = [fleet.submit(p, T) for p in prompts]
    _drain_verifying(fleet)
    assert fleet.handoffs_completed + fleet.disagg_fallbacks == len(prompts)
    retired_ids = {r.request_id for r in fleet.all_retired()}
    for i, req in enumerate(reqs):
        assert req.state in (RequestState.FINISHED, RequestState.FAILED), (mode, faulty, at_step, i, req.state)
        assert req.request_id in retired_ids
        if req.state == RequestState.FAILED:
            assert req.cause.startswith("replica-lost:"), (req.cause, mode)
        else:
            assert list(req.output_tokens) == expect[i], (mode, faulty, at_step, i)
    for entry in fleet.handoff_log:
        assert entry["cause"] in HANDOFF_FAULT_CAUSES or entry["cause"].endswith(("-pool-down", "-pool-full"))


# -- the fleet supervisor's roles ------------------------------------------------


async def _role_fixture():
    from datetime import timedelta

    from test_torch_fleet import ALGO, FLEET_JS, NS, _Fixture, _role_jobset
    from tpu_nexus_torch.checkpoint.store import InMemoryCheckpointStore
    from tpu_nexus_torch.core.signals import LifecycleContext
    from tpu_nexus_torch.k8s.fake import FakeKubeClient
    from tpu_nexus_torch.serving import FleetSupervisor

    client = FakeKubeClient(jobset_controller=True, emit_pod_events=True)
    client.inject("ADDED", "JobSet", _role_jobset())
    store = InMemoryCheckpointStore()
    fleet = ServingFleet(disagg=DisaggConfig(), handoff_sleep=lambda s: None)
    made = []

    def factory(name, step, kv_blocks):
        made.append((name, step, kv_blocks))
        # real paged engines: the handoff surface is the executor contract
        return _engine(slots=2)

    sup = FleetSupervisor(client, store, NS, fleet, FLEET_JS, ALGO, factory, grace_s=30.0, kv_blocks=64,
                          resync_period=timedelta(0))
    ctx = LifecycleContext()
    sup._factory.start(ctx)
    assert await sup._factory.wait_for_cache_sync(timeout=10.0)
    await sup.adopt_pods(step=1)
    return _Fixture(client, store, fleet, sup, ctx, made)


class TestSupervisorRoles:
    async def test_adoption_reads_roles_from_pod_env(self):
        from test_torch_fleet import FLEET_JS

        fx = await _role_fixture()
        try:
            roles = {n: r.role for n, r in fx.fleet.replicas.items()}
            assert roles == {
                f"{FLEET_JS}-prefill-0-0": ROLE_PREFILL,
                f"{FLEET_JS}-prefill-1-0": ROLE_PREFILL,
                f"{FLEET_JS}-decode-0-0": ROLE_DECODE,
            }
        finally:
            await fx.close()

    async def test_segfaulting_prefill_pod_recreated_as_prefill(self):
        """A segfaulting prefill pod is recreated AS a prefill pod — the
        pool never silently shrinks to zero while decode replicas idle —
        and the replacement manifest carries the preserved
        ``NEXUS_REPLICA_ROLE`` env."""
        from test_torch_fleet import FLEET_JS, NS, _settle

        fx = await _role_fixture()
        try:
            pod = f"{FLEET_JS}-prefill-0-0"
            fx.client.fail_pod(NS, pod, message="segfault", crash_loop=True)
            await _settle()
            await fx.sup.reconcile()
            assert fx.sup.recreated == 1
            rep = fx.fleet.replicas[pod]
            assert rep.state == "serving" and rep.role == ROLE_PREFILL
            manifest = fx.client._objects["Pod"][(NS, pod)]
            env = manifest["spec"]["containers"][0]["env"]
            assert {"name": "NEXUS_REPLICA_ROLE", "value": ROLE_PREFILL} in env
            assert fx.sup.incidents[-1]["role"] == ROLE_PREFILL
            # the recovered pool serves disaggregated traffic again
            reqs = [fx.fleet.submit(np.array([1, 2, i + 3]), 3) for i in range(2)]
            fx.fleet.run_until_drained()
            assert all(r.state == RequestState.FINISHED for r in reqs)
            assert fx.fleet.handoffs_completed == 2
        finally:
            await fx.close()

    async def test_scale_down_never_drains_a_roles_last_replica(self):
        from test_torch_fleet import FLEET_JS

        fx = await _role_fixture()
        try:
            sup, fleet = fx.sup, fx.fleet
            await sup._scale_down(1.0, "healthy", fleet.snapshot())
            assert sup.scaled_down == 1
            # the decode pool's LAST replica survived; one prefill drained
            assert f"{FLEET_JS}-decode-0-0" in fleet.replicas
            roles = [r.role for r in fleet.replicas.values()]
            assert roles.count(ROLE_PREFILL) == 1
            # every surviving role is now at its floor: no further drain
            await sup._scale_down(2.0, "healthy", fleet.snapshot())
            assert sup.scaled_down == 1
        finally:
            await fx.close()
