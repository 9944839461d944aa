"""The port's parallel training (``tpu_nexus_torch``) against the JAX package.

Ranks are spawned gloo processes on the CPU, one world of 4 for the module
(``workload/rehearsal.py::RankWorld``; the pytest process is not a rank).
The JAX side runs as its own tests run it, on the virtual 8-device CPU mesh
(``build_mesh(spec, devices=jax.devices()[:n])``).

* One train step, f32, from the same carried state (the JAX package's
  parameters and optimizer state after a first step on the mesh, carried
  by ``models/convert.py``: Adam's first step, ``g / (|g| + eps)``, turns
  the rounding noise of a gradient element that cancels to ~0 into up to
  2·lr, in any two programs, the JAX package's meshes included) on the
  same global batch, at every mesh of parallel training (fsdp 2, dp 2, tp 2, fsdp 2 ×
  tp 2, sp 2 ring, sp 2 Ulysses, sp 2 × tp 2 ring, fsdp 2 × sp 2
  Ulysses) with adamw, and with adafactor at fsdp 2 and tp 2: loss, grad
  norm and every parameter leaf after the update within 1e-5 × max|ref| of
  the JAX package's ``make_train_step`` on the same mesh AND of the port's
  one-device step.  The config (hidden 128, intermediate 256) has factored
  Adafactor leaves (the embedding, the MLP) and unfactored ones.
* The same step under each remat policy (``attn_out`` keeps the ring's
  forward; ``nothing`` and ``qkv`` recompute it) matches one device: the
  recompute issues its collectives in the same order on every rank.
* Ring and Ulysses attention: forward and q/k/v gradients against
  ``ring_attention_sharded`` / ``ulysses_attention`` (f32 within 1e-5,
  causal and full, GQA, with tp), one ring case against the JAX ring's
  Pallas route in interpret mode at local seq 128 and D 128, a bf16 case
  within 2e-2, and the Ulysses head-cap refusal in the reference's words.
* The ring under ``pp`` is refused from the loss in the reference's words
  (pipeline and MoE training on a mesh: ``tests/test_torch_pipeline.py``,
  ``tests/test_torch_moe_ep.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_nexus.models import llama as jax_llama
from tpu_nexus.parallel import LOGICAL_RULES_FSDP_TP, MeshSpec, build_mesh
from tpu_nexus.parallel.ring import ring_attention_sharded
from tpu_nexus.parallel.ulysses import ulysses_attention
from tpu_nexus.workload import train as jax_train
from tpu_nexus_torch.models import llama as port_llama
from tpu_nexus_torch.parallel import mesh as port_mesh
from tpu_nexus_torch.parallel.ulysses import ulysses_attention as port_ulysses
from tpu_nexus_torch.workload import train as port_train
from tpu_nexus_torch.workload.rehearsal import RankWorld

KW = dict(vocab_size=256, hidden=128, n_layers=2, n_heads=4, n_kv_heads=2, head_dim=16,
          intermediate=256, max_seq_len=64, remat=False, tied_embeddings=True)
JCFG = jax_llama.LlamaConfig(dtype=jnp.float32, param_dtype=jnp.float32, **KW)
PCFG = port_llama.LlamaConfig(dtype=torch.float32, param_dtype=torch.float32, **KW)
TRAIN = dict(learning_rate=1e-3, warmup_steps=0, total_steps=4, ce_chunk=16)
BATCHES = [np.random.default_rng(s).integers(0, KW["vocab_size"], (4, 32)).astype(np.int32) for s in (7, 8)]

MESHES = [
    ({"fsdp": 2}, "ring"), ({"dp": 2}, "ring"), ({"tp": 2}, "ring"), ({"fsdp": 2, "tp": 2}, "ring"),
    ({"sp": 2}, "ring"), ({"sp": 2}, "ulysses"), ({"sp": 2, "tp": 2}, "ring"), ({"fsdp": 2, "sp": 2}, "ulysses"),
]
CASES = [(spec, attn, "adamw") for spec, attn in MESHES] + [
    ({"fsdp": 2}, "ring", "adafactor"), ({"tp": 2}, "ring", "adafactor")]


@pytest.fixture(scope="module")
def world():
    with RankWorld(4, timeout_s=120) as w:
        yield w


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v, np.float32)
    return out


def _moments(opt_state, optimizer, params):
    """optax's state after a step as the port's (count, per-leaf moments),
    in the parameters' flatten order."""
    import optax

    paths = sorted(_flat(params))
    if optimizer == "adamw":
        adam = [s for s in jax.tree.leaves(opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
                if isinstance(s, optax.ScaleByAdamState)][0]
        mu, nu = _flat(adam.mu), _flat(adam.nu)
        return int(adam.count), [{"mu": mu[p], "nu": nu[p]} for p in paths]
    fac = [s for s in jax.tree.leaves(opt_state, is_leaf=lambda x: hasattr(x, "v_row")) if hasattr(s, "v_row")][0]
    row, col, v = _flat(fac.v_row), _flat(fac.v_col), _flat(fac.v)
    flat = _flat(params)
    return int(fac.count), [
        {"v_row": row[p], "v_col": col[p]} if v[p].shape != flat[p].shape else {"v": v[p]} for p in paths]


def _jax_steps(spec, attn, optimizer):
    """Two JAX steps on the mesh: the state after the first (params and
    optimizer state, numpy: what the port starts from) and the second
    step's loss, grad norm and parameters (the reference)."""
    n = int(np.prod(list(spec.values()))) if spec else 1
    mesh = build_mesh(MeshSpec(**{"fsdp": 1, **spec}), devices=jax.devices()[:n])
    tc = jax_train.TrainConfig(**TRAIN, sp_attn=attn, optimizer=optimizer)
    state = jax_train.init_train_state(jax.random.PRNGKey(0), JCFG, tc, mesh, LOGICAL_RULES_FSDP_TP)
    step = jax_train.make_train_step(JCFG, tc, mesh, LOGICAL_RULES_FSDP_TP)
    with mesh:
        state, _ = step(state, jnp.asarray(BATCHES[0]))
        params = jax.tree.map(np.asarray, state["params"])
        start = (params, _moments(jax.tree.map(np.asarray, state["opt_state"]), optimizer, params))
        state, m = step(state, jnp.asarray(BATCHES[1]))
    return start, (float(m["loss"]), float(m["grad_norm"]), _flat(jax.tree.map(np.asarray, state["params"])))


def _port_step(world, spec, attn, optimizer, start, cfg=PCFG):
    """The port's second step on the mesh from the carried first-step state."""
    tc = port_train.TrainConfig(**TRAIN, sp_attn=attn, optimizer=optimizer)
    got = world.run("tpu_nexus_torch.workload.rehearsal:train_steps", spec=spec, model=cfg, train_cfg=tc,
                    batches=[BATCHES[1]], params=start[0], opt_state=start[1])[0]
    return got["loss"][0], got["grad_norm"][0], got["params"]


def _close(got, ref, what):
    loss, norm, params = got
    rloss, rnorm, rparams = ref
    assert abs(loss - rloss) <= 1e-5 * abs(rloss), (what, loss, rloss)
    assert abs(norm - rnorm) <= 1e-5 * abs(rnorm), (what, norm, rnorm)
    assert sorted(params) == sorted(rparams)
    for path, want in rparams.items():
        err = float(np.abs(params[path] - want).max())
        assert err <= 1e-5 * float(np.abs(want).max()), (what, path, err, float(np.abs(want).max()))


@pytest.mark.parametrize("spec,attn,optimizer", CASES,
                         ids=[f"{'x'.join(f'{k}{v}' for k, v in s.items())}-{a}-{o}" for s, a, o in CASES])
def test_train_step_matches_jax_on_the_mesh(world, spec, attn, optimizer):
    start, ref = _jax_steps(spec, attn, optimizer)
    got = _port_step(world, spec, attn, optimizer, start)
    _close(got, ref, "jax")
    _close(got, _port_step(world, {}, attn, optimizer, start), "one device")


@pytest.fixture(scope="module")
def adamw_start():
    return _jax_steps({}, "ring", "adamw")[0]


@pytest.mark.parametrize("policy", ["attn_out", "nothing", "qkv"])
def test_remat_recompute_keeps_the_collective_order(world, adamw_start, policy):
    cfg = dataclasses.replace(PCFG, remat=True, remat_policy=policy)
    one = _port_step(world, {}, "ring", "adamw", adamw_start, cfg)
    for spec, attn in [({"fsdp": 2, "tp": 2}, "ring"), ({"sp": 2, "tp": 2}, "ring"), ({"fsdp": 2, "sp": 2}, "ulysses")]:
        _close(_port_step(world, spec, attn, "adamw", adamw_start, cfg), one, (policy, spec, attn))


# -- ring and Ulysses attention ------------------------------------------------------


def _qkv(seed, b, s, hq, hkv, d, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.standard_normal(shape).astype(dtype)
                  for shape in ((b, s, hq, d), (b, s, hkv, d), (b, s, hkv, d), (b, s, hq, d)))
    return q, k, v, g


def _jax_attention(kind, spec, q, k, v, g, causal, **kw):
    n = int(np.prod(list(spec.values())))
    mesh = build_mesh(MeshSpec(**{"fsdp": 1, **spec}), devices=jax.devices()[:n])
    head_axis = "tp" if spec.get("tp", 1) > 1 else None
    if kind == "ring":
        fn = lambda q, k, v: ring_attention_sharded(q, k, v, mesh, causal=causal, head_axis=head_axis, **kw)  # noqa: E731
    else:
        fn = lambda q, k, v: ulysses_attention(q, k, v, mesh=mesh, causal=causal, head_axis=head_axis)  # noqa: E731
    with mesh:
        out, vjp = jax.vjp(jax.jit(fn), *(jnp.asarray(x) for x in (q, k, v)))
        grads = vjp(jnp.asarray(g).astype(out.dtype))
    return {name: np.asarray(x, np.float32) for name, x in zip(("out", "dq", "dk", "dv"), (out, *grads))}


ATTN = [
    ("ring", {"sp": 4}, True), ("ring", {"sp": 4}, False), ("ring", {"fsdp": 2, "sp": 2}, True),
    ("ring", {"sp": 2, "tp": 2}, True), ("ulysses", {"sp": 2}, True), ("ulysses", {"sp": 2}, False),
    ("ulysses", {"sp": 2, "tp": 2}, True),
]


@pytest.mark.parametrize("kind,spec,causal", ATTN)
def test_sequence_parallel_attention_matches_jax(world, kind, spec, causal):
    q, k, v, g = _qkv(1, 2, 64, 8, 4, 16)
    got = world.run("tpu_nexus_torch.workload.rehearsal:sp_attention", spec=spec, kind=kind, q=q, k=k, v=v, g=g,
                    causal=causal)[0]
    ref = _jax_attention(kind, spec, q, k, v, g, causal)
    for name in ("out", "dq", "dk", "dv"):
        err = float(np.abs(got[name] - ref[name]).max())
        assert err <= 1e-5 * float(np.abs(ref[name]).max()), (name, err)


@pytest.mark.parametrize("causal", [True, False])
def test_ring_matches_the_jax_pallas_route_in_interpret_mode(world, causal):
    """Local seq 128, D 128: the JAX ring's blocks are the Pallas flash
    kernels (interpret mode); the port's are the kernels' plain versions."""
    q, k, v, g = _qkv(5, 1, 256, 2, 1, 128)
    got = world.run("tpu_nexus_torch.workload.rehearsal:sp_attention", spec={"sp": 2}, kind="ring", q=q, k=k, v=v,
                    g=g, causal=causal)[0]
    ref = _jax_attention("ring", {"sp": 2}, q, k, v, g, causal, impl="pallas", interpret=True)
    for name in ("out", "dq", "dk", "dv"):
        err = float(np.abs(got[name] - ref[name]).max())
        assert err <= 1e-5 * float(np.abs(ref[name]).max()), (name, err)


def test_bf16_ring_stays_within_2e_2(world):
    q, k, v, g = _qkv(2, 2, 64, 4, 2, 16)
    got = world.run("tpu_nexus_torch.workload.rehearsal:sp_attention", spec={"sp": 2, "tp": 2}, kind="ring",
                    q=q, k=k, v=v, g=g, causal=True, dtype="bfloat16")[0]
    ref = _jax_attention("ring", {"sp": 2, "tp": 2}, *(x.astype(jnp.bfloat16) for x in (q, k, v, g)), causal=True)
    for name in ("out", "dq", "dk", "dv"):
        assert float(np.abs(got[name] - ref[name]).max()) <= 2e-2 * max(1.0, float(np.abs(ref[name]).max())), name


def test_ulysses_head_cap_refusal_matches_jax():
    """Hkv 2 over sp 4: the reference's check and words, before any exchange."""
    class _Mesh:
        def size(self, *axes):
            return {"sp": 4, "tp": 1}[axes[0]]

    q, k = torch.zeros(1, 8, 8, 16), torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError) as got:
        port_ulysses(q, k, k, mesh=_Mesh(), head_axis=None)
    mesh = build_mesh(MeshSpec(fsdp=1, sp=4), devices=jax.devices()[:4])
    with pytest.raises(ValueError) as want:
        ulysses_attention(jnp.zeros((1, 8, 8, 16)), jnp.zeros((1, 8, 2, 16)), jnp.zeros((1, 8, 2, 16)),
                          mesh=mesh, head_axis=None)
    assert str(got.value) == str(want.value)


def test_train_mesh_groups_follow_the_axis_order():
    """A world of one is the trivial mesh; the coordinates are row-major,
    tp fastest (the JAX mesh's device order)."""
    m = port_mesh.TrainMesh(port_mesh.MeshSpec(fsdp=1))
    assert m.world == 1 and m.size("fsdp", "tp") == 1 and m.group("fsdp") is None
    assert port_mesh.mesh_coords(5, (1, 1, 2, 1, 2, 2)) == (0, 0, 1, 0, 0, 1)


class _PipelineMesh:
    """A mesh that only answers the refusal checks' questions."""

    def __init__(self, **sizes):
        self.sizes = {"pp": 1, "dp": 1, "fsdp": 1, "ep": 1, "sp": 1, "tp": 1, **sizes}
        self.world = int(np.prod(list(self.sizes.values())))

    def size(self, *axes):
        return int(np.prod([self.sizes[a] for a in axes]))

    def describe(self):
        return {a: s for a, s in self.sizes.items() if s > 1}


@pytest.mark.parametrize("case", ["ring_under_pp"])
def test_what_a6b_ii_brings_still_raises_naming_it(case):
    """Of what ROADMAP.md A6b-ii brought to training, the reference refuses
    only the ring under pp: so does the port, in its words."""
    from tpu_nexus.models.registry import LlamaAdapter as JaxLlama
    from tpu_nexus_torch.models.registry import LlamaAdapter

    with pytest.raises(ValueError) as want:
        JaxLlama(config=JCFG).make_loss(jax_train.TrainConfig(),
                                        build_mesh(MeshSpec(pp=2, sp=2, fsdp=1), devices=jax.devices()[:4]))
    with pytest.raises(ValueError) as got:
        LlamaAdapter(config=PCFG).make_loss(port_train.TrainConfig(), _PipelineMesh(pp=2, sp=2))
    assert str(got.value) == str(want.value)
