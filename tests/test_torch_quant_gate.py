"""The port's perplexity gates (``tpu_nexus_torch/tools``) against the JAX
package's tools (``tools/int8_gate_1b.py``, ``tools/int4_gate_1b.py``).

* The corpus: the JAX tools' token arrays, captured where they write them,
  equal the port's ``corpus_tokens`` (the int4 tool's ``tiny`` tier, 1 M
  tokens; the int8 tool's 8 M-token corpus, the full 8 M).
* ``measure`` on the ``tiny`` tier, f32, after a few training steps of the
  port: every perplexity it reports (forward and decode, full precision,
  int8 and int4 weights, int8 KV) equals the JAX gate's computation on the
  converted params, the same held-out windows and the same sizes, within
  1e-4 relative; its JSON lines carry the reference tools' keys.
* The gates' thresholds and the trained-model check.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tools import int4_gate_1b as jax_int4_tool
from tools import int8_gate_1b as jax_int8_tool
from tpu_nexus.models import LlamaConfig as JaxLlamaConfig
from tpu_nexus.models.generate import teacher_forced_decode_ce as jax_decode_ce
from tpu_nexus.models.quant import quantize_params as jax_quantize_params
from tpu_nexus.parallel import LOGICAL_RULES_FSDP_TP, MeshSpec, build_mesh
from tpu_nexus.workload import data as jax_data
from tpu_nexus.workload.train import TrainConfig as JaxTrainConfig
from tpu_nexus.workload.train import make_eval_step as jax_make_eval_step
from tpu_nexus_torch.models.convert import params_to_numpy
from tpu_nexus_torch.tools import int4_gate_1b as gate4
from tpu_nexus_torch.tools import int8_gate_1b as gate8

torch.set_num_threads(1)
REL = 1e-4

#: the keys of the reference tools' JSON lines (tools/int8_gate_1b.py and
#: tools/int4_gate_1b.py print them from inside ``main``)
INT8_FORWARD_KEYS = {"phase", "model", "steps", "ppl_bf16", "ppl_int8w", "support", "rel_delta", "gate_lt", "pass"}
INT8_DECODE_KEYS = {"phase", "model", "seq", "ppl_bf16", "ppl_int8kv", "ppl_int8w_int8kv", "rel_delta_kv",
                    "rel_delta_both", "gate_kv_lt", "gate_both_lt", "pass"}
INT4_FORWARD_KEYS = {"phase", "model", "steps", "support", "int4_group", "ppl_bf16", "ppl_int8w", "ppl_int4w",
                     "rel_delta_int8", "rel_delta_int4", "gate_int8_lt", "gate_int4_lt", "pass"}
INT4_DECODE_KEYS = {"phase", "model", "seq", "int4_group", "ppl_bf16", "ppl_int8w", "ppl_int4w", "rel_delta_int8",
                    "rel_delta_int4", "gate_int8_lt", "gate_int4_lt", "pass"}


class _Captured(Exception):
    pass


def _jax_tool_corpus(monkeypatch, tool, model):
    """The tokens a JAX tool writes, caught at its ``write_token_npy``
    (the tool stops there)."""
    seen = {}

    def capture(path, tokens):
        seen["tokens"] = np.asarray(tokens)
        raise _Captured

    monkeypatch.setattr(jax_data, "write_token_npy", capture)
    monkeypatch.setenv("NEXUS_GATE_MODEL", model)
    with pytest.raises(_Captured):
        tool.main()
    return seen["tokens"]


def test_corpus_equals_the_jax_tools(monkeypatch):
    small = _jax_tool_corpus(monkeypatch, jax_int4_tool, "tiny")
    full = _jax_tool_corpus(monkeypatch, jax_int8_tool, "nexus_1b")
    assert small.shape == (1024 * 1024,) and full.shape == (8 * 1024 * 1024,)
    port_full = gate8.corpus_tokens(8 * 1024 * 1024)
    np.testing.assert_array_equal(port_full, full)
    np.testing.assert_array_equal(gate8.corpus_tokens(1024 * 1024), small)
    # the 1 M corpus is the 8 M one's prefix, and it stays inside the support
    np.testing.assert_array_equal(port_full[: small.shape[0]], small)
    assert port_full.dtype == np.int32 and int(port_full.max()) < gate8.SUPPORT


def test_tiers_match_the_reference_tools():
    assert (gate8.gate_tier("nexus_1b").batch, gate8.gate_tier("nexus_1b").seq) == (16, 2048)
    assert gate8.gate_tier("nexus_moe").batch == 32 and gate8.gate_tier("nexus_moe").cfg.dispatch == "gmm"
    small = gate8.gate_tier("small", cpu_tiers=True)
    assert (small.cfg.hidden, small.cfg.n_layers, small.batch, small.seq, small.n_tokens) == (
        256, 2, 8, 128, 1024 * 1024)
    tiny = gate8.gate_tier("tiny", cpu_tiers=True)
    assert (tiny.cfg.vocab_size, tiny.cfg.hidden, tiny.batch, tiny.seq) == (1024, 64, 8, 256)
    with pytest.raises(ValueError, match="NEXUS_GATE_MODEL 'small'"):
        gate8.gate_tier("small")  # the int8 gate has only the card's tiers
    with pytest.raises(ValueError, match="unknown NEXUS_GATE_MODEL"):
        gate8.gate_tier("nexus_2b", cpu_tiers=True)


def test_thresholds_and_the_trained_check():
    assert (gate8.GATE_WEIGHTS, gate8.GATE_KV, gate8.GATE_BOTH) == (0.01, 0.01, 0.02)
    assert (gate4.GATE_INT8, gate4.GATE_INT4) == (0.01, 0.02)
    gate8.check_trained(255.9)
    with pytest.raises(RuntimeError, match="did not train"):
        gate8.check_trained(256.0)


@pytest.fixture(scope="module")
def trained_tiny(tmp_path_factory):
    """The ``tiny`` tier in f32 after 3 steps of the port's training half,
    its corpus written under a temporary directory."""
    tier = gate8.gate_tier("tiny", cpu_tiers=True)
    tier = dataclasses.replace(tier, cfg=dataclasses.replace(tier.cfg, dtype=torch.float32,
                                                             param_dtype=torch.float32))
    path = str(tmp_path_factory.mktemp("gate") / "corpus.npy")
    np.save(path, gate8.corpus_tokens(tier.n_tokens))
    lines = []
    params = gate8.train(tier, 3, path, torch.device("cpu"), log=lines.append)
    assert lines == []  # a JSON line every 50 steps
    return tier, path, params


SIZES = dict(eval_batches=2, decode_batches=1, decode_seq=32)


def _jax_gate(tier, path, params):
    """The JAX gate's computation (``tools/int*_gate_1b.py``'s
    ``forward_ppl`` and ``decode_ppl``) on the port's params, converted."""
    jcfg = dataclasses.replace(JaxLlamaConfig.tiny(vocab_size=1024), dtype=jnp.float32, param_dtype=jnp.float32)
    jparams = jax.tree.map(jnp.asarray, params_to_numpy(params))
    mesh = build_mesh(MeshSpec(fsdp=-1))
    eval_fn = jax_make_eval_step(jcfg, JaxTrainConfig(), mesh, LOGICAL_RULES_FSDP_TP)
    split = int(tier.n_tokens * 0.98)
    heldout = jax_data.token_file_batches(path, batch=tier.batch, seq_len=tier.seq, seed=99, start=split)
    eval_batches = [jnp.asarray(next(heldout)) for _ in range(SIZES["eval_batches"])]
    dec_stream = jax_data.token_file_batches(path, batch=8, seq_len=SIZES["decode_seq"], seed=7, start=split)
    dec_batches = [jnp.asarray(next(dec_stream)) for _ in range(SIZES["decode_batches"])]

    def forward_ppl(p):
        with mesh:
            ces = [float(eval_fn({"params": p}, b)["ce_loss"]) for b in eval_batches]
        return float(np.exp(np.mean(ces)))

    def decode_ppl(p, kv_quant=""):
        return float(np.exp(np.mean([float(jax_decode_ce(p, b, jcfg, kv_quant=kv_quant)) for b in dec_batches])))

    q8 = jax_quantize_params(jparams, mode="int8")
    q4 = jax_quantize_params(jparams, mode="int4", group=16)
    return {
        "fwd_full": forward_ppl(jparams), "fwd_int8": forward_ppl(q8), "fwd_int4": forward_ppl(q4),
        "dec_full": decode_ppl(jparams), "dec_kv8": decode_ppl(jparams, "int8"),
        "dec_both": decode_ppl(q8, "int8"), "dec_int8": decode_ppl(q8), "dec_int4": decode_ppl(q4),
    }


def test_measure_equals_the_jax_gates_computation(trained_tiny, monkeypatch):
    tier, path, params = trained_tiny
    # three steps do not train the model: the check has its own test
    monkeypatch.setattr(gate8, "check_trained", lambda ppl: None)
    dev = torch.device("cpu")
    f8, d8 = gate8.measure(params, tier, path, dev, 3, **SIZES)
    f4, d4 = gate4.measure(params, tier, path, dev, 3, 16, **SIZES)
    ref = _jax_gate(tier, path, params)
    got = {
        "fwd_full": f8["ppl_bf16"], "fwd_int8": f8["ppl_int8w"], "fwd_int4": f4["ppl_int4w"],
        "dec_full": d8["ppl_bf16"], "dec_kv8": d8["ppl_int8kv"], "dec_both": d8["ppl_int8w_int8kv"],
        "dec_int8": d4["ppl_int8w"], "dec_int4": d4["ppl_int4w"],
    }
    for key, value in got.items():
        assert value == pytest.approx(ref[key], rel=REL), key
    assert f4["ppl_bf16"] == f8["ppl_bf16"] and d4["ppl_bf16"] == d8["ppl_bf16"]
    assert set(f8) == INT8_FORWARD_KEYS and set(d8) == INT8_DECODE_KEYS
    assert set(f4) == INT4_FORWARD_KEYS and set(d4) == INT4_DECODE_KEYS
    assert (f8["phase"], d8["phase"], f4["int4_group"], d4["seq"]) == ("gate_forward", "gate_decode", 16, 32)
    assert f8["pass"] == (abs(f8["rel_delta"]) < 0.01)


def test_measure_refuses_an_untrained_model(trained_tiny):
    tier, path, params = trained_tiny
    with pytest.raises(RuntimeError, match="did not train"):
        gate8.measure(params, tier, path, torch.device("cpu"), 3, **SIZES)


def test_main_runs_end_to_end_on_the_cpu(monkeypatch, tmp_path, capsys):
    """``python -m tpu_nexus_torch.tools.int4_gate_1b --with-int8-gate`` on
    the tiny tier: a train line, both gates' lines, the exit code saying
    whether every gate passed (the untrained model is refused)."""
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr("tempfile.tempdir", None)
    env = {"NEXUS_GATE_MODEL": "tiny", "NEXUS_GATE_STEPS": "50", "NEXUS_DEVICE": "cpu", "NEXUS_QUANT_GROUP": "16"}
    monkeypatch.setattr(gate8, "check_trained", lambda ppl: None)
    monkeypatch.setattr(gate8, "heldout", lambda tier, path, device, **kw: _few(tier, path, device, **kw))
    rc = gate4.main(["--with-int8-gate"], env=env)
    out = [line for line in capsys.readouterr().out.splitlines() if line.startswith("{")]
    assert len(out) == 5 and '"phase": "train"' in out[0] and '"step": 50' in out[0]
    assert rc in (0, 1)
    assert os.path.exists(tmp_path / "gate4_corpus_tiny.npy")


_heldout = gate8.heldout


def _few(tier, path, device, *, batch, seq, seed, count):
    return _heldout(tier, path, device, batch=batch, seq=min(seq, 32), seed=seed, count=1)
