"""The port's tensor checkpointer (``workload/tensor_checkpoint.py``) on the
CPU: its storage, its restores, its rotation and its re-save rules.

* save → commit → restore is bit-identical for bf16, f32 and int32 leaves
  and for nested optimizer state (adamw, adamw-bf16, adafactor), and every
  restored tensor is fresh and contiguous with a storage of its own (the
  optimizer writes into them in place);
* ``restore_params`` rebuilds the params module without a template and
  reads only the params' files; it refuses ``cuda`` without a card;
* a template that does not match raises ``ValueError`` naming the place,
  and the harness's pre-health migration reseeds the sentinel state;
* a step is written under a temporary name: a crash mid-write leaves no
  step, and the next save of that step clears the leftover;
* re-saving a quarantined or abandoned step number is a real save, and a
  step that exists is refused;
* ``max_to_keep`` deletes only older committed steps;
* loads go through ``weights_only``: a tensor file that holds another
  pickle is refused, not executed, and an index naming a file outside
  its step is corrupt.

Tolerance: none — every comparison is bit for bit.
"""

import json
import os
import pickle

import pytest
import torch

from tpu_nexus_torch.models.registry import get_adapter
from tpu_nexus_torch.workload import durability
from tpu_nexus_torch.workload.harness import _restore_train_state
from tpu_nexus_torch.workload.tensor_checkpoint import (
    CURSOR_SIDECAR,
    TENSOR_DIR,
    TREE_INDEX,
    CheckpointCorrupt,
    CheckpointMissing,
    TensorCheckpointer,
)
from tpu_nexus_torch.workload.train import TrainConfig, init_train_state, make_train_step

torch.set_num_threads(1)


def _flat(obj, prefix=""):
    """(path, tensor) pairs of a state tree, modules by parameter name."""
    if isinstance(obj, torch.nn.Module):
        return [(f"{prefix}.{n}", p) for n, p in obj.named_parameters()]
    if isinstance(obj, torch.Tensor):
        return [(prefix, obj)]
    if isinstance(obj, dict):
        return [x for k, v in obj.items() for x in _flat(v, f"{prefix}/{k}")]
    if isinstance(obj, (list, tuple)):
        return [x for i, v in enumerate(obj) for x in _flat(v, f"{prefix}[{i}]")]
    return []


def _assert_bit_identical(a, b):
    fa, fb = _flat(a), _flat(b)
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (path, x), (_, y) in zip(fa, fb):
        assert x.dtype == y.dtype and x.shape == y.shape, path
        assert torch.equal(x.detach().view(torch.uint8) if x.dim() else x.detach().reshape(1).view(torch.uint8),
                           y.detach().view(torch.uint8) if y.dim() else y.detach().reshape(1).view(torch.uint8)), path


def _trained_state(preset, optimizer, seed, steps=2):
    adapter = get_adapter(preset) if isinstance(preset, str) else preset
    cfg = TrainConfig(optimizer=optimizer, warmup_steps=1, total_steps=10)
    state = init_train_state(torch.Generator().manual_seed(seed), adapter, cfg, "cpu")
    step_fn = make_train_step(adapter, cfg)
    data = adapter.data(2, 16, seed=seed)
    for _ in range(steps):
        state, _ = step_fn(state, adapter.to_device(next(data), "cpu"))
    return adapter, cfg, state


@pytest.mark.parametrize(
    "preset,optimizer,param_dtype",
    [
        ("tiny", "adamw", torch.float32),
        ("tiny", "adamw", torch.bfloat16),
        ("tiny", "adamw-bf16", torch.float32),
        ("tiny", "adafactor", torch.bfloat16),
        ("mnist", "adamw", torch.float32),
    ],
)
def test_save_commit_restore_is_bit_identical(tmp_path, preset, optimizer, param_dtype):
    if param_dtype != torch.float32:
        import dataclasses

        from tpu_nexus_torch.models.registry import LlamaAdapter

        adapter = get_adapter(preset)
        preset = LlamaAdapter(config=dataclasses.replace(adapter.config, param_dtype=param_dtype))
    adapter, cfg, state = _trained_state(preset, optimizer, seed=0)
    dtypes = {t.dtype for _, t in _flat(state)}
    assert torch.int32 in dtypes and param_dtype in dtypes
    ckpt = TensorCheckpointer(str(tmp_path))
    assert ckpt.save(2, state) == f"{tmp_path}/2"
    assert ckpt.commit(2) == f"{tmp_path}/2" and ckpt.last_committed_step == 2
    # a template from another seed: every value must come from the files
    _, _, template = _trained_state(preset, optimizer, seed=1, steps=0)
    fresh = TensorCheckpointer(str(tmp_path))
    restored = fresh.restore(template)
    _assert_bit_identical(restored, state)
    assert restored["params"] is template["params"]  # the module is filled in place
    pointers = set()
    for path, t in _flat(restored):
        assert t.is_contiguous() and t.storage_offset() == 0, path
        assert t.untyped_storage().nbytes() == t.numel() * t.element_size(), path
        assert t.untyped_storage().data_ptr() not in pointers, path
        pointers.add(t.untyped_storage().data_ptr())
    # the restored state trains on exactly as the saved one does
    step_fn = make_train_step(adapter, cfg)
    batch = adapter.to_device(next(adapter.data(2, 16, seed=5)), "cpu")
    _, m1 = step_fn(state, batch)
    _, m2 = step_fn(restored, batch)
    assert torch.equal(m1["loss"], m2["loss"]) and torch.equal(m1["grad_norm"], m2["grad_norm"])
    _assert_bit_identical(restored, state)


def test_restore_params_is_template_free_and_reads_only_params(tmp_path, monkeypatch):
    _, _, state = _trained_state("tiny", "adamw", seed=0)
    ckpt = TensorCheckpointer(str(tmp_path))
    ckpt.save(3, state)
    ckpt.commit(3)
    loaded = []
    real = torch.load
    monkeypatch.setattr(torch, "load", lambda path, **kw: loaded.append(path) or real(path, **kw))
    params = TensorCheckpointer(str(tmp_path)).restore_params(device="cpu")
    assert type(params) is type(state["params"])
    _assert_bit_identical(params, state["params"])
    assert len(loaded) == len(list(state["params"].parameters()))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TensorCheckpointer(str(tmp_path)).restore_params(3)


def test_restore_params_verifies_every_file_first(tmp_path):
    _, _, state = _trained_state("mnist", "adamw", seed=0, steps=0)
    ckpt = TensorCheckpointer(str(tmp_path))
    ckpt.save(1, state)
    ckpt.commit(1)
    # rot in an optimizer moment — a file restore_params never reads
    index = json.loads((tmp_path / "1" / TREE_INDEX).read_text())
    last = index["tree"]["dict"][1][1]["dict"][1][1]["list"][-1]["dict"][-1][1]["tensor"]
    target = tmp_path / "1" / last
    data = bytearray(target.read_bytes())
    data[len(data) // 2] ^= 0xFF
    target.write_bytes(bytes(data))
    with pytest.raises(CheckpointCorrupt, match="checksum mismatch"):
        TensorCheckpointer(str(tmp_path)).restore_params(1, device="cpu")


def test_template_mismatch_names_the_place_and_pre_health_migrates(tmp_path):
    _, _, state = _trained_state("mnist", "adamw", seed=0)
    legacy = {k: v for k, v in state.items() if k != "health"}
    ckpt = TensorCheckpointer(str(tmp_path))
    ckpt.save(4, legacy)
    ckpt.commit(4)
    _, _, template = _trained_state("mnist", "adamw", seed=1, steps=0)
    with pytest.raises(ValueError, match="/dict/health"):
        ckpt.restore(template, 4)
    restored = _restore_train_state(ckpt, template, 4)
    _assert_bit_identical({k: restored[k] for k in legacy}, legacy)
    assert int(restored["health"]["count"]) == 0 and float(restored["health"]["ema_loss"]) == 0.0
    # another model's template is refused outright, not migrated
    _, _, tiny = _trained_state("tiny", "adamw", seed=1, steps=0)
    with pytest.raises(ValueError, match="does not match"):
        _restore_train_state(ckpt, tiny, 4)


def test_a_crash_mid_write_leaves_no_step(tmp_path, monkeypatch):
    _, _, state = _trained_state("mnist", "adamw", seed=0, steps=0)
    ckpt = TensorCheckpointer(str(tmp_path))
    calls = {"n": 0}
    real = torch.save

    def dying_save(obj, f):
        calls["n"] += 1
        if calls["n"] == 3:
            raise OSError("injected disk failure mid-write")
        return real(obj, f)

    monkeypatch.setattr(torch, "save", dying_save)
    with pytest.raises(OSError, match="mid-write"):
        ckpt.save(2, state)
    leftovers = os.listdir(tmp_path)
    assert durability.list_steps(str(tmp_path)) == [] and len(leftovers) == 1
    assert ckpt.latest_verified_step() is None and ckpt.rollbacks == []
    monkeypatch.setattr(torch, "save", real)
    ckpt.save(2, state)  # clears the leftover of the same step
    ckpt.commit(2)
    assert os.listdir(tmp_path) == ["2"]


def test_resave_of_a_set_aside_step_is_a_real_save(tmp_path):
    _, _, state = _trained_state("mnist", "adamw", seed=0, steps=0)
    _, _, other = _trained_state("mnist", "adamw", seed=1, steps=0)
    ckpt = TensorCheckpointer(str(tmp_path))
    for s in (2, 4):
        ckpt.save(s, state)
        ckpt.commit(s)
    with pytest.raises(ValueError, match="already exists"):
        ckpt.save(4, other)
    durability.abandon_step(str(tmp_path), 4)
    durability.quarantine_step(str(tmp_path), 2)
    ckpt.reload()  # a no-op: nothing is cached
    for s in (2, 4):
        ckpt.save(s, other)
        ckpt.commit(s)
        _, _, template = _trained_state("mnist", "adamw", seed=2, steps=0)
        _assert_bit_identical(TensorCheckpointer(str(tmp_path)).restore(template, s), other)
    assert sorted(os.listdir(tmp_path)) == ["2", "2.corrupt", "4", "4.abandoned"]


def test_max_to_keep_rotates_only_older_committed_steps(tmp_path):
    _, _, state = _trained_state("mnist", "adamw", seed=0, steps=0)
    ckpt = TensorCheckpointer(str(tmp_path), max_to_keep=2)
    for s in (1, 2):
        ckpt.save(s, state)
        ckpt.commit(s)
    durability.quarantine_step(str(tmp_path), 1)
    ckpt.save(3, state)  # torn: saved, never committed
    for s in (4, 5, 6):
        ckpt.save(s, state)
        ckpt.commit(s)
    assert sorted(os.listdir(tmp_path)) == ["1.corrupt", "3", "5", "6"]
    assert ckpt.latest_step() == 6 and ckpt.latest_verified_step() == 6


def test_cursor_sidecar_is_covered_by_the_manifest(tmp_path):
    _, _, state = _trained_state("mnist", "adamw", seed=0, steps=0)
    ckpt = TensorCheckpointer(str(tmp_path))
    ckpt.save(2, state)
    ckpt.save_cursor(2, {"position": 5, "skips": [[2, 4]]})
    manifest = durability.read_json_sidecar(str(tmp_path / "2"), TREE_INDEX)
    assert manifest["step"] == 2
    ckpt.commit(2)
    assert CURSOR_SIDECAR in ckpt.verify(2)["files"]
    assert ckpt.load_cursor(2) == {"position": 5, "skips": [[2, 4]]}
    (tmp_path / "2" / CURSOR_SIDECAR).write_text('{"position": 6, "skips": [[2, 4]]}\n')
    with pytest.raises(CheckpointCorrupt):
        ckpt.verify(2)


def test_a_view_is_saved_without_its_base_storage(tmp_path):
    base = torch.arange(1 << 16, dtype=torch.float32)
    view = base[100:110]
    ckpt = TensorCheckpointer(str(tmp_path))
    ckpt.save(1, {"params": {"w": view}})
    ckpt.commit(1)
    (size,) = [os.path.getsize(tmp_path / "1" / f) for f in os.listdir(tmp_path / "1" / TENSOR_DIR)
               for f in [f"{TENSOR_DIR}/{f}"]]
    assert size < 4096  # not the 256 KB base
    assert torch.equal(ckpt.restore_params(1, device="cpu")["w"], view)


def test_loads_refuse_a_pickle_that_is_not_a_tensor(tmp_path):
    class Payload:
        def __reduce__(self):
            return (os.system, ("echo pwned > " + str(tmp_path / "pwned"),))

    ckpt = TensorCheckpointer(str(tmp_path))
    ckpt.save(1, {"params": {"w": torch.ones(3)}})
    with open(tmp_path / "1" / TENSOR_DIR / "00000.pt", "wb") as fh:
        pickle.dump(Payload(), fh)
    ckpt.commit(1)  # the manifest blesses the bytes: only weights_only stops them
    with pytest.raises(pickle.UnpicklingError):
        ckpt.restore_params(1, device="cpu")
    assert not (tmp_path / "pwned").exists()


def test_nothing_to_restore_is_classified(tmp_path):
    ckpt = TensorCheckpointer(str(tmp_path / "empty"))
    with pytest.raises(CheckpointMissing, match="no verifiable checkpoint"):
        ckpt.restore({"step": torch.zeros((), dtype=torch.int32)})
    assert ckpt.latest_step() is None


def test_an_index_naming_a_file_outside_the_step_is_corrupt(tmp_path):
    ckpt = TensorCheckpointer(str(tmp_path / "ckpt"))
    ckpt.save(1, {"params": {"w": torch.ones(3)}})
    index_path = tmp_path / "ckpt" / "1" / TREE_INDEX
    index = json.loads(index_path.read_text())
    torch.save(torch.zeros(3), tmp_path / "outside.pt")
    index["tree"]["dict"][0][1]["dict"][0][1]["tensor"] = "../../outside.pt"
    index_path.write_text(json.dumps(index))
    ckpt.commit(1)
    with pytest.raises(CheckpointCorrupt, match="outside the step"):
        ckpt.restore_params(1, device="cpu")
