"""The port's durability layer (``tpu_nexus_torch/workload/durability.py``)
against the JAX package's, on the same directories.

The port keeps the manifest and commit-marker format byte for byte, so a
checkpoint either package wrote resolves and verifies under the other:

* both packages' ``build_manifest`` give the same JSON for one step
  directory, and their staged manifests are the same bytes;
* a step committed by either package's checkpointer verifies under both
  packages' ``verify_step`` and ``resolve_verified_uri``;
* both classify the same corruptions alike (missing marker, truncated
  file, flipped byte, wrong-shaped manifest, unreadable file);
* ``newest_verified_step`` returns the same step and the same rollback
  records, quarantining or read-only;
* the poller and the resolver cache as the reference's do, the ``adopt``
  CLI migrates, and the copy imports only the standard library.

Tolerance: none — every comparison is exact.
"""

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_nexus.workload import durability as jax_durability
from tpu_nexus.workload.tensor_checkpoint import TensorCheckpointer as JaxCheckpointer
from tpu_nexus_torch.workload import durability
from tpu_nexus_torch.workload.tensor_checkpoint import TensorCheckpointer

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
WRITERS = ("jax", "port")


def _state(step, writer, seed=0):
    rng = np.random.default_rng(seed + step)
    w = rng.standard_normal(16).astype(np.float32)
    b = rng.standard_normal(3).astype(np.float32)
    if writer == "jax":
        return {"params": {"w": jnp.asarray(w), "b": jnp.asarray(b)}, "step": jnp.int32(step)}
    return {"params": {"w": torch.from_numpy(w), "b": torch.from_numpy(b)},
            "step": torch.tensor(step, dtype=torch.int32)}


def _commit(directory, writer, *steps):
    """Commit ``steps`` with the ``writer`` package's checkpointer."""
    ckpt = (JaxCheckpointer if writer == "jax" else TensorCheckpointer)(str(directory), max_to_keep=10)
    for s in steps:
        ckpt.save(s, _state(s, writer))
        ckpt.commit(s)
    ckpt.close()


def _verdict(module, step_dir, step):
    try:
        module.verify_step(step_dir, step)
    except module.CheckpointError as exc:
        return exc.cause
    return "ok"


@pytest.mark.parametrize("writer", WRITERS)
def test_build_manifest_is_the_reference_json(tmp_path, writer):
    _commit(tmp_path, writer, 2)
    step_dir = str(tmp_path / "2")
    mine, ref = durability.build_manifest(step_dir, 2), jax_durability.build_manifest(step_dir, 2)
    assert json.dumps(mine, sort_keys=True) == json.dumps(ref, sort_keys=True)
    assert mine["file_count"] == len(durability.manifest_files(step_dir)) > 0
    # the staged manifests are the same bytes, and so is the committed one
    with open(durability.write_manifest_temp(step_dir, mine), "rb") as fh:
        staged = fh.read()
    with open(jax_durability.write_manifest_temp(step_dir, ref), "rb") as fh:
        assert fh.read() == staged
    with open(os.path.join(step_dir, durability.MANIFEST_NAME), "rb") as fh:
        assert fh.read() == staged


@pytest.mark.parametrize("writer", WRITERS)
def test_a_committed_step_verifies_under_both_packages(tmp_path, writer):
    _commit(tmp_path, writer, 2, 4)
    for module in (durability, jax_durability):
        for s in (2, 4):
            assert module.verify_step(str(tmp_path / str(s)), s)["step"] == s
        assert module.resolve_verified_uri(f"{tmp_path}/4") == f"{tmp_path}/4"
        assert module.newest_verified_step(str(tmp_path), quarantine=False) == (4, [])
    # a torn newest step: both resolvers repoint to the same previous step
    os.remove(tmp_path / "4" / durability.MANIFEST_NAME)
    assert durability.resolve_verified_uri(f"{tmp_path}/4") == f"{tmp_path}/2"
    assert jax_durability.resolve_verified_uri(f"{tmp_path}/4") == f"{tmp_path}/2"


def _corrupt(kind, step_dir, monkeypatch):
    files = durability.manifest_files(step_dir)
    target = os.path.join(step_dir, files[0])
    if kind == "missing-marker":
        os.remove(os.path.join(step_dir, durability.MANIFEST_NAME))
    elif kind == "truncated":
        with open(target, "r+b") as fh:
            fh.truncate(os.path.getsize(target) - 1)
    elif kind == "flipped-byte":
        with open(target, "r+b") as fh:
            fh.seek(os.path.getsize(target) // 2)
            byte = fh.read(1)[0]
            fh.seek(-1, os.SEEK_CUR)
            fh.write(bytes([byte ^ 0x01]))
    elif kind == "wrong-shaped-manifest":
        with open(os.path.join(step_dir, durability.MANIFEST_NAME), "w", encoding="utf-8") as fh:
            fh.write('{"step": 2, "files": {"a": "junk"}}')
    elif kind == "unreadable-file":
        for module in (durability, jax_durability):
            real = module._sha256_file

            def failing(path, chunk=1 << 20, _real=real):
                if os.path.samefile(path, target):
                    raise OSError("injected I/O error")
                return _real(path, chunk)

            monkeypatch.setattr(module, "_sha256_file", failing)


@pytest.mark.parametrize("writer", WRITERS)
@pytest.mark.parametrize(
    "kind,cause",
    [
        ("missing-marker", "uncommitted"),
        ("truncated", "corrupt"),
        ("flipped-byte", "corrupt"),
        ("wrong-shaped-manifest", "corrupt"),
        ("unreadable-file", "corrupt"),
    ],
)
def test_corruptions_classify_alike(tmp_path, monkeypatch, writer, kind, cause):
    _commit(tmp_path, writer, 2)
    step_dir = str(tmp_path / "2")
    _corrupt(kind, step_dir, monkeypatch)
    assert _verdict(durability, step_dir, 2) == _verdict(jax_durability, step_dir, 2) == cause
    assert durability.resolve_verified_uri(f"{tmp_path}/2") is None
    assert jax_durability.resolve_verified_uri(f"{tmp_path}/2") is None


@pytest.mark.parametrize("quarantine", [True, False])
@pytest.mark.parametrize("writer", WRITERS)
def test_newest_verified_step_rolls_back_alike(tmp_path, writer, quarantine):
    """Steps 2..8: 8 bit-rotten, 6 torn; both packages land on 4 with the
    same rollback records (detail strings name the directory scanned)."""
    _commit(tmp_path / "src", writer, 2, 4, 6, 8)
    flip = tmp_path / "src" / "8" / durability.manifest_files(str(tmp_path / "src" / "8"))[0]
    data = bytearray(flip.read_bytes())
    data[len(data) // 2] ^= 0xFF
    flip.write_bytes(bytes(data))
    os.remove(tmp_path / "src" / "6" / durability.MANIFEST_NAME)
    shutil.copytree(tmp_path / "src", tmp_path / "mine")
    shutil.copytree(tmp_path / "src", tmp_path / "ref")
    mine = durability.newest_verified_step(str(tmp_path / "mine"), quarantine=quarantine)
    ref = jax_durability.newest_verified_step(str(tmp_path / "ref"), quarantine=quarantine)
    assert mine[0] == ref[0] == 4
    strip = lambda events, d: [  # noqa: E731
        {k: str(v).replace(str(tmp_path / d), "<dir>") for k, v in e.items()} for e in events
    ]
    assert strip(mine[1], "mine") == strip(ref[1], "ref")
    assert [e["cause"] for e in mine[1]] == ["corrupt", "uncommitted"]
    assert sorted(os.listdir(tmp_path / "mine")) == sorted(os.listdir(tmp_path / "ref"))
    assert ("8.corrupt" in os.listdir(tmp_path / "mine")) == quarantine


def test_steps_listing_ignores_set_aside_and_temporary_directories(tmp_path):
    _commit(tmp_path, "port", 2, 4)
    durability.quarantine_step(str(tmp_path), 4)
    durability.abandon_step(str(tmp_path), 2)
    (tmp_path / "6.nexus-tmp-123").mkdir()
    (tmp_path / "notes").mkdir()
    assert durability.list_steps(str(tmp_path)) == []
    assert sorted(os.listdir(tmp_path)) == ["2.abandoned", "4.corrupt", "6.nexus-tmp-123", "notes"]
    # a second incident on the same step number keeps both sets of bytes
    _commit(tmp_path, "port", 4)
    assert durability.quarantine_step(str(tmp_path), 4).endswith("4.corrupt-1")


def test_sidecars_roundtrip_and_classify(tmp_path):
    step_dir = str(tmp_path)
    durability.write_json_sidecar(step_dir, "_X.json", {"position": 7, "skips": [[1, 3]]})
    assert durability.read_json_sidecar(step_dir, "_X.json") == {"position": 7, "skips": [[1, 3]]}
    assert durability.read_json_sidecar(step_dir, "_absent.json") is None
    (tmp_path / "_bad.json").write_text("[1, 2]")
    with pytest.raises(durability.CheckpointCorrupt, match="unreadable sidecar"):
        durability.read_json_sidecar(step_dir, "_bad.json")


def test_verified_step_poller_rescans_only_on_change(tmp_path, monkeypatch):
    _commit(tmp_path, "port", 2)
    poller = durability.VerifiedStepPoller(str(tmp_path))
    assert poller.latest_verified_step() == 2 and poller.scans == 1
    hashed = []
    real = durability._sha256_file
    monkeypatch.setattr(durability, "_sha256_file", lambda p, chunk=1 << 20: hashed.append(p) or real(p, chunk))
    assert poller.latest_verified_step() == 2 and poller.scans == 1 and not hashed
    _commit(tmp_path, "port", 4)
    assert poller.latest_verified_step() == 4 and poller.scans == 2


def test_caching_resolver_skips_rehash_and_sees_commits(tmp_path, monkeypatch):
    _commit(tmp_path, "port", 2)
    resolver = durability.CachingUriResolver()
    assert resolver(f"{tmp_path}/2") == f"{tmp_path}/2"
    calls = []
    real = durability.resolve_verified_uri
    resolver._resolve = lambda uri: calls.append(uri) or real(uri)
    assert resolver(f"{tmp_path}/2") == f"{tmp_path}/2" and calls == []
    # a negative verdict is cached until the directory changes
    os.remove(tmp_path / "2" / durability.MANIFEST_NAME)
    assert resolver(f"{tmp_path}/2") is None and len(calls) == 1
    assert resolver(f"{tmp_path}/2") is None and len(calls) == 1
    _commit(tmp_path, "port", 4)
    assert resolver(f"{tmp_path}/2") == f"{tmp_path}/4" and len(calls) == 2


def test_adopt_cli_commits_unmanifested_steps(tmp_path):
    _commit(tmp_path, "port", 2, 4)
    os.remove(tmp_path / "2" / durability.MANIFEST_NAME)
    proc = subprocess.run(
        [sys.executable, "-m", "tpu_nexus_torch.workload.durability", "adopt", str(tmp_path)],
        capture_output=True, text=True, timeout=60, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT)),
    )
    assert proc.returncode == 0, proc.stderr
    assert "adopted 1 step(s): [2]" in proc.stdout
    # the adopted step now verifies under both packages
    assert jax_durability.verify_step(str(tmp_path / "2"), 2)["step"] == 2
    assert durability._main(["nope"]) == 2


def test_durability_copy_imports_only_the_standard_library():
    tree = ast.parse((ROOT / "tpu_nexus_torch" / "workload" / "durability.py").read_text())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom):
            assert node.level == 0, "relative import"
            roots.add(node.module.split(".")[0])
    assert roots <= set(sys.stdlib_module_names), roots - set(sys.stdlib_module_names)
    probe = (
        "import sys\n"
        "import tpu_nexus_torch.workload.durability\n"
        "assert 'torch' not in sys.modules, 'torch leaked'\n"
        "assert 'jax' not in sys.modules, 'jax leaked'\n"
    )
    subprocess.run([sys.executable, "-c", probe], check=True, timeout=60, cwd=ROOT,
                   env=dict(os.environ, PYTHONPATH=str(ROOT)))
