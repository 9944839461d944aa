"""The port's import rule, checked on the code.

* No module of ``tpu_nexus_torch/``, and not ``chip_smoke.py``, imports
  ``jax`` or ``tpu_nexus`` — at the top or inside a function.
* The workload and serving path loads neither ``yaml`` nor ``aiohttp``: both
  are installed but outside the torch/numpy/stdlib rule, so the control
  plane imports them where it uses them (``core/config.py`` when it parses
  a file, ``k8s/rest.py`` when it reads a kubeconfig or opens a session).
  The taxonomy, which the serving engine reads, imports the informers and
  the resolvers; a fresh interpreter shows that neither pulls them in.
"""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "tpu_nexus_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module.split(".")[0]


def test_the_walk_sees_the_control_plane():
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    for module in ("core/config.py", "k8s/rest.py", "supervisor/service.py", "launcher/jobset.py",
                   "app/dependencies.py", "main.py", "workload/__main__.py", "parallel/ring.py",
                   "parallel/ulysses.py", "workload/rehearsal.py"):
        assert f"tpu_nexus_torch/{module}" in names


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_module_imports_jax_or_the_reference(path):
    bad = [(line, root) for line, root in _imported_roots(path) if root in ("jax", "jaxlib", "tpu_nexus")]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


_PROBE = """
import json, sys
for name in sys.argv[1:]:
    __import__(name)
print(json.dumps({m: m in sys.modules for m in ("yaml", "aiohttp", "jax", "tpu_nexus")}))
"""


@pytest.mark.parametrize(
    "modules",
    [
        ["tpu_nexus_torch.workload.harness"],
        ["tpu_nexus_torch.workload.serve"],
        ["tpu_nexus_torch.supervisor.taxonomy"],
        ["tpu_nexus_torch.workload.__main__", "tpu_nexus_torch.serving.recovery", "tpu_nexus_torch.serving.handoff"],
    ],
    ids=["harness", "serve", "taxonomy", "entry-and-serving"],
)
def test_workload_path_loads_neither_yaml_nor_aiohttp(modules):
    proc = subprocess.run([sys.executable, "-c", _PROBE, *modules], cwd=ROOT, capture_output=True, text=True,
                          timeout=240, env={"PYTHONPATH": str(ROOT), "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stderr[-2000:]
    loaded = json.loads(proc.stdout.strip().splitlines()[-1])
    assert loaded == {"yaml": False, "aiohttp": False, "jax": False, "tpu_nexus": False}, modules


def test_the_entry_points_store_reads_no_yaml_without_a_file(tmp_path):
    """With no ``appconfig.yaml`` on the search path, the workload entry
    point builds its ledger store from env alone and never imports the
    parser."""
    probe = (
        "import sys\n"
        "from tpu_nexus_torch.workload.__main__ import store_from_env\n"
        "store = store_from_env({'NEXUS__CQL_STORE_TYPE': 'memory'})\n"
        "print(type(store).__name__, 'yaml' in sys.modules)\n"
    )
    proc = subprocess.run([sys.executable, "-c", probe], cwd=tmp_path, capture_output=True, text=True,
                          timeout=240, env={"PYTHONPATH": str(ROOT), "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.split() == ["InMemoryCheckpointStore", "False"]
