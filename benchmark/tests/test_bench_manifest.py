"""BENCHMARK.json and the files it names: parse, names and units within
the contract's characters, every name found as a file, every cell
reporting what it must."""

import json
import re

import pytest

from benchmark.common import CHECKOUT, HERE, load_json

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
WIDTHS = re.compile(r"(_size$|_dim$|_rank$|head|expansion|factor|experts_per_tok|latent|state|proj)")

MANIFEST = load_json(CHECKOUT / "BENCHMARK.json")
CELLS = [w["name"] for w in MANIFEST["workloads"]]


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_command():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(MANIFEST["paths"]) <= 16 and all(PATH.match(p) for p in MANIFEST["paths"])
    assert len(MANIFEST["command"]) <= 32 and all(_line(w) for w in MANIFEST["command"])
    assert not any(w.startswith("/") or ".." in w for w in MANIFEST["command"])
    assert isinstance(MANIFEST["run_seconds"], int) and 1 <= MANIFEST["run_seconds"] <= 51
    assert len(json.dumps(MANIFEST)) < 64 * 1024


def test_names_are_unique_and_within_the_characters():
    names = [c["name"] for c in MANIFEST["configs"]] + CELLS
    names += [m["name"] for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]]
    names += [w["traffic"] for w in MANIFEST["workloads"]]
    assert all(NAME.match(n) for n in names), names
    metrics = [m["name"] for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]]
    assert len(set(metrics)) == len(metrics) and len(set(CELLS)) == len(CELLS)
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")


@pytest.mark.parametrize("config", MANIFEST["configs"], ids=lambda c: c["name"])
def test_configuration_file_matches_its_entry(config):
    assert set(config) == {"name", "source", "file", "reduced", "why"}
    assert config["file"].startswith("benchmark/") and _line(config["source"]) and _line(config["why"])
    data = load_json(CHECKOUT / config["file"])
    assert data["source"] == config["source"] and data["reduced"] == config["reduced"]
    assert len(config["reduced"]) <= 16
    for key in config["reduced"]:
        assert NAME.match(key) and not WIDTHS.search(key), key
        assert data["published"][key] != data[key]
    assert any(w["config"] == config["name"] for w in MANIFEST["workloads"])
    assert [c["file"] for c in MANIFEST["configs"]].count(config["file"]) == 1


@pytest.mark.parametrize("cell", MANIFEST["workloads"], ids=lambda w: w["name"])
def test_cell_files_and_metrics(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"} and cell["chips"] in (1, 4)
    assert _line(cell["why"])
    assert (HERE / "traffic" / f"{cell['traffic']}.json").is_file()
    assert (HERE / "limits" / f"{cell['name']}.json").is_file()
    e2e = [m["name"] for m in MANIFEST["end_to_end"] if cell["name"] in m.get("workloads", [cell["name"]])]
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = [m for m in MANIFEST["per_layer"] if cell["name"] in m.get("workloads", [cell["name"]])]
    assert layer and all(m["moves"] in e2e for m in layer)


def test_metric_entries():
    assert any(m["name"] == "setup_s" and m["bound"] == 0.25 for m in MANIFEST["end_to_end"])
    for m in MANIFEST["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        assert all(c in CELLS for c in m.get("workloads", []))
    for m in MANIFEST["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _line(m["layer"]) and all(c in CELLS for c in m.get("workloads", []))
        assert (HERE / "metrics" / f"{m['name']}.py").is_file()
        if m["name"].endswith("_roofline") or "_roofline." in m["name"]:
            assert m["unit"] == "%"


def test_four_chip_cells_are_few():
    four = sum(w["chips"] == 4 for w in MANIFEST["workloads"])
    assert four <= max(1, len(CELLS) // 4)


def _run(cwd, *extra):
    import subprocess
    import sys

    cell = CELLS[0]
    return subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell, "--seed", str(2**31 + 3),
                           "--seconds", "1", "--trace", "0", *extra], cwd=cwd, capture_output=True, text=True,
                          timeout=300)


def test_no_result_without_the_cards_or_the_program(tmp_path):
    import shutil

    import torch

    if torch.cuda.is_available():
        pytest.skip("this test holds the run where no card is")
    out = _run(CHECKOUT)
    assert out.returncode != 0 and not out.stdout.strip()
    shutil.copy(CHECKOUT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(HERE, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0 and not out.stdout.strip()
