"""Tiny cells for the CPU tests: the real cells' configuration files and
mixes with every size cut, run by the same harness on the CPU (the port's
kernels take their plain versions there)."""

from __future__ import annotations

import copy
from typing import Dict

from benchmark.common import HERE, load_json

TINY_WIDTHS = {"hidden_size": 64, "intermediate_size": 96, "num_attention_heads": 4, "num_key_value_heads": 2,
               "head_dim": 16, "vocab_size": 256, "num_hidden_layers": 2}


#: Mixtral-8x7B-v0.1's published MoE keys over the dense configuration's
#: (no benchmark cell runs the MoE family yet; its reference is held to
#: the port here)
MIXTRAL = {"family": "moe", "num_local_experts": 8, "num_experts_per_tok": 2, "router_aux_loss_coef": 0.02,
           "vocab_size": 32000}


def tiny_config(name: str) -> Dict:
    """A configuration file cut to tiny sizes; ``<file>+moe`` adds
    Mixtral's MoE keys (dropless, gmm dispatch, no router z-loss)."""
    base, _, family = name.partition("+")
    cfg = copy.deepcopy(load_json(HERE / "configs" / f"{base}.json"))
    if family == "moe":
        cfg.update(MIXTRAL)
        cfg["run"].update(dispatch="gmm", router_z_coef=0.0)
    cfg.update(TINY_WIDTHS)
    if cfg["family"] == "moe":
        cfg["num_local_experts"] = 4
    cfg["run"]["max_seq_len"] = 512
    cfg["run"]["param_dtype"] = "float32" if "train" in cfg else cfg["run"]["param_dtype"]
    return cfg


def tiny_traffic(mix: str) -> Dict:
    t = copy.deepcopy(load_json(HERE / "traffic" / f"{mix}.json"))
    t.update(batch=2, seq_len=64, profile_steps=1)
    t["documents"].update(median=16, min=4, max=64)
    return t


def tiny_ctx(cell: str, limits: Dict = None) -> Dict:
    """A context as ``common.find_cell`` builds it, for ``cell``'s
    configuration and mix at tiny sizes."""
    manifest = load_json(HERE.parent / "BENCHMARK.json")
    w = {x["name"]: x for x in manifest["workloads"]}[cell]
    config = next(c for c in manifest["configs"] if c["name"] == w["config"])["file"].split("/")[-1][:-5]
    e2e = [m for m in manifest["end_to_end"] if cell in m.get("workloads", [cell])]
    layer = [m for m in manifest["per_layer"] if cell in m.get("workloads", [cell])]
    default = {"ref_steps": 2, "loss1_gap": 1e-3, "grad_gap_median": 1e-3, "change_gap": 1e-3}
    return {"cell": w, "config": tiny_config(config), "traffic": tiny_traffic(w["traffic"]),
            "limits": limits or default, "end_to_end": e2e, "per_layer": layer}
