"""The per-layer readers over a hand-made trace: each reads what it claims,
and one with nothing to read returns nothing (never a 0 share)."""

import json

import pytest

from benchmark import roofline
from benchmark.common import HERE, breakdown, load_json, load_reader, read_trace

MANIFEST = load_json(HERE.parent / "BENCHMARK.json")


def _k(name, ts, dur, op="", types=None, dims=None):
    return {"name": name, "cat": "kernel", "ts": ts, "dur": dur, "op": op, "types": types, "dims": dims}


def _train_rec(device, cfg="mistral_7b_pp2"):
    return {"config": load_json(HERE / "configs" / f"{cfg}.json"), "traffic": load_json(HERE / "traffic" / "s8k.json"),
            "trace": {"device": device, "busy_s": 1.5, "gaps": [], "spans": []}, "traced_window_s": 2.0,
            "traced_steps": 2, "window": {"tokens": 16384 * 4, "window_s": 8.0}}


def test_every_listed_metric_has_a_reader():
    for m in MANIFEST["per_layer"]:
        assert callable(load_reader(m["name"]))


def test_training_readers():
    dev = [_k("flash_fwd_bf16_kernel<128>", 0, 1000), _k("flash_bwd_dq_bf16_kernel<128>", 1000, 2000),
           _k("flash_bwd_dkv_bf16_kernel<128>", 3000, 3000),
           _k("sm90_xmma_gemm_f32f32", 6000, 4000, "aten::bmm", ["float", "float"]),
           _k("nvjet_tst", 10000, 10000, "aten::bmm", ["c10::BFloat16", "c10::BFloat16"])]
    rec = _train_rec(dev)
    assert load_reader("f32_gemm_ms.train")(rec) == pytest.approx(4.0 / 2)
    want = (roofline.flash_fwd_flops(2, 8192, 32, 128) + roofline.flash_bwd_flops(2, 8192, 32, 128)) / 989e12
    assert load_reader("flash_roofline.train")(rec) == pytest.approx(100 * want / 6e-3)
    assert load_reader("device_idle.train")(rec) == pytest.approx(25.0)
    mfu = roofline.model_flops_per_token(rec["config"], 8192) * 16384 * 4 / 8.0 / 989e12
    assert load_reader("mfu.train")(rec) == pytest.approx(100 * mfu)


def test_readers_with_nothing_to_read_return_nothing():
    rec = _train_rec([])
    for name in ("f32_gemm_ms.train", "flash_roofline.train", "device_idle.train"):
        assert load_reader(name)(rec) is None


def test_read_trace_and_breakdown(tmp_path):
    events = [
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0, "dur": 5, "args": {"External id": 7,
                                                                                  "Input type": ["float"]}},
        {"ph": "X", "cat": "user_annotation", "name": "bench.step", "ts": 0, "dur": 100},
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 10, "dur": 20, "args": {"External id": 7}},
        {"ph": "X", "cat": "kernel", "name": "k2", "ts": 20, "dur": 20, "args": {}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "copy", "ts": 70, "dur": 10, "args": {}},
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    t = read_trace(str(path))
    assert t["busy_s"] == pytest.approx(40e-6) and t["gaps"] == [(40, 70)]
    assert t["device"][0]["op"] == "aten::mm" and t["device"][0]["types"] == ["float"]
    b = breakdown(t)
    assert b["idle_gaps"] == [["bench.step", pytest.approx(30e-6)]]
    assert b["device_ops"][0][0] in ("k1", "k2")
