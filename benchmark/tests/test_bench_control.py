"""The control: the reference computed in float8 in the program's
place.  On the CPU at a tiny size it reads well above the program; on the
card, at the cell's own size, it fails the cell's limits (``gpu``)."""

import subprocess
import sys

import pytest
import torch

from benchmark.common import CHECKOUT, HERE
from benchmark.reference import model as ref
from benchmark.tests.tiny import tiny_ctx


def test_fp8_rounds_to_float8_under_a_per_tensor_scale():
    x = torch.linspace(-3, 3, 1001)
    scale = 3 / 448
    q = ref._fp8(x)
    assert torch.allclose((q / scale).to(torch.float8_e4m3fn).float(), q / scale, rtol=1e-6, atol=0)
    assert ((q - x).abs() <= x.abs() / 16 + scale / 2**6).all()
    assert len(torch.unique(q)) < 300
    g = torch.linspace(-1, 1, 101, requires_grad=True)
    y = ref._GradFp8.apply(g * 1.0)
    y.backward(torch.linspace(-5, 5, 101))
    assert len(torch.unique(g.grad)) < 101 and ((g.grad - torch.linspace(-5, 5, 101)).abs() <= 5 / 4).all()


def test_training_control_reads_above_the_program():
    from benchmark.drive_train import control

    ctx = tiny_ctx("train.mistral_7b.s8k")
    out = control(ctx, 99, "cpu")
    for k in ("loss2_gap", "grad_gap", "grad_gap_median"):
        assert out["control"][k] > 3 * out["program"][k], k


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at the cell's own size")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", sorted(p.stem for p in (HERE / "limits").glob("*.json")))
def test_control_fails_the_cells_limits_on_the_card(card, cell):
    """On four seeds the sound program passes every limit and the control
    fails one."""
    import json

    seeds = "1234567891,1234567892,1234567893,1234567894"
    out = subprocess.run([sys.executable, "benchmark/control.py", "--workload", cell, "--seeds", seeds],
                         cwd=CHECKOUT, capture_output=True, text=True, timeout=1800)
    lines = [json.loads(x) for x in out.stdout.splitlines() if x.startswith("{")]
    assert len(lines) == 4, out.stderr[-2000:]
    assert all(x["program_passes"] for x in lines), lines
    assert all(x["control_fails"] for x in lines), lines
