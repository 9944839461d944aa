"""Kernels #1-#3 against their roofline: the causal products their
launches need (two a forward, five a backward) at the bf16 peak, over the
device time of those kernels."""

from benchmark.kernels import device_ms, kernels
from benchmark.roofline import PEAK_BF16_FLOPS, dims, flash_bwd_flops, flash_fwd_flops


def read(rec):
    trace, mix, g = rec["trace"], rec["traffic"], dims(rec["config"])
    fwd = kernels(trace, "flash_fwd")
    dq = kernels(trace, "flash_bwd_dq")
    dkv = kernels(trace, "flash_bwd_dkv")
    if not fwd and not dq:
        return None
    shape = (mix["batch"], mix["seq_len"], g["hq"], g["d"])
    flops = len(fwd) * flash_fwd_flops(*shape) + len(dq) * flash_bwd_flops(*shape)
    return 100.0 * flops / PEAK_BF16_FLOPS / (device_ms(fwd + dq + dkv) / 1e3)
