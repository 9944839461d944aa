"""Model FLOPs of the window's tokens (6 x matmul params + causal attention,
recompute excluded) over the window, as a share of the bf16 peak."""

from benchmark.roofline import PEAK_BF16_FLOPS, model_flops_per_token


def read(rec):
    w = rec["window"]
    flops = model_flops_per_token(rec["config"], rec["traffic"]["seq_len"]) * w["tokens"]
    return 100.0 * flops / w["window_s"] / PEAK_BF16_FLOPS
