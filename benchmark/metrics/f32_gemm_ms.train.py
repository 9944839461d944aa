"""Device ms a step in float32 matrix products: the chunked loss's f32
vocabulary projection (forward, recompute and backward) and an MoE
router's f32 product."""

from benchmark.kernels import device_ms, f32_gemms


def read(rec):
    found = f32_gemms(rec["trace"])
    if not found:
        return None
    return device_ms(found) / rec["traced_steps"]
