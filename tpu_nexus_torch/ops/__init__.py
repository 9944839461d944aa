"""Kernel layer: hand-written CUDA kernels (``csrc/``) for the ops the JAX
package wrote in Pallas, each beside its plain PyTorch version; plain
tensor code for the rest."""

from tpu_nexus_torch.ops.attention import attention, dense_attention
from tpu_nexus_torch.ops.rmsnorm import rms_norm

__all__ = ["attention", "dense_attention", "rms_norm"]
