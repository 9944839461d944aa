"""Command-line tools of the port that drive the model on the card: the
perplexity gates of quantized serving (:mod:`.int8_gate_1b`,
:mod:`.int4_gate_1b`).  Run them as modules, e.g. ``python -m
tpu_nexus_torch.tools.int8_gate_1b``."""
