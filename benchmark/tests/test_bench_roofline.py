"""The operation counts of the cells' shapes against values worked out by
hand (the arithmetic is in each test's comment)."""

from benchmark import roofline
from benchmark.common import HERE, load_json


def _cfg(name):
    return load_json(HERE / "configs" / f"{name}.json")


def test_mistral_stage_flops_per_token():
    # a layer: attention 2*4096*32*128 + 2*4096*8*128 = 41,943,040; MLP 3*4096*14336 = 176,160,768
    # 16 layers + head 4096*32768: 3,623,878,656 params; attention 2*8192*32*128*16 = 1,073,741,824
    assert roofline.matmul_params(_cfg("mistral_7b_pp2")) == 3_623_878_656
    assert roofline.model_flops_per_token(_cfg("mistral_7b_pp2"), 8192) == 3 * (2 * 3_623_878_656 + 1_073_741_824)


def test_mixtral_stage_flops_per_token():
    # Mixtral-8x7B's published widths, 4 layers: a layer's attention 41,943,040; top-2 experts
    # 2*3*4096*14336 + router 4096*8 = 352,354,304; + head 4096*32000: 1,708,261,376;
    # attention 2*8192*32*128*4 = 268,435,456
    cfg = dict(_cfg("mistral_7b_pp2"), num_hidden_layers=4, vocab_size=32000, num_local_experts=8,
               num_experts_per_tok=2)
    assert roofline.matmul_params(cfg) == 1_708_261_376
    assert roofline.model_flops_per_token(cfg, 8192) == 3 * (2 * 1_708_261_376 + 268_435_456)


def test_flash_launch_flops():
    # one product over B2 S8192 Hq32 D128: 2*2*32*8192^2*128 = 1,099,511,627,776, halved by causality
    full = 2 * 2 * 32 * 8192**2 * 128
    assert full == 1_099_511_627_776
    assert roofline.flash_fwd_flops(2, 8192, 32, 128) == 2 * full / 2
    assert roofline.flash_bwd_flops(2, 8192, 32, 128) == 5 * full / 2
