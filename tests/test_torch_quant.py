"""The port's weight quantization against the JAX package, bit for bit.

The same numpy weights (seeded) go through ``tpu_nexus.models.quant`` and
``tpu_nexus_torch.models.quant``: int8 values, packed nibbles and f32
scales must be IDENTICAL (no tolerance), for single tensors (int4 at
groups 2, 4 and 64) and for whole parameter trees; the nibble packing
round-trips; per-layer slicing keeps the aux fields; ``quantize_params``
is idempotent; ``quantized_bytes`` equals the reference's; a quantized
tree crosses ``models/convert.py`` bit for bit in both directions and
refuses training.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_nexus.models import llama as jax_llama
from tpu_nexus.models import quant as jq
from tpu_nexus_torch.models import quant as pq
from tpu_nexus_torch.models.convert import params_from_numpy, params_to_numpy
from tpu_nexus_torch.workload.train import param_leaves
from test_torch_llama import carried, tiny_configs

torch.set_num_threads(1)


def _weights(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def numpy_tree(jparams):
    """A JAX params tree (quantized or not) as the nested dicts of numpy
    arrays ``params_from_numpy`` takes: a ``QTensor`` leaf becomes
    ``{"q", "s"}``, a ``QTensor4`` leaf that plus its three aux fields."""

    def leaf(w):
        if isinstance(w, jq.QTensor4):
            return {"q": np.asarray(w.q), "s": np.asarray(w.s), "contract_shape": w.contract_shape,
                    "out_shape": w.out_shape, "group": w.group}
        if isinstance(w, jq.QTensor):
            return {"q": np.asarray(w.q), "s": np.asarray(w.s)}
        return np.asarray(w)

    tree = {k: leaf(v) for k, v in jparams.items() if k not in ("embed", "layers")}
    tree["embed"] = {k: np.asarray(v) for k, v in jparams["embed"].items()}
    tree["layers"] = {k: leaf(v) for k, v in jparams["layers"].items()}
    return tree


def _same(port_leaf, jax_leaf):
    np.testing.assert_array_equal(port_leaf.q.numpy(), np.asarray(jax_leaf.q))
    np.testing.assert_array_equal(port_leaf.s.numpy(), np.asarray(jax_leaf.s))
    assert port_leaf.q.dtype == torch.int8 and port_leaf.s.dtype == torch.float32
    assert tuple(port_leaf.shape) == tuple(jax_leaf.shape)


@pytest.mark.parametrize(
    "shape,axes", [((3, 64, 4, 16), (-3,)), ((2, 4, 16, 64), (-3, -2)), ((64, 128), (-2,)), ((2, 5, 16), (-1,))]
)
def test_quantize_tensor_is_bit_identical(shape, axes):
    w = _weights(shape, seed=len(shape) + shape[-1])
    _same(pq.quantize_tensor(torch.from_numpy(w), axes), jq.quantize_tensor(jnp.asarray(w), axes))


def test_quantize_tensor_of_bf16_and_zero_weights_is_bit_identical():
    w = jnp.asarray(_weights((2, 32, 48), seed=3)).astype(jnp.bfloat16)
    tw = torch.from_numpy(np.array(w).view(np.int16)).view(torch.bfloat16)
    _same(pq.quantize_tensor(tw, (-2,)), jq.quantize_tensor(w, (-2,)))
    zeros = np.zeros((8, 4), np.float32)  # the scale floor, not a division by zero
    _same(pq.quantize_tensor(torch.from_numpy(zeros), (-2,)), jq.quantize_tensor(jnp.asarray(zeros), (-2,)))


@pytest.mark.parametrize("group", [2, 4, 64])
@pytest.mark.parametrize("shape,axes", [((3, 64, 4, 16), (-3,)), ((2, 4, 16, 64), (-3, -2)), ((128, 24), (-2,))])
def test_quantize_tensor_int4_is_bit_identical(shape, axes, group):
    w = _weights(shape, seed=group, scale=0.3)
    port = pq.quantize_tensor_int4(torch.from_numpy(w), axes, group, name="w")
    ref = jq.quantize_tensor_int4(jnp.asarray(w), axes, group, name="w")
    _same(port, ref)
    assert (port.contract_shape, port.out_shape, port.group) == (ref.contract_shape, ref.out_shape, ref.group)
    np.testing.assert_array_equal(port.to(torch.float32).numpy(), np.asarray(ref.astype(jnp.float32)))


@pytest.mark.parametrize("group", [2, 4, 8, 64])
def test_nibble_packing_round_trips_and_matches_the_reference(group):
    q4 = np.random.default_rng(group).integers(-7, 8, size=(2, 128, 16)).astype(np.int8)
    packed = pq._pack_nibbles(torch.from_numpy(q4), group)
    assert packed.shape == (2, 64, 16) and packed.dtype == torch.int8
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jq._pack_nibbles(jnp.asarray(q4), group)))
    np.testing.assert_array_equal(pq._unpack_nibbles(packed, group).numpy(), q4)


def test_half_split_puts_rows_i_and_i_plus_half_group_in_one_byte():
    group = 8
    q4 = torch.from_numpy((np.arange(-7, 9).reshape(16, 1) % 8 - 4).astype(np.int8))
    packed = pq._pack_nibbles(q4, group)
    lo = torch.bitwise_right_shift(torch.bitwise_left_shift(packed, 4), 4)
    hi = torch.bitwise_right_shift(packed, 4)
    for g in range(2):
        for i in range(group // 2):
            assert int(lo[g * 4 + i, 0]) == int(q4[g * group + i, 0])
            assert int(hi[g * 4 + i, 0]) == int(q4[g * group + i + group // 2, 0])


def test_per_layer_slicing_keeps_the_aux_fields():
    w = torch.from_numpy(_weights((3, 64, 32), seed=1))
    qt = pq.quantize_tensor_int4(w, (-2,), 16, name="w")
    layer = qt[1]
    assert isinstance(layer, pq.QTensor4)
    assert layer.shape == (64, 32) and layer.group == 16
    assert (layer.contract_shape, layer.out_shape) == (qt.contract_shape, qt.out_shape)
    assert torch.equal(layer.to(torch.float32), qt.to(torch.float32)[1])
    q8 = pq.quantize_tensor(w, (-2,))
    assert isinstance(q8[2], pq.QTensor) and q8[2].shape == (64, 32) and q8[2].s.shape == (1, 32)
    assert torch.equal(q8[2].to(torch.float32), q8.to(torch.float32)[2])


def test_group_errors_name_the_weight():
    w = torch.from_numpy(_weights((96, 16), seed=0))
    with pytest.raises(ValueError, match="even"):
        pq.quantize_tensor_int4(w, (-2,), 3, name="wq")
    with pytest.raises(ValueError, match="wq.*NEXUS_QUANT_GROUP"):
        pq.quantize_tensor_int4(w, (-2,), 64, name="wq")
    # the reference raises the same two errors
    with pytest.raises(ValueError, match="even"):
        jq.quantize_tensor_int4(jnp.asarray(w.numpy()), (-2,), 3, name="wq")
    with pytest.raises(ValueError, match="wq.*NEXUS_QUANT_GROUP"):
        jq.quantize_tensor_int4(jnp.asarray(w.numpy()), (-2,), 64, name="wq")


@pytest.mark.parametrize("mode,group", [("int8", 0), ("int4", 0), ("int4", 16), ("int4", 2)])
def test_quantize_params_is_bit_identical_and_idempotent(mode, group):
    jcfg, pcfg = tiny_configs()
    jparams, pparams = carried(jcfg, pcfg, seed=2)
    jqp = jq.quantize_params(jparams, mode=mode, group=group)
    pqp = pq.quantize_params(pparams, mode=mode, group=group)
    assert isinstance(pqp, pq.QuantizedParams)
    assert pqp.keys() == pparams.keys() and ("lm_head" in pqp) == ("lm_head" in pparams)
    for name, ref in jqp["layers"].items():
        got = pqp["layers"][name]
        if name.endswith("norm"):
            assert isinstance(got, torch.Tensor)
            np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        else:
            assert type(got).__name__ == type(ref).__name__
            _same(got, ref)
    assert isinstance(pqp["embed"]["tokens"], torch.Tensor) and not pqp["embed"]["tokens"].requires_grad
    again = pq.quantize_params(pqp, mode=mode, group=group)
    assert all(again["layers"][k] is pqp["layers"][k] for k in pq._CONTRACT_AXES)
    assert pq.quantized_bytes(pqp) == jq.quantized_bytes(jqp)


def test_quantized_bytes_counts_stored_widths():
    jcfg, pcfg = tiny_configs()
    jparams, pparams = carried(jcfg, pcfg)
    full = pq.quantized_bytes(pparams)
    assert full == jq.quantized_bytes(jparams)
    b8 = pq.quantized_bytes(pq.quantize_params(pparams, mode="int8"))
    q4 = pq.quantize_params(pparams, mode="int4", group=16)
    assert pq.quantized_bytes(q4) < b8 < full
    k, n = pcfg.hidden, pcfg.n_heads * pcfg.head_dim
    wq4 = q4["layers"]["wq"]
    leaf_bytes = sum(a.numel() * a.element_size() for a in (wq4.q, wq4.s))
    assert leaf_bytes == pcfg.n_layers * (k // 2 * n + k // 16 * n * 4)


def test_quantize_params_validates_the_mode_and_the_group():
    _, pcfg = tiny_configs()
    _, pparams = carried(*tiny_configs())
    with pytest.raises(ValueError, match="unknown quantize mode 'fp4'"):
        pq.quantize_params(pparams, mode="fp4")
    with pytest.raises(ValueError, match="'wq'.*contraction width 64"):
        pq.quantize_params(pparams, mode="int4", group=48)
    assert pq.quantize_params(pparams, mode="int4")["layers"]["wq"].group == pq.DEFAULT_INT4_GROUP == 64


def test_a_quantized_tree_is_frozen_and_refuses_training():
    _, pparams = carried(*tiny_configs())
    qp = pq.quantize_params(pparams, mode="int8")
    assert not any(leaf.requires_grad for leaf in pq.tree_leaves(qp))
    with pytest.raises(TypeError, match="frozen"):
        qp.named_parameters()
    with pytest.raises(TypeError, match="frozen"):
        param_leaves(qp)  # what the train state and the train step enumerate
    with pytest.raises(TypeError):
        qp["layers"] = {}


@pytest.mark.parametrize("mode,group", [("int8", 0), ("int4", 16)])
def test_a_quantized_tree_crosses_the_converter_bit_for_bit(mode, group):
    jcfg, pcfg = tiny_configs()
    jparams = jax_llama.llama_init(jax.random.PRNGKey(5), jcfg)
    jqp = jq.quantize_params(jparams, mode=mode, group=group)
    tree = numpy_tree(jqp)
    pqp = params_from_numpy(tree, pcfg, device="cpu")
    assert isinstance(pqp, pq.QuantizedParams)
    for name in pq._CONTRACT_AXES:
        _same(pqp["layers"][name], jqp["layers"][name])
    back = params_to_numpy(pqp)
    for name, leaf in tree["layers"].items():
        if isinstance(leaf, dict):
            assert set(back["layers"][name]) == set(leaf)
            for key, val in leaf.items():
                np.testing.assert_array_equal(np.asarray(back["layers"][name][key]), np.asarray(val))
        else:
            np.testing.assert_array_equal(back["layers"][name], leaf)
    wrong = dict(tree, layers=dict(tree["layers"], wq=tree["layers"]["wk"]))
    with pytest.raises(ValueError, match="layers/wq"):
        params_from_numpy(wrong, pcfg, device="cpu")
