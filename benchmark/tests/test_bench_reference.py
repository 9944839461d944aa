"""The plain reference agrees with the port at a tiny size on the CPU, in
float32: prefill then paged decode logits through the port's paged
executor, and one train step's loss and gradients, for both families."""

import copy

import numpy as np
import pytest
import torch

from benchmark.common import port_config
from benchmark.reference import model as ref
from benchmark.tests.tiny import tiny_config
from benchmark.weights import leaves, make_tree, param_name

F32 = {"dtype": "float32", "param_dtype": "float32"}


def _f32(name):
    cfg = tiny_config(name)
    cfg["run"].update(F32)
    return cfg


FAMILIES = ["mistral_7b_pp2", "mistral_7b_pp2+moe"]


@pytest.mark.parametrize("name", FAMILIES)
def test_prefill_then_paged_decode_logits(name):
    from tpu_nexus_torch.models.llama import LlamaParams
    from tpu_nexus_torch.serving.engine import PagedModelExecutor

    cfg = _f32(name)
    cfg["run"]["dispatch"] = "scatter"  # the port's dropless decode
    tree = make_tree(cfg, 12345, "cpu", torch.float32)
    ex = PagedModelExecutor(LlamaParams(copy.deepcopy(tree)), port_config(cfg), num_slots=2, max_len=32,
                            page_size=4, num_blocks=20)
    seen = []
    ex._sample = lambda logits: (seen.append(logits.detach().clone()), logits.argmax(-1))[1]
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, cfg["vocab_size"], 11).astype(np.int32)
    table = np.zeros((2, 8), np.int32)
    table[0, :4] = [3, 7, 1, 9]
    first = ex.begin(0, prompt, table_row=table[0])
    tokens, out = np.zeros(2, np.int32), [first]
    cursors = np.zeros(2, np.int32)
    for i in range(4):
        tokens[0], cursors[0] = out[-1], len(prompt) + i
        out.append(int(ex.step(tokens, cursors, table)[0]))
    want = ref.logits(tree, torch.as_tensor(np.concatenate([prompt, out[:-1]])).long(), cfg)
    got = torch.stack([seen[0][0]] + [s[0] for s in seen[1:]])
    assert torch.allclose(got, want[len(prompt) - 1:], atol=2e-4, rtol=1e-4)


@pytest.mark.parametrize("name", FAMILIES)
def test_train_loss_and_gradients(name):
    from tpu_nexus_torch.models.llama import LlamaParams
    from tpu_nexus_torch.models.registry import adapter_for
    from tpu_nexus_torch.workload.train import TrainConfig, param_leaves

    cfg = _f32(name)
    tree = make_tree(cfg, 777, "cpu", torch.float32)
    params = LlamaParams(copy.deepcopy(tree))
    tcfg = TrainConfig(z_loss=cfg["train"]["z_loss"], ce_chunk=16)
    loss_fn = adapter_for(port_config(cfg)).make_loss(tcfg)
    tokens = torch.as_tensor(np.random.default_rng(1).integers(0, cfg["vocab_size"], (2, 32))).long()
    loss, _ = loss_fn(params, tokens)
    named = param_leaves(params)
    grads = dict(zip([n for n, _ in named], torch.autograd.grad(loss, [p for _, p in named])))

    leaf = {p: tree_leaf(tree, p).clone().requires_grad_() for p, _, _ in leaves(cfg)}
    rtree = {"embed": {"tokens": leaf["embed/tokens"]}, "out_norm": leaf["out_norm"]}
    h, lb, rz = ref.hidden(rtree, tokens, cfg, grad=True,
                           layer_weights=lambda li: {p.split("/")[1]: t[li] for p, t in leaf.items()
                                                     if p.startswith("layers/")})
    rloss, _ = ref.next_token_loss(h, leaf["lm_head"], tokens, tcfg.z_loss, "f32", grad=True)
    if cfg["family"] == "moe":
        rloss = rloss + cfg["router_aux_loss_coef"] * lb + cfg["run"]["router_z_coef"] * rz
    rgrads = torch.autograd.grad(rloss, list(leaf.values()))
    assert abs(float(loss.detach()) - float(rloss.detach())) < 1e-5
    for (path, _), g in zip(leaf.items(), rgrads):
        mine = grads[param_name(path)]
        assert torch.allclose(mine, g, atol=1e-5 * float(g.abs().max()) + 1e-7), path


def tree_leaf(tree, path):
    head, _, tail = path.partition("/")
    return tree[head][tail] if tail else tree[head]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_reference_step_stores_the_configured_dtype(dtype):
    from benchmark import traffic
    from benchmark.reference.train import reference_steps

    cfg = tiny_config("mistral_7b_pp2")
    cfg["run"]["param_dtype"] = dtype
    mix = {"batch": 2, "seq_len": 32, "documents": {"median": 8, "sigma": 1.0, "min": 2, "max": 32, "eos": 2}}
    batches = traffic.train_batches(mix, cfg["vocab_size"], 5)
    out = reference_steps(cfg, 5, [next(batches), next(batches)], 2, "cpu", look=True)
    # a norm's weights start at 1, where bf16's spacing (2**-8 below, 2**-7
    # above) is over twice the largest update (lr 3e-4 x 1.1): stored in
    # bf16 they never move; in float32 they do
    norms = [out["change"][k] for k in ("out_norm", "layers/attn_norm", "layers/mlp_norm")]
    assert all(c == 0 for c in norms) if dtype == "bfloat16" else all(c > 0 for c in norms)
    assert all(v > 0 for k, v in out["change"].items() if "norm" not in k)
    assert len(out["loss"]) == 2 and out["embed_witness"]["top_token_count"] >= 1
