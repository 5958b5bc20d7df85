"""The frozen plain reference agrees with the port's plain CPU path at a
tiny size, both in float32: the loss and every leaf's gradient. The
port's CPU path is its plain attention (RoPE then softmax attention) and
its dense one-hot MoE dispatch; the reference is written apart from it."""

import dataclasses

import pytest
import torch

from portbench import spec, traffic, weights
from portbench.reference import moe_lm, transformer_lm
from portbench.tests import tiny


def _grads(loss, flat):
    (g,) = torch.autograd.grad(loss, flat)
    return g


@pytest.mark.parametrize("name", ["flagship.s1k_uniform", "moe_lm.s1k_uniform"])
def test_reference_matches_port_cpu_path(name):
    cell = tiny.cell(name)
    cfg, tr = cell.config, cell.traffic
    reference = spec.reference_module(cell)
    model_mod = spec.model_module(cell)
    leaves = reference.leaves(cfg)
    tokens = traffic.batches(tr, cfg["vocab"], 11, "cpu")[0]

    flat, _ = weights.make(leaves, 5, "cpu")
    flat.requires_grad_(True)
    ref_loss = reference.loss(cfg, weights.tree_of(flat, leaves), tokens)
    ref_grad = _grads(ref_loss, flat)

    from tpu_dra_torch.workloads import model as port
    from tpu_dra_torch.workloads import moe_model

    pflat, tree = weights.make(leaves, 5, "cpu")
    pcfg = dataclasses.replace(model_mod.model_config(cfg, tr["seq"]),
                               dtype=torch.float32)
    if cell.family == "moe_lm":
        model = moe_model.MoETransformerLM(pcfg, tree)
        loss = moe_model.loss_fn(model, tokens)
    else:
        model = port.TransformerLM(pcfg, tree)
        loss = port.loss_fn(model, tokens)
    params = list(model.parameters())
    grads = torch.autograd.grad(loss, params)
    assert float(loss.detach()) == pytest.approx(float(ref_loss.detach()), rel=2e-6)
    by_storage = {p.data_ptr(): g for p, g in zip(params, grads)}
    for (path, shape, _), sl in zip(leaves, weights.slices(leaves)):
        view = weights.get(tree, path)
        want = ref_grad[sl].view(shape)
        got = by_storage[view.data_ptr()]
        scale = float(want.abs().max()) + 1e-12
        assert float((got - want).abs().max()) / scale < 2e-4, path


def test_moe_reference_routes_and_drops_in_order():
    cfg = {"n_experts": 2, "capacity_factor": 1.0}
    x = torch.tensor([[[1.0, 0.0], [2.0, 0.0], [0.0, 1.0], [3.0, 0.0]]])
    p = {"router": torch.eye(2) * 10,
         "w_up": torch.ones(2, 2, 3), "w_down": torch.ones(2, 3, 2)}
    out, aux = moe_lm.moe_ffn(cfg, p, x, torch.matmul)
    # capacity = int(1.0 * 4 / 2) = 2: tokens 0 and 1 fill expert 0,
    # token 3 (also expert 0) is dropped, token 2 goes to expert 1.
    assert moe_lm.capacity(cfg, 4) == 2
    assert float(out[0, 3].abs().sum()) == 0.0
    assert all(float(out[0, i].abs().sum()) > 0 for i in (0, 1, 2))
    assert float(aux) > 0


def test_rope_is_a_rotation_of_half_split_pairs():
    x = torch.randn(1, 5, 2, 8)
    y = transformer_lm.rope(x)
    assert torch.allclose(y.norm(dim=-1), x.norm(dim=-1), atol=1e-5)
    assert torch.equal(y[:, 0], x[:, 0])
