"""The frozen FLOP and byte formulas against hand counts at the cells'
shapes, and against PyTorch's own count of the reference's products."""

import json
import os

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench.core import flops, inputs, manifest
from perfbench.reference import ft_transformer as ref


def _cfg(name):
    with open(os.path.join(manifest.HERE, "configs", f"{name}.json")) as f:
        return json.load(f)


# per row: blocks x [2*S*(3D^2 + D^2 + 2*R*D^2) + 4*S^2*D] + 2*D
HAND = {"ft-rtdl-b2-d128": 2 * (2 * 29 * (3 + 1 + 4) * 128 ** 2
                                + 4 * 29 ** 2 * 128) + 2 * 128,
        "ft-rtdl-b3-d192": 3 * (2 * 29 * (3 + 1 + 4) * 192 ** 2
                                + 4 * 29 ** 2 * 192) + 2 * 192}


@pytest.mark.parametrize("name", sorted(HAND))
def test_forward_flops_hand_count(name):
    assert flops.ft_forward_flops(_cfg(name)) == HAND[name]
    assert flops.ft_train_flops(_cfg(name)) == 3 * HAND[name]


def test_hand_counts_match_the_issue_figures():
    # 48.2 MFLOP a trained row, 53.25 MFLOP a scored row
    assert round(3 * HAND["ft-rtdl-b2-d128"] / 1e6, 1) == 48.2
    assert round(HAND["ft-rtdl-b3-d192"] / 1e6, 2) == 53.25


@pytest.mark.parametrize("name", sorted(HAND))
def test_forward_flops_match_torch_count_of_the_reference(name):
    cfg = _cfg(name)
    p = inputs.ft_weights(cfg, 3, "cpu")
    x = inputs.numeric_rows(4, cfg["n_num_features"], 3, "cpu")
    with FlopCounterMode(display=False) as counter:
        ref.logits(p, x, cfg)
    assert counter.get_total_flops() == 4 * flops.ft_forward_flops(cfg)


def test_ft_block_cost_and_bound_at_the_training_shape():
    b, s, d, h, r = 8192, 29, 128, 8, 2
    products, rest = flops.ft_block_ops(b, s, d, h, r)
    m = b * s
    assert products == 2 * m * 8 * d * d
    assert rest == (4 * b * h * s * s * (d // h) + 16 * m * d
                    + 10 * m * r * d + 4 * b * h * s * s + 2 * m * d)
    n_params = 4 * d + 3 * d * d + 3 * d + d * d + d + 2 * r * d * d \
        + r * d + d
    assert flops.ft_block_params(d, r) == n_params
    assert flops.ft_block_cost(b, s, d, h, r) == (
        products + rest, float(2 * m * d * 4 + 4 * n_params))
    # bound by the products in 3 bf16 passes: 62.3 GFLOP x 3 / 989 TFLOP/s
    bound = flops.ft_block_bound_s(b, s, d, h, r)
    assert bound == pytest.approx(3 * products / 989e12)
    assert bound == pytest.approx(0.189e-3, rel=0.01)


def test_weights_cover_every_parameter_of_the_port():
    from perfbench.drivers.train import job_config
    from shifu_tpu_torch.models.registry import build_model
    for name in HAND:
        cfg = _cfg(name)
        job = job_config(cfg, {"batch_rows": 8}, 0)
        model = build_model(job.model, job.schema, "cpu")
        want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
        got = {k: tuple(v.shape) for k, v in
               inputs.ft_weights(cfg, 1, "cpu").items()}
        assert got == want
        assert sum(torch.Size(s).numel() for s in got.values()) == sum(
            p.numel() for p in model.parameters())
