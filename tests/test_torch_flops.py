"""The port's FLOP and byte counts (shifu_tpu_torch/obs/flops.py), the
kernels' `cost(...)` formulas and the goodput ledger's MFU, on the CPU.

- A train step of the MLP counts its closed form: 6 x the later layers'
  in x out (forward, dX, dW) + 4 x layer 0's (forward, dW: its input
  takes no gradient), a sample, exactly.
- Each kernel's `cost(...)` gives, at the path shapes, the counts that
  chip_smoke.py's checks computed inline before they read these formulas,
  and `chip_smoke.bound_ms` over them reproduces PERF.md's bound column
  to its 4 decimals (H100: 132 SMs at the 1980 MHz `clocks.max.sm`).
- A call through each kernel wrapper counts its formula, and not the
  plain body's aten ops: the count is the model's and the shapes', not
  the implementation's.
- The goodput MFU under SHIFU_TPU_PEAK_TFLOPS equals the JAX package's
  (`tests/test_introspect.py::test_goodput_mfu_uses_peak_override`).
- The JAX package's CPU `cost_analysis` of the same MLP train step counts
  every op XLA runs (elementwise and the optimizer too), where the port
  counts torch.utils.flop_counter's op set plus the kernels' formulas:
  the port's count is 0.5 to 1 of XLA's here (a deliberate difference,
  ROADMAP.md section C).
"""

import importlib.util
import json
import math
import pathlib

import pytest
import torch

from shifu_tpu_torch import obs
from shifu_tpu_torch.obs import flops, goodput
from shifu_tpu_torch.ops import embedding as emb
from shifu_tpu_torch.ops import flash_attention as fa
from shifu_tpu_torch.ops import ft_block
from shifu_tpu_torch.ops import int8_matmul as i8
from shifu_tpu_torch.ops import small_attention as sa

_ROOT = pathlib.Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               _ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)


@pytest.fixture(autouse=True)
def _clean():
    obs.reset_for_tests()
    yield
    obs.reset_for_tests()


def _mlp_job(batch, hidden=(100, 100, 100), features=30):
    from shifu_tpu_torch.config.schema import (DataConfig, JobConfig,
                                               ModelSpec, OptimizerConfig,
                                               TrainConfig)
    from shifu_tpu_torch.data import synthetic
    return JobConfig(
        schema=synthetic.make_schema(num_features=features),
        data=DataConfig(batch_size=batch, wire_dtype="int8"),
        model=ModelSpec(model_type="mlp", hidden_nodes=hidden,
                        activations=("relu",) * len(hidden),
                        compute_dtype="bfloat16"),
        train=TrainConfig(epochs=1, loss="weighted_mse",
                          optimizer=OptimizerConfig(name="adadelta",
                                                    learning_rate=0.003)),
    ).validate()


def _batch(job, rows=None, seed=1):
    from shifu_tpu_torch.data import pipeline as pipe
    from shifu_tpu_torch.data import reader, synthetic
    from shifu_tpu_torch.train.loop import to_device
    n = rows or job.data.batch_size
    cols = reader.project_columns(synthetic.make_rows(n, job.schema,
                                                      seed=seed), job.schema)
    b = {k: cols[k] for k in ("features", "target", "weight")}
    wcast = pipe.wire_cast_fn(job.schema, job.data, job.model.compute_dtype,
                              compact=True)
    return to_device(wcast(b) if wcast else b, job, torch.device("cpu"))


def _closed_form(batch, widths):
    later = sum(a * b for a, b in zip(widths[1:], widths[2:]))
    return (6 * later + 4 * widths[0] * widths[1]) * batch


@pytest.mark.parametrize("batch,hidden", [(64, (100, 100, 100)),
                                          (16, (8, 4))])
def test_mlp_step_counts_its_closed_form(batch, hidden):
    from shifu_tpu_torch.train.loop import init_state
    from shifu_tpu_torch.train.step import _train_step_fn, make_train_step
    job = _mlp_job(batch, hidden)
    state = init_state(job, 30, "cpu")
    _, got = flops.count(_train_step_fn(job), state, _batch(job))
    assert got["flops"] == _closed_form(batch, (30, *hidden, 1))
    assert got["bytes_accessed"] > 0
    # the instrumented step credits the same count to the ledger on every
    # dispatch, and tallies its dispatches
    step = make_train_step(job)
    led = goodput.begin_epoch()
    for _ in range(3):
        state, _m = step(state, _batch(job))
    assert led._flops == 3 * got["flops"]
    st = flops.stats()["train_step"]
    assert (st["dispatches"], st["counts"], st["flops"]) == (3, 1,
                                                             got["flops"])
    goodput.reset_for_tests()


def test_the_mlp_closed_form_is_the_headline_reckoning():
    # 132,600 FLOPs a trained sample of the headline MLP (PERF.md)
    assert _closed_form(1, (30, 100, 100, 100, 1)) == 132_600


def _sfu(monkeypatch):
    monkeypatch.setitem(chip_smoke.SFU, "sms", 132)
    monkeypatch.setitem(chip_smoke.SFU, "clock_hz", 1980e6)


def _expected_touched(u, nc, v):
    # the deduped batch of u uniform ids in [0, v): its distinct rows
    return round(nc * v * (1 - (1 - 1 / v) ** u))


def test_costs_reproduce_the_checks_counts_and_the_bound_column(
        monkeypatch):
    _sfu(monkeypatch)
    bf16, f32 = torch.bfloat16, torch.float32
    # (cost, the inline count the check used, PERF.md's bound ms)
    b, s, d, h, r = chip_smoke.FT_BLOCK_SHAPE
    m_tok = b * s
    params = sum(math.prod(shape)
                 for shape in ft_block._param_shapes(d, r).values())
    assert ft_block.cost(b, s, d, h, r)[1] == 2 * b * s * d * 4 + params * 4
    products, rest = ft_block.block_ops(b, s, d, h, r)
    assert products == 2 * m_tok * (3 * d * d + d * d + 2 * r * d * d)
    assert rest == (4 * b * h * s * s * (d // h) + 2 * 8 * m_tok * d
                    + 10 * m_tok * r * d + 4 * b * h * s * s + 2 * m_tok * d)
    peak_16, peak_hbm = chip_smoke.peaks()
    ft_bound = max(ft_block.cost(b, s, d, h, r)[1] / peak_hbm,
                   chip_smoke.FT_SPLIT_PASSES * products / peak_16,
                   rest / chip_smoke.PEAK_F32_FLOPS) * 1e3
    assert round(ft_bound, 4) == 0.0757

    b, h, s, d = chip_smoke.SMALL_ATTN_SHAPE
    numel = b * h * s * d
    assert sa.cost(b, h, s, d, bf16) == (
        4.0 * b * h * s * s * d + 4.0 * b * h * s * s, 4 * numel * 2,
        float(b * h) * s * s)
    assert sa.cost_bwd(b, h, s, d, bf16) == (
        10.0 * b * h * s * s * d, 7 * numel * 2, float(b * h) * s * s)
    m, f, n = chip_smoke.INT8_SHAPE
    assert i8.cost(m, f, n, bf16, f32) == (
        2.0 * m * f * n, m * f + f * n * 4 + n * 4 + f * 4 + m * n * 2, 0.0)
    b, nc, v, d = chip_smoke.LOOKUP_SHAPE
    assert emb.lookup_cost(b, nc, d, bf16) == (
        0.0, 2 * b * nc * d * 2 + b * nc * 4, 0.0)
    u, nc, v, d = chip_smoke.ROWS_SHAPE
    touched = _expected_touched(u, nc, v)
    assert emb.rows_update_cost(u, nc, d, f32, touched) == (
        0.0, touched * 7 * d * 4 + u * nc * 4, 0.0)
    b, h, s, d = chip_smoke.FLASH_SHAPE
    numel, bh_s, pairs = b * h * s * d, b * h * s, float(b * h) * s * s
    assert fa.cost_fwd(b, h, s, d, bf16) == (
        4.0 * pairs * d, 4 * numel * 2 + bh_s * 4, pairs)
    assert fa.cost_bwd_dq(b, h, s, d, bf16) == (
        6.0 * pairs * d, 5 * numel * 2 + 2 * bh_s * 4, pairs)
    assert fa.cost_bwd_dkv(b, h, s, d, bf16) == (
        8.0 * pairs * d, 6 * numel * 2 + 2 * bh_s * 4, pairs)

    def bound(cost, dtype):
        n_ops, n_bytes, n_exp = cost
        return round(chip_smoke.bound_ms(n_bytes, n_ops, dtype, n_exp)[0], 4)

    shape = chip_smoke.SMALL_ATTN_SHAPE
    assert bound(sa.cost(*shape, bf16), bf16) == 0.0388
    assert bound(sa.cost_bwd(*shape, bf16), bf16) == 0.0679
    assert bound(i8.cost(*chip_smoke.INT8_SHAPE, bf16, f32), bf16) == 0.0045
    b, nc, v, d = chip_smoke.LOOKUP_SHAPE
    assert bound(emb.lookup_cost(b, nc, d, bf16), bf16) == 0.0042
    assert bound(emb.rows_update_cost(u, nc, 16, f32, touched), f32) \
        == 0.0227
    for cost in (fa.cost_fwd, fa.cost_bwd_dq, fa.cost_bwd_dkv):
        assert bound(cost(*chip_smoke.FLASH_SHAPE, bf16), bf16) == 1.9629


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _wrapper_calls():
    """(label, call, cost) of one call through each kernel wrapper at a
    small shape, on CPU tensors (the plain bodies)."""
    from shifu_tpu_torch.config.schema import ModelSpec
    g = _gen()
    q8 = torch.randint(-127, 128, (33, 7), generator=g, dtype=torch.int8)
    w = torch.randn(7, 5, generator=g, requires_grad=True)
    bias = torch.randn(5, generator=g, requires_grad=True)
    scale = torch.full((7,), 0.05)
    spec = ModelSpec(model_type="ft_transformer", token_dim=16,
                     num_attention_heads=4, mlp_ratio=2)
    shapes = ft_block._param_shapes(16, 2)
    p = {k: torch.randn(*shape, generator=g) * 0.1
         for k, shape in shapes.items()}
    x = torch.randn(3, 5, 16, generator=g)
    qkv = [torch.randn(2, 3, 9, 8, generator=g, dtype=torch.float32)
           for _ in range(3)]
    table = torch.randn(2, 50, 4, generator=g)
    ids = torch.randint(0, 50, (6, 2), generator=g)
    in_range = ids.clone()
    ids[0, 0] = 50  # out of range: the update skips it
    slots = (torch.rand(2, 50, 4, generator=g), torch.rand(2, 50, 4,
                                                          generator=g))
    g_rows = torch.randn(6, 2, 4, generator=g)
    return [
        # + the 4-byte placeholder Int8MatmulFn saves for a missing offset
        ("int8", lambda: i8.int8_matmul_dequant(q8, w, bias, scale),
         flops.add_costs(i8.cost(33, 7, 5, torch.bfloat16, torch.float32),
                         (0.0, 4.0, 0.0))),
        ("ft_block", lambda: ft_block.fused_transformer_block(x, p, spec),
         ft_block.cost(3, 5, 16, 4, 2)),
        ("small_attention", lambda: sa.small_token_attention(*qkv),
         sa.cost(2, 3, 9, 8, torch.float32)),
        ("small_attention_bwd",
         lambda: sa.small_attention_bwd(*qkv, qkv[0], 0.3),
         sa.cost_bwd(2, 3, 9, 8, torch.float32)),
        ("flash_fwd", lambda: fa.flash_fwd(*qkv, 0.3),
         fa.cost_fwd(2, 3, 9, 8, torch.float32)),
        ("lookup", lambda: emb.embedding_lookup(table, in_range),
         emb.lookup_cost(6, 2, 4, torch.float32)),
        ("rows_update",
         lambda: emb.fused_rows_update(table.clone(),
                                       tuple(s.clone() for s in slots),
                                       g_rows, ids, "adadelta", 0.1),
         # the clones are outside the kernel: counted as aten copies
         flops.add_costs(emb.rows_update_cost(6, 2, 4, torch.float32, 11),
                         (0.0, 3 * 2 * 2 * 50 * 4 * 4, 0.0))),
    ]


@pytest.mark.parametrize("case", range(7))
def test_a_call_through_each_wrapper_counts_its_formula(case):
    label, call, cost = _wrapper_calls()[case]
    _, got = flops.count(call)
    assert (got["flops"], got["bytes_accessed"], got["exponentials"]) \
        == tuple(float(c) for c in cost), label


def test_a_step_through_the_wrappers_counts_formulas_not_plain_ops():
    """The FT step through the fused block (plain body on the CPU) counts
    the block's formula in place of the body's products: the count does
    not move when the plain body changes its work."""
    from shifu_tpu_torch.config.schema import (DataConfig, JobConfig,
                                               ModelSpec, OptimizerConfig,
                                               TrainConfig)
    from shifu_tpu_torch.data import synthetic
    from shifu_tpu_torch.train.loop import init_state
    from shifu_tpu_torch.train.step import _train_step_fn
    job = JobConfig(
        schema=synthetic.make_schema(num_features=6),
        data=DataConfig(batch_size=8),
        model=ModelSpec(model_type="ft_transformer", token_dim=16,
                        num_layers=2, num_attention_heads=4, mlp_ratio=2,
                        compute_dtype="float32"),
        train=TrainConfig(epochs=1, optimizer=OptimizerConfig(
            name="sgd", learning_rate=0.1))).validate()
    assert ft_block.fused_block_engaged(job.model, 7, train=True)

    def step_count():
        state = init_state(job, 6, "cpu")
        return flops.count(_train_step_fn(job), state, _batch(job))[1]

    base = step_count()
    orig = ft_block.block_math

    def heavier(x, p, heads):  # the same result, more products
        for _ in range(3):
            torch.matmul(x, x.transpose(-1, -2))
        return orig(x, p, heads)

    try:
        ft_block.block_math = heavier
        heavy = step_count()
    finally:
        ft_block.block_math = orig
    # the forward's extra products are inside the wrapper (not counted);
    # the recompute backward runs the plain body outside it on both
    # devices, so its products count there
    fwd_extra = 0.0
    bwd_extra = 2 * 3 * 2 * (8 * 7 * 7 * 16)
    assert heavy["flops"] - base["flops"] == fwd_extra + bwd_extra


def test_goodput_mfu_uses_peak_override_as_jax(monkeypatch):
    from shifu_tpu.obs import goodput as jax_goodput
    for mod in (goodput, jax_goodput):
        monkeypatch.setenv(mod.ENV_PEAK_TFLOPS, "2.0")
        led = mod.begin_epoch()
        led.add("step", 1.0)
        led.add_flops(1e12)  # 1 TFLOP over a 1 s wall = 1 TFLOP/s
        rec = mod.end_epoch(0, wall_s=1.0)
        assert rec["achieved_tflops"] == pytest.approx(1.0)
        assert rec["mfu"] == pytest.approx(0.5)
        assert rec["peak_tflops"] == 2.0
    # tiny CPU rates keep significant digits in both
    monkeypatch.delenv(goodput.ENV_PEAK_TFLOPS)
    recs = []
    for mod in (goodput, jax_goodput):
        mod.begin_epoch().add_flops(1234.5678)
        recs.append(mod.end_epoch(0, wall_s=3.0))
    assert recs[0]["achieved_tflops"] == recs[1]["achieved_tflops"] > 0
    assert recs[0]["mfu"] is None and recs[0]["peak_tflops"] is None


def test_jax_cost_analysis_beside_the_port_count():
    """The same MLP train step: XLA's CPU cost analysis counts every op
    (the elementwise work, the loss, Adam's update); the port counts the
    products.  Recorded here with the band it holds."""
    import jax.numpy as jnp

    from shifu_tpu.config import schema as jax_schema
    from shifu_tpu.data import synthetic as jax_synth
    from shifu_tpu.obs import introspect
    from shifu_tpu.train import loop as jax_loop
    from shifu_tpu.train import step as jax_step
    from shifu_tpu_torch.config import schema as port_schema
    from shifu_tpu_torch.train.loop import init_state
    from shifu_tpu_torch.train.step import _train_step_fn

    jjob = jax_schema.JobConfig(
        schema=jax_synth.make_schema(12),
        data=jax_schema.DataConfig(batch_size=64, wire_dtype="int8"),
        model=jax_schema.ModelSpec(hidden_nodes=(16, 8),
                                   activations=("relu", "relu"),
                                   compute_dtype="float32"),
        train=jax_schema.TrainConfig(epochs=1, optimizer=(
            jax_schema.OptimizerConfig(name="adam",
                                       learning_rate=0.01)))).validate()
    pjob = port_schema.JobConfig.from_dict(
        json.loads(jjob.to_json())).validate()
    batch = _batch(pjob)
    introspect.reset_for_tests()
    jstate = jax_loop.init_state(jjob, 12)
    jax_step.make_train_step(jjob)(
        jstate, {k: jnp.asarray(v.numpy()) for k, v in batch.items()})
    xla = introspect.stats()["train_step"]["flops"]
    _, port = flops.count(_train_step_fn(pjob), init_state(pjob, 12, "cpu"),
                          batch)
    assert port["flops"] == _closed_form(64, (12, 16, 8, 1))
    ratio = port["flops"] / xla
    assert 0.5 <= ratio <= 1.0, (port["flops"], xla)
