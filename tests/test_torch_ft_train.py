"""FT-Transformer training in the port (shifu_tpu_torch/train with
models/ft_transformer.py) against the JAX package's, on the CPU at small
sizes: `make_train_step` in lockstep, `train()` end to end with the trained
artifact scored by both packages, dropout with remat on the default gate,
and the int8 wire decoded before the model.

Inputs are made with numpy and handed to both packages; the port starts
from the JAX package's initial parameters (`params_from_jax`).
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from shifu_tpu.config import schema as jax_schema
from shifu_tpu.data import pipeline as jax_pipe
from shifu_tpu.data import synthetic as jax_synth
from shifu_tpu.export.artifact import _flatten_params
from shifu_tpu.train import loop as jax_loop
from shifu_tpu.train import step as jax_step
from shifu_tpu_torch.config import schema as port_schema
from shifu_tpu_torch.data import pipeline as pipe
from shifu_tpu_torch.export.artifact import params_from_jax
from shifu_tpu_torch.train import loop, step

# A small FT (token_dim 16, 2 layers, 4 heads, mlp_ratio 2; 10 features of
# which 3 categorical with vocab 20) on three routes: fused_block "on" (the
# JAX fused block runs its Pallas forward in interpret mode and the
# recompute VJP), "off" (the unfused block; the JAX small-token attention is
# sent through its Pallas kernels, forward and backward, in interpret mode)
# and flash (fused_block "off", attention_impl "flash"; the JAX flash
# kernels in interpret mode with 32-row blocks).  Dropout 0: the two
# packages draw other masks.  SGD: the key bias has a gradient of exactly 0
# in exact arithmetic (softmax is shift-invariant per query), so both
# packages hold roundoff there, which Adam would scale up to full steps.

FT_F, FT_CAT, FT_VOCAB = 10, 3, 20
_FT_ROUTES = {"fused": dict(fused_block="on"),
              "unfused": dict(fused_block="off"),
              "flash": dict(fused_block="off", attention_impl="flash")}


def _force_jax_kernels(monkeypatch):
    """Send the JAX FT model's attention through its Pallas kernels on the
    CPU (interpret mode), as the port always takes its kernels; the JAX
    package itself is not edited."""
    import functools
    from shifu_tpu.models import ft_transformer as jax_ft
    from shifu_tpu.ops import pallas_attention as jax_fa
    from shifu_tpu.ops import pallas_small_attention as jax_sa
    monkeypatch.setattr(jax_ft, "small_token_attention", functools.partial(
        jax_sa.small_token_attention, use_pallas=True))
    monkeypatch.setattr(jax_ft, "flash_attention", functools.partial(
        jax_fa.flash_attention, use_pallas=True, block_q=32, block_k=32))


def _ft_jobs(route, cdt="float32", epochs=2):
    schema = jax_synth.make_schema(num_features=FT_F, num_categorical=FT_CAT,
                                   vocab_size=FT_VOCAB)
    jjob = jax_schema.JobConfig(
        schema=schema, data=jax_schema.DataConfig(batch_size=64),
        model=jax_schema.ModelSpec(
            model_type="ft_transformer", token_dim=16, num_layers=2,
            num_attention_heads=4, mlp_ratio=2, compute_dtype=cdt,
            **_FT_ROUTES[route]),
        train=jax_schema.TrainConfig(
            epochs=epochs, loss="weighted_mse",
            optimizer=jax_schema.OptimizerConfig(name="sgd",
                                                 learning_rate=0.1))
    ).validate()
    pjob = port_schema.JobConfig.from_dict(json.loads(jjob.to_json()))
    return jjob, pjob.validate()


def _ft_datasets(jjob, n_train=640, n_valid=200, seed=3):
    from shifu_tpu.data import reader as jax_reader
    cols = jax_reader.project_columns(
        jax_synth.make_rows(n_train + n_valid, jjob.schema, seed=seed),
        jjob.schema)

    def part(lo, hi, mod):
        return mod.TabularDataset(cols["features"][lo:hi],
                                  cols["target"][lo:hi],
                                  cols["weight"][lo:hi])
    return ((part(0, n_train, jax_pipe), part(n_train, None, jax_pipe)),
            (part(0, n_train, pipe), part(n_train, None, pipe)))


def _carried_state(jparams, pjob, init_state=loop.init_state):
    state = init_state(pjob, FT_F, "cpu")
    flat = {k: np.asarray(v) for k, v in
            _flatten_params(jax.device_get(jparams)).items()}
    state.model.load_state_dict(params_from_jax(flat, state.model))
    return state


@pytest.mark.parametrize("cdt,rtol", [("float32", 1e-5), ("bfloat16", 1e-2)])
@pytest.mark.parametrize("route", list(_FT_ROUTES))
def test_ft_train_step_lockstep(monkeypatch, route, cdt, rtol):
    """10 `make_train_step` updates of the FT from the same params on the
    same batches: per-step losses and the final params.  bf16: both round
    to bf16 between ops, at points the frameworks choose."""
    _force_jax_kernels(monkeypatch)
    jjob, pjob = _ft_jobs(route, cdt)
    jstate = jax_loop.init_state(jjob, FT_F)
    state = _carried_state(jstate.params, pjob)
    jtrain = jax_step.make_train_step(jjob)
    ptrain = step.make_train_step(pjob)
    (_, _), (ptr, _) = _ft_datasets(jjob)
    wcast = pipe.wire_cast_fn(pjob.schema, pjob.data, cdt, compact=True)
    jl, pl = [], []
    for i, batch in enumerate(pipe.batch_iterator(ptr, 64, seed=1)):
        if i == 10:
            break
        b = wcast(batch)
        jstate, jm = jtrain(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        state, pm = ptrain(state, loop.to_device(b, pjob,
                                                 torch.device("cpu")))
        jl.append(float(jm["loss"]))
        pl.append(float(pm["loss"]))
    assert state.step == 10
    np.testing.assert_allclose(pl, jl, rtol=rtol)
    if cdt == "float32":
        want = {k.replace("/", "."): np.asarray(v) for k, v in
                _flatten_params(jax.device_get(jstate.params)).items()}
        for k, v in state.model.state_dict().items():
            np.testing.assert_allclose(v.numpy(), want[k], rtol=1e-4,
                                       atol=1e-5, err_msg=k)


@pytest.mark.parametrize("route", list(_FT_ROUTES))
def test_ft_train_matches_jax_train(monkeypatch, tmp_path, route):
    """`train()` of the FT against JAX `train()` from the same params, f32:
    per-epoch train_error and valid_error rel 1e-4, valid_auc within 1e-3;
    then the trained model's artifact scores the same through the port's
    `TorchScorer` and the JAX package's `JaxScorer`.  The JAX flash route
    takes its XLA reference `mha` here (its default off a TPU): in
    interpret mode the 4096-row eval batch takes a minute, and the step
    lockstep above holds the port to the flash kernels."""
    from shifu_tpu.export.scorer import JaxScorer
    from shifu_tpu_torch.export.artifact import save_artifact
    from shifu_tpu_torch.export.scorer import TorchScorer
    if route != "flash":
        _force_jax_kernels(monkeypatch)
    jjob, pjob = _ft_jobs(route)
    (jtr, jva), (ptr, pva) = _ft_datasets(jjob)
    jres = jax_loop.train(jjob, jtr, jva, console=lambda s: None)
    jinit = jax_loop.init_state(jjob, FT_F)  # same seed: the same init
    real_init = loop.init_state
    monkeypatch.setattr(loop, "init_state",
                        lambda job, n, device=None: _carried_state(
                            jinit.params, job, real_init))
    pres = loop.train(pjob, ptr, pva, console=lambda s: None, device="cpu")
    assert pres.tier == "resident"
    assert len(pres.history) == len(jres.history) == 2
    for g, w in zip(pres.history, jres.history):
        assert g.train_error == pytest.approx(w.train_error, rel=1e-4)
        assert g.valid_error == pytest.approx(w.valid_error, rel=1e-4)
        assert abs(g.valid_auc - w.valid_auc) <= 1e-3
    out = save_artifact(pres.state.model, pjob.model, pjob.schema,
                        str(tmp_path / "ft"))
    x = pva.features[:50]
    np.testing.assert_allclose(
        TorchScorer(out, device="cpu").compute_batch(x),
        JaxScorer(out).compute_batch(x), rtol=1e-5, atol=1e-5)


def test_ft_trains_with_dropout_remat_and_the_auto_gate():
    """`train()` of the FT with dropout and remat on the default gate: the
    unfused block trains (dropout keeps fusion off in training), the eval
    fuses, and remat does not change the result."""
    from shifu_tpu_torch.ops import ft_block
    _, pjob = _ft_jobs("unfused")
    (_, _), (ptr, pva) = _ft_datasets(_ft_jobs("unfused")[0])
    results = []
    for remat in (False, True):
        job = dataclasses.replace(pjob, model=dataclasses.replace(
            pjob.model, fused_block="auto", dropout_rate=0.1, remat=remat))
        results.append(loop.train(job, ptr, pva, console=lambda s: None,
                                  device="cpu"))
        assert not ft_block.fused_block_engaged(job.model, FT_F + 1,
                                                train=True)
        assert ft_block.fused_block_engaged(job.model, FT_F + 1)
    a, b = results
    assert [m.train_error for m in a.history] == pytest.approx(
        [m.train_error for m in b.history], rel=1e-6)
    for k, v in a.state.model.state_dict().items():
        torch.testing.assert_close(v, b.state.model.state_dict()[k],
                                   rtol=1e-5, atol=1e-6)


def test_ft_decodes_the_int8_wire_before_the_model():
    """An FT model does not take int8 features: on the int8 wire the step
    decodes them in f32 before the model, and `train()` trains on it."""
    schema = jax_synth.make_schema(num_features=FT_F)
    jjob = jax_schema.JobConfig(
        schema=schema, data=jax_schema.DataConfig(batch_size=64,
                                                  wire_dtype="int8"),
        model=jax_schema.ModelSpec(model_type="ft_transformer", token_dim=8,
                                   num_layers=1, num_attention_heads=2,
                                   mlp_ratio=2, compute_dtype="float32"),
        train=jax_schema.TrainConfig(epochs=1)).validate()
    pjob = port_schema.JobConfig.from_dict(
        json.loads(jjob.to_json())).validate()
    assert not step.wire_fused_into_model(pjob)
    (_, _), (ptr, pva) = _ft_datasets(jjob, n_train=256, n_valid=64)
    batch = next(pipe.batch_iterator(ptr, 64, seed=0))
    q = pipe.wire_cast_fn(pjob.schema, pjob.data, "float32")(batch)
    assert q["features"].dtype == np.int8
    state = loop.init_state(pjob, FT_F, "cpu")
    scale, offset = pipe.wire_params(pjob.schema, pjob.data)
    decoded = dict(q, features=pipe.wire_dequantize(q["features"], scale,
                                                    offset))
    f32 = dataclasses.replace(pjob, data=dataclasses.replace(
        pjob.data, wire_dtype="float32"))
    with torch.no_grad():
        got = step.make_loss_fn(pjob)(
            state.model, loop.to_device(q, pjob, torch.device("cpu")))
        want = step.make_loss_fn(f32)(
            state.model, loop.to_device(decoded, f32, torch.device("cpu")))
    assert float(got) == float(want)
    res = loop.train(pjob, ptr, pva, console=lambda s: None, device="cpu")
    assert np.isfinite(res.history[-1].train_error)
