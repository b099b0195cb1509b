"""The port's training slice (shifu_tpu_torch/ops/losses.py,
train/optimizers.py, train/step.py, train/loop.py) against the JAX
package's, on the CPU at small sizes.

Inputs are made with numpy and handed to both packages; the port starts
from the JAX package's initial parameters (`params_from_jax`), and both
start from fresh optimizer state, equal by construction.  Tolerances:
- losses and optimizer rules, f32: rtol 1e-5 (the same formulas, other
  summation orders and f32 vs f64 host scalars);
- the train step in f32: per-step losses rtol 1e-5 over 10 steps;
- the train step in bf16: rtol 1e-2 over 10 steps.  Both round to bf16 at
  the same points, but sums run in other orders, and on the CPU the JAX
  package decodes the int8 wire before layer 0 and so rounds layer 0's dW
  to bf16, where the port keeps it in f32 (ops/int8_matmul.py);
- `train()` end to end: per-epoch train_error rtol 1e-4 (f32), valid_auc
  within 1e-3 absolute.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from shifu_tpu.config import schema as jax_schema
from shifu_tpu.data import pipeline as jax_pipe
from shifu_tpu.data import synthetic as jax_synth
from shifu_tpu.export.artifact import _flatten_params
from shifu_tpu.ops import losses as jax_losses
from shifu_tpu.train import loop as jax_loop
from shifu_tpu.train import optimizers as jax_opt
from shifu_tpu.train import step as jax_step
from shifu_tpu_torch.config import schema as port_schema
from shifu_tpu_torch.data import pipeline as pipe
from shifu_tpu_torch.export.artifact import params_from_jax
from shifu_tpu_torch.models.registry import build_model
from shifu_tpu_torch.ops import int8_matmul as i8
from shifu_tpu_torch.ops import losses
from shifu_tpu_torch.train import loop, optimizers, step

F = 12
HIDDEN = (16, 8)


# -- losses -------------------------------------------------------------------

def _loss_inputs(h=1, seed=0, zero_weights=True):
    rng = np.random.default_rng(seed)
    logits = rng.normal(scale=2, size=(64, h)).astype(np.float32)
    target = rng.integers(0, 2, (64, h)).astype(np.float32)
    weight = rng.uniform(0.5, 2, (64, 1)).astype(np.float32)
    if zero_weights:
        weight[::7] = 0.0
    return logits, target, weight


@pytest.mark.parametrize("name", ["weighted_mse", "bce", "weighted_bce"])
@pytest.mark.parametrize("heads", [1, 3])
def test_losses_match_jax(name, heads):
    lg, t, w = _loss_inputs(heads, seed=heads)
    want_fn, got_fn = jax_losses.get_loss(name), losses.get_loss(name)
    if heads > 1:
        want_fn = jax_losses.multitask_loss(want_fn)
        got_fn = losses.multitask_loss(got_fn)
    want = float(want_fn(jnp.asarray(lg), jnp.asarray(t), jnp.asarray(w)))
    # bf16 logits: both upcast to f32 before the sigmoid
    lg_b = torch.from_numpy(lg).to(torch.bfloat16)
    want_b = float(want_fn(jnp.asarray(lg_b.float().numpy(), jnp.bfloat16),
                           jnp.asarray(t), jnp.asarray(w)))
    got = float(got_fn(torch.from_numpy(lg), torch.from_numpy(t),
                       torch.from_numpy(w)))
    got_b = float(got_fn(lg_b, torch.from_numpy(t), torch.from_numpy(w)))
    assert got == pytest.approx(want, rel=1e-5)
    assert got_b == pytest.approx(want_b, rel=1e-5)


def test_weighted_mse_all_zero_weights_and_l2_penalty():
    lg, t, _ = _loss_inputs()
    w0 = np.zeros((64, 1), np.float32)
    assert float(losses.weighted_mse(*map(torch.from_numpy, (lg, t, w0)))) \
        == float(jax_losses.weighted_mse(*map(jnp.asarray, (lg, t, w0)))) \
        == 0.0
    spec = port_schema.ModelSpec(hidden_nodes=HIDDEN,
                                 activations=("relu", "relu"))
    model = build_model(spec, pipe_schema(), device="cpu")
    params = {k: jnp.asarray(v.numpy())
              for k, v in model.state_dict().items()}
    for scale in (0.0, 0.01):
        with torch.no_grad():
            got = float(losses.l2_penalty(model, scale))
        assert got == pytest.approx(
            float(jax_losses.l2_penalty(params, scale)), rel=1e-5)


# -- optimizers ---------------------------------------------------------------

_OPT_CASES = [
    dict(name="adadelta", learning_rate=0.003),
    dict(name="adadelta", learning_rate=0.5, grad_clip_norm=0.5),
    dict(name="adam", learning_rate=0.01),
    dict(name="adamw", learning_rate=0.01, weight_decay=0.1),
    dict(name="sgd", learning_rate=0.1),
    dict(name="gradientdescent", learning_rate=0.1, accumulate_steps=2),
    dict(name="momentum", learning_rate=0.1, momentum=0.8),
    dict(name="rmsprop", learning_rate=0.01),
    dict(name="adagrad", learning_rate=0.1),
    dict(name="adam", learning_rate=0.01, schedule="cosine", decay_steps=4,
         end_lr_factor=0.1),
    dict(name="sgd", learning_rate=0.1, schedule="exponential",
         decay_steps=2, decay_rate=0.5),
    dict(name="adam", learning_rate=0.01, schedule="warmup_cosine",
         warmup_steps=2, decay_steps=5, end_lr_factor=0.2),
    dict(name="rmsprop", learning_rate=0.01, accumulate_steps=3,
         grad_clip_norm=1.0, schedule="cosine", decay_steps=3),
]


@pytest.mark.parametrize("kw", _OPT_CASES,
                         ids=[f"{c['name']}-{i}" for i, c in
                              enumerate(_OPT_CASES)])
def test_optimizer_matches_optax(kw):
    """5 updates (6 with accumulation) from the same params and grads."""
    rng = np.random.default_rng(len(kw))
    shapes = {"a": (5, 3), "b": (3,), "c": (4,)}
    p0 = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    jcfg = jax_schema.OptimizerConfig(**kw)
    tx = jax_opt.build_optimizer(jcfg)
    jparams = {k: jnp.asarray(v) for k, v in p0.items()}
    jstate = tx.init(jparams)
    tparams = [torch.nn.Parameter(torch.from_numpy(p0[k].copy()))
               for k in shapes]
    opt = optimizers.Optimizer(tparams, port_schema.OptimizerConfig(**kw))
    for _ in range(6):
        grads = {k: rng.normal(scale=2, size=s).astype(np.float32)
                 for k, s in shapes.items()}
        updates, jstate = tx.update({k: jnp.asarray(v)
                                     for k, v in grads.items()},
                                    jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        opt.step([torch.from_numpy(grads[k]) for k in shapes])
        for k, p in zip(shapes, tparams):
            np.testing.assert_allclose(p.detach().numpy(),
                                       np.asarray(jparams[k]),
                                       rtol=1e-5, atol=1e-6)


def test_unknown_optimizer_raises():
    with pytest.raises(port_schema.ConfigError):
        optimizers.Optimizer([], port_schema.OptimizerConfig(name="lion"))


# -- jobs, data and carried params -------------------------------------------

def pipe_schema():
    from shifu_tpu_torch.data import synthetic
    return synthetic.make_schema(F)


def _jobs(cdt="float32", wire="int8", **data_kw):
    """The same job for both packages (the port's parsed from the JAX
    job's dict)."""
    train_kw = data_kw.pop("train_kw", {})
    model_kw = data_kw.pop("model_kw", {})
    jjob = jax_schema.JobConfig(
        schema=jax_synth.make_schema(F),
        data=jax_schema.DataConfig(batch_size=64, wire_dtype=wire,
                                   **data_kw),
        model=jax_schema.ModelSpec(hidden_nodes=HIDDEN,
                                   activations=("relu", "relu"),
                                   compute_dtype=cdt, **model_kw),
        train=jax_schema.TrainConfig(
            epochs=3, optimizer=jax_schema.OptimizerConfig(
                name="adam", learning_rate=0.01), **train_kw)).validate()
    pjob = port_schema.JobConfig.from_dict(json.loads(jjob.to_json()))
    return jjob, pjob.validate()


def _datasets(n_train=1024, n_valid=300, seed=0):
    schema = jax_synth.make_schema(F)
    rows = jax_synth.make_rows(n_train + n_valid, schema, seed=seed)
    from shifu_tpu.data import reader as jax_reader
    cols = jax_reader.project_columns(rows, schema)

    def part(lo, hi, mod):
        return mod.TabularDataset(cols["features"][lo:hi],
                                  cols["target"][lo:hi],
                                  cols["weight"][lo:hi])
    return ((part(0, n_train, jax_pipe), part(n_train, None, jax_pipe)),
            (part(0, n_train, pipe), part(n_train, None, pipe)))


def _carry(jstate, pjob):
    """A port TrainState holding the JAX state's params."""
    state = loop.init_state(pjob, F, "cpu")
    flat = {k: np.asarray(v) for k, v in
            _flatten_params(jax.device_get(jstate.params)).items()}
    state.model.load_state_dict(params_from_jax(flat, state.model))
    return state


# -- the train step ------------------------------------------------------------

@pytest.mark.parametrize("cdt,rtol", [("float32", 1e-5), ("bfloat16", 1e-2)])
def test_train_step_lockstep_on_the_int8_wire(cdt, rtol):
    jjob, pjob = _jobs(cdt)
    assert step.wire_fused_into_model(pjob)  # layer 0 takes int8
    jstate = jax_loop.init_state(jjob, F)
    state = _carry(jstate, pjob)
    jtrain = jax_step.make_train_step(jjob)
    ptrain = step.make_train_step(pjob)
    (jtr, _), (ptr, _) = _datasets()
    wcast = pipe.wire_cast_fn(pjob.schema, pjob.data, cdt, compact=True)
    jl, pl = [], []
    for i, batch in enumerate(pipe.batch_iterator(ptr, 64, seed=1)):
        if i == 10:
            break
        b = wcast(batch)
        assert b["features"].dtype == np.int8 and "weight" not in b
        jstate, jm = jtrain(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        state, pm = ptrain(state, loop.to_device(b, pjob,
                                                 torch.device("cpu")))
        jl.append(float(jm["loss"]))
        pl.append(float(pm["loss"]))
    assert state.step == 10
    np.testing.assert_allclose(pl, jl, rtol=rtol)


def test_eval_step_matches_jax_scores():
    jjob, pjob = _jobs("float32")
    jstate = jax_loop.init_state(jjob, F)
    state = _carry(jstate, pjob)
    (_, jva), (_, pva) = _datasets()
    wcast = pipe.wire_cast_fn(pjob.schema, pjob.data, "float32")
    b = wcast({"features": pva.features[:100]})
    want = np.asarray(jax_step.make_eval_step(jjob)(
        jstate, {"features": jnp.asarray(b["features"])}))
    got = step.make_eval_step(pjob)(
        state, {"features": torch.from_numpy(b["features"])})
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_wire_decode_when_the_model_does_not_take_int8():
    """Outside the fused route (an FT model, or a layer 0 past the gate)
    the step decodes q * scale + offset in f32 before the model, as the
    JAX package's make_wire_decode does."""
    _, pjob = _jobs("float32")
    assert step.make_wire_decode(pjob) is None
    ft = dataclasses.replace(pjob, model=dataclasses.replace(
        pjob.model, model_type="ft_transformer"))
    assert not step.wire_fused_into_model(ft)
    dec = step.make_wire_decode(ft)
    q = torch.tensor([[-127, 0, 5] + [1] * (F - 3)], dtype=torch.int8)
    s, o = pipe.wire_params(pjob.schema, pjob.data)
    np.testing.assert_array_equal(dec(q).numpy(),
                                  pipe.wire_dequantize(q.numpy(), s, o))
    f32 = pipe.wire_cast_fn(pjob.schema, dataclasses.replace(
        pjob.data, wire_dtype="float32"), "float32")
    assert f32 is None


def test_port_engages_the_int8_kernel_route_where_jax_waits_for_a_tpu(
        monkeypatch):
    """Deliberate difference (ROADMAP.md section C): the JAX package sends
    int8 batches into layer 0 only on a TPU (or under SHIFU_TPU_PALLAS);
    the port does wherever the shape gate admits, so a CUDA int8 batch
    always reaches the kernel and the CPU runs the same routing through
    the plain version."""
    monkeypatch.delenv("SHIFU_TPU_PALLAS", raising=False)
    jjob, pjob = _jobs("bfloat16")
    assert jax.default_backend() == "cpu"
    assert not jax_step.wire_fused_into_model(jjob)
    assert step.wire_fused_into_model(pjob)
    state = loop.init_state(pjob, F, "cpu")
    seen = []
    from shifu_tpu_torch.models import base
    monkeypatch.setattr(base, "int8_matmul_dequant",
                        lambda *a: seen.append(a[0].dtype)
                        or i8.int8_matmul_dequant(*a))
    step.make_eval_step(pjob)(state, {"features": torch.zeros(
        (4, F), dtype=torch.int8)})
    assert seen == [torch.int8]
    wide = dataclasses.replace(pjob, model=dataclasses.replace(
        pjob.model, hidden_nodes=(4097, 8)))
    assert not step.wire_fused_into_model(wide)


# -- dropout ---------------------------------------------------------------------

def test_dropout_off_in_eval_and_deterministic_per_seed_and_step():
    _, pjob = _jobs("float32", model_kw={"dropout_rate": 0.5})
    _, nodrop = _jobs("float32")
    (_, _), (ptr, _) = _datasets()
    batch = next(pipe.batch_iterator(ptr, 64, seed=0))
    tb = loop.to_device(batch, pjob, torch.device("cpu"))
    st = loop.init_state(pjob, F, "cpu")
    ref = loop.init_state(nodrop, F, "cpu")
    ref.model.load_state_dict(st.model.state_dict())
    score = step.make_eval_step(pjob)
    feats = {"features": tb["features"]}
    # eval: dropout is off, so the scores equal a dropout-free model's
    torch.testing.assert_close(score(st, feats), score(ref, feats))
    assert st.model.training  # eval restored the training mode
    loss_fn = step.make_loss_fn(pjob)
    with torch.no_grad():
        a = loss_fn(st.model, tb, step=3)
        b = loss_fn(st.model, tb, step=3)
        c = loss_fn(st.model, tb, step=4)
        plain = step.make_loss_fn(nodrop)(ref.model, tb, step=3)
    assert float(a) == float(b)
    assert float(a) != float(c) and float(a) != float(plain)
    other = dataclasses.replace(pjob, train=dataclasses.replace(
        pjob.train, seed=7))
    with torch.no_grad():
        assert float(step.make_loss_fn(other)(st.model, tb, step=3)) \
            != float(a)


def test_dropout_keeps_the_state_dict_layout():
    spec = port_schema.ModelSpec(hidden_nodes=HIDDEN,
                                 activations=("relu", "relu"),
                                 dropout_rate=0.3)
    a = build_model(spec, pipe_schema(), device="cpu", train=True)
    b = build_model(dataclasses.replace(spec, dropout_rate=0.0),
                    pipe_schema(), device="cpu")
    assert list(a.state_dict()) == list(b.state_dict())
    assert a.training and not b.training


# -- train() end to end -----------------------------------------------------------

def _run_both(monkeypatch, cdt="float32", **data_kw):
    jjob, pjob = _jobs(cdt, **data_kw)
    (jtr, jva), (ptr, pva) = _datasets()
    jres = jax_loop.train(jjob, jtr, jva, console=lambda s: None)
    jinit = jax_loop.init_state(jjob, F)  # same seed: the same init
    real_init = loop.init_state

    def carried(job, num_features, device=None):
        state = real_init(job, num_features, device)
        flat = {k: np.asarray(v) for k, v in
                _flatten_params(jax.device_get(jinit.params)).items()}
        state.model.load_state_dict(params_from_jax(flat, state.model))
        return state

    monkeypatch.setattr(loop, "init_state", carried)
    lines = []
    pres = loop.train(pjob, ptr, pva, console=lines.append, device="cpu")
    return jres, pres, lines


@pytest.mark.parametrize("tier,data_kw", [
    ("resident", {}),
    ("batch", {"staged": False}),
])
def test_train_matches_jax_train(monkeypatch, tier, data_kw):
    jres, pres, lines = _run_both(monkeypatch, **data_kw)
    assert pres.tier == tier
    assert len(pres.history) == len(jres.history) == 3
    for g, w in zip(pres.history, jres.history):
        assert g.train_error == pytest.approx(w.train_error, rel=1e-4)
        assert g.valid_error == pytest.approx(w.valid_error, rel=1e-4)
        assert abs(g.valid_auc - w.valid_auc) <= 1e-3
    assert lines[0].startswith("Epoch 0: train_error=")
    assert lines[-1].endswith("progress=100%")


def test_train_matches_jax_train_bf16(monkeypatch):
    """bf16 compute on the resident int8 tier: train_error rtol 2e-2,
    valid_auc within 1e-2 (module docstring)."""
    jres, pres, _ = _run_both(monkeypatch, cdt="bfloat16")
    for g, w in zip(pres.history, jres.history):
        assert g.train_error == pytest.approx(w.train_error, rel=2e-2)
        assert abs(g.valid_auc - w.valid_auc) <= 1e-2


def test_local_sgd_needs_the_resident_tier_in_both(monkeypatch):
    """local_sgd_window > 0: the per-batch tier raises the JAX loop's
    ValueError in both packages; on the resident tier both train (one
    device holds one replica, so the window's average is the identity and
    the epochs match plain SGD's)."""
    def jobs(**data_kw):
        jjob, _ = _jobs("float32", **data_kw)
        jjob = dataclasses.replace(jjob, train=dataclasses.replace(
            jjob.train, epochs=2, local_sgd_window=4,
            optimizer=jax_schema.OptimizerConfig(name="sgd",
                                                 learning_rate=0.1)))
        pjob = port_schema.JobConfig.from_dict(json.loads(jjob.to_json()))
        return jjob.validate(), pjob.validate()

    (jtr, jva), (ptr, pva) = _datasets()
    jjob, pjob = jobs(staged=False)
    messages = []
    for fn, job, tr, va in ((jax_loop.train, jjob, jtr, jva),
                            (loop.train, pjob, ptr, pva)):
        kw = {"device": "cpu"} if fn is loop.train else {}
        with pytest.raises(ValueError, match="local_sgd_window") as err:
            fn(job, tr, va, console=lambda s: None, **kw)
        messages.append(str(err.value))
    assert messages[0] == messages[1]

    jjob, pjob = jobs()
    jres = jax_loop.train(jjob, jtr, jva, console=lambda s: None)
    jinit = jax_loop.init_state(jjob, F)
    real_init = loop.init_state

    def carried(job, num_features, device=None):
        state = real_init(job, num_features, device)
        flat = {k: np.asarray(v) for k, v in
                _flatten_params(jax.device_get(jinit.params)).items()}
        state.model.load_state_dict(params_from_jax(flat, state.model))
        return state

    monkeypatch.setattr(loop, "init_state", carried)
    pres = loop.train(pjob, ptr, pva, console=lambda s: None, device="cpu")
    assert pres.tier == "resident"
    assert len(pres.history) == len(jres.history) == 2
    for g, w in zip(pres.history, jres.history):
        assert g.train_error == pytest.approx(w.train_error, rel=1e-4)
        assert abs(g.valid_auc - w.valid_auc) <= 1e-3


def test_eval_pads_the_tail_with_zero_weight_rows():
    _, pjob = _jobs("float32")
    (_, _), (_, pva) = _datasets(n_valid=300)
    state = loop.init_state(pjob, F, "cpu")
    assert loop.eval_batch_size(pjob, 300) == 4096
    assert loop.eval_batch_size(pjob, 5000) == 4096
    big = dataclasses.replace(pjob, data=dataclasses.replace(
        pjob.data, batch_size=65536))
    assert loop.eval_batch_size(big, 5000) == 8192
    assert loop.eval_batch_size(big, 262144) == 65536
    err_full, auc_full = loop.evaluate(state, pva, pjob,
                                       step.make_eval_step(pjob),
                                       torch.device("cpu"))
    err_small, auc_small = loop.evaluate(state, pva, pjob,
                                         step.make_eval_step(pjob),
                                         torch.device("cpu"), batch_size=7)
    assert err_full == pytest.approx(err_small, rel=1e-6)
    assert auc_full == pytest.approx(auc_small, abs=1e-9)


@pytest.mark.parametrize("data_kw,want", [
    ({}, "resident"),
    # past the resident budget the JAX loop stages, and so does the port
    ({"device_resident_bytes": 0}, "staged"),
    ({"staged": False}, "batch"),
    ({"drop_remainder": False}, "batch"),
    # 1024 rows x (12 int8 features + a u8 target), weight elided
    ({"device_resident_bytes": 1024 * 13}, "resident"),
    ({"device_resident_bytes": 1024 * 13 - 1}, "staged"),
])
def test_tier_choice(data_kw, want):
    _, pjob = _jobs("float32", **data_kw)
    (_, _), (ptr, pva) = _datasets()
    job = dataclasses.replace(pjob, train=dataclasses.replace(pjob.train,
                                                              epochs=1))
    res = loop.train(job, ptr, pva, console=lambda s: None, device="cpu")
    assert res.tier == want


def test_early_stopping_restores_the_best_params(monkeypatch):
    _, pjob = _jobs("float32", train_kw={"early_stop_patience": 2})
    job = dataclasses.replace(pjob, train=dataclasses.replace(pjob.train,
                                                              epochs=10))
    (_, _), (ptr, pva) = _datasets()
    errors = iter([0.5, 0.4, 0.45, 0.46, 0.3])
    snapshots = []

    def fake_eval(state, ds, job, eval_step, device, batch_size=None,
                  score_sink=None):
        snapshots.append({k: v.clone() for k, v in
                          state.model.state_dict().items()})
        return next(errors), 0.5

    monkeypatch.setattr(loop, "evaluate", fake_eval)
    lines = []
    res = loop.train(job, ptr, pva, console=lines.append, device="cpu")
    assert len(res.history) == 4  # epochs 2 and 3 missed epoch 1's best
    assert any(ln.startswith("Early stop at epoch 3") for ln in lines)
    for k, v in res.state.model.state_dict().items():
        torch.testing.assert_close(v, snapshots[1][k])
        assert not torch.equal(v, snapshots[3][k])


def test_checkpoint_directory_is_refused(tmp_path, monkeypatch):
    """A checkpoint directory trains, saves and resumes, local
    (tests/test_torch_checkpoint.py) or remote: here pyarrow's mock://
    filesystem, through data/fsio.py (the remote half, ROADMAP (a)4.3)."""
    from pyarrow import fs as pafs

    from shifu_tpu_torch.data import fsio
    from shifu_tpu_torch.train import checkpoint as ckpt_lib

    mock, _ = pafs.FileSystem.from_uri("mock://seed")
    monkeypatch.setitem(fsio._fs_cache, ("mock", ""), mock)
    _, pjob = _jobs("float32")
    job = dataclasses.replace(pjob, runtime=dataclasses.replace(
        pjob.runtime, checkpoint=dataclasses.replace(
            pjob.runtime.checkpoint, directory="mock://bucket/ckpt")))
    (_, _), (ptr, pva) = _datasets()
    first = loop.train(job, ptr, pva, console=lambda s: None, device="cpu")
    manager = ckpt_lib.make_manager("mock://bucket/ckpt")
    assert manager.all_steps()[-1] == int(first.state.step)
    assert ckpt_lib.verify_manifest(manager.directory,
                                    manager.latest_step()) is True
    lines = []
    again = loop.train(job.replace(train=dataclasses.replace(
        job.train, epochs=job.train.epochs + 1)), ptr, pva,
        console=lines.append, device="cpu")
    assert any(line.startswith("Resumed from checkpoint") for line in lines)
    assert again.resumed_from_epoch == job.train.epochs


def test_files_load_first_where_jax_would_stream(tmp_path, monkeypatch):
    """Both packages stream the first epoch of a job given files: with
    stream_first_epoch (the default) and no hot cache, neither loads the
    datasets before epoch 0; both train epoch 0 on the streamed blocks, in
    file order, with the same block count and `real_batches`, and agree on
    its train_error.  The later epochs train the retained dataset on the
    staged tier (the partition is past the resident budget here) in both,
    with the same losses."""
    from shifu_tpu_torch.data import synthetic
    schema = synthetic.make_schema(F)
    synthetic.write_files(synthetic.make_rows(1500, schema, seed=2),
                          str(tmp_path), 2)
    jjob, pjob = _jobs("float32", device_resident_bytes=0)
    assert pjob.data.stream_first_epoch and jjob.data.stream_first_epoch
    pjob = dataclasses.replace(pjob, data=dataclasses.replace(
        pjob.data, paths=(str(tmp_path),)))
    jjob = jjob.replace(data=dataclasses.replace(
        jjob.data, paths=(str(tmp_path),)))
    loads = []
    for mod in (pipe, jax_pipe):
        real = mod.load_datasets
        monkeypatch.setattr(mod, "load_datasets",
                            lambda *a, _r=real, **k: loads.append(1)
                            or _r(*a, **k))
    blocks = {}
    for name, mod in (("port", pipe), ("jax", jax_pipe)):
        real_blocks = mod.StreamingLoader.first_epoch_blocks

        def counted(self, *a, _r=real_blocks, _n=name, **k):
            for b in _r(self, *a, **k):
                blocks[_n] = blocks.get(_n, 0) + 1
                yield b
            blocks[_n + "_real"] = self.real_batches

        monkeypatch.setattr(mod.StreamingLoader, "first_epoch_blocks",
                            counted)
    jinit = jax_loop.init_state(jjob, F)
    real_init = loop.init_state

    def carried(job, num_features, device=None):
        state = real_init(job, num_features, device)
        flat = {k: np.asarray(v) for k, v in
                _flatten_params(jax.device_get(jinit.params)).items()}
        state.model.load_state_dict(params_from_jax(flat, state.model))
        return state

    monkeypatch.setattr(loop, "init_state", carried)
    jlines, plines = [], []
    jres = jax_loop.train(jjob, console=jlines.append)
    pres = loop.train(pjob, console=plines.append, device="cpu")
    assert loads == []  # neither loaded before its first epoch
    assert any(ln.startswith("Streaming first epoch") for ln in plines)
    assert any(ln.startswith("Streaming first epoch") for ln in jlines)
    assert blocks["port"] == blocks["jax"] > 0
    assert blocks["port_real"] == blocks["jax_real"] > 0
    assert pres.tier == "staged"
    assert len(pres.history) == len(jres.history) == 3
    for g, w in zip(pres.history, jres.history):
        assert g.train_error == pytest.approx(w.train_error, rel=1e-4)
        assert abs(g.valid_auc - w.valid_auc) <= 1e-3


@pytest.mark.parametrize("model_type", ["multitask", "moe_mlp"])
def test_training_other_models_is_refused(model_type):
    """multitask and moe_mlp, the last models of the JAX ladder, train;
    a model type outside the ladder is refused."""
    _, pjob = _jobs("float32", wire="float32")
    job = dataclasses.replace(pjob, model=dataclasses.replace(
        pjob.model, model_type=model_type))
    state = loop.init_state(job, F, "cpu")
    assert type(state.model).__name__ == {"multitask": "MultiTask",
                                          "moe_mlp": "MoEMLP"}[model_type]
    bogus = dataclasses.replace(job, model=dataclasses.replace(
        job.model, model_type="bogus"))
    with pytest.raises(KeyError, match="bogus"):
        loop.init_state(bogus, F, "cpu")


def test_default_device_is_the_card(monkeypatch):
    _, pjob = _jobs("float32")
    (_, _), (ptr, pva) = _datasets()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        loop.train(pjob, ptr, pva)
