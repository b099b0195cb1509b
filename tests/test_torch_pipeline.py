"""GPipe over the `pipe` axis (shifu_tpu_torch/parallel/pipeline.py, the
stacked trunk of models/ft_transformer.py, the trunk-layout restore of
train/loop.py) against the JAX package: the counterparts of
tests/test_pipeline.py, run on gloo ranks (tests/torch_mesh_helpers, one
spawn of 8 ranks re-formed into 4 for the checkpoint run) and in the
pytest process.  JAX's weights reach the port through `params_from_jax`.

Tolerances, JAX's own:
- the schedule against the sequential oracle: forward rtol 1e-5, atol
  1e-6; gradients rtol 1e-4, atol 1e-5;
- the pipelined step against the one-device step: rtol 2e-4, atol 2e-5,
  the loss rel 1e-5;
- layouts and artifacts: canonicalized forward rtol 1e-5, atol 1e-6; the
  artifact's scores rtol 1e-4, atol 1e-5; the layout conversions exact;
- the data=2 x pipe=2 checkpoint resumed on one device against the
  unbroken one-device run: rtol 1e-4, atol 1e-5 (PR 16's resume test).
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_mesh_helpers as H
from shifu_tpu.config import schema as jax_schema
from shifu_tpu.data import reader as jax_reader
from shifu_tpu.data import synthetic as jax_synth
from shifu_tpu.export import load_scorer as jax_load_scorer
from shifu_tpu.export.artifact import _flatten_params
from shifu_tpu.models import ft_transformer as jax_ft
from shifu_tpu.models.registry import build_model as jax_build_model
from shifu_tpu.parallel import pipeline_reference as jax_pipeline_reference
from shifu_tpu.train import loop as jax_loop
from shifu_tpu.train import step as jax_step
from shifu_tpu_torch.config import schema as port_schema
from shifu_tpu_torch.config.schema import ConfigError, MeshConfig, ModelSpec
from shifu_tpu_torch.data import pipeline as pipe
from shifu_tpu_torch.export.artifact import params_from_jax, save_artifact
from shifu_tpu_torch.export.scorer import Scorer
from shifu_tpu_torch.models import ft_transformer as port_ft
from shifu_tpu_torch.models.registry import build_model
from shifu_tpu_torch.parallel import pipeline_reference
from shifu_tpu_torch.parallel.mesh import Mesh
from shifu_tpu_torch.train import checkpoint as ckpt_lib
from shifu_tpu_torch.train import loop, step

L, D, N_MICRO, MB = 4, 8, 6, 8


def _ft_jobs(stages, batch_size=16, mesh_cfg=None, **model_kw):
    schema = jax_synth.make_schema(num_features=7, num_categorical=2,
                                   vocab_size=16)
    jjob = jax_schema.JobConfig(
        schema=schema, data=jax_schema.DataConfig(batch_size=batch_size),
        model=jax_schema.ModelSpec(
            model_type="ft_transformer", hidden_nodes=(8,),
            activations=("relu",), token_dim=8, num_attention_heads=2,
            num_layers=2, pipeline_stages=stages, compute_dtype="float32",
            **model_kw),
        train=jax_schema.TrainConfig(
            epochs=1, loss="weighted_mse",
            optimizer=jax_schema.OptimizerConfig(name="adadelta",
                                                 learning_rate=0.01)),
    ).validate()
    if mesh_cfg is not None:
        jjob = jjob.replace(runtime=jjob.runtime.__class__(
            mesh=jax_schema.MeshConfig(**mesh_cfg)))
    pjob = port_schema.JobConfig.from_dict(json.loads(jjob.to_json()))
    return jjob, pjob.validate()


def _ft_batch(job, n, seed=0):
    rows = jax_synth.make_rows(n, job.schema, seed=seed)
    return jax_reader.project_columns(rows, job.schema)


def _flat(params) -> dict:
    return {k: np.asarray(v) for k, v in
            _flatten_params(jax.device_get(params)).items()}


def _with_ckpt(pjob, directory, epochs):
    return pjob.replace(
        train=dataclasses.replace(pjob.train, epochs=epochs),
        runtime=dataclasses.replace(
            pjob.runtime, checkpoint=dataclasses.replace(
                pjob.runtime.checkpoint, directory=str(directory))))


def _ft_data():
    jjob, _ = _ft_jobs(2)
    cols = _ft_batch(jjob, 160, seed=21)
    arrays = (cols["features"], cols["target"], cols["weight"])
    return (tuple(a[:128] for a in arrays), tuple(a[128:] for a in arrays))


def _toy_stage(params, h):
    for i in range(params["w"].shape[0]):
        h = torch.tanh(h @ params["w"][i])
    return h


def _jax_toy_stage(params, h):
    def body(carry, w):
        return jnp.tanh(carry @ w), None
    out, _ = jax.lax.scan(body, h, params)
    return out


# -- the multi-rank runs: one spawn ------------------------------------------

@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """8 gloo ranks on data=4 x pipe=2 (the toy schedule, its gradients,
    the FT step from JAX's weights), then the first 4 re-formed into
    data=2 x pipe=2 for a checkpointed 2-epoch run."""
    tmp = tmp_path_factory.mktemp("pipe")
    rng = np.random.default_rng(0)
    toy_w = (rng.standard_normal((L, D, D)) * 0.3).astype(np.float32)
    toy_x = rng.standard_normal((N_MICRO, MB, D)).astype(np.float32)

    jjob, pjob = _ft_jobs(2, mesh_cfg=dict(data=4, pipe=2))
    jstate = jax_loop.init_state(jjob.replace(
        runtime=jax_schema.RuntimeConfig()), jjob.schema.feature_count)
    flat = _flat(jstate.params)
    batches = [_ft_batch(jjob, 16, seed=s) for s in (1, 2)]
    jtrain = jax_step.make_train_step(jjob.replace(
        runtime=jax_schema.RuntimeConfig()), donate=False)
    jl = []
    for b in batches:
        jstate, m = jtrain(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        jl.append(float(m["loss"]))

    tr, va = _ft_data()
    _, ck_job = _ft_jobs(2, mesh_cfg=dict(data=2, pipe=2))
    ck_job = _with_ckpt(ck_job, tmp / "ckpt", 2)
    steps = [
        (8, H.pipeline_checks, (MeshConfig(data=4, pipe=2), toy_w, toy_x)),
        (8, H.dp_cases, (MeshConfig(data=4, pipe=2), [(pjob, flat, batches)])),
        (4, H.train_runs, (MeshConfig(data=2, pipe=2), [(ck_job, tr, va)])),
    ]
    res = H.run_ranks(H.sequence, 8, tmp, str(tmp / "regroup"), steps,
                      timeout=240.0)
    return {"ranks": res, "toy": (toy_w, toy_x), "jax_step": (jl, jstate),
            "flat": flat, "batches": batches, "pjob": pjob, "tmp": tmp,
            "ck_job": ck_job, "data": (tr, va)}


def test_pipeline_matches_reference_forward(ranks):
    """The schedule over data=4 x pipe=2 equals the sequential oracle (the
    port's and JAX's): every stage holds the outputs of its data rows."""
    toy_w, toy_x = ranks["toy"]
    want = pipeline_reference(_toy_stage, {"w": torch.tensor(toy_w)},
                              torch.tensor(toy_x), 2).numpy()
    jwant = np.asarray(jax_pipeline_reference(
        _jax_toy_stage, jnp.asarray(toy_w), jnp.asarray(toy_x), n_stages=2))
    np.testing.assert_allclose(want, jwant, rtol=1e-5, atol=1e-6)
    mb = MB // 4
    for res in ranks["ranks"]:
        got = res[0]
        d = got["coords"]["data"]
        np.testing.assert_allclose(got["out"], jwant[:, d * mb:(d + 1) * mb],
                                   rtol=1e-5, atol=1e-6)


def test_pipeline_matches_reference_gradients(ranks):
    """Each stage's gradient, summed over the data ranks, is its slice of
    the oracle's gradient of sum(out ** 2) (JAX's jax.grad of the
    reference)."""
    toy_w, toy_x = ranks["toy"]
    jgrad = np.asarray(jax.grad(lambda p: jnp.sum(jax_pipeline_reference(
        _jax_toy_stage, p, jnp.asarray(toy_x), 2) ** 2))(jnp.asarray(toy_w)))
    for stage in (0, 1):
        parts = [r[0]["grad"] for r in ranks["ranks"]
                 if r[0]["coords"]["pipe"] == stage]
        assert len(parts) == 4
        np.testing.assert_allclose(np.sum(parts, axis=0),
                                   jgrad[2 * stage:2 * stage + 2],
                                   rtol=1e-4, atol=1e-5)


def test_pipelined_train_step_matches_single_device(ranks):
    """Two steps on data=4 x pipe=2 from JAX's weights equal JAX's
    one-device steps of the stacked trunk; each stage holds its layer of
    every stacked leaf and of its optimizer slots, and the data ranks of a
    stage hold the same bits."""
    jl, jstate = ranks["jax_step"]
    want = {k.replace("/", "."): v for k, v in _flat(jstate.params).items()}
    res = [r[1][0] for r in ranks["ranks"]]
    for r in res:
        np.testing.assert_allclose(r["losses"], jl, rtol=1e-5)
        assert r["specs"]["blocks.qkv_kernel"] == ("pipe", None, None)
        assert r["state"]["param/blocks.qkv_kernel"].shape == (1, 8, 24)
        slots = [v for k, v in r["state"].items() if k.startswith("opt/")
                 and v.shape == (1, 8, 24)]
        assert len(slots) == 2  # Adadelta's two slots, the stage's layer
    full = res[0]["full"]
    assert sorted(full) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(full[k], v, rtol=2e-4, atol=2e-5,
                                   err_msg=k)
    for r in res:
        twin = next(o for o in res
                    if o["coords"]["pipe"] == r["coords"]["pipe"])
        for k, v in r["state"].items():
            assert np.array_equal(v, twin["state"][k]), k


def test_pipelined_step_matches_port_world1(ranks):
    """The same two steps on one device without a mesh (the stacked trunk
    as one loop) equal the mesh run's gathered parameters."""
    pjob = ranks["pjob"].replace(runtime=port_schema.RuntimeConfig())
    state = loop.init_state(pjob, pjob.schema.feature_count, "cpu")
    H.carry(state, ranks["flat"], pjob)
    train = step.make_train_step(pjob)
    for b in ranks["batches"]:
        state, _ = train(state, H.to_batch(b, pjob))
    full = ranks["ranks"][0][1][0]["full"]
    for k, v in state.model.state_dict().items():
        np.testing.assert_allclose(full[k], v.numpy(), rtol=2e-4, atol=2e-5,
                                   err_msg=k)


def test_data_pipe_checkpoint_resumes_on_one_device(ranks, tmp_path):
    """A data=2 x pipe=2 run's checkpoint (stage-split leaves and their
    slots gathered by the chief) resumes on one device and matches the
    unbroken one-device run."""
    tr, va = ranks["data"]
    first = [r[2][0] for r in ranks["ranks"][:4]]
    assert first[0]["history"][-1]["epoch"] == 1
    assert first[0]["state"]["param/blocks.qkv_kernel"].shape == (1, 8, 24)
    d = ranks["tmp"] / "ckpt"
    saved = torch.load(max((p for p in d.iterdir() if p.name.isdigit()),
                           key=lambda p: int(p.name)) / "state.pt",
                       weights_only=True)
    assert tuple(saved["model"]["blocks.qkv_kernel"].shape) == (2, 8, 24)
    job1 = ranks["ck_job"].replace(runtime=dataclasses.replace(
        ranks["ck_job"].runtime, mesh=MeshConfig()))
    resumed = loop.train(_with_ckpt(job1, d, 3), pipe.TabularDataset(*tr),
                         pipe.TabularDataset(*va), console=lambda s: None,
                         device="cpu")
    assert resumed.resumed_from_epoch == 2
    ref = loop.train(_with_ckpt(job1, tmp_path / "straight", 3),
                     pipe.TabularDataset(*tr), pipe.TabularDataset(*va),
                     console=lambda s: None, device="cpu")
    want = H.state_arrays(ref.state)
    got = H.state_arrays(resumed.state)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-4, atol=1e-5,
                                   err_msg=k)


# -- in the pytest process ---------------------------------------------------

def test_canonicalize_params_matches_per_block_model():
    """The stacked trunk's forward equals the per-block model's on the
    canonicalized weights, and both equal JAX's from the same weights;
    one seed draws the same weights in both layouts."""
    jjob, pjob = _ft_jobs(2, batch_size=8)
    x = np.random.default_rng(1).standard_normal(
        (8, jjob.schema.feature_count)).astype(np.float32)
    jmodel = jax_build_model(jjob.model, jjob.schema)
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x))
    jwant = np.asarray(jmodel.apply(variables, jnp.asarray(x)))
    stacked = build_model(pjob.model, pjob.schema, "cpu")
    stacked.load_state_dict(params_from_jax(_flat(variables["params"]),
                                            stacked))
    canon_spec = dataclasses.replace(pjob.model, pipeline_stages=1)
    canon = build_model(canon_spec, pjob.schema, "cpu")
    canon.load_state_dict(port_ft.canonicalize_params(
        dict(stacked.state_dict()), pjob.model))
    with torch.no_grad():
        got_s = stacked(torch.from_numpy(x)).numpy()
        got_c = canon(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got_c, got_s, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got_s, jwant, rtol=1e-5, atol=1e-6)
    seeded = [build_model(s, pjob.schema, "cpu",
                          generator=torch.Generator().manual_seed(5))
              for s in (pjob.model, canon_spec)]
    per_block = port_ft.canonicalize_params(dict(seeded[0].state_dict()),
                                            pjob.model)
    for k, v in seeded[1].state_dict().items():
        assert torch.equal(per_block[k], v), k


def test_pipelined_model_exports_canonical_artifact(tmp_path):
    """save_artifact on a stacked model writes the per-block artifact
    (pipeline_stages 1, transformer_block ops); the port's numpy scorer
    and the JAX package's scorer reproduce the training forward."""
    _, pjob = _ft_jobs(2, batch_size=8)
    state = loop.init_state(pjob, pjob.schema.feature_count, "cpu")
    save_artifact(state.model, pjob.model, pjob.schema, str(tmp_path))
    topo = json.loads((tmp_path / "topology.json").read_text())
    assert topo["model_spec"]["pipeline_stages"] == 1
    assert any(op["op"] == "transformer_block" for op in topo["program"])
    with np.load(tmp_path / "weights.npz") as z:
        assert "block_1/qkv/kernel" in z.files
        assert not any(k.startswith("blocks/") for k in z.files)
    rows = np.random.default_rng(2).standard_normal(
        (16, pjob.schema.feature_count)).astype(np.float32)
    state.model.eval()
    with torch.no_grad():
        want = torch.sigmoid(state.model(torch.from_numpy(rows))).numpy()
    for scorer in (Scorer(str(tmp_path)), jax_load_scorer(str(tmp_path))):
        got = np.asarray(scorer.compute_batch(rows)).ravel()
        np.testing.assert_allclose(got, want.ravel(), rtol=1e-4, atol=1e-5)


def test_mesh_pipe_stage_mismatch_rejected(eight_devices):
    """A pipe axis that disagrees with pipeline_stages fails at init with
    JAX's ConfigError."""
    from shifu_tpu.parallel import make_mesh as jax_make_mesh
    jjob, pjob = _ft_jobs(2, mesh_cfg=dict(data=2, pipe=4))
    with pytest.raises(jax_schema.ConfigError) as jerr:
        jax_loop.init_state(jjob, jjob.schema.feature_count, jax_make_mesh(
            jjob.runtime.mesh, devices=eight_devices))
    mesh = Mesh(MeshConfig(data=2, pipe=4), 0, {})
    with pytest.raises(ConfigError, match="pipe axis") as perr:
        loop.init_state(pjob, pjob.schema.feature_count, "cpu", mesh=mesh)
    assert str(perr.value) == str(jerr.value)


def test_pipeline_batch_quantum_rejected(eight_devices):
    """A batch that microbatches x data does not divide fails at init with
    JAX's ConfigError, which names the usable multiple."""
    from shifu_tpu.parallel import make_mesh as jax_make_mesh
    jjob, pjob = _ft_jobs(2, batch_size=24, mesh_cfg=dict(data=4, pipe=2),
                          pipeline_microbatches=4)
    with pytest.raises(jax_schema.ConfigError) as jerr:
        jax_loop.init_state(jjob, jjob.schema.feature_count, jax_make_mesh(
            jjob.runtime.mesh, devices=eight_devices))
    mesh = Mesh(MeshConfig(data=4, pipe=2), 0, {})
    with pytest.raises(ConfigError, match="multiple of 16") as perr:
        loop.init_state(pjob, pjob.schema.feature_count, "cpu", mesh=mesh)
    assert str(perr.value) == str(jerr.value)


@pytest.mark.parametrize("make", [
    lambda M, S: M(pipe=0).validate(),
    lambda M, S: M(pipe=2, axis_order=("data", "seq", "model")).validate(),
    lambda M, S: S(model_type="mlp", pipeline_stages=2).validate(),
    lambda M, S: S(model_type="ft_transformer", num_layers=3,
                   pipeline_stages=2).validate(),
])
def test_mesh_config_pipe_validation(make):
    """The config validations of the pipe axis and the stage count raise
    JAX's ConfigError with its message."""
    with pytest.raises(jax_schema.ConfigError) as jerr:
        make(jax_schema.MeshConfig, jax_schema.ModelSpec)
    with pytest.raises(ConfigError) as perr:
        make(MeshConfig, ModelSpec)
    assert str(perr.value) == str(jerr.value)


def test_trunk_layout_conversion_roundtrip():
    """stack_block_params inverts canonicalize_params exactly, on the
    port's tensors and on JAX's arrays, and both match JAX's conversions
    of the same weights name for name."""
    jjob, pjob = _ft_jobs(2, batch_size=8)
    jmodel = jax_build_model(jjob.model, jjob.schema)
    jparams = dict(jmodel.init(jax.random.PRNGKey(1), jnp.zeros(
        (8, jjob.schema.feature_count), jnp.float32))["params"])
    jcanon = {k.replace("/", "."): v for k, v in _flat(
        jax_ft.canonicalize_params(jparams, jjob.model)).items()}
    flat = {k.replace("/", "."): v for k, v in _flat(jparams).items()}
    canon = port_ft.canonicalize_params(flat, pjob.model)
    assert sorted(canon) == sorted(jcanon)
    for k, v in jcanon.items():
        np.testing.assert_array_equal(np.asarray(canon[k]), v)
    back = port_ft.stack_block_params(canon, pjob.model)
    assert sorted(back) == sorted(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(np.asarray(back[k]), v)
    model = build_model(pjob.model, pjob.schema, "cpu")
    sd = dict(model.state_dict())
    rt = port_ft.stack_block_params(
        port_ft.canonicalize_params(sd, pjob.model), pjob.model)
    for k, v in sd.items():
        assert torch.equal(rt[k], v), k


@pytest.mark.parametrize("first_stages", [1, 2])
def test_checkpoint_resumes_across_trunk_layout(tmp_path, first_stages):
    """A per-block checkpoint resumes into a stacked trunk and a stacked
    one into the per-block trunk: the weights convert exactly, the
    optimizer restarts, and the console says so (JAX's
    restore_latest_any_layout)."""
    tr, va = _ft_data()
    _, a = _ft_jobs(first_stages)
    _, b = _ft_jobs(3 - first_stages)
    first = loop.train(_with_ckpt(a, tmp_path, 2), pipe.TabularDataset(*tr),
                       pipe.TabularDataset(*va), console=lambda s: None,
                       device="cpu")
    job_b = _with_ckpt(b, tmp_path, 3)
    state = loop.init_state(job_b, job_b.schema.feature_count, "cpu")
    said = []
    _, extra, step_no = loop.restore_latest_any_layout(
        ckpt_lib.make_manager(str(tmp_path)), state, job_b, said.append)
    assert extra["epoch"] == 2 and step_no == first.state.step
    assert state.step == first.state.step
    assert "trunk-layout change" in said[0] and "reinitialized" in said[0]
    convert = (port_ft.stack_block_params if first_stages == 1
               else port_ft.canonicalize_params)
    want = convert(dict(first.state.model.state_dict()), a.model)
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, want[k]), k
    resumed = loop.train(job_b, pipe.TabularDataset(*tr),
                         pipe.TabularDataset(*va), console=said.append,
                         device="cpu")
    assert resumed.resumed_from_epoch == 2
    assert [m.epoch for m in resumed.history] == [2]
