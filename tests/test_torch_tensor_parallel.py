"""Tensor-parallel placements (shifu_tpu_torch/parallel/sharding.place_model
and sharding_rules, the field-split tables of models/embedding.py, the
experts of models/moe.py, train/step.py's reductions) against the JAX
package: the counterparts of tests/test_parallel.py's placement, local-SGD,
`shifu.sharding.rules` and expert-parallel tests, run on gloo ranks
(tests/torch_mesh_helpers, one spawn of 8 ranks re-formed into 4) and in
the pytest process.  JAX's weights reach the port through
`params_from_jax`.

Tolerances, JAX's own: a step against one device or JAX's mesh step rtol
2e-5, atol 2e-6, the loss rel 1e-5 (Adam's field-split DeepFM against
JAX's mesh step: rtol 1e-4, atol 1e-5, the port's Adam lockstep's); local
SGD over one epoch call rtol 1e-4, atol 1e-5 (PR 16's local-SGD test).
"""

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
from shifu_tpu.export.artifact import _flatten_params
from shifu_tpu.parallel import make_mesh as jax_make_mesh
from shifu_tpu.parallel import shard_batch as jax_shard_batch
from shifu_tpu.parallel.sharding import shard_blocks as jax_shard_blocks
from shifu_tpu.train import loop as jax_loop
from shifu_tpu.train import step as jax_step
from shifu_tpu.utils.xmlconfig import parse_sharding_rules as jax_rules
from shifu_tpu_torch.config import schema as port_schema
from shifu_tpu_torch.config.schema import ConfigError, MeshConfig
from shifu_tpu_torch.parallel import sharding as port_sharding
from shifu_tpu_torch.parallel.mesh import Mesh
from shifu_tpu_torch.train import loop
from shifu_tpu_torch.utils.xmlconfig import parse_sharding_rules

RULES = ".*hidden_layer0.*kernel.*=none,model; .*hidden_layer1.*kernel.*=model"


def _port(jjob):
    return port_schema.JobConfig.from_dict(
        json.loads(jjob.to_json())).validate()


def _flat(params) -> dict:
    return {k: np.asarray(v) for k, v in
            _flatten_params(jax.device_get(params)).items()}


def _names(flat: dict) -> dict:
    return {k.replace("/", "."): v for k, v in flat.items()}


def _jax_mesh(devices, **axes):
    return jax_make_mesh(jax_schema.MeshConfig(**axes),
                         devices=devices[:int(np.prod(list(axes.values())))])


def _mlp_jobs(mesh_cfg, clip=0.0):
    jjob = jax_schema.JobConfig(
        schema=jax_synth.make_schema(num_features=30),
        data=jax_schema.DataConfig(batch_size=64),
        model=jax_schema.ModelSpec(model_type="mlp", hidden_nodes=(16, 16),
                                   activations=("tanh", "tanh"),
                                   compute_dtype="float32"),
        train=jax_schema.TrainConfig(
            epochs=1, loss="weighted_mse",
            optimizer=jax_schema.OptimizerConfig(name="adadelta",
                                                 learning_rate=0.05,
                                                 grad_clip_norm=clip)),
        runtime=jax_schema.RuntimeConfig(
            mesh=jax_schema.MeshConfig(**mesh_cfg),
            param_sharding_rules=jax_rules(RULES)),
    ).validate()
    return jjob, _port(jjob)


def _moe_jobs():
    jjob = jax_schema.JobConfig(
        schema=jax_synth.make_schema(num_features=12),
        data=jax_schema.DataConfig(batch_size=32),
        model=jax_schema.ModelSpec(model_type="moe_mlp", hidden_nodes=(16, 8),
                                   activations=("relu", "relu"),
                                   num_experts=4, compute_dtype="float32"),
        train=jax_schema.TrainConfig(
            epochs=1, loss="weighted_mse",
            optimizer=jax_schema.OptimizerConfig(name="adadelta",
                                                 learning_rate=0.05)),
        runtime=jax_schema.RuntimeConfig(
            mesh=jax_schema.MeshConfig(data=2, model=4)),
    ).validate()
    return jjob, _port(jjob)


def _deepfm_jobs(mesh_cfg, opt="adam", lr=3e-3, window=0):
    jjob = jax_schema.JobConfig(
        schema=jax_synth.make_schema(num_features=10, num_categorical=4,
                                     vocab_size=64),
        data=jax_schema.DataConfig(batch_size=32),
        model=jax_schema.ModelSpec(model_type="deepfm", hidden_nodes=(8,),
                                   activations=("relu",), embedding_dim=8,
                                   compute_dtype="float32"),
        train=jax_schema.TrainConfig(
            epochs=1, loss="weighted_mse", local_sgd_window=window,
            sparse_embedding_update="off",
            optimizer=jax_schema.OptimizerConfig(name=opt,
                                                 learning_rate=lr)),
        runtime=jax_schema.RuntimeConfig(
            mesh=jax_schema.MeshConfig(**mesh_cfg)),
    ).validate()
    return jjob, _port(jjob)


def _deepfm_batch(n, seed):
    rng = np.random.default_rng(seed)
    f = rng.standard_normal((n, 10)).astype(np.float32)
    f[:, 6:] = rng.integers(0, 64, (n, 4)).astype(np.float32)
    return {"features": f,
            "target": (rng.random((n, 1)) < 0.5).astype(np.float32),
            "weight": (rng.random((n, 1)) + 0.5).astype(np.float32)}


def _deepfm_blocks(nb=4, seed=0):
    bs = [_deepfm_batch(32, seed + i) for i in range(nb)]
    return {k: np.stack([b[k] for b in bs]) for k in bs[0]}


def _rows(jjob, n, seed):
    return jax_reader.project_columns(
        jax_synth.make_rows(n, jjob.schema, seed=seed), jjob.schema)


def _jax_steps(jjob, jmesh, batches):
    """JAX's init on `jmesh` (None: one device) and its steps; (flat
    init params, losses, flat final params)."""
    state = jax_loop.init_state(
        jjob if jmesh is not None else jjob.replace(
            runtime=jax_schema.RuntimeConfig()),
        jjob.schema.feature_count, jmesh)
    flat = _flat(state.params)
    job = jjob if jmesh is not None else jjob.replace(
        runtime=jax_schema.RuntimeConfig())
    train = jax_step.make_train_step(job, jmesh, donate=False)
    losses = []
    for b in batches:
        put = (jax_shard_batch(b, jmesh) if jmesh is not None
               else {k: jnp.asarray(v) for k, v in b.items()})
        state, m = train(state, put)
        losses.append(float(m["loss"]))
    return flat, losses, _names(_flat(state.params))


def _jax_local_sgd(jjob, jmesh, blocks):
    state = jax_loop.init_state(jjob, jjob.schema.feature_count, jmesh)
    flat = _flat(state.params)
    fn = jax_step.make_local_sgd_epoch_step(jjob, jmesh, donate=False)
    state, acc = fn(state, jax_shard_blocks(blocks, jmesh))
    table = state.params["cat_embedding"]["embedding"]
    return flat, float(acc), _names(_flat(state.params)), \
        table.sharding.spec


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, eight_devices):
    """8 gloo ranks: the rules MLP on data=4 x model=2, the MoE on
    data=2 x model=4, local SGD of the field-split DeepFM on data=4 x
    model=2; then 4 of them: the field-split DeepFM on Adam and local SGD
    on data=2 x model=2."""
    tmp = tmp_path_factory.mktemp("tp")
    refs = {}
    jjob, pjob = _mlp_jobs(dict(data=4, model=2))
    batches = [_rows(jjob, 64, seed=5)]
    jm = _jax_mesh(eight_devices, data=4, model=2)
    flat, jl, jparams = _jax_steps(jjob, jm, batches)
    _, jl1, jparams1 = _jax_steps(jjob, None, batches)
    refs["mlp"] = (jl, jparams, jl1, jparams1)
    case_mlp = (pjob, flat, batches)
    jjob, pjob = _mlp_jobs(dict(data=4, model=2), clip=0.05)
    flat, jl, jparams = _jax_steps(jjob, jm, batches)
    refs["clip"] = (jl, jparams)
    case_clip = (pjob, flat, batches)

    jjob, pjob = _moe_jobs()
    batches = [_rows(jjob, 32, seed=4)]
    flat, jl, jparams = _jax_steps(jjob, _jax_mesh(eight_devices, data=2,
                                                   model=4), batches)
    _, jl1, jparams1 = _jax_steps(jjob, None, batches)
    refs["moe"] = (jl, jparams, jl1, jparams1)
    case_moe = (pjob, flat, batches)

    blocks = _deepfm_blocks()
    jjob, pjob = _deepfm_jobs(dict(data=4, model=2), "sgd", 0.01, window=2)
    flat, acc, jparams, spec = _jax_local_sgd(
        jjob, _jax_mesh(eight_devices, data=4, model=2), blocks)
    refs["local8"] = (acc, jparams, spec)
    case_local8 = (pjob, flat, blocks, True)

    jjob, pjob = _deepfm_jobs(dict(data=2, model=2))
    batches = [_deepfm_batch(32, seed=s) for s in (11, 12, 13)]
    flat, jl, jparams = _jax_steps(jjob, _jax_mesh(eight_devices, data=2,
                                                   model=2), batches)
    refs["adam"] = (jl, jparams)
    case_adam = (pjob, flat, batches)

    jjob, pjob = _deepfm_jobs(dict(data=2, model=2), "sgd", 0.01, window=2)
    flat, acc, jparams, spec = _jax_local_sgd(
        jjob, _jax_mesh(eight_devices, data=2, model=2), blocks)
    refs["local4"] = (acc, jparams, spec)
    case_local4 = (pjob, flat, blocks, True)

    steps = [
        (8, H.dp_cases, (MeshConfig(data=4, model=2), [case_mlp,
                                                        case_clip])),
        (8, H.dp_cases, (MeshConfig(data=2, model=4), [case_moe])),
        (8, H.epoch_cases, (MeshConfig(data=4, model=2), [case_local8])),
        (4, H.dp_cases, (MeshConfig(data=2, model=2), [case_adam])),
        (4, H.epoch_cases, (MeshConfig(data=2, model=2), [case_local4])),
    ]
    res = H.run_ranks(H.sequence, 8, tmp, str(tmp / "regroup"), steps,
                      timeout=240.0)
    return {"ranks": res, "refs": refs}


def _close(got: dict, want: dict, rtol, atol):
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=rtol, atol=atol,
                                   err_msg=k)


def _replicas_equal(res: list, axis: str):
    """The ranks that differ only along `axis` hold the same bits."""
    for r in res:
        key = {a: i for a, i in r["coords"].items() if a != axis}
        twin = next(o for o in res if {a: i for a, i in o["coords"].items()
                                       if a != axis} == key)
        for k, v in r["state"].items():
            assert np.array_equal(v, twin["state"][k]), k


def test_param_sharding_rules(eight_devices):
    """DEFAULT_RULES split an embedding table's first axis over `model`
    and replicate a dense kernel, as JAX places them."""
    from shifu_tpu.parallel import place_params as jax_place
    from shifu_tpu.parallel.sharding import DEFAULT_RULES as JAX_DEFAULT
    jm = _jax_mesh(eight_devices, data=4, model=2)
    placed = jax_place({"embedding": {"table": jnp.zeros((128, 16))},
                        "dense": {"kernel": jnp.zeros((16, 8))}}, jm,
                       JAX_DEFAULT)
    specs = port_sharding.param_specs(
        {"embedding.table": np.zeros((128, 16)),
         "dense.kernel": np.zeros((16, 8))}, port_sharding.DEFAULT_RULES)
    assert specs["embedding.table"] == tuple(
        placed["embedding"]["table"].sharding.spec) == ("model", None)
    assert specs["dense.kernel"] == tuple(
        placed["dense"]["kernel"].sharding.spec) == ()


def test_opt_state_follows_param_sharding(eight_devices):
    """A DeepFM on data=4 x model=2: the field-split table and its
    optimizer slots hold this rank's fields, as JAX places them."""
    jjob, pjob = _deepfm_jobs(dict(data=4, model=2), "adadelta", 0.01)
    jstate = jax_loop.init_state(jjob, 10, _jax_mesh(eight_devices, data=4,
                                                     model=2))
    jtable = jstate.params["cat_embedding"]["embedding"]
    assert jtable.sharding.spec[0] == "model"
    for rank in range(8):
        state = loop.init_state(pjob, 10, "cpu",
                                mesh=Mesh(pjob.runtime.mesh, rank, {}))
        assert state.shardings["cat_embedding.embedding"].spec == (
            "model", None, None)
        table = state.model.cat_embedding.embedding
        want = [s.data.shape for s in jtable.addressable_shards
                if s.device.id == rank][0]
        assert tuple(table.shape) == tuple(want) == (2, 64, 8)
        slots = [t for t in jax.tree_util.tree_leaves(
            state.optimizer.state_dict()) if isinstance(t, torch.Tensor)
            and tuple(t.shape) == (2, 64, 8)]
        assert len(slots) == 2


def test_opt_state_no_short_suffix_collision():
    """A slot matches its parameter by the longest name suffix only: one
    whose longest match differs in shape replicates, never taking an
    unrelated shorter name's block (JAX's place_opt_state)."""
    params = {"kernel": np.zeros((64, 8), np.float32),
              "dense.kernel": np.zeros((32, 8), np.float32)}
    opt = ({"kernel": np.zeros((64, 8), np.float32),
            "dense": {"kernel": np.zeros((64, 8), np.float32)}},)
    mesh = Mesh(MeshConfig(data=4, model=2), 1, {})
    placed = port_sharding.place_opt_state(
        opt, params, mesh, ((r"^kernel$", ("model", None)),))
    assert tuple(placed[0]["kernel"].shape) == (32, 8)
    assert placed[0]["dense"]["kernel"] is opt[0]["dense"]["kernel"]


def test_config_wired_tensor_parallel(ranks):
    """shifu.sharding.rules split the MLP's kernels over `model` on
    data=4 x model=2; the step equals JAX's on its mesh and the
    one-device step; the slots follow the blocks."""
    assert parse_sharding_rules(RULES) == jax_rules(RULES) == (
        (".*hidden_layer0.*kernel.*", (None, "model")),
        (".*hidden_layer1.*kernel.*", ("model",)))
    jl, jparams, jl1, jparams1 = ranks["refs"]["mlp"]
    res = [r[0][0] for r in ranks["ranks"]]
    k0 = "trunk.hidden_layer0.Dense_0.kernel"
    k1 = "trunk.hidden_layer1.Dense_0.kernel"
    for r in res:
        assert r["specs"][k0] == (None, "model")
        assert r["specs"][k1] == ("model", None)
        assert r["state"][f"param/{k0}"].shape == (30, 8)
        np.testing.assert_allclose(r["losses"], jl, rtol=1e-5)
        np.testing.assert_allclose(r["losses"], jl1, rtol=1e-5)
        slots = [v for k, v in r["state"].items()
                 if k.startswith("opt/") and v.shape == (30, 8)]
        assert len(slots) == 2
    for want in (jparams, jparams1):
        _close(res[0]["full"], want, 2e-5, 2e-6)
    _replicas_equal(res, "data")


def test_clipping_takes_the_global_norm_of_split_kernels(ranks):
    """Gradient clipping on the rule-split MLP clips by the norm of the
    whole gradients (each block's squares summed over its axis), as JAX's
    optax does on its mesh."""
    jl, jparams = ranks["refs"]["clip"]
    unclipped = ranks["refs"]["mlp"][1]
    assert any(not np.allclose(v, unclipped[k], rtol=1e-3)
               for k, v in jparams.items())  # the clip engaged
    res = [r[0][1] for r in ranks["ranks"]]
    for r in res:
        np.testing.assert_allclose(r["losses"], jl, rtol=1e-5)
    _close(res[0]["full"], jparams, 2e-5, 2e-6)
    _replicas_equal(res, "data")


@pytest.mark.parametrize("rule,err", [
    ((".*kernel.*", ("bogus",)), "bogus"),
    ((".*[kernel=", ("data",)), "bad path regex"),
])
def test_sharding_rules_bad_axis_and_regex(eight_devices, rule, err):
    """A rule naming an axis the mesh lacks, or a bad regex, raises JAX's
    ConfigError; the rules survive a JSON round trip."""
    jjob, pjob = _mlp_jobs(dict(data=4, model=2))
    jjob = jjob.replace(runtime=jax_schema.RuntimeConfig(
        mesh=jjob.runtime.mesh, param_sharding_rules=(rule,)))
    pjob = _port(jjob)
    assert port_schema.JobConfig.from_json(pjob.to_json()) == pjob
    with pytest.raises(jax_schema.ConfigError, match=err) as jerr:
        jax_loop.init_state(jjob, 30, _jax_mesh(eight_devices, data=4,
                                                model=2))
    with pytest.raises(ConfigError, match=err) as perr:
        loop.init_state(pjob, 30, "cpu", mesh=Mesh(pjob.runtime.mesh, 0, {}))
    assert str(perr.value) == str(jerr.value)


def test_expert_parallel_matches_single_device(ranks):
    """moe_mlp on data=2 x model=4: each rank holds one expert of every
    expert leaf and of its slots; the step equals JAX's on its mesh and
    the one-device step."""
    jl, jparams, jl1, jparams1 = ranks["refs"]["moe"]
    res = [r[1][0] for r in ranks["ranks"]]
    for r in res:
        assert r["specs"]["experts.kernel0"] == ("model", None, None)
        assert r["state"]["param/experts.kernel0"].shape == (1, 12, 16)
        assert "gate.Dense_0.kernel" not in r["specs"]
        slots = [v for k, v in r["state"].items()
                 if k.startswith("opt/") and v.shape == (1, 12, 16)]
        assert len(slots) == 2
        np.testing.assert_allclose(r["losses"], jl, rtol=1e-5)
        np.testing.assert_allclose(r["losses"], jl1, rtol=1e-5)
    for want in (jparams, jparams1):
        _close(res[0]["full"], want, 2e-5, 2e-6)
    _replicas_equal(res, "data")


@pytest.mark.parametrize("step_no,key,mesh", [
    (2, "local8", dict(data=4, model=2)),
    (4, "local4", dict(data=2, model=2)),
])
def test_local_sgd_composes_with_tensor_parallel(ranks, step_no, key, mesh):
    """Local SGD (window 2) of the field-split DeepFM: the tables stay
    split over `model` after the call, and the loss sum and the averaged
    replicas equal JAX's make_local_sgd_epoch_step on its mesh."""
    acc, jparams, jspec = ranks["refs"][key]
    assert jspec[0] == "model"
    n = mesh["data"] * mesh["model"]
    res = [r[step_no][0] for r in ranks["ranks"][:n]]
    for r in res:
        assert r["specs"]["cat_embedding.embedding"] == ("model", None, None)
        assert r["state"]["param/cat_embedding.embedding"].shape == (
            4 // mesh["model"], 64, 8)
        assert r["loss_sum"] == pytest.approx(acc, rel=1e-5)
        assert r["step"] == 4
    _close(res[0]["full"], jparams, 1e-4, 1e-5)
    _replicas_equal(res, "data")


def test_field_axis_deepfm_matches_jax(ranks):
    """Three Adam steps of a DeepFM (sparse plan off) on data=2 x model=2:
    each model rank looks up its two fields and holds them, their slots
    too; the steps equal JAX's on its data=2 x model=2 mesh."""
    jl, jparams = ranks["refs"]["adam"]
    res = [r[3][0] for r in ranks["ranks"][:4]]
    for r in res:
        for name in ("cat_embedding.embedding", "first_order_cat.embedding"):
            assert r["specs"][name] == ("model", None, None)
            assert r["state"][f"param/{name}"].shape[0] == 2
        assert r["specs"]["numeric_embedding.weight"] == ("model", None)
        np.testing.assert_allclose(r["losses"], jl, rtol=1e-5)
        slots = [v for k, v in r["state"].items()
                 if k.startswith("opt/") and v.shape == (2, 64, 8)]
        assert len(slots) == 2  # Adam's two moments of the local fields
    _close(res[0]["full"], jparams, 1e-4, 1e-5)
    _replicas_equal(res, "data")
