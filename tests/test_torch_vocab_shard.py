"""Vocab-sharded embedding tables (shifu_tpu_torch/embed/shard.py,
models/embedding.sharded_lookup, train/sparse_embed.py on a mesh) against
the unsharded port and the JAX package (tests/test_embed_engine.py's
sharded update, a DeepFM on JAX's data=2 x model=2 mesh).

The port's ranks are gloo processes on the CPU (tests/torch_mesh_helpers).
Tolerances: the sharded lookup is the unsharded one bit for bit (each id
lands in one slice, the others add zeros), its gradient too; the sharded
update against the replicated references rtol 1e-6, atol 1e-7 (JAX's own
test); the DeepFM against JAX after 4 steps: losses rtol 1e-5, parameters
and slots rtol 1e-4, atol 1e-5 (the port's sparse lockstep,
tests/test_torch_embed_models.py).
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
from shifu_tpu.data import synthetic as jax_synth
from shifu_tpu.embed import attach_dedup as jax_attach_dedup
from shifu_tpu.export.artifact import _flatten_params
from shifu_tpu.models.embedding import field_layout as jax_field_layout
from shifu_tpu.ops import pallas_embedding as jax_emb
from shifu_tpu.parallel import mesh as jax_mesh
from shifu_tpu.parallel import sharding as jax_sharding
from shifu_tpu.train import loop as jax_loop
from shifu_tpu.train import sparse_embed as jax_sparse
from shifu_tpu.train import step as jax_step
from shifu_tpu_torch.config import schema as port_schema
from shifu_tpu_torch.config.schema import ConfigError, MeshConfig
from shifu_tpu_torch.embed.shard import (assert_vocab_sharded,
                                         make_sharded_rows_update)
from shifu_tpu_torch.ops import embedding as port_emb
from shifu_tpu_torch.parallel.mesh import Mesh
from shifu_tpu_torch.train import loop, sparse_embed

NC, V, D = 3, 64, 8


def test_sharded_lookup_and_gradient_are_the_unsharded_ones(tmp_path):
    """Ids inside, wrapped ([-V, 0), one of them a lower shard's id that a
    rebase would send below 0) and outside [-V, V) (a NaN row), on 4
    model ranks: the values of `_xla_lookup` and the port's plain lookup,
    the gradient of the unsharded lookup's on each slice."""
    rng = np.random.default_rng(0)
    table = rng.standard_normal((NC, V, D)).astype(np.float32)
    ids = rng.integers(0, V, (20, NC)).astype(np.int32)
    ids[0] = [-1, -V, V - 1]
    ids[1] = [V, -V - 1, 17]
    ids[2] = [-60, 5, 40]
    w = rng.standard_normal((20, NC, D)).astype(np.float32)

    want = port_emb.lookup_reference(torch.tensor(table), torch.tensor(ids))
    jwant = jax_emb.embedding_lookup(jnp.asarray(table), jnp.asarray(ids),
                                     use_pallas=False)
    np.testing.assert_array_equal(want.numpy(), np.asarray(jwant))
    full = torch.tensor(table).requires_grad_(True)
    out = port_emb.embedding_lookup(full, torch.tensor(ids))
    torch.where(torch.isfinite(out), out * torch.tensor(w), 0.0).sum() \
        .backward()

    ranks = H.run_ranks(H.lookup_checks, 4, tmp_path, MeshConfig(model=4),
                        table, ids, w)
    per = V // 4
    for res in ranks:
        np.testing.assert_array_equal(res["out"], want.numpy())
        s = res["model"]
        np.testing.assert_array_equal(
            res["grad"], full.grad.numpy()[:, s * per:(s + 1) * per])
    assert np.isnan(ranks[0]["out"][1, :2]).all()


def test_sharded_update_matches_replicated(tmp_path):
    """The counterpart of tests/test_embed_engine.py:200 on 4 model ranks:
    sgd and adadelta on each slice == the replicated update (the port's
    and JAX's `rows_update_reference`); each rank holds V/4 rows."""
    rng = np.random.default_rng(6)
    table = rng.standard_normal((NC, V, D)).astype(np.float32)
    dense_g = rng.standard_normal((NC, V, D)).astype(np.float32)
    from shifu_tpu_torch.embed.dedup import dedup_ids
    unique, _, _ = dedup_ids(rng.integers(0, V, (24, NC)).astype(np.int32),
                             sentinel=V)
    ranks = H.run_ranks(H.update_checks, 4, tmp_path, MeshConfig(model=4),
                        table, dense_g, unique, 0.5)
    order = sorted(ranks, key=lambda r: r["model"])
    safe = np.clip(unique, 0, V - 1)
    g_rows = np.stack([dense_g[f, safe[:, f]] for f in range(NC)], axis=1)
    for rule in ("sgd", "adadelta"):
        slots = ((np.zeros((NC, V, D), np.float32),) * 2
                 if rule == "adadelta" else ())
        ref_t, ref_s = port_emb.rows_update_reference(
            torch.tensor(table), tuple(torch.tensor(s) for s in slots),
            torch.tensor(g_rows), torch.tensor(unique), rule, 0.5)
        jref_t, jref_s = jax_emb.rows_update_reference(
            jnp.asarray(table), tuple(jnp.asarray(s) for s in slots),
            jnp.asarray(g_rows), jnp.asarray(unique), rule, 0.5)
        got_t = np.concatenate([r[rule][0] for r in order], axis=1)
        for res in order:
            assert res[rule][0].shape == (NC, V // 4, D)
        for want in (ref_t.numpy(), np.asarray(jref_t)):
            np.testing.assert_allclose(got_t, want, rtol=1e-6, atol=1e-7)
        for i, (a, b) in enumerate(zip(ref_s, jref_s)):
            got = np.concatenate([r[rule][1][i] for r in order], axis=1)
            np.testing.assert_allclose(got, a.numpy(), rtol=1e-6, atol=1e-7)
            np.testing.assert_allclose(got, np.asarray(b), rtol=1e-6,
                                       atol=1e-7)


def _deepfm_jobs(model=2, data=2, opt="adadelta", vocab=V, sparse="on"):
    schema = jax_synth.make_schema(num_features=10, num_categorical=4,
                                   vocab_size=vocab)
    jjob = jax_schema.JobConfig(
        schema=schema, data=jax_schema.DataConfig(batch_size=32),
        model=jax_schema.ModelSpec(model_type="deepfm", hidden_nodes=(8,),
                                   activations=("relu",), embedding_dim=8,
                                   compute_dtype="float32"),
        train=jax_schema.TrainConfig(
            epochs=1, loss="weighted_mse", sparse_embedding_update=sparse,
            optimizer=jax_schema.OptimizerConfig(name=opt,
                                                 learning_rate=0.5)),
        runtime=jax_schema.RuntimeConfig(
            mesh=jax_schema.MeshConfig(data=data, model=model)))
    pjob = port_schema.JobConfig.from_dict(json.loads(jjob.to_json()))
    return jjob, pjob


def test_indivisible_vocab_is_refused_as_in_jax():
    with pytest.raises(ValueError, match="divisible"):
        make_sharded_rows_update(None, nc=NC, vocab=50, shards=8, rule="sgd")
    jjob, pjob = _deepfm_jobs(model=3, data=1)
    with pytest.raises(jax_schema.ConfigError) as jerr:
        jax_sparse.resolve_plan(jjob)
    with pytest.raises(ConfigError) as perr:
        sparse_embed.resolve_plan(pjob)
    assert str(perr.value) == str(jerr.value)
    assert "divisible by the model axis (3)" in str(perr.value)
    with pytest.raises(AssertionError, match="vocab slice of 32 rows"):
        assert_vocab_sharded(torch.zeros((NC, V, D)), 2, V)


def test_deepfm_on_data2_model2_matches_jax(tmp_path, eight_devices):
    """4 steps of a DeepFM with vocab-sharded tables and the sparse
    Adadelta on data=2 x model=2, raw-id and deduped batches, against
    JAX's train step on the same mesh from the same parameters; each rank
    holds V/2 rows of every table and slot."""
    jjob, pjob = _deepfm_jobs()
    jmesh = jax_mesh.make_mesh(jjob.runtime.mesh, jax.devices()[:4])
    jstate = jax_loop.init_state(jjob, 10, jmesh)
    flat = {k: np.asarray(v) for k, v in
            _flatten_params(jax.device_get(jstate.params)).items()}
    jtrain = jax_step.make_train_step(jjob, jmesh, donate=False)
    dedup = jax_attach_dedup(jax_field_layout(jjob.schema), V)
    rng = np.random.default_rng(3)
    batches = []
    for i in range(4):
        f = rng.standard_normal((32, 10)).astype(np.float32)
        f[:, 6:] = rng.integers(0, V, (32, 4)).astype(np.float32)
        b = {"features": f,
             "target": (rng.random((32, 1)) < 0.5).astype(np.float32),
             "weight": (rng.random((32, 1)) + 0.5).astype(np.float32)}
        batches.append(dedup(b) if i % 2 else b)
    jl = []
    for b in batches:
        jstate, m = jtrain(jstate, jax_sharding.shard_batch(b, jmesh))
        jl.append(float(m["loss"]))
    want = {k.replace("/", "."): np.asarray(v) for k, v in
            _flatten_params(jax.device_get(jstate.params)).items()}
    jslots = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            jax.device_get(jstate.table_slots))[0]:
        keys = [getattr(p, "key", getattr(p, "idx", None)) for p in path]
        jslots[(".".join(str(k) for k in keys[:-1]), keys[-1])] = \
            np.asarray(leaf)

    ranks = H.run_ranks(H.dp_cases, 4, tmp_path, pjob.runtime.mesh,
                        [(pjob, flat, batches)])
    res = [r[0] for r in ranks]
    for r in res:
        np.testing.assert_allclose(r["losses"], jl, rtol=1e-5)
        for name in ("cat_embedding.embedding", "first_order_cat.embedding"):
            assert r["state"][f"param/{name}"].shape[1] == V // 2
            assert r["state"][f"slots/{name}/0"].shape[1] == V // 2
    row0 = sorted((r for r in res if r["coords"]["data"] == 0),
                  key=lambda r: r["coords"]["model"])
    for k, v in want.items():
        parts = [r["state"][f"param/{k}"] for r in row0]
        got = (np.concatenate(parts, axis=1) if parts[0].shape != v.shape
               else parts[0])
        np.testing.assert_allclose(got, v, rtol=1e-4, atol=1e-5, err_msg=k)
    for (name, i), v in jslots.items():
        got = np.concatenate([r["state"][f"slots/{name}/{i}"] for r in row0],
                             axis=1)
        np.testing.assert_allclose(got, v, rtol=1e-4, atol=1e-5,
                                   err_msg=f"{name} {i}")
    # the data ranks of each model slice hold the same bits
    for r in res:
        twin = [o for o in res if o["coords"]["model"] == r["coords"]["model"]]
        for k, v in r["state"].items():
            assert np.array_equal(v, twin[0]["state"][k]), k


def _moe_job():
    jjob = jax_schema.JobConfig(
        schema=jax_synth.make_schema(num_features=10),
        model=jax_schema.ModelSpec(model_type="moe_mlp", hidden_nodes=(8,),
                                   activations=("relu",), num_experts=2,
                                   compute_dtype="float32"),
        runtime=jax_schema.RuntimeConfig(
            mesh=jax_schema.MeshConfig(data=2, model=2)))
    return jjob, port_schema.JobConfig.from_dict(json.loads(jjob.to_json()))


def _ruled_job():
    jjob, pjob = _deepfm_jobs()
    rules = ((r".*trunk.*kernel", (None, "model")),)
    jjob = jjob.replace(runtime=dataclasses.replace(
        jjob.runtime, param_sharding_rules=rules))
    return jjob, pjob.replace(runtime=dataclasses.replace(
        pjob.runtime, param_sharding_rules=rules))


def _ft_pipe_jobs(batch_size, mesh, micro=0):
    jjob = jax_schema.JobConfig(
        schema=jax_synth.make_schema(num_features=7, num_categorical=2,
                                     vocab_size=16),
        data=jax_schema.DataConfig(batch_size=batch_size),
        model=jax_schema.ModelSpec(
            model_type="ft_transformer", hidden_nodes=(8,),
            activations=("relu",), token_dim=8, num_attention_heads=2,
            num_layers=2, pipeline_stages=2, pipeline_microbatches=micro,
            compute_dtype="float32"),
        runtime=jax_schema.RuntimeConfig(
            mesh=jax_schema.MeshConfig(**mesh)))
    return jjob, port_schema.JobConfig.from_dict(json.loads(jjob.to_json()))


def _trim(spec) -> tuple:
    out = tuple(spec)
    while out and out[-1] is None:
        out = out[:-1]
    return out


@pytest.mark.parametrize("what,make", [
    ("field-axis sharding",
     lambda: _deepfm_jobs(opt="adam", sparse="off")),
    ("MoE expert sharding", _moe_job),
    ("shifu.sharding.rules", _ruled_job),
    ("pipe axis", lambda: _ft_pipe_jobs(16, dict(data=1, pipe=4))),
    ("multiple of 8", lambda: _ft_pipe_jobs(12, dict(data=2, pipe=2),
                                            micro=4)),
])
def test_other_model_axis_placements_raise(what, make, eight_devices):
    """The JAX package's model-axis placements beyond vocab-sharded
    tables (the field axis of DEFAULT_RULES, MoE experts,
    `shifu.sharding.rules`) place every parameter on each rank of a
    data=2 x model=2 mesh as JAX does: the same spec and this rank's
    block of JAX's shape.  A pipe axis that disagrees with the stages and
    a batch that the microbatches do not divide raise JAX's ConfigError
    with its message."""
    jjob, pjob = make()
    jmesh = jax_mesh.make_mesh(jjob.runtime.mesh,
                               jax.devices()[:jjob.runtime.mesh.num_devices])
    if what in ("pipe axis", "multiple of 8"):
        with pytest.raises(jax_schema.ConfigError) as jerr:
            jax_loop.init_state(jjob, jjob.schema.feature_count, jmesh)
        with pytest.raises(ConfigError, match=what) as perr:
            loop.init_state(pjob, pjob.schema.feature_count, "cpu",
                            mesh=Mesh(pjob.runtime.mesh, 0, {}))
        assert str(perr.value) == str(jerr.value)
        return
    jstate = jax_loop.init_state(jjob, jjob.schema.feature_count, jmesh)
    jleaves = {jax.tree_util.keystr(kp): leaf for kp, leaf in
               jax.tree_util.tree_flatten_with_path(jstate.params)[0]}
    flat = _flatten_params(jax.device_get(jstate.params))
    by_name = dict(zip((k.replace("/", ".") for k in flat),
                       jleaves.values()))
    split = 0
    for dev in jmesh.devices.flat:
        state = loop.init_state(pjob, pjob.schema.feature_count, "cpu",
                                mesh=Mesh(pjob.runtime.mesh, dev.id, {}))
        params = dict(state.model.named_parameters())
        assert sorted(params) == sorted(by_name)
        for name, leaf in by_name.items():
            sh = state.shardings.get(name)
            assert (_trim(sh.spec) if sh else ()) == _trim(
                leaf.sharding.spec), name
            want = [s.data.shape for s in leaf.addressable_shards
                    if s.device == dev][0]
            assert tuple(params[name].shape) == tuple(want), name
            split += sh is not None
    assert split > 0
