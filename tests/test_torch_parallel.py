"""The port's mesh, placement, data-parallel step, local SGD and
checkpoints across meshes (shifu_tpu_torch/parallel, train/step.py,
train/loop.py, train/checkpoint.py) against the JAX package on its virtual
8-device CPU mesh.

The port's ranks are gloo processes on the CPU (tests/torch_mesh_helpers:
spawned, a file store in tmp_path, one thread each, a deadline per group);
JAX's weights reach them through `params_from_jax`.  Tolerances:
- the data-parallel step against the port's world-1 step: rtol 1e-5,
  atol 1e-6 (the same math, other reduction orders);
- against JAX's data=4 sharded step: rtol 2e-5, atol 2e-6 (the JAX
  package's own data-parallel-against-one-device tolerance,
  tests/test_parallel.py), losses rtol 1e-5 (the port's f32 lockstep,
  tests/test_torch_train.py);
- local SGD over one epoch call against JAX's: rtol 1e-4, atol 1e-5 (8
  SGD updates, replicas averaged in another order);
- resumed across meshes against an unbroken run: rtol 1e-4, atol 1e-5 (3
  epochs of Adadelta).
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
from shifu_tpu.export.artifact import _flatten_params
from shifu_tpu.parallel import mesh as jax_mesh
from shifu_tpu.parallel import sharding as jax_sharding
from shifu_tpu.train import loop as jax_loop
from shifu_tpu.train import step as jax_step
from shifu_tpu_torch.config import schema as port_schema
from shifu_tpu_torch.config.schema import ConfigError, MeshConfig
from shifu_tpu_torch.data import pipeline as pipe
from shifu_tpu_torch.parallel import mesh as port_mesh
from shifu_tpu_torch.parallel import sharding as port_sharding
from shifu_tpu_torch.train import loop, step

F = 30


def _port(jjob):
    return port_schema.JobConfig.from_dict(json.loads(jjob.to_json())).validate()


def _mlp_jobs(optimizer="adam", lr=3e-3, **train_kw):
    jjob = jax_schema.JobConfig(
        schema=jax_synth.make_schema(num_features=F),
        data=jax_schema.DataConfig(batch_size=64, valid_ratio=0.1),
        model=jax_schema.ModelSpec(model_type="mlp", hidden_nodes=(16, 16),
                                   activations=("tanh", "tanh"),
                                   compute_dtype="float32"),
        train=jax_schema.TrainConfig(
            epochs=1, optimizer=jax_schema.OptimizerConfig(
                name=optimizer, learning_rate=lr), **train_kw)).validate()
    return jjob, _port(jjob)


def _batch(n=64, seed=0, weights="ones"):
    rng = np.random.default_rng(seed)
    w = np.ones((n, 1), np.float32)
    if weights == "skewed":
        # every quarter (one data shard of four) weighs differently, one
        # holds zero weights
        w[: n // 4] = 0.25
        w[n // 4: n // 2] = 3.0
        w[n // 2: 3 * n // 4] = 0.0
        w[3 * n // 4:] = rng.random((n - 3 * n // 4, 1)) + 0.5
    return {"features": rng.standard_normal((n, F)).astype(np.float32),
            "target": (rng.random((n, 1)) < 0.5).astype(np.float32),
            "weight": w}


def _flat(jstate) -> dict:
    return {k: np.asarray(v) for k, v in
            _flatten_params(jax.device_get(jstate.params)).items()}


def _jax_params(jstate) -> dict:
    return {"param/" + k.replace("/", "."): v
            for k, v in _flat(jstate).items()}


def _jax_mesh(cfg: jax_schema.MeshConfig):
    return jax_mesh.make_mesh(cfg, jax.devices()[:cfg.num_devices])


# -- mesh and placement, in the pytest process -----------------------------

@pytest.mark.parametrize("order", [("data", "seq", "pipe", "model"),
                                   ("model", "data", "seq", "pipe")])
def test_rank_layout_matches_jax_device_mesh(eight_devices, order):
    """Rank r sits where JAX puts device r: row-major over axis_order."""
    jm = jax_mesh.make_mesh(jax_schema.MeshConfig(data=4, model=2,
                                                  axis_order=order),
                            eight_devices)
    cfg = MeshConfig(data=4, model=2, axis_order=order)
    for pos, dev in np.ndenumerate(np.asarray(jm.devices)):
        m = port_mesh.Mesh(cfg, dev.id, {})
        assert tuple(m.coords[a] for a in jm.axis_names) == pos
        assert m.shape == dict(jm.shape)
    lines = port_mesh._lines({a: getattr(cfg, a) for a in order}, "model")
    assert all(len(line) == 2 for line in lines) and len(lines) == 4
    assert sorted(r for line in lines for r in line) == list(range(8))


def test_make_mesh_errors_match_jax(eight_devices):
    with pytest.raises(jax_schema.ConfigError) as jerr:
        jax_mesh.make_mesh(jax_schema.MeshConfig(data=3), eight_devices)
    with pytest.raises(ConfigError) as perr:
        port_mesh.make_mesh(MeshConfig(data=3), devices=8)
    assert str(perr.value) == str(jerr.value)
    # seq and pipe meshes lay ranks out as JAX lays its devices out
    for axes in (dict(data=2, seq=2), dict(data=2, pipe=2),
                 dict(seq=2, pipe=2, model=2)):
        jm = jax_mesh.make_mesh(jax_schema.MeshConfig(**axes), eight_devices[
            :int(np.prod(list(axes.values())))])
        for pos, dev in np.ndenumerate(np.asarray(jm.devices)):
            m = port_mesh.Mesh(MeshConfig(**axes), dev.id, {})
            assert tuple(m.coords[a] for a in jm.axis_names) == pos
            assert m.shape == dict(jm.shape)
    # a mesh of more than one rank needs the process group of its ranks
    with pytest.raises(ConfigError, match="process group"):
        port_mesh.make_mesh(MeshConfig(seq=2), devices=2)
    # JAX's remaining errors, with its messages
    for bad in (dict(seq=0), dict(pipe=0),
                dict(pipe=2, axis_order=("data", "seq", "model")),
                dict(seq=2, axis_order=("data", "pipe", "model"))):
        with pytest.raises(jax_schema.ConfigError) as jerr:
            jax_schema.MeshConfig(**bad).validate()
        with pytest.raises(ConfigError) as perr:
            MeshConfig(**bad).validate()
        assert str(perr.value) == str(jerr.value)
    # no process group: a mesh of one, no collectives
    m = port_mesh.make_mesh()
    assert m.size == 1 and m.group("data") is None and m.control is None


def test_host_shard_info_is_one_host(eight_devices):
    """Ranks share their host's files: (0, 1), JAX's single-host answer,
    never (rank, world) (ROADMAP.md section C)."""
    jm = _jax_mesh(jax_schema.MeshConfig(data=8))
    m = port_mesh.Mesh(MeshConfig(data=4, model=2), 5, {})
    assert port_mesh.host_shard_info(m) == jax_mesh.host_shard_info(jm) \
        == (0, 1)
    topo = port_mesh.dcn_topology(m)
    assert topo["devices"] == 8 and topo["slices"] == 1


@pytest.mark.parametrize("cards,want", [
    (["h0|A", "h0|B", "h1|A"], ("nccl", 1)),
    (["h0|A", "h0|B", "h0|A"], ("gloo", 2)),
    (["h0|A", "h0|A", "h0|A"], ("gloo", 3))])
def test_the_placement_takes_gloo_only_where_ranks_share_a_card(cards,
                                                                 want):
    """Each rank publishes (host, card) through the store; the group takes
    gloo as soon as two ranks name the same card, else NCCL."""
    from concurrent.futures import ThreadPoolExecutor

    from shifu_tpu_torch.parallel import distributed

    store = torch.distributed.HashStore()
    with ThreadPoolExecutor(len(cards)) as pool:
        got = list(pool.map(lambda r: distributed.placement_backend(
            store, len(cards), r, cards[r]), range(len(cards))))
    assert got == [want] * len(cards)


def test_shard_batch_and_blocks_match_jax_shards(eight_devices):
    cfg = jax_schema.MeshConfig(data=4, model=2)
    jm = _jax_mesh(cfg)
    batch = _batch(64, seed=1)
    blocks = {k: np.stack([v, v[::-1]]) for k, v in batch.items()}
    jb = jax_sharding.shard_batch(batch, jm)
    jbl = jax_sharding.shard_blocks(blocks, jm)
    for pos, dev in np.ndenumerate(np.asarray(jm.devices)):
        m = port_mesh.Mesh(MeshConfig(data=4, model=2), dev.id, {})
        got = port_sharding.shard_batch(batch, m)
        gotb = port_sharding.shard_blocks(blocks, m)
        for k in batch:
            want = [s.data for s in jb[k].addressable_shards
                    if s.device == dev][0]
            np.testing.assert_array_equal(got[k], np.asarray(want))
            wantb = [s.data for s in jbl[k].addressable_shards
                     if s.device == dev][0]
            np.testing.assert_array_equal(gotb[k], np.asarray(wantb))
        kept = port_sharding.shard_batch(batch, m, keep=("target",))
        assert kept["target"] is batch["target"]
    # process-local: two hosts each holding their half of the global
    # batch; each rank takes its rows out of its host's half, JAX's shard
    # of the global array built from the process-local data
    jpl = jax_sharding.shard_batch_process_local(batch, jm)
    jplb = jax_sharding.shard_blocks_process_local(blocks, jm)
    for pos, dev in np.ndenumerate(np.asarray(jm.devices)):
        m = port_mesh.Mesh(MeshConfig(data=4, model=2), dev.id, {})
        h = m.axis_index("data") // 2
        mine = port_sharding.shard_batch_process_local(
            {k: v[h * 32:(h + 1) * 32] for k, v in batch.items()}, m,
            hosts=(h, 2))
        mineb = port_sharding.shard_blocks_process_local(
            {k: v[:, h * 32:(h + 1) * 32] for k, v in blocks.items()}, m,
            hosts=(h, 2))
        for k in batch:
            want = [s.data for s in jpl[k].addressable_shards
                    if s.device == dev][0]
            np.testing.assert_array_equal(mine[k], np.asarray(want))
            wantb = [s.data for s in jplb[k].addressable_shards
                     if s.device == dev][0]
            np.testing.assert_array_equal(mineb[k], np.asarray(wantb))
    # a rank whose rows lie outside its host's slice is refused
    with pytest.raises(ConfigError, match="outside host 0"):
        port_sharding.shard_batch_process_local(
            batch, port_mesh.Mesh(MeshConfig(data=4, model=2), 7, {}),
            hosts=(0, 2))


def test_param_rules_and_placement_match_jax(eight_devices):
    cfg = jax_schema.MeshConfig(data=4, model=2)
    jm = _jax_mesh(cfg)
    rng = np.random.default_rng(2)
    f32 = np.float32
    jparams = {"embedding": {"table": rng.standard_normal((128, 16),
                                                          dtype=f32)},
               "dense": {"kernel": rng.standard_normal((16, 8), dtype=f32),
                         "bias": rng.standard_normal((8,), dtype=f32)}}
    pparams = {"embedding.table": jparams["embedding"]["table"],
               "dense.kernel": jparams["dense"]["kernel"],
               "dense.bias": jparams["dense"]["bias"]}
    jspecs = jax_sharding.param_specs(jparams, jax_sharding.DEFAULT_RULES)
    pspecs = port_sharding.param_specs(pparams, port_sharding.DEFAULT_RULES)
    assert pspecs["embedding.table"] == tuple(jspecs["embedding"]["table"])
    assert pspecs["dense.kernel"] == tuple(jspecs["dense"]["kernel"]) == ()
    placed = jax_sharding.place_params(jparams, jm, jax_sharding.DEFAULT_RULES)
    slots = {"embedding.table": (np.ones((128, 16)), np.zeros((128, 16))),
             "count": np.zeros(())}
    for dev_pos, dev in np.ndenumerate(np.asarray(jm.devices)):
        m = port_mesh.Mesh(MeshConfig(data=4, model=2), dev.id, {})
        got = port_sharding.place_params(pparams, m,
                                         port_sharding.DEFAULT_RULES)
        want = [s.data for s in placed["embedding"]["table"].addressable_shards
                if s.device == dev][0]
        np.testing.assert_array_equal(got["embedding.table"].numpy(),
                                      np.asarray(want))
        assert got["dense.kernel"].shape == (16, 8)
        opt = port_sharding.place_opt_state(slots, pparams, m,
                                            port_sharding.DEFAULT_RULES)
        assert opt["embedding.table"][0].shape == (64, 16)
        assert opt["count"] is slots["count"]


# -- the data-parallel step, 4 gloo ranks ------------------------------------

def test_dp_step_equals_jax_data4_and_world1(tmp_path, eight_devices):
    """A 4-rank step on a 64-row global batch: uniform weights, then
    weights that differ across the shards (one shard all zero), and with
    L2 and dropout on; against JAX's data=4 sharded step and the port's
    world-1 step; parameters and optimizer state bitwise equal across the
    ranks."""
    jmesh = _jax_mesh(jax_schema.MeshConfig(data=4))
    cases, jax_want, port_want = [], [], []
    for weights, model_kw in (("ones", {}), ("skewed", {}),
                              ("skewed", {"l2_scale": 1e-3})):
        jjob, pjob = _mlp_jobs()
        if model_kw:
            jjob = dataclasses.replace(jjob, model=dataclasses.replace(
                jjob.model, **model_kw)).validate()
            pjob = _port(jjob)
        batches = [_batch(64, seed=s, weights=weights) for s in (3, 4)]
        jstate = jax_loop.init_state(jjob, F, jmesh)
        flat = _flat(jstate)
        jtrain = jax_step.make_train_step(jjob, jmesh, donate=False)
        jl = []
        for b in batches:
            jstate, m = jtrain(jstate, jax_sharding.shard_batch(b, jmesh))
            jl.append(float(m["loss"]))
        jax_want.append((jl, _jax_params(jstate)))
        state = loop.init_state(pjob, F, "cpu")
        H.carry(state, flat, pjob)
        ptrain = step.make_train_step(pjob)
        pl = []
        for b in batches:
            state, m = ptrain(state, H.to_batch(b, pjob))
            pl.append(float(m["loss"]))
        port_want.append((pl, H.state_arrays(state)))
        cases.append((pjob, flat, batches))
    # dropout: a world of 4 applies the world-1 mask's rows
    _, pjob = _mlp_jobs()
    pjob = pjob.replace(model=dataclasses.replace(pjob.model,
                                                  dropout_rate=0.3))
    state = loop.init_state(pjob, F, "cpu")
    ptrain = step.make_train_step(pjob)
    batches = [_batch(64, seed=s, weights="skewed") for s in (5, 6)]
    pl = [float(ptrain(state, H.to_batch(b, pjob))[1]["loss"])
          for b in batches]
    port_want.append((pl, H.state_arrays(state)))
    cases.append((pjob, None, batches))

    ranks = H.run_ranks(H.dp_cases, 4, tmp_path, MeshConfig(data=4), cases)
    for i, (pl, pstate) in enumerate(port_want):
        for r, res in enumerate(ranks):
            got = res[i]
            np.testing.assert_allclose(got["losses"], pl, rtol=1e-5)
            for k, v in pstate.items():
                np.testing.assert_allclose(got["state"][k], v, rtol=1e-5,
                                           atol=1e-6, err_msg=f"{i} {k}")
                # replicated state stays bitwise equal across the ranks
                assert np.array_equal(got["state"][k],
                                      ranks[0][i]["state"][k]), (i, r, k)
    for i, (jl, jparams) in enumerate(jax_want):
        got = ranks[0][i]
        np.testing.assert_allclose(got["losses"], jl, rtol=1e-5)
        for k, v in jparams.items():
            np.testing.assert_allclose(got["state"][k], v, rtol=2e-5,
                                       atol=2e-6, err_msg=f"{i} {k}")


# -- local SGD -----------------------------------------------------------------

def _blocks(nb=8, seed=7):
    bs = [_batch(64, seed=seed + i) for i in range(nb)]
    return {k: np.stack([b[k] for b in bs]) for k in bs[0]}


def test_local_sgd_matches_jax_and_window_one_is_sync_dp(tmp_path,
                                                         eight_devices):
    """K=4 on data=4 over one staged call equals JAX's
    make_local_sgd_epoch_step on its data=4 mesh; K=1 equals synchronous
    data-parallel SGD (uniform weights)."""
    jmesh = _jax_mesh(jax_schema.MeshConfig(data=4))
    blocks = _blocks()
    cases, want = [], []
    for k in (4, 1, 0):
        jjob, pjob = _mlp_jobs("sgd", lr=0.05, local_sgd_window=k)
        jstate = jax_loop.init_state(jjob, F, jmesh)
        flat = _flat(jstate)
        if k == 4:
            jfn = jax_step.make_local_sgd_epoch_step(jjob, jmesh,
                                                     donate=False)
            jstate, acc = jfn(jstate, jax_sharding.shard_blocks(blocks,
                                                                jmesh))
            want.append((float(acc), _jax_params(jstate)))
        cases.append((pjob, flat, blocks, k > 0))
    ranks = H.run_ranks(H.epoch_cases, 4, tmp_path, MeshConfig(data=4),
                        cases)
    k4, k1, sync = (ranks[0][i] for i in range(3))
    loss_sum, jparams = want[0]
    assert k4["loss_sum"] == pytest.approx(loss_sum, rel=1e-5)
    assert k4["step"] == 8
    for key, v in jparams.items():
        np.testing.assert_allclose(k4["state"][key], v, rtol=1e-4,
                                   atol=1e-5, err_msg=key)
        for res in ranks:
            assert np.array_equal(res[0]["state"][key], k4["state"][key])
    for key in jparams:
        np.testing.assert_allclose(k1["state"][key], sync["state"][key],
                                   rtol=2e-4, atol=2e-5, err_msg=key)
    assert k1["loss_sum"] == pytest.approx(sync["loss_sum"], rel=1e-5)


# -- checkpoints across meshes ---------------------------------------------------

def _deepfm_job(tmp_dir, epochs):
    schema = jax_synth.make_schema(num_features=12, num_categorical=4,
                                   vocab_size=64)
    jjob = jax_schema.JobConfig(
        schema=schema, data=jax_schema.DataConfig(batch_size=64),
        model=jax_schema.ModelSpec(model_type="deepfm", hidden_nodes=(16,),
                                   activations=("relu",), embedding_dim=8,
                                   compute_dtype="float32"),
        train=jax_schema.TrainConfig(
            epochs=epochs, sparse_embedding_update="on",
            optimizer=jax_schema.OptimizerConfig(name="adadelta",
                                                 learning_rate=1.0)),
    ).validate()
    pjob = _port(jjob)
    return pjob.replace(runtime=dataclasses.replace(
        pjob.runtime, checkpoint=dataclasses.replace(
            pjob.runtime.checkpoint, directory=str(tmp_dir))))


def _deepfm_data():
    schema = jax_synth.make_schema(num_features=12, num_categorical=4,
                                   vocab_size=64)
    rows = jax_synth.make_rows(640, schema, seed=9)
    from shifu_tpu.data import reader as jax_reader
    cols = jax_reader.project_columns(rows, schema)
    arrays = (cols["features"], cols["target"], cols["weight"])
    return (tuple(a[:512] for a in arrays), tuple(a[512:] for a in arrays))


def test_resume_across_mesh_topologies(tmp_path):
    """A checkpoint of a data=2 x model=2 run (vocab-sharded tables and
    slots, gathered by the chief) resumes on data=4 and on one device,
    and each matches the unbroken run (tests/test_checkpoint.py:236)."""
    tr, va = _deepfm_data()
    d = tmp_path / "elastic"
    first = H.run_ranks(H.train_runs, 4, tmp_path,
                        MeshConfig(data=2, model=2),
                        [(_deepfm_job(d, 2), tr, va)])
    assert first[0][0]["history"][-1]["epoch"] == 1
    # the checkpoint holds the full tables, as a world-1 run writes them
    saved = torch.load(sorted((p for p in d.iterdir() if p.name.isdigit()),
                              key=lambda p: int(p.name))[-1] / "state.pt",
                       weights_only=True)
    assert tuple(saved["model"]["cat_embedding.embedding"].shape) == (4, 64, 8)
    assert tuple(saved["table_slots"]["cat_embedding.embedding"][0].shape) \
        == (4, 64, 8)
    assert first[1][0]["state"]["param/cat_embedding.embedding"].shape \
        == (4, 32, 8)

    second = H.run_ranks(H.train_runs, 4, tmp_path, MeshConfig(data=4),
                         [(_deepfm_job(d, 3), tr, va)])
    assert second[0][0]["resumed"] == 2
    assert [h["epoch"] for h in second[0][0]["history"]] == [2]
    third = loop.train(_deepfm_job(d, 4), pipe.TabularDataset(*tr),
                       pipe.TabularDataset(*va), console=lambda s: None,
                       device="cpu")
    assert third.resumed_from_epoch == 3
    assert [m.epoch for m in third.history] == [3]

    for epochs, got in ((3, second[0][0]["state"]),
                        (4, H.state_arrays(third.state))):
        ref = loop.train(_deepfm_job(tmp_path / f"straight{epochs}", epochs),
                         pipe.TabularDataset(*tr), pipe.TabularDataset(*va),
                         console=lambda s: None, device="cpu")
        for k, v in H.state_arrays(ref.state).items():
            np.testing.assert_allclose(got[k], v, rtol=1e-4, atol=1e-5,
                                       err_msg=f"{epochs} {k}")
    # every data rank of the data=4 run holds the same state
    for res in second[1:]:
        for k, v in second[0][0]["state"].items():
            assert np.array_equal(res[0]["state"][k], v), k
