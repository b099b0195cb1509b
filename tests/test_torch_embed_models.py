"""Wide&Deep and DeepFM in the port (models/wide_deep.py, models/deepfm.py,
embed/dedup.py, train/sparse_embed.py and the trainer's sparse path)
against the JAX package's, on the CPU at small sizes.

Inputs are made with numpy from a seed and handed to both packages; the
port carries the JAX package's initial parameters (`params_from_jax`).
Tolerances:
- forward, f32: 2e-5 (summation order); bf16 compute: 2e-2 (activations
  round to bf16 between ops on both sides, at other points);
- the train step with the sparse update, f32, 10 steps: per-step losses
  rtol 1e-5, every parameter and table slot after the 10 steps rtol 1e-4
  atol 1e-5 (summation order, and the update's multiply-adds, which XLA
  may contract into FMAs);
- `train()` end to end, f32: per-epoch train_error and valid_error rel
  1e-4, valid_auc within 1e-3;
- artifacts: scores within 1e-5.
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
from shifu_tpu.data import reader as jax_reader
from shifu_tpu.data import synthetic as jax_synth
from shifu_tpu.embed import dedup as jax_dedup
from shifu_tpu.export.artifact import _flatten_params
from shifu_tpu.models import embedding as jax_embedding
from shifu_tpu.models.registry import build_model as jax_build_model
from shifu_tpu.train import loop as jax_loop
from shifu_tpu.train import sparse_embed as jax_sparse
from shifu_tpu.train import step as jax_step
from shifu_tpu_torch.config import schema as port_schema
from shifu_tpu_torch.config.schema import ConfigError
from shifu_tpu_torch.data import pipeline as pipe
from shifu_tpu_torch.embed import dedup
from shifu_tpu_torch.export.artifact import params_from_jax, save_artifact
from shifu_tpu_torch.export.scorer import TorchScorer
from shifu_tpu_torch.models import embedding
from shifu_tpu_torch.models.registry import build_model
from shifu_tpu_torch.ops import embedding as emb
from shifu_tpu_torch.train import loop, sparse_embed, step

F, NC, VOCAB = 9, 3, 20
BATCH = 16


def _schema(vocab=VOCAB, nc=NC, f=F):
    return jax_synth.make_schema(num_features=f, num_categorical=nc,
                                 vocab_size=vocab)


def _port_schema(jschema):
    return port_schema._from_dict(port_schema.DataSchema,
                                  dataclasses.asdict(jschema))


def _rows(rng, n, f=F, nc=NC, vocab=VOCAB):
    """Numeric features and ids: in range, past the vocab, negative and
    fractional."""
    x = rng.normal(size=(n, f)).astype(np.float32)
    x[:, f - nc:] = rng.integers(0, vocab, size=(n, nc))
    odd = rng.random((n, nc)) < 0.2
    x[:, f - nc:][odd] = rng.choice(
        np.array([vocab, vocab + 7, -1, 2.5, 0.9], np.float32),
        size=int(odd.sum()))
    return x


def _spec_kw(model_type, cdt="float32", pdt="float32"):
    return dict(model_type=model_type, hidden_nodes=(8, 6),
                activations=("relu", "tanh"), embedding_dim=4,
                compute_dtype=cdt, param_dtype=pdt)


def _pair(spec_kw, seed=0, jschema=None):
    """(jax forward, jax params, port model) sharing the Flax params."""
    jschema = jschema or _schema()
    jmodel = jax_build_model(jax_schema.ModelSpec(**spec_kw), jschema)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(seed),
                                  jnp.zeros((2, jschema.feature_count)))[
        "params"]
    model = build_model(port_schema.ModelSpec(**spec_kw),
                        _port_schema(jschema), device="cpu")
    model.load_state_dict(params_from_jax(_flatten_params(params), model))
    apply = jax.jit(jmodel.apply)
    return (lambda x: np.asarray(apply({"params": params}, jnp.asarray(x))),
            params, model)


# -- the models -------------------------------------------------------------------

@pytest.mark.parametrize("cdt,tol", [("float32", 2e-5), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("model_type", ["wide_deep", "deepfm"])
def test_model_matches_jax(model_type, cdt, tol):
    jfwd, params, model = _pair(_spec_kw(model_type, cdt))
    x = _rows(np.random.default_rng(1), 12)
    with torch.inference_mode():
        got = model(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (12, 1)
    np.testing.assert_allclose(got.numpy(), jfwd(x), rtol=tol, atol=tol)
    # the Flax tree's names and shapes, key for key
    assert {k.replace(".", "/"): tuple(v.shape)
            for k, v in model.state_dict().items()} == {
        k: tuple(v.shape) for k, v in _flatten_params(params).items()}


@pytest.mark.parametrize("model_type,names", [
    ("wide_deep", ("deep_embedding", "wide_cat_embedding")),
    ("deepfm", ("cat_embedding", "first_order_cat"))])
def test_fused_lookup_equals_separate_lookups(monkeypatch, model_type,
                                              names):
    """One lookup of the concatenated tables gives each table's own lookup,
    bitwise; so does the JAX package's separate-lookup route (its
    SHIFU_TPU_PALLAS opt-in, through its Pallas kernel in interpret
    mode), which the port does not take."""
    _, params, model = _pair(_spec_kw(model_type, "bfloat16"))
    x = _rows(np.random.default_rng(2), 10)
    _, ids = embedding.split_features(torch.from_numpy(x), model.layout)
    embeds = [getattr(model, n) for n in names]
    with torch.no_grad():
        fused = embedding.fused_lookup(embeds, ids)
        for got, e in zip(fused, embeds):
            assert torch.equal(got, e(ids))
    monkeypatch.setenv("SHIFU_TPU_PALLAS", "1")
    jembeds = [jax_embedding.CategoricalEmbed(
        layout=jax_embedding.field_layout(_schema()), dim=e.dim,
        compute_dtype="bfloat16") for e in embeds]
    for got, je, n in zip(fused, jembeds, names):
        want = je.apply({"params": {"embedding": params[n]["embedding"]}},
                        jnp.asarray(ids.numpy()))
        np.testing.assert_array_equal(
            got.view(torch.int16).numpy(),
            np.asarray(want).view(np.int16))


# -- dedup -------------------------------------------------------------------------

def test_host_ids_follow_split_features():
    """host_ids gives the ids the forward gathers, for NaN, negative,
    fractional and huge ids.  The JAX package's host_ids casts first and
    clips after, so a float of 2^31 or more becomes INT_MIN and then 0,
    where the forward (the port's and XLA's saturating cast) uses
    vocab - 1: the port follows its forward."""
    layout = embedding.field_layout(_port_schema(_schema()))
    x = np.zeros((8, F), np.float32)
    x[:, F - NC:] = np.array(
        [[np.nan, -3, 2.9], [0.5, 19.99, 20], [2.0 ** 31, 1e30, -1e30],
         [np.inf, -np.inf, 7], [-0.5, 3, 4], [5, 6, 1e9], [3e9, 0, 1],
         [19, 18, 17]], np.float32)
    got = dedup.host_ids(x, layout)
    want = embedding.split_features(torch.from_numpy(x), layout)[1].numpy()
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32
    assert got[2, 0] == VOCAB - 1
    jlayout = jax_embedding.field_layout(_schema())
    with np.errstate(invalid="ignore"):   # numpy's cast of 2^31 and NaN
        assert jax_dedup.host_ids(x, jlayout)[2, 0] == 0
    sane = x[[1, 4, 7]]
    np.testing.assert_array_equal(dedup.host_ids(sane, layout),
                                  jax_dedup.host_ids(sane, jlayout))


def test_dedup_ids_compaction_and_inverse():
    rng = np.random.default_rng(3)
    ids = rng.integers(0, VOCAB, (32, NC)).astype(np.int32)
    unique, inverse, counts = dedup.dedup_ids(ids, sentinel=VOCAB)
    for got, want in zip((unique, inverse, counts),
                         jax_dedup.dedup_ids(ids, sentinel=VOCAB)):
        np.testing.assert_array_equal(got, want)
    for f in range(NC):
        u = int(counts[f])
        assert u == np.unique(ids[:, f]).size
        assert (unique[u:, f] == VOCAB).all()
        np.testing.assert_array_equal(unique[inverse[:, f], f], ids[:, f])
    with pytest.raises(ValueError, match="capacity"):
        dedup.dedup_ids(ids, VOCAB, capacity=2)


def test_attach_dedup_and_dedup_lookup():
    """The transform adds the two keys and counts; the lookup through the
    compacted ids gives the raw lookup's values (the sentinel rows come
    back NaN and are never selected) and its gradient within f32
    summation order."""
    layout = embedding.field_layout(_port_schema(_schema()))
    x = _rows(np.random.default_rng(4), 24)
    tf = dedup.attach_dedup(layout, VOCAB)
    out = tf({"features": x, "target": np.zeros((24, 1), np.float32)})
    assert tf({"target": 1}) == {"target": 1}
    u = torch.from_numpy(out[dedup.UNIQUE_KEY])
    inv = torch.from_numpy(out[dedup.INVERSE_KEY])
    assert u.shape == (24, NC) and inv.shape == (24, NC)
    st = tf.dedup_state
    assert st["batches"] == 1 and st["cells"] == 24 * NC
    assert st["unique"] == int((u < VOCAB).sum())
    table = torch.randn((NC, VOCAB, 4), generator=torch.Generator()
                        .manual_seed(0), requires_grad=True)
    ids = torch.from_numpy(dedup.host_ids(x, layout))
    raw = emb.embedding_lookup(table, ids)
    dd = dedup.dedup_lookup(table, u, inv)
    assert torch.equal(raw, dd)
    g = torch.randn(raw.shape, generator=torch.Generator().manual_seed(1))
    ga = torch.autograd.grad(raw, table, g)[0]
    gb = torch.autograd.grad(dd, table, g)[0]
    torch.testing.assert_close(ga, gb, rtol=1e-6, atol=1e-6)


# -- the plan ----------------------------------------------------------------------

def _jobs(model_type="deepfm", opt="adadelta", sparse="on", lr=0.5,
          vocab=VOCAB, staged=True, dedup_mode="auto", epochs=2, **kw):
    """The same job for both packages (the port's parsed from the JAX
    job's dict)."""
    train_kw = kw.pop("train_kw", {})
    jjob = jax_schema.JobConfig(
        schema=_schema(vocab),
        data=jax_schema.DataConfig(batch_size=BATCH, staged=staged),
        model=jax_schema.ModelSpec(**_spec_kw(model_type)),
        train=jax_schema.TrainConfig(
            epochs=epochs, loss="weighted_mse",
            optimizer=jax_schema.OptimizerConfig(name=opt, learning_rate=lr,
                                                 **kw),
            sparse_embedding_update=sparse, **train_kw),
        embed=jax_schema.EmbedConfig(dedup=dedup_mode)).validate()
    pjob = port_schema.JobConfig.from_dict(json.loads(jjob.to_json()))
    return jjob, pjob.validate()


def test_plan_gating_follows_jax_blockers():
    for kw, match in ((dict(opt="adam"), "sparse rule"),
                      (dict(model_type="mlp"), "stacked embedding"),
                      (dict(grad_clip_norm=1.0), "grad_clip_norm"),
                      (dict(accumulate_steps=2), "accumulation")):
        jjob, pjob = _jobs(**kw)
        for resolve in (jax_sparse.resolve_plan, sparse_embed.resolve_plan):
            job = jjob if resolve is jax_sparse.resolve_plan else pjob
            with pytest.raises(Exception, match=match) as e:
                resolve(job)
            assert isinstance(e.value, ValueError)
    _, pjob = _jobs()
    numeric = dataclasses.replace(pjob, schema=_port_schema(
        jax_synth.make_schema(num_features=F)))
    with pytest.raises(ConfigError, match="categorical"):
        sparse_embed.resolve_plan(numeric)
    plan = sparse_embed.resolve_plan(pjob)
    assert (plan.rule, plan.learning_rate, plan.max_vocab) == (
        "adadelta", 0.5, VOCAB)
    assert sparse_embed.resolve_plan(_jobs(sparse="off")[1]) is None
    assert sparse_embed.resolve_plan(_jobs(sparse="auto")[1]) is None
    sharded = dataclasses.replace(pjob, runtime=dataclasses.replace(
        pjob.runtime, mesh=dataclasses.replace(pjob.runtime.mesh, model=2)))
    with pytest.raises(NotImplementedError, match=r"queue A item \(f\)"):
        sparse_embed.resolve_plan(sharded)


def test_auto_engages_at_100k_vocab_on_any_device(monkeypatch):
    """Deliberate difference (ROADMAP.md section C): "auto" engages the
    sparse update once the largest vocab reaches 100,000, whatever the
    device (kernel #6 on the card, its plain version on the CPU); the JAX
    package also wants a TPU with D % 128 == 0, or its Pallas opt-in."""
    monkeypatch.delenv("SHIFU_TPU_PALLAS", raising=False)
    for vocab, want in ((99_999, False), (100_000, True)):
        jjob, pjob = _jobs(sparse="auto", vocab=vocab)
        assert (sparse_embed.resolve_plan(pjob) is not None) == want
        assert jax_sparse.resolve_plan(jjob) is None
    state = loop.init_state(pjob, F, "cpu")
    assert set(state.table_slots) == {"cat_embedding.embedding",
                                      "first_order_cat.embedding"}


@pytest.mark.parametrize("opt,n_slots", [("adadelta", 2), ("sgd", 0)])
def test_state_structure(opt, n_slots):
    """The optimizer holds every parameter but the tables; the tables'
    slots are f32 zeros on `table_slots`; a dense job has none."""
    _, pjob = _jobs(opt=opt)
    state = loop.init_state(pjob, F, "cpu")
    tables = {n: p for n, p in state.model.named_parameters()
              if n.endswith("embedding") and p.dim() == 3}
    assert set(state.table_slots) == set(tables)
    assert not any(p is t for p in state.optimizer.params
                   for t in tables.values())
    assert len(state.optimizer.params) == len(
        list(state.model.parameters())) - len(tables)
    for name, slots in state.table_slots.items():
        assert len(slots) == n_slots
        for s in slots:
            assert s.dtype == torch.float32 and not s.any()
            assert s.shape == tables[name].shape
    dense = loop.init_state(_jobs(opt=opt, sparse="off")[1], F, "cpu")
    assert dense.table_slots is None
    assert len(dense.optimizer.params) == len(
        list(dense.model.parameters()))


# -- training against JAX -----------------------------------------------------------

def _carry(jstate, pjob, init_state=loop.init_state):
    state = init_state(pjob, F, "cpu")
    flat = {k: np.asarray(v) for k, v in
            _flatten_params(jax.device_get(jstate.params)).items()}
    state.model.load_state_dict(params_from_jax(flat, state.model))
    return state


def _slot_leaves(jstate):
    """JAX's table slots by the port's parameter name."""
    out = {}
    for kp, leaf in jax.tree_util.tree_flatten_with_path(
            jstate.table_slots)[0]:
        names = [getattr(k, "key", getattr(k, "idx", None)) for k in kp]
        out.setdefault(".".join(names[:-1]), {})[names[-1]] = leaf
    return {k: tuple(np.asarray(v[i]) for i in sorted(v))
            for k, v in out.items()}


@pytest.mark.parametrize("pallas", [False, True])
@pytest.mark.parametrize("with_dedup", [True, False])
@pytest.mark.parametrize("model_type,opt", [
    ("deepfm", "adadelta"), ("deepfm", "sgd"), ("wide_deep", "adadelta")])
def test_sparse_train_step_lockstep(monkeypatch, model_type, opt,
                                    with_dedup, pallas):
    """10 steps of `make_train_step` with the sparse update on, from the
    same params, on the same batches, with and without the dedup keys.
    With SHIFU_TPU_PALLAS the JAX package runs its Pallas lookup (tables
    looked up one by one) and, on deduped batches, its Pallas rows update,
    in interpret mode; without it, its XLA references."""
    if pallas:
        monkeypatch.setenv("SHIFU_TPU_PALLAS", "1")
    else:
        monkeypatch.delenv("SHIFU_TPU_PALLAS", raising=False)
    lr = 0.1 if opt == "sgd" else 0.5
    jjob, pjob = _jobs(model_type, opt, lr=lr)
    jstate = jax_loop.init_state(jjob, F)
    state = _carry(jstate, pjob)
    jtrain = jax_step.make_train_step(jjob)
    ptrain = step.make_train_step(pjob)
    layout = embedding.field_layout(pjob.schema)
    tf = dedup.attach_dedup(layout, VOCAB)
    rng = np.random.default_rng(5)
    jl, pl = [], []
    for _ in range(10):
        b = {"features": _rows(rng, BATCH),
             "target": (rng.random((BATCH, 1)) < 0.5).astype(np.float32),
             "weight": np.ones((BATCH, 1), np.float32)}
        if with_dedup:
            b = tf(b)
        jstate, jm = jtrain(jstate, {k: jnp.asarray(v) for k, v in
                                     b.items()})
        state, pm = ptrain(state, loop.to_device(b, pjob,
                                                 torch.device("cpu")))
        jl.append(float(jm["loss"]))
        pl.append(float(pm["loss"]))
    assert state.step == 10
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    want = {k.replace("/", "."): np.asarray(v) for k, v in
            _flatten_params(jax.device_get(jstate.params)).items()}
    for k, v in state.model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    jslots = _slot_leaves(jstate) if opt == "adadelta" else {}
    for name, slots in state.table_slots.items():
        assert len(slots) == (2 if opt == "adadelta" else 0)
        for a, b in zip(slots, jslots.get(name, ())):
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-4, atol=1e-5,
                                       err_msg=name)


def _datasets(n_train=640, n_valid=200, seed=0):
    schema = _schema()
    rows = jax_synth.make_rows(n_train + n_valid, schema, seed=seed)
    cols = jax_reader.project_columns(rows, schema)

    def part(lo, hi, mod):
        return mod.TabularDataset(cols["features"][lo:hi],
                                  cols["target"][lo:hi],
                                  cols["weight"][lo:hi])
    return ((part(0, n_train, jax_pipe), part(n_train, None, jax_pipe)),
            (part(0, n_train, pipe), part(n_train, None, pipe)))


@pytest.mark.parametrize("model_type", ["deepfm", "wide_deep"])
@pytest.mark.parametrize("tier,staged", [("batch", False),
                                         ("resident", True)])
def test_train_matches_jax_train(monkeypatch, tmp_path, model_type, tier,
                                 staged):
    """`train()` with the sparse update against JAX `train()` from the same
    params, f32: on the per-batch tier each batch's ids are compacted
    (dedup) in both packages; on the resident tier both update from the
    raw ids.  Then the trained model's artifact scores the same through
    the port's `TorchScorer` and the JAX package's `JaxScorer`."""
    from shifu_tpu.export.scorer import JaxScorer
    monkeypatch.delenv("SHIFU_TPU_PALLAS", raising=False)
    jjob, pjob = _jobs(model_type, staged=staged)
    (jtr, jva), (ptr, pva) = _datasets()
    jres = jax_loop.train(jjob, jtr, jva, console=lambda s: None)
    jinit = jax_loop.init_state(jjob, F)
    real_init = loop.init_state
    monkeypatch.setattr(loop, "init_state", lambda job, n, device=None:
                        _carry(jinit, job, real_init))
    pres = loop.train(pjob, ptr, pva, console=lambda s: None, device="cpu")
    assert pres.tier == tier
    if tier == "batch":
        assert pres.dedup["batches"] == 2 * (640 // BATCH)
        assert 0 < pres.dedup["unique"] < pres.dedup["cells"]
    else:
        assert pres.dedup is None
    assert len(pres.history) == len(jres.history) == 2
    for g, w in zip(pres.history, jres.history):
        assert g.train_error == pytest.approx(w.train_error, rel=1e-4)
        assert g.valid_error == pytest.approx(w.valid_error, rel=1e-4)
        assert abs(g.valid_auc - w.valid_auc) <= 1e-3
    out = save_artifact(pres.state.model, pjob.model, pjob.schema,
                        str(tmp_path / model_type))
    x = pva.features[:50]
    np.testing.assert_allclose(
        TorchScorer(out, device="cpu").compute_batch(x),
        JaxScorer(out).compute_batch(x), rtol=1e-5, atol=1e-5)


# -- artifacts -----------------------------------------------------------------------

@pytest.mark.parametrize("model_type", ["wide_deep", "deepfm"])
def test_jax_saved_artifact_scores_in_the_port(tmp_path, model_type):
    """An artifact the JAX package wrote (with its op-list program) loads
    into the port and scores as the JAX package's own scorers do."""
    from shifu_tpu.export.artifact import save_artifact as jax_save
    from shifu_tpu.export.scorer import JaxScorer, Scorer
    jjob, _ = _jobs(model_type)
    jfwd, params, _ = _pair(_spec_kw(model_type))
    out = jax_save(params, jjob, str(tmp_path / "jax"))
    x = _rows(np.random.default_rng(6), 40)
    got = TorchScorer(out, device="cpu").compute_batch(x)
    np.testing.assert_allclose(got, JaxScorer(out).compute_batch(x),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, Scorer(out).compute_batch(x), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("model_type", ["wide_deep", "deepfm"])
def test_port_saved_artifact_served_by_the_daemon(tmp_path, model_type):
    """A port-saved artifact of a model with bf16 compute and bf16
    parameters (written as f32, exactly) serves through the daemon; the
    scorer rebuilds the bf16 parameters bit for bit."""
    from shifu_tpu_torch.config.schema import ServingConfig
    from shifu_tpu_torch.runtime.serve import ScoringDaemon
    kw = _spec_kw(model_type, "bfloat16", "bfloat16")
    _, _, model = _pair(kw)
    out = save_artifact(model, port_schema.ModelSpec(**kw),
                        _port_schema(_schema()), str(tmp_path / "port"))
    x = _rows(np.random.default_rng(7), 24)
    scorer = TorchScorer(out, device="cpu")
    for k, v in model.state_dict().items():
        assert torch.equal(scorer.model.state_dict()[k], v), k
    want = scorer.compute_batch(x)
    daemon = ScoringDaemon(out, config=ServingConfig(max_batch=16),
                           device="cpu").start()
    try:
        futs = [daemon.submit(row) for row in x]
        got = np.stack([f.result(timeout=30) for f in futs])
        frame = daemon.score_batch(x)
    finally:
        daemon.stop()
    # a row scores alone or in a padded batch: per-row math, bf16 at the
    # same points
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(frame, want, rtol=1e-6, atol=1e-6)
