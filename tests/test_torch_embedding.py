"""The port's embedding kernels' plain versions and routing
(shifu_tpu_torch/ops/embedding.py) against the JAX package's
shifu_tpu/ops/pallas_embedding.py, on the CPU.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances:
- the lookup is a gather: bitwise, against `_xla_lookup` for every id
  (NaN rows included) and against `_pallas_lookup` in interpret mode for
  ids in [-V, V) (the interpreter clamps the rest where the reference
  fills NaN);
- its gradient: the f32 scatter-add, summation order only: rtol 1e-6 in
  f32; in bf16 one ulp of the rounded sum (2^-7 relative);
- the rows-touched update: rtol 1e-5, atol 1e-6 against both JAX versions,
  the JAX tests' own tolerance (XLA may contract a multiply and an add
  into one FMA where the port rounds each); the port's raw-id update with
  duplicates equals its deduped update bitwise.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from shifu_tpu.ops import pallas_embedding as jpe
from shifu_tpu_torch.embed.dedup import dedup_ids
from shifu_tpu_torch.ops import embedding as emb

NC, V, D = 3, 11, 5


def _table(rng, dtype=np.float32, nc=NC, v=V, d=D):
    return rng.normal(size=(nc, v, d)).astype(np.float32).astype(dtype)


def _edge_ids(rng, b=24, nc=NC, v=V):
    ids = rng.integers(0, v, size=(b, nc)).astype(np.int32)
    ids.reshape(-1)[:8] = [v, -1, -v, v - 1, 0, -v - 1, v + 5, -2 * v]
    return ids


def _jax_bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view({4: np.int32, 2: np.int16}[a.dtype.itemsize])


def _port_bits(t: torch.Tensor) -> np.ndarray:
    return t.view({4: torch.int32, 2: torch.int16}[t.element_size()]).numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_lookup_matches_jax_bitwise(dtype):
    rng = np.random.default_rng(0)
    jdt = jnp.dtype(dtype)
    table = jnp.asarray(_table(rng), jdt)
    ttable = torch.from_numpy(np.array(table.astype(jnp.float32))).to(
        getattr(torch, dtype))
    ids = _edge_ids(rng)
    got = emb.lookup_reference(ttable, torch.from_numpy(ids))
    assert got.dtype == ttable.dtype and got.shape == (24, NC, D)
    np.testing.assert_array_equal(
        _port_bits(got), _jax_bits(jpe._xla_lookup(table, jnp.asarray(ids))))
    # wrapped and in-range ids: the Pallas kernel in interpret mode
    inside = np.where((ids >= -V) & (ids < V), ids, 3).astype(np.int32)
    np.testing.assert_array_equal(
        _port_bits(emb.lookup_reference(ttable, torch.from_numpy(inside))),
        _jax_bits(jpe._pallas_lookup(table, jnp.asarray(inside),
                                     interpret=True)))
    # NaN rows exactly where the id lies outside [-V, V)
    nan_rows = np.isnan(got.float().numpy()).all(axis=-1)
    np.testing.assert_array_equal(nan_rows, (ids < -V) | (ids >= V))


@pytest.mark.parametrize("dtype,rtol", [("float32", 1e-6),
                                        ("bfloat16", 2.0 ** -7)])
def test_lookup_gradient_matches_jax(dtype, rtol):
    """The f32 scatter-add, rounded once to the table's dtype; wrapped ids
    add on their row, ids outside [-V, V) drop."""
    rng = np.random.default_rng(1)
    b = 64
    table = _table(rng)
    ids = _edge_ids(rng, b=b)
    ids[8:40, 1] = 4                           # many rows on one id
    g = rng.normal(size=(b, NC, D)).astype(np.float32)
    tt = torch.from_numpy(table).to(getattr(torch, dtype)).requires_grad_()
    gt = torch.from_numpy(g).to(tt.dtype)
    out = emb.embedding_lookup(tt, torch.from_numpy(ids))
    (got,) = torch.autograd.grad(out, tt, gt)
    jt = jnp.asarray(tt.detach().float().numpy(), jnp.dtype(dtype))
    _, vjp = jax.vjp(lambda t: jpe.embedding_lookup(t, jnp.asarray(ids)), jt)
    (want,) = vjp(jnp.asarray(gt.float().numpy(), jnp.dtype(dtype)))
    assert got.dtype == tt.dtype
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=rtol, atol=1e-6)


def test_scatter_grad_drops_ids_outside_the_table():
    """An id of V in field f must not alias row 0 of field f + 1."""
    ids = torch.tensor([[V, 0, -V - 1]], dtype=torch.int32)
    g = torch.ones((1, NC, D))
    grad = emb.scatter_grad(ids, (NC, V, D), g)
    assert float(grad[1].sum()) == D and float(grad.sum()) == D


class _FakeCudaTensor:
    """Stands in for a CUDA tensor where there is no card: only its device
    is read before the route is chosen."""
    device = torch.device("cuda", 0)


def _no_plain(*a, **k):
    raise AssertionError("a CUDA tensor reached the plain version")


def test_cuda_lookup_routes_to_the_kernel(monkeypatch):
    calls = []
    monkeypatch.setattr(emb, "lookup_reference", _no_plain)
    monkeypatch.setattr(emb, "_launch_lookup",
                        lambda *a: calls.append(a) or "out")
    t = _FakeCudaTensor()
    assert emb._lookup_forward(t, "ids") == "out"
    assert calls == [(t, "ids")]


def test_cuda_rows_update_routes_to_the_kernel(monkeypatch):
    """A CUDA table reaches the launch, with `unique` as the caller gave
    it (False, the default, takes duplicate ids)."""
    calls = []
    monkeypatch.setattr(emb, "rows_update_plain", _no_plain)
    monkeypatch.setattr(emb, "_launch_rows_update",
                        lambda *a: calls.append(a))
    t = _FakeCudaTensor()
    emb.fused_rows_update(t, [], "g", "ids", "sgd", 0.1)
    emb.fused_rows_update(t, [], "g", "ids", "sgd", 0.1, unique=True)
    assert calls == [(t, (), "g", "ids", "sgd", 0.1, False),
                     (t, (), "g", "ids", "sgd", 0.1, True)]


@pytest.mark.parametrize("which", ["lookup", "rows"])
def test_cuda_launch_failure_raises(monkeypatch, which):
    """A kernel that cannot take a CUDA call raises; nothing falls back."""
    def refuse(*a):
        raise RuntimeError("kernel launch failed")

    monkeypatch.setattr(emb, "lookup_reference", _no_plain)
    monkeypatch.setattr(emb, "rows_update_plain", _no_plain)
    monkeypatch.setattr(emb, "_launch_lookup", refuse)
    monkeypatch.setattr(emb, "_launch_rows_update", refuse)
    with pytest.raises(RuntimeError, match="launch failed"):
        if which == "lookup":
            emb._lookup_forward(_FakeCudaTensor(), None)
        else:
            emb.fused_rows_update(_FakeCudaTensor(), (), None, None, "sgd",
                                  0.1)


def test_other_devices_raise():
    t = torch.zeros((NC, V, D), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        emb._lookup_forward(t, torch.zeros((2, NC), dtype=torch.int32))
    with pytest.raises(ValueError, match="unknown rule"):
        emb.fused_rows_update(t, (), None, None, "adam", 0.1)


def test_cpu_runs_plain_and_counts_no_launch():
    before = (emb.embedding_lookup.launches, emb.fused_rows_update.launches)
    rng = np.random.default_rng(2)
    t = torch.from_numpy(_table(rng))
    ids = torch.from_numpy(_edge_ids(rng))
    emb.embedding_lookup(t, ids)
    emb.fused_rows_update(t, (), torch.zeros((24, NC, D)), ids, "sgd", 0.1)
    assert (emb.embedding_lookup.launches,
            emb.fused_rows_update.launches) == before
    assert all(emb.fused_update_available(d) for d in (1, 16, 17, 128))


def _update_inputs(rng, u=16, pad=4):
    """A deduped batch of ids, padded with the sentinel V, its gradient
    rows and a table with nonzero slots."""
    raw = rng.integers(0, V, size=(u, NC)).astype(np.int32)
    ids = dedup_ids(raw, V)[0]
    ids[-pad:] = V
    g = rng.normal(size=(u, NC, D)).astype(np.float32)
    table = _table(rng)
    slots = tuple(rng.uniform(0, 1e-2, size=(NC, V, D)).astype(np.float32)
                  for _ in range(2))
    return table, slots, g, ids


@pytest.mark.parametrize("rule", ["sgd", "adadelta"])
def test_rows_update_matches_jax(rule):
    rng = np.random.default_rng(3)
    table, slots, g, ids = _update_inputs(rng)
    s_in = slots if rule == "adadelta" else ()
    got_t, got_s = emb.rows_update_reference(
        torch.from_numpy(table), tuple(map(torch.from_numpy, s_in)),
        torch.from_numpy(g), torch.from_numpy(ids), rule, 0.5)
    j_in = tuple(map(jnp.asarray, s_in))
    for want_t, want_s in (
            jpe.rows_update_reference(jnp.asarray(table), j_in,
                                      jnp.asarray(g), jnp.asarray(ids), rule,
                                      0.5),
            jpe._pallas_rows_update(jnp.asarray(table), j_in, jnp.asarray(g),
                                    jnp.asarray(ids), rule, 0.5,
                                    interpret=True)):
        np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t),
                                   rtol=1e-5, atol=1e-6)
        assert len(got_s) == len(want_s)
        for a, b in zip(got_s, want_s):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=1e-6)
    # the sentinel's rows and the untouched rows are left as they were
    touched = np.zeros((NC, V), bool)
    for f in range(NC):
        touched[f, ids[ids[:, f] < V, f]] = True
    np.testing.assert_array_equal(got_t.numpy()[~touched], table[~touched])
    assert not np.array_equal(got_t.numpy()[touched], table[touched])
    # the in-place wrapper on CPU tensors is the reference, bitwise
    t2 = torch.from_numpy(table.copy())
    s2 = tuple(torch.from_numpy(s.copy()) for s in s_in)
    emb.fused_rows_update(t2, s2, torch.from_numpy(g), torch.from_numpy(ids),
                          rule, 0.5)
    assert torch.equal(t2, got_t)
    assert all(torch.equal(a, b) for a, b in zip(s2, got_s))


@pytest.mark.parametrize("rule", ["sgd", "adadelta"])
def test_raw_ids_with_duplicates_equal_the_deduped_update(rule):
    """Deliberate difference (ROADMAP.md section C): the port sends raw-id
    batches through the update too.  Duplicates of one id carry the same
    gradient row (the summed dense gradient at that id), so a raw batch
    leaves the table and slots its deduped batch leaves, bitwise, and
    what the JAX reference leaves (its `.at[].set` of equal values)."""
    rng = np.random.default_rng(4)
    raw = rng.integers(0, 4, size=(40, NC)).astype(np.int32)  # many repeats
    uniq = dedup_ids(raw, V)[0]
    dense_g = rng.normal(size=(NC, V, D)).astype(np.float32)
    fields = np.arange(NC)[None, :]
    table = _table(rng)
    slots = tuple(rng.uniform(0, 1e-2, size=(NC, V, D)).astype(np.float32)
                  for _ in range(2)) if rule == "adadelta" else ()

    def port(ids):
        g = dense_g[fields, np.minimum(ids, V - 1)]
        return emb.rows_update_reference(
            torch.from_numpy(table), tuple(map(torch.from_numpy, slots)),
            torch.from_numpy(g), torch.from_numpy(ids), rule, 0.5)

    (rt, rs), (ut, us) = port(raw), port(uniq)
    assert torch.equal(rt, ut)
    assert all(torch.equal(a, b) for a, b in zip(rs, us))
    jt, js = jpe.rows_update_reference(
        jnp.asarray(table), tuple(map(jnp.asarray, slots)),
        jnp.asarray(dense_g[fields, raw]), jnp.asarray(raw), rule, 0.5)
    np.testing.assert_allclose(rt.numpy(), np.asarray(jt), rtol=1e-5,
                               atol=1e-6)
    for a, b in zip(rs, js):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)


def test_rows_update_on_a_bf16_table():
    """Math in f32, the new rows stored in bf16 (as the JAX reference casts
    them), the slots in f32: within one bf16 ulp of JAX's rows."""
    rng = np.random.default_rng(5)
    table, slots, g, ids = _update_inputs(rng)
    tb = torch.from_numpy(table).to(torch.bfloat16)
    got_t, got_s = emb.rows_update_reference(
        tb, tuple(map(torch.from_numpy, slots)), torch.from_numpy(g),
        torch.from_numpy(ids), "adadelta", 0.5)
    want_t, want_s = jpe.rows_update_reference(
        jnp.asarray(tb.float().numpy(), jnp.bfloat16),
        tuple(map(jnp.asarray, slots)), jnp.asarray(g), jnp.asarray(ids),
        "adadelta", 0.5)
    assert got_t.dtype == torch.bfloat16
    assert all(s.dtype == torch.float32 for s in got_s)
    np.testing.assert_allclose(got_t.float().numpy(),
                               np.asarray(want_t.astype(jnp.float32)),
                               rtol=2.0 ** -8, atol=1e-6)
    for a, b in zip(got_s, want_s):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("rule", ["sgd", "adadelta"])
def test_plain_update_ignores_unique(rule):
    """`unique` only tells the kernel how to treat duplicates: on the CPU
    a deduped batch leaves the same bits with unique=True and False."""
    rng = np.random.default_rng(6)
    table, slots, g, ids = _update_inputs(rng)
    out = []
    for unique in (True, False):
        t = torch.from_numpy(table.copy())
        s = tuple(torch.from_numpy(x.copy()) for x in slots)
        emb.fused_rows_update(t, s if rule == "adadelta" else (),
                              torch.from_numpy(g), torch.from_numpy(ids),
                              rule, 0.5, unique=unique)
        out.append((t, s))
    (t1, s1), (t2, s2) = out
    assert np.array_equal(_port_bits(t1), _port_bits(t2))
    assert all(np.array_equal(_port_bits(a), _port_bits(b))
               for a, b in zip(s1, s2))


def _deepfm_job(dedup: str):
    from shifu_tpu_torch.config.schema import (DataConfig, EmbedConfig,
                                               JobConfig, ModelSpec,
                                               OptimizerConfig, TrainConfig)
    from shifu_tpu_torch.data import synthetic
    return JobConfig(
        schema=synthetic.make_schema(num_features=6, num_categorical=NC,
                                     vocab_size=V),
        data=DataConfig(batch_size=8),
        model=ModelSpec(model_type="deepfm", hidden_nodes=(4,),
                        activations=("relu",), embedding_dim=D),
        train=TrainConfig(epochs=1, loss="weighted_mse",
                          optimizer=OptimizerConfig(name="adadelta",
                                                    learning_rate=0.5),
                          sparse_embedding_update="on"),
        embed=EmbedConfig(dedup=dedup)).validate()


@pytest.mark.parametrize("dedup,attach,want", [
    ("auto", True, True),    # the per-batch tier's deduped ids
    ("auto", False, False),  # raw ids (the resident tier)
    ("off", True, False),    # dedup "off" reads the raw ids
])
def test_sparse_apply_says_when_ids_are_unique(monkeypatch, dedup, attach,
                                               want):
    """`make_sparse_apply` passes unique=True exactly when it updates from
    the batch's UNIQUE_KEY ids; on the card that reaches the kernel's
    launch (test_cuda_rows_update_routes_to_the_kernel)."""
    from shifu_tpu_torch.embed.dedup import UNIQUE_KEY, attach_dedup
    from shifu_tpu_torch.models.embedding import field_layout
    from shifu_tpu_torch.train import loop, sparse_embed, step
    job = _deepfm_job(dedup)
    state = loop.init_state(job, job.schema.feature_count, "cpu")
    seen, real = [], sparse_embed.fused_rows_update

    def record(*a, **k):
        seen.append(k.get("unique"))
        return real(*a, **k)

    monkeypatch.setattr(sparse_embed, "fused_rows_update", record)
    rng = np.random.default_rng(7)
    feats = rng.normal(size=(8, 6)).astype(np.float32)
    feats[:, 6 - NC:] = rng.integers(0, 4, size=(8, NC))  # duplicates
    batch = {"features": feats,
             "target": (rng.random((8, 1)) < 0.5).astype(np.float32),
             "weight": np.ones((8, 1), np.float32)}
    if attach:
        batch = attach_dedup(field_layout(job.schema), V)(batch)
        assert UNIQUE_KEY in batch
    step.make_train_step(job)(state, loop.to_device(batch, job,
                                                    torch.device("cpu")))
    assert seen == [want] * len(state.table_slots) and seen
