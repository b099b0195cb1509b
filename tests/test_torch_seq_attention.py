"""Ring and Ulysses attention over the `seq` axis (shifu_tpu_torch/ops/
attention.py, the FT-Transformer's sequence-parallel route) against the
JAX package: the counterparts of tests/test_attention.py, run on gloo
ranks (tests/torch_mesh_helpers, one spawn of 4 ranks) and in the pytest
process.  Each rank holds its S/n tokens of q, k, v; its output block is
all-gathered over `seq`.

Tolerances, JAX's own: the forward rtol 2e-5, atol 2e-6 (bf16 at S=256:
3e-2); the gradients rtol 1e-4, atol 1e-5; the FT train step on data=2 x
seq=2 against JAX's on its mesh: rtol 2e-4, atol 2e-5, the loss rel 1e-5.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

import torch_mesh_helpers as H
from shifu_tpu.config import schema as jax_schema
from shifu_tpu.data import reader as jax_reader
from shifu_tpu.data import synthetic as jax_synth
from shifu_tpu.export.artifact import _flatten_params
from shifu_tpu.models.registry import build_model as jax_build_model
from shifu_tpu.ops import attention as jax_attn
from shifu_tpu.parallel import make_mesh as jax_make_mesh
from shifu_tpu.parallel import shard_batch as jax_shard_batch
from shifu_tpu.train import loop as jax_loop
from shifu_tpu.train import step as jax_step
from shifu_tpu_torch.config import schema as port_schema
from shifu_tpu_torch.config.schema import MeshConfig
from shifu_tpu_torch.ops.attention import mha

FWD = dict(rtol=2e-5, atol=2e-6)
GRAD = dict(rtol=1e-4, atol=1e-5)
STEP = dict(rtol=2e-4, atol=2e-5)


def _qkv(b=2, h=4, s=64, d=16, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((b, h, s, d)).astype(np.float32)
                 for _ in range(3))


def _jax_mha_and_grads(q, k, v):
    out = np.asarray(jax_attn.mha(*(jnp.asarray(t) for t in (q, k, v))))
    grads = jax.grad(lambda q, k, v: jnp.sum(jnp.square(jax_attn.mha(
        q, k, v))), argnums=(0, 1, 2))(*(jnp.asarray(t) for t in (q, k, v)))
    return out, [np.asarray(g) for g in grads]


def _ft_jobs(impl):
    # 15 features + CLS = 16 tokens, divisible by seq=2; 2 heads for ulysses
    schema = jax_synth.make_schema(num_features=15, num_categorical=3,
                                   vocab_size=8)
    jjob = jax_schema.JobConfig(
        schema=schema, data=jax_schema.DataConfig(batch_size=16),
        model=jax_schema.ModelSpec(
            model_type="ft_transformer", hidden_nodes=(8,),
            activations=("relu",), token_dim=8, num_attention_heads=2,
            num_layers=1, attention_impl=impl, compute_dtype="float32"),
        train=jax_schema.TrainConfig(
            epochs=1, loss="weighted_mse",
            optimizer=jax_schema.OptimizerConfig(name="adadelta")),
        runtime=jax_schema.RuntimeConfig(
            mesh=jax_schema.MeshConfig(data=2, seq=2)),
    ).validate()
    pjob = port_schema.JobConfig.from_dict(json.loads(jjob.to_json()))
    return jjob, pjob.validate()


def _flat(params) -> dict:
    return {k: np.asarray(v) for k, v in
            _flatten_params(jax.device_get(params)).items()}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, eight_devices):
    """4 gloo ranks: the ops on data=2 x seq=2 and on seq=4, bf16 at
    S=256, Ulysses with indivisible heads, then the FT model's forward
    and train step on data=2 x seq=2 from JAX's weights, against JAX's
    step on its data=2 x seq=2 mesh."""
    tmp = tmp_path_factory.mktemp("seq")
    q, k, v = _qkv(seed=3)
    qb, kb, vb = _qkv(b=1, h=2, s=256, d=32, seed=5)
    q2, k2, v2 = _qkv(h=2, s=64, seed=7)
    jmesh = jax_make_mesh(jax_schema.MeshConfig(data=2, seq=2),
                          devices=eight_devices[:4])
    fts = {}
    for impl in ("ring", "ulysses"):
        jjob, pjob = _ft_jobs(impl)
        jstate = jax_loop.init_state(jjob, jjob.schema.feature_count, jmesh)
        flat = _flat(jstate.params)
        batch = jax_reader.project_columns(
            jax_synth.make_rows(16, jjob.schema, seed=9), jjob.schema)
        local = jax_build_model(jjob.model, jjob.schema)
        want_fwd = np.asarray(local.apply(
            {"params": jax.device_get(jstate.params)},
            jnp.asarray(batch["features"])))
        jtrain = jax_step.make_train_step(jjob, jmesh, donate=False)
        jnew, m = jtrain(jstate, jax_shard_batch(batch, jmesh))
        fts[impl] = {"pjob": pjob, "flat": flat, "batch": batch,
                     "fwd": want_fwd, "loss": float(m["loss"]),
                     "params": _flat(jnew.params)}
    order = ("ring", "ulysses")
    steps = [
        (4, H.seq_attention_checks, (MeshConfig(data=2, seq=2), q, k, v,
                                     order)),
        (4, H.seq_attention_checks, (MeshConfig(seq=4), q, k, v, order)),
        (4, H.seq_attention_checks, (MeshConfig(seq=4), qb, kb, vb,
                                     ("ring",), "bfloat16")),
        (4, H.seq_attention_checks, (MeshConfig(seq=4), q2, k2, v2,
                                     ("ulysses",))),
        (4, H.forward_cases, (MeshConfig(data=2, seq=2), [
            (fts[i]["pjob"], fts[i]["flat"], fts[i]["batch"]["features"])
            for i in order])),
        (4, H.dp_cases, (MeshConfig(data=2, seq=2), [
            (fts[i]["pjob"], fts[i]["flat"], [fts[i]["batch"]])
            for i in order])),
    ]
    res = H.run_ranks(H.sequence, 4, tmp, str(tmp / "regroup"), steps,
                      timeout=240.0)
    return {"ranks": res, "qkv": (q, k, v), "bf16": (qb, kb, vb),
            "heads2": (q2, k2, v2), "ft": fts}


def test_mha_is_softmax_attention():
    q, k, v = _qkv(s=8)
    out = mha(*(torch.tensor(t) for t in (q, k, v))).numpy()
    scores = np.einsum("bhqd,bhkd->bhqk", q, k) / np.sqrt(16)
    w = np.exp(scores - scores.max(-1, keepdims=True))
    w = w / w.sum(-1, keepdims=True)
    want = np.einsum("bhqk,bhkd->bhqd", w, v)
    np.testing.assert_allclose(out, want, **FWD)
    np.testing.assert_allclose(out, np.asarray(jax_attn.mha(
        *(jnp.asarray(t) for t in (q, k, v)))), **FWD)


@pytest.mark.parametrize("step_no,n_seq", [(0, 2), (1, 4)])
@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_seq_attention_matches_mha_and_jax(ranks, eight_devices, step_no,
                                           n_seq, impl):
    """Each rank's block, gathered over seq, equals `mha` and JAX's
    sequence-parallel op on its own seq mesh of the same size."""
    q, k, v = ranks["qkv"]
    jmesh = jax_make_mesh(jax_schema.MeshConfig(data=1, seq=n_seq),
                          devices=eight_devices[:n_seq])
    spec = NamedSharding(jmesh, P(None, None, "seq", None))
    jfn = (jax_attn.ring_attention if impl == "ring"
           else jax_attn.ulysses_attention)
    jout = np.asarray(jfn(*(jax.device_put(jnp.asarray(t), spec)
                            for t in (q, k, v)), jmesh))
    want, _ = _jax_mha_and_grads(q, k, v)
    np.testing.assert_allclose(jout, want, **FWD)
    for res in ranks["ranks"]:
        got = res[step_no]
        assert got["n"] == n_seq
        np.testing.assert_allclose(got[impl]["out"], want, **FWD)
        np.testing.assert_allclose(got[impl]["out"], jout, **FWD)


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_seq_attention_gradients_match_mha(ranks, impl):
    """The gradients of each rank's q, k, v blocks for sum(out ** 2) are
    the blocks of JAX's gradient of the same sum through `mha` (on
    data=2 x seq=2; JAX's test_*_attention_grad_flows)."""
    q, k, v = ranks["qkv"]
    _, jgrads = _jax_mha_and_grads(q, k, v)
    for res in ranks["ranks"]:
        got = res[0]
        blk = q.shape[2] // got["n"]
        lo = got["seq"] * blk
        for g, want in zip(got[impl]["grads"], jgrads):
            np.testing.assert_allclose(g, want[:, :, lo:lo + blk], **GRAD)


def test_ring_attention_long_sequence_bf16(ranks, eight_devices):
    """S=256 in bf16 on seq=4, the production dtype, against JAX's ring
    on its seq=4 mesh and the full attention."""
    qb, kb, vb = ranks["bf16"]
    jmesh = jax_make_mesh(jax_schema.MeshConfig(data=1, seq=4),
                          devices=eight_devices[:4])
    spec = NamedSharding(jmesh, P(None, None, "seq", None))
    as_bf16 = [jnp.asarray(t, dtype=jnp.bfloat16) for t in (qb, kb, vb)]
    jout = np.asarray(jax_attn.ring_attention(
        *(jax.device_put(t, spec) for t in as_bf16), jmesh), np.float32)
    full = np.asarray(jax_attn.mha(*as_bf16), np.float32)
    for res in ranks["ranks"]:
        got = res[2]["ring"]["out"]
        np.testing.assert_allclose(got, jout, rtol=3e-2, atol=3e-2)
        np.testing.assert_allclose(got, full, rtol=3e-2, atol=3e-2)


def test_ulysses_rejects_indivisible_heads(ranks, eight_devices):
    """2 heads over seq=4: JAX's ValueError, with its message."""
    q2, k2, v2 = ranks["heads2"]
    jmesh = jax_make_mesh(jax_schema.MeshConfig(data=1, seq=4),
                          devices=eight_devices[:4])
    with pytest.raises(ValueError, match="divisible") as jerr:
        jax_attn.ulysses_attention(*(jnp.asarray(t) for t in (q2, k2, v2)),
                                   jmesh)
    for res in ranks["ranks"]:
        assert res[3]["ulysses"]["error"] == str(jerr.value)


@pytest.mark.parametrize("i,impl", [(0, "ring"), (1, "ulysses")])
def test_ft_sequence_parallel_forward(ranks, i, impl):
    """The FT-Transformer with attention_impl ring/ulysses on data=2 x
    seq=2 scores each data rank's rows as JAX's local-attention model
    does from the same weights."""
    want = ranks["ft"][impl]["fwd"]
    for res in ranks["ranks"]:
        got = res[4][i]
        d = got["coords"]["data"]
        np.testing.assert_allclose(got["logits"], want[d * 8:(d + 1) * 8],
                                   **FWD)


@pytest.mark.parametrize("i,impl", [(0, "ring"), (1, "ulysses")])
def test_ft_sequence_parallel_train_step(ranks, i, impl):
    """One step on data=2 x seq=2 from JAX's weights equals JAX's sharded
    step on its data=2 x seq=2 mesh; every rank holds the same bits."""
    ft = ranks["ft"][impl]
    res = [r[5][i] for r in ranks["ranks"]]
    want = {k.replace("/", "."): v for k, v in ft["params"].items()}
    for r in res:
        assert r["losses"][0] == pytest.approx(ft["loss"], rel=1e-5)
        assert not r["specs"]  # the seq axis splits no parameter
        for k, v in r["state"].items():
            assert np.array_equal(v, res[0]["state"][k]), k
    for k, v in want.items():
        np.testing.assert_allclose(res[0]["state"][f"param/{k}"], v,
                                   **STEP, err_msg=k)
