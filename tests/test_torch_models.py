"""Whole models of the port against the JAX package's: FT-Transformer (fused
and unfused blocks) and the MLP, with the JAX model's Flax params carried
across by `params_from_jax` and the same inputs fed to both.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from shifu_tpu.config.schema import ModelSpec as JaxModelSpec
from shifu_tpu.data import synthetic
from shifu_tpu.export.artifact import _flatten_params
from shifu_tpu.models.registry import build_model as jax_build_model
from shifu_tpu_torch.config.schema import DataSchema, ModelSpec, _from_dict
from shifu_tpu_torch.export.artifact import params_from_jax
from shifu_tpu_torch.models.registry import build_model
from shifu_tpu_torch.ops import flash_attention, ft_block, small_attention

N_NUMERIC, N_CAT, VOCAB = 5, 2, 11

# f32 end to end: summation order only
F32_TOL = 2e-5
# bf16 compute: activations round to bf16 between ops on both sides, but
# the frameworks' bf16 products round at different points, and the
# unfused branch differs in kind: JAX on the CPU runs `mha` (bf16 scores),
# the port the small-attention kernel's f32 softmax.  A few bf16 ulps of a
# logit of order 1 (an ulp is 2^-8 in [0.5, 1)), over two blocks.
BF16_TOL = 2e-2


def _schema():
    return synthetic.make_schema(num_features=N_NUMERIC + N_CAT,
                                 num_categorical=N_CAT, vocab_size=VOCAB)


def _rows(rng, n):
    x = rng.normal(size=(n, N_NUMERIC + N_CAT)).astype(np.float32)
    # ids in range, past the vocab, negative, and fractional
    x[:, N_NUMERIC:] = rng.choice(
        np.array([0, 3, 10, 11, 25, -2, 4.7], np.float32),
        size=(n, N_CAT))
    return x


_PARAMS: dict = {}


def _init_params(spec_kw, seed):
    """Flax params, cached: the tree does not depend on the compute dtype
    or on fused_block, so one init serves every variant of a width."""
    kw = {k: v for k, v in spec_kw.items()
          if k not in ("compute_dtype", "fused_block")}
    key = (tuple(sorted(kw.items())), seed)
    if key not in _PARAMS:
        jschema = _schema()
        jmodel = jax_build_model(
            JaxModelSpec(**kw, fused_block="off"), jschema)
        _PARAMS[key] = jax.jit(jmodel.init)(
            jax.random.PRNGKey(seed),
            jnp.zeros((2, jschema.feature_count)))["params"]
    return _PARAMS[key]


def _pair(spec_kw, seed=0):
    """(jax forward, port model) sharing the Flax params."""
    jschema = _schema()
    jmodel = jax_build_model(JaxModelSpec(**spec_kw), jschema)
    params = _init_params(spec_kw, seed)
    schema = _from_dict(DataSchema, dataclasses.asdict(jschema))
    model = build_model(ModelSpec(**spec_kw), schema, device="cpu")
    model.load_state_dict(params_from_jax(_flatten_params(params), model))

    apply = jax.jit(jmodel.apply)

    def jfwd(x):
        return np.asarray(apply({"params": params}, jnp.asarray(x)))
    return jfwd, model


def _ft_kw(fused_block, cdt):
    return dict(model_type="ft_transformer", token_dim=16, num_layers=2,
                num_attention_heads=2, mlp_ratio=2, compute_dtype=cdt,
                fused_block=fused_block)


@pytest.mark.parametrize("fused_block", ["on", "off"])
@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
def test_ft_transformer_matches_jax(fused_block, cdt):
    jfwd, model = _pair(_ft_kw(fused_block, cdt))
    x = _rows(np.random.default_rng(1), 6)
    want = jfwd(x)
    with torch.inference_mode():
        got = model(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (6, 1)
    tol = F32_TOL if cdt == "float32" else BF16_TOL
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)
    # on the CPU the wrappers run their plain versions, never a kernel
    assert ft_block.fused_transformer_block.launches == 0
    assert small_attention.small_token_attention.launches == 0


def test_ft_fused_and_unfused_share_weights():
    """The two branches read one parameter tree: an artifact serves either
    way, and at f32 they agree."""
    _, on = _pair(_ft_kw("on", "float32"))
    _, off = _pair(_ft_kw("off", "float32"))
    assert list(on.state_dict()) == list(off.state_dict())
    x = torch.from_numpy(_rows(np.random.default_rng(2), 5))
    with torch.inference_mode():
        torch.testing.assert_close(on(x), off(x), rtol=F32_TOL,
                                   atol=F32_TOL)


def test_ft_unfused_takes_mha_outside_the_small_attention_envelope():
    """Head dim 32 > 16: the unfused block uses plain `mha`, and still
    matches JAX."""
    kw = dict(_ft_kw("off", "float32"), token_dim=32, num_attention_heads=1)
    jfwd, model = _pair(kw)
    assert not small_attention.small_attention_applicable(8, 32, 1)
    x = _rows(np.random.default_rng(3), 4)
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, jfwd(x), rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("fused_block,want", [
    ("auto", "fused_transformer_block"), ("off", "small_token_attention")])
def test_ft_routing_ignores_jax_kill_switches(monkeypatch, fused_block, want):
    """The JAX package's kill switches do not reach the port: with both set,
    a block routes by fused_block and shape alone, as it does on the card,
    and never to plain `mha` inside the kernels' envelope."""
    from shifu_tpu_torch.models import ft_transformer
    monkeypatch.setenv("SHIFU_TPU_NO_FT_FUSED", "1")
    monkeypatch.setenv("SHIFU_TPU_NO_SMALL_ATTENTION", "1")
    calls = []
    for name in ("fused_transformer_block", "small_token_attention", "mha"):
        fn = getattr(ft_transformer, name)
        monkeypatch.setattr(
            ft_transformer, name,
            lambda *a, _n=name, _f=fn, **k: calls.append(_n) or _f(*a, **k))
    schema = _from_dict(DataSchema, dataclasses.asdict(_schema()))
    model = build_model(ModelSpec(**_ft_kw(fused_block, "float32")), schema,
                        device="cpu", generator=torch.Generator().manual_seed(0))
    with torch.inference_mode():
        model(torch.from_numpy(_rows(np.random.default_rng(6), 3)))
    assert calls == [want] * 2


@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("acts", [("tanh", "relu"),
                                  ("leakyrelu", "sigmoid")])
def test_mlp_matches_jax(cdt, acts):
    kw = dict(model_type="mlp", hidden_nodes=(6, 4), activations=acts,
              compute_dtype=cdt)
    jfwd, model = _pair(kw, seed=4)
    x = np.random.default_rng(5).normal(
        size=(8, N_NUMERIC + N_CAT)).astype(np.float32)
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
    # bf16: a product and a bias add round to bf16 per layer on both sides
    tol = F32_TOL if cdt == "float32" else 2e-2
    np.testing.assert_allclose(got, jfwd(x), rtol=tol, atol=tol)


def test_params_from_jax_rejects_missing_extra_and_misshaped_keys():
    jschema = _schema()
    kw = dict(model_type="mlp", hidden_nodes=(6,), activations=("relu",))
    jmodel = jax_build_model(JaxModelSpec(**kw), jschema)
    flat = _flatten_params(jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, jschema.feature_count)))
        ["params"])
    schema = _from_dict(DataSchema, dataclasses.asdict(jschema))
    model = build_model(ModelSpec(**kw), schema, device="cpu")
    params_from_jax(flat, model)  # complete: no error
    key = "trunk/hidden_layer0/Dense_0/kernel"
    with pytest.raises(KeyError, match="missing"):
        params_from_jax({k: v for k, v in flat.items() if k != key}, model)
    with pytest.raises(KeyError, match="unexpected"):
        params_from_jax({**flat, "extra/kernel": flat[key]}, model)
    with pytest.raises(ValueError, match="shape"):
        params_from_jax({**flat, key: flat[key].T}, model)


def test_unported_configurations_raise():
    schema = _from_dict(DataSchema, dataclasses.asdict(_schema()))
    for kw in (dict(attention_impl="ulysses"), dict(attention_impl="ring"),
               dict(pipeline_stages=2)):
        spec = ModelSpec(**dict(_ft_kw("auto", "float32"), **kw))
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            build_model(spec, schema, device="cpu")


def _forced_flash(monkeypatch):
    """Send the JAX model's flash route through its Pallas kernels
    (interpret mode, 32-row blocks), as the port always takes its kernels;
    the JAX package is not edited."""
    import functools
    from shifu_tpu.models import ft_transformer as jax_ft
    from shifu_tpu.ops import pallas_attention as jax_fa
    monkeypatch.setattr(jax_ft, "flash_attention", functools.partial(
        jax_fa.flash_attention, use_pallas=True, block_q=32, block_k=32))


@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
def test_ft_flash_matches_jax(monkeypatch, cdt):
    """attention_impl="flash" with the unfused block: the port's flash
    attention against the JAX model's Pallas flash kernels."""
    _forced_flash(monkeypatch)
    kw = dict(_ft_kw("off", cdt), attention_impl="flash")
    jfwd, model = _pair(kw)
    x = _rows(np.random.default_rng(8), 6)
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
    tol = F32_TOL if cdt == "float32" else BF16_TOL
    np.testing.assert_allclose(got, jfwd(x), rtol=tol, atol=tol)
    assert flash_attention.flash_fwd.launches == 0


def test_ft_flash_spec_fuses_where_the_gate_admits(monkeypatch):
    """JAX fuses a flash spec whenever its gate admits the shape (S <= 64),
    and so does the port: with fused_block on, no flash call at S = 8."""
    from shifu_tpu_torch.models import ft_transformer
    calls = []
    real = ft_transformer.flash_attention
    monkeypatch.setattr(ft_transformer, "flash_attention",
                        lambda *a: calls.append(1) or real(*a))
    schema = _from_dict(DataSchema, dataclasses.asdict(_schema()))
    for mode, want in (("on", 0), ("off", 2)):
        model = build_model(ModelSpec(**dict(_ft_kw(mode, "float32"),
                                             attention_impl="flash")),
                            schema, device="cpu")
        calls.clear()
        with torch.inference_mode():
            model(torch.from_numpy(_rows(np.random.default_rng(9), 3)))
        assert len(calls) == want, mode


def _dropout_model(**kw):
    schema = _from_dict(DataSchema, dataclasses.asdict(_schema()))
    spec = ModelSpec(**{**_ft_kw("auto", "float32"), "dropout_rate": 0.2,
                        **kw})
    return build_model(spec, schema, device="cpu", train=True,
                       generator=torch.Generator().manual_seed(3))


def test_ft_dropout_is_deterministic_per_seed_and_step():
    """The unfused block drops out after proj and after mlp_out; the masks
    are a pure function of (seed, step) through the trainer's dropout
    stream, and eval mode turns them off (and fuses the block again)."""
    from shifu_tpu_torch.models.base import Dropout, set_dropout_generator
    from shifu_tpu_torch.train.step import DropoutStream
    model = _dropout_model()
    assert sum(isinstance(m, Dropout) for m in model.modules()) == 4
    x = torch.from_numpy(_rows(np.random.default_rng(10), 8))
    stream = DropoutStream(seed=5)

    def run(step, seed_stream=stream):
        set_dropout_generator(model, seed_stream.generator(x.device, step))
        with torch.no_grad():
            return model(x)

    a, b, c = run(3), run(3), run(4)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)
    assert not torch.equal(a, run(3, DropoutStream(seed=6)))
    model.eval()
    with torch.no_grad():
        ev = model(x)
    nodrop = _dropout_model(dropout_rate=0.0).eval()
    with torch.no_grad():
        torch.testing.assert_close(ev, nodrop(x), rtol=0, atol=0)
    assert list(model.state_dict()) == list(nodrop.state_dict())


def test_ft_remat_grads_equal_without_remat_with_dropout_on():
    """remat=True recomputes each block in the backward pass; the block
    restores its dropout generator first, so the recompute draws the
    forward's masks and the gradients equal remat=False's."""
    from shifu_tpu_torch.models.base import set_dropout_generator
    x = torch.from_numpy(_rows(np.random.default_rng(11), 8))
    grads = []
    for remat in (False, True):
        model = _dropout_model(remat=remat)
        set_dropout_generator(model, torch.Generator().manual_seed(99))
        loss = model(x).square().mean()
        grads.append(torch.autograd.grad(loss, list(model.parameters())))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
    assert any(float(g.abs().sum()) > 0 for g in grads[1])


def test_embedding_gradient_scatters_in_f32_like_jax():
    """Many rows on one id at bf16: the port's lookup gradient sums the rows
    in f32 and rounds once to bf16, as JAX's lookup gradient does (within
    one bf16 ulp); a plain bf16 gather's autograd would add the rows in
    bf16 and land far off."""
    from shifu_tpu.ops.pallas_embedding import embedding_lookup as jax_lookup
    from shifu_tpu_torch.models.embedding import embedding_lookup
    rng = np.random.default_rng(12)
    nc, v, d, b = 3, 20, 8, 2048
    table = rng.normal(size=(nc, v, d)).astype(np.float32)
    ids = rng.integers(0, v, size=(b, nc)).astype(np.int32)
    ids[: b // 2, 0] = 7                      # 1024+ rows on one id
    g = rng.normal(size=(b, nc, d)).astype(np.float32)
    tb = torch.from_numpy(table).to(torch.bfloat16).requires_grad_(True)
    gb = torch.from_numpy(g).to(torch.bfloat16)
    out = embedding_lookup(tb, torch.from_numpy(ids))
    (got,) = torch.autograd.grad(out, tb, gb)
    jt = jnp.asarray(tb.detach().float().numpy(), jnp.bfloat16)
    jout, vjp = jax.vjp(lambda t: jax_lookup(t, jnp.asarray(ids)), jt)
    (want,) = vjp(jnp.asarray(gb.float().numpy(), jnp.bfloat16))
    want = np.asarray(want.astype(jnp.float32))
    np.testing.assert_array_equal(out.detach().float().numpy(),
                                  np.asarray(jout.astype(jnp.float32)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2.0 ** -7,
                               atol=1e-6)
    fields = torch.arange(nc)[None, :]
    plain = torch.autograd.grad(tb[fields, torch.from_numpy(ids).long()],
                                tb, gb)[0].float().numpy()
    assert np.abs(plain - want).max() > 10 * np.abs(
        got.float().numpy() - want).max() + 1e-3


# -- param_dtype ------------------------------------------------------------

_PDT_KW = {
    "mlp": dict(model_type="mlp", hidden_nodes=(6, 4),
                activations=("relu", "tanh")),
    "ft_transformer": dict(_ft_kw("off", "float32")),
    "wide_deep": dict(model_type="wide_deep", hidden_nodes=(6,),
                      activations=("relu",), embedding_dim=4),
    "deepfm": dict(model_type="deepfm", hidden_nodes=(6,),
                   activations=("relu",), embedding_dim=4),
}


@pytest.mark.parametrize("model_type", sorted(_PDT_KW))
def test_param_dtypes_follow_param_dtype_like_jax(model_type):
    """With param_dtype="bfloat16" every parameter has the dtype the JAX
    package gives it: bf16, but the FT's LayerNorm scales and biases,
    which Flax keeps in f32."""
    kw = dict(_PDT_KW[model_type], param_dtype="bfloat16")
    want = {k: str(v.dtype) for k, v in
            _flatten_params(_init_params(kw, 0)).items()}
    schema = _from_dict(DataSchema, dataclasses.asdict(_schema()))
    model = build_model(ModelSpec(**kw), schema, device="cpu")
    got = {k.replace(".", "/"): str(v.dtype).replace("torch.", "")
           for k, v in model.state_dict().items()}
    assert got == want
    assert "bfloat16" in got.values()


@pytest.mark.parametrize("model_type", sorted(_PDT_KW))
def test_bf16_params_train_in_lockstep_with_jax(model_type):
    """4 SGD steps of `make_train_step` with bf16 parameters (f32 compute),
    from the same params on the same batches: the losses within 1e-2
    relative (bf16 updates round on both sides, at the same points, but
    the gradients they round come from sums in other orders), and the
    parameters stay bf16."""
    import json

    from shifu_tpu.config import schema as jax_schema
    from shifu_tpu.train import loop as jax_loop
    from shifu_tpu.train import step as jax_step
    from shifu_tpu_torch.config.schema import JobConfig
    from shifu_tpu_torch.export.artifact import params_from_jax as carry
    from shifu_tpu_torch.train import loop, step

    jjob = jax_schema.JobConfig(
        schema=_schema(), data=jax_schema.DataConfig(batch_size=32),
        model=JaxModelSpec(**dict(_PDT_KW[model_type],
                                  param_dtype="bfloat16")),
        train=jax_schema.TrainConfig(
            epochs=1, optimizer=jax_schema.OptimizerConfig(
                name="sgd", learning_rate=0.1))).validate()
    pjob = JobConfig.from_dict(json.loads(jjob.to_json())).validate()
    n_feat = N_NUMERIC + N_CAT
    jstate = jax_loop.init_state(jjob, n_feat)
    state = loop.init_state(pjob, n_feat, "cpu")
    state.model.load_state_dict(carry(_flatten_params(
        jax.device_get(jstate.params)), state.model))
    jtrain, ptrain = jax_step.make_train_step(jjob), step.make_train_step(pjob)
    rng = np.random.default_rng(13)
    jl, pl = [], []
    for _ in range(4):
        b = {"features": _rows(rng, 32),
             "target": (rng.random((32, 1)) < 0.5).astype(np.float32),
             "weight": np.ones((32, 1), np.float32)}
        jstate, jm = jtrain(jstate, {k: jnp.asarray(v) for k, v in
                                     b.items()})
        state, pm = ptrain(state, {k: torch.from_numpy(v)
                                   for k, v in b.items()})
        jl.append(float(jm["loss"]))
        pl.append(float(pm["loss"]))
    np.testing.assert_allclose(pl, jl, rtol=1e-2)
    assert all(p.dtype == torch.bfloat16
               for n, p in state.model.named_parameters()
               if "ln_" not in n)
