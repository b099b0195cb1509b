"""The JAX package's public surface in the port.

- Every JAX module is parsed with `ast` (JAX is not imported for it) and
  its counterpart in `shifu_tpu_torch` (the module of the same name, or
  of the name in `RENAMED`) is imported: each public top-level name, each
  public method of a public class and each parameter name of a public
  function or method is present there, unless `ALLOWED` names its
  counterpart or says why it has none.  `ALLOWED` cannot go stale: each
  of its entries really is absent from the port.
- Every name a JAX subpackage's `__init__` exports (its `__all__` and the
  names it imports) resolves from the port's subpackage of that name.
- `models.register` against JAX's: the unknown-type KeyError, a user
  builder under a new name, re-registering "mlp"; the registries restored.
- `data.reader.shard_paths` and `iter_file_rows`, `export.build_program`
  for every ladder type, `Histogram.observe_many` and
  `MetricsRegistry.snapshot` equal JAX's; `force` rebuilds a native
  library.
"""

import ast
import dataclasses
import importlib
import inspect
import json
import os

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_ROOT = os.path.join(REPO, "shifu_tpu")
PORT_ROOT = os.path.join(REPO, "shifu_tpu_torch")

# JAX modules whose port carries another name (the kernel modules)
RENAMED = {
    "ops/pallas_attention.py": "ops/flash_attention.py",
    "ops/pallas_embedding.py": "ops/embedding.py",
    "ops/pallas_ft_block.py": "ops/ft_block.py",
    "ops/pallas_int8_matmul.py": "ops/int8_matmul.py",
    "ops/pallas_small_attention.py": "ops/small_attention.py",
}
# JAX modules with no port, and why
NO_COUNTERPART = {
    "ops/pallas_common.py": "the Pallas opt-in (`pallas_opt_in`): the "
    "port's kernels run wherever the tensor is on the card",
    "obs/introspect.py": "XLA's per-program cost capture and its "
    "`xla_compile` event: the FLOP counts are obs/flops.py, and nothing "
    "compiles in an epoch",
    "utils/compilecache.py": "JAX's persistent compilation cache: the "
    "kernels' content-hashed library cache is ops/_build.py",
    "utils/jaxcompat.py": "a shim over jax.shard_map's import paths",
}
_DEVICE_ROUTE = ("the route is the tensor's device (the kernel on the "
                 "card, its plain version on the CPU)")
_FUNCTIONAL = ("functional JAX's parameter tree: the port's modules and "
               "optimizers hold their state")
_DONATE = "JAX's buffer donation; torch updates in place"
# "module:Name", "module:Class.method" or "module:function(param)" ->
# its counterpart in the port, or why there is none
ALLOWED = {
    # subpackage exports
    "obs/__init__.py:introspect": NO_COUNTERPART["obs/introspect.py"],
    "ops/__init__.py:flash_attention": "the port's `ops.flash_attention` "
    "is the module of kernels #7 and #8; the function is "
    "`ops.flash_attention.flash_attention`",
    "export/__init__.py:export_stablehlo": "the StableHLO export is "
    "`export.artifact.write_export_program` (scoring.pt2)",
    "train/__init__.py:build_optimizer": "`train.optimizers.build_transform`",
    "train/__init__.py:make_forward_fn": "`export.artifact.scoring_module`",
    # the kernel modules
    "ops/pallas_attention.py:flash_attention(use_pallas)": _DEVICE_ROUTE,
    "ops/pallas_attention.py:flash_attention(block_q)": "the Pallas grid's "
    "query block; flash_fwd.cu tiles by its own head-dim bucket",
    "ops/pallas_attention.py:flash_attention(block_k)": "the Pallas grid's "
    "key block; flash_fwd.cu tiles by its own head-dim bucket",
    "ops/pallas_embedding.py:embedding_lookup(use_pallas)": _DEVICE_ROUTE,
    "ops/pallas_embedding.py:fused_rows_update(use_pallas)": _DEVICE_ROUTE,
    "ops/pallas_ft_block.py:BATCH_TILE": "the Pallas grid's samples a "
    "step; ft_block.cu's rows a CTA are its own",
    "ops/pallas_ft_block.py:ENV_DISABLE": "`ModelSpec.fused_block` and "
    + _DEVICE_ROUTE,
    "ops/pallas_ft_block.py:fused_transformer_block(use_pallas)":
        _DEVICE_ROUTE,
    "ops/pallas_int8_matmul.py:BLOCK_ROWS": "the Pallas grid's rows a "
    "step; int8_matmul.cu picks its own panels",
    "ops/pallas_int8_matmul.py:ENV_DISABLE": _DEVICE_ROUTE,
    "ops/pallas_int8_matmul.py:fused_available":
        "`ops.int8_matmul.int8_available` (the same shape gate)",
    "ops/pallas_int8_matmul.py:fused_engaged":
        "`ops.int8_matmul.int8_available`, since " + _DEVICE_ROUTE,
    "ops/pallas_int8_matmul.py:xla_reference":
        "`ops.int8_matmul.int8_matmul_plain`",
    "ops/pallas_int8_matmul.py:int8_matmul_dequant(use_pallas)":
        _DEVICE_ROUTE,
    "ops/pallas_small_attention.py:ENV_DISABLE": "`ModelSpec.fused_block` "
    "and " + _DEVICE_ROUTE,
    "ops/pallas_small_attention.py:small_token_attention(use_pallas)":
        _DEVICE_ROUTE,
    "embed/dedup.py:dedup_lookup(use_pallas)": _DEVICE_ROUTE,
    "embed/shard.py:make_sharded_rows_update(use_pallas)": _DEVICE_ROUTE,
    # functional JAX: parameter trees, keys, donation, abstract state
    "ops/initializers.py:xavier_bias(key)": "a torch.Generator "
    "(`generator`)",
    "ops/initializers.py:xavier_bias(dtype)": "the module's parameter "
    "dtype, cast by the model",
    "ops/initializers.py:zeros_bias(key)": "a torch.Generator "
    "(`generator`)",
    "ops/initializers.py:zeros_bias(dtype)": "the module's parameter "
    "dtype, cast by the model",
    "ops/losses.py:l2_penalty(params)": "`model`: " + _FUNCTIONAL,
    "parallel/pipeline.py:PyTree": "a JAX type alias",
    "parallel/pipeline.py:pipeline_apply(stacked_params)": "`stage_params`, "
    "this stage's block of the stacked trunk",
    "parallel/sharding.py:PyTree": "a JAX type alias",
    "train/checkpoint.py:restore(abstract_state)": "`state`, restored in "
    "place",
    "train/checkpoint.py:restore_latest(abstract_state)": "`state`, "
    "restored in place",
    "train/optimizers.py:build_optimizer": "`train.optimizers."
    "build_transform`",
    "train/sparse_embed.py:dense_mask": "an optax mask: the port's dense "
    "optimizer takes the dense parameters only",
    "train/sparse_embed.py:init_table_slots(params)": "`model`: "
    + _FUNCTIONAL,
    "train/step.py:make_train_step(donate)": _DONATE,
    "train/step.py:make_train_step(donate_batch)": _DONATE,
    "train/step.py:make_epoch_scan_step(donate)": _DONATE,
    "train/step.py:make_epoch_scan_step(donate_blocks)": _DONATE,
    "train/step.py:make_device_epoch_step(donate)": _DONATE,
    "train/step.py:make_local_sgd_epoch_step(donate)": _DONATE,
    "train/step.py:make_forward_fn": "`export.artifact.scoring_module` "
    "(the model in eval mode with the sigmoid)",
    "train/train_state.py:TrainState.apply_gradients(grads)": "the "
    "gradients sit on the parameters (`.grad`)",
    "train/train_state.py:TrainState.create": "`train.loop.init_state`",
    "models/embedding.py:CategoricalEmbed.setup": "Flax's setup: a torch "
    "module makes its parameters in __init__",
    "models/embedding.py:paired_cat_embed(big_name)": "the port builds the "
    "pair of tables from the layout and returns both modules",
    "models/embedding.py:paired_cat_embed(small_name)": "the port builds "
    "the pair of tables from the layout and returns both modules",
    "models/embedding.py:paired_cat_embed(ids)": "the port's pair is "
    "looked up by the modules it returns",
    "data/pipeline.py:fast_take": "a TPU-side gather of bf16 rows; the "
    "port holds bf16 as uint16 bits and takes with numpy",
    "data/pipeline.py:prefetch_to_device(batches)": "`items`",
    "data/pipeline.py:prefetch_to_device(mesh)": "`put_fn`, the placer of "
    "the rank's rows",
    # the export: StableHLO and the JAX engines
    "export/aot.py:build_aot_pack(forward_fn)": "the pack is built from "
    "the artifact's own files (`export_dir`)",
    "export/aot.py:build_aot_pack(params)": "the pack is built from the "
    "artifact's own files (`export_dir`)",
    "export/aot.py:build_aot_pack(num_features)": "read from the "
    "artifact's topology",
    "export/aot.py:build_aot_pack(num_heads)": "read from the artifact's "
    "topology",
    "export/artifact.py:STABLEHLO": "the `export` engine's "
    "`scoring.pt2` (`artifact.EXPORT_PROGRAM`)",
    "export/artifact.py:JAX_EXPORT": "the `export` engine's "
    "`scoring.pt2` (`artifact.EXPORT_PROGRAM`)",
    "export/artifact.py:export_stablehlo": "`export.artifact."
    "write_export_program`",
    "export/artifact.py:save_artifact(params)": "`model`: " + _FUNCTIONAL,
    "export/artifact.py:save_artifact(job)": "`spec` and `schema`",
    "export/artifact.py:save_artifact(forward_fn)": "the forward is the "
    "model's (`export.artifact.scoring_module`)",
    "export/artifact.py:save_artifact(extra_inputs)": "the port's "
    "artifacts take the features only; an artifact with extra inputs is "
    "refused by the torch engines",
    "export/scorer.py:JaxScorer": "`export.scorer.TorchScorer` (the "
    "`torch` engine)",
    "export/scorer.py:StableHloScorer": "`export.scorer.ExportScorer` (the "
    "`export` engine)",
}


def _jax_modules() -> list:
    out = []
    for root, _dirs, files in os.walk(JAX_ROOT):
        for f in files:
            if f.endswith(".py"):
                out.append(os.path.relpath(os.path.join(root, f), JAX_ROOT)
                           .replace(os.sep, "/"))
    return sorted(out)


def _args(fn: ast.AST) -> list:
    a = fn.args
    return [x.arg for x in (*a.posonlyargs, *a.args, *a.kwonlyargs)
            if x.arg not in ("self", "cls")]


def _public(name: str) -> bool:
    return not name.startswith("_")


def jax_surface(rel: str) -> list:
    """(key, kind, parameter names) of a JAX module's public top-level
    names and its public classes' public methods, from its source."""
    with open(os.path.join(JAX_ROOT, rel)) as f:
        tree = ast.parse(f.read())
    out = []
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if _public(node.name):
                out.append((node.name, "def", _args(node)))
        elif isinstance(node, ast.ClassDef) and _public(node.name):
            out.append((node.name, "class", []))
            for m in node.body:
                if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                        and _public(m.name):
                    out.append((f"{node.name}.{m.name}", "def", _args(m)))
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            out.extend((t.id, "var", []) for t in targets
                       if isinstance(t, ast.Name) and _public(t.id))
    return out


def port_module_name(rel: str) -> str:
    rel = RENAMED.get(rel, rel)[:-3]
    parts = ["shifu_tpu_torch", *rel.split("/")]
    if parts[-1] == "__init__":
        parts.pop()
    return ".".join(parts)


def _resolve(mod, dotted: str):
    obj = mod
    for part in dotted.split("."):
        if not hasattr(obj, part):
            return None, False
        obj = getattr(obj, part)
    return obj, True


def _params(obj):
    """The parameter names `obj` takes, or None where any keyword goes."""
    try:
        sig = inspect.signature(obj)
    except (TypeError, ValueError):
        return None
    if any(p.kind is p.VAR_KEYWORD for p in sig.parameters.values()):
        return None
    return set(sig.parameters)


def surface_gaps(rel: str) -> list:
    """The keys of `rel`'s public surface the port lacks."""
    mod = importlib.import_module(port_module_name(rel))
    gaps = []
    for name, kind, args in jax_surface(rel):
        obj, found = _resolve(mod, name)
        if not found:
            gaps.append(f"{rel}:{name}")
            continue
        takes = _params(obj) if kind == "def" else None
        if takes is not None:
            gaps.extend(f"{rel}:{name}({a})" for a in args
                        if a not in takes)
    return gaps


def init_exports(rel: str) -> list:
    """Every name a JAX subpackage's __init__ exports: its __all__ and the
    names its relative imports bind."""
    with open(os.path.join(JAX_ROOT, rel)) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in tree.body:
        if isinstance(node, ast.ImportFrom) and node.level == 1:
            names.update(a.asname or a.name for a in node.names)
        elif isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "__all__"
                for t in node.targets):
            names.update(ast.literal_eval(node.value))
    return sorted(n for n in names if _public(n))


PORTED = [rel for rel in _jax_modules() if rel not in NO_COUNTERPART]
INITS = [rel for rel in _jax_modules()
         if rel.endswith("/__init__.py") and init_exports(rel)]


@pytest.mark.parametrize("rel", PORTED)
def test_every_public_name_method_and_parameter_is_in_the_port(rel):
    gaps = [g for g in surface_gaps(rel) if g not in ALLOWED]
    assert not gaps, f"{port_module_name(rel)} lacks {gaps}"


@pytest.mark.parametrize("rel", INITS)
def test_every_subpackage_export_resolves_from_the_port(rel):
    pkg = importlib.import_module(port_module_name(rel))
    missing = [n for n in init_exports(rel)
               if f"{rel}:{n}" not in ALLOWED
               and not _resolve(pkg, n)[1]]
    assert not missing, f"{pkg.__name__} does not export {missing}"


def test_the_allow_list_names_only_what_the_port_lacks():
    gaps = {g for rel in PORTED for g in surface_gaps(rel)}
    for rel in INITS:
        pkg = importlib.import_module(port_module_name(rel))
        gaps.update(f"{rel}:{n}" for n in init_exports(rel)
                    if n == "flash_attention" or not _resolve(pkg, n)[1])
    assert sorted(set(ALLOWED) - gaps) == []
    assert all(reason for reason in ALLOWED.values())


@pytest.mark.parametrize("rel", sorted(NO_COUNTERPART))
def test_modules_without_a_port_have_none(rel):
    assert os.path.exists(os.path.join(JAX_ROOT, rel))
    assert not os.path.exists(os.path.join(PORT_ROOT, rel))
    assert rel not in RENAMED


def test_the_exports_load_lazily_and_the_views_stay_torch_free():
    import subprocess
    import sys
    code = ("import sys\n"
            "import shifu_tpu_torch.data, shifu_tpu_torch.export, "
            "shifu_tpu_torch.models, shifu_tpu_torch.runtime, "
            "shifu_tpu_torch.obs\n"
            "from shifu_tpu_torch.obs import aggregate, render, timeline\n"
            "assert 'torch' not in sys.modules, 'torch'\n"
            "from shifu_tpu_torch.data import shard_paths\n"
            "assert 'shifu_tpu_torch.data.pipeline' not in sys.modules\n"
            "from shifu_tpu_torch.models import build_model\n"
            "assert 'shifu_tpu_torch.models.ft_transformer' not in "
            "sys.modules\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


# -- models.register ----------------------------------------------------------

@pytest.fixture
def registries():
    """Both packages' builder tables, restored after the test."""
    from shifu_tpu.models import registry as jax_registry
    from shifu_tpu_torch.models import registry
    saved = dict(registry._BUILDERS), dict(jax_registry._BUILDERS)
    yield registry, jax_registry
    for table, old in zip((registry._BUILDERS, jax_registry._BUILDERS),
                          saved):
        table.clear()
        table.update(old)


def _specs(model_type: str):
    from shifu_tpu.config import schema as jax_schema
    from shifu_tpu.data import synthetic as jax_synth
    from shifu_tpu_torch.config import schema as port_schema
    from shifu_tpu_torch.data import synthetic
    return ((port_schema.ModelSpec(model_type=model_type,
                                   hidden_nodes=(8,),
                                   activations=("relu",)),
             synthetic.make_schema(num_features=6)),
            (jax_schema.ModelSpec(model_type=model_type, hidden_nodes=(8,),
                                  activations=("relu",)),
             jax_synth.make_schema(num_features=6)))


def test_an_unknown_model_type_raises_jax_s_key_error(registries):
    from shifu_tpu.models import build_model as jax_build_model
    from shifu_tpu_torch.models import build_model
    (spec, schema), (jspec, jschema) = _specs("no_such_model")
    with pytest.raises(KeyError) as got:
        build_model(spec, schema, device="cpu")
    with pytest.raises(KeyError) as want:
        jax_build_model(jspec, jschema)
    assert str(got.value) == str(want.value)
    assert "available: ['deepfm', 'ft_transformer', 'mlp', 'moe_mlp', " \
        "'multitask', 'wide_deep']" in str(got.value)


def test_a_user_builder_under_a_new_name_is_built(registries):
    from shifu_tpu.models import build_model as jax_build_model
    from shifu_tpu.models import register as jax_register
    from shifu_tpu_torch.models import ShifuMLP, build_model, register
    seen = []

    @register("user_mlp")
    def _port(spec, schema, generator, mesh=None):
        seen.append(("port", spec.model_type, mesh))
        return ShifuMLP(dataclasses.replace(spec, model_type="mlp"),
                        schema.feature_count, generator)

    @jax_register("user_mlp")
    def _jax(spec, schema, mesh=None):
        from shifu_tpu.models import ShifuMLP as JaxMLP
        seen.append(("jax", spec.model_type, mesh))
        return JaxMLP(spec=dataclasses.replace(spec, model_type="mlp"))

    (spec, schema), (jspec, jschema) = _specs("user_mlp")
    model = build_model(spec, schema, device="cpu",
                        generator=torch.Generator().manual_seed(3))
    jax_build_model(jspec, jschema)
    assert seen == [("port", "user_mlp", None), ("jax", "user_mlp", None)]
    ref = ShifuMLP(dataclasses.replace(spec, model_type="mlp"), 6,
                   torch.Generator().manual_seed(3))
    x = torch.randn(5, 6, generator=torch.Generator().manual_seed(4))
    assert not model.training
    torch.testing.assert_close(model(x), ref.eval()(x), rtol=0, atol=0)


def test_re_registering_mlp_replaces_its_builder(registries):
    from shifu_tpu.models import build_model as jax_build_model
    from shifu_tpu.models import register as jax_register
    from shifu_tpu_torch.models import build_model, register
    (spec, schema), (jspec, jschema) = _specs("mlp")
    sentinel, jax_sentinel = torch.nn.Identity(), object()
    register("mlp")(lambda *a, **k: sentinel)
    jax_register("mlp")(lambda *a, **k: jax_sentinel)
    assert build_model(spec, schema, device="cpu") is sentinel
    assert jax_build_model(jspec, jschema) is jax_sentinel
    port, jax = registries
    assert sorted(port._BUILDERS) == sorted(jax._BUILDERS)


def test_the_registries_hold_the_same_ladder():
    from shifu_tpu.models import registry as jax_registry
    from shifu_tpu_torch.models import registry
    assert sorted(registry._BUILDERS) == sorted(jax_registry._BUILDERS)


# -- reader shards ------------------------------------------------------------

@pytest.mark.parametrize("n_paths,shards", [(0, 2), (3, 2), (5, 3), (2, 4),
                                            (7, 1)])
def test_shard_paths_equals_jax(n_paths, shards):
    from shifu_tpu.data import shard_paths as jax_shard_paths
    from shifu_tpu_torch.data import shard_paths
    paths = [f"part-{i:05d}.gz" for i in range(n_paths)]
    got = [shard_paths(paths, i, shards) for i in range(shards)]
    assert got == [jax_shard_paths(paths, i, shards)
                   for i in range(shards)]
    assert sorted(p for s in got for p in s) == paths


@pytest.mark.parametrize("chunk_rows", [1, 7, 100, 262144])
def test_iter_file_rows_equals_jax(tmp_path, chunk_rows):
    from shifu_tpu.data import reader as jax_reader
    from shifu_tpu_torch.data import reader, synthetic
    schema = synthetic.make_schema(num_features=4)
    paths = synthetic.write_files(
        synthetic.make_rows(150, schema, seed=5), str(tmp_path),
        num_files=3)
    got = list(reader.iter_file_rows(paths, chunk_rows=chunk_rows))
    want = list(jax_reader.iter_file_rows(paths, chunk_rows=chunk_rows))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(np.concatenate(got),
                                  np.concatenate(reader.read_files(paths)))


# -- build_program ------------------------------------------------------------

LADDER = ["mlp", "wide_deep", "deepfm", "multitask", "moe_mlp",
          "ft_transformer"]


@pytest.mark.parametrize("model_type", LADDER)
def test_build_program_equals_jax(model_type):
    from shifu_tpu.config import schema as jax_schema
    from shifu_tpu.data import synthetic as jax_synth
    from shifu_tpu.export import build_program as jax_build_program
    from shifu_tpu_torch.config import schema as port_schema
    from shifu_tpu_torch.data import synthetic
    from shifu_tpu_torch.export import build_program
    kw = dict(model_type=model_type, hidden_nodes=(8, 4),
              activations=("relu", "tanh"), embedding_dim=4, token_dim=8,
              num_layers=2, num_attention_heads=2, num_experts=2,
              num_heads=2 if model_type == "multitask" else 1)
    schema = synthetic.make_schema(num_features=7, num_categorical=2,
                                   vocab_size=11)
    jschema = jax_synth.make_schema(num_features=7, num_categorical=2,
                                    vocab_size=11)
    got = build_program(port_schema.ModelSpec(**kw), schema)
    want = jax_build_program(jax_schema.ModelSpec(**kw), jschema)
    assert got is not None
    assert json.loads(json.dumps(got)) == json.loads(json.dumps(want))
    no_schema = (build_program(port_schema.ModelSpec(**kw)),
                 jax_build_program(jax_schema.ModelSpec(**kw)))
    assert json.loads(json.dumps(no_schema[0])) == json.loads(
        json.dumps(no_schema[1]))


def test_build_program_of_an_unknown_type_is_none():
    from shifu_tpu_torch.config import schema as port_schema
    from shifu_tpu_torch.export import build_program
    assert build_program(port_schema.ModelSpec(model_type="user_type")) \
        is None


# -- metrics ------------------------------------------------------------------

VALUES = [0.0, 0.0005, 0.0007, 0.001, 0.3, 0.3, 2.5, 7.0, 299.0, 300.0,
          301.0, 1e9]


def _ops(obs_metrics, registry):
    """One sequence of operations on a registry of `obs_metrics`."""
    registry.counter("requests_total", "requests").inc(3, engine="torch")
    registry.counter("requests_total").inc(engine="numpy")
    g = registry.gauge("depth", "queue depth")
    g.set(4.5)
    g.inc(-1.5, pool="a")
    h = registry.histogram("latency_seconds", "latency")
    h.observe_many(VALUES, route="/score")
    h.observe(0.02, route="/score")
    h.observe_many([], route="/empty")
    registry.histogram("tiny", buckets=(1.0, 2.0)).observe_many([0.5, 3.0])
    return registry


def test_observe_many_equals_a_loop_of_observe_and_jax():
    from shifu_tpu.obs import metrics as jax_metrics
    from shifu_tpu_torch.obs import metrics
    bulk = metrics.MetricsRegistry().histogram("h")
    loop = metrics.MetricsRegistry().histogram("h")
    jax_h = jax_metrics.MetricsRegistry().histogram("h")
    bulk.observe_many(VALUES, k="v")
    jax_h.observe_many(VALUES, k="v")
    for v in VALUES:
        loop.observe(v, k="v")
    assert bulk.counts(k="v") == loop.counts(k="v") == jax_h.counts(k="v")
    assert bulk.quantile(0.5, k="v") == jax_h.quantile(0.5, k="v")


def test_snapshot_equals_jax_as_json():
    from shifu_tpu.obs import metrics as jax_metrics
    from shifu_tpu_torch.obs import metrics
    got = _ops(metrics, metrics.MetricsRegistry()).snapshot()
    want = _ops(jax_metrics, jax_metrics.MetricsRegistry()).snapshot()
    assert json.dumps(got, sort_keys=True) == json.dumps(want,
                                                         sort_keys=True)
    assert got["latency_seconds"]["values"]["route=/score"]["count"] == 13
    assert metrics.MetricsRegistry().snapshot() == {}


def test_metrics_defines_each_instrument_once():
    with open(os.path.join(PORT_ROOT, "obs", "metrics.py")) as f:
        tree = ast.parse(f.read())
    names = [n.name for n in tree.body if isinstance(n, ast.ClassDef)]
    assert sorted(names) == ["Counter", "Gauge", "Histogram",
                             "MetricsRegistry"]
    from shifu_tpu_torch.obs import metrics
    assert metrics.Histogram.quantile


# -- force --------------------------------------------------------------------

def _build(which: str, out_dir: str, force: bool) -> str:
    from shifu_tpu_torch.runtime import native_scorer, nativelib
    if which == "nativelib":
        return nativelib.build_library("shifu_parser.cc", out_dir=out_dir,
                                       force=force)
    return native_scorer.build_library(out_dir=out_dir, force=force)


@pytest.mark.parametrize("which", ["nativelib", "native_scorer"])
def test_force_rebuilds_a_current_library(tmp_path, which):
    path = _build(which, str(tmp_path), force=False)
    first = os.stat(path)
    assert _build(which, str(tmp_path), force=False) == path
    again = os.stat(path)
    assert (again.st_ino, again.st_mtime_ns) == (first.st_ino,
                                                 first.st_mtime_ns)
    assert _build(which, str(tmp_path), force=True) == path
    rebuilt = os.stat(path)
    assert (rebuilt.st_ino, rebuilt.st_mtime_ns) != (first.st_ino,
                                                     first.st_mtime_ns)
