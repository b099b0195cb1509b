"""The last two models of the JAX ladder in the port
(shifu_tpu_torch/models/multitask.py, models/moe.py) against the JAX
package's, on the CPU at small sizes.

Inputs are made with numpy from a seed and handed to both packages; the
port starts from the JAX package's parameters (`params_from_jax`: the
per-head towers and the stacked (E, in, out) expert leaves carry across by
name).  Tolerances:
- forward in f32: rtol/atol 1e-5 (the same products, other summation
  orders);
- the train step in f32 with dropout 0: per-step losses rtol 1e-5 over 10
  steps (as tests/test_torch_train.py);
- `train()` end to end: per-epoch train_error rtol 1e-4, valid_auc within
  1e-3 absolute (as tests/test_torch_train.py);
- `evaluate` on multi-head logits: head 0 against target column 0, the
  JAX loop's rule, within 1e-6 of the JAX evaluate;
- the train step's FLOPs: exactly the closed form of the model's products.
The Shifu MTL and MOE configurations train through both packages' `train`
command on the CPU.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from shifu_tpu.config import schema as jax_schema
from shifu_tpu.data import pipeline as jax_pipe
from shifu_tpu.data import reader as jax_reader
from shifu_tpu.data import synthetic as jax_synth
from shifu_tpu.export.artifact import _flatten_params
from shifu_tpu.models.registry import build_model as jax_build
from shifu_tpu.train import loop as jax_loop
from shifu_tpu.train import step as jax_step
from shifu_tpu_torch import obs
from shifu_tpu_torch.config import schema as port_schema
from shifu_tpu_torch.data import pipeline as pipe
from shifu_tpu_torch.export.artifact import params_from_jax
from shifu_tpu_torch.models.registry import build_model
from shifu_tpu_torch.obs import flops
from shifu_tpu_torch.train import loop, step

F = 12
HIDDEN = (16, 8)

# what a `train` command exports into os.environ (a chaos plan and its
# state file, among others), which an earlier test file in the worker may
# have left behind
_CLI_ENV = ("SHIFU_TPU_CHAOS_PLAN", "SHIFU_TPU_CHAOS_STATE",
            "SHIFU_TPU_METRICS_DIR", "SHIFU_TPU_DATA_CACHE",
            "SHIFU_TPU_PDEATHSIG")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    from shifu_tpu import chaos as jax_chaos
    from shifu_tpu import obs as jax_obs
    from shifu_tpu_torch import chaos
    for var in _CLI_ENV:
        monkeypatch.delenv(var, raising=False)
    for m in (obs, jax_obs, chaos, jax_chaos):
        m.reset_for_tests()
    yield
    for var in _CLI_ENV:
        os.environ.pop(var, None)
    for m in (obs, jax_obs, chaos, jax_chaos):
        m.reset_for_tests()

# (model_type, ModelSpec keywords, targets in the data)
CASES = {
    "multitask": (dict(model_type="multitask", num_heads=2,
                       head_names=("shifu_output_0", "shifu_output_1")), 2),
    "multitask3": (dict(model_type="multitask", num_heads=3,
                        head_names=tuple(f"shifu_output_{h}"
                                         for h in range(3))), 3),
    "moe": (dict(model_type="moe_mlp", num_experts=4), 1),
    "moe2": (dict(model_type="moe_mlp", num_experts=2), 1),
}


def _spec_kw(case, acts=("relu", "tanh"), **kw):
    model_kw, _ = CASES[case]
    return {**dict(model_kw, hidden_nodes=HIDDEN, activations=acts,
                   compute_dtype="float32"), **kw}


def _schema(case):
    return jax_synth.make_schema(F, num_targets=CASES[case][1])


def _jobs(case, epochs=3, wire="int8", **model_kw):
    jjob = jax_schema.JobConfig(
        schema=_schema(case),
        data=jax_schema.DataConfig(batch_size=64, wire_dtype=wire),
        model=jax_schema.ModelSpec(**_spec_kw(case, **model_kw)),
        train=jax_schema.TrainConfig(
            epochs=epochs, optimizer=jax_schema.OptimizerConfig(
                name="adam", learning_rate=0.01))).validate()
    pjob = port_schema.JobConfig.from_dict(json.loads(jjob.to_json()))
    return jjob, pjob.validate()


def _datasets(case, n_train=1024, n_valid=300, seed=0):
    schema = _schema(case)
    cols = jax_reader.project_columns(
        jax_synth.make_rows(n_train + n_valid, schema, seed=seed), schema)

    def part(lo, hi, mod):
        return mod.TabularDataset(cols["features"][lo:hi],
                                  cols["target"][lo:hi],
                                  cols["weight"][lo:hi])
    return ((part(0, n_train, jax_pipe), part(n_train, None, jax_pipe)),
            (part(0, n_train, pipe), part(n_train, None, pipe)))


def _flat(params):
    return {k: np.asarray(v)
            for k, v in _flatten_params(jax.device_get(params)).items()}


def _carry(jstate, pjob):
    state = loop.init_state(pjob, F, "cpu")
    state.model.load_state_dict(params_from_jax(_flat(jstate.params),
                                                state.model))
    return state


# -- forward -------------------------------------------------------------------

@pytest.mark.parametrize("acts", [("relu", "tanh"), ("sigmoid", "leakyrelu")])
@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_matches_flax_with_carried_params(case, acts):
    jspec = jax_schema.ModelSpec(**_spec_kw(case, acts))
    model = jax_build(jspec, _schema(case))
    params = model.init(jax.random.PRNGKey(3), jnp.zeros((2, F)))["params"]
    x = np.random.default_rng(1).normal(size=(40, F)).astype(np.float32)
    want = np.asarray(model.apply({"params": params}, jnp.asarray(x)))
    pspec = port_schema.ModelSpec(**_spec_kw(case, acts))
    pschema = port_schema.JobConfig.from_dict(json.loads(
        jax_schema.JobConfig(schema=_schema(case)).to_json())).schema
    mine = build_model(pspec, pschema, device="cpu")
    flat = _flat(params)
    assert sorted(k.replace("/", ".") for k in flat) \
        == sorted(mine.state_dict())
    mine.load_state_dict(params_from_jax(flat, mine))
    with torch.no_grad():
        got = mine(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    assert got.shape == (40, pspec.num_heads)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_parameter_layout_and_init_distribution():
    """The towers' width is max(hidden[-1] // 2, 4); the stacked expert
    kernels are (E, in, out), Xavier-uniform per expert over (in, out)
    (limit sqrt(6 / (in + out))), the biases zero."""
    _, pjob = _jobs("multitask")
    mt = build_model(pjob.model, pjob.schema, device="cpu")
    sd = mt.state_dict()
    assert sd["tower_0.Dense_0.kernel"].shape == (HIDDEN[-1], 4)
    assert sd["shifu_output_1.Dense_0.kernel"].shape == (4, 1)
    _, mjob = _jobs("moe", hidden_nodes=(64, 48), acts=("relu", "relu"))
    moe = build_model(mjob.model, mjob.schema, device="cpu",
                      generator=torch.Generator().manual_seed(5))
    k0 = moe.state_dict()["experts.kernel0"]
    assert k0.shape == (4, F, 64)
    assert moe.state_dict()["experts.bias1"].shape == (4, 48)
    assert float(moe.state_dict()["experts.bias0"].abs().max()) == 0.0
    limit = np.sqrt(6.0 / (F + 64))
    assert float(k0.abs().max()) <= limit
    assert float(k0.abs().max()) > 0.9 * limit
    # every expert draws its own numbers
    assert not torch.equal(k0[0], k0[1])


# -- the train step ------------------------------------------------------------

@pytest.mark.parametrize("case", ["multitask", "moe"])
def test_train_step_lockstep(case):
    jjob, pjob = _jobs(case)
    jstate = jax_loop.init_state(jjob, F)
    state = _carry(jstate, pjob)
    jtrain = jax_step.make_train_step(jjob)
    ptrain = step.make_train_step(pjob)
    (_, _), (ptr, _) = _datasets(case)
    wcast = pipe.wire_cast_fn(pjob.schema, pjob.data, "float32",
                              compact=True)
    jl, pl = [], []
    for i, batch in enumerate(pipe.batch_iterator(ptr, 64, seed=1)):
        if i == 10:
            break
        b = wcast(batch)
        jstate, jm = jtrain(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        state, pm = ptrain(state, loop.to_device(b, pjob,
                                                 torch.device("cpu")))
        jl.append(float(jm["loss"]))
        pl.append(float(pm["loss"]))
    assert state.step == 10
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    # the parameters moved alike too
    want = _flat(jstate.params)
    for k, v in state.model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k.replace(".", "/")],
                                   rtol=1e-4, atol=1e-5, err_msg=k)


# -- train() and evaluate --------------------------------------------------------

@pytest.mark.parametrize("case", ["multitask", "moe"])
def test_train_matches_jax_train(monkeypatch, case):
    jjob, pjob = _jobs(case)
    (jtr, jva), (ptr, pva) = _datasets(case)
    jres = jax_loop.train(jjob, jtr, jva, console=lambda s: None)
    jinit = jax_loop.init_state(jjob, F)  # the same seed: the same init
    real_init = loop.init_state

    def carried(job, num_features, device=None):
        state = real_init(job, num_features, device)
        state.model.load_state_dict(params_from_jax(_flat(jinit.params),
                                                    state.model))
        return state

    monkeypatch.setattr(loop, "init_state", carried)
    pres = loop.train(pjob, ptr, pva, console=lambda s: None, device="cpu")
    assert len(pres.history) == len(jres.history) == 3
    for g, w in zip(pres.history, jres.history):
        assert g.train_error == pytest.approx(w.train_error, rel=1e-4)
        assert g.valid_error == pytest.approx(w.valid_error, rel=1e-4)
        assert abs(g.valid_auc - w.valid_auc) <= 1e-3
    # the frozen baseline rides the result, as in the JAX loop
    assert pres.baseline_profile["num_features"] == F
    assert pres.baseline_profile["rows"] \
        == jres.baseline_profile["rows"] == 1024


def test_evaluate_scores_head_0_against_target_column_0():
    jjob, pjob = _jobs("multitask3")
    jstate = jax_loop.init_state(jjob, F)
    state = _carry(jstate, pjob)
    (_, jva), (_, pva) = _datasets("multitask3", n_valid=500)
    assert pva.target.shape[1] == 3
    got = loop.evaluate(state, pva, pjob, step.make_eval_step(pjob),
                        torch.device("cpu"))
    want = jax_loop.evaluate(jstate, jva, jjob, jax_step.make_eval_step(jjob))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    # by hand: the first head's probabilities against the first target
    from shifu_tpu_torch.ops.metrics import StreamingMetrics
    wcast = pipe.wire_cast_fn(pjob.schema, pjob.data, "float32")
    feats = wcast({"features": pva.features})["features"]
    with torch.no_grad():
        probs = step.make_eval_step(pjob)(
            state, {"features": torch.from_numpy(feats)}).numpy()
    assert probs.shape == (500, 3)
    sm = StreamingMetrics()
    sm.update(probs[:, 0], pva.target[:, 0], pva.weight[:, 0])
    assert got == pytest.approx((sm.weighted_error(), sm.auc()), abs=1e-6)
    other = StreamingMetrics()
    other.update(probs[:, 1], pva.target[:, 1], pva.weight[:, 0])
    assert other.auc() != pytest.approx(got[1], abs=1e-6)


# -- FLOPs ----------------------------------------------------------------------

def _dense_pairs(widths):
    return list(zip(widths[:-1], widths[1:]))


def _closed_form(case, batch, spec):
    """Forward products x 3 (forward, dX, dW), except where the input
    takes no gradient (the features): forward and dW only, x 2."""
    h = spec.hidden_nodes
    if spec.model_type == "multitask":
        tower = max(h[-1] // 2, 4)
        first = F * h[0]
        later = sum(a * b for a, b in _dense_pairs(h))
        later += spec.num_heads * (h[-1] * tower + tower * 1)
    else:
        e = spec.num_experts
        first = F * e + e * F * h[0]          # the gate, expert layer 0
        later = e * sum(a * b for a, b in _dense_pairs(h))
        later += e * h[-1]                     # the gate-weighted combine
        later += h[-1] * spec.num_heads        # the head
    return 2 * batch * (2 * first + 3 * later)


@pytest.mark.parametrize("case", ["multitask", "multitask3", "moe", "moe2"])
def test_train_step_counts_its_closed_form(case):
    obs.reset_for_tests()
    _, pjob = _jobs(case)
    state = loop.init_state(pjob, F, "cpu")
    (_, _), (ptr, _) = _datasets(case)
    wcast = pipe.wire_cast_fn(pjob.schema, pjob.data, "float32",
                              compact=True)
    batch = loop.to_device(wcast(next(pipe.batch_iterator(ptr, 64, seed=2))),
                           pjob, torch.device("cpu"))
    _, got = flops.count(step._train_step_fn(pjob), state, batch)
    assert got["flops"] == _closed_form(case, 64, pjob.model)
    obs.reset_for_tests()


# -- the Shifu configs through both `train` commands -----------------------------

@pytest.mark.parametrize("algorithm", ["MTL", "MOE"])
def test_shifu_config_trains_through_both_commands(tmp_path, algorithm):
    from shifu_tpu import obs as jax_obs
    from shifu_tpu.export.scorer import Scorer as JaxScorer
    from shifu_tpu.launcher import cli as jax_cli
    from shifu_tpu_torch.export.scorer import Scorer, TorchScorer
    from shifu_tpu_torch.launcher import cli
    from shifu_tpu_torch.utils import xmlconfig

    targets = 2 if algorithm == "MTL" else 1
    schema = jax_synth.make_schema(num_features=8, num_targets=targets)
    jax_synth.write_files(jax_synth.make_rows(600, schema, seed=7),
                          str(tmp_path / "data"), num_files=2)
    params = {"NumHiddenLayers": 2, "NumHiddenNodes": [8, 8],
              "ActivationFunc": ["relu", "relu"], "LearningRate": 0.01,
              "Propagation": "Q", "Loss": "squared", "NumExperts": 3}
    data_set = {"targetColumnName": "target0" if targets > 1 else "target",
                "dataDelimiter": "|"}
    if targets > 1:
        data_set["multiTargetColumnNames"] = ["target0", "target1"]
    mc = {"basic": {"name": algorithm.lower()}, "dataSet": data_set,
          "train": {"validSetRate": 0.2, "numTrainEpochs": 2,
                    "algorithm": algorithm, "params": params}}
    cc = [{"columnNum": c.index, "columnName": c.name,
           "columnFlag": "Target" if c.is_target else None,
           "columnType": "N", "finalSelect": c.is_selected}
          for c in schema.columns]
    (tmp_path / "ModelConfig.json").write_text(json.dumps(mc))
    (tmp_path / "ColumnConfig.json").write_text(json.dumps(cc))
    xmlconfig.write_configuration_xml(
        {"shifu.application.batch-size": "64",
         "shifu.checkpoint.save-seconds": "0",
         "shifu.liveness.seconds": "0"}, str(tmp_path / "global.xml"))
    argv = ["train", "--modelconfig", str(tmp_path / "ModelConfig.json"),
            "--columnconfig", str(tmp_path / "ColumnConfig.json"),
            "--data", str(tmp_path / "data"),
            "--globalconfig", str(tmp_path / "global.xml")]
    assert jax_cli.main(argv + ["--output", str(tmp_path / "j")]) == 0
    jax_obs.reset_for_tests()
    assert cli.main(argv + ["--output", str(tmp_path / "p"),
                            "--device", "cpu"]) == 0
    obs.reset_for_tests()
    jtop = json.loads((tmp_path / "j" / "final_model" /
                       "topology.json").read_text())
    ptop = json.loads((tmp_path / "p" / "final_model" /
                       "topology.json").read_text())
    assert ptop["model_type"] == jtop["model_type"] == {
        "MTL": "multitask", "MOE": "moe_mlp"}[algorithm]
    assert ptop["num_heads"] == jtop["num_heads"] == targets
    assert ptop["program"] == jtop["program"]
    for job in ("j", "p"):
        lines = (tmp_path / job / "metrics.jsonl").read_text().splitlines()
        assert [json.loads(ln)["epoch"] for ln in lines] == [0, 1]
        assert (tmp_path / job / "final_model" /
                "baseline_profile.json").exists()
    # the op-list interpreters of both packages score in f32 (1e-5); the
    # torch engine in the job's bf16 compute (the serving tolerance, 0.02)
    rows = np.random.default_rng(0).normal(size=(7, 8)).astype(np.float32)
    out = str(tmp_path / "p" / "final_model")
    want = Scorer(out).compute_batch(rows)
    assert want.shape == (7, targets) and np.all(np.isfinite(want))
    np.testing.assert_allclose(JaxScorer(out).compute_batch(rows), want,
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        TorchScorer(out, device="cpu").compute_batch(rows), want, atol=0.02)
