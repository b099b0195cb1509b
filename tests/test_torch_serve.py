"""The port's serving path: artifacts, `TorchScorer` and `ScoringDaemon`
(shifu_tpu_torch/export, shifu_tpu_torch/runtime/serve.py), on the CPU.

Artifacts written by the JAX package's `save_artifact` score the same in
the port as in the JAX package's numpy `Scorer` and `JaxScorer`; the golden
MLP fixture scores to its pinned probabilities.
"""

import dataclasses
import os
import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from shifu_tpu_torch.config.schema import (ColumnSpec, DataSchema,
                                           ModelSpec, ServingConfig)
from shifu_tpu_torch.export.artifact import (flat_params, load_artifact,
                                             save_artifact)
from shifu_tpu_torch.export.scorer import BatchScorer, TorchScorer
from shifu_tpu_torch.models.registry import build_model
from shifu_tpu_torch.ops import ft_block, small_attention
from shifu_tpu_torch.runtime.serve import (ModelRegistry, ScoringDaemon,
                                           ServeOverload, bucket_for,
                                           bucket_ladder)

_GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "fixtures", "golden_mlp")
N_FEAT, N_CAT = 7, 2
# f32 compute on both sides: summation order only
F32_TOL = 1e-5


def _rows(n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, N_FEAT)).astype(np.float32)
    x[:, N_FEAT - N_CAT:] = rng.integers(-1, 14, size=(n, N_CAT))
    return x


@pytest.fixture(scope="module")
def jax_ft_artifact(tmp_path_factory):
    """A tiny FT-Transformer exported by the JAX package at f32 compute."""
    from shifu_tpu.config import JobConfig
    from shifu_tpu.config.schema import ModelSpec as JaxModelSpec
    from shifu_tpu.data import synthetic
    from shifu_tpu.export.artifact import save_artifact as jax_save
    from shifu_tpu.models.registry import build_model as jax_build

    schema = synthetic.make_schema(num_features=N_FEAT,
                                   num_categorical=N_CAT, vocab_size=11)
    spec = JaxModelSpec(model_type="ft_transformer", token_dim=16,
                        num_layers=2, num_attention_heads=2, mlp_ratio=2,
                        compute_dtype="float32", fused_block="off")
    job = JobConfig(schema=schema, model=spec).validate()
    model = jax_build(spec, schema)
    params = jax.jit(model.init)(jax.random.PRNGKey(7),
                                 jnp.zeros((2, N_FEAT)))["params"]
    out = str(tmp_path_factory.mktemp("jax_ft") / "model")
    jax_save(params, job, out)
    return out


def _port_schema():
    cols = [ColumnSpec(0, "target", is_target=True)] + [
        ColumnSpec(i, f"f{i}", is_selected=True,
                   is_categorical=i > N_FEAT - N_CAT,
                   vocab_size=11 if i > N_FEAT - N_CAT else 0)
        for i in range(1, N_FEAT + 1)]
    return DataSchema(columns=tuple(cols), target_index=0,
                      selected_indices=tuple(range(1, N_FEAT + 1)))


def _port_ft_artifact(path, seed=0, **kw):
    spec = ModelSpec(model_type="ft_transformer", token_dim=16, num_layers=1,
                     num_attention_heads=2, mlp_ratio=2,
                     compute_dtype="float32", **kw)
    model = build_model(spec, _port_schema(), device="cpu",
                        generator=torch.Generator().manual_seed(seed))
    return save_artifact(model, spec, _port_schema(), str(path)), model


def test_jax_artifact_scores_like_numpy_scorer_and_jax_scorer(
        jax_ft_artifact):
    from shifu_tpu.export.scorer import JaxScorer, Scorer
    x = _rows(9)
    got = TorchScorer(jax_ft_artifact, device="cpu").compute_batch(x)
    assert got.shape == (9, 1) and got.dtype == np.float32
    np.testing.assert_allclose(got, Scorer(jax_ft_artifact).compute_batch(x),
                               rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(got,
                               JaxScorer(jax_ft_artifact).compute_batch(x),
                               rtol=F32_TOL, atol=F32_TOL)
    assert ft_block.fused_transformer_block.launches == 0
    assert small_attention.small_token_attention.launches == 0


def test_golden_mlp_fixture():
    rows = np.load(os.path.join(_GOLDEN, "probe_rows.npy"))
    want = np.load(os.path.join(_GOLDEN, "probe_scores.npy"))
    scorer = TorchScorer(_GOLDEN, device="cpu")
    np.testing.assert_allclose(scorer.compute_batch(rows), want,
                               rtol=1e-5, atol=1e-6)
    assert scorer.compute(rows[0]) == pytest.approx(float(want[0, 0]),
                                                    rel=1e-5)


def test_save_load_round_trip_is_exact(tmp_path):
    out, model = _port_ft_artifact(tmp_path / "m", seed=3)
    art = load_artifact(out)
    assert art.spec == ModelSpec(**{
        f.name: getattr(art.spec, f.name)
        for f in dataclasses.fields(ModelSpec)})
    assert art.schema == _port_schema()
    from shifu_tpu_torch.export.program import build_program_v2
    assert art.topology["program"] == build_program_v2(art.spec, art.schema)
    assert art.topology["program_version"] == 2
    want = flat_params(model)
    assert sorted(art.weights) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(art.weights[k], v)
    x = _rows(5, seed=1)
    with torch.inference_mode():
        direct = torch.sigmoid(model(torch.from_numpy(x))).numpy()
    np.testing.assert_array_equal(
        TorchScorer(out, device="cpu").compute_batch(x), direct)


def test_port_artifact_reads_in_the_jax_package(tmp_path):
    """The JAX package rebuilds the port's artifact from its topology and
    weights (JaxScorer) and scores it the same."""
    from shifu_tpu.export.scorer import JaxScorer
    out, _ = _port_ft_artifact(tmp_path / "m", seed=4, fused_block="off")
    x = _rows(6, seed=2)
    np.testing.assert_allclose(
        TorchScorer(out, device="cpu").compute_batch(x),
        JaxScorer(out).compute_batch(x), rtol=F32_TOL, atol=F32_TOL)


def test_scorer_rejects_bad_width_and_extra_inputs(tmp_path):
    out, _ = _port_ft_artifact(tmp_path / "m")
    scorer = TorchScorer(out, device="cpu")
    with pytest.raises(ValueError, match="features"):
        scorer.compute_batch(np.zeros((2, N_FEAT + 1), np.float32))
    import json
    path = os.path.join(out, "GenericModelConfig.json")
    with open(path) as f:
        sidecar = json.load(f)
    sidecar["inputnames"].append("aux")
    with open(path, "w") as f:
        json.dump(sidecar, f)
    with pytest.raises(ValueError, match="extra named inputs"):
        TorchScorer(out, device="cpu")


def test_cuda_scorer_raises_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the request is valid here")
    out, _ = _port_ft_artifact(tmp_path / "m")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TorchScorer(out, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TorchScorer(out)  # the default device is the card


def test_bucket_ladder():
    assert bucket_ladder(16, 4096) == (16, 32, 64, 128, 256, 512, 1024,
                                       2048, 4096)
    assert bucket_ladder(4, 20) == (4, 8, 16, 20)
    ladder = bucket_ladder(4, 20)
    assert [bucket_for(n, ladder) for n in (1, 4, 5, 17, 20, 99)] == \
        [4, 4, 8, 20, 20, 20]


def test_daemon_submit_score_and_batch(tmp_path):
    out, _ = _port_ft_artifact(tmp_path / "m", seed=5)
    ref = TorchScorer(out, device="cpu")
    x = _rows(40, seed=3)
    want = ref.compute_batch(x)
    cfg = ServingConfig(max_batch=16, min_batch_bucket=4,
                        latency_budget_ms=5.0)
    daemon = ScoringDaemon(out, config=cfg, device="cpu").start()
    try:
        results = {}

        def client(lo, hi):
            futs = [(i, daemon.submit(x[i])) for i in range(lo, hi)]
            for i, f in futs:
                results[i] = f.result(timeout=30)

        threads = [threading.Thread(target=client, args=(i * 10, i * 10 + 10))
                   for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        single = daemon.score(x[30].tolist(), timeout=30)
        frame = daemon.score_batch(x[31:])
        stats = daemon.stats()
    finally:
        daemon.stop()
    np.testing.assert_allclose(np.stack([results[i] for i in range(30)]),
                               want[:30], rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(single, want[30], rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(frame, want[31:], rtol=F32_TOL, atol=F32_TOL)
    assert stats["requests"] == 31 and stats["errors"] == 0
    assert stats["direct_rows"] == 9 and stats["direct_batches"] == 1
    assert stats["batch_rows"] == 31
    assert 1 <= stats["batches"] <= 31
    assert stats["batch_mean"] == pytest.approx(31 / stats["batches"])
    # every dispatched batch was padded up to a rung of the ladder
    assert stats["batch_rows"] <= stats["padded_rows"] <= \
        stats["batches"] * cfg.max_batch
    assert stats["p50_ms"] is not None and stats["p99_ms"] >= stats["p50_ms"]
    assert stats["engine"] == "torch" and stats["num_features"] == N_FEAT


class _Failing(BatchScorer):
    engine = "failing"
    static_shapes = True
    num_features = N_FEAT

    def _score_batch(self, x):
        raise RuntimeError("device lost")


def test_daemon_scoring_error_resolves_futures_and_counts():
    reg = ModelRegistry(loader=lambda d, e: _Failing())
    reg.load("unused", warm=False)
    daemon = ScoringDaemon(registry=reg).start()
    try:
        futs = [daemon.submit(np.zeros(N_FEAT, np.float32))
                for _ in range(3)]
        for f in futs:
            with pytest.raises(RuntimeError, match="device lost"):
                f.result(timeout=30)
        with pytest.raises(RuntimeError, match="device lost"):
            daemon.score_batch(np.zeros((2, N_FEAT), np.float32))
        stats = daemon.stats()
    finally:
        daemon.stop()
    assert stats["errors"] == 5 and stats["requests"] == 0


def test_daemon_overload_and_stop_drains(tmp_path):
    out, _ = _port_ft_artifact(tmp_path / "m")
    cfg = ServingConfig(max_batch=8, min_batch_bucket=4, queue_limit=3,
                        latency_budget_ms=60_000.0, prewarm_ladder=False)
    daemon = ScoringDaemon(out, config=cfg, device="cpu").start()
    futs = [daemon.submit(np.zeros(N_FEAT, np.float32)) for _ in range(3)]
    with pytest.raises(ServeOverload):
        daemon.submit(np.zeros(N_FEAT, np.float32))
    t0 = time.monotonic()
    daemon.stop()
    assert time.monotonic() - t0 < 30  # stop cut the 60 s window short
    assert all(f.result(timeout=1).shape == (1,) for f in futs)
    assert daemon.stats()["rejected"] == 1
    with pytest.raises(RuntimeError, match="not accepting"):
        daemon.submit(np.zeros(N_FEAT, np.float32))


def test_daemon_hot_swap_and_failed_swap(tmp_path):
    out1, _ = _port_ft_artifact(tmp_path / "a", seed=1)
    out2, _ = _port_ft_artifact(tmp_path / "b", seed=2)
    cfg = ServingConfig(max_batch=8, min_batch_bucket=4)
    daemon = ScoringDaemon(out1, config=cfg, device="cpu").start()
    try:
        x = _rows(1, seed=9)[0]
        before = daemon.score(x, timeout=30)
        res = daemon.swap(out2)
        assert res["ok"] and res["version"] == 2
        after = daemon.score(x, timeout=30)
        np.testing.assert_allclose(
            after, TorchScorer(out2, device="cpu").compute_batch(x)[0],
            rtol=F32_TOL, atol=F32_TOL)
        assert not np.allclose(before, after)
        bad = daemon.swap(str(tmp_path / "missing"))
        assert not bad["ok"] and bad["kept_version"] == 2
        assert daemon.stats()["swaps_failed"] == 1
    finally:
        daemon.stop()


def test_daemon_rejects_malformed_rows(tmp_path):
    out, _ = _port_ft_artifact(tmp_path / "m")
    daemon = ScoringDaemon(out, config=ServingConfig(
        max_batch=8, min_batch_bucket=4), device="cpu").start()
    try:
        with pytest.raises(ValueError, match="features"):
            daemon.submit(np.zeros(N_FEAT + 2, np.float32))
    finally:
        daemon.stop()


def test_serving_config_validates():
    from shifu_tpu_torch.config.schema import ConfigError
    for kw in (dict(engine="jax"), dict(max_batch=0),
               dict(min_batch_bucket=64, max_batch=32),
               dict(latency_budget_ms=0), dict(queue_limit=0)):
        with pytest.raises(ConfigError):
            ServingConfig(**kw).validate()


def test_stats_percentiles_read_the_slo_engines_histogram():
    """`stats()` p50/p99 come from the one latency record the daemon
    keeps, as in the JAX daemon: the shared `score_latency_seconds`
    histogram (admission to reply) windowed to this daemon, the series the
    SLO engine reads.  One batch of 100 requests whose scheduled arrivals
    are 1 ms apart."""
    from shifu_tpu_torch.export.scorer import SCORE_LATENCY_BUCKETS
    from shifu_tpu_torch.obs.metrics import quantile_from_counts
    reg = ModelRegistry(loader=lambda d, e: _Stub())
    reg.load("unused", warm=False)
    cfg = ServingConfig(max_batch=100, min_batch_bucket=4,
                        latency_budget_ms=60_000.0, report_every_s=0.0)
    daemon = ScoringDaemon(registry=reg, config=cfg).start()
    try:
        base = time.perf_counter()
        futs = [daemon.submit(np.zeros(N_FEAT, np.float32),
                              t_arrival=base - k * 1e-3) for k in range(100)]
        for f in futs:
            f.result(timeout=30)
        deadline = time.monotonic() + 10
        while (sum(daemon._windowed_latency_counts() or []) < 100
               and time.monotonic() < deadline):
            time.sleep(0.01)  # the histogram is fed after the reply
        counts = daemon._windowed_latency_counts()
        stats = daemon.stats()
    finally:
        daemon.stop()
    assert stats["batches"] == 1 and sum(counts) == 100
    assert (stats["p50_ms"], stats["p99_ms"]) == tuple(
        round(quantile_from_counts(SCORE_LATENCY_BUCKETS, counts, 100, q)
              * 1e3, 3) for q in (0.50, 0.99))
    # latencies of 0-99 ms plus the dispatch: the median lies past the
    # 25 ms bound, and the 99th percentile in a later bucket
    assert 25 < stats["p50_ms"] < stats["p99_ms"]


class _Stub(BatchScorer):
    engine = "stub"
    num_features = N_FEAT

    def _score_batch(self, x):
        return np.zeros((x.shape[0], 1), np.float32)
