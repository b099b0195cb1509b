"""The port's operator tools (`shifu_tpu_torch/tools/`) against the repo's
JAX tools (`tools/`) on the same inputs.

- trace_diff: the device rollup diff (bare rollups and journals written by
  each package's own `obs`, with and without `--fail-above`, both
  directions, `--epoch`, the missing rollup), `--serving` (the SKIP and
  regression cases) and `--pod` (a rank slowed 4x): the `--json` reports
  and exit codes equal but for the `a`/`b` paths, the text equal line for
  line.
- profile_staged at a small size on the CPU through the module's
  function: the sizing equal to JAX's `wire_row_bytes` arithmetic, one
  `goodput` per wire with the JAX tool's fields and buckets that sum to
  the wall, and the inline epoch's summed loss within bf16 tolerance of
  JAX's `make_epoch_scan_step` on the same blocks from the same weights.
- loadtest: a 0.5 s in-process run with the port CLI's `loadtest --json`
  keys; the JAX engine names refused with the port's counterparts named.
"""

import importlib.util
import json
import os
import re

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_jax_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_td():
    return _load_jax_tool("trace_diff")


@pytest.fixture(scope="module")
def port_td():
    from shifu_tpu_torch.tools import trace_diff
    return trace_diff


def _both(jax_td, port_td, capsys, argv_jax, argv_port=None):
    """Each tool's (rc, stdout) on its argv (the port's defaults to the
    same argv)."""
    rc_j = jax_td.main(list(argv_jax))
    out_j = capsys.readouterr().out
    rc_p = port_td.main(list(argv_port or argv_jax))
    out_p = capsys.readouterr().out
    return (rc_j, out_j), (rc_p, out_p)


def _same(jax_side, port_side, as_json):
    (rc_j, out_j), (rc_p, out_p) = jax_side, port_side
    assert rc_p == rc_j
    if as_json:
        doc_j, doc_p = json.loads(out_j), json.loads(out_p)
        for doc in (doc_j, doc_p):
            doc.pop("a", None)
            doc.pop("b", None)
        assert doc_p == doc_j
        return doc_p
    assert out_p.splitlines() == out_j.splitlines()
    return out_p


# -- trace_diff: the device rollup diff ---------------------------------------

_ROLLUP_A = {"device_us_total": 100.0, "epoch": 0,
             "kernels": [{"name": "dot.1", "module": "jit_step", "calls": 3,
                          "device_us": 80.0},
                         {"name": "fusion.1", "module": "jit_step",
                          "calls": 3, "device_us": 20.0}]}


def _rollups(tmp_path):
    b = json.loads(json.dumps(_ROLLUP_A))
    b["device_us_total"] = 250.0
    b["kernels"][0]["device_us"] = 230.0
    b["kernels"].append({"name": "int8_matmul_panel", "module": "jit_step",
                         "calls": 3, "device_us": 5.0})
    pa, pb = tmp_path / "a.json", tmp_path / "b.json"
    pa.write_text(json.dumps(_ROLLUP_A))
    pb.write_text(json.dumps(b))
    return str(pa), str(pb)


@pytest.mark.parametrize("order", ["a_b", "b_a"])
@pytest.mark.parametrize("gate", [[], ["--fail-above", "50"]])
@pytest.mark.parametrize("as_json", [True, False])
def test_trace_diff_bare_rollups_equal_jax(jax_td, port_td, tmp_path, capsys,
                                           order, gate, as_json):
    pa, pb = _rollups(tmp_path)
    argv = ([pa, pb] if order == "a_b" else [pb, pa]) + gate \
        + (["--json"] if as_json else [])
    got = _same(*_both(jax_td, port_td, capsys, argv), as_json)
    if as_json:
        want = ("REGRESSION" if gate and order == "a_b" else "PASS")
        assert got["verdict"] == want
        if want == "REGRESSION":  # the kernel that grew and the total
            assert got["blamed"] == ["dot.1", "<device total>"]


def test_trace_diff_missing_rollup_is_a_usage_error(jax_td, port_td,
                                                    tmp_path, capsys):
    _pa, pb = _rollups(tmp_path)
    nope = str(tmp_path / "nope.json")
    (rc_j, _), (rc_p, _) = _both(jax_td, port_td, capsys, [nope, pb])
    assert rc_j == rc_p == port_td.EXIT_USAGE == 2
    # a journal with no device_profile, and --serving with --pod
    (tmp_path / "empty" / "telemetry").mkdir(parents=True)
    (tmp_path / "empty" / "telemetry" / "journal.jsonl").write_text(
        json.dumps({"ts": 1.0, "seq": 1, "kind": "epoch"}) + "\n")
    (rc_j, _), (rc_p, _) = _both(jax_td, port_td, capsys,
                                 [str(tmp_path / "empty"), pb])
    assert rc_j == rc_p == 2
    (rc_j, _), (rc_p, _) = _both(jax_td, port_td, capsys,
                                 [pb, pb, "--serving", "--pod"])
    assert rc_j == rc_p == 2


def _profile_events(us_by_epoch):
    return [dict(epoch=e, trigger="schedule", device_us_total=us,
                 kernels=[{"name": "int8_matmul_panel_kernel",
                           "module": "epoch_scan_step", "calls": 10,
                           "device_us": 0.7 * us},
                          {"name": "elementwise_kernel",
                           "module": "epoch_scan_step", "calls": 40,
                           "device_us": 0.3 * us}])
            for e, us in us_by_epoch]


def _write_journals(tmp_path, obs_mod, tag):
    """Two job dirs whose journals `obs_mod` (each package's own) wrote:
    a device_profile for epochs 0 and 1 each, B's epoch 1 twice A's."""
    out = []
    for sub, us in (("ja", (10.0, 20.0)), ("jb", (11.0, 40.0))):
        obs_mod.reset_for_tests()
        d = tmp_path / f"{tag}_{sub}" / "telemetry"
        obs_mod.configure(str(d))
        for ev in _profile_events(enumerate(us)):
            obs_mod.event("device_profile", **ev)
        obs_mod.flush()
        obs_mod.shutdown()
        out.append(str(tmp_path / f"{tag}_{sub}"))
    obs_mod.reset_for_tests()
    return out


@pytest.mark.parametrize("extra", [[], ["--epoch", "0"],
                                   ["--fail-above", "50"],
                                   ["--epoch", "0", "--fail-above", "50"]])
def test_trace_diff_reads_each_packages_journals(jax_td, port_td, tmp_path,
                                                 capsys, extra):
    """JAX's tool on journals the JAX package wrote, the port's on
    journals the port wrote (and on JAX's): equal reports and text."""
    from shifu_tpu import obs as jax_obs
    from shifu_tpu_torch import obs as port_obs

    ja, jb = _write_journals(tmp_path, jax_obs, "jax")
    pa, pb = _write_journals(tmp_path, port_obs, "port")
    reports = {}
    for key, (j1, j2, p1, p2) in {"ab": (ja, jb, pa, pb),
                                  "ba": (jb, ja, pb, pa)}.items():
        reports[key] = _same(*_both(jax_td, port_td, capsys,
                                    [j1, j2, *extra, "--json"],
                                    [p1, p2, *extra, "--json"]), True)
        _same(*_both(jax_td, port_td, capsys, [j1, j2, *extra],
                     [p1, p2, *extra]), False)
        (rc_j, out_j), (rc_p, out_p) = _both(jax_td, port_td, capsys,
                                             [j1, j2, *extra])
        assert rc_p == rc_j and out_p == out_j
    gated, latest = "--fail-above" in extra, "--epoch" not in extra
    doc = reports["ab"]
    assert doc["a_epoch"] == doc["b_epoch"] == (1 if latest else 0)
    # B's epoch 1 doubled every kernel; its epoch 0 grew 10%
    assert doc["verdict"] == ("REGRESSION" if gated and latest else "PASS")
    if gated and latest:
        assert doc["blamed"] == ["int8_matmul_panel_kernel",
                                 "elementwise_kernel", "<device total>"]
    assert reports["ba"]["verdict"] == "PASS"  # improvements never fail


def test_trace_diff_epoch_without_a_capture_is_a_usage_error(
        jax_td, port_td, tmp_path, capsys):
    from shifu_tpu import obs as jax_obs
    from shifu_tpu_torch import obs as port_obs

    ja, jb = _write_journals(tmp_path, jax_obs, "jax")
    pa, pb = _write_journals(tmp_path, port_obs, "port")
    (rc_j, _), (rc_p, _) = _both(jax_td, port_td, capsys,
                                 [ja, jb, "--epoch", "7"],
                                 [pa, pb, "--epoch", "7"])
    assert rc_j == rc_p == 2


# -- trace_diff --serving -----------------------------------------------------

def _write_raw(path, events):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        for e in events:
            f.write(json.dumps(e) + "\n")


def _serving_journals(tmp_path):
    """The SKIP and regression case of tests/test_timeline.py's
    `test_trace_diff_serving_mode_skip_and_regression`."""
    a, b, c = tmp_path / "a", tmp_path / "b", tmp_path / "c"
    _write_raw(str(a / "journal.jsonl"), [
        {"ts": 1.0, "seq": 1, "kind": "loadtest_report", "p50_ms": 1.0,
         "p99_ms": 3.0, "achieved_scores_per_sec": 1000.0,
         "stages": {"queue": {"mean_ms": 0.5}}},
        {"ts": 2.0, "seq": 2, "kind": "route_trace", "trace_id": "a" * 16,
         "hops": [{"ms": 1.0, "outcome": "ok"}], "hedged": False,
         "queue_ms": 0.2, "e2e_ms": 1.2, "outcome": "ok"},
        {"ts": 3.0, "seq": 3, "kind": "cold_start", "engine": "aot",
         "spawn_ms": 40.0, "promote_ms": 25.0, "live_compiles": 0},
        {"ts": 3.5, "seq": 4, "kind": "cold_start", "engine": "jax",
         "spawn_ms": 900.0, "promote_ms": 30.0, "live_compiles": 5},
    ])
    _write_raw(str(b / "journal.jsonl"), [
        {"ts": 1.0, "seq": 1, "kind": "loadtest_report", "p50_ms": 2.0,
         "p99_ms": 3.1, "achieved_scores_per_sec": 990.0,
         "stages": {"queue": {"mean_ms": 0.5},
                    "device": {"mean_ms": 0.4}}},
        {"ts": 2.0, "seq": 2, "kind": "cold_start", "engine": "aot",
         "spawn_ms": 44.0, "promote_ms": 26.0, "live_compiles": 0},
    ])
    _write_raw(str(c / "journal.jsonl"),
               [{"ts": 1.0, "seq": 1, "kind": "serve_start"}])
    return str(a), str(b), str(c)


@pytest.mark.parametrize("gate", [[], ["--fail-above", "50"]])
@pytest.mark.parametrize("as_json", [True, False])
def test_trace_diff_serving_equals_jax(jax_td, port_td, tmp_path, capsys,
                                       gate, as_json):
    a, b, c = _serving_journals(tmp_path)
    fmt = ["--json"] if as_json else []
    for pair in ((a, b), (b, a)):
        got = _same(*_both(jax_td, port_td, capsys,
                           [*pair, "--serving", *gate, *fmt]), as_json)
        if as_json and pair == (a, b):
            rows = {r["axis"]: r["status"] for r in got["axes"]}
            assert rows["stage.device.mean_ms"] == "SKIP"
            assert rows["cold_start.jax.spawn_ms"] == "SKIP"
            assert got["blamed"] == (["p50_ms"] if gate else [])
    # a report JSON side, and the journal with no serving axes (usage)
    rep = tmp_path / "report.json"
    rep.write_text(json.dumps({"p50_ms": 1.5, "p99_ms": 2.0,
                               "stages": {"queue": {"mean_ms": 0.4}}}))
    _same(*_both(jax_td, port_td, capsys,
                 [str(rep), b, "--serving", *gate, *fmt]), as_json)
    (rc_j, _), (rc_p, _) = _both(jax_td, port_td, capsys,
                                 [a, c, "--serving"])
    assert rc_j == rc_p == 2


# -- trace_diff --pod ---------------------------------------------------------

def _pod_run(d, s0, s1):
    rows = [{"ts": 1.0, "kind": "pod_epoch_close", "epoch": 0, "rank": r,
             "hosts": 2, "order_digest": "od0", "shard_digest": "sd0",
             "ingest_bytes": 100, "ingest_s": s} for r, s in ((0, s0),
                                                              (1, s1))]
    _write_raw(str(d / "telemetry" / "journal.jsonl"), rows)
    return str(d)


@pytest.mark.parametrize("gate", [[], ["--fail-above", "50"],
                                  ["--fail-above", "10"]])
@pytest.mark.parametrize("as_json", [True, False])
def test_trace_diff_pod_equals_jax(jax_td, port_td, tmp_path, capsys, gate,
                                   as_json):
    a = _pod_run(tmp_path / "a", 1.0, 1.0)
    b = _pod_run(tmp_path / "b", 1.0, 4.0)   # rank 1 got 4x slower
    fmt = ["--json"] if as_json else []
    for pair in ((a, b), (b, a), (a, a)):
        got = _same(*_both(jax_td, port_td, capsys,
                           [*pair, "--pod", *gate, *fmt]), as_json)
        if as_json and pair == (a, b) and gate:
            assert "host.1.ingest_s" in got["blamed"]
            assert "train_scaling_efficiency" in got["blamed"]
            assert "host.0.ingest_bytes" not in got["blamed"]
    # the bench-artifact JSON format, and a dir with no pod rows (usage)
    art = tmp_path / "bench.json"
    art.write_text(json.dumps({"train_scaling_efficiency": 0.8,
                               "train_scaling": {
                                   "host_ingest_s_n4": [1.0, 1.1, 0.9, 1.2],
                                   "host_ingest_bytes_n4": [5, 5, 5, 5]}}))
    _same(*_both(jax_td, port_td, capsys,
                 [str(art), b, "--pod", *gate, *fmt]), as_json)
    _write_raw(str(tmp_path / "e" / "journal.jsonl"),
               [{"ts": 1.0, "seq": 1, "kind": "epoch"}])
    (rc_j, _), (rc_p, _) = _both(jax_td, port_td, capsys,
                                 [a, str(tmp_path / "e"), "--pod"])
    assert rc_j == rc_p == 2


# -- the subpackage stands alone ----------------------------------------------

_TOOL_MODULES = ("trace_diff", "profile_staged", "loadtest")


@pytest.mark.parametrize("name", _TOOL_MODULES)
def test_each_tool_imports_no_bench_and_no_repo_tool(name):
    path = os.path.join(REPO, "shifu_tpu_torch", "tools", f"{name}.py")
    src = open(path).read()
    bad = re.findall(r"^\s*(?:from|import)\s+(bench|tools|shifu_tpu)\b",
                     src, re.MULTILINE)
    assert not bad, bad
    assert 'if __name__ == "__main__":' in src


# -- profile_staged -----------------------------------------------------------

F = 30
BATCH = 64
# two bf16 chunks' worth of bytes a chunk: 2, 3 and 4 batches on the
# bf16, int8 and compact int8 wires
CHUNK_BYTES = BATCH * (F * 2 + 8) * 2
PROBE = dict(small_bytes=1 << 16, large_bytes=1 << 18, max_bytes=1 << 20)
# the JAX tool's `goodput` fields (tools/profile_staged.py:136-150, 158-168)
GOODPUT_FIELDS = {"ts", "seq", "kind", "source", "wire", "wall_s",
                  "buckets", "goodput_fraction", "mfu", "row_bytes",
                  "chunk_batches", "n_chunks", "assemble_s", "put_s",
                  "dispatch_s", "sync_s", "put_mb_per_s", "wall_inline_s",
                  "wall_prefetch_s", "rate_prefetch"}
# bf16 compute over two epochs: the port's bf16 products and JAX's XLA
# ones round apart (a bf16 tolerance, ten times under the 1e-2 of
# test_torch_train's bf16 lockstep; 2.4e-6 to 3.5e-6 measured here on the
# summed loss).  Each block's loss is held to the same rtol, so a block
# trained out of order shows.
LOSS_RTOL = 1e-3
# the inline epoch's update: each parameter's change over the two epochs
# against JAX's, to within this share of the largest change (bf16 sign
# noise on near-zero gradients; 0.0057 measured here); a skipped update
# changes nothing
DELTA_ATOL_SHARE = 0.02


@pytest.fixture(scope="module")
def staged_run():
    """The port's profile over the three wires at BATCH, from the JAX
    package's initial weights (`params_from_jax`), into an in-memory
    journal; and the JAX epoch-scan losses on the same blocks."""
    import jax
    import jax.numpy as jnp
    import ml_dtypes

    from shifu_tpu.config import schema as jax_schema
    from shifu_tpu.data import pipeline as jax_pipe
    from shifu_tpu.data import synthetic as jax_synth
    from shifu_tpu.export.artifact import _flatten_params
    from shifu_tpu.train import loop as jax_loop
    from shifu_tpu.train import step as jax_step
    from shifu_tpu_torch import obs
    from shifu_tpu_torch.export.artifact import params_from_jax
    from shifu_tpu_torch.train.loop import init_state
    from shifu_tpu_torch.tools import profile_staged as ps

    rows = ps.dataset_rows(BATCH, CHUNK_BYTES)
    ds = ps.make_dataset(rows, seed=3)

    def jax_job(wire):
        return jax_schema.JobConfig(
            schema=jax_synth.make_schema(num_features=F),
            data=jax_schema.DataConfig(batch_size=BATCH, wire_dtype=wire),
            model=jax_schema.ModelSpec(
                model_type="mlp", hidden_nodes=(100, 100, 100),
                activations=("relu",) * 3, compute_dtype="bfloat16"),
            train=jax_schema.TrainConfig(
                epochs=1, loss="weighted_mse",
                optimizer=jax_schema.OptimizerConfig(
                    name="adadelta", learning_rate=0.003)),
        ).validate()

    def port_keyed(jparams):
        flat = {k: np.array(v, copy=True) for k, v in
                _flatten_params(jax.device_get(jparams)).items()}
        model = init_state(ps.make_job("auto", BATCH), F, "cpu").model
        return flat, {k: v.float().numpy() for k, v in
                      params_from_jax(flat, model).items()}

    jstate0 = jax_loop.init_state(jax_job("auto"), F)  # seeded: each
    # wire's init_state below draws the same weights
    flat, init_params = port_keyed(jstate0.params)

    def init_fn(job, num_features, device):
        state = init_state(job, num_features, device)
        state.model.load_state_dict(params_from_jax(flat, state.model))
        return state

    obs.reset_for_tests()
    obs.set_journal(obs.RunJournal(None))
    out = ps.profile("cpu", ds=ds, batch_size=BATCH,
                     chunk_bytes=CHUNK_BYTES, probe=PROBE, init_fn=init_fn)
    records = list(obs.get_journal().records)
    obs.reset_for_tests()

    # JAX: the same blocks through make_epoch_scan_step, epoch 0 then
    # the summed loss of epoch 1, from the same initial weights
    jax_inline, jax_sizes = {}, {}
    for name, wire, compact in ps.WIRES:
        job = jax_job(wire)
        cdt = job.model.compute_dtype
        wcast = jax_pipe.wire_cast_fn(job.schema, job.data, cdt)
        feats = (wcast({"features": ds.features})["features"]
                 if wire == "int8"
                 else ds.features.astype(ml_dtypes.bfloat16))
        dsw = jax_pipe.TabularDataset(feats, ds.target, ds.weight)
        cast = (jax_pipe.wire_cast_fn(job.schema, job.data, cdt,
                                      compact=True) if compact else wcast)
        row_b = jax_pipe.wire_row_bytes(job.schema, job.data, cdt,
                                        compact=compact)
        chunk = max(1, CHUNK_BYTES // (BATCH * row_b))
        jax_sizes[name] = {"row_bytes": row_b, "chunk_batches": chunk,
                           "n_chunks": -(-(rows // BATCH) // chunk)}
        scan = jax_step.make_epoch_scan_step(job, None)
        state = jax_loop.init_state(job, F)  # the scan donates its state
        for e in (0, 1):
            block_losses = []
            for blk in jax_pipe.staged_epoch_blocks(
                    dsw, BATCH, epoch=e, block_batches=chunk):
                blk = cast(blk) if cast else blk
                state, last = scan(state, {k: jnp.asarray(v)
                                           for k, v in blk.items()})
                block_losses.append(float(last))
        jax_inline[name] = {"loss": sum(block_losses),
                            "block_losses": block_losses,
                            "params": port_keyed(state.params)[1]}
    return out, records, jax_inline, jax_sizes, init_params


def test_profile_staged_sizes_equal_jax_arithmetic(staged_run):
    out, _records, _inline, jax_sizes, _init = staged_run
    assert set(out["results"]) == {"bf16", "int8", "int8c"}
    for name, want in jax_sizes.items():
        got = out["results"][name]
        assert {k: got[k] for k in want} == want, name
    # and the full-size default is the JAX tool's: 5 bf16 batches a chunk,
    # 2,949,120 rows of 68 bytes
    from shifu_tpu_torch.tools import profile_staged as ps
    assert ps.chunk_batches(68, ps.BATCH_SIZE) == 5
    assert ps.dataset_rows() == 6 * 5 * 98_304 == 2_949_120


def test_profile_staged_events_have_jax_fields(staged_run):
    _out, records, *_ = staged_run
    kinds = [r["kind"] for r in records]
    assert kinds == ["h2d_probe", "goodput", "goodput", "goodput",
                     "h2d_probe", "staged_roofline", "staged_roofline",
                     "staged_roofline"]
    assert [r["when"] for r in records if r["kind"] == "h2d_probe"] == [
        "before", "after"]
    good = [r for r in records if r["kind"] == "goodput"]
    assert [g["wire"] for g in good] == ["bf16", "int8", "int8c"]
    jax_src = open(os.path.join(REPO, "tools", "profile_staged.py")).read()
    for g in good:
        assert set(g) == GOODPUT_FIELDS
        assert g["source"] == "profile_staged"
        assert sum(g["buckets"].values()) == pytest.approx(g["wall_s"],
                                                           rel=1e-3)
        assert g["buckets"]["input"] > 0 and g["buckets"]["step"] > 0
        assert len(g["wall_prefetch_s"]) == 3
    for key in GOODPUT_FIELDS - {"ts", "seq", "kind", "wire", "source",
                                 "wall_s", "buckets", "goodput_fraction",
                                 "mfu"}:
        assert f'"{key}"' in jax_src, key
    roof = [r for r in records if r["kind"] == "staged_roofline"]
    assert {k for r in roof for k in r} == {
        "ts", "seq", "kind", "wire", "fraction_at_before_probe",
        "fraction_at_after_probe", "before_mb_per_sec", "after_mb_per_sec"}


def test_profile_staged_inline_loss_matches_jax_epoch_scan(staged_run):
    out, _records, jax_inline, _sizes, init_params = staged_run
    for name, want in jax_inline.items():
        got = out["inline"][name]
        np.testing.assert_allclose(got["loss"], want["loss"],
                                   rtol=LOSS_RTOL, err_msg=name)
        # block by block, in the order trained
        assert len(got["block_losses"]) == len(want["block_losses"]) > 1
        np.testing.assert_allclose(got["block_losses"],
                                   want["block_losses"], rtol=LOSS_RTOL,
                                   err_msg=name)
        # the parameters after the inline epoch moved as JAX's did
        assert set(got["params"]) == set(want["params"]) == set(init_params)
        for key, p0 in init_params.items():
            d_port = got["params"][key] - p0
            d_jax = want["params"][key] - p0
            scale = np.abs(d_jax).max()
            assert scale > 0, (name, key)
            np.testing.assert_allclose(d_port, d_jax,
                                       atol=DELTA_ATOL_SHARE * scale,
                                       err_msg=f"{name} {key}")
    # the three wires carry the same rows: the int8 wires agree closely
    assert out["inline"]["int8"]["loss"] == pytest.approx(
        out["inline"]["int8c"]["loss"], rel=1e-5)


def test_profile_staged_renders_in_the_ports_profile_view(staged_run,
                                                          tmp_path):
    """The events written to a journal are what `shifu-tpu-torch profile`
    renders, as JAX's renderer does on the same journal."""
    from shifu_tpu.obs import render as jax_render
    from shifu_tpu_torch.obs import render

    _out, records, *_ = staged_run
    d = tmp_path / "telemetry"
    _write_raw(str(d / "journal.jsonl"), records)
    got = render.render_profile_text(render.profile_summary(str(tmp_path)))
    want = jax_render.render_profile_text(
        jax_render.profile_summary(str(tmp_path)))
    assert got == want


def test_the_tools_default_to_the_card(monkeypatch, tmp_path, capsys):
    from shifu_tpu_torch.tools import loadtest as lt_tool
    from shifu_tpu_torch.tools import profile_staged as ps

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ps.profile(ds=ps.make_dataset(8), batch_size=4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ps.main([])
    art = _artifact(tmp_path)
    assert lt_tool.main(["--model", art, "--duration", "0.1",
                         "--engine", "torch"]) == 1
    assert "CUDA is not available" in capsys.readouterr().err


# -- loadtest -----------------------------------------------------------------

def _artifact(tmp_path):
    from shifu_tpu_torch.config import ModelSpec
    from shifu_tpu_torch.data import synthetic
    from shifu_tpu_torch.export.artifact import save_artifact
    from shifu_tpu_torch.models.registry import build_model

    out = tmp_path / "mlp_art"
    if out.exists():
        return str(out)
    schema = synthetic.make_schema(num_features=8)
    spec = ModelSpec(model_type="mlp", hidden_nodes=(12,),
                     activations=("relu",), compute_dtype="float32")
    model = build_model(spec, schema, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    return save_artifact(model, spec, schema, str(out))


@pytest.fixture(scope="module")
def jax_lt():
    return _load_jax_tool("loadtest")


def _shape(text):
    """A text report with its numbers and padding taken out."""
    return [re.sub(r"\s+", " ", re.sub(r"[0-9][0-9.,]*", "N", line))
            for line in text.splitlines()]


@pytest.mark.parametrize("as_json", [True, False])
def test_loadtest_report_equals_jax(jax_lt, tmp_path, capsys, as_json):
    """JAX's tool and the port's on the same argv and artifact (JAX's
    numpy op-list engine reads the port's artifact): the same exit code,
    report keys and text layout, and the same seeded arrivals."""
    from shifu_tpu_torch.tools import loadtest as lt_tool

    art = _artifact(tmp_path)
    argv = ["--model", art, "--rate", "200", "--duration", "0.5",
            "--engine", "numpy", "--seed", "7"]
    fmt = ["--json"] if as_json else []
    rc_j = jax_lt.main([*argv, *fmt])
    out_j = capsys.readouterr().out
    rc_p = lt_tool.main([*argv, "--device", "cpu", *fmt])
    out_p = capsys.readouterr().out
    assert rc_j == rc_p == 0
    if not as_json:
        assert _shape(out_p) == _shape(out_j)
        return
    doc_j, doc_p = json.loads(out_j), json.loads(out_p)
    assert set(doc_p) == set(doc_j)
    assert {s: set(v) for s, v in doc_p["stages"].items()} == {
        s: set(v) for s, v in doc_j["stages"].items()}
    for key in ("mode", "engine", "offered_rate", "duration_s", "senders",
                "submitted"):
        assert doc_p[key] == doc_j[key], key
    assert doc_p["completed"] == doc_j["completed"] > 0
    assert doc_p["errors"] == doc_j["errors"] == 0


def test_loadtest_json_keys_equal_the_cli(tmp_path, capsys):
    from shifu_tpu_torch.launcher import cli
    from shifu_tpu_torch.tools import loadtest as lt_tool

    art = _artifact(tmp_path)
    args = ["--model", art, "--rate", "200", "--duration", "0.5",
            "--engine", "numpy", "--device", "cpu", "--json"]
    assert lt_tool.main(list(args)) == 0
    tool = json.loads(capsys.readouterr().out)
    assert cli.main(["loadtest", *args]) == 0
    cmd = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(tool) == set(cmd)
    assert tool["completed"] > 0 and tool["errors"] == 0
    # the text report is the runtime's renderer, as the CLI's
    assert lt_tool.main([a for a in args if a != "--json"]) == 0
    text = capsys.readouterr().out
    from shifu_tpu_torch.runtime import loadtest as lt
    def shape(t):
        return re.sub(r"[0-9.]+", "N", t).splitlines()
    assert shape(text) == shape(lt.render_report(tool))


@pytest.mark.parametrize("engine,port_name", [("jax", "torch"),
                                              ("stablehlo", "export")])
def test_loadtest_refuses_the_jax_engines(tmp_path, capsys, engine,
                                          port_name):
    from shifu_tpu_torch.launcher import cli
    from shifu_tpu_torch.tools import loadtest as lt_tool

    art = _artifact(tmp_path)
    args = ["--model", art, "--duration", "0.1", "--engine", engine,
            "--device", "cpu"]
    assert lt_tool.main(list(args)) == 1
    err = capsys.readouterr().err
    assert repr(port_name) in err or port_name in err
    assert cli.main(["loadtest", *args]) == 1
    assert port_name in capsys.readouterr().err


def test_loadtest_usage_errors_exit_2(jax_lt, tmp_path, capsys):
    """Neither mode, both modes, and --capacity without --model: usage
    (exit 2) from both tools, before anything is loaded."""
    from shifu_tpu_torch.tools import loadtest as lt_tool

    art = _artifact(tmp_path)
    for argv in (["--rate", "10"],
                 ["--model", art, "--connect", "127.0.0.1:1"],
                 ["--connect", "127.0.0.1:1", "--capacity"]):
        codes = []
        for tool in (jax_lt, lt_tool):
            with pytest.raises(SystemExit) as e:
                tool.main(list(argv))
            codes.append(e.value.code)
        assert codes == [2, 2], argv
        capsys.readouterr()
