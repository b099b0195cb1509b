"""The port's AOT pack (shifu_tpu_torch/export/aot.py, the `aot` tier of
runtime/serve.load_engine) against the JAX package's, on the CPU: the
counterparts of tests/test_aot.py.

- The pack's layout: one static-batch `torch.export` program per rung,
  every file digest-pinned, the manifest's keys the JAX pack's (built here
  on the same weights: the JAX package packs on this CPU) save for the
  toolchain fields, with the same rung grid, widths and weight-key digest.
- Loading runs no trace and scores as the export tier does; the daemon
  serves on `engine="aot"`, and hot-swaps to a packed v2 under load.
- A fingerprint mismatch, a damaged bucket file and a missing pack each
  journal one `aot_fallback` and serve through the export tier on the same
  device.
- The pack rides `sync_manifest.json`: the JAX package's `sync_artifact`
  verifies it, catches a corrupted pull, and the port loads the copy.
- The four journal events carry the JAX package's keys.
(The JAX package cannot load its own pack on this CPU, the seed's failing
tests/test_aot.py, so the port is not held to JAX's load.)
"""

import ast
import collections
import dataclasses
import inspect
import json
import os
import shutil
import threading

import numpy as np
import pytest
import torch

from shifu_tpu import chaos as jax_chaos
from shifu_tpu import obs as jax_obs
from shifu_tpu.chaos import plan as jax_plan
from shifu_tpu.config import JobConfig as JaxJobConfig
from shifu_tpu.export import aot as jax_aot
from shifu_tpu.export import artifact as jax_artifact
from shifu_tpu.runtime import fleet as jax_fleet
from shifu_tpu.train import init_state as jax_init_state
from shifu_tpu.train import make_forward_fn
from shifu_tpu_torch import obs
from shifu_tpu_torch.config.schema import ServingConfig
from shifu_tpu_torch.export import aot, artifact, scorer
from shifu_tpu_torch.models.registry import build_model
from shifu_tpu_torch.runtime import fleet
from shifu_tpu_torch.runtime.serve import ScoringDaemon, load_engine

import test_torch_program as tp

PACK_BUCKETS = (16, 32, 64)
JAX_TOOLCHAIN_FIELDS = {"jax_version", "jaxlib_version"}
PORT_TOOLCHAIN_FIELDS = {"torch_version", "cuda_version",
                         "compute_capability", "kernel_sources",
                         "libraries", "weight_dtypes"}


@pytest.fixture(autouse=True)
def _clean():
    for m in (obs, jax_obs, jax_chaos):
        m.reset_for_tests()
    yield
    for m in (obs, jax_obs, jax_chaos):
        m.reset_for_tests()


def _port_artifact(root, jdir, name, shift=0.0):
    """The port's artifact of the JAX artifact's weights (+ `shift`), with
    its pack over PACK_BUCKETS on the CPU."""
    jspec, jschema = _specs()
    pspec, pschema = tp._port(jspec, jschema)
    model = build_model(pspec, pschema, device="cpu")
    with np.load(os.path.join(jdir, "weights.npz")) as z:
        model.load_state_dict(artifact.params_from_jax(
            {k: z[k] + np.float32(shift) for k in z.files}, model))
    return artifact.save_artifact(model, pspec, pschema, str(root / name),
                                  aot_pack=True, aot_buckets=PACK_BUCKETS,
                                  aot_device="cpu")


def _specs():
    return (dataclasses.replace(tp._jax_spec("ft_transformer"),
                                fused_block="on"), tp._jax_schema(3))


@pytest.fixture(scope="module")
def packed(tmp_path_factory):
    """(JAX packed artifact, port packed artifact of its weights, port
    packed v2 with shifted weights): the FT with the fused block, so the
    programs call #1 and #5."""
    root = tmp_path_factory.mktemp("aot")
    jspec, jschema = _specs()
    jjob = JaxJobConfig(schema=jschema, model=dataclasses.replace(
        jspec, fused_block="off")).validate()
    state = jax_init_state(jjob, jschema.feature_count)
    jdir = str(root / "jax")
    jax_artifact.save_artifact(state.params, jjob, jdir,
                               forward_fn=make_forward_fn(jjob,
                                                          state.apply_fn),
                               aot_pack=True, aot_buckets=PACK_BUCKETS)
    return (jdir, _port_artifact(root, jdir, "port"),
            _port_artifact(root, jdir, "port_v2", shift=0.05))


def _journal(tmp_path):
    obs.flush()
    return obs.read_journal(str(tmp_path / "tele" / "journal.jsonl"))


def _tamper_manifest(export_dir, **fields):
    path = os.path.join(aot.pack_dir(export_dir), aot.AOT_MANIFEST)
    with open(path) as f:
        manifest = json.load(f)
    manifest.update(fields)
    with open(path, "w") as f:
        json.dump(manifest, f)


def test_pack_layout_and_manifest_against_jax(packed):
    jdir, pdir, _ = packed
    with open(os.path.join(jax_aot.pack_dir(jdir), "manifest.json")) as f:
        jman = json.load(f)
    with open(os.path.join(aot.pack_dir(pdir), aot.AOT_MANIFEST)) as f:
        man = json.load(f)
    assert set(jman) - JAX_TOOLCHAIN_FIELDS \
        == set(man) - PORT_TOOLCHAIN_FIELDS
    for key in ("format", "num_features", "num_heads", "buckets",
                "weight_keys_digest", "algo"):
        assert man[key] == jman[key], key
    assert man["platform"] == "cpu" and man["device_kind"] == "cpu"
    assert man["libraries"] == {} and man["kernel_sources"] == {}
    assert sorted(man["files"]) == [aot._bucket_file(b)
                                    for b in PACK_BUCKETS]
    for name, want in man["files"].items():
        with open(os.path.join(aot.pack_dir(pdir), name), "rb") as f:
            assert aot._digest(f.read()) == want
        program = torch.export.load(os.path.join(aot.pack_dir(pdir), name))
        assert artifact.program_operators(program) == {
            "shifu_tpu_torch.ft_block.default",
            "shifu_tpu_torch.embedding_lookup.default"}
        assert artifact.device_literals(program) == []
        assert not program.state_dict  # the weights are an input
    host = aot.host_fingerprint("cpu")
    for field, value in host.items():
        assert man[field] == value


def test_load_scores_as_the_export_tier_with_no_trace(packed, tmp_path,
                                                      monkeypatch):
    _, pdir, _ = packed
    obs.configure(str(tmp_path / "tele"))

    def no_trace(*a, **k):
        raise AssertionError("loading the pack traced a program")

    monkeypatch.setattr(torch.export, "export", no_trace)
    sc = aot.try_load_aot(pdir, "cpu")
    assert isinstance(sc, aot.AotScorer) and sc.engine == "aot"
    assert sc.buckets == PACK_BUCKETS
    ex = scorer.ExportScorer(pdir, device="cpu")
    x = tp._rows(200, 3, seed=31)
    # a batch that fills its rung scores as the symbolic program does
    np.testing.assert_array_equal(sc.compute_batch(x[:32]),
                                  ex.compute_batch(x[:32]))
    # padded rungs and chunks over the largest rung: f32 roundoff apart
    np.testing.assert_allclose(sc.compute_batch(x), ex.compute_batch(x),
                               rtol=0, atol=1e-6)
    assert sc.compute_batch(x[:0]).shape == (0, 1)
    loads = [e for e in _journal(tmp_path) if e["kind"] == "aot_load"]
    assert len(loads) == 1 and loads[0]["buckets"] == list(PACK_BUCKETS)


def _call_counts(program) -> collections.Counter:
    return collections.Counter(str(n.target) for n in program.graph.nodes
                               if n.op == "call_function")


def test_each_rung_runs_the_export_graph(packed):
    """A rung's program calls what `scoring.pt2` calls, node for node, but
    for the symbolic batch's size and slices: the two tiers launch the
    same kernels and aten ops on a batch that fills its rung."""
    _, pdir, _ = packed
    want = _call_counts(torch.export.load(
        os.path.join(pdir, artifact.EXPORT_PROGRAM)))
    for op in ("aten.sym_size.int", "aten.slice.Tensor"):
        assert want.pop(op) > 0, op
    for b in PACK_BUCKETS:
        got = _call_counts(torch.export.load(
            os.path.join(aot.pack_dir(pdir), aot._bucket_file(b))))
        assert got == want, b


def _cfg(**kw) -> ServingConfig:
    base = dict(engine="aot", report_every_s=0.0, min_batch_bucket=16,
                max_batch=64)
    base.update(kw)
    return ServingConfig(**base)


def test_the_daemon_serves_on_the_aot_engine(packed, tmp_path):
    _, pdir, _ = packed
    obs.configure(str(tmp_path / "tele"))
    x = tp._rows(48, 3, seed=32)
    with ScoringDaemon(pdir, config=_cfg(), device="cpu") as daemon:
        assert daemon._registry.current().engine_name == "aot"
        got = daemon.score_batch(x)
        single = daemon.score(x[0], timeout=60)
    want = scorer.ExportScorer(pdir, device="cpu").compute_batch(x)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(single, want[0], rtol=0, atol=1e-6)
    assert not [e for e in _journal(tmp_path) if e["kind"] == "aot_fallback"]


def test_hot_swap_to_a_packed_v2_under_load(packed, tmp_path):
    _, pdir, v2 = packed
    obs.configure(str(tmp_path / "tele"))
    rows = tp._rows(120, 3, seed=33)
    want = {d: scorer.ExportScorer(d, device="cpu").compute_batch(rows)
            for d in (pdir, v2)}
    got, errors = [], []
    with ScoringDaemon(pdir, config=_cfg(), device="cpu") as daemon:
        def send():
            for i in range(len(rows)):
                try:
                    got.append((i, daemon.score(rows[i], timeout=60)))
                except Exception as e:  # noqa: BLE001 - counted below
                    errors.append(e)

        t = threading.Thread(target=send)
        t.start()
        daemon.swap(v2)
        t.join(timeout=120)
        assert not t.is_alive()
        tail = daemon.score(rows[-1], timeout=60)
    assert not errors and len(got) == len(rows)
    for i, s in got:
        assert any(np.allclose(s, want[d][i], rtol=0, atol=1e-6)
                   for d in want)
    np.testing.assert_allclose(tail, want[v2][-1], rtol=0, atol=1e-6)
    loads = [e for e in _journal(tmp_path) if e["kind"] == "aot_load"]
    assert [e["path"] for e in loads] == [pdir, v2]


def test_a_fingerprint_mismatch_falls_back_to_the_export_tier(packed,
                                                              tmp_path):
    _, pdir, _ = packed
    stale = str(tmp_path / "stale")
    shutil.copytree(pdir, stale)
    _tamper_manifest(stale, torch_version="0.0.1")
    obs.configure(str(tmp_path / "tele"))
    assert aot.try_load_aot(stale, "cpu") is None
    sc = load_engine(stale, "aot", device="cpu")
    assert isinstance(sc, scorer.ExportScorer) and sc.device.type == "cpu"
    x = tp._rows(20, 3, seed=34)
    np.testing.assert_array_equal(
        sc.compute_batch(x),
        scorer.ExportScorer(pdir, device="cpu").compute_batch(x))
    evs = _journal(tmp_path)
    falls = [e for e in evs if e["kind"] == "aot_fallback"]
    assert len(falls) == 2
    assert all("torch_version" in e["reason"] and "0.0.1" in e["reason"]
               for e in falls)
    assert not [e for e in evs if e["kind"] == "aot_load"]


def test_a_changed_kernel_source_falls_back(packed, tmp_path, monkeypatch):
    """The pack's libraries are pinned to the kernel sources they were
    built from: a checkout with another source refuses them."""
    _, pdir, _ = packed
    stale = str(tmp_path / "stale")
    shutil.copytree(pdir, stale)
    _tamper_manifest(stale, libraries={"ft_block": "lib/libft_block-x.so"},
                     kernel_sources={"ft_block": "0" * 16})
    obs.configure(str(tmp_path / "tele"))
    assert aot.try_load_aot(stale, "cpu") is None
    falls = [e for e in _journal(tmp_path) if e["kind"] == "aot_fallback"]
    assert len(falls) == 1 and "kernel_sources" in falls[0]["reason"]


def test_a_damaged_bucket_file_is_caught_by_its_digest(packed, tmp_path):
    _, pdir, _ = packed
    bad = str(tmp_path / "bad")
    shutil.copytree(pdir, bad)
    victim = os.path.join(aot.pack_dir(bad), aot._bucket_file(32))
    blob = bytearray(open(victim, "rb").read())
    blob[len(blob) // 2] ^= 0xFF
    with open(victim, "wb") as f:
        f.write(bytes(blob))
    obs.configure(str(tmp_path / "tele"))
    assert aot.try_load_aot(bad, "cpu") is None
    falls = [e for e in _journal(tmp_path) if e["kind"] == "aot_fallback"]
    assert len(falls) == 1
    assert "digest mismatch" in falls[0]["reason"]
    assert aot._bucket_file(32) in falls[0]["reason"]


def test_a_missing_pack_is_a_single_fallback(packed, tmp_path):
    _, pdir, _ = packed
    bare = str(tmp_path / "bare")
    shutil.copytree(pdir, bare)
    shutil.rmtree(aot.pack_dir(bare))
    obs.configure(str(tmp_path / "tele"))
    with ScoringDaemon(bare, config=_cfg(), device="cpu") as daemon:
        assert daemon._registry.current().engine_name == "export"
        assert daemon.score(np.zeros(tp.F, np.float32),
                            timeout=60).shape == (1,)
    falls = [e for e in _journal(tmp_path) if e["kind"] == "aot_fallback"]
    assert len(falls) == 1
    assert "manifest.json missing" in falls[0]["reason"]


def test_the_pack_rides_the_sync_manifest(packed, tmp_path):
    """Every aot/ file is in sync_manifest.json with its digest; the JAX
    package's sync plane catches a corrupted pull and publishes a verified
    one, whose pack the port loads."""
    _, pdir, _ = packed
    sync = fleet.read_sync_manifest(pdir)["files"]
    with open(os.path.join(aot.pack_dir(pdir), aot.AOT_MANIFEST)) as f:
        man = json.load(f)
    for name, want in man["files"].items():
        assert sync[f"{aot.AOT_DIR}/{name}"] == want
    assert f"{aot.AOT_DIR}/{aot.AOT_MANIFEST}" in sync
    jax_obs.configure(str(tmp_path / "jtele"))
    cache = str(tmp_path / "hostcache")
    jax_chaos.configure(jax_plan.parse_plan({"faults": [
        {"site": jax_fleet.SYNC_SITE, "every": 1, "max_times": 1,
         "action": "corrupt"}]}))
    with pytest.raises(jax_fleet.SyncError):
        jax_fleet.sync_artifact(pdir, cache, 1)
    dest = jax_fleet.sync_artifact(pdir, cache, 1)
    assert aot.has_pack(dest)
    sc = aot.try_load_aot(dest, "cpu")
    assert sc is not None
    x = tp._rows(16, 3, seed=35)
    np.testing.assert_array_equal(
        sc.compute_batch(x), aot.try_load_aot(pdir, "cpu").compute_batch(x))


def _event_keys(fn) -> dict:
    """{kind: keyword names} of the obs.event(...) calls in `fn`'s
    source."""
    out = {}
    for node in ast.walk(ast.parse(inspect.getsource(fn))):
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "event" and node.args
                and isinstance(node.args[0], ast.Constant)):
            out[node.args[0].value] = {k.arg for k in node.keywords}
    return out


def test_journal_events_carry_the_jax_keys(packed, tmp_path):
    want = {**_event_keys(jax_aot.build_aot_pack),
            **_event_keys(jax_aot.try_load_aot)}
    got = {**_event_keys(aot.build_aot_pack),
           **_event_keys(aot.try_load_aot)}
    assert set(want) == {"aot_pack", "aot_pack_failed", "aot_load",
                         "aot_fallback"}
    assert got == want
    # and the events the two packages emit here: pack, failed, fallback
    jdir, pdir, _ = packed
    jax_obs.configure(str(tmp_path / "jtele"))
    obs.configure(str(tmp_path / "tele"))

    def boom(params, feats):
        raise RuntimeError("no forward")

    assert jax_aot.build_aot_pack(str(tmp_path / "jx"), boom, {}, tp.F, 1,
                                  (16,)) is None
    assert aot.build_aot_pack(str(tmp_path / "px"), (16,), "cpu") is None
    stale = str(tmp_path / "stale")
    shutil.copytree(pdir, stale)
    _tamper_manifest(stale, format=99)
    assert aot.try_load_aot(stale, "cpu") is None
    jstale = str(tmp_path / "jstale")
    shutil.copytree(jdir, jstale)
    _tamper_manifest(jstale, format=99)
    assert jax_aot.try_load_aot(jstale) is None
    jax_obs.flush()
    jevs = jax_obs.read_journal(str(tmp_path / "jtele" / "journal.jsonl"))
    pevs = _journal(tmp_path)
    for kind in ("aot_pack_failed", "aot_fallback"):
        (j,) = [e for e in jevs if e["kind"] == kind]
        (p,) = [e for e in pevs if e["kind"] == kind]
        assert set(p) == set(j), kind
