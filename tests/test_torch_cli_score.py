"""The port's artifact commands (shifu_tpu_torch/launcher/cli.py `score`,
`eval`, `export`, `serve`, `loadtest`) against the JAX package's CLI on
the same artifact, on the CPU (`--device cpu`), in this process.

- `score` writes the JAX command's bytes on the default engine (both pick
  the op-list interpreter), and every other tier agrees with it;
  `--native` contradicts another `--engine`; `--engine jax` names the
  port's counterpart.
- `eval` prints the JAX command's summary; on the torch tier its AUC is
  within 1e-3 of it.
- `export --checkpoint-dir` reproduces the job's final_model (weights
  bitwise, the same scores in the JAX command) and, with `--aot-pack`,
  ships the pack.
- `serve --port 0` (a thread) answers the loadtest of both packages'
  `loadtest --connect` with no error; `loadtest --model` runs in process.
- The JAX CLI's pod and provisioning commands (`provision`,
  `pod-verify`, `data-dryrun`) answer as JAX's do.
- The wdbc demo's sequence (examples/_run_demo.sh) through the port's
  CLI, cut to tests/test_demo.py's 1200 rows: train, score, score
  --native, agreeing within 1e-5.
"""

import importlib.util
import json
import os
import threading
import time

import numpy as np
import pytest

from shifu_tpu import obs as jax_obs
from shifu_tpu.launcher import cli as jax_cli
from shifu_tpu_torch import chaos, obs
from shifu_tpu_torch.launcher import cli
from shifu_tpu_torch.runtime import serve

import test_torch_launcher as tl

SERVE_ATOL = 2e-2   # bf16 engines against the f32 op list
NATIVE_ATOL = 1e-5  # the demo's native-against-numpy bound
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for var in tl._CLI_ENV:
        monkeypatch.delenv(var, raising=False)
    for m in (obs, jax_obs):
        m.reset_for_tests()
    chaos.reset_for_tests()
    yield
    for var in tl._CLI_ENV:
        os.environ.pop(var, None)
    for m in (obs, jax_obs):
        m.reset_for_tests()
    chaos.reset_for_tests()


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """A job the port's `train` command trained on the CPU: (the Shifu
    files' dir, the job dir, a data part)."""
    root = tmp_path_factory.mktemp("cli_score")
    argv = tl._shifu_files(root)
    assert cli.main(argv + ["--output", str(root / "job"),
                            "--device", "cpu"]) == 0
    obs.reset_for_tests()
    part = sorted(p for p in os.listdir(root / "data")
                  if not p.startswith((".", "_")))[0]
    return root, root / "job", str(root / "data" / part)


def _read(path) -> np.ndarray:
    return np.loadtxt(path, delimiter="|", ndmin=2)


def test_score_writes_the_jax_commands_scores(job, tmp_path, capsys):
    root, out, part = job
    model = str(out / "final_model")
    assert jax_cli.main(["score", "--model", model, "--input", part,
                         "--output", str(tmp_path / "jax.txt")]) == 0
    assert cli.main(["score", "--model", model, "--input", part,
                     "--output", str(tmp_path / "port.txt"),
                     "--device", "cpu"]) == 0
    want = (tmp_path / "jax.txt").read_bytes()
    assert (tmp_path / "port.txt").read_bytes() == want
    ref = _read(tmp_path / "jax.txt")
    for flags, tol in ((["--native"], NATIVE_ATOL),
                       (["--engine", "native"], NATIVE_ATOL),
                       (["--engine", "numpy"], 0.0),
                       (["--engine", "torch"], SERVE_ATOL),
                       (["--engine", "export"], SERVE_ATOL),
                       (["--engine", "aot"], SERVE_ATOL)):
        dest = tmp_path / ("_".join(flags) + ".txt")
        assert cli.main(["score", "--model", model, "--input", part,
                         "--output", str(dest), "--device", "cpu",
                         *flags]) == 0, flags
        got = _read(dest)
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=0, atol=tol + 1e-6,
                                   err_msg=str(flags))
    np.testing.assert_array_equal(_read(tmp_path / "--engine_torch.txt"),
                                  _read(tmp_path / "--engine_export.txt"))
    # stdout, as in JAX
    capsys.readouterr()
    assert cli.main(["score", "--model", model, "--input", part,
                     "--device", "cpu"]) == 0
    assert capsys.readouterr().out.encode() == want


@pytest.mark.parametrize("flags,needle", [
    (["--native", "--engine", "torch"], "contradicts --engine torch"),
    (["--engine", "jax"], "counterpart is 'torch'"),
    (["--engine", "stablehlo"], "counterpart is 'export'"),
])
def test_score_refuses_contradictions_and_jax_engines(job, capsys, flags,
                                                      needle):
    _, out, part = job
    assert cli.main(["score", "--model", str(out / "final_model"),
                     "--input", part, "--device", "cpu", *flags]) == 1
    assert needle in capsys.readouterr().err


def test_eval_prints_the_jax_commands_summary(job, tmp_path, capsys):
    root, out, _ = job
    base = ["eval", "--model", str(out / "final_model"),
            "--columnconfig", str(root / "ColumnConfig.json"),
            "--modelconfig", str(root / "ModelConfig.json"),
            "--data", str(root / "data")]
    assert jax_cli.main(base + ["--scores-output",
                                str(tmp_path / "jax.txt")]) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert cli.main(base + ["--scores-output", str(tmp_path / "port.txt"),
                            "--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got == want
    assert (tmp_path / "port.txt").read_bytes() \
        == (tmp_path / "jax.txt").read_bytes()
    assert cli.main(base + ["--engine", "torch", "--device", "cpu"]) == 0
    torch_sum = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert torch_sum["rows"] == want["rows"]
    assert abs(torch_sum["auc"] - want["auc"]) <= 1e-3


def test_export_reproduces_the_final_model(job, tmp_path, capsys):
    root, out, part = job
    dest = tmp_path / "reexport"
    assert cli.main(["export", "--modelconfig", str(root / "ModelConfig.json"),
                     "--columnconfig", str(root / "ColumnConfig.json"),
                     "--checkpoint-dir", str(out / "tmp_model"),
                     "--globalconfig", str(root / "global.xml"),
                     "--output", str(dest), "--aot-pack",
                     "--device", "cpu"]) == 0
    assert "exporting checkpoint step" in capsys.readouterr().out
    for name in ("weights.npz", "scoring.pt2", "model.bin",
                 "sync_manifest.json", "aot/manifest.json"):
        assert (dest / name).exists(), name
    with np.load(out / "final_model" / "weights.npz") as a, \
            np.load(dest / "weights.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])
    for model in (out / "final_model", dest):
        assert jax_cli.main(["score", "--model", str(model), "--input", part,
                             "--output", str(tmp_path / f"{model.name}.txt"),
                             "--engine", "native"]) == 0
    assert (tmp_path / "final_model.txt").read_bytes() \
        == (tmp_path / "reexport.txt").read_bytes()
    assert cli.main(["export", "--modelconfig", str(root / "ModelConfig.json"),
                     "--columnconfig", str(root / "ColumnConfig.json"),
                     "--checkpoint-dir", str(tmp_path / "nowhere"),
                     "--output", str(tmp_path / "x")]) == 1


def _serve_in_thread(model: str, monkeypatch):
    """`cli.main(["serve", ...])` on a thread, its serve_forever given a
    stop event; returns (port, stop event, thread, exit codes)."""
    stop = threading.Event()
    lines: list = []
    real = serve.serve_forever

    def serve_forever(export_dir, config, echo=print, **kw):
        def both(line):
            lines.append(line)
            echo(line)
        return real(export_dir, config, echo=both, stop_event=stop, **kw)

    monkeypatch.setattr(serve, "serve_forever", serve_forever)
    rc: list = []
    th = threading.Thread(target=lambda: rc.append(cli.main(
        ["serve", model, "--port", "0", "--engine", "export",
         "--device", "cpu"])), daemon=True)
    th.start()
    deadline = time.monotonic() + 120
    while not lines and th.is_alive() and time.monotonic() < deadline:
        time.sleep(0.02)
    assert lines, "serve printed no address"
    assert "engine=export" in lines[0]
    port = int(lines[0].split(" on ")[1].split()[0].rsplit(":", 1)[1])
    return port, stop, th, rc


def test_serve_answers_both_packages_loadtests(job, monkeypatch, capsys,
                                               tmp_path):
    _, out, _ = job
    monkeypatch.setenv("SHIFU_TPU_METRICS_DIR", str(tmp_path / "tele"))
    port, stop, th, rc = _serve_in_thread(str(out / "final_model"),
                                          monkeypatch)
    try:
        args = ["loadtest", "--connect", f"127.0.0.1:{port}", "--rate",
                "200", "--duration", "0.5", "--senders", "2", "--json"]
        capsys.readouterr()
        assert cli.main(args + ["--device", "cpu"]) == 0
        ours = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert jax_cli.main(args) == 0
        theirs = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    finally:
        stop.set()
        th.join(timeout=120)
    assert not th.is_alive() and rc == [0]
    for rep in (ours, theirs):
        assert rep["mode"] == "socket" and rep["completed"] > 0
        assert rep["errors"] == 0 and rep["rejected"] == 0
    assert set(ours) == set(theirs)


def test_loadtest_in_process_and_its_text_report(job, capsys):
    _, out, _ = job
    assert cli.main(["loadtest", "--model", str(out / "final_model"),
                     "--engine", "torch", "--rate", "300", "--duration",
                     "0.3", "--device", "cpu"]) == 0
    text = capsys.readouterr().out
    assert text.startswith("loadtest [inproc]: offered 300/s")
    assert cli.main(["loadtest", "--device", "cpu"]) == 1


_POD_ROWS = [{"kind": "pod_epoch_close", "epoch": e, "rank": r, "hosts": 2,
              "order_digest": f"o{e}", "shard_digest": f"s{e}",
              "ingest_bytes": 100 + r, "ingest_s": 0.5}
             for e in range(2) for r in range(2)]


@pytest.mark.parametrize("command,item", [
    ("provision", "(f)"), ("pod-verify", "(f)"), ("data-dryrun", "(f)"),
])
def test_the_other_jax_commands_raise_naming_their_item(command, item,
                                                        tmp_path, capsys):
    """The three commands that once raised naming (f) now run as JAX's
    do: `provision` refuses an incomplete spec with JAX's message,
    `pod-verify` prints JAX's report on the same journal, and a lone
    `data-dryrun` rank journals JAX's digests on the same files."""
    del item
    if command == "provision":
        argv = ["provision", "status", "--zone", "z"]
        rc, out, err = cli.main(argv), *capsys.readouterr()
        want = (jax_cli.main(argv), *capsys.readouterr())
        assert (rc, out, err) == want and rc == 1
        assert "shifu.provision.name/accelerator-type" in err
    elif command == "pod-verify":
        tele = tmp_path / "job" / "telemetry"
        tele.mkdir(parents=True)
        (tele / "journal.jsonl").write_text(
            "".join(json.dumps(dict(r, ts=1.0 + i)) + "\n"
                    for i, r in enumerate(_POD_ROWS)))
        for extra in ([], ["--json"]):
            argv = ["pod-verify", str(tmp_path / "job"), *extra]
            rc, out = cli.main(argv), capsys.readouterr().out
            assert (rc, out) == (jax_cli.main(argv),
                                 capsys.readouterr().out)
            assert rc == 0 and "PASS" in out
    else:
        from shifu_tpu_torch.data import synthetic
        synthetic.write_files(synthetic.make_rows(
            48, synthetic.make_schema(num_features=4), seed=2),
            str(tmp_path / "d"), num_files=3)
        argv = ["data-dryrun", "--data", str(tmp_path / "d"), "--features",
                "4", "--epochs", "2", "--seed", "3"]
        closes = []
        for main, name, read in ((cli.main, "port", obs.read_journal),
                                 (jax_cli.main, "jax",
                                  jax_obs.read_journal)):
            obs.reset_for_tests()  # the ingest counters start at 0
            jax_obs.reset_for_tests()
            try:
                assert main(argv + ["--out", str(tmp_path / name)]) == 0
            finally:
                obs.reset_for_tests()
                jax_obs.reset_for_tests()
            closes.append([
                {k: e[k] for k in ("epoch", "rank", "hosts", "rows", "files",
                                   "order_digest", "shard_digest",
                                   "ingest_bytes")}
                for e in read(str(tmp_path / name / "telemetry" /
                                  "journal.jsonl"))
                if e["kind"] == "pod_epoch_close"])
        assert closes[0] == closes[1] and len(closes[0]) == 2
        assert capsys.readouterr().out.count("data-dryrun rank 0/1") == 4


def _load_make_demo():
    spec = importlib.util.spec_from_file_location(
        "make_demo_wdbc",
        os.path.join(REPO, "examples", "wdbc_demo", "make_demo.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_the_wdbc_demo_sequence_through_the_port(tmp_path):
    """examples/_run_demo.sh on the port's CLI at tests/test_demo.py's
    size: train, score with the default engine, score --native; the two
    agree within 1e-5, and the artifact has skill."""
    from shifu_tpu.data import synthetic
    from shifu_tpu.ops import auc
    paths = _load_make_demo().write_demo(str(tmp_path / "demo"), rows=1200,
                                         epochs=8)
    job_dir = tmp_path / "demo" / "job"
    assert cli.main(["train", "--modelconfig", paths["modelconfig"],
                     "--columnconfig", paths["columnconfig"],
                     "--data", paths["data"], "--output", str(job_dir),
                     "--device", "cpu"]) == 0
    part = sorted(p for p in os.listdir(paths["data"])
                  if p.startswith("part-"))[0]
    scores = {}
    for name, flags in (("python", []), ("native", ["--native"])):
        dest = tmp_path / f"scores_{name}.txt"
        assert cli.main(["score", "--model", str(job_dir / "final_model"),
                         "--input", os.path.join(paths["data"], part),
                         "--output", str(dest), "--device", "cpu",
                         *flags]) == 0
        scores[name] = np.loadtxt(dest)
    assert scores["python"].shape == scores["native"].shape
    assert np.abs(scores["python"] - scores["native"]).max() < NATIVE_ATOL
    schema = synthetic.make_schema(num_features=_load_make_demo()
                                   .NUM_FEATURES)
    matrix = synthetic.make_rows(1200, schema, seed=7, noise=0.3)
    from shifu_tpu_torch.export.scorer import load_scorer
    got = load_scorer(str(job_dir / "final_model"), device="cpu") \
        .compute_batch(matrix[:, 1:].astype(np.float32))
    assert auc(got[:, 0], matrix[:, 0]) > 0.8
