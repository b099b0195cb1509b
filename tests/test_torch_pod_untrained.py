"""A pod's one-epoch streamed run on unbalanced file shards.

The gang streams its first epoch in rounds, one block a host, and stops
at the first host whose stream runs dry; with `--epochs 1` no later epoch
trains the rest.  Each host with rows left over says how many, in the
JAX package's sentence (read from `shifu_tpu/train/loop.py`): the chief
on the launcher's console, another host on its own output, which the
launcher keeps in `logs/host-<rank>.attempt-1.log` (the launcher echoes
only rank 0's lines, as JAX's does).  The count is the host's
`StreamingLoader.train_rows_total()` less the rounds times the rows a
round, the rounds being those the smallest host fills (`train --hosts
local:2 --epochs 1 --device cpu`, three gangs at once, one an
arrangement):

- the big shard on host 0: the chief says it, host 1 has nothing left;
- the big shard on host 1: host 1 says it in its log, the chief says
  nothing;
- host 1 without a full round: no round trains, the epoch re-runs on all
  rows, and no host says anything.  JAX warns there too, though no row
  stays untrained; the port does not (ROADMAP C, deliberate
  differences).

`train_rows_total()` itself equals JAX's on the same files, in process.
"""

import ast
import json
import os
import re
import subprocess
import sys

import pytest

from shifu_tpu_torch.config import schema as port_schema
from shifu_tpu_torch.data import pipeline as pipe
from shifu_tpu_torch.data import synthetic
from shifu_tpu_torch.utils import xmlconfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GANG_TIMEOUT_S = 180
BATCH = 64
# the rows of each data file, in name order; the round-robin by index
# gives host 0 the even files and host 1 the odd ones.  A round is 32
# batches of 32 rows a host (1024), so 1024 rows fill exactly one
ARRANGEMENTS = {
    "big_on_host0": (2500, 1024, 1500),
    "big_on_host1": (1024, 4000),
    "no_full_round": (2500, 600, 1500),
}
STREAM = re.compile(r"Streaming first epoch: .*\(batch (\d+), (\d+) "
                    r"batches/chunk\)")


def jax_sentence() -> re.Pattern:
    """The JAX loop's untrained-rows sentence, its count a group."""
    with open(os.path.join(REPO, "shifu_tpu", "train", "loop.py")) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.JoinedStr) and any(
                isinstance(v, ast.Constant) and "untrained" in v.value
                for v in node.values):
            return re.compile("".join(
                re.escape(v.value) if isinstance(v, ast.Constant)
                else r"(\d+)" for v in node.values))
    raise AssertionError("no untrained-rows sentence in JAX's loop")


UNTRAINED = jax_sentence()


def write_arrangement(root, rows: tuple) -> list:
    """Shifu config files and the data files of one arrangement; returns
    the train argv."""
    schema = synthetic.make_schema(num_features=8)
    data = root / "data"
    data.mkdir(parents=True)
    for i, n in enumerate(rows):
        (path,) = synthetic.write_files(
            synthetic.make_rows(n, schema, seed=100 + i, noise=0.3),
            str(root / f"w{i}"), num_files=1)
        os.replace(path, data / f"part-{i:05d}.gz")
    mc = {"basic": {"name": "untrained"},
          "dataSet": {"targetColumnName": "target", "dataDelimiter": "|"},
          "train": {"validSetRate": 0.0, "numTrainEpochs": 1,
                    "algorithm": "NN",
                    "params": {"NumHiddenLayers": 1, "NumHiddenNodes": [8],
                               "ActivationFunc": ["relu"],
                               "LearningRate": 0.05, "Propagation": "Q",
                               "Loss": "squared"}}}
    cc = [{"columnNum": c.index, "columnName": c.name,
           "columnFlag": "Target" if c.is_target else None,
           "columnType": "N", "finalSelect": c.is_selected}
          for c in schema.columns]
    (root / "ModelConfig.json").write_text(json.dumps(mc))
    (root / "ColumnConfig.json").write_text(json.dumps(cc))
    xmlconfig.write_configuration_xml(
        {"shifu.data.staged": "true",
         "shifu.application.batch-size": str(BATCH),
         "shifu.checkpoint.save-seconds": "0"}, str(root / "global.xml"))
    return ["train", "--modelconfig", str(root / "ModelConfig.json"),
            "--columnconfig", str(root / "ColumnConfig.json"),
            "--data", str(data), "--globalconfig", str(root / "global.xml"),
            "--output", str(root / "job"), "--epochs", "1",
            "--hosts", "local:2", "--device", "cpu"]


@pytest.fixture(scope="module")
def gangs(tmp_path_factory):
    """Every arrangement's gang, started at once; each case waits for its
    own."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("SHIFU_TPU_")}
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH")) if p)
    out = {}
    for name, rows in ARRANGEMENTS.items():
        root = tmp_path_factory.mktemp(name)
        argv = write_arrangement(root, rows)
        proc = subprocess.Popen(
            [sys.executable, "-m", "shifu_tpu_torch.launcher.cli", *argv],
            env=env, cwd=str(root), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        out[name] = (root, proc)
    yield out
    for _root, proc in out.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait(10)


def host_train_rows(root) -> list:
    data = port_schema.DataConfig(paths=(str(root / "data"),),
                                  valid_ratio=0.0, batch_size=BATCH)
    schema = synthetic.make_schema(num_features=8)
    return [pipe.StreamingLoader(schema, data, host_index=h,
                                 num_hosts=2).train_rows_total()
            for h in range(2)]


@pytest.mark.parametrize("name", sorted(ARRANGEMENTS))
def test_one_epoch_pod_says_what_stays_untrained(gangs, name):
    root, proc = gangs[name]
    try:
        stdout, _ = proc.communicate(timeout=GANG_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        pytest.fail(f"{name}: the gang did not end in {GANG_TIMEOUT_S} s")
    assert proc.returncode == 0, stdout[-4000:]
    chunk = STREAM.search(stdout)
    assert chunk is not None, stdout[-4000:]
    local_bs = int(chunk.group(1)) // 2
    round_rows = int(chunk.group(2)) * local_bs
    rows = host_train_rows(root)
    logs = sorted(os.listdir(root / "job" / "logs"))
    assert logs == ["host-0.attempt-1.log", "host-1.attempt-1.log"]
    said = [[int(n) for n in UNTRAINED.findall(text)] for text in (
        stdout, (root / "job" / "logs" / logs[1]).read_text())]
    rounds = min(r // round_rows for r in rows)
    if name == "no_full_round":
        assert rounds == 0
        assert said == [[], []], said
        assert f"re-running epoch 0 with batch {BATCH}" in stdout
        assert "Epoch 0:" in stdout
        return
    skipped = [r - rounds * round_rows for r in rows]
    assert rounds == 1 and sorted(skipped)[0] == 0, (rows, round_rows)
    assert said == [[s] if s > 0 else [] for s in skipped], (said, skipped)
    assert said[0 if name == "big_on_host0" else 1], said
    assert "re-running epoch" not in stdout
    assert (root / "job" / "final_model" / "weights.npz").exists()


@pytest.mark.parametrize("valid_ratio", [0.0, 0.25])
@pytest.mark.parametrize("name", sorted(ARRANGEMENTS))
def test_train_rows_total_equals_jax(tmp_path, name, valid_ratio):
    from shifu_tpu.config import schema as jax_schema
    from shifu_tpu.data import pipeline as jax_pipe
    from shifu_tpu.data import synthetic as jax_synth
    write_arrangement(tmp_path, ARRANGEMENTS[name])
    paths = (str(tmp_path / "data"),)
    schema = synthetic.make_schema(num_features=8)
    jschema = jax_synth.make_schema(num_features=8)
    data = port_schema.DataConfig(paths=paths, valid_ratio=valid_ratio)
    jdata = jax_schema.DataConfig(paths=paths, valid_ratio=valid_ratio)
    for host in range(2):
        port = pipe.StreamingLoader(schema, data, host_index=host,
                                    num_hosts=2)
        jax = jax_pipe.StreamingLoader(jschema, jdata, host_index=host,
                                       num_hosts=2)
        got = port.train_rows_total()
        assert got == jax.train_rows_total()
        # the same count once the datasets are assembled
        assert port.datasets()[0].num_rows == got
        assert port.train_rows_total() == got
    assert got > 0
