"""The port's `fleet` command, `serve --heartbeat-s` and the `shifu.fleet.*`
keys through the command line, on the CPU.

- `fleet` refuses what JAX's refuses with the same message, the JAX
  engine names with the port's counterparts named, and the card when there
  is none (its default device is `cuda:0`).
- `serve --heartbeat-s` writes the fleet's lease (its host from
  SHIFU_TPU_FLEET_HOST) and a SIGTERM ends it with 0.
- `fleet` in a child process, with in-process members and with `serve`
  children (`--member-mode process`, the XML's member-port-base): routed
  answers, a killed child failed over, a SIGTERM that ends it with 0 and
  leaves no child behind, and `fleet-verify` PASS on its journals.
"""

import os
import random
import signal
import socket
import subprocess
import sys
import time

import pytest
import torch

from shifu_tpu.launcher import cli as jax_cli
from shifu_tpu_torch import obs
from shifu_tpu_torch.launcher import cli
from shifu_tpu_torch.runtime import fleet, loadtest, serve_wire
from shifu_tpu_torch.utils import xmlconfig

from test_torch_fleet import _reset_all, wait_for
from test_torch_fleet_model import ft_artifact, rows

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD_TIMEOUT_S = 120


@pytest.fixture(autouse=True)
def _clean():
    _reset_all()
    yield
    _reset_all()


@pytest.fixture(scope="module")
def art(tmp_path_factory):
    return ft_artifact(tmp_path_factory.mktemp("fleet_cli") / "ft", 0, "on")


def _refusal(main, argv, capsys) -> tuple:
    capsys.readouterr()
    rc = main(argv)
    return rc, capsys.readouterr().err


@pytest.mark.parametrize("flags", [["--n-daemons", "9"],
                                   ["--standbys", "0", "--hosts", "local:0"],
                                   ["--heartbeat-s", "0.5",
                                    "--scale-every-s", "-0"] + [
                                       "--globalconfig", "BAD"]])
def test_fleet_refuses_a_bad_config_like_jax(tmp_path, capsys, flags):
    if "BAD" in flags:
        xml = str(tmp_path / "bad.xml")
        xmlconfig.write_configuration_xml(
            {"shifu.fleet.scale-up-burn": "0.1"}, xml)
        flags = [xml if f == "BAD" else f for f in flags]
    argv = ["fleet", str(tmp_path / "art"), *flags]
    got = _refusal(cli.main, argv + ["--device", "cpu"], capsys)
    want = _refusal(jax_cli.main, argv, capsys)
    assert got == want and got[0] == 1 and got[1].startswith("fleet: ")


@pytest.mark.parametrize("engine,counterpart", [("jax", "torch"),
                                                ("stablehlo", "export")])
def test_fleet_names_the_ports_engines(tmp_path, capsys, engine,
                                       counterpart):
    rc, err = _refusal(cli.main, ["fleet", str(tmp_path), "--engine", engine,
                                  "--device", "cpu"], capsys)
    assert rc == 1
    assert f"torch and export stand in for the JAX package's jax and " \
        "stablehlo" in err and repr(engine) in err


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_fleet_defaults_to_the_card(tmp_path, capsys):
    rc, err = _refusal(cli.main, ["fleet", str(tmp_path)], capsys)
    assert rc == 1 and "CUDA is not available" in err


# -- child processes ---------------------------------------------------------


def _env(**extra) -> dict:
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("SHIFU_TPU_")}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.update(extra)
    return env


def _child(args: list, env: dict) -> subprocess.Popen:
    return subprocess.Popen(
        [sys.executable, "-m", "shifu_tpu_torch.launcher.cli", *args],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, start_new_session=True)


def _first_line(proc, prefix: str) -> str:
    deadline = time.monotonic() + CHILD_TIMEOUT_S
    seen = []
    while time.monotonic() < deadline:
        line = proc.stdout.readline()
        if not line:
            break
        seen.append(line)
        if line.startswith(prefix):
            return line
    proc.kill()
    raise AssertionError(f"no {prefix!r} line: {''.join(seen)[-3000:]}")


def _port_of(line: str) -> int:
    return int(line.split(" on ")[1].split()[0].rsplit(":", 1)[1])


def _end(proc) -> tuple:
    os.kill(proc.pid, signal.SIGTERM)
    try:
        out, _ = proc.communicate(timeout=60)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
    return proc.returncode, out


def _alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    try:   # a zombie is not alive
        with open(f"/proc/{pid}/stat") as f:
            return f.read().split(")")[1].split()[0] != "Z"
    except OSError:
        return False


def _free_base(n: int) -> int:
    """A port base whose next `n` ports are free."""
    rng = random.Random(os.getpid())
    for _ in range(50):
        base = rng.randrange(20000, 40000)
        socks = []
        try:
            for p in range(base, base + n):
                s = socket.socket()
                s.bind(("127.0.0.1", p))
                socks.append(s)
            return base
        except OSError:
            continue
        finally:
            for s in socks:
                s.close()
    raise RuntimeError("no free port range")


def test_serve_heartbeat_writes_the_fleet_lease(art, tmp_path):
    tele = tmp_path / "tele"
    proc = _child(["serve", art, "--port", "0", "--engine", "torch",
                   "--heartbeat-s", "0.2", "--heartbeat-misses", "4",
                   "--device", "cpu"],
                  _env(SHIFU_TPU_METRICS_DIR=str(tele),
                       SHIFU_TPU_FLEET_HOST="local-7"))
    line = _first_line(proc, "serve: model=")
    lease = fleet.read_lease(str(tele))
    assert lease["member"] == f"serve-{proc.pid}"
    assert lease["host"] == "local-7" and lease["ttl_s"] == 0.8
    assert wait_for(lambda: (fleet.read_lease(str(tele)) or {}).get(
        "seq", 0) > lease["seq"], 5.0)
    with serve_wire.ServeClient("127.0.0.1", _port_of(line)) as c:
        assert c.score_rows(rows(2), dtype=serve_wire.DTYPE_F32).shape == (
            2, 1)
        # the child's own account of where it scores: on the CPU no
        # kernel launched (on the card 22h reads #1 and #5 here)
        stats = c.stats()
        assert (stats["device"], stats["launches"]) == ("cpu", {})
    rc, out = _end(proc)
    assert rc == 0, out
    seq = fleet.read_lease(str(tele))["seq"]
    time.sleep(0.5)
    assert fleet.read_lease(str(tele))["seq"] == seq  # no beat after


@pytest.mark.parametrize("mode", ["inproc", "process"])
def test_the_fleet_command_serves_fails_over_and_stops(art, tmp_path, mode,
                                                       capsys):
    root = tmp_path / "fleet"
    xml = str(tmp_path / "fleet.xml")
    xmlconfig.write_configuration_xml({
        "shifu.fleet.member-port-base": str(_free_base(4)),
        "shifu.fleet.heartbeat-every-s": "0.5",
        # a CPU shared with other test workers can stall one request past
        # the 1 s default, and the one member in rotation has no hedge
        "shifu.fleet.route-timeout-ms": "30000",
        "shifu.serving.max-batch": "256"}, xml)
    proc = _child(["fleet", art, "--member-mode", mode, "--hosts", "local:2",
                   "--n-daemons", "1", "--standbys", "1", "--port", "0",
                   "--root-dir", str(root), "--globalconfig", xml,
                   "--device", "cpu"],
                  _env(SHIFU_TPU_METRICS_DIR=str(root)))
    try:
        line = _first_line(proc, "fleet: ")
        assert f"{mode} members" in line
        port = _port_of(line)
        rep = loadtest.run_loadtest(connect=f"127.0.0.1:{port}", rate=100.0,
                                    duration=1.0, senders=2, seed=1)
        assert rep["errors"] == 0 and rep["completed"] == rep["submitted"]
        leases = {m: fleet.read_lease(str(root / m))
                  for m in ("member-0", "member-1")}
        assert {m: lease["host"] for m, lease in leases.items()} == {
            "member-0": "local-0", "member-1": "local-1"}
        children = [lease["pid"] for lease in leases.values()]
        if mode == "process":
            # a serve child's whole tree killed: its lease ages out
            assert proc.pid not in children
            os.killpg(leases["member-0"]["pid"], signal.SIGKILL)
            journal = root / "journal.jsonl"
            assert wait_for(lambda: any(
                e["kind"] == "fleet_failover"
                for e in obs.read_journal(str(journal))), 10.0)
            # the replacement standby, a child that loads for seconds
            # before its first lease, is not swept as dead meanwhile
            assert wait_for(lambda: fleet.read_lease(
                str(root / "member-2")) is not None, CHILD_TIMEOUT_S)
        else:
            assert children == [proc.pid] * 2
        with serve_wire.ServeClient("127.0.0.1", port, timeout=30) as c:
            assert c.score_rows(rows(3), dtype=serve_wire.DTYPE_F32).shape \
                == (3, 1)
    finally:
        rc, out = _end(proc)
    assert rc == 0, out
    assert "fleet: stopped - " in out
    if mode == "process":
        pids = [fleet.read_lease(str(d))["pid"] for d in root.iterdir()
                if (d / fleet.LEASE_FILE).exists()]
        assert len(pids) == 3
        assert wait_for(lambda: not any(_alive(p) for p in pids), 10.0)
    capsys.readouterr()
    assert cli.main(["fleet-verify", str(root)]) == 0
    assert capsys.readouterr().out.startswith("fleet-verify: PASS")
    evs = obs.read_journal(str(root / "journal.jsonl"))
    fo = [(e["member"], e["standby"]) for e in evs
          if e["kind"] == "fleet_failover"]
    assert fo == ([("member-0", "member-1")] if mode == "process" else [])
    assert [e["kind"] for e in evs if e["kind"] in (
        "fleet_start", "fleet_serve_start")] == ["fleet_start",
                                                 "fleet_serve_start"]
