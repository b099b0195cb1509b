"""The port's slice provisioning (launcher/provision.py, `provision`,
`train --provision`, the marker in `detach` and `kill --force`) against
the JAX package's, driven through a fake `gcloud` on PATH as
tests/test_provision.py drives JAX's.

Each scenario runs once with the port's modules and once with JAX's on
its own fake gcloud log: the outcomes and every gcloud argv must be the
same.  Then `train --provision` end to end over the fake gcloud and a
fake `ssh` that runs the remote command here: the marker is written
during the run and cleared after it, the slice is deleted, the job's
artifact written.
"""

import json
import os
import subprocess
import sys
import time

import pytest

from shifu_tpu.launcher import detach as jax_detach
from shifu_tpu.launcher import provision as jax_prov
from shifu_tpu_torch.launcher import detach, provision

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GANG_TIMEOUT_S = 180

_FAKE_GCLOUD = f"""#!{sys.executable}
import json, os, sys
args = sys.argv[1:]
with open(os.environ["FAKE_GCLOUD_LOG"], "a") as f:
    f.write(json.dumps(args) + chr(10))
cmd = " ".join(args)
if "queued-resources create" in cmd:
    mode = os.environ.get("FAKE_GCLOUD_FAIL_CREATE")
    if mode == "ALREADY_EXISTS":
        sys.stderr.write("ERROR: ALREADY_EXISTS: resource exists" + chr(10))
        sys.exit(1)
    if mode:
        sys.stderr.write("ERROR: (gcloud) quota exceeded" + chr(10))
        sys.exit(1)
    sys.exit(0)
if "queued-resources describe" in cmd:
    sf = os.environ["FAKE_GCLOUD_STATE"]
    n = int(open(sf).read()) if os.path.exists(sf) else 0
    open(sf, "w").write(str(n + 1))
    states = os.environ.get("FAKE_GCLOUD_STATES", "ACTIVE").split(",")
    state = states[min(n, len(states) - 1)]
    print(json.dumps({{"state": {{"state": state}}}}))
    sys.exit(0)
if "tpu-vm describe" in cmd:
    print(json.dumps({{"networkEndpoints": [
        {{"ipAddress": "localhost"}}, {{"ipAddress": "localhost"}}]}}))
    sys.exit(0)
if "queued-resources delete" in cmd:
    if os.environ.get("FAKE_GCLOUD_DELETE_NOT_FOUND"):
        sys.stderr.write("ERROR: NOT_FOUND: no such queued resource" + chr(10))
        sys.exit(1)
    if os.environ.get("FAKE_GCLOUD_FAIL_DELETE_MSG"):
        sys.stderr.write(os.environ["FAKE_GCLOUD_FAIL_DELETE_MSG"] + chr(10))
        sys.exit(1)
    sys.exit(1 if os.environ.get("FAKE_GCLOUD_FAIL_DELETE") else 0)
sys.exit(64)
"""


def fake_gcloud_env(tmp_path, monkeypatch, tag: str = ""):
    """A fake gcloud first on PATH; returns its argv log."""
    fake_bin = tmp_path / f"bin{tag}"
    fake_bin.mkdir(exist_ok=True)
    (fake_bin / "gcloud").write_text(_FAKE_GCLOUD)
    (fake_bin / "gcloud").chmod(0o755)
    log = tmp_path / f"gcloud{tag}.log"
    monkeypatch.setenv("PATH", f"{fake_bin}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setenv("FAKE_GCLOUD_LOG", str(log))
    monkeypatch.setenv("FAKE_GCLOUD_STATE", str(tmp_path / f"state{tag}"))
    for var in ("FAKE_GCLOUD_FAIL_CREATE", "FAKE_GCLOUD_STATES",
                "FAKE_GCLOUD_DELETE_NOT_FOUND", "FAKE_GCLOUD_FAIL_DELETE",
                "FAKE_GCLOUD_FAIL_DELETE_MSG"):
        monkeypatch.delenv(var, raising=False)
    return log


def _calls(log):
    if not log.exists():
        return []
    return [json.loads(ln) for ln in log.read_text().splitlines()]


def _quiet(_msg):
    pass


def _try(fn):
    """fn()'s value, or the class and message of what it raised."""
    try:
        return fn()
    except Exception as e:  # noqa: BLE001 - compared across packages
        return (type(e).__name__, str(e))


# -- scenarios: (prov, det, tmp dir, monkeypatch) -> observable outcome ------


def _lifecycle(prov, det, d, mp):
    spec = prov.ProvisionSpec(name="s1", accelerator_type="v5litepod-8",
                              zone="us-west4-a", project="p", spot=True,
                              poll_seconds=0.01)
    prov.create(spec, echo=_quiet)
    prov.await_ready(spec, echo=_quiet)
    return (prov.worker_hosts(spec), prov.serving_hosts(spec),
            prov.state(spec), prov.delete(spec, echo=_quiet))


def _await_queue(prov, det, d, mp):
    mp.setenv("FAKE_GCLOUD_STATES", "ACCEPTED,WAITING_FOR_RESOURCES,ACTIVE")
    seen = []
    prov.await_ready(prov.ProvisionSpec(
        name="s2", accelerator_type="a", zone="z", poll_seconds=0.01),
        echo=seen.append)
    mp.setenv("FAKE_GCLOUD_STATES", "FAILED")
    mp.setenv("FAKE_GCLOUD_STATE", str(d / "fresh"))
    dead = _try(lambda: prov.await_ready(prov.ProvisionSpec(
        name="s3", accelerator_type="a", zone="z", poll_seconds=0.01),
        echo=_quiet))
    return seen, dead


def _run_fails(prov, det, d, mp):
    spec = prov.ProvisionSpec(name="s4", accelerator_type="a", zone="z",
                              poll_seconds=0.01)

    def boom(hosts):
        raise RuntimeError(f"boom on {hosts}")
    return _try(lambda: prov.provision_and_run(spec, boom, echo=_quiet,
                                               marker_dir=str(d / "j")))


def _marker_lifecycle(prov, det, d, mp):
    spec = prov.ProvisionSpec(name="m1", accelerator_type="v5litepod-8",
                              zone="us-west4-a")
    seen = {}

    def run_fn(hosts):
        seen["marker"] = {k: v for k, v in
                          prov.read_marker(str(d / "j")).items()
                          if k not in ("pid", "created_at")}
        return 7
    rc = prov.provision_and_run(spec, run_fn, echo=_quiet,
                                marker_dir=str(d / "j"))
    return rc, seen["marker"], prov.read_marker(str(d / "j"))


def _kept(prov, det, d, mp):
    spec = prov.ProvisionSpec(name="m2", accelerator_type="v5litepod-8",
                              zone="us-west4-a")
    rc = prov.provision_and_run(spec, lambda h: 0, echo=_quiet, keep=True,
                                marker_dir=str(d / "k"))
    return (rc, prov.read_marker(str(d / "k"))["keep"],
            prov.release_from_marker(str(d / "k"), echo=_quiet),
            prov.read_marker(str(d / "k")) is not None)


def _unclean_death(prov, det, d, mp):
    out = d / "leaked"
    out.mkdir()
    spec = prov.ProvisionSpec(name="leaked-slice",
                              accelerator_type="v5litepod-8",
                              zone="us-west4-a", project="p1")
    prov.write_marker(spec, str(out))
    dead = subprocess.Popen([sys.executable, "-c", "pass"])
    dead.wait()
    (out / det.JOB_FILE).write_text(json.dumps(
        {"pid": dead.pid, "host": os.uname().nodename}))
    before = det.job_state(str(out)).get("provisioned_slice")
    msgs = []
    rc = det.kill(str(out), echo=msgs.append)
    return (before, rc, any("released leaked-slice" in m for m in msgs),
            prov.read_marker(str(out)))


def _release_failures(prov, det, d, mp):
    spec = prov.ProvisionSpec(name="sticky", accelerator_type="a",
                              zone="us-west4-a")
    prov.write_marker(spec, str(d / "f"))
    out = []
    for env, val in (("FAKE_GCLOUD_FAIL_DELETE", "1"),
                     ("FAKE_GCLOUD_FAIL_DELETE_MSG",
                      "ERROR: project my-proj not found"),
                     ("FAKE_GCLOUD_FAIL_DELETE_MSG",
                      "ERROR: queued resource sticky not found")):
        mp.setenv(env, val)
        out.append((prov.release_from_marker(str(d / "f"), echo=_quiet),
                    prov.read_marker(str(d / "f")) is not None))
        mp.delenv(env)
        prov.write_marker(spec, str(d / "f"))
    mp.setenv("FAKE_GCLOUD_DELETE_NOT_FOUND", "1")
    out.append(prov.release_from_marker(str(d / "f"), echo=_quiet))
    return out


def _create_failures(prov, det, d, mp):
    spec = prov.ProvisionSpec(name="phantom", accelerator_type="a",
                              zone="us-west4-a")
    out = []
    for mode in ("1", "ALREADY_EXISTS"):
        mp.setenv("FAKE_GCLOUD_FAIL_CREATE", mode)
        mp.setenv("FAKE_GCLOUD_DELETE_NOT_FOUND", "1")
        err = _try(lambda: prov.provision_and_run(
            spec, lambda h: 0, echo=_quiet, marker_dir=str(d / mode)))
        out.append((err, prov.read_marker(str(d / mode))))
    # a retry after an unclean death of the same name keeps that trail
    prov.write_marker(spec, str(d / "retry"))
    for keep in (False, True):
        _try(lambda: prov.provision_and_run(
            spec, lambda h: 0, echo=_quiet, keep=keep,
            marker_dir=str(d / "retry")))
        marker = prov.read_marker(str(d / "retry"))
        out.append((marker["name"], bool(marker.get("keep"))))
    return out


def _cross_host_and_clobber(prov, det, d, mp):
    out = d / "nfs"
    out.mkdir()
    (out / prov.MARKER_FILE).write_text(json.dumps(
        {"name": "far-slice", "zone": "us-west4-a", "project": "",
         "keep": False, "pid": 1234, "host": "other-host.example"}))
    refused = det.kill(str(out), echo=_quiet)
    kept_trail = prov.read_marker(str(out)) is not None
    det.kill(str(out), echo=_quiet, force=True)
    kept = prov.ProvisionSpec(name="kept-x", accelerator_type="a", zone="z")
    prov.write_marker(kept, str(d / "t"), keep=True)
    clobber = _try(lambda: prov.provision_and_run(
        kept, lambda h: 0, echo=_quiet, marker_dir=str(d / "t")))
    return refused, kept_trail, prov.read_marker(str(out)), clobber


_SCENARIOS = {"lifecycle": _lifecycle, "await_queue": _await_queue,
              "run_fails": _run_fails, "marker": _marker_lifecycle,
              "kept": _kept, "unclean_death": _unclean_death,
              "release_failures": _release_failures,
              "create_failures": _create_failures,
              "cross_host_and_clobber": _cross_host_and_clobber}


@pytest.mark.parametrize("name", sorted(_SCENARIOS))
def test_scenarios_make_jax_gcloud_calls(name, tmp_path, monkeypatch):
    results, calls = [], []
    for tag, prov, det in (("port", provision, detach),
                           ("jax", jax_prov, jax_detach)):
        d = tmp_path / tag
        d.mkdir()
        log = fake_gcloud_env(tmp_path, monkeypatch, tag)
        # the job dir's path and the command's name are each package's own
        results.append(json.dumps(
            _SCENARIOS[name](prov, det, d, monkeypatch)).replace(
                str(d), "JOB").replace("shifu-tpu-torch ", "shifu-tpu "))
        calls.append(_calls(log))
    assert results[0] == results[1]
    assert calls[0] == calls[1] and calls[0]


def test_spec_from_xml_and_flags_equal_jax():
    conf = {"shifu.provision.name": "shifu-job",
            "shifu.provision.accelerator-type": "v5litepod-16",
            "shifu.provision.zone": "us-west4-a",
            "shifu.provision.spot": "true",
            "shifu.provision.ready-timeout-seconds": "600"}
    for over in ({}, {"zone": "europe-west4-b", "name": "other"}):
        got = provision.spec_from_xml(conf, **over)
        want = jax_prov.spec_from_xml(conf, **over)
        assert got.__dict__ == want.__dict__
    for bad in ({"shifu.provision.ready-timeout-seconds": "soon"},):
        assert _try(lambda: provision.spec_from_xml(bad)) == \
            _try(lambda: jax_prov.spec_from_xml(bad))
    assert _try(lambda: provision.ProvisionSpec(
        name="x", accelerator_type="", zone="z").validate()) == \
        _try(lambda: jax_prov.ProvisionSpec(
            name="x", accelerator_type="", zone="z").validate())


@pytest.mark.parametrize("action", ["create", "status", "hosts", "delete"])
def test_the_provision_command_equals_jax(action, tmp_path, monkeypatch,
                                          capsys):
    from shifu_tpu.launcher import cli as jax_cli
    from shifu_tpu_torch.launcher import cli

    argv = ["provision", action, "--provision-name", "cmd",
            "--accelerator-type", "v5litepod-8", "--zone", "us-west4-a",
            "--project", "p", "--spot"]
    if action == "create":
        argv.append("--wait")
    got = []
    for tag, main in (("port", cli.main), ("jax", jax_cli.main)):
        log = fake_gcloud_env(tmp_path, monkeypatch, tag)
        rc = main(argv)
        out = capsys.readouterr().out
        got.append((rc, out, _calls(log)))
    assert got[0] == got[1] and got[0][0] == 0


def test_kill_refuses_a_live_foreground_provision(tmp_path, monkeypatch):
    """A foreground `train --provision` writes no job.json; its marker
    names the live dispatcher, so `kill` refuses to release (exit 1) and
    `kill --force` releases."""
    log = fake_gcloud_env(tmp_path, monkeypatch)
    out = tmp_path / "live"
    live = subprocess.Popen(
        [sys.executable, "-c",
         "import shifu_tpu_torch.launcher, time; print('up', flush=True); "
         "time.sleep(600)"], stdout=subprocess.PIPE, text=True,
        env={**os.environ, "PYTHONPATH":
             REPO + os.pathsep + os.environ.get("PYTHONPATH", "")})
    try:
        live.stdout.readline()  # the child has exec'd
        spec = provision.ProvisionSpec(name="live-slice",
                                       accelerator_type="a",
                                       zone="us-west4-a")
        provision.write_marker(spec, str(out))
        marker = provision.read_marker(str(out))
        marker["pid"] = live.pid
        (out / provision.MARKER_FILE).write_text(json.dumps(marker))
        msgs = []
        assert detach.kill(str(out), echo=msgs.append) == 1
        assert any("LIVE dispatcher" in m for m in msgs), msgs
        assert not [c for c in _calls(log) if "delete" in c]
        detach.kill(str(out), echo=msgs.append, force=True)
        assert provision.read_marker(str(out)) is None
        assert [c for c in _calls(log) if "delete" in c]
    finally:
        live.kill()
        live.wait()


def test_train_provision_end_to_end(tmp_path, monkeypatch):
    """nothing -> slice -> gang -> released, in one command: `train
    --provision` over the fake gcloud (two workers at localhost) and a
    fake ssh; the marker exists while the gang trains and is gone after,
    and the last gcloud call deletes the slice."""
    from test_torch_pod_train import _env, _files

    log = fake_gcloud_env(tmp_path, monkeypatch)
    fake_bin = tmp_path / "bin"
    marker_seen = tmp_path / "marker_seen"
    (fake_bin / "ssh").write_text(
        "#!/bin/sh\n"
        "[ \"$1\" = -tt ] || { echo 'missing -tt' >&2; exit 64; }\n"
        "shift\n"
        "[ \"$1\" = -o ] && shift 2\n"
        "host=\"$1\"; shift\n"
        f"cp {tmp_path / 'job' / 'provision.json'} {marker_seen}"
        " 2>/dev/null\n"
        "exec sh -c \"$*\"\n")
    (fake_bin / "ssh").chmod(0o755)
    from shifu_tpu_torch.parallel.launch import free_port
    argv = _files(tmp_path, valid=0.1)
    env = _env(tmp_path)
    env.update(PATH=os.environ["PATH"], FAKE_GCLOUD_LOG=str(log),
               FAKE_GCLOUD_STATE=str(tmp_path / "state"))
    t0 = time.monotonic()
    r = subprocess.run(
        [sys.executable, "-m", "shifu_tpu_torch.launcher.cli", *argv,
         "--output", str(tmp_path / "job"), "--provision",
         "--provision-name", "shifu-e2e", "--accelerator-type",
         "v5litepod-8", "--zone", "us-west4-a", "--coordinator-port",
         str(free_port())],
        env=env, cwd=str(tmp_path), capture_output=True, text=True,
        timeout=GANG_TIMEOUT_S)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    assert time.monotonic() - t0 < GANG_TIMEOUT_S
    assert "provision: requesting v5litepod-8" in r.stdout
    assert "2 worker hosts: localhost, localhost" in r.stdout
    assert "provision: released shifu-e2e" in r.stdout
    assert json.loads(marker_seen.read_text())["name"] == "shifu-e2e"
    assert not (tmp_path / "job" / "provision.json").exists()
    calls = _calls(log)
    assert calls[0][3] == "create" and calls[-1][3] == "delete"
    assert (tmp_path / "job" / "final_model").exists()
