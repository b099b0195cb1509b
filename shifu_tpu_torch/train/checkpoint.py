"""Checkpoint save and auto-resume with a self-healing restore (port of
shifu_tpu/train/checkpoint.py, in the port's own format: no Orbax).

A checkpoint directory holds one step tree per save, `<dir>/<step>/`, with
`state.pt` (`torch.save` of the model's `state_dict`, the optimizer
chain's state, `TrainState.step` and, under a sparse plan,
`TrainState.table_slots`) and `extra.json` (`{"epoch", "best_restored"}`).
A save writes into a temporary directory that is renamed into place, so a
step tree is whole or absent.  Beside the step trees:

- `manifest-<step>.json`: blake2b over every file of the step tree, and
  `state_tree`, the path, shape and dtype of every leaf.  It is written
  after the data, once the save is durable.  Restore re-hashes the tree
  (unless SHIFU_TPU_CKPT_VERIFY=0) and checks `state_tree` against the
  restore target before any tensor is loaded.
- `PROGRESS`: {"epoch", "step"} of the newest durable save.

`restore_latest` is the recovery ladder: a corrupt or unreadable newest
step falls back to the newest earlier verified one (journaled as
`checkpoint_fallback`); an incompatible step (`CheckpointIncompatibleError`)
re-raises; when every step fails the first error is re-raised.  Steps past
`max_to_keep` are deleted after a save, each journaled as `checkpoint_gc`.
A save on an existing step bumps its key instead of deleting first: the
key only orders the saves, the true step is in the state.  With
`block=False` the state is copied to the host first and written on one
background thread; at most one save is in flight, and `finalize` makes it
durable.

A state on a mesh (train/loop.py) saves full tensors: the chief writes
what `full_payload` gathered from every rank's blocks of the split
parameters (tables split by vocab or field, experts, pipeline stages,
rule-split leaves), their optimizer slots and their table slots: the same
files a world-1 run writes.  A restore
checks the full shapes and keeps this rank's blocks, so a checkpoint
resumes on any mesh, or on none.

A remote directory (gs:// hdfs:// mock://) holds the same files through
`data/fsio.py`.  Object stores have no directory rename, so a remote save
writes `state.pt` into the step tree and `extra.json` last: a remote step
tree is committed once its `extra.json` exists, and listings skip the
others.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import shutil
import threading
import time
from typing import Any, Iterable, Optional

import torch

from .. import chaos, obs
from ..data import fsio

PROGRESS_MARKER = "PROGRESS"
MANIFEST_PREFIX = "manifest-"
STATE_FILE = "state.pt"
EXTRA_FILE = "extra.json"
_DIGEST_ALGO = "blake2b-128"


class CheckpointCorruptError(RuntimeError):
    """The step tree's bytes no longer match its digest manifest."""


class CheckpointIncompatibleError(RuntimeError):
    """The checkpoint's recorded state tree (leaf paths, shapes, dtypes)
    does not match the restore target: another model, not corruption.
    Raised before any tensor is loaded."""


class CheckpointManager:
    """A checkpoint directory: its step trees, its retention and its one
    background writer."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.remote = fsio.is_remote(directory)
        self.directory = (directory.rstrip("/") if self.remote
                          else os.path.abspath(directory))
        self.max_to_keep = max(int(max_to_keep), 1)
        if not self.remote:
            os.makedirs(self.directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        # (step, extra, tree_spec) of an async save not yet known durable
        self._pending: Optional[tuple] = None

    def all_steps(self) -> list[int]:
        if self.remote:
            return _remote_committed_steps(self.directory)
        try:
            names = os.listdir(self.directory)
        except FileNotFoundError:
            return []
        return sorted(int(n) for n in names if n.isdigit()
                      and os.path.isdir(os.path.join(self.directory, n)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def wait_until_finished(self) -> None:
        """Join the in-flight background save; re-raise its error."""
        t, self._thread = self._thread, None
        if t is not None:
            t.join()
        err, self._error = self._error, None
        if err is not None:
            raise err


def make_manager(directory: str, max_to_keep: int = 3) -> CheckpointManager:
    return CheckpointManager(directory, max_to_keep)


def _remote_committed_steps(directory: str) -> list[int]:
    """Digit-named step trees of a remote directory that hold their
    `extra.json` (the commit mark a remote save writes last), ascending."""
    from pyarrow import fs as pafs
    filesystem, fs_path = fsio._filesystem(directory)
    base = fs_path.rstrip("/")
    infos = fsio._retry_transient(
        lambda: filesystem.get_file_info(
            pafs.FileSelector(base, recursive=False, allow_not_found=True)),
        op_name="checkpoint_list")
    steps = [int(i.base_name) for i in infos
             if i.type == pafs.FileType.Directory and i.base_name.isdigit()]
    return sorted(s for s in steps
                  if fsio.exists(fsio.join(directory, str(s), EXTRA_FILE)))


def _remote_delete_tree(directory: str, step: int) -> None:
    filesystem, fs_path = fsio._filesystem(fsio.join(directory, str(step)))
    try:
        filesystem.delete_dir(fs_path.rstrip("/"))
    except Exception:
        pass


def _write_progress_marker(directory: str, step: int,
                           extra: Optional[dict]) -> None:
    """`<dir>/PROGRESS` ({"epoch": E, "step": S}), rewritten on every
    durable save: the durable-progress probe, keyed on the epoch (the
    step re-inflates when a mid-epoch resume replays its epoch).
    Best-effort: a marker failure must never fail the checkpoint."""
    payload = json.dumps({"epoch": int((extra or {}).get("epoch", -1)),
                          "step": int(step)}).encode()
    try:
        fsio.write_bytes(fsio.join(directory, PROGRESS_MARKER), payload)
    except Exception:
        pass


# -- the state tree -----------------------------------------------------------

def _host_copy(obj):
    """The state's nested dicts, lists and tuples with every tensor copied
    to the host (an async save must not read tensors later steps change)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _host_copy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_host_copy(v) for v in obj)
    return obj


def state_payload(state) -> dict:
    """What a step holds of a TrainState, as plain nested containers (on
    a mesh: this rank's blocks)."""
    return {"model": state.model.state_dict(),
            "optimizer": state.optimizer.state_dict(),
            "step": int(state.step),
            "table_slots": (None if state.table_slots is None
                            else {k: list(v)
                                  for k, v in state.table_slots.items()})}


def _map_opt(obj, n: int, positions: dict, fn):
    """The optimizer state with fn(sharding, slot) applied to the slots of
    split parameters: a transformation's per-parameter slots are a list of
    `n` tensors in the optimizer's parameter order."""
    if isinstance(obj, dict):
        return {k: _map_opt(v, n, positions, fn) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        if len(obj) == n and all(isinstance(x, torch.Tensor) for x in obj):
            return type(obj)(fn(positions[i], x) if i in positions else x
                             for i, x in enumerate(obj))
        return type(obj)(_map_opt(v, n, positions, fn) for v in obj)
    return obj


def _map_sharded(payload: dict, state, fn) -> dict:
    """`payload` with fn(sharding, tensor) applied to the leaves of the
    state's split parameters: the parameter, its optimizer slots and its
    table slots."""
    if not getattr(state, "shardings", None):
        return payload
    out = dict(payload, model=dict(payload["model"]))
    slots = payload.get("table_slots")
    if slots is not None:
        out["table_slots"] = dict(slots)
    for name, sh in state.shardings.items():
        out["model"][name] = fn(sh, payload["model"][name])
        if slots is not None and name in slots:
            out["table_slots"][name] = [fn(sh, t) for t in slots[name]]
    names = {id(p): n for n, p in state.model.named_parameters()}
    opt_params = state.optimizer.params
    positions = {i: state.shardings[names[id(p)]]
                 for i, p in enumerate(opt_params)
                 if names.get(id(p)) in state.shardings}
    if positions:
        out["optimizer"] = _map_opt(payload["optimizer"], len(opt_params),
                                    positions, fn)
    return out


def full_payload(state) -> dict:
    """The payload with every sharded block gathered into its full tensor:
    a collective over the mesh's groups, which every rank must call."""
    return _map_sharded(state_payload(state), state,
                        lambda sh, t: sh.gather(t.detach()))


def _full_shaped(state) -> dict:
    """The payload's tree as the checkpoint holds it (full shapes; the
    sharded leaves as shape-only meta tensors), for the compatibility
    check, with no collective."""
    def meta(sh, t):
        return torch.empty(sh.full_shape(t.shape), dtype=t.dtype,
                           device="meta")
    return _map_sharded(state_payload(state), state, meta)


def _leaves(obj, path: str = ""):
    if isinstance(obj, dict):
        for k in obj:
            yield from _leaves(obj[k], f"{path}/{k}")
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, obj


def _tree_spec(payload: dict) -> list:
    """[[leaf path, shape, dtype], ...] of a state payload: recorded in
    the manifest so that restore can refuse an incompatible checkpoint
    before it loads anything."""
    out = []
    for path, x in _leaves(payload):
        if isinstance(x, torch.Tensor):
            out.append([path, [int(d) for d in x.shape],
                        str(x.dtype).replace("torch.", "")])
        else:
            out.append([path, [], type(x).__name__])
    return out


# -- integrity: digest manifests ----------------------------------------------

def manifest_path(directory: str, step: int) -> str:
    return fsio.join(str(directory), f"{MANIFEST_PREFIX}{int(step)}.json")


def _tree_files(root: str) -> Iterable[tuple[str, int]]:
    prefix = root.rstrip("/")
    remote = fsio.is_remote(root)
    for full, size in fsio.walk_files(root):
        rel = (full[len(prefix):].lstrip("/") if remote
               else os.path.relpath(full, root))
        yield rel, size


def _digest_file(root: str, rel: str) -> str:
    """Streaming blake2b of one file, in 1 MiB chunks.  A remote read
    retries a transient error over the whole file (a fresh hash each
    attempt): a network blip during a verify must read as a retry, never
    as a corrupt checkpoint."""
    chunk_bytes = 1 << 20
    if fsio.is_remote(root):
        def op() -> str:
            h = hashlib.blake2b(digest_size=16)
            f = fsio.open_input_file(fsio.join(root, rel))
            try:
                while True:
                    chunk = f.read(chunk_bytes)
                    if not chunk:
                        break
                    h.update(bytes(chunk))
            finally:
                f.close()
            return h.hexdigest()

        return fsio._retry_transient(op, op_name="digest_file")
    h = hashlib.blake2b(digest_size=16)
    with open(os.path.join(root, rel), "rb") as f:
        for chunk in iter(lambda: f.read(chunk_bytes), b""):
            h.update(chunk)
    return h.hexdigest()


def write_manifest(directory: str, step: int,
                   tree_spec: Optional[list] = None) -> Optional[dict]:
    """Hash every file of the committed step tree into
    `<dir>/manifest-<step>.json`, once the save is durable.  Best-effort:
    restore treats a missing manifest as unverified."""
    step_dir = fsio.join(str(directory), str(int(step)))
    try:
        files = {rel: [_digest_file(step_dir, rel), size]
                 for rel, size in _tree_files(step_dir)}
        manifest = {"step": int(step), "algo": _DIGEST_ALGO, "files": files}
        if tree_spec:
            manifest["state_tree"] = tree_spec
        fsio.write_bytes(manifest_path(directory, step),
                         json.dumps(manifest).encode())
        return manifest
    except Exception:
        return None


def read_manifest(directory: str, step: int) -> Optional[dict]:
    try:
        m = json.loads(fsio.read_bytes(manifest_path(directory, step)))
        return m if isinstance(m, dict) else None
    except Exception:
        return None


def verify_manifest(directory: str, step: int) -> Optional[bool]:
    """Re-hash the step tree against its manifest.  True = verified;
    False = mismatch, missing or unreadable files; None = no manifest
    (restore proceeds on trust)."""
    manifest = read_manifest(directory, step)
    if manifest is None or not isinstance(manifest.get("files"), dict):
        return None
    step_dir = fsio.join(str(directory), str(int(step)))
    have = dict(_tree_files(step_dir))
    for rel, entry in manifest["files"].items():
        digest, size = (entry[0], entry[1]) if isinstance(entry, list) \
            else (entry, None)
        if rel not in have or (size is not None and have[rel] != size):
            return False
        try:
            if _digest_file(step_dir, rel) != digest:
                return False
        except Exception:
            return False
    return True


def _finalize_durable(directory: str, step: int, extra: Optional[dict],
                      tree_spec: Optional[list] = None) -> None:
    """After a save is durable: the manifest first (the marker must never
    advertise progress whose integrity record is missing), then PROGRESS,
    then the "checkpoint.post_save" chaos probe, the injection point that
    models silent damage to a committed checkpoint."""
    write_manifest(directory, step, tree_spec)
    _write_progress_marker(directory, step, extra)
    try:
        chaos.maybe_fail("checkpoint.post_save", step=int(step),
                         path=fsio.join(directory, str(int(step))))
    except chaos.ChaosError:
        pass  # post-save actions model data damage, not process failure


def _flush_pending_marker(manager: CheckpointManager) -> None:
    pending, manager._pending = manager._pending, None
    if pending is not None:
        step, extra, tree_spec = pending
        _finalize_durable(manager.directory, step, extra, tree_spec)


# -- save ---------------------------------------------------------------------

def _step_size(directory: str, step: int) -> int:
    return sum(size for _, size in
               _tree_files(fsio.join(directory, str(step))))


def _gc(manager: CheckpointManager) -> None:
    """Delete the oldest steps past max_to_keep, each with its manifest,
    each journaled as `checkpoint_gc` with the bytes it freed."""
    steps = manager.all_steps()
    drop, kept = steps[:-manager.max_to_keep], steps[-manager.max_to_keep:]
    for step in drop:
        size = _step_size(manager.directory, step)
        if manager.remote:
            _remote_delete_tree(manager.directory, step)
            try:
                filesystem, fs_path = fsio._filesystem(
                    manifest_path(manager.directory, step))
                filesystem.delete_file(fs_path)
            except Exception:
                pass
        else:
            shutil.rmtree(os.path.join(manager.directory, str(step)),
                          ignore_errors=True)
            try:
                os.unlink(manifest_path(manager.directory, step))
            except OSError:
                pass
        obs.counter("checkpoint_gc_total",
                    "checkpoint steps garbage-collected").inc()
        obs.counter("checkpoint_gc_bytes_total",
                    "bytes freed by checkpoint retention").inc(int(size))
        obs.event("checkpoint_gc", step=int(step), freed_bytes=int(size),
                  kept=kept)


def _write_step(manager: CheckpointManager, step: int, payload: dict,
                extra: Optional[dict]) -> None:
    """The step tree in a temporary directory, renamed into place (on a
    remote directory: the state, then `extra.json` as the commit mark);
    then retention."""
    if manager.remote:
        step_dir = fsio.join(manager.directory, str(int(step)))
        buf = io.BytesIO()
        torch.save(payload, buf)
        fsio.write_bytes(fsio.join(step_dir, STATE_FILE), buf.getvalue())
        fsio.write_bytes(fsio.join(step_dir, EXTRA_FILE),
                         json.dumps(extra).encode())
        _gc(manager)
        return
    final = os.path.join(manager.directory, str(int(step)))
    tmp = os.path.join(manager.directory, f".tmp-{int(step)}-{os.getpid()}")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(payload, os.path.join(tmp, STATE_FILE))
    with open(os.path.join(tmp, EXTRA_FILE), "w") as f:
        json.dump(extra, f)
    os.replace(tmp, final)
    _gc(manager)


def save(manager: CheckpointManager, step: int, state,
         extra: Optional[dict] = None, block: bool = True,
         payload: Optional[dict] = None) -> None:
    """Save the train state (and a small metadata dict) at `step`.

    `block=False` (CheckpointConfig.async_save) copies the state to the
    host, then writes it on a background thread that overlaps the next
    epoch; any previous in-flight save is finalized first.  `payload`
    (default `state_payload(state)`) is what to write: on a mesh, the
    chief passes `full_payload`'s gathered tensors."""
    manager.wait_until_finished()  # at most one save in flight
    _flush_pending_marker(manager)  # the previous async save is durable
    # the clock starts after the previous save's drain: an async
    # observation times this save's dispatch only
    t0 = time.perf_counter()
    # a save on an existing step must still win (a terminal save can land
    # on the step of a cadence save with another extra): bump the key past
    # the collision rather than deleting the newest durable step first
    existing = set(manager.all_steps())
    while step in existing:
        step += 1
    payload = _host_copy(state_payload(state) if payload is None
                         else payload)
    tree_spec = _tree_spec(payload)
    chaos.maybe_fail("checkpoint.save", step=int(step))
    if block:
        _write_step(manager, step, payload, extra)
        _finalize_durable(manager.directory, step, extra, tree_spec)
    else:
        manager._pending = (step, extra, tree_spec)

        def run() -> None:
            try:
                _write_step(manager, step, payload, extra)
            except BaseException as e:  # re-raised by wait_until_finished
                manager._error = e

        manager._thread = threading.Thread(target=run, daemon=True,
                                           name="shifu-checkpoint-save")
        manager._thread.start()
    dur = time.perf_counter() - t0
    mode = "blocking" if block else "async"
    obs.counter("checkpoint_saves_total", "checkpoint saves").inc(mode=mode)
    obs.histogram("checkpoint_save_seconds",
                  "checkpoint save latency (async: dispatch only)").observe(
        dur, mode=mode)
    obs.event("checkpoint_save", step=int(step),
              epoch=(extra or {}).get("epoch"), mode=mode,
              dur_s=round(dur, 4))
    # save wall is epoch time not spent stepping (async: the dispatch only)
    obs.goodput.note("checkpoint", dur)


def finalize(manager: CheckpointManager) -> None:
    """Block until any in-flight async save is durable (call before exit)."""
    manager.wait_until_finished()
    _flush_pending_marker(manager)


def latest_step(manager: CheckpointManager) -> Optional[int]:
    return manager.latest_step()


# -- restore ------------------------------------------------------------------

def _check_compatible(directory: str, step: int, target: dict) -> None:
    manifest = read_manifest(directory, step)
    want = manifest.get("state_tree") if manifest else None
    if not want:
        return  # no manifest: restore proceeds on trust

    def norm(spec):
        return [(p, tuple(shape), dt) for p, shape, dt in spec]

    have = _tree_spec(target)
    if norm(want) == norm(have):
        return
    want_map = {p: (shape, dt) for p, shape, dt in norm(want)}
    have_map = {p: (shape, dt) for p, shape, dt in norm(have)}
    for path in sorted(set(want_map) | set(have_map)):
        if want_map.get(path) != have_map.get(path):
            raise CheckpointIncompatibleError(
                f"checkpoint step {step} is incompatible with the restore "
                f"target at {path!r}: saved "
                f"{want_map.get(path, 'nothing')}, target expects "
                f"{have_map.get(path, 'nothing')}")


def _load_into(state, payload: dict) -> None:
    """Apply a loaded payload to `state` in place (tensors keep their
    device and identity, so the optimizer's parameter list stays bound);
    on a mesh each sharded tensor gives this rank's block."""
    payload = _map_sharded(payload, state, lambda sh, t: sh.local(t))
    state.model.load_state_dict(payload["model"], strict=True)
    state.optimizer.load_state_dict(payload["optimizer"])
    state.step = int(payload["step"])
    slots = payload.get("table_slots")
    if state.table_slots is not None and slots is not None:
        with torch.no_grad():
            for name, cur in state.table_slots.items():
                for dst, src in zip(cur, slots[name]):
                    dst.copy_(src)


def restore(manager: CheckpointManager, step: int, state,
            with_extra: bool = False):
    """Restore the state saved at `step` into `state` (built the same way
    as at save time), in place; returns it (and the extra)."""
    t0 = time.perf_counter()
    step_dir = fsio.join(manager.directory, str(int(step)))
    source = fsio.join(step_dir, STATE_FILE)
    if manager.remote:
        source = io.BytesIO(fsio.read_bytes(source))
    payload = torch.load(source, map_location="cpu", weights_only=True)
    extra = None
    if with_extra:
        extra = json.loads(fsio.read_bytes(fsio.join(step_dir, EXTRA_FILE)))
    _load_into(state, payload)
    dur = time.perf_counter() - t0
    obs.counter("checkpoint_restores_total", "checkpoint restores").inc()
    obs.histogram("checkpoint_restore_seconds",
                  "checkpoint restore latency").observe(dur)
    obs.event("checkpoint_restore", step=int(step), dur_s=round(dur, 4))
    # the resume before the first epoch has no ledger open: a no-op
    obs.goodput.note("restore", dur)
    if with_extra:
        return state, extra
    return state


def restore_latest(manager: CheckpointManager, state,
                   with_extra: bool = False):
    """Auto-resume with a recovery ladder: restore the newest step, or,
    when its manifest fails verification or the load itself errors (a
    truncated or unreadable file), the newest earlier step that works.
    Every rung skipped is journaled as `checkpoint_fallback`.  Returns
    None when no checkpoint exists; (state, step) or (state, extra, step)
    otherwise.  An incompatible step re-raises at once; when every step
    fails, the first error is re-raised."""
    steps = sorted(manager.all_steps(), reverse=True)
    if not steps:
        return None
    directory = manager.directory
    target = _full_shaped(state)
    first_err: Optional[Exception] = None
    for i, step in enumerate(steps):
        try:
            # probe before the verify: an injected read failure costs this
            # rung even when the bytes underneath are intact
            chaos.maybe_fail("checkpoint.restore", step=int(step))
            if (os.environ.get("SHIFU_TPU_CKPT_VERIFY", "1") != "0"
                    and verify_manifest(directory, step) is False):
                raise CheckpointCorruptError(
                    f"checkpoint step {step} failed digest verification "
                    f"(manifest-{step}.json)")
            _check_compatible(directory, step, target)
            out = restore(manager, step, state, with_extra=with_extra)
        except CheckpointIncompatibleError:
            raise  # another model: an older rung would silently lose epochs
        except Exception as e:  # noqa: BLE001 - each rung fails its own way
            if first_err is None:
                first_err = e
            obs.counter("checkpoint_fallback_total",
                        "restores that fell back past a bad step").inc(
                reason=type(e).__name__)
            obs.event("checkpoint_fallback", failed_step=int(step),
                      reason=type(e).__name__, error=str(e)[:300],
                      remaining_steps=[int(s) for s in steps[i + 1:]])
            obs.flush()
            continue
        if i > 0:
            obs.event("checkpoint_fallback_resolved", step=int(step),
                      skipped=[int(s) for s in steps[:i]])
        if with_extra:
            st, extra = out
            return st, extra, step
        return out, step
    raise first_err
