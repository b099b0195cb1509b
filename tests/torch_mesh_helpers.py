"""Gloo process groups for the port's mesh tests, and the work their ranks
run.

`run_ranks(fn, world, tmp_path, *args)` spawns `world` processes with
torch.multiprocessing's spawn context; each joins a gloo group through a
`file://` store in `tmp_path` (no TCP port to race for between test
workers), sets one intra-op thread, calls `fn(rank, world, *args)` and
sends back its picklable result.  The group has its own deadline: a rank
that hangs fails the test and every child is killed.  The rank functions
live here, importing torch and the port only, so a child starts without
JAX.
"""

from __future__ import annotations

import dataclasses
import queue as queue_lib
import time
import traceback

import numpy as np
import torch
import torch.multiprocessing as mp

GROUP_TIMEOUT_S = 120.0


def _entry(fn, rank, world, store, args, out):
    torch.set_num_threads(1)
    from shifu_tpu_torch.parallel import distributed
    try:
        distributed.initialize(coordinator=f"file://{store}",
                               num_processes=world, process_id=rank,
                               device="cpu")
        out.put((rank, True, fn(rank, world, *args)))
    except BaseException:  # noqa: BLE001 - reported to the parent
        out.put((rank, False, traceback.format_exc()))
    finally:
        distributed.shutdown()


def run_ranks(fn, world: int, tmp_path, *args,
              timeout: float = GROUP_TIMEOUT_S) -> list:
    """[fn(r, world, *args) for each rank r], run in `world` gloo ranks."""
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    store = tmp_path / f"store-{time.monotonic_ns()}"
    procs = [ctx.Process(target=_entry,
                         args=(fn, r, world, str(store), args, out),
                         daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    results: dict = {}
    deadline = time.monotonic() + timeout
    try:
        while len(results) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"{world} ranks gave {len(results)} "
                                   f"results in {timeout} s")
            try:
                rank, ok, value = out.get(timeout=min(left, 1.0))
            except queue_lib.Empty:
                if any(p.exitcode not in (None, 0) for p in procs):
                    dead = [p.exitcode for p in procs]
                    raise RuntimeError(f"a rank died: exit codes {dead}")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            results[rank] = value
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5)
    return [results[r] for r in range(world)]


# -- rank work -----------------------------------------------------------------

def state_arrays(state) -> dict:
    """A TrainState's parameters, optimizer state and slots as numpy."""
    out = {f"param/{k}": v.detach().float().numpy().copy()
           for k, v in state.model.state_dict().items()}

    def walk(obj, path):
        if isinstance(obj, torch.Tensor):
            out[path] = obj.detach().float().numpy().copy()
        elif isinstance(obj, dict):
            for k, v in obj.items():
                walk(v, f"{path}/{k}")
        elif isinstance(obj, (list, tuple)):
            for i, v in enumerate(obj):
                walk(v, f"{path}/{i}")
    walk(state.optimizer.state_dict(), "opt")
    if state.table_slots:
        walk(state.table_slots, "slots")
    return out


def carry(state, flat: dict, job) -> None:
    """Load full (JAX-named, numpy) parameters onto a state:
    `params_from_jax` gives the full state, `place_params` this rank's
    blocks of the sharded ones."""
    import re

    from shifu_tpu_torch.export.artifact import params_from_jax
    from shifu_tpu_torch.models.registry import build_model
    from shifu_tpu_torch.parallel.sharding import place_params

    full = params_from_jax(flat, build_model(job.model, job.schema, "cpu"))
    if state.mesh is not None:
        rules = [(re.escape(k) + "$", sh.spec)
                 for k, sh in state.shardings.items()]
        full = place_params(full, state.mesh, rules)
    state.model.load_state_dict(full)


def to_batch(host: dict, job) -> dict:
    from shifu_tpu_torch.train import loop
    return loop.to_device({k: np.asarray(v) for k, v in host.items()}, job,
                          torch.device("cpu"))


def _mesh(mesh_cfg):
    from shifu_tpu_torch.parallel import make_mesh
    return make_mesh(mesh_cfg)


def full_params(state, rank: int):
    """The whole parameters (numpy, by name) gathered from the mesh's
    blocks (a collective: every rank calls it); on rank 0 only."""
    from shifu_tpu_torch.train import checkpoint as ckpt_lib

    full = ckpt_lib.full_payload(state)["model"]
    if rank != 0:
        return None
    return {k: v.detach().float().numpy().copy() for k, v in full.items()}


def dp_cases(rank, world, mesh_cfg, cases) -> list:
    """For each (job, flat params or None, host batches): the train
    steps on the mesh from those params; the losses, this rank's state
    and (on rank 0) the gathered parameters."""
    from shifu_tpu_torch.train import loop, step

    mesh = _mesh(mesh_cfg)
    out = []
    for job, flat, batches in cases:
        state = loop.init_state(job, job.schema.feature_count, "cpu",
                                mesh=mesh)
        if flat is not None:
            carry(state, flat, job)
        train_step = step.make_train_step(job, mesh)
        losses = []
        for b in batches:
            state, m = train_step(state, to_batch(b, job))
            losses.append(float(m["loss"]))
        out.append({"losses": losses, "state": state_arrays(state),
                    "coords": dict(mesh.coords),
                    "specs": {k: sh.spec for k, sh in state.shardings.items()},
                    "full": full_params(state, rank)})
    return out


def regroup(rank: int, world: int, store: str) -> bool:
    """Leave the process group and form one of the first `world` ranks
    (a `file://` store at `store`); True on the ranks that go on."""
    from shifu_tpu_torch.parallel import distributed

    distributed.shutdown()
    if rank >= world:
        return False
    distributed.initialize(coordinator=f"file://{store}",
                           num_processes=world, process_id=rank,
                           device="cpu")
    return True


def sequence(rank, world, store_base: str, steps) -> list:
    """Run `steps`, (ranks, fn, args) each, in order on one spawn of the
    largest world: before a step on fewer ranks the group is re-formed
    over the first of them (`regroup`) and the others stop.  The results
    of the steps this rank took part in."""
    out = []
    cur = world
    for i, (n, fn, args) in enumerate(steps):
        if n != cur:
            if not regroup(rank, n, f"{store_base}-{i}"):
                break
            cur = n
        out.append(fn(rank, n, *args))
    return out


def forward_cases(rank, world, mesh_cfg, cases) -> list:
    """For each (job, flat params, (B, F) features): the eval forward on
    the mesh of this rank's data rows (logits) and its coordinates."""
    from shifu_tpu_torch.parallel.sharding import model_forward, shard_batch
    from shifu_tpu_torch.train import loop

    mesh = _mesh(mesh_cfg)
    out = []
    for job, flat, feats in cases:
        state = loop.init_state(job, job.schema.feature_count, "cpu",
                                mesh=mesh)
        carry(state, flat, job)
        state.model.eval()
        local = shard_batch({"features": torch.tensor(feats)}, mesh)
        with torch.no_grad():
            logits = model_forward(state.model, local["features"])
        out.append({"logits": logits.numpy(), "coords": dict(mesh.coords)})
    return out


def seq_attention_checks(rank, world, mesh_cfg, q, k, v, impls,
                         dtype: str = "float32") -> dict:
    """Each of `impls` ("ring", "ulysses") on this rank's sequence blocks
    of the whole (B, H, S, D) q, k, v (every data coordinate holds the
    same rows): the output gathered over `seq`, and the gradients of this
    rank's blocks for sum(out ** 2), each rank's share 1 / n_seq (the
    step's convention)."""
    from shifu_tpu_torch.ops.attention import ring_attention, \
        ulysses_attention
    from shifu_tpu_torch.parallel.distributed import gather_grad
    from shifu_tpu_torch.parallel.mesh import SEQ_AXIS

    mesh = _mesh(mesh_cfg)
    n = mesh.axis_size(SEQ_AXIS)
    blk = q.shape[2] // n
    lo = mesh.axis_index(SEQ_AXIS) * blk
    out = {"seq": mesh.axis_index(SEQ_AXIS), "n": n}
    for impl in impls:
        fn = ring_attention if impl == "ring" else ulysses_attention
        ts = [torch.tensor(t[:, :, lo:lo + blk]).to(getattr(torch, dtype))
              .requires_grad_(True) for t in (q, k, v)]
        try:
            local = fn(*ts, mesh)
        except ValueError as e:
            out[impl] = {"error": str(e)}
            continue
        whole = gather_grad(local, mesh.group(SEQ_AXIS), 2)
        (torch.sum(torch.square(whole.float())) / n).backward()
        out[impl] = {"out": whole.detach().float().numpy(),
                     "grads": [t.grad.float().numpy() for t in ts]}
    return out


def pipeline_checks(rank, world, mesh_cfg, params, x) -> dict:
    """The toy stage (h <- tanh(h @ W) over the stage's stacked W) through
    `pipeline_apply` on the mesh: this data coordinate's rows of x
    (n_micro, mb, d), the stage's layers of params (L, d, d); the output,
    and the gradient of the stage's layers for sum(out ** 2) (each pipe
    rank's share 1 / n_pipe)."""
    from shifu_tpu_torch.parallel.mesh import DATA_AXIS, PIPE_AXIS
    from shifu_tpu_torch.parallel.pipeline import pipeline_apply

    mesh = _mesh(mesh_cfg)
    n_pipe, n_data = mesh.axis_size(PIPE_AXIS), mesh.axis_size(DATA_AXIS)
    lps = params.shape[0] // n_pipe
    s, d = mesh.axis_index(PIPE_AXIS), mesh.axis_index(DATA_AXIS)
    w = torch.tensor(params[s * lps:(s + 1) * lps]).requires_grad_(True)
    mb = x.shape[1] // n_data
    xs = torch.tensor(x[:, d * mb:(d + 1) * mb])

    def stage_fn(p, h):
        for i in range(p["w"].shape[0]):
            h = torch.tanh(h @ p["w"][i])
        return h

    y = pipeline_apply(stage_fn, {"w": w}, xs, mesh)
    (torch.sum(torch.square(y)) / n_pipe).backward()
    return {"out": y.detach().numpy(), "grad": w.grad.numpy(),
            "coords": dict(mesh.coords)}


def epoch_cases(rank, world, mesh_cfg, cases) -> list:
    """For each (job, flat params, host (nb, B, ...) blocks, local SGD?):
    one call of the staged tier's step (local SGD's or the synchronous
    one) on the mesh; the loss sum and this rank's state."""
    from shifu_tpu_torch.train import loop, step

    mesh = _mesh(mesh_cfg)
    out = []
    for job, flat, blocks, local in cases:
        state = loop.init_state(job, job.schema.feature_count, "cpu",
                                mesh=mesh)
        carry(state, flat, job)
        fn = (step.make_local_sgd_epoch_step(job, mesh) if local
              else step.make_epoch_scan_step(job, mesh))
        state, acc = fn(state, to_batch(blocks, job))
        out.append({"loss_sum": float(acc), "state": state_arrays(state),
                    "step": state.step, "coords": dict(mesh.coords),
                    "specs": {k: sh.spec for k, sh in state.shardings.items()},
                    "full": full_params(state, rank)})
    return out


def train_runs(rank, world, mesh_cfg, runs) -> list:
    """For each (job, train arrays, valid arrays): `loop.train` on the
    mesh; its history, resumed epoch and this rank's state."""
    from shifu_tpu_torch.data.pipeline import TabularDataset
    from shifu_tpu_torch.train import loop

    mesh = _mesh(mesh_cfg)
    out = []
    for job, tr, va in runs:
        res = loop.train(job, TabularDataset(*tr), TabularDataset(*va),
                         console=lambda s: None, device="cpu", mesh=mesh)
        out.append({"history": [dataclasses.asdict(m) for m in res.history],
                    "resumed": res.resumed_from_epoch, "tier": res.tier,
                    "state": state_arrays(res.state),
                    "coords": dict(mesh.coords)})
    return out


def lookup_checks(rank, world, mesh_cfg, table, ids, weight) -> dict:
    """The vocab-sharded lookup of `ids` from this rank's slice of
    `table`, and the gradient of sum(out * weight) (finite rows) on the
    slice, each model rank's share of that sum 1 / shards (the step's
    convention: the transpose of the slices' sum is a sum)."""
    from shifu_tpu_torch.embed.shard import (VOCAB_SHARD_SPEC,
                                             assert_vocab_sharded)
    from shifu_tpu_torch.models.embedding import VocabShard, sharded_lookup
    from shifu_tpu_torch.parallel.mesh import MODEL_AXIS
    from shifu_tpu_torch.parallel.sharding import Sharding

    mesh = _mesh(mesh_cfg)
    shards = mesh.axis_size(MODEL_AXIS)
    vocab = table.shape[1]
    local = Sharding(mesh, VOCAB_SHARD_SPEC).local(
        torch.tensor(table)).clone().requires_grad_(True)
    assert_vocab_sharded(local, shards, vocab)
    rows = vocab // shards
    shard = VocabShard(mesh.axis_index(MODEL_AXIS) * rows, rows, vocab,
                       mesh.group(MODEL_AXIS))
    out = sharded_lookup(local, torch.tensor(ids), shard)
    w = torch.tensor(weight)
    (torch.where(torch.isfinite(out), out * w, 0.0).sum()
     / shards).backward()
    return {"out": out.detach().numpy(), "grad": local.grad.numpy(),
            "model": mesh.axis_index(MODEL_AXIS)}


def update_checks(rank, world, mesh_cfg, table, dense_g, ids, lr) -> dict:
    """The shard-local rows update (sgd and adadelta) of this rank's
    slices; the updated slices by rule."""
    from shifu_tpu_torch.embed.shard import (VOCAB_SHARD_SPEC,
                                             make_sharded_rows_update)
    from shifu_tpu_torch.parallel.mesh import MODEL_AXIS
    from shifu_tpu_torch.parallel.sharding import Sharding

    mesh = _mesh(mesh_cfg)
    sh = Sharding(mesh, VOCAB_SHARD_SPEC)
    nc, vocab, _ = table.shape
    out = {"model": mesh.axis_index(MODEL_AXIS)}
    for rule in ("sgd", "adadelta"):
        t = sh.local(torch.tensor(table)).contiguous().clone()
        g = sh.local(torch.tensor(dense_g)).contiguous()
        slots = (tuple(torch.zeros_like(t) for _ in range(2))
                 if rule == "adadelta" else ())
        update = make_sharded_rows_update(
            mesh, nc=nc, vocab=vocab, shards=mesh.axis_size(MODEL_AXIS),
            rule=rule)
        update(t, slots, g, torch.tensor(ids), lr, unique=True)
        out[rule] = (t.numpy(), [s.numpy() for s in slots])
    return out
