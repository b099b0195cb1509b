"""Process-group initialization, the chief, barriers and the collectives
(port of shifu_tpu/parallel/distributed.py on torch.distributed).

The JAX package drives every device of a host from one process and
brings up `jax.distributed` only across hosts.  The port follows torch's
idiom instead: one process (a rank) per device, so a mesh of N devices is
N ranks in one process group, even on one host (ROADMAP.md section C).

Environment contract, as in the JAX package (first match wins): explicit
arguments, else SHIFU_TPU_COORDINATOR + SHIFU_TPU_NUM_PROCESSES +
SHIFU_TPU_PROCESS_ID; without a coordinator `initialize` is a no-op and
the process trains alone.  The coordinator is `host:port` (a TCP store on
that address; rank 0 listens) or a `tcp://` / `file://` init method.

The backend is gloo on the CPU.  On CUDA the placement decides it, before
the group forms: every rank publishes its host name and its card's UUID
through the store at the coordinator, and if any two ranks share a card
the whole group takes gloo (NCCL refuses two ranks of one communicator on
one device; gloo carries every collective used here on CUDA tensors),
else NCCL (an `env://` init method has no store to publish in: NCCL).
No NCCL failure is ever caught and retried on gloo.  `backend_choice()`
says what was chosen and why (the mesh and `dcn_placement` rows journal
it).

A pod (launcher/pod.py) adds SHIFU_TPU_NUM_HOSTS to the contract: the
ranks are then spread over that many hosts, `world / hosts` on each, rank
= host * (world / hosts) + local rank, and each host reads its own slice
of the data (`pod_contract`).  Without it every rank is on one host.  The
JAX package's TPU pod autodetection (TPU_WORKER_HOSTNAMES) has no
counterpart.

The collectives take a group of the mesh (`parallel/mesh.py`) and are
no-ops on `None`, the group of a process that trains alone.  `all_reduce`
with "avg" is NCCL's native average (a pre-multiplied sum; on one rank
NCCL still launches its one-rank reduce kernel, where it elides an
in-place sum) and, on gloo, which has no average, a sum divided by the
group's size.

The collectives with a gradient (`sum_forward`, `gather_grad`,
`all_to_all_grad`, `ppermute`) are the ones XLA inserts for the JAX
package's model-side axes (`model`, `seq`, `pipe`).  Each backward is the
exact transpose of its forward under one convention (train/step.py): the
objective is the SUM over the ranks of their losses, each rank's loss
scaled by 1 / (the number of ranks that see its rows).  So the transpose
of a sum over a group is a sum of the cotangents, that of an all-gather
this rank's slice of the summed cotangent, that of a tiled all-to-all the
inverse all-to-all, and that of a neighbour exchange the exchange the
other way round.

Gloo has no point-to-point transfer of CUDA tensors (its send reads the
device pointer from the host: "Bad address" on the H100 machine), and
ranks that share a card run gloo: there the neighbour exchange is staged
through host memory explicitly, and only there; gloo's all-reduce,
all-gather and all-to-all take CUDA tensors, and NCCL takes every one as
it is.  That is the collective's transport, not a fallback of the compute
(ROADMAP.md section C).
"""

from __future__ import annotations

import logging
import os
from typing import Optional

import torch
import torch.distributed as dist

from ..device import DeviceLike, resolve_device

log = logging.getLogger(__name__)

ENV_COORDINATOR = "SHIFU_TPU_COORDINATOR"
ENV_NUM_PROCESSES = "SHIFU_TPU_NUM_PROCESSES"
ENV_PROCESS_ID = "SHIFU_TPU_PROCESS_ID"
ENV_NUM_HOSTS = "SHIFU_TPU_NUM_HOSTS"

_PLACEMENT_PREFIX = "shifu_placement/"
_choice: dict = {}


def _init_method(coordinator: str) -> str:
    if coordinator.startswith(("tcp://", "file://", "env://")):
        return coordinator
    return f"tcp://{coordinator}"


def _make_store(coordinator: str, world: int, rank: int):
    """The rendezvous store at the coordinator (None for env://, which
    torch reads itself): a TCP store that rank 0 serves, or a file."""
    method = _init_method(coordinator)
    if method.startswith("file://"):
        return dist.FileStore(method[len("file://"):], world)
    if method.startswith("tcp://"):
        host, _, port = method[len("tcp://"):].rpartition(":")
        return dist.TCPStore(host, int(port), world, is_master=rank == 0)
    return None


def card_identity(dev: torch.device) -> str:
    """(this host, this card) as one string: the host name and the card's
    UUID (its index where the UUID is not exposed)."""
    props = torch.cuda.get_device_properties(dev)
    card = getattr(props, "uuid", None)
    return f"{os.uname().nodename}|{card if card is not None else dev}"


def placement_backend(store, world: int, rank: int, me: str) -> tuple:
    """("gloo" | "nccl", ranks per card): each rank publishes `me` under
    its rank in `store` and reads every rank's; gloo as soon as two ranks
    share a card."""
    store.set(f"{_PLACEMENT_PREFIX}{rank}", me)
    seen = [store.get(f"{_PLACEMENT_PREFIX}{r}").decode()
            for r in range(world)]
    most = max(seen.count(c) for c in seen)
    return ("gloo" if most > 1 else "nccl"), most


def backend_choice() -> dict:
    """{"backend", "reason", "ranks_per_card"} of the group this process
    joined ({} alone)."""
    return dict(_choice)


def pod_contract() -> Optional[tuple[int, int]]:
    """(host index, number of hosts) when this process is a rank of a pod
    (SHIFU_TPU_NUM_HOSTS in the contract), else None."""
    hosts = int(os.environ.get(ENV_NUM_HOSTS, "0") or 0)
    if hosts < 1 or not os.environ.get(ENV_COORDINATOR):
        return None
    world = int(os.environ.get(ENV_NUM_PROCESSES, "1"))
    rank = int(os.environ.get(ENV_PROCESS_ID, "0"))
    return rank // max(world // hosts, 1), hosts


def initialize(coordinator: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               device: DeviceLike = None) -> bool:
    """Join the process group; True when one is (now) up.

    Safe to call unconditionally: without a coordinator (argument or
    environment) it does nothing and returns False.  Idempotent.  The
    backend is gloo on the CPU and, for a CUDA `device` (default
    `cuda:0`), what the placement allows (module docstring); a CUDA rank
    is bound to its device first."""
    if dist.is_initialized():
        return True
    coordinator = coordinator or os.environ.get(ENV_COORDINATOR)
    if not coordinator:
        return False
    if num_processes is None:
        num_processes = int(os.environ.get(ENV_NUM_PROCESSES, "1"))
    if process_id is None:
        process_id = int(os.environ.get(ENV_PROCESS_ID, "0"))
    dev = resolve_device(device)
    world, rank = int(num_processes), int(process_id)
    store = _make_store(coordinator, world, rank)
    per_card = None
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if dev.type != "cuda":
        backend, reason = "gloo", "cpu"
    elif store is None:
        backend, reason = "nccl", "cuda"
    else:
        backend, per_card = placement_backend(store, world, rank,
                                              card_identity(dev))
        reason = ("ranks share a card" if per_card > 1
                  else "one rank per card")
    kwargs = {"device_id": dev} if backend == "nccl" else {}
    if store is None:
        kwargs["init_method"] = _init_method(coordinator)
    else:
        kwargs["store"] = store
    dist.init_process_group(backend, world_size=world, rank=rank, **kwargs)
    _choice.clear()
    _choice.update(backend=backend, reason=reason, ranks_per_card=per_card)
    log.info("torch.distributed initialized: rank %d/%d via %s (%s: %s)",
             dist.get_rank(), dist.get_world_size(), coordinator, backend,
             reason)
    return True


def shutdown() -> None:
    """Leave the process group (a no-op when none is up)."""
    if dist.is_initialized():
        dist.destroy_process_group()
    _choice.clear()


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_chief() -> bool:
    """The rank that writes the journal, the board, checkpoints and the
    artifact (the reference's chief worker, worker:0)."""
    return process_index() == 0


def barrier(name: str = "barrier") -> None:
    """Wait for every rank; a no-op alone."""
    if process_count() == 1:
        return
    log.debug("barrier %s", name)
    dist.barrier()


def all_reduce(t: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """In-place "sum", "max", "min" or "avg" of `t` over `group`; returns
    `t`."""
    if group is None:
        return t
    if op in ("max", "min"):
        dist.all_reduce(t, op=getattr(dist.ReduceOp, op.upper()),
                        group=group)
    elif op == "avg" and dist.get_backend(group) == "nccl":
        dist.all_reduce(t, op=dist.ReduceOp.AVG, group=group)
    elif op in ("sum", "avg"):
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
        if op == "avg":
            t.div_(dist.get_world_size(group))
    else:
        raise ValueError(f"all_reduce: unknown op {op!r}")
    return t


def all_gather(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The group's tensors concatenated along `dim`, in rank order of the
    group; `t` itself alone."""
    if group is None:
        return t
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def _group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _global_rank(group, i: int) -> int:
    return dist.get_global_rank(group, i)


def _host_staged(t: torch.Tensor, group) -> bool:
    """True where a point-to-point exchange of `t` goes through host
    memory: a CUDA tensor on a gloo group (module docstring)."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


class _SumForward(torch.autograd.Function):
    """Sum over a group; the backward sums the cotangents over the group
    (the transpose of a sum, module docstring)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x.clone(), group, "sum")

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.group, "sum"), None


def sum_forward(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable all-reduce sum (JAX's psum): the reduction of the
    partial results the ranks of the group computed."""
    if _group_size(group) == 1:
        return x
    return _SumForward.apply(x, group)


class _GatherGrad(torch.autograd.Function):
    """All-gather along `dim`; the backward is this rank's slice of the
    cotangent summed over the group.  The sum is an all-reduce (gloo has
    no reduce-scatter of CUDA tensors), then the slice."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.n = group, dim, x.shape[dim]
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        total = all_reduce(g.contiguous().clone(), ctx.group, "sum")
        i = dist.get_rank(ctx.group)
        return total.narrow(ctx.dim, i * ctx.n, ctx.n).contiguous(), None, \
            None


def gather_grad(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Differentiable all-gather of the group's blocks along `dim`, in
    rank order of the group (JAX's all_gather(tiled=True))."""
    if _group_size(group) == 1:
        return x
    return _GatherGrad.apply(x, group, dim)


def all_to_all(x: torch.Tensor, group, split_dim: int,
               concat_dim: int) -> torch.Tensor:
    """JAX's all_to_all(split_axis, concat_axis, tiled=True): `x` cut in
    n blocks along `split_dim`, block j sent to rank j of the group, the
    n blocks received concatenated along `concat_dim` in rank order."""
    n = _group_size(group)
    if n == 1:
        return x
    if x.shape[split_dim] % n:
        raise ValueError(f"all_to_all: dimension {split_dim} of size "
                         f"{x.shape[split_dim]} does not split into {n}")
    send = torch.stack(x.chunk(n, dim=split_dim)).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return torch.cat(list(recv.unbind(0)), dim=concat_dim)


class _AllToAll(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group, split_dim, concat_dim):
        ctx.args = (group, split_dim, concat_dim)
        return all_to_all(x, group, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        group, split_dim, concat_dim = ctx.args
        return (all_to_all(g.contiguous(), group, concat_dim, split_dim),
                None, None, None)


def all_to_all_grad(x: torch.Tensor, group, split_dim: int,
                    concat_dim: int) -> torch.Tensor:
    """Differentiable tiled all-to-all; its backward is the inverse
    all-to-all (split and concat dimensions swapped)."""
    if _group_size(group) == 1:
        return x
    return _AllToAll.apply(x, group, split_dim, concat_dim)


def exchange(x: torch.Tensor, group, shift: int, ring: bool
             ) -> torch.Tensor:
    """Send `x` to the rank `shift` places on in the group and return what
    the rank `shift` places back sent (JAX's ppermute).  `ring`: the
    permutation j -> j + shift mod n; else the open chain, where a rank
    with no peer to send to sends nothing and one with none to receive
    from gets zeros.  One batch of isend/irecv (NCCL pairs them; gloo
    stages CUDA tensors through host memory)."""
    n = _group_size(group)
    i = dist.get_rank(group)
    dst, src = i + shift, i - shift
    if ring:
        dst, src = dst % n, src % n
    staged = _host_staged(x, group)
    send = (x.cpu() if staged else x).contiguous()
    recv = torch.zeros_like(send)
    ops = []
    if 0 <= dst < n:
        ops.append(dist.P2POp(dist.isend, send, _global_rank(group, dst),
                              group))
    if 0 <= src < n:
        ops.append(dist.P2POp(dist.irecv, recv, _global_rank(group, src),
                              group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return recv.to(x.device) if staged else recv


class _Exchange(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group, shift, ring):
        ctx.args = (group, shift, ring)
        return exchange(x, group, shift, ring)

    @staticmethod
    def backward(ctx, g):
        group, shift, ring = ctx.args
        return exchange(g.contiguous(), group, -shift, ring), None, None, \
            None


def ppermute(x: torch.Tensor, group, shift: int = 1,
             ring: bool = True) -> torch.Tensor:
    """Differentiable neighbour exchange (`exchange`); the backward sends
    the cotangent the other way.  Every rank of the group must call it,
    in the same order."""
    if _group_size(group) == 1:
        return x if ring else torch.zeros_like(x)
    return _Exchange.apply(x, group, shift, ring)


class _Attach(torch.autograd.Function):
    """`x` itself; `dep` rides along with a zero cotangent.  Keeps an
    exchange whose result a rank does not use in that rank's backward
    graph, so every rank runs every exchange's transpose in the same
    order (parallel/pipeline.py)."""

    @staticmethod
    def forward(ctx, x, dep):
        ctx.dep = (dep.shape, dep.dtype, dep.device)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        shape, dtype, device = ctx.dep
        return g, torch.zeros(shape, dtype=dtype, device=device)


def attach(x: torch.Tensor, dep: torch.Tensor) -> torch.Tensor:
    return _Attach.apply(x, dep)
