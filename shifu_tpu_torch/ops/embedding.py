"""Stacked-table embedding lookup and the fused rows-touched update.

Port of shifu_tpu/ops/pallas_embedding.py.  Two kernels:

- `embedding_lookup(table, ids)`: `out[b, f, :] = table[f, ids[b, f], :]`.
  On a CUDA tensor it launches `csrc/embedding_lookup.cu` (the TPU kernel
  `_pallas_lookup`); on a CPU tensor it runs `lookup_reference`, the
  semantics of the JAX package's `_xla_lookup`: ids in [-V, 0) wrap, ids
  outside [-V, V) give a NaN row.  The gradient is the JAX package's
  `_scatter_grad`: the rows are scatter-added in f32 (wrapped ids land on
  their row, ids outside [-V, V) drop) and the sum is rounded once to the
  table's dtype.  It is plain PyTorch on either device, as the JAX
  backward is XLA; on the card `index_add_` adds in f32 atomics, in no
  fixed order.
- `fused_rows_update(table, slots, g_rows, ids, rule, lr, unique=False)`:
  the SGD or Adadelta update of the touched rows of a table (and of its
  two f32 Adadelta slots), in place.  On CUDA tensors it launches
  `csrc/rows_update.cu` (the TPU kernel `_pallas_rows_update`) once; on
  CPU tensors it runs `rows_update_plain`, the same math in plain PyTorch
  (`rows_update_reference` is its functional form).  Only ids in [0, V)
  are updated; the dedup sentinel V pads a batch of unique ids to a fixed
  size.  `unique=True` says the in-range ids of each field are unique, the
  TPU kernel's own contract.  Unlike the TPU kernel it also takes
  duplicate in-range ids (`unique=False`, the default): every duplicate
  carries the same gradient row, so one of them, elected through a
  per-row stamp the wrapper keeps, updates the row.

The lookup is the operator `shifu_tpu_torch::embedding_lookup`: the
dispatcher picks its implementation from the device at run time (a
`torch.export` program holds the operator).  There is no fallback from a
kernel to its plain version: a CUDA call the kernel cannot take raises.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Sequence

import torch

from ..obs import flops as flops_lib
from . import _build

# TF 1.4 Adadelta constants (train/optimizers.py uses the same)
ADADELTA_RHO = 0.95
ADADELTA_EPS = 1e-8

RULES = ("sgd", "adadelta")

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_count_lock = threading.Lock()


def lookup_cost(b: int, nc: int, d: int, dtype) -> tuple:
    """(flops, bytes, exponentials) of the lookup of (B, Nc) ids: each
    gathered row read and written once, the ids read as int32; no
    operations."""
    elt = torch.empty((), dtype=dtype).element_size()
    return 0.0, float(2 * b * nc * d * elt + b * nc * 4), 0.0


def rows_update_cost(u: int, nc: int, d: int, dtype, touched: int,
                     rule: str = "adadelta") -> tuple:
    """(flops, bytes, exponentials) of the rows-touched update of (U, Nc)
    ids, `touched` of them in range: a touched row's table entry read and
    written, its f32 gradient row read, and under adadelta its two f32
    slots read and written (7 x D x 4 bytes for an f32 table); the ids
    read as int32.  The count follows this call's ids, not the most they
    could touch."""
    elt = torch.empty((), dtype=dtype).element_size()
    per_row = d * (2 * elt + 4 + (16 if rule == "adadelta" else 0))
    return 0.0, float(touched * per_row + u * nc * 4), 0.0


def _check_device(name: str, t: torch.Tensor) -> None:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {t.device}")


def _wrap(ids: torch.Tensor, vocab: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(ids with [-V, 0) wrapped, mask of the ids that then lie in [0, V))."""
    ids = ids.long()
    wrapped = torch.where(ids < 0, ids + vocab, ids)
    return wrapped, (wrapped >= 0) & (wrapped < vocab)


# -- kernel #5: the lookup ----------------------------------------------------

def lookup_reference(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """(Nc, V, D) table, (B, Nc) ids -> (B, Nc, D) in the table's dtype,
    with `_xla_lookup`'s out-of-range semantics.  The kernel's plain twin."""
    nc, v, _ = table.shape
    wrapped, valid = _wrap(ids, v)
    fields = torch.arange(nc, device=ids.device)[None, :]
    out = table[fields, torch.where(valid, wrapped, 0)]
    return out.masked_fill(~valid[..., None], float("nan"))


def _lookup_lib() -> ctypes.CDLL:
    lib = _build.load("embedding_lookup")
    if not getattr(lib, "_shifu_typed", False):
        lib.embedding_lookup_fwd.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                     ctypes.c_longlong, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_void_p])
        lib.embedding_lookup_fwd.restype = ctypes.c_int
        lib.embedding_lookup_error_string.argtypes = [ctypes.c_int]
        lib.embedding_lookup_error_string.restype = ctypes.c_char_p
        lib._shifu_typed = True
    return lib


def _launch_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    if table.dim() != 3 or table.dtype not in _DTYPE_CODES:
        raise ValueError(f"embedding_lookup: table must be (Nc, V, D) f32, "
                         f"bf16 or f16; got {tuple(table.shape)} "
                         f"{table.dtype}")
    nc, v, d = table.shape
    if ids.dim() != 2 or ids.shape[1] != nc or ids.device != table.device:
        raise ValueError(f"embedding_lookup: ids must be (B, {nc}) on "
                         f"{table.device}; got {tuple(ids.shape)} on "
                         f"{ids.device}")
    if not table.is_contiguous():
        raise ValueError("embedding_lookup: the table must be contiguous")
    ids = ids.to(torch.int32).contiguous()
    b = ids.shape[0]
    out = torch.empty((b, nc, d), dtype=table.dtype, device=table.device)
    if out.numel() == 0:
        return out
    lib = _lookup_lib()
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        rc = lib.embedding_lookup_fwd(table.data_ptr(), ids.data_ptr(),
                                      out.data_ptr(), b, nc, v, d,
                                      _DTYPE_CODES[table.dtype], stream)
    if rc != 0:
        msg = lib.embedding_lookup_error_string(rc).decode()
        raise RuntimeError(f"embedding_lookup kernel launch failed: {msg} "
                           f"(B={b} Nc={nc} V={v} D={d} {table.dtype})")
    with _count_lock:
        embedding_lookup.launches += 1
    return out


@torch.library.custom_op("shifu_tpu_torch::embedding_lookup",
                         mutates_args=(), device_types="cpu")
def lookup_op(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """The lookup as an operator: the dispatcher picks this CPU
    implementation (`lookup_reference`) or the CUDA one (the kernel) from
    the tensors' device at run time."""
    return lookup_reference(table, ids)


@lookup_op.register_kernel("cuda")
def _lookup_cuda(table, ids):
    return _launch_lookup(table, ids)


@lookup_op.register_fake
def _lookup_fake(table, ids):
    return table.new_empty((ids.shape[0], table.shape[0], table.shape[-1]))


def _lookup_setup(ctx, inputs, output):
    table, ids = inputs
    ctx.save_for_backward(ids)
    ctx.table_shape, ctx.table_dtype = tuple(table.shape), table.dtype


def _lookup_grad(ctx, g):
    (ids,) = ctx.saved_tensors
    return scatter_grad(ids, ctx.table_shape, g).to(ctx.table_dtype), None


lookup_op.register_autograd(_lookup_grad, setup_context=_lookup_setup)


def _lookup_forward(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    _check_device("embedding_lookup", table)
    with flops_lib.kernel(lambda: lookup_cost(ids.shape[0], table.shape[0],
                                              table.shape[-1], table.dtype)):
        return lookup_op(table, ids)


def scatter_grad(ids: torch.Tensor, table_shape: Sequence[int],
                 g: torch.Tensor) -> torch.Tensor:
    """The lookup's gradient, (Nc, V, D) f32: g[b, f] added at row
    ids[b, f] of field f; wrapped ids land on their row, ids outside
    [-V, V) drop (the JAX package's `_scatter_grad`)."""
    nc, v, d = table_shape
    wrapped, valid = _wrap(ids, v)
    fields = torch.arange(nc, device=ids.device)[None, :]
    # invalid ids go to one spare row past the table, dropped after the sum
    flat = torch.where(valid, fields * v + wrapped, nc * v).reshape(-1)
    grad = torch.zeros((nc * v + 1, d), dtype=torch.float32, device=g.device)
    grad.index_add_(0, flat, g.reshape(-1, d).float())
    return grad[:nc * v].reshape(nc, v, d)


def embedding_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """out[b, f, :] = table[f, ids[b, f], :] for a (Nc, V, D) table and
    (B, Nc) integer ids; differentiable in the table (module docstring).
    CUDA tensors launch the kernel (counted in `embedding_lookup.launches`);
    CPU tensors run `lookup_reference`."""
    return _lookup_forward(table, ids)


embedding_lookup.launches = 0


# -- kernel #6: the rows-touched update ---------------------------------------

def fused_update_available(dim: int) -> bool:
    """Where the rows-touched update can run: any embedding dim, on the card
    through the kernel and on the CPU through its plain version.  (The JAX
    package's kernel needs D % 128 == 0 on a TPU.)"""
    return dim >= 1


def _check_rule(rule: str) -> None:
    if rule not in RULES:
        raise ValueError(f"fused_rows_update: unknown rule {rule!r}")


def rows_update_plain(table: torch.Tensor, slots: tuple,
                      g_rows: torch.Tensor, ids: torch.Tensor, rule: str,
                      lr: float) -> None:
    """The kernel's update in place in plain PyTorch, one field at a time,
    in the JAX reference's order of f32 operations; rows stored in
    table.dtype.  The kernel's plain twin."""
    nc, v, _ = table.shape
    lr = float(lr)
    for f in range(nc):
        keep = (ids[:, f] >= 0) & (ids[:, f] < v)
        i_f = ids[keep, f].long()
        g = g_rows[keep, f].float()
        p = table[f, i_f].float()
        if rule == "sgd":
            table[f].index_put_((i_f,), (p - lr * g).to(table.dtype))
            continue
        accu, delta = slots
        a = accu[f, i_f]
        d = delta[f, i_f]
        new_a = ADADELTA_RHO * a + (1.0 - ADADELTA_RHO) * g * g
        upd = g * torch.sqrt(d + ADADELTA_EPS) / torch.sqrt(new_a
                                                            + ADADELTA_EPS)
        new_d = ADADELTA_RHO * d + (1.0 - ADADELTA_RHO) * upd * upd
        table[f].index_put_((i_f,), (p - lr * upd).to(table.dtype))
        accu[f].index_put_((i_f,), new_a)
        delta[f].index_put_((i_f,), new_d)


def rows_update_reference(table: torch.Tensor, slots: tuple,
                          g_rows: torch.Tensor, ids: torch.Tensor, rule: str,
                          lr: float) -> tuple[torch.Tensor, tuple]:
    """Functional form of the update (the JAX package's
    `rows_update_reference`): table (Nc, V, D), slots () for sgd or
    (accu, delta) f32 for adadelta, g_rows (U, Nc, D), ids (U, Nc).
    Returns (new_table, new_slots); the inputs are left as they were."""
    _check_rule(rule)
    table = table.detach().clone()
    slots = tuple(s.detach().clone() for s in slots)
    with torch.no_grad():
        rows_update_plain(table, slots, g_rows, ids, rule, lr)
    return table, slots


def _rows_lib() -> ctypes.CDLL:
    lib = _build.load("rows_update")
    if not getattr(lib, "_shifu_typed", False):
        lib.rows_update.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_longlong,
                                     ctypes.c_int, ctypes.c_longlong,
                                     ctypes.c_int, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_float,
                                     ctypes.c_void_p])
        lib.rows_update.restype = ctypes.c_int
        lib.rows_update_error_string.argtypes = [ctypes.c_int]
        lib.rows_update_error_string.restype = ctypes.c_char_p
        lib._shifu_typed = True
    return lib


# (device index, stream, Nc * V) -> [int32 stamp of Nc * V, last call]:
# a raw-id launch elects one entry per touched row by an atomicMax of its
# call number on the row's stamp (csrc/rows_update.cu).  The call numbers
# of one stamp grow strictly in the order of the launches on its stream:
# _launch_lock is held from taking a number to the launch.  Before the
# number would pass INT32_MAX the stamp is zeroed on that stream and the
# count starts again.
_stamps: dict = {}
_STAMP_MAX_CALL = 2 ** 31 - 1
_launch_lock = threading.Lock()


def _next_stamp(dev: torch.device, stream: int,
                rows: int) -> tuple[torch.Tensor, int]:
    """The stamp and the next call number; under _launch_lock."""
    key = (dev.index, stream, rows)
    entry = _stamps.get(key)
    if entry is None:
        entry = _stamps[key] = [torch.zeros(rows, dtype=torch.int32,
                                            device=dev), 0]
    if entry[1] == _STAMP_MAX_CALL:
        entry[0].zero_()
        entry[1] = 0
    entry[1] += 1
    return entry[0], entry[1]


def _launch_rows_update(table: torch.Tensor, slots: tuple,
                        g_rows: torch.Tensor, ids: torch.Tensor, rule: str,
                        lr: float, unique: bool) -> None:
    if table.dim() != 3 or table.dtype not in _DTYPE_CODES:
        raise ValueError(f"fused_rows_update: table must be (Nc, V, D) f32, "
                         f"bf16 or f16; got {tuple(table.shape)} "
                         f"{table.dtype}")
    nc, v, d = table.shape
    u = ids.shape[0]
    dev = table.device
    if ids.dim() != 2 or ids.shape[1] != nc or ids.device != dev:
        raise ValueError(f"fused_rows_update: ids must be (U, {nc}) on "
                         f"{dev}; got {tuple(ids.shape)} on {ids.device}")
    if (tuple(g_rows.shape) != (u, nc, d) or g_rows.dtype != torch.float32
            or g_rows.device != dev):
        raise ValueError(f"fused_rows_update: g_rows must be ({u}, {nc}, "
                         f"{d}) f32 on {dev}; got {tuple(g_rows.shape)} "
                         f"{g_rows.dtype} on {g_rows.device}")
    if len(slots) != (2 if rule == "adadelta" else 0):
        raise ValueError(f"fused_rows_update: {rule} takes "
                         f"{2 if rule == 'adadelta' else 0} slots, got "
                         f"{len(slots)}")
    for s in slots:
        if (s.shape != table.shape or s.dtype != torch.float32
                or s.device != dev or not s.is_contiguous()):
            raise ValueError("fused_rows_update: each slot must be an f32 "
                             f"contiguous {tuple(table.shape)} tensor on "
                             f"{dev}")
    if not table.is_contiguous():
        raise ValueError("fused_rows_update: the table must be contiguous")
    if u == 0 or d == 0:
        return
    ids = ids.to(torch.int32).contiguous()
    g_rows = g_rows.contiguous()
    accu, delta = slots if slots else (None, None)
    lib = _rows_lib()
    with torch.cuda.device(dev), _launch_lock:
        stream = torch.cuda.current_stream(dev).cuda_stream
        stamp, call = ((None, 0) if unique
                       else _next_stamp(dev, stream, nc * v))
        rc = lib.rows_update(
            table.data_ptr(), accu.data_ptr() if accu is not None else None,
            delta.data_ptr() if delta is not None else None,
            g_rows.data_ptr(), ids.data_ptr(),
            stamp.data_ptr() if stamp is not None else None, call, u, nc, v,
            d, RULES.index(rule), _DTYPE_CODES[table.dtype], float(lr),
            stream)
    if rc != 0:
        msg = lib.rows_update_error_string(rc).decode()
        raise RuntimeError(f"rows_update kernel launch failed: {msg} "
                           f"(U={u} Nc={nc} V={v} D={d} {rule} "
                           f"{table.dtype} unique={unique})")
    with _count_lock:
        fused_rows_update.launches += 1


@torch.no_grad()
def fused_rows_update(table: torch.Tensor, slots: tuple,
                      g_rows: torch.Tensor, ids: torch.Tensor, rule: str,
                      lr: float, unique: bool = False
                      ) -> tuple[torch.Tensor, tuple]:
    """Apply `rule` ("sgd" or "adadelta") at learning rate `lr` to the rows
    of `table` (Nc, V, D) that `ids` (U, Nc) touch, with their gradient
    rows `g_rows` (U, Nc, D) f32, in place on `table` and `slots` (() for
    sgd, (accu, delta) f32 for adadelta).  Math in f32, new rows stored in
    the table's dtype; ids outside [0, V) are skipped.  `unique=True`
    promises that the in-range ids of each field are unique (a deduped
    batch); with False, the default, duplicate ids are allowed, each
    carrying the same gradient row.  CUDA tensors launch the kernel
    (counted in `fused_rows_update.launches`, once per call); CPU tensors
    run the plain version, which gives the same bits either way.  Returns
    (table, slots)."""
    _check_rule(rule)
    slots = tuple(slots)

    def cost() -> tuple:
        nc, v, d = table.shape
        touched = int(((ids >= 0) & (ids < v)).sum())
        return rows_update_cost(ids.shape[0], nc, d, table.dtype, touched,
                                rule)

    with flops_lib.kernel(cost):
        if table.device.type == "cpu":
            rows_update_plain(table, slots, g_rows, ids, rule, lr)
        else:
            _check_device("fused_rows_update", table)
            _launch_rows_update(table, slots, g_rows, ids, rule, lr, unique)
    return table, slots


fused_rows_update.launches = 0
