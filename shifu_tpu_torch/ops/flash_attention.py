"""Flash attention for long token axes: any S, head dim <= 128.

Port of shifu_tpu/ops/pallas_attention.py.  On CUDA tensors the forward
launches `flash_fwd` and the backward `flash_bwd_dq` and `flash_bwd_dkv`,
the hand-written kernels of `csrc/flash_fwd.cu`, `csrc/flash_bwd_dq.cu`
and `csrc/flash_bwd_dkv.cu`; on CPU tensors they
run `flash_fwd_plain` and `flash_bwd_plain`, the same f32 math in plain
PyTorch.  There is no fallback from one to the other: a CUDA tensor the
kernels cannot take raises.

Semantics are the Pallas kernels': q, k, v (and dO) are widened to f32;
the forward keeps a streaming softmax and writes the output, rounded once
to q's dtype, and the log-sum-exp lse = m + log(l) in f32; the backward
recomputes p = exp(s - lse) and takes dS = p (dP - Dres) with
Dres = rowsum(dO * o), a torch op beside the kernels as it is an XLA op
beside the TPU kernels; each gradient is rounded once to q's dtype.  The
JAX wrapper pads S to a common multiple of its 512-row blocks; those are
TPU tiles, so here S is the real token count and the kernels mask the
ragged edge themselves.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import torch

from . import _build

MAX_D = 128

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_count_lock = threading.Lock()
# the plain versions form the (rows, S, S) f32 scores a chunk of
# (sample, head) rows at a time, by device: on the card 512 MB, so that they
# fit its memory at the flash path's shapes (1024 x 8 rows of 1001 x 1001
# would be 33 GB at once) in few launches; on the CPU 4 MB, which stays in
# cache (2.5x faster than 512 MB at S = 1001 on an 8-core host)
_PLAIN_CHUNK_BYTES = {"cuda": 1 << 29, "cpu": 1 << 22}


def _chunks(n_rows: int, s: int, device: torch.device):
    budget = _PLAIN_CHUNK_BYTES.get(device.type, _PLAIN_CHUNK_BYTES["cpu"])
    step = max(1, budget // max(1, s * s * 4))
    for lo in range(0, n_rows, step):
        yield slice(lo, min(n_rows, lo + step))


def flash_fwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel's math in plain PyTorch: (B, H, S, D) ->
    (out in q's dtype, lse (B, H, S) f32)."""
    b, h, s, d = q.shape
    q3, k3, v3 = (t.reshape(b * h, s, d) for t in (q, k, v))
    out = torch.empty_like(q3)
    lse = torch.empty((b * h, s), dtype=torch.float32, device=q.device)
    for sl in _chunks(b * h, s, q.device):
        scores = torch.matmul(q3[sl].float(),
                              k3[sl].float().transpose(-1, -2)) * scale
        m = scores.amax(dim=-1, keepdim=True)
        p = torch.exp(scores - m)
        l = p.sum(dim=-1, keepdim=True)
        out[sl] = (torch.matmul(p, v3[sl].float()) / l).to(q.dtype)
        lse[sl] = (m + torch.log(l)).squeeze(-1)
    return out.reshape(b, h, s, d), lse.reshape(b, h, s)


def flash_dres(out: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Dres = rowsum(dO * o) in f32, (B, H, S): the backward's one torch op
    beside the kernels."""
    return (g.float() * out.float()).sum(dim=-1)


def _bwd_plain(q, k, v, g, lse, dres, scale, parts) -> dict:
    """The backward's f32 math for the gradients named in `parts` ("dq",
    "dk", "dv"), a chunk of (sample, head) rows at a time, in one pass:
    p = exp(s - lse), dS = p (dP - Dres), dq = scale * dS k,
    dk = scale * dS^T q, dv = p^T dO, each rounded to q's dtype."""
    b, h, s, d = q.shape
    q3, k3, v3, g3 = (t.reshape(b * h, s, d) for t in (q, k, v, g))
    lse3, dres3 = lse.reshape(b * h, s), dres.reshape(b * h, s)
    out = {n: torch.empty((b * h, s, d), dtype=q.dtype, device=q.device)
           for n in parts}
    for sl in _chunks(b * h, s, q.device):
        qf, kf, vf, gf = (t[sl].float() for t in (q3, k3, v3, g3))
        scores = torch.matmul(qf, kf.transpose(-1, -2)) * scale
        p = torch.exp(scores - lse3[sl].unsqueeze(-1))
        if "dv" in parts:
            out["dv"][sl] = torch.matmul(p.transpose(-1, -2), gf).to(q.dtype)
        dp = torch.matmul(gf, vf.transpose(-1, -2))
        ds = p * (dp - dres3[sl].unsqueeze(-1))
        if "dq" in parts:
            out["dq"][sl] = (torch.matmul(ds, kf) * scale).to(q.dtype)
        if "dk" in parts:
            out["dk"][sl] = (torch.matmul(ds.transpose(-1, -2), qf)
                             * scale).to(q.dtype)
    return {n: t.reshape(b, h, s, d) for n, t in out.items()}


def flash_bwd_dq_plain(q, k, v, g, lse, dres, scale) -> torch.Tensor:
    """The dq kernel's math in plain PyTorch."""
    return _bwd_plain(q, k, v, g, lse, dres, scale, ("dq",))["dq"]


def flash_bwd_dkv_plain(q, k, v, g, lse, dres, scale
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """The dk/dv kernel's math in plain PyTorch."""
    got = _bwd_plain(q, k, v, g, lse, dres, scale, ("dk", "dv"))
    return got["dk"], got["dv"]


def flash_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    out: torch.Tensor, lse: torch.Tensor, g: torch.Tensor,
                    scale: float
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward in plain PyTorch: (dq, dk, dv) in q's dtype from the
    saved output and log-sum-exp, in one pass (the CPU route)."""
    got = _bwd_plain(q, k, v, g, lse, flash_dres(out, g), scale,
                     ("dq", "dk", "dv"))
    return got["dq"], got["dk"], got["dv"]


# pointers each kernel's C entry point takes before (B, H, S, D, scale,
# dtype, stream)
_N_PTRS = {"flash_fwd": 5, "flash_bwd_dq": 7, "flash_bwd_dkv": 8}


def _lib(name: str) -> ctypes.CDLL:
    """The library of `csrc/<name>.cu` (one source per kernel)."""
    lib = _build.load(name)
    if not getattr(lib, "_shifu_typed", False):
        fn = getattr(lib, name)
        fn.argtypes = ([ctypes.c_void_p] * _N_PTRS[name]
                       + [ctypes.c_int] * 4
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.flash_error_string.argtypes = [ctypes.c_int]
        lib.flash_error_string.restype = ctypes.c_char_p
        lib._shifu_typed = True
    return lib


def _check(name: str, q: torch.Tensor, *others: torch.Tensor) -> None:
    """The kernels' envelope on CUDA tensors: (B, H, S, D) of one shape,
    dtype and device, contiguous, 0 < D <= 128."""
    if q.dim() != 4:
        raise ValueError(f"{name} expects (B, H, S, D); got {tuple(q.shape)}")
    for t in others:
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(
                f"{name}: every operand must match q in shape, dtype and "
                f"device; q {tuple(q.shape)} {q.dtype} {q.device}, got "
                f"{tuple(t.shape)} {t.dtype} {t.device}")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name}: dtype {q.dtype} not supported; expected "
                        "float32, bfloat16 or float16")
    for t in (q, *others):
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
    _b, _h, s, d = q.shape
    if not (s > 0 and 0 < d <= MAX_D):
        raise ValueError(f"{name}: the kernels take S >= 1 and D <= {MAX_D}; "
                         f"got S={s}, D={d}")


def _check_vec(name: str, q: torch.Tensor, *vecs: torch.Tensor) -> None:
    for t in vecs:
        if (t.shape != q.shape[:3] or t.dtype != torch.float32
                or t.device != q.device or not t.is_contiguous()):
            raise ValueError(f"{name}: lse and Dres must be contiguous f32 "
                             f"{tuple(q.shape[:3])} on {q.device}")


def _run(fn_name: str, counter, q: torch.Tensor, ptrs: list,
         scale: float) -> None:
    """Launch `fn_name` with the data pointers, q's shape, the scale and
    the dtype code on the current stream; raise if the launch failed, else
    count it on `counter`."""
    b, h, s, d = q.shape
    lib = _lib(fn_name)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = getattr(lib, fn_name)(*ptrs, b, h, s, d, float(scale),
                                   _DTYPE_CODES[q.dtype], stream)
    if rc != 0:
        msg = lib.flash_error_string(rc).decode()
        raise RuntimeError(f"{fn_name} kernel launch failed: {msg} "
                           f"(B={b} H={h} S={s} D={d} {q.dtype})")
    with _count_lock:
        counter.launches += 1


def _route(name: str, q: torch.Tensor) -> bool:
    """True for CUDA (launch the kernel), False for the CPU (plain)."""
    if q.device.type == "cpu":
        return False
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    return True


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(out, lse) of the forward.  CUDA tensors launch the kernel (and
    count in `flash_fwd.launches`); CPU tensors run `flash_fwd_plain`."""
    if not _route("flash_fwd", q):
        return flash_fwd_plain(q, k, v, scale)
    _check("flash_fwd", q, k, v)
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    if q.numel():
        _run("flash_fwd", flash_fwd, q,
             [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
              lse.data_ptr()], scale)
    return out, lse


def flash_bwd_dq(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 g: torch.Tensor, lse: torch.Tensor, dres: torch.Tensor,
                 scale: float) -> torch.Tensor:
    """dq from the saved lse and Dres.  CUDA tensors launch the dq kernel
    (and count in `flash_bwd_dq.launches`); CPU tensors run
    `flash_bwd_dq_plain`."""
    if not _route("flash_bwd_dq", q):
        return flash_bwd_dq_plain(q, k, v, g, lse, dres, scale)
    _check("flash_bwd_dq", q, k, v, g)
    _check_vec("flash_bwd_dq", q, lse, dres)
    dq = torch.empty_like(q)
    if q.numel():
        _run("flash_bwd_dq", flash_bwd_dq, q,
             [q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
              lse.data_ptr(), dres.data_ptr(), dq.data_ptr()], scale)
    return dq


def flash_bwd_dkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  g: torch.Tensor, lse: torch.Tensor, dres: torch.Tensor,
                  scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) from the saved lse and Dres.  CUDA tensors launch the dk/dv
    kernel (and count in `flash_bwd_dkv.launches`); CPU tensors run
    `flash_bwd_dkv_plain`."""
    if not _route("flash_bwd_dkv", q):
        return flash_bwd_dkv_plain(q, k, v, g, lse, dres, scale)
    _check("flash_bwd_dkv", q, k, v, g)
    _check_vec("flash_bwd_dkv", q, lse, dres)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if q.numel():
        _run("flash_bwd_dkv", flash_bwd_dkv, q,
             [q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
              lse.data_ptr(), dres.data_ptr(), dk.data_ptr(), dv.data_ptr()],
             scale)
    return dk, dv


def flash_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              out: torch.Tensor, lse: torch.Tensor, g: torch.Tensor,
              scale: float
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv): on CUDA Dres as a torch op, then the dq kernel and the
    dk/dv kernel; on the CPU `flash_bwd_plain`."""
    if not _route("flash_bwd", q):
        return flash_bwd_plain(q, k, v, out, lse, g, scale)
    g = g.contiguous()
    dres = flash_dres(out, g)
    dq = flash_bwd_dq(q, k, v, g, lse, dres, scale)
    dk, dv = flash_bwd_dkv(q, k, v, g, lse, dres, scale)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale):
        out, lse = flash_fwd(q, k, v, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, out, lse, g, ctx.scale)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: Optional[float] = None) -> torch.Tensor:
    """softmax(q k^T * scale) v on (B, H, S, D), differentiable through the
    flash backward; `scale` defaults to 1/sqrt(D)."""
    if q.dim() != 4:
        raise ValueError(f"flash_attention expects (B, H, S, D); got "
                         f"{tuple(q.shape)}")
    scale = scale if scale is not None else 1.0 / (q.shape[-1] ** 0.5)
    return _FlashAttention.apply(q, k, v, float(scale))


flash_fwd.launches = 0
flash_bwd_dq.launches = 0
flash_bwd_dkv.launches = 0
