"""Small-token attention for feature tokens: S <= 64 tokens, head dim <= 16.

Port of shifu_tpu/ops/pallas_small_attention.py, forward and backward.  On
CUDA tensors `small_token_attention` launches the hand-written kernels of
`csrc/small_attention.cu`: the forward, and in the backward pass
`small_attention_bwd`; on CPU tensors they run `small_attention_plain` and
`small_attention_bwd_plain`, the same f32 math in plain PyTorch.  The
forward is the operator `shifu_tpu_torch::small_attention`: the dispatcher
picks its implementation from the device at run time (a `torch.export`
program holds the operator).  There is no fallback from one to the other:
a CUDA tensor the kernels cannot take raises.

Semantics are the Pallas kernels', not `ops/attention.mha`'s: q, k and v
are widened to f32, scores, softmax and the weighted sum of V are f32, and
the output is rounded once to q's dtype; the backward recomputes the
softmax, sums every gradient in f32 and rounds each once to q's dtype.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import torch

from ..obs import flops as flops_lib
from . import _build

# the JAX gate's envelope, so both packages route the same shapes
MAX_S = 64
MAX_D = 16
LANES = 128

# every ModelSpec.compute_dtype: the unfused block hands the kernel q, k, v
# in the compute dtype
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_count_lock = threading.Lock()


def small_attention_applicable(s: int, d: int, h: int = 1) -> bool:
    """The shape envelope of the JAX package's auto-routing gate
    (`pallas_small_attention.small_attention_applicable`), kept as it is
    so that the unfused block takes the kernel for the same shapes:
    S <= 64, D <= 16, and the TPU kernel's resident-buffer estimate
    8*h*d*S_pad*128*4 bytes under 48 MB.  Shape only: no setting sends a
    shape inside the envelope to plain `mha`."""
    s_pad = -(-s // 8) * 8
    vmem_estimate = 8 * h * d * s_pad * LANES * 4
    return (s <= MAX_S and d <= MAX_D
            and vmem_estimate <= 48 * 1024 * 1024)


def cost(b: int, h: int, s: int, d: int, dtype) -> tuple:
    """(flops, bytes, exponentials) of the forward on (B, H, S, D): the
    two products and ~4 operations a score; q, k, v read and the output
    written once; one exponential a score."""
    elt = torch.empty((), dtype=dtype).element_size()
    n_ops = 4.0 * b * h * s * s * d + 4.0 * b * h * s * s
    return n_ops, float(4 * b * h * s * d * elt), float(b * h) * s * s


def cost_bwd(b: int, h: int, s: int, d: int, dtype) -> tuple:
    """(flops, bytes, exponentials) of the backward: the five products
    (the scores recomputed, dP, dq, dk, dv); q, k, v and dO read, dq, dk
    and dv written; the scores' exponentials again."""
    elt = torch.empty((), dtype=dtype).element_size()
    return (10.0 * b * h * s * s * d, float(7 * b * h * s * d * elt),
            float(b * h) * s * s)


def small_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: float) -> torch.Tensor:
    """The kernel's math in plain PyTorch: (B, H, S, D) -> (B, H, S, D)."""
    qf, kf, vf = q.float(), k.float(), v.float()
    scores = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    w = p / p.sum(dim=-1, keepdim=True)
    return torch.matmul(w, vf).to(q.dtype)


def small_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, g: torch.Tensor, scale: float
                              ) -> tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """The backward kernel's math in plain PyTorch, step by step as
    `_bwd_kernel` takes it (softmax recomputed; dv = w^T g, dP = g v^T,
    dS = w (dP - sum_k w dP), dq = scale dS k, dk = scale dS^T q), in f32;
    returns (dq, dk, dv) in q's dtype."""
    qf, kf, vf, gf = q.float(), k.float(), v.float(), g.float()
    scores = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    w = p / p.sum(dim=-1, keepdim=True)
    dv = torch.matmul(w.transpose(-1, -2), gf)
    dp = torch.matmul(gf, vf.transpose(-1, -2))
    row = (dp * w).sum(dim=-1, keepdim=True)
    ds = w * (dp - row)
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def _lib() -> ctypes.CDLL:
    lib = _build.load("small_attention")
    if not getattr(lib, "_shifu_typed", False):
        lib.small_attention_fwd.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        lib.small_attention_fwd.restype = ctypes.c_int
        lib.small_attention_bwd.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        lib.small_attention_bwd.restype = ctypes.c_int
        lib.small_attention_error_string.argtypes = [ctypes.c_int]
        lib.small_attention_error_string.restype = ctypes.c_char_p
        lib._shifu_typed = True
    return lib


def _check_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    for name, t in (("k", k), ("v", v)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(
                f"small_token_attention: {name} must match q in shape, "
                f"dtype and device; q {tuple(q.shape)} {q.dtype} {q.device}, "
                f"{name} {tuple(t.shape)} {t.dtype} {t.device}")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"small_token_attention: dtype {q.dtype} not "
                        "supported; expected float32, bfloat16 or float16")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"small_token_attention: {name} must be "
                             "contiguous (B, H, S, D)")
    _b, _h, s, d = q.shape
    if not (0 < s <= MAX_S and 0 < d <= MAX_D):
        raise ValueError(f"small_token_attention: kernel takes S <= {MAX_S} "
                         f"and D <= {MAX_D}; got S={s}, D={d}")


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            scale: float) -> torch.Tensor:
    b, h, s, d = q.shape
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.small_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, h, s, d, float(scale), _DTYPE_CODES[q.dtype], stream)
    if rc != 0:
        msg = lib.small_attention_error_string(rc).decode()
        raise RuntimeError(f"small_attention kernel launch failed: {msg} "
                           f"(B={b} H={h} S={s} D={d} {q.dtype})")
    with _count_lock:
        small_token_attention.launches += 1
    return out


def _launch_bwd(q, k, v, g, scale):
    b, h, s, d = q.shape
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    if q.numel() == 0:
        return dq, dk, dv
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.small_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b, h, s, d, float(scale), _DTYPE_CODES[q.dtype], stream)
    if rc != 0:
        msg = lib.small_attention_error_string(rc).decode()
        raise RuntimeError(f"small_attention_bwd kernel launch failed: {msg} "
                           f"(B={b} H={h} S={s} D={d} {q.dtype})")
    with _count_lock:
        small_attention_bwd.launches += 1
    return dq, dk, dv


def _route(q: torch.Tensor) -> bool:
    """True for CUDA (launch the kernel), False for the CPU (plain)."""
    if q.device.type == "cpu":
        return False
    if q.device.type != "cuda":
        raise ValueError(f"small_token_attention: unsupported device "
                         f"{q.device}")
    return True


@torch.library.custom_op("shifu_tpu_torch::small_attention",
                         mutates_args=(), device_types="cpu")
def small_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       scale: float) -> torch.Tensor:
    """The forward as an operator: the dispatcher picks this CPU
    implementation (the plain version) or the CUDA one (the kernel) from
    the tensors' device at run time."""
    return small_attention_plain(q, k, v, scale)


@small_attention_op.register_kernel("cuda")
def _small_attention_cuda(q, k, v, scale):
    _check_cuda(q, k, v)
    return _launch(q, k, v, scale)


@small_attention_op.register_fake
def _small_attention_fake(q, k, v, scale):
    return torch.empty_like(q)


def _small_attention_setup(ctx, inputs, output):
    q, k, v, scale = inputs
    ctx.save_for_backward(q, k, v)
    ctx.scale = scale


def _small_attention_grad(ctx, g):
    q, k, v = ctx.saved_tensors
    dq, dk, dv = small_attention_bwd(q, k, v, g, ctx.scale)
    return dq, dk, dv, None


small_attention_op.register_autograd(_small_attention_grad,
                                     setup_context=_small_attention_setup)


def small_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: float) -> torch.Tensor:
    """The forward, differentiable through `small_attention_bwd`: CUDA
    tensors launch the kernel (and count in
    `small_token_attention.launches`); CPU tensors run the plain
    version."""
    _route(q)  # raises on a device with neither
    with flops_lib.kernel(lambda: cost(*q.shape, q.dtype)):
        return small_attention_op(q, k, v, float(scale))


def small_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        g: torch.Tensor, scale: float
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) for the output gradient g: CUDA tensors launch the
    backward kernel (and count in `small_attention_bwd.launches`); CPU
    tensors run `small_attention_bwd_plain`."""
    with flops_lib.kernel(lambda: cost_bwd(*q.shape, q.dtype)):
        if not _route(q):
            return small_attention_bwd_plain(q, k, v, g, scale)
        _check_cuda(q, k, v)
        if g.shape != q.shape or g.dtype != q.dtype or g.device != q.device:
            raise ValueError(f"small_attention_bwd: g must match q; got "
                             f"{tuple(g.shape)} {g.dtype} {g.device}")
        return _launch_bwd(q, k, v, g.contiguous(), scale)


def small_token_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: Optional[float] = None) -> torch.Tensor:
    """softmax(q k^T * scale) v on (B, H, S, D) with S <= 64, D <= 16;
    `scale` defaults to 1/sqrt(D).  Differentiable: the backward pass runs
    `small_attention_bwd`.  CUDA tensors launch the kernels; CPU tensors
    run the plain versions."""
    if q.dim() != 4:
        raise ValueError(f"small_token_attention expects (B, H, S, D); got "
                         f"{tuple(q.shape)}")
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    return small_attention_fwd(q, k, v, float(scale))


small_token_attention.launches = 0
small_attention_bwd.launches = 0
