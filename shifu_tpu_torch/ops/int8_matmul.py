"""Fused int8-dequant + first-layer product for int8 wire features.

Port of shifu_tpu/ops/pallas_int8_matmul.py.  On a CUDA tensor
`int8_matmul_dequant` launches the hand-written kernel
`csrc/int8_matmul.cu`; on a CPU tensor it runs `int8_matmul_plain`, the same
math in plain PyTorch (the JAX package's `xla_reference`).  There is no
fallback from one to the other: a CUDA call the kernel cannot take raises.

Contract, for q (M, F) int8, w (F, N), b (N,), scale/offset (F,) f32 and a
compute dtype cdt in {bfloat16, float32, float16}:

    cdt(cdt(q * scale + offset) @ cdt(w)) + cdt(b)

with the dequant in f32, the product accumulated in f32 and rounded to cdt,
and the bias added in cdt (an f32 add of the two rounded values, rounded
once more) -- not an f32 bias add before the rounding.

Gradient (`Int8MatmulFn`): the JAX package's `custom_vjp`.  dW = x^T dy with
x the recomputed dequant in cdt, accumulated in f32 and cast to w's dtype
(f32); db = the sum of dy in dy's dtype (the compute dtype), cast to
w's dtype; q, scale and offset get no gradient.  The
JAX package on a CPU does not run its kernel: there layer 0 sees decoded f32
features, and autograd of the cast to cdt rounds dW to cdt.  The port keeps
dW in f32 on both devices, as the TPU path does; the training tests' bf16
tolerance covers the difference.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import torch

from . import _build

# the JAX gate's shape limits (`pallas_int8_matmul.fused_available`)
MAX_FEATURES = 4096
MAX_OUT = 4096

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_count_lock = threading.Lock()


def int8_available(n_features: int, n_out: int) -> bool:
    """The shape gate: 0 < F <= 4096 and 0 < N <= 4096.  Shape only -- on
    the card every admitted shape launches the kernel."""
    return 0 < n_features <= MAX_FEATURES and 0 < n_out <= MAX_OUT


def dequant_plain(q: torch.Tensor, scale: torch.Tensor,
                  offset: Optional[torch.Tensor]) -> torch.Tensor:
    """f32 inverse of the wire grid: q * scale (+ offset)."""
    x = q.float() * scale.float()
    return x if offset is None else x + offset.float()


def int8_matmul_plain(q: torch.Tensor, w: torch.Tensor,
                      b: torch.Tensor, scale: torch.Tensor,
                      offset: Optional[torch.Tensor],
                      compute_dtype: torch.dtype = torch.bfloat16
                      ) -> torch.Tensor:
    """The kernel's math in plain PyTorch, (M, F) int8 -> (M, N) cdt."""
    x = dequant_plain(q, scale, offset).to(compute_dtype)
    y = (x.float() @ w.to(compute_dtype).float()).to(compute_dtype)
    return y + b.to(compute_dtype)


def _lib() -> ctypes.CDLL:
    lib = _build.load("int8_matmul")
    if not getattr(lib, "_shifu_typed", False):
        lib.int8_matmul_fwd.argtypes = (
            [ctypes.c_void_p] * 6
            + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
               ctypes.c_void_p])
        lib.int8_matmul_fwd.restype = ctypes.c_int
        lib.int8_matmul_error_string.argtypes = [ctypes.c_int]
        lib.int8_matmul_error_string.restype = ctypes.c_char_p
        lib._shifu_typed = True
    return lib


def _launch(q: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
            scale: torch.Tensor, offset: Optional[torch.Tensor],
            compute_dtype: torch.dtype) -> torch.Tensor:
    if q.dtype != torch.int8 or q.dim() != 2:
        raise ValueError(f"int8_matmul_dequant: q must be (M, F) int8; got "
                         f"{tuple(q.shape)} {q.dtype}")
    if compute_dtype not in _DTYPE_CODES:
        raise TypeError(f"int8_matmul_dequant: compute dtype {compute_dtype} "
                        "not supported; expected float32, bfloat16 or "
                        "float16")
    m, f = q.shape
    n = w.shape[1]
    if w.shape[0] != f or not int8_available(f, n):
        raise ValueError(f"int8_matmul_dequant: kernel takes 0 < F, N <= "
                         f"{MAX_FEATURES}; got q {tuple(q.shape)}, w "
                         f"{tuple(w.shape)}")
    dev = q.device

    def as_f32(t: torch.Tensor, shape: tuple, name: str) -> torch.Tensor:
        if tuple(t.shape) != shape or t.device != dev:
            raise ValueError(f"int8_matmul_dequant: {name} must be {shape} on "
                             f"{dev}; got {tuple(t.shape)} on {t.device}")
        return t.detach().to(torch.float32).contiguous()

    q = q.contiguous()
    w32 = as_f32(w, (f, n), "w")
    b32 = as_f32(b, (n,), "b")
    s32 = as_f32(scale, (f,), "scale")
    o32 = as_f32(offset, (f,), "offset") if offset is not None else None
    out = torch.empty((m, n), device=dev, dtype=compute_dtype)
    if m == 0:
        return out
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.int8_matmul_fwd(
            q.data_ptr(), w32.data_ptr(), b32.data_ptr(), s32.data_ptr(),
            o32.data_ptr() if o32 is not None else None, out.data_ptr(),
            m, f, n, _DTYPE_CODES[compute_dtype], stream)
    if rc != 0:
        msg = lib.int8_matmul_error_string(rc).decode()
        raise RuntimeError(f"int8_matmul kernel launch failed: {msg} "
                           f"(M={m} F={f} N={n} {compute_dtype})")
    with _count_lock:
        int8_matmul_dequant.launches += 1
    return out


def _forward(q, w, b, scale, offset, compute_dtype) -> torch.Tensor:
    if q.device.type == "cpu":
        return int8_matmul_plain(q, w, b, scale, offset, compute_dtype)
    if q.device.type != "cuda":
        raise ValueError(f"int8_matmul_dequant: unsupported device {q.device}")
    return _launch(q, w, b, scale, offset, compute_dtype)


class Int8MatmulFn(torch.autograd.Function):
    """Forward through the kernel (or the plain math on the CPU); backward
    as the JAX package's `_int8_matmul_bwd`."""

    @staticmethod
    def forward(ctx, q, w, b, scale, offset, compute_dtype):
        ctx.compute_dtype = compute_dtype
        ctx.has_offset = offset is not None
        ctx.w_dtype = w.dtype
        ctx.save_for_backward(q, scale, offset if offset is not None
                              else scale.new_zeros(()))
        return _forward(q, w, b, scale, offset, compute_dtype)

    @staticmethod
    def backward(ctx, dy):
        q, scale, offset = ctx.saved_tensors
        x = dequant_plain(q, scale, offset if ctx.has_offset else None)
        x = x.to(ctx.compute_dtype).float()
        dyc = dy.to(ctx.compute_dtype).float()
        dw = (x.t() @ dyc).to(ctx.w_dtype)
        db = dy.sum(dim=0).to(ctx.w_dtype)
        return None, dw, db, None, None, None


def int8_matmul_dequant(q: torch.Tensor, w: torch.Tensor,
                        b: torch.Tensor, scale: torch.Tensor,
                        offset: Optional[torch.Tensor] = None,
                        compute_dtype: torch.dtype = torch.bfloat16
                        ) -> torch.Tensor:
    """`dequant(q) @ w + b` for int8 wire features, differentiable in w and
    b.  CUDA tensors launch the kernel (counted in
    `int8_matmul_dequant.launches`); CPU tensors run the plain version."""
    return Int8MatmulFn.apply(q, w, b, scale, offset, compute_dtype)


int8_matmul_dequant.launches = 0
