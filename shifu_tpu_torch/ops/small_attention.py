"""Small-token attention for feature tokens: S <= 64 tokens, head dim <= 16.

Port of shifu_tpu/ops/pallas_small_attention.py (forward).  On a CUDA
tensor `small_token_attention` launches the hand-written kernel
`csrc/small_attention.cu`; on a CPU tensor it runs `small_attention_plain`,
the same f32 math in plain PyTorch.  There is no fallback from one to the
other: a CUDA tensor the kernel cannot take raises.

Semantics are the Pallas kernel's, not `ops/attention.mha`'s: q, k and v
are widened to f32, scores, softmax and the weighted sum of V are f32, and
the output is rounded once to q's dtype.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import torch

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


def small_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: float) -> torch.Tensor:
    """The kernel's math in plain PyTorch: (B, H, S, D) -> (B, H, S, D)."""
    qf, kf, vf = q.float(), k.float(), v.float()
    scores = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    w = p / p.sum(dim=-1, keepdim=True)
    return torch.matmul(w, vf).to(q.dtype)


def _lib() -> ctypes.CDLL:
    lib = _build.load("small_attention")
    if not getattr(lib, "_shifu_typed", False):
        lib.small_attention_fwd.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        lib.small_attention_fwd.restype = ctypes.c_int
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


def small_token_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: Optional[float] = None) -> torch.Tensor:
    """softmax(q k^T * scale) v on (B, H, S, D) with S <= 64, D <= 16;
    `scale` defaults to 1/sqrt(D).  CUDA tensors launch the kernel (and
    count in `small_token_attention.launches`); CPU tensors run the plain
    version."""
    if q.dim() != 4:
        raise ValueError(f"small_token_attention expects (B, H, S, D); got "
                         f"{tuple(q.shape)}")
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    if q.device.type == "cpu":
        return small_attention_plain(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"small_token_attention: unsupported device "
                         f"{q.device}")
    _check_cuda(q, k, v)
    return _launch(q, k, v, scale)


small_token_attention.launches = 0
