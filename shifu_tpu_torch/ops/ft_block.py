"""Fused FT-Transformer block: attention + FFN in one pass.

Port of shifu_tpu/ops/pallas_ft_block.py.  On a CUDA tensor
`fused_transformer_block` launches the hand-written kernel
`csrc/ft_block.cu`; on a CPU tensor it runs `block_math`, the same f32 math
in plain PyTorch.  There is no fallback from one to the other: a CUDA
tensor the kernel cannot take raises.

The backward is the JAX package's `_fused_block_bwd`: no activation is
stored across the block; the backward pass recomputes `block_math` from
the saved input and f32 params and differentiates it.  In JAX that
backward is XLA (`jax.vjp` of `_block_math`), not Pallas, so here it is
plain PyTorch on either device and no kernel of its own (a hand-written
backward is a later performance item, ROADMAP.md).

The math is `_block_math` of the JAX module, all in f32: LayerNorm with a
two-pass variance and eps 1e-6, QKV, per-head softmax attention over the
S tokens, projection and residual, LayerNorm, tanh-gelu FFN and residual.
The JAX wrapper pads S to 8 and B to the 8-sample tile and masks the pad
keys; those are TPU tiling choices, so here S is always the real token
count and nothing is padded.
"""

from __future__ import annotations

import ctypes
import threading

import torch
import torch.nn.functional as F

from . import _build

MAX_TOKENS = 64
MAX_TOKEN_DIM = 128
MAX_MLP_RATIO = 8
LN_EPS = 1e-6          # flax nn.LayerNorm default

# the JAX module's order; the kernel takes the 12 pointers in it
_PARAM_ORDER = (
    "ln_attn_scale", "ln_attn_bias", "qkv_kernel", "qkv_bias",
    "proj_kernel", "proj_bias", "ln_mlp_scale", "ln_mlp_bias",
    "mlp_in_kernel", "mlp_in_bias", "mlp_out_kernel", "mlp_out_bias")

_count_lock = threading.Lock()


def ft_block_applicable(seq_len: int, token_dim: int, num_heads: int,
                        mlp_ratio: int) -> bool:
    """True where the fused block can run: head split exact and (S, D, R)
    inside S <= 64, D <= 128, R <= 8 — the JAX gate's limits.  The kernel's
    shared-memory plan covers that whole envelope."""
    if num_heads <= 0 or token_dim % num_heads != 0:
        return False
    return (0 < seq_len <= MAX_TOKENS and 0 < token_dim <= MAX_TOKEN_DIM
            and 0 < mlp_ratio <= MAX_MLP_RATIO)


def fused_block_engaged(spec, seq_len: int, train: bool = False) -> bool:
    """Config-level gate (ModelSpec.fused_block), the JAX gate's rules with
    one difference: where JAX engages "auto" only on a TPU, here "auto"
    engages wherever the block runs — on the card through the kernel, on
    the CPU through its plain version.  As in JAX, a block with dropout is
    not fused in training (dropout applies between the fused stages).  The
    JAX gate's ring/Ulysses case has no caller: the model refuses those
    `attention_impl`s."""
    if getattr(spec, "fused_block", "off") == "off":
        return False
    if train and spec.dropout_rate > 0:
        return False
    return ft_block_applicable(seq_len, spec.token_dim,
                               spec.num_attention_heads, spec.mlp_ratio)


def _ln(x: torch.Tensor, scale: torch.Tensor,
        bias: torch.Tensor) -> torch.Tensor:
    mean = x.mean(dim=-1, keepdim=True)
    var = torch.square(x - mean).mean(dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + LN_EPS) * scale + bias


def block_math(x: torch.Tensor, p: dict, heads: int) -> torch.Tensor:
    """The fused block in plain PyTorch on (B, S, D) f32 tokens with the
    stacked-name param dict (f32).  The kernel's CPU twin."""
    b, s, d = x.shape
    dh = d // heads
    x2 = x.reshape(b * s, d)

    y = _ln(x2, p["ln_attn_scale"], p["ln_attn_bias"])
    qkv = y @ p["qkv_kernel"] + p["qkv_bias"]
    q, k, v = (t.reshape(b, s, heads, dh).transpose(1, 2)
               for t in qkv.split(d, dim=-1))             # (B, H, S, dh)
    scores = torch.matmul(q * dh ** -0.5, k.transpose(-1, -2))
    smax = scores.amax(dim=-1, keepdim=True)
    ex = torch.exp(scores - smax)
    probs = ex / ex.sum(dim=-1, keepdim=True)
    attn = torch.matmul(probs, v).transpose(1, 2).reshape(b * s, d)
    x2 = x2 + (attn @ p["proj_kernel"] + p["proj_bias"])

    y = _ln(x2, p["ln_mlp_scale"], p["ln_mlp_bias"])
    y = F.gelu(y @ p["mlp_in_kernel"] + p["mlp_in_bias"], approximate="tanh")
    y = y @ p["mlp_out_kernel"] + p["mlp_out_bias"]
    return (x2 + y).reshape(b, s, d)


def _param_shapes(d: int, r: int) -> dict:
    return {"ln_attn_scale": (d,), "ln_attn_bias": (d,),
            "qkv_kernel": (d, 3 * d), "qkv_bias": (3 * d,),
            "proj_kernel": (d, d), "proj_bias": (d,),
            "ln_mlp_scale": (d,), "ln_mlp_bias": (d,),
            "mlp_in_kernel": (d, r * d), "mlp_in_bias": (r * d,),
            "mlp_out_kernel": (r * d, d), "mlp_out_bias": (d,)}


def _lib() -> ctypes.CDLL:
    lib = _build.load("ft_block")
    if not getattr(lib, "_shifu_typed", False):
        lib.ft_block_fwd.argtypes = (
            [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
            + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p])
        lib.ft_block_fwd.restype = ctypes.c_int
        lib.ft_block_error_string.argtypes = [ctypes.c_int]
        lib.ft_block_error_string.restype = ctypes.c_char_p
        lib._shifu_typed = True
    return lib


def _launch(xf: torch.Tensor, flat: list, heads: int,
            ratio: int) -> torch.Tensor:
    b, s, d = xf.shape
    out = torch.empty_like(xf)
    if b == 0:
        return out
    lib = _lib()
    ptrs = (ctypes.c_void_p * len(flat))(*[t.data_ptr() for t in flat])
    with torch.cuda.device(xf.device):
        stream = torch.cuda.current_stream(xf.device).cuda_stream
        rc = lib.ft_block_fwd(xf.data_ptr(), out.data_ptr(), ptrs, b, s, d,
                              heads, ratio, float((d // heads) ** -0.5),
                              stream)
    if rc != 0:
        msg = lib.ft_block_error_string(rc).decode()
        raise RuntimeError(f"ft_block kernel launch failed: {msg} "
                           f"(B={b} S={s} D={d} H={heads} R={ratio})")
    with _count_lock:
        fused_transformer_block.launches += 1
    return out


class _FusedBlock(torch.autograd.Function):
    """Forward: the kernel on CUDA, `block_math` on the CPU.  Backward: the
    recompute of JAX's `_fused_block_bwd` (module docstring)."""

    @staticmethod
    def forward(ctx, xf, heads, ratio, *flat):
        ctx.save_for_backward(xf, *flat)
        ctx.heads = heads
        if xf.device.type == "cpu":
            return block_math(xf, dict(zip(_PARAM_ORDER, flat)), heads)
        return _launch(xf, list(flat), heads, ratio)

    @staticmethod
    def backward(ctx, dy):
        xf, *flat = ctx.saved_tensors
        with torch.enable_grad():
            xr = xf.detach().requires_grad_(True)
            pr = [t.detach().requires_grad_(True) for t in flat]
            y = block_math(xr, dict(zip(_PARAM_ORDER, pr)), ctx.heads)
            grads = torch.autograd.grad(y, [xr, *pr], dy)
        return (grads[0], None, None, *grads[1:])


def fused_transformer_block(x: torch.Tensor, p: dict,
                            spec) -> torch.Tensor:
    """One fused pre-LN transformer block over (B, S, D) tokens with the
    stacked-name param dict (`_PARAM_ORDER` keys).  Computes in f32 and
    returns x.dtype; differentiable in x and every param (recompute
    backward).  CUDA tensors launch the kernel (and count in
    `fused_transformer_block.launches`); CPU tensors run `block_math`."""
    if x.dim() != 3:
        raise ValueError(f"fused_transformer_block expects (B, S, D); got "
                         f"{tuple(x.shape)}")
    b, s, d = x.shape
    heads, ratio = spec.num_attention_heads, spec.mlp_ratio
    if d != spec.token_dim or not ft_block_applicable(s, d, heads, ratio):
        raise ValueError(
            "fused_transformer_block called while not applicable "
            f"(S={s} D={d} H={heads} R={ratio}); gate call sites on "
            "fused_block_engaged()")
    shapes = _param_shapes(d, ratio)
    flat = []
    for name in _PARAM_ORDER:
        t = p[name]
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"fused_transformer_block: {name} has shape "
                             f"{tuple(t.shape)}, expected {shapes[name]}")
        if t.device != x.device:
            raise ValueError(f"fused_transformer_block: {name} is on "
                             f"{t.device}, x on {x.device}")
        flat.append(t.float())
    xf = x.float()
    if x.device.type == "cuda":
        for name, t in zip(("x", *_PARAM_ORDER), (xf, *flat)):
            if not t.is_contiguous():
                raise ValueError(f"fused_transformer_block: {name} must be "
                                 "contiguous")
    elif x.device.type != "cpu":
        raise ValueError(f"fused_transformer_block: unsupported device "
                         f"{x.device}")
    return _FusedBlock.apply(xf, heads, ratio, *flat).to(x.dtype)


fused_transformer_block.launches = 0
