"""Fused FT-Transformer block: attention + FFN in one pass.

Port of shifu_tpu/ops/pallas_ft_block.py.  On a CUDA tensor
`fused_transformer_block` launches the hand-written kernel
`csrc/ft_block.cu`; on a CPU tensor it runs `block_math`, the same f32 math
in plain PyTorch.  The forward is the operator `shifu_tpu_torch::ft_block`
(`torch.library.custom_op`): the dispatcher picks its CPU or CUDA
implementation from the tensors' device at run time, so a `torch.export`
program holds the operator and runs the kernel wherever it is loaded on
the card.  There is no fallback from one to the other: a CUDA tensor the
kernel cannot take raises.

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

from ..obs import flops as flops_lib
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


def fused_block_engaged(spec, seq_len: int, train: bool = False,
                        n_seq_parallel: int = 1) -> bool:
    """Config-level gate (ModelSpec.fused_block), the JAX gate's rules with
    one difference: where JAX engages "auto" only on a TPU, here "auto"
    engages wherever the block runs — on the card through the kernel, on
    the CPU through its plain version.  As in JAX, a block with dropout is
    not fused in training (dropout applies between the fused stages), nor
    one whose attention is ring or Ulysses (`attention_impl`, with or
    without a seq axis above 1)."""
    if getattr(spec, "fused_block", "off") == "off":
        return False
    if train and spec.dropout_rate > 0:
        return False
    if n_seq_parallel > 1 or spec.attention_impl in ("ring", "ulysses"):
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


def block_ops(b: int, s: int, d: int, h: int,
              r: int) -> tuple[float, float]:
    """Operations of one block on these shapes: (the four products, the
    rest: the attention products and the elementwise work, LayerNorm
    ~8/elt, gelu ~10/elt, softmax ~4 per score, residual adds)."""
    m = b * s
    products = 2 * m * (3 * d * d + d * d + 2 * r * d * d)
    attention = 4 * b * h * s * s * (d // h)
    elementwise = (2 * 8 * m * d + 10 * m * r * d + 4 * b * h * s * s
                   + 2 * m * d)
    return float(products), float(attention + elementwise)


def cost(b: int, s: int, d: int, h: int, r: int) -> tuple:
    """(flops, bytes, exponentials) of one forward call: `block_ops`
    summed; x read and the output written in f32, every parameter read
    once.  (Its bound weighs the products and the rest at their own rates,
    chip_smoke.check_ft_block.)"""
    products, rest = block_ops(b, s, d, h, r)
    params = sum(int(torch.Size(shape).numel())
                 for shape in _param_shapes(d, r).values())
    return products + rest, float(2 * b * s * d * 4 + params * 4), 0.0


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


# The forward is the operator `shifu_tpu_torch::ft_block`: the dispatcher
# picks its CPU implementation (`block_math`) or its CUDA one (the kernel)
# from the tensors' device at run time, so a program traced by
# torch.export on either device holds the operator, not one branch.


@torch.library.custom_op("shifu_tpu_torch::ft_block", mutates_args=(),
                         device_types="cpu")
def ft_block_op(xf: torch.Tensor, flat: list[torch.Tensor], heads: int,
                ratio: int) -> torch.Tensor:
    """CPU: `block_math` on f32 tokens and the `_PARAM_ORDER` params."""
    return block_math(xf, dict(zip(_PARAM_ORDER, flat)), heads)


@ft_block_op.register_kernel("cuda")
def _ft_block_cuda(xf, flat, heads, ratio):
    for name, t in zip(("x", *_PARAM_ORDER), (xf, *flat)):
        if not t.is_contiguous():
            raise ValueError(f"fused_transformer_block: {name} must be "
                             "contiguous")
    return _launch(xf, list(flat), heads, ratio)


@ft_block_op.register_fake
def _ft_block_fake(xf, flat, heads, ratio):
    return torch.empty_like(xf)


def _ft_block_setup(ctx, inputs, output):
    xf, flat, heads, _ratio = inputs
    ctx.save_for_backward(xf, *flat)
    ctx.heads = heads


def _ft_block_bwd(ctx, dy):
    """The recompute of JAX's `_fused_block_bwd` (module docstring)."""
    xf, *flat = ctx.saved_tensors
    with torch.enable_grad():
        xr = xf.detach().requires_grad_(True)
        pr = [t.detach().requires_grad_(True) for t in flat]
        y = block_math(xr, dict(zip(_PARAM_ORDER, pr)), ctx.heads)
        grads = torch.autograd.grad(y, [xr, *pr], dy)
    return grads[0], list(grads[1:]), None, None


ft_block_op.register_autograd(_ft_block_bwd, setup_context=_ft_block_setup)


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
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_transformer_block: unsupported device "
                         f"{x.device}")
    with flops_lib.kernel(lambda: cost(b, s, d, heads, ratio)):
        out = ft_block_op(x.float(), flat, heads, ratio)
    return out.to(x.dtype)


fused_transformer_block.launches = 0
