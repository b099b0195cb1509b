"""The rounding argument of the tensor-core fused FT block (kernel #1,
shifu_tpu_torch/csrc/ft_block.cu), modelled in PyTorch on the CPU.

The kernel runs the block's four products (QKV, projection, mlp_in,
mlp_out) on the tensor cores with f32 sums: each f32 operand, the
activations and the weights alike, goes in as bf16 hi = x rounded and
lo = x - hi rounded, and each product takes three mma, hi hi + hi lo +
lo hi (the lo lo term is dropped).  Everything else stays in f32 on the
CUDA cores: LayerNorm, the attention scores and their weighted sum of v,
softmax as exp2(s * scale * log2(e) - max * scale * log2(e)) divided by
the row sum (online over chunks of 8 keys, as the kernel takes it at head
dims 8 and 16), gelu as x / (1 + exp(-2 y)) (the same function as the tanh
form, 0.5 x (1 + tanh(y))).  The model below does the same roundings and is held to
chip_smoke.py's F32_ATOL / F32_RTOL against `block_math`, which the card
holds the kernel to, at check_ft_block's edge shapes and the path's shape
(B cut to a few samples).  As a contrast, the products rounded once to
bf16 (one pass), or split into two passes (hi hi + hi lo), miss that
tolerance at the path's shape: three passes is the cheapest split that
meets it, and the check tells the designs apart.

These tests check the rounding argument, not the kernel: nothing ties the
model to the CUDA code, and only chip_smoke.py's check_ft_block holds the
kernel itself.  The model is not on any path: nothing in the package
calls it.
"""

import importlib.util
import math
import pathlib

import numpy as np
import pytest
import torch

from shifu_tpu_torch.ops import ft_block

_ROOT = pathlib.Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               _ROOT / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)

LOG2E = 1.0 / math.log(2.0)
GELU_C = math.sqrt(2.0 / math.pi)
KEY_CHUNK = 8  # the kernel's kJ
MAX_B = 4


def _parts(x):
    """bf16 hi and lo of an f32 tensor, as f32 values."""
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def _prod(a, w, passes):
    """a @ w as the tensor cores take it, f32 sums: `passes` 3 is hi hi +
    hi lo + lo hi, 2 drops lo hi, 1 is hi hi alone."""
    ah, al = _parts(a)
    wh, wl = _parts(w)
    out = ah @ wh
    if passes >= 2:
        out = out + ah @ wl
    if passes >= 3:
        out = out + al @ wh
    return out


def _attention(q, k, v, c):
    """Softmax attention in f32 as the kernel's CUDA cores take it at head
    dims 8 and 16: keys KEY_CHUNK at a time, the running max and sum and
    the output rescaled once a chunk, p = exp2(s c - max c), the output
    divided by the sum at the end."""
    m = torch.full(q.shape[:-1], -math.inf)
    l = torch.zeros(q.shape[:-1])
    o = torch.zeros(q.shape)
    for j0 in range(0, k.shape[-2], KEY_CHUNK):
        s = q @ k[..., j0:j0 + KEY_CHUNK, :].transpose(-1, -2)
        mn = torch.maximum(m, s.amax(dim=-1))
        corr = torch.exp2(m * c - mn * c)
        p = torch.exp2(s * c - (mn * c).unsqueeze(-1))
        l = l * corr + p.sum(dim=-1)
        o = o * corr.unsqueeze(-1) + p @ v[..., j0:j0 + KEY_CHUNK, :]
        m = mn
    return o / l.unsqueeze(-1)


def model_block(x, p, heads, passes=smoke.FT_SPLIT_PASSES):
    """`block_math` with the kernel's roundings (module docstring)."""
    b, s, d = x.shape
    dh = d // heads
    c = dh ** -0.5 * LOG2E
    x2 = x.reshape(b * s, d)
    y = ft_block._ln(x2, p["ln_attn_scale"], p["ln_attn_bias"])
    qkv = _prod(y, p["qkv_kernel"], passes) + p["qkv_bias"]
    q, k, v = (t.reshape(b, s, heads, dh).transpose(1, 2)
               for t in qkv.split(d, dim=-1))
    attn = _attention(q, k, v, c).transpose(1, 2).reshape(b * s, d)
    x2 = x2 + (_prod(attn, p["proj_kernel"], passes) + p["proj_bias"])
    y = ft_block._ln(x2, p["ln_mlp_scale"], p["ln_mlp_bias"])
    y = _prod(y, p["mlp_in_kernel"], passes) + p["mlp_in_bias"]
    y = y / (1 + torch.exp(-2 * GELU_C * (y + 0.044715 * y ** 3)))
    y = _prod(y, p["mlp_out_kernel"], passes) + p["mlp_out_bias"]
    return (x2 + y).reshape(b, s, d)


def _case(b, s, d, h, r, seed):
    """Inputs as chip_smoke.check_ft_block draws them (its block_params)."""
    gen = torch.Generator().manual_seed(seed)
    p = smoke.block_params(d, r, gen, "cpu")
    x = torch.from_numpy(np.random.default_rng(seed).normal(
        size=(b, s, d)).astype(np.float32))
    return x, p, ft_block.block_math(x, p, h)


def _ok(got, want) -> bool:
    return bool(torch.isfinite(got).all()) and bool(
        ((got - want).abs()
         <= smoke.F32_ATOL + smoke.F32_RTOL * want.abs()).all())


# check_ft_block's edge shapes and the path's shape, B cut to MAX_B (and
# the shapes that then repeat taken once)
SHAPES = list(dict.fromkeys(
    (min(b, MAX_B), s, d, h, r)
    for b, s, d, h, r in (*smoke.FT_BLOCK_EDGE_SHAPES, smoke.FT_BLOCK_SHAPE)))


@pytest.mark.parametrize("b,s,d,h,r", SHAPES)
def test_three_pass_split_meets_the_chip_tolerance(b, s, d, h, r):
    x, p, want = _case(b, s, d, h, r, seed=1000 * s + d + r)
    assert _ok(model_block(x, p, h), want)


@pytest.mark.parametrize("passes", [1, 2])
def test_fewer_passes_miss_it_at_the_path_shape(passes):
    b, s, d, h, r = smoke.FT_BLOCK_SHAPE
    x, p, want = _case(MAX_B, s, d, h, r, seed=31)
    assert _ok(model_block(x, p, h, passes=3), want)
    assert not _ok(model_block(x, p, h, passes=passes), want)
