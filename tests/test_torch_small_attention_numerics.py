"""The rounding argument of the tensor-core small-attention kernels
(kernels #2 and #3, shifu_tpu_torch/csrc/small_attention.cu), modelled in
PyTorch on the CPU.

The kernels feed the tensor cores 16-bit operands and sum in f32.  Q K^T
and dO V^T take the inputs as they are.  P and dS, computed in f32, go in
as 16-bit parts: part 0 is x rounded, each next part the rest rounded.
The backward's P and dS take two parts; in f16 dS's second part is scaled
by 2^11 into an accumulator of its own.  The forward's P takes three parts
for bf16 inputs and two otherwise.  f32 inputs go in as bf16 hi + lo
parts, three products each (hi hi, hi lo, lo hi).  The softmax takes one
pass over every key of a row (exp2 of s c - max c, c = |scale| log2 e); the
backward walks the query rows in 16-row m-tiles and sums dk and dv over
them.  The model below does the same roundings, and is held to
chip_smoke.py's tolerances against the plain versions
(`small_attention_plain`, `small_attention_bwd_plain`), which the card
holds the kernels to, at the edge shapes of chip_smoke's checks (batch cut
to 2) and at the training path's shape (batch cut to 1024).

Two contrasts tell the designs apart at the path's shape, in bf16: P and
dS rounded once to bf16 miss every tolerance, the forward's and the three
gradients'; and two parts of P miss the forward's, where an output cancels
towards 0 under the one-ulp tolerance's absolute floor of 1e-6 (a few
outputs in a million), while two parts of P and dS meet the gradients'.

These tests check the rounding argument, not the kernels: nothing ties the
model to the CUDA code, and only chip_smoke.py's checks hold the kernels
themselves.  The model is not on any path: nothing in the package calls
it.
"""

import importlib.util
import math
import pathlib

import numpy as np
import pytest
import torch

from shifu_tpu_torch.ops import small_attention as sa

_ROOT = pathlib.Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               _ROOT / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)

LOG2E = 1.0 / math.log(2.0)
F16_LO_SCALE = 2.0 ** 11
M_TILE = 16
# the path's shape, cut in batch from 8192
PATH = (1024,) + tuple(smoke.SMALL_ATTN_SHAPE[1:])


def _mma_type(dtype):
    return torch.float16 if dtype == torch.float16 else torch.bfloat16


def _parts(x, e, n, lo_scale=1.0):
    """x (f32) as n parts in the 16-bit type e, as f32 values: part 0 is x
    rounded, each next one the rest rounded (times lo_scale, undone)."""
    out, rest = [], x
    for i in range(n):
        sc = 1.0 if i == 0 else lo_scale
        part = (rest * sc).to(e).float() / sc
        out.append(part)
        rest = rest - part
    return out


def _operand(x):
    """An input as the tensor cores see it: itself, or bf16 hi + lo."""
    if x.dtype == torch.float32:
        return _parts(x, torch.bfloat16, 2)
    return [x.float()]


def _t(op):
    return [p.transpose(-1, -2) for p in op]


def _prod_inputs(a, b):
    """a @ b of two inputs: hi hi, plus hi lo and lo hi for f32; f32 sums."""
    out = a[0] @ b[0]
    if len(b) > 1:
        out = out + a[0] @ b[1]
    if len(a) > 1:
        out = out + a[1] @ b[0]
    return out


def _prod_computed(a, b):
    """a @ b of P or dS (its parts) and an input: every part times b's hi,
    plus a's first part times b's lo for f32."""
    out = sum(p @ b[0] for p in a)
    if len(b) > 1:
        out = out + a[0] @ b[1]
    return out


def _softmax(q, k, scale):
    """p = exp2(s c - max c) over the row's keys and its sum l (f32)."""
    c = abs(scale) * LOG2E
    sgn = -1.0 if scale < 0 else 1.0
    s = _prod_inputs([sgn * p for p in _operand(q)], _t(_operand(k)))
    p = torch.exp2(s * c - s.amax(-1, keepdim=True) * c)
    return p, p.sum(-1, keepdim=True)


def fwd_parts(dtype) -> int:
    """P's parts in the forward kernel (kPParts in small_attention.cu)."""
    return 3 if dtype == torch.bfloat16 else 2


def model_fwd(q, k, v, scale, p_parts):
    p, l = _softmax(q, k, scale)
    acc = _prod_computed(_parts(p, _mma_type(q.dtype), p_parts),
                         _operand(v))
    return (acc / l).to(q.dtype)


def model_bwd(q, k, v, g, scale, parts=2):
    e = _mma_type(q.dtype)
    lo_scale = F16_LO_SCALE if q.dtype == torch.float16 else 1.0
    qo, ko, vo, go = (_operand(t) for t in (q, k, v, g))
    p, l = _softmax(q, k, scale)
    w = p * (1.0 / l)
    dp = _prod_inputs(go, _t(vo))
    row = (w * dp).sum(-1, keepdim=True)
    ds = w * (dp - row)
    dsp = _parts(ds, e, parts, lo_scale)
    wp = _parts(w, e, parts)
    dq = _prod_computed(dsp, ko) * scale
    dk = torch.zeros(k.shape)
    dv = torch.zeros(v.shape)
    for r0 in range(0, q.shape[-2], M_TILE):  # the m-tiles, in order
        rows = slice(r0, r0 + M_TILE)
        dk = dk + _prod_computed(_t([x[..., rows, :] for x in dsp]),
                                 [x[..., rows, :] for x in qo])
        dv = dv + _prod_computed(_t([x[..., rows, :] for x in wp]),
                                 [x[..., rows, :] for x in go])
    return tuple(t.to(q.dtype) for t in (dq, dk * scale, dv))


def _misses(got, want, atol, rtol) -> int:
    got, want = got.float(), want.float()
    if not bool(torch.isfinite(got).all()):
        return got.numel()
    return int(((got - want).abs() > atol + rtol * want.abs()).sum())


def _out_misses(out, want) -> int:
    """chip_smoke.check_small_attention's tolerance."""
    if want.dtype == torch.float32:
        return _misses(out, want, smoke.F32_ATOL, smoke.F32_RTOL)
    ulp = 2.0 ** -7 if want.dtype == torch.bfloat16 else 2.0 ** -10
    return _misses(out, want, smoke.BF16_ATOL, ulp)


def _grad_misses(got, want) -> int:
    """chip_smoke.check_grad's tolerance."""
    frac, rtol, _ = smoke.grad_tolerance(want.dtype)
    atol = (smoke.F32_ATOL if want.dtype == torch.float32
            else frac * float(want.float().abs().max()) + 1e-12)
    return _misses(got, want, atol, rtol)


def _inputs(b, h, s, d, dtype, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=(b, h, s, d))
                             .astype(np.float32)).to(dtype)
            for _ in range(4)]


def _fwd_misses(q, k, v, scale, p_parts) -> int:
    return _out_misses(model_fwd(q, k, v, scale, p_parts),
                       sa.small_attention_plain(q, k, v, scale))


def _bwd_misses(q, k, v, g, scale, parts=2) -> dict:
    got = model_bwd(q, k, v, g, scale, parts)
    want = sa.small_attention_bwd_plain(q, k, v, g, scale)
    return {n: _grad_misses(x, y)
            for n, x, y in zip(("dq", "dk", "dv"), got, want)}


def _cut(shapes):
    return [(min(b, 2), h, s, d, getattr(torch, dt))
            for b, h, s, d, dt in shapes]


@pytest.mark.parametrize("b,h,s,d,dtype",
                         _cut(smoke.SMALL_ATTN_EDGE_SHAPES))
def test_forward_model_meets_the_chip_tolerance(b, h, s, d, dtype):
    q, k, v, _ = _inputs(b, h, s, d, dtype, seed=1000 * s + d)
    assert _fwd_misses(q, k, v, d ** -0.5, fwd_parts(dtype)) == 0


@pytest.mark.parametrize("b,h,s,d,dtype",
                         _cut(smoke.SMALL_ATTN_BWD_EDGE_SHAPES))
def test_backward_model_meets_the_chip_tolerance(b, h, s, d, dtype):
    q, k, v, g = _inputs(b, h, s, d, dtype, seed=1000 * s + d)
    misses = _bwd_misses(q, k, v, g, d ** -0.5)
    assert not any(misses.values()), misses


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
def test_model_meets_the_chip_tolerance_at_the_path_shape(dtype):
    q, k, v, g = _inputs(*PATH, dtype, seed=31)
    scale = PATH[-1] ** -0.5
    assert _fwd_misses(q, k, v, scale, fwd_parts(dtype)) == 0
    misses = _bwd_misses(q, k, v, g, scale)
    assert not any(misses.values()), misses


def test_negative_scale_takes_the_max_of_the_scaled_scores():
    q, k, v, _ = _inputs(3, 2, 33, 8, torch.bfloat16, seed=7)
    assert _fwd_misses(q, k, v, -0.4, fwd_parts(torch.bfloat16)) == 0


def test_two_parts_of_p_miss_the_bf16_forward_at_the_path_shape():
    q, k, v, g = _inputs(*PATH, torch.bfloat16, seed=31)
    scale = PATH[-1] ** -0.5
    assert _fwd_misses(q, k, v, scale, 2) > 0
    assert _fwd_misses(q, k, v, scale, 3) == 0
    # the gradients' tolerance scales with the tensor's largest value, and
    # two parts of P and dS meet it
    assert not any(_bwd_misses(q, k, v, g, scale, 2).values())


def test_rounding_p_and_ds_once_misses_them_at_the_path_shape():
    q, k, v, g = _inputs(*PATH, torch.bfloat16, seed=31)
    scale = PATH[-1] ** -0.5
    assert _fwd_misses(q, k, v, scale, 1) > 0
    misses = _bwd_misses(q, k, v, g, scale, 1)
    assert all(misses.values()), misses
