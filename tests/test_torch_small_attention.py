"""The port's small-token attention (shifu_tpu_torch/ops/small_attention.py)
and `mha` against the JAX package's: the Pallas kernels
(shifu_tpu/ops/pallas_small_attention.py, forward and backward) in
interpret mode on the CPU, and `ops/attention.mha`.

On the CPU the port's wrappers run the kernels' plain PyTorch twins; the
CUDA kernels themselves are held against those twins on the card by
chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from shifu_tpu.ops import attention as jax_attention
from shifu_tpu.ops import pallas_small_attention as jax_sa
from shifu_tpu_torch.ops import attention
from shifu_tpu_torch.ops import small_attention as sa

# f32: same math, summation order only
F32_TOL = 1e-5
# bf16 output: both round an f32 result once; they may land one bf16 ulp
# (2^-7 relative) apart
BF16_RTOL = 2.0 ** -7


def _qkv(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("shape", [(3, 2, 9, 8), (2, 1, 16, 16),
                                   (4, 3, 5, 3)])
def test_plain_matches_pallas_interpret_f32(shape):
    q, k, v = _qkv(shape, sum(shape))
    want = np.asarray(jax_sa.small_token_attention(
        *(jnp.asarray(t) for t in (q, k, v)), use_pallas=True))
    got = sa.small_token_attention(*(torch.from_numpy(t) for t in (q, k, v)))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=F32_TOL, atol=F32_TOL)


def test_plain_matches_pallas_interpret_bf16():
    q, k, v = _qkv((2, 2, 12, 8), 7)
    want = np.asarray(jax_sa.small_token_attention(
        *(jnp.asarray(t, jnp.bfloat16) for t in (q, k, v)),
        use_pallas=True).astype(jnp.float32))
    got = sa.small_token_attention(
        *(torch.from_numpy(t).to(torch.bfloat16) for t in (q, k, v)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=BF16_RTOL,
                               atol=1e-6)
    assert sa.small_token_attention.launches == 0  # CPU: no kernel


def test_explicit_scale():
    q, k, v = _qkv((2, 2, 7, 4), 11)
    want = np.asarray(jax_sa.small_token_attention(
        *(jnp.asarray(t) for t in (q, k, v)), scale=0.3, use_pallas=True))
    got = sa.small_token_attention(*(torch.from_numpy(t) for t in (q, k, v)),
                                   scale=0.3)
    np.testing.assert_allclose(got.numpy(), want, rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mha_matches_jax(dtype):
    q, k, v = _qkv((2, 4, 10, 8), 13)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    want = np.asarray(jax_attention.mha(
        *(jnp.asarray(t, jdt) for t in (q, k, v))).astype(jnp.float32))
    got = attention.mha(*(torch.from_numpy(t).to(tdt) for t in (q, k, v)))
    assert got.dtype == tdt
    # bf16: scores and the second product round to bf16 on both sides, at
    # places the two frameworks choose; allow a few bf16 ulps
    tol = F32_TOL if dtype == "float32" else 4 * BF16_RTOL
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


@pytest.mark.parametrize("s", [1, 9, 31, 64, 65])
@pytest.mark.parametrize("d", [1, 8, 16, 17])
@pytest.mark.parametrize("h", [1, 8, 16])
def test_applicability_gate_matches_jax(s, d, h):
    assert (sa.small_attention_applicable(s, d, h)
            == jax_sa.small_attention_applicable(s, d, h))


def test_kill_switch(monkeypatch):
    """The JAX package's kill switch does not reach the port: the gate
    tests shape only, so the unfused block keeps taking the kernel."""
    monkeypatch.setenv("SHIFU_TPU_NO_SMALL_ATTENTION", "1")
    assert sa.small_attention_applicable(31, 8, 8)
    assert not jax_sa.small_attention_applicable(31, 8, 8)


def test_bad_inputs_raise():
    q = torch.zeros(2, 2, 4, 4)
    with pytest.raises(ValueError):
        sa.small_token_attention(q[0], q[0], q[0])        # rank 3
    with pytest.raises(ValueError):
        sa.small_token_attention(q.to("meta"), q.to("meta"), q.to("meta"))


# -- backward ---------------------------------------------------------------

@pytest.mark.parametrize("shape", [(3, 2, 9, 8), (2, 1, 33, 16),
                                   (4, 3, 5, 3), (2, 2, 1, 4)])
def test_bwd_plain_matches_pallas_interpret_f32(shape):
    q, k, v = _qkv(shape, 40 + sum(shape))
    g = np.random.default_rng(sum(shape)).normal(size=shape).astype(
        np.float32)
    scale = shape[-1] ** -0.5
    want = jax_sa._run_bwd(*(jnp.asarray(t) for t in (q, k, v, g)), scale,
                           True)
    got = sa.small_attention_bwd_plain(
        *(torch.from_numpy(t) for t in (q, k, v, g)), scale)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=F32_TOL,
                                   atol=F32_TOL, err_msg=name)


def test_bwd_plain_matches_pallas_interpret_bf16():
    shape = (3, 2, 12, 8)
    q, k, v = _qkv(shape, 21)
    g = np.random.default_rng(22).normal(size=shape).astype(np.float32)
    bf = [torch.from_numpy(t).to(torch.bfloat16) for t in (q, k, v, g)]
    want = jax_sa._run_bwd(
        *(jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in bf),
        8 ** -0.5, True)
    got = sa.small_attention_bwd(*bf, 8 ** -0.5)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.bfloat16
        # both sum in f32 and round once to bf16: one bf16 ulp apart at most
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(b.astype(jnp.float32)),
                                   rtol=BF16_RTOL, atol=1e-6, err_msg=name)
    assert sa.small_attention_bwd.launches == 0  # CPU: no kernel


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_autograd_grads_match_jax_vjp(dtype):
    """The autograd function's gradients against `jax.vjp` of the JAX
    wrapper with the Pallas kernels forced (interpret mode)."""
    shape = (5, 2, 11, 4)
    q, k, v = _qkv(shape, 31)
    g = np.random.default_rng(32).normal(size=shape).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    ts = [torch.from_numpy(t).to(tdt).requires_grad_(True)
          for t in (q, k, v)]
    tg = torch.from_numpy(g).to(tdt)
    out = sa.small_token_attention(*ts)
    got = torch.autograd.grad(out, ts, tg)
    jout, vjp = jax.vjp(
        lambda a, b, c: jax_sa.small_token_attention(a, b, c,
                                                     use_pallas=True),
        *(jnp.asarray(t.detach().float().numpy(), jdt) for t in ts))
    want = vjp(jnp.asarray(tg.float().numpy(), jdt))
    tol = (dict(rtol=F32_TOL, atol=F32_TOL) if dtype == "float32"
           else dict(rtol=BF16_RTOL, atol=1e-6))
    np.testing.assert_allclose(out.detach().float().numpy(),
                               np.asarray(jout.astype(jnp.float32)), **tol)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == tdt
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(b.astype(jnp.float32)),
                                   err_msg=name, **tol)


def test_bwd_bad_device_raises():
    q = torch.zeros(2, 2, 4, 4, device="meta")
    with pytest.raises(ValueError):
        sa.small_attention_bwd(q, q, q, q, 0.5)
