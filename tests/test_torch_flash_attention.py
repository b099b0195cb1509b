"""The port's flash attention (shifu_tpu_torch/ops/flash_attention.py)
against the JAX package's Pallas kernels (shifu_tpu/ops/pallas_attention.py:
`_flash_fwd_impl`, `_flash_bwd_impl` and the custom-VJP wrapper) run in
interpret mode on the CPU with 32-row blocks, at S = 9, 33 and 70 (70 is
ragged: the JAX wrapper pads it to 96).

On the CPU the port's wrappers run the kernels' plain PyTorch twins; the
CUDA kernels themselves are held against those twins on the card by
chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from shifu_tpu.ops import pallas_attention as jax_fa
from shifu_tpu_torch.ops import flash_attention as fa

# f32: the same math, other summation orders and block boundaries
F32_TOL = 1e-5
# gradients sum S terms per element in both; a little looser than outputs
GRAD_TOL = 2e-5
# bf16: both round an f32 result once; one bf16 ulp apart at most
BF16_RTOL = 2.0 ** -7
BLOCK = 32


def _inputs(shape, seed, n=4):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(n)]


@pytest.mark.parametrize("s", [9, 33, 70])
@pytest.mark.parametrize("d", [4, 16])
def test_fwd_plain_matches_pallas_interpret(s, d):
    q, k, v = _inputs((2, 3, s, d), s + d, 3)
    scale = d ** -0.5
    want_out, want_lse = jax_fa._flash_fwd_impl(
        *(jnp.asarray(t) for t in (q, k, v)), scale, True, BLOCK, BLOCK)
    out, lse = fa.flash_fwd(*(torch.from_numpy(t) for t in (q, k, v)), scale)
    assert out.dtype == torch.float32 and lse.shape == (2, 3, s)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out),
                               rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(lse.numpy(),
                               np.asarray(want_lse)[:, :, :s, 0],
                               rtol=F32_TOL, atol=F32_TOL)
    assert fa.flash_fwd.launches == 0  # CPU: no kernel


@pytest.mark.parametrize("s", [9, 33, 70])
def test_bwd_plain_matches_pallas_interpret(s):
    q, k, v, g = _inputs((2, 2, s, 8), 100 + s)
    scale = 8 ** -0.5
    jq, jk, jv, jg = (jnp.asarray(t) for t in (q, k, v, g))
    jout, jlse = jax_fa._flash_fwd_impl(jq, jk, jv, scale, True, BLOCK,
                                        BLOCK)
    want = jax_fa._flash_bwd_impl(jq, jk, jv, jout, jlse, jg, scale, True,
                                  BLOCK, BLOCK)
    tq, tk, tv, tg = (torch.from_numpy(t) for t in (q, k, v, g))
    out, lse = fa.flash_fwd(tq, tk, tv, scale)
    got = fa.flash_bwd(tq, tk, tv, out, lse, tg, scale)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=name)
    # the two kernels' plain twins compose to the same backward
    dres = fa.flash_dres(out, tg)
    dq = fa.flash_bwd_dq(tq, tk, tv, tg, lse, dres, scale)
    dk, dv = fa.flash_bwd_dkv(tq, tk, tv, tg, lse, dres, scale)
    for a, b in zip((dq, dk, dv), got):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert fa.flash_bwd_dq.launches == fa.flash_bwd_dkv.launches == 0


@pytest.mark.parametrize("s", [9, 33, 70])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_autograd_matches_jax_vjp(s, dtype):
    """`flash_attention` and its gradients against `jax.vjp` of the JAX
    wrapper with the kernels forced (interpret mode, 32-row blocks)."""
    q, k, v, g = _inputs((2, 2, s, 8), 200 + s)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    ts = [torch.from_numpy(t).to(tdt).requires_grad_(True)
          for t in (q, k, v)]
    tg = torch.from_numpy(g).to(tdt)
    out = fa.flash_attention(*ts)
    got = torch.autograd.grad(out, ts, tg)
    jout, vjp = jax.vjp(
        lambda a, b, c: jax_fa.flash_attention(
            a, b, c, use_pallas=True, block_q=BLOCK, block_k=BLOCK),
        *(jnp.asarray(t.detach().float().numpy(), jdt) for t in ts))
    want = vjp(jnp.asarray(tg.float().numpy(), jdt))
    out_tol = (dict(rtol=F32_TOL, atol=F32_TOL) if dtype == "float32"
               else dict(rtol=BF16_RTOL, atol=1e-6))
    np.testing.assert_allclose(out.detach().float().numpy(),
                               np.asarray(jout.astype(jnp.float32)),
                               **out_tol)
    grad_tol = (dict(rtol=GRAD_TOL, atol=GRAD_TOL) if dtype == "float32"
                else dict(rtol=BF16_RTOL, atol=1e-5))
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == tdt
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(b.astype(jnp.float32)),
                                   err_msg=name, **grad_tol)


def test_plain_chunks_agree_with_one_pass(monkeypatch):
    """The plain versions form the S x S scores a chunk of (sample, head)
    rows at a time; the chunking changes no value."""
    q, k, v, g = (torch.from_numpy(t) for t in _inputs((3, 2, 17, 4), 5))
    monkeypatch.setitem(fa._PLAIN_CHUNK_BYTES, "cpu", 1 << 30)  # one pass
    whole_fwd = fa.flash_fwd_plain(q, k, v, 0.5)
    whole_bwd = fa.flash_bwd_plain(q, k, v, *whole_fwd, g, 0.5)
    monkeypatch.setitem(fa._PLAIN_CHUNK_BYTES, "cpu", 17 * 17 * 4)  # 1 row
    for a, b in zip((*fa.flash_fwd_plain(q, k, v, 0.5),
                     *fa.flash_bwd_plain(q, k, v, *whole_fwd, g, 0.5)),
                    (*whole_fwd, *whole_bwd)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_matches_small_attention_where_both_apply():
    """At S <= 64 the two attention routes compute the same function."""
    from shifu_tpu_torch.ops.small_attention import small_attention_plain
    q, k, v = (torch.from_numpy(t) for t in _inputs((4, 2, 31, 8), 6, 3))
    torch.testing.assert_close(fa.flash_attention(q, k, v),
                               small_attention_plain(q, k, v, 8 ** -0.5),
                               rtol=F32_TOL, atol=F32_TOL)


def test_bad_inputs_raise():
    q = torch.zeros(2, 2, 4, 4)
    with pytest.raises(ValueError):
        fa.flash_attention(q[0], q[0], q[0])                # rank 3
    m = q.to("meta")
    with pytest.raises(ValueError):
        fa.flash_attention(m, m, m)                         # no kernel there
    for fn in (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv):
        with pytest.raises(ValueError):
            fn(*([m] * (3 if fn is fa.flash_fwd else 6)), 0.5)


def test_cuda_envelope_is_checked_before_any_launch():
    """The CUDA checks refuse what the kernels cannot take (head dim over
    128, mixed dtypes, non-contiguous operands) without a card: the check
    runs on the tensors' metadata."""
    q = torch.zeros(1, 1, 4, 129)
    with pytest.raises(ValueError, match="D <= 128"):
        fa._check("flash_fwd", q, q, q)
    with pytest.raises(ValueError, match="match q"):
        fa._check("flash_fwd", q[..., :8], q[..., :8].double(), q[..., :8])
    with pytest.raises(ValueError, match="contiguous"):
        t = torch.zeros(1, 1, 8, 4).transpose(2, 3)
        fa._check("flash_fwd", t, t, t)
    with pytest.raises(TypeError):
        t = torch.zeros(1, 1, 4, 4, dtype=torch.float64)
        fa._check("flash_fwd", t, t, t)
    with pytest.raises(ValueError, match="f32"):
        fa._check_vec("flash_bwd_dq", torch.zeros(1, 1, 4, 4),
                      torch.zeros(1, 1, 4, dtype=torch.float16))
