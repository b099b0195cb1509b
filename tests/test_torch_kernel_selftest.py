"""The kernels' selftest (`shifu_tpu_torch.ops.selftest`) on the CPU.

- every launch counter has cases, small and full-width, and every case lies
  inside its wrapper's gate;
- the branches each launcher picks have a case, read from the case shapes
  against the constants the wrappers expose (`ft_block.MAX_TOKENS`,
  `small_attention.MAX_S`, `flash_attention.MAX_D`,
  `int8_matmul.MAX_FEATURES`, ...) and the launchers' rules the selftest
  states;
- `main(["--device", "cpu"])` runs every case through the plain versions
  and exits 0; the default device, cuda:0, raises where there is no CUDA;
- each case's plain output against the JAX package's reference on the same
  inputs, at the tolerances of the kernels' existing tests
  (test_torch_ft_block.py, test_torch_small_attention.py,
  test_torch_int8_matmul.py, test_torch_embedding.py,
  test_torch_flash_attention.py).  JAX's gates refuse no case; what JAX is
  given in place of the case's own inputs is said where it is.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from shifu_tpu.ops import pallas_attention as jax_fa
from shifu_tpu.ops import pallas_embedding as jax_emb
from shifu_tpu.ops import pallas_ft_block as jax_ftb
from shifu_tpu.ops import pallas_int8_matmul as jax_i8
from shifu_tpu.ops import pallas_small_attention as jax_sa
from shifu_tpu_torch import ops
from shifu_tpu_torch.ops import embedding as emb
from shifu_tpu_torch.ops import flash_attention as fa
from shifu_tpu_torch.ops import ft_block
from shifu_tpu_torch.ops import int8_matmul as i8
from shifu_tpu_torch.ops import selftest as st
from shifu_tpu_torch.ops import small_attention as sa

CPU = torch.device("cpu")
KERNELS = sorted(st.RUNNERS)


def _small(kernel):
    return st.select([kernel])


def test_every_counter_has_small_and_full_cases():
    assert set(ops.launch_counters()) == set(st.RUNNERS)
    assert {c.kernel for c in st.select()} == set(KERNELS)
    full = [c for c in st.CASES if c.full]
    assert sorted(c.kernel for c in full) == KERNELS


def _inside_gate(c) -> bool:
    if c.kernel == "ft_block":
        b, s, d, h, r = c.shape
        return ft_block.ft_block_applicable(s, d, h, r)
    if c.kernel.startswith("small_attention"):
        b, h, s, d = c.shape
        return (sa.small_attention_applicable(s, d, h) and 0 < s <= sa.MAX_S
                and 0 < d <= sa.MAX_D)
    if c.kernel.startswith("flash"):
        return c.shape[2] >= 1 and 0 < c.shape[3] <= fa.MAX_D
    if c.kernel == "int8_matmul":
        return i8.int8_available(*c.shape[1:])
    if c.kernel == "rows_update":
        return emb.fused_update_available(c.shape[3])
    return c.shape[3] >= 1  # the lookup takes any D


@pytest.mark.parametrize("full", [False, True])
def test_every_case_lies_inside_its_gate(full):
    cases = [c for c in st.CASES if c.full == full]
    assert cases
    outside = [c.label for c in cases if not _inside_gate(c)]
    assert not outside


def test_ft_block_branches():
    cases = _small("ft_block")
    shapes = [c.shape for c in cases]
    # KS = D / 16 rounded up takes every value to MAX_TOKEN_DIM / 16, so
    # both warp plans (two warps an m-tile for KS <= 4, one above); each KS
    # with the kernel's three attention cases: dh 8, 16 and another
    ks_dh = {(-(-d // 16), d // h if d // h in (8, 16) else 0)
             for _b, _s, d, h, _r in shapes}
    assert ks_dh == {(ks, dh) for ks in range(1, ft_block.MAX_TOKEN_DIM // 16
                                              + 1) for dh in (8, 16, 0)}
    assert {d for _b, _s, d, _h, _r in shapes if d % 16} >= {8, 24}
    assert (24, 4) in {(d, h) for _b, _s, d, h, _r in shapes}  # dh = 6
    assert {s for _b, s, _d, _h, _r in shapes} >= {1, 5, 31,
                                                     ft_block.MAX_TOKENS}
    assert {r for *_x, r in shapes} >= {1, 4, ft_block.MAX_MLP_RATIO}
    assert {c.dtype for c in cases} == {"float32", "bfloat16"}
    # several samples a CTA with one left for the last; and at S = 1 the
    # rows are samples: rows = 1 mod rows_cap(D)
    assert any(st.ft_samples_per_cta(b, s, d) > 1
               and b % st.ft_samples_per_cta(b, s, d) == 1
               for b, s, d, _h, _r in shapes)
    assert any(s == 1 and b % st.ft_rows_cap(d) == 1
               and st.ft_samples_per_cta(b, s, d) == st.ft_rows_cap(d)
               for b, s, d, _h, _r in shapes)
    assert st.ft_rows_cap(64) == 128 and st.ft_rows_cap(128) == 80


@pytest.mark.parametrize("kernel", ["small_attention", "small_attention_bwd"])
def test_small_attention_branches(kernel):
    cases = _small(kernel)
    # every instantiation: D <= 8 or <= 16, S <= 32 or <= 64, three dtypes
    buckets = {(8 if d <= 8 else 16, 32 if s <= 32 else 64, c.dtype)
               for c in cases for _b, _h, s, d in [c.shape]}
    assert buckets == {(dp, sp, dt) for dp in (8, sa.MAX_D)
                       for sp in (32, sa.MAX_S)
                       for dt in ("float32", "bfloat16", "float16")}
    assert {c.shape[2] for c in cases} >= {1, 7, 31, 64}
    assert {c.shape[3] for c in cases} >= {5, 8, 16}
    # f32 (the split path); 16-bit with 16-byte copies (D 8 or 16,
    # aligned) and with element loads (another D, or misaligned)
    vec = [c for c in cases if c.dtype != "float32" and c.shape[3] in (8, 16)
           and "misaligned" not in c.opts]
    elem = [c for c in cases if c.dtype != "float32"
            and (c.shape[3] not in (8, 16) or "misaligned" in c.opts)]
    assert vec and elem and any(c.dtype == "float32" for c in cases)
    assert any("misaligned" in c.opts and c.shape[3] in (8, 16)
               for c in cases)
    # whole warps idle in the last CTA (4 warps, a group each), and more
    # groups than a wave of warps holds
    assert any(c.shape[0] * c.shape[1] % 4 for c in cases)
    assert max(c.shape[0] * c.shape[1] for c in cases) >= 9000


def test_int8_branches():
    cases = _small("int8_matmul")
    fits_panel = [c for c in cases if c.shape[1] <= 64
                  and c.shape[2] <= 128 and c.shape[0] > 0]
    panel = [c for c in fits_panel if "misaligned" not in c.opts]
    by_alignment = [c for c in fits_panel if "misaligned" in c.opts]
    tiled = [c for c in cases if c.shape[1] > 64 and c.shape[2] > 128]
    assert any(c.shape[0] % 64 == 1 for c in panel)
    assert by_alignment and all(c.shape[1] % 16 for c in by_alignment)
    assert any(m % 128 == 1 and f % 64 and n % 128
               for m, f, n in (c.shape for c in tiled))
    for group in (panel, tiled):
        assert {c.dtype for c in group} == {"float32", "bfloat16", "float16"}
        assert {"offset" in c.opts for c in group} == {False, True}
    assert any(c.shape[0] == 0 for c in cases)
    assert all(c.shape[1] <= i8.MAX_FEATURES and c.shape[2] <= i8.MAX_OUT
               for c in cases)


def test_lookup_branches():
    cases = _small("embedding_lookup")
    assert {(c.shape[3], c.dtype) for c in cases} >= {
        (d, dt) for d in (16, 17) for dt in ("float32", "bfloat16")}
    assert min(c.shape[3] for c in cases) == 1
    assert all(c.shape[0] % 256 for c in cases)  # B off a block's share
    for c in cases:
        ids = st.prepare(c, CPU).inputs["ids"]
        v = c.shape[2]
        assert 0 in ids and v - 1 in ids
    edge = [c for c in cases if "edge" in c.opts]
    assert edge
    ids = st.prepare(edge[0], CPU).inputs["ids"]
    v = edge[0].shape[2]
    assert ((ids < 0) & (ids >= -v)).any() and ((ids >= v) | (ids < -v)).any()


def test_rows_update_branches():
    cases = _small("rows_update")
    assert {c.opts for c in cases} >= {(r, i) for r in ("sgd", "adadelta")
                                       for i in ("unique", "raw")}
    # 4-, 2- and 1-element accesses
    assert {4 if d % 4 == 0 else 2 if d % 2 == 0 else 1
            for d in (c.shape[3] for c in cases)} == {1, 2, 4}
    assert {c.shape[3] for c in cases} >= {16, 17}
    assert all(emb.fused_update_available(c.shape[3]) for c in cases)
    for c in cases:
        ids = st.prepare(c, CPU).inputs["ids"]
        v = c.shape[2]
        assert (ids == -1).any() and (ids == v).any()  # skipped
        inside = [ids[:, f][(ids[:, f] >= 0) & (ids[:, f] < v)]
                  for f in range(ids.shape[1])]
        unique = all(len(x) == len(torch.unique(x)) for x in inside)
        assert unique == ("unique" in c.opts)


@pytest.mark.parametrize("kernel", ["flash_fwd", "flash_bwd_dq",
                                    "flash_bwd_dkv"])
def test_flash_branches(kernel):
    cases = _small(kernel)
    assert {c.shape[2] for c in cases} >= {1, 37, 1001}
    assert {c.shape[3] for c in cases} >= {5, 8, 16, 64, fa.MAX_D}
    # every instantiation: the head-dim buckets by the three dtypes
    buckets = {(next(x for x in (8, 16, 32, 64, 128) if c.shape[3] <= x),
                c.dtype) for c in cases}
    assert buckets == {(x, dt) for x in (8, 16, 32, 64, fa.MAX_D)
                       for dt in ("float32", "bfloat16", "float16")}
    for s in (1, 37, 1001):
        assert {c.dtype for c in cases if c.shape[2] == s} >= {
            "float32", "bfloat16"}
    assert all(c.shape[0] * c.shape[1] % 2 for c in cases)


def test_main_runs_every_case_on_the_cpu(capsys):
    before = {n: f.launches for n, f in ops.launch_counters().items()}
    assert st.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert sum(ln.startswith("ok ") for ln in out) == len(st.select())
    assert sum(ln.startswith("launches: ") for ln in out) == len(KERNELS)
    # the CPU runs the plain versions: no counter moves
    assert {n: f.launches for n, f in ops.launch_counters().items()} == before


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        st.main([])


def test_options(capsys):
    assert st.main(["--list", "--full"]) == 0
    assert len(capsys.readouterr().out.splitlines()) == len(st.CASES)
    assert st.main(["--device", "cpu", "--kernel", "rows_update",
                    "--repeat"]) == 0
    with pytest.raises(ValueError, match="CUDA"):
        st.main(["--device", "cpu", "--guard"])


def test_check_fails_out_of_tolerance():
    case = st.select(["flash_fwd"])[0]
    want = torch.ones(4)
    assert st._check(case, st.Out("o", want.clone(), want)) == 0.0
    with pytest.raises(st.SelftestError, match="exceeds"):
        st._check(case, st.Out("o", want + 1e-3, want))
    with pytest.raises(st.SelftestError, match="non-finite"):
        st._check(case, st.Out("o", want * float("nan"), want))
    bitwise = st.select(["rows_update"])[0]
    with pytest.raises(st.SelftestError, match="bitwise"):
        st._check(bitwise, st.Out("o", want + 2 ** -20, want))


# -- the plain outputs against the JAX package ---------------------------------

def _j(t: torch.Tensor):
    """A torch tensor as a JAX array of the same dtype (exactly)."""
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    return jnp.asarray(t.numpy())


def _np(a) -> np.ndarray:
    a = jnp.asarray(a)
    return np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16
                      else a)


def _t(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _close(got, want, rtol, atol, what):
    np.testing.assert_allclose(_t(got), _np(want), rtol=rtol, atol=atol,
                               err_msg=what)


# 16-bit tolerances of the existing tests: one ulp relative
ULP = {"bfloat16": 2.0 ** -7, "float16": 2.0 ** -10}


def _vs_ft_block(case, prep, want):
    x, p, h = prep.inputs["x"], prep.inputs["p"], prep.inputs["heads"]
    ref = jax.jit(functools.partial(jax_ftb._block_math, s_real=x.shape[1],
                                    heads=h))(
        _j(x.float()), {k: _j(v) for k, v in p.items()})
    if case.dtype == "float32":  # test_torch_ft_block.TOL
        _close(want[0], ref, 2e-5, 2e-5, case.label)
    else:  # the f32 results rounded once: one ulp apart at most
        _close(want[0], ref.astype(jnp.bfloat16), ULP[case.dtype], 2e-5,
               case.label)


def _attention_tol(case, f32_tol, inputs=None):
    """(rtol, atol) of an attention output against JAX: f32 `f32_tol`; a
    16-bit output one ulp, + 1e-6 for a forward, and for a gradient the
    selftest's own absolute term (2^-16 of the largest term its sums add:
    the two rounded outputs that feed Dres may differ by an ulp, which
    moves a cancelling dP - Dres by that much), at least the 1e-5 of the
    existing tests."""
    if case.dtype == "float32":
        return f32_tol, f32_tol
    if inputs is None:
        return ULP[case.dtype], 1e-6
    terms = st._grad_terms(case, *(inputs[n] for n in ("q", "k", "v", "g",
                                                       "scale")))
    return ULP[case.dtype], max(1e-5, terms)


def _vs_small_attention(case, prep, want):
    q, k, v, scale = (prep.inputs[n] for n in ("q", "k", "v", "scale"))
    rtol, atol = _attention_tol(case, 1e-5, None if case.kernel ==
                                "small_attention" else prep.inputs)
    if case.kernel == "small_attention":
        ref = (jax_sa._run_fwd(_j(q), _j(k), _j(v), scale, True),)
    else:
        ref = jax_sa._run_bwd(_j(q), _j(k), _j(v), _j(prep.inputs["g"]),
                              scale, True)
    for got, r in zip(want, ref):
        _close(got, r, rtol, atol, case.label)


def _vs_int8(case, prep, want):
    ins = prep.inputs
    q, w, b, scale, off = (ins[n] for n in ("q", "w", "b", "scale",
                                            "offset"))
    cdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16,
           "float16": jnp.float16}[case.dtype]
    ref = _np(jax_i8.xla_reference(_j(q), _j(w), _j(b), _j(scale),
                                   None if off is None else _j(off), cdt))
    # test_torch_int8_matmul._tol
    if case.dtype == "float32":
        tol = 1e-5 + 1e-5 * np.abs(ref)
    else:
        x = i8.dequant_plain(q, scale, off).to(ins["cdt"]).float()
        wc, bc = w.to(ins["cdt"]).float(), b.to(ins["cdt"]).float()
        tol = (ULP[case.dtype] * (2 * (x @ wc).abs() + bc.abs())
               + q.shape[1] * 2.0 ** -24 * (x.abs() @ wc.abs())
               ).numpy() + 1e-6
    assert ref.shape == tuple(want[0].shape), case.label
    assert (np.abs(_t(want[0]) - ref) <= tol).all(), case.label


def _vs_lookup(case, prep, want):
    ref = jax_emb._xla_lookup(_j(prep.inputs["table"]),
                              _j(prep.inputs["ids"]))
    got = want[0].view(torch.int32 if want[0].element_size() == 4
                       else torch.int16).numpy()
    r = np.asarray(ref)
    assert np.array_equal(got, r.view({4: np.int32, 2: np.int16}[
        r.dtype.itemsize])), case.label


def _vs_rows(case, prep, want):
    ins = prep.inputs
    v = case.shape[2]
    # the port skips ids of -1; JAX's reference would wrap them to V - 1,
    # so JAX is given V there, the sentinel both skip
    ids = torch.where(ins["ids"] < 0, v, ins["ids"])
    ref_t, ref_s = jax_emb.rows_update_reference(
        _j(ins["table"]), tuple(_j(s) for s in ins["slots"]),
        _j(ins["g_rows"]), _j(ids), ins["rule"], ins["lr"])
    rtol = 1e-5 if case.dtype == "float32" else ULP[case.dtype]
    for got, r in zip(want, (ref_t, *ref_s)):  # test_torch_embedding's
        _close(got, r, rtol, 1e-6, case.label)


_FLASH_REFS: dict = {}


def _vs_flash(case, prep, want):
    q, k, v, g, scale = (prep.inputs[n] for n in ("q", "k", "v", "g",
                                                  "scale"))
    # the three kernels of one shape share their inputs (one seed a shape):
    # one JAX forward and backward serves them
    key = (case.shape, case.dtype, case.seed)
    if key not in _FLASH_REFS:
        jq, jk, jv, jg = (_j(t) for t in (q, k, v, g))
        out, lse = jax_fa._flash_fwd_impl(jq, jk, jv, scale, True, 512, 512)
        _FLASH_REFS[key] = (out, lse, jax_fa._flash_bwd_impl(
            jq, jk, jv, out, lse, jg, scale, True, 512, 512))
    out, lse, (dq, dk, dv) = _FLASH_REFS[key]
    s = case.shape[2]
    if case.kernel == "flash_fwd":  # test_torch_flash_attention's
        rtol, atol = _attention_tol(case, 1e-5)
        _close(want[0], out, rtol, atol, case.label)
        _close(want[1], np.asarray(lse)[:, :, :s, 0], 1e-5, 1e-5, case.label)
        return
    rtol, atol = _attention_tol(case, 2e-5, prep.inputs)
    refs = (dq,) if case.kernel == "flash_bwd_dq" else (dk, dv)
    for got, r in zip(want, refs):
        _close(got, r, rtol, atol, case.label)


VERSUS = {"ft_block": _vs_ft_block, "small_attention": _vs_small_attention,
          "small_attention_bwd": _vs_small_attention,
          "int8_matmul": _vs_int8, "embedding_lookup": _vs_lookup,
          "rows_update": _vs_rows, "flash_fwd": _vs_flash,
          "flash_bwd_dq": _vs_flash, "flash_bwd_dkv": _vs_flash}


@pytest.mark.parametrize("kernel", KERNELS)
def test_plain_matches_jax(kernel):
    with jax.default_device(jax.devices("cpu")[0]):
        for case in _small(kernel):
            prep = st.prepare(case, CPU)
            with torch.no_grad():
                VERSUS[kernel](case, prep, prep.plain())
