"""The hand-written kernels' selftest: every kernel of `csrc/`, through its
public wrapper and against its plain version on the same inputs, on small
cases that reach each branch its launcher picks.

    python -m shifu_tpu_torch.ops.selftest [--device cuda:0] [--kernel NAME ...]
                                           [--list] [--full] [--guard]
                                           [--repeat]

The CUDA counterpart of the host components' -DSHIFU_SELFTEST_MAIN entries
(runtime/nativelib.build_selftest): the program a memory checker runs
(chip_smoke.py phase 27 runs it under each compute-sanitizer tool).  Each
case of `CASES` names a kernel of `ops.launch_counters()`, its shape and
dtype, a seed and a tolerance; it runs the kernel through its wrapper, so
that the launch counter moves, and the plain version on the same inputs,
and prints one line.  Then one line of launches per counter.  Exit 0, or 1
at the first case out of tolerance.

- `--device` defaults to cuda:0 and raises where there is no CUDA; with
  `--device cpu` the wrappers run their plain versions (a dry run of the
  cases).
- `--full` adds one case a kernel at its training path's full width.
- `--guard` (CUDA) puts every tensor of the process in an allocation of its
  own between guard bands, all of it filled with 0xFF
  (`csrc/tools/guard_alloc.cu`): a kernel that reads past a tensor or an
  element nothing wrote reads NaN and misses its plain version; one that
  writes past a tensor changes a guard, and the case fails.
- `--repeat` launches each case's kernel REPEAT times on the same inputs;
  the results must be bitwise equal to the first (a race that loses under
  some schedules shows as a difference).

Tolerances, per kernel and output dtype (each kernel's own reasons, as its
checks in chip_smoke.py state them): an f32 output 1e-4 + 1e-4 |ref| (the
summation order only); a bf16/f16 forward one ulp (2^-7 / 2^-10 |ref| +
1e-6); the fused block's bf16 output, an f32 result rounded, 1e-4 + (2^-7
+ 1e-4) |ref|; a bf16/f16 gradient one ulp of the element plus 2^-16 of the
largest |ref| and of the largest term its sums add (the f32 summation
order, which scales with the terms: `_grad_terms`);
#4 in bf16/f16 one ulp of 2 |x@w| + |b| plus F 2^-24 (|x| @ |w|) + 1e-6;
#5 and #6 bitwise (a gather copies; the update rounds each f32 operation
on its own in both).
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import gc
import math
import sys
import time
import types
from typing import Callable, NamedTuple, Optional, Sequence

import torch

from . import _build, launch_counters

F32 = (1e-4, 1e-4, 0.0)
REPEAT = 8  # launches of each case's kernel under --repeat
ULP = {"bfloat16": 2.0 ** -7, "float16": 2.0 ** -10}
GRADS = ("small_attention_bwd", "flash_bwd_dq", "flash_bwd_dkv")


def tolerance(kernel: str, dtype: str) -> tuple[float, float, float]:
    """(atol, rtol, atol_max): |got - ref| <= atol + rtol |ref| + atol_max
    max |ref| (module docstring); (0, 0, 0) is bitwise."""
    if kernel in ("embedding_lookup", "rows_update"):
        return 0.0, 0.0, 0.0
    if dtype == "float32":
        return F32
    ulp = ULP[dtype]
    if kernel in GRADS:
        return 1e-12, ulp, 2.0 ** -16
    if kernel == "ft_block":
        return 1e-4, ulp + 1e-4, 0.0
    return 1e-6, ulp, 0.0


@dataclasses.dataclass(frozen=True)
class Case:
    """One selftest case.  `shape` is the kernel's own: (B, S, D, H, R) for
    ft_block; (B, H, S, D) for small attention and flash; (M, F, N) for
    int8_matmul; (B, Nc, V, D) for the lookup and (U, Nc, V, D) for the
    rows update.  `opts` switch branches: "misaligned" (inputs not 16-byte
    aligned), "offset" (#4's wire offset), "edge" (#5's ids outside [0,
    V)), "sgd"/"adadelta" and "unique"/"raw" (#6's rule and ids)."""
    kernel: str
    shape: tuple
    dtype: str
    seed: int
    atol: float
    rtol: float
    atol_max: float = 0.0
    opts: tuple = ()
    full: bool = False

    @property
    def label(self) -> str:
        opts = "".join(f" {o}" for o in self.opts)
        return (f"{self.kernel} {'x'.join(map(str, self.shape))} "
                f"{self.dtype}{opts}{' full' if self.full else ''}")


class Out(NamedTuple):
    """One output of a case: the kernel's and the plain version's, and
    tolerance terms where the case's own do not apply (`tol`: (atol,
    rtol, atol_max); `mag`: what rtol multiplies, default |ref|; `extra`:
    an absolute term, a tensor or 0)."""
    name: str
    got: torch.Tensor
    want: torch.Tensor
    tol: Optional[tuple] = None
    mag: Optional[torch.Tensor] = None
    extra: object = 0.0


class Prepared(NamedTuple):
    """A case made ready: `kernel()` and `plain()` return the outputs (a
    tuple of tensors) of the wrapper and of the plain version on the same
    `inputs`; `outputs(got, want)` pairs them as `Out`s."""
    kernel: Callable
    plain: Callable
    outputs: Callable
    inputs: dict


class SelftestError(AssertionError):
    """A case out of tolerance, or a guard band written."""


# -- the cases ----------------------------------------------------------------

# #1's launcher (csrc/ft_block.cu ft_block_fwd): a CTA takes ns samples,
# ns = max(1, min(rows_cap(D) // S, ceil(B / SMs))), where rows_cap(D) is
# the largest multiple of 16 rows up to 128 whose shared-memory plan fits
# 232,448 bytes
FT_SMS = 132  # the H100's SMs
FT_SMEM_MAX = 232448
FT_SMEM_FIXED = 2 * 64 * 64 * 4 + 2 * 64 * 72 * 2


def ft_rows_cap(d: int) -> int:
    def r16(x):
        return -(-x // 16) * 16

    rows = 128
    while rows > 16 and (FT_SMEM_FIXED + rows * (r16(d) + 8 + r16(3 * d) + 8)
                         * 4) > FT_SMEM_MAX:
        rows -= 16
    return rows


def ft_samples_per_cta(b: int, s: int, d: int) -> int:
    return max(1, min(ft_rows_cap(d) // s, -(-b // FT_SMS)))


def _ft_cases() -> list:
    out = []
    # every instantiation: KS = D / 16 from 1 to 8, each with dh 8, 16 and
    # another (the kernel's three attention cases); S over 1, 5, 31, 64 and
    # R over 1, 4, 8
    s_cycle, r_cycle = (1, 5, 31, 64), (1, 4, 8)
    i = 0
    for ks in range(1, 9):
        d = 16 * ks
        for dh in (8, 16, d if ks > 1 else 4):
            out.append(("ft_block", (3, s_cycle[i % 4], d, d // dh,
                                     r_cycle[i % 3]), "float32", ()))
            i += 1
    # D off the mma's 16 (8, 24, 40), dh 6 (D = 24, H = 4), bf16 tokens
    out += [("ft_block", (3, 5, 8, 1, 4), "float32", ()),
            ("ft_block", (7, 31, 24, 4, 2), "float32", ()),
            ("ft_block", (7, 31, 24, 4, 2), "bfloat16", ()),
            ("ft_block", (5, 64, 40, 5, 8), "float32", ()),
            ("ft_block", (3, 64, 128, 16, 8), "bfloat16", ())]
    # several samples a CTA with one in the last: B = ns * 132 + 1 at the
    # path's (S, D, H, R); and S = 1, where rows are samples: B = 132
    # rows_cap(D) + 1, rows = 1 mod rows_cap(D)
    out += [("ft_block", (4 * FT_SMS + 1, 31, 64, 8, 4), "float32", ()),
            ("ft_block", (FT_SMS * ft_rows_cap(96) + 1, 1, 96, 6, 1),
             "float32", ())]
    return out


def _small_attention_cases() -> list:
    out = []
    for kernel in ("small_attention", "small_attention_bwd"):
        # B * H = 9 groups: the last CTA's 4 warps keep one, three leave
        for s in (1, 7, 31, 64):
            for d in (5, 8, 16):
                for dt in ("float32", "bfloat16"):
                    out.append((kernel, (3, 3, s, d), dt, ()))
        out += [(kernel, (3, 3, s, d), "float16", ())
                for s, d in ((7, 5), (31, 16), (64, 5), (64, 16))]
        out += [
                # 16-bit D of 8 and 16 not 16-byte aligned: element loads
                (kernel, (3, 3, 31, 8), "bfloat16", ("misaligned",)),
                (kernel, (3, 3, 64, 16), "float16", ("misaligned",)),
                # 9000 groups, more than a wave of warps: each warp stages
                # its next group while it computes one
                (kernel, (1000, 9, 33, 8), "bfloat16", ())]
    return out


def _int8_cases() -> list:
    out = []
    # the panel kernel (F <= 64, N <= 128, q and out 16-byte aligned) with
    # M = 1 mod 64; the same shape with q one row in (30 bytes): the tiled
    # kernel; F = 200, N = 300 with M = 1 mod 128: the tiled kernel with
    # tails on its 64-feature chunks and 128-column tiles
    for dt in ("float32", "bfloat16", "float16"):
        out += [("int8_matmul", (65, 30, 100), dt, ()),
                ("int8_matmul", (65, 30, 100), dt, ("offset",)),
                ("int8_matmul", (129, 200, 300), dt,
                 ("offset",) if dt == "bfloat16" else ())]
    out += [("int8_matmul", (65, 30, 100), "bfloat16", ("misaligned",)),
            ("int8_matmul", (65, 30, 100), "float32",
             ("misaligned", "offset")),
            ("int8_matmul", (0, 30, 100), "bfloat16", ())]
    return out


def _lookup_cases() -> list:
    # 16-byte rows (D = 16), rows that are not (D = 17), narrow rows (D =
    # 1, 3); B = 77, not a multiple of a block's share; ids at 0 and V - 1,
    # and with "edge" ids that wrap and ids outside [-V, V)
    out = [("embedding_lookup", (77, 6, 1000, d), dt, ("edge",))
           for d in (16, 17) for dt in ("float32", "bfloat16")]
    return out + [("embedding_lookup", (77, 6, 1000, 1), "bfloat16", ()),
                  ("embedding_lookup", (77, 6, 1000, 3), "float32", ()),
                  ("embedding_lookup", (77, 6, 1000, 16), "float16",
                   ("edge",))]


def _rows_cases() -> list:
    # D = 16 (4-element accesses), 18 (2) and 17 (1); SGD and Adadelta;
    # deduped ids (the sentinel V among them) and raw ids with duplicates;
    # ids of -1 and V, which are skipped
    out = [("rows_update", (300, 6, 1000, d), "float32", (rule, ids))
           for d in (16, 17, 18) for rule in ("sgd", "adadelta")
           for ids in ("unique", "raw")]
    out += [("rows_update", (300, 6, 1000, 16), "bfloat16",
             ("adadelta", "raw")),
            ("rows_update", (300, 6, 1000, 17), "float16", ("sgd", "unique"))]
    return out


def _flash_cases() -> list:
    # S = 1, 37, 1001 (tails on the 64-row tiles) by D = 5 (element-load
    # staging), 8, 16, 64, 128, in f32 and bf16 by turns; then every
    # instantiation of the rest (the 32 bucket, f16 in each bucket);
    # B * H = 3
    out = []
    for kernel in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        for i, s in enumerate((1, 37, 1001)):
            for j, d in enumerate((5, 8, 16, 64, 128)):
                out.append((kernel, (3, 1, s, d),
                            ("float32", "bfloat16")[(i + j) % 2], ()))
        out += [(kernel, (3, 1, 45, 24), dt, ())
                for dt in ("float32", "bfloat16", "float16")]
        out += [(kernel, (3, 1, 37, d), "float16", ())
                for d in (8, 16, 64, 128)]
    return out


# one case a kernel at its training path's full width (chip_smoke.py's
# path shapes)
_FULL = [("ft_block", (8192, 31, 64, 8, 4), "float32", ()),
         ("small_attention", (8192, 8, 31, 8), "bfloat16", ()),
         ("small_attention_bwd", (8192, 8, 31, 8), "bfloat16", ()),
         ("int8_matmul", (65536, 30, 100), "bfloat16", ()),
         ("embedding_lookup", (32768, 6, 100_000, 17), "bfloat16", ()),
         ("rows_update", (32768, 6, 100_000, 16), "float32",
          ("adadelta", "raw")),
         ("flash_fwd", (1024, 8, 1001, 8), "bfloat16", ()),
         ("flash_bwd_dq", (1024, 8, 1001, 8), "bfloat16", ()),
         ("flash_bwd_dkv", (1024, 8, 1001, 8), "bfloat16", ())]


def _make_cases() -> tuple:
    """The cases with their tolerances and seeds: one seed a (shape,
    dtype, opts), so that the kernels of one function (small attention's
    forward and backward, flash's three) see the same inputs."""
    seeds: dict = {}
    cases = []
    small = (_ft_cases() + _small_attention_cases() + _int8_cases()
             + _lookup_cases() + _rows_cases() + _flash_cases())
    for rows, full, base in ((small, False, 1000), (_FULL, True, 9000)):
        for kernel, shape, dt, opts in rows:
            seed = seeds.setdefault((shape, dt, opts, full),
                                    base + len(seeds))
            cases.append(Case(kernel, tuple(shape), dt, seed,
                              *tolerance(kernel, dt), opts=tuple(opts),
                              full=full))
    return tuple(cases)


CASES = _make_cases()


def select(kernels: Sequence[str] = (), full: bool = False) -> list:
    """The cases of `kernels` (all when empty), the full-width ones only
    with `full`."""
    return [c for c in CASES
            if (not kernels or c.kernel in kernels) and (full or not c.full)]


# -- inputs and runners ---------------------------------------------------------

class _Inputs:
    """Seeded draws on the case's device."""

    def __init__(self, seed: int, device: torch.device):
        self.device = device
        self.gen = torch.Generator(device=device).manual_seed(seed)

    def randn(self, *shape, dtype=torch.float32, misaligned=False):
        lead = 1 if misaligned else 0
        t = torch.randn(math.prod(shape) + lead, generator=self.gen,
                        device=self.device)
        # a contiguous view one element in: not 16-byte aligned
        return t.to(dtype)[lead:].view(*shape)

    def randint(self, lo, hi, shape, dtype=torch.int32):
        return torch.randint(lo, hi, shape, generator=self.gen,
                             device=self.device, dtype=dtype)


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def _ft_block(case: Case, inp: _Inputs):
    from . import ft_block
    b, s, d, h, r = case.shape
    spec = types.SimpleNamespace(token_dim=d, num_attention_heads=h,
                                 mlp_ratio=r)
    p = {}
    for name, shape in ft_block._param_shapes(d, r).items():
        noise = inp.randn(*shape)
        if name.startswith("ln_") and name.endswith("scale"):
            p[name] = 1 + 0.1 * noise
        elif name.endswith("kernel"):
            p[name] = noise * shape[0] ** -0.5
        else:
            p[name] = 0.1 * noise
    x = inp.randn(b, s, d, dtype=_dtype(case.dtype))

    def kernel():
        return (ft_block.fused_transformer_block(x, p, spec),)

    def plain():
        return (ft_block.block_math(x.float(), p, h).to(x.dtype),)

    return Prepared(kernel, plain, _named("out"), dict(x=x, p=p, heads=h))


def _attention_inputs(case: Case, inp: _Inputs, n: int) -> list:
    misaligned = "misaligned" in case.opts
    return [inp.randn(*case.shape, dtype=_dtype(case.dtype),
                      misaligned=misaligned) for _ in range(n)]


def _small_attention(case: Case, inp: _Inputs):
    from . import small_attention as sa
    q, k, v = _attention_inputs(case, inp, 3)
    scale = case.shape[-1] ** -0.5

    def kernel():
        return (sa.small_token_attention(q, k, v),)

    def plain():
        return (sa.small_attention_plain(q, k, v, scale),)

    return Prepared(kernel, plain, _named("out"), dict(q=q, k=k, v=v, scale=scale))


def _small_attention_bwd(case: Case, inp: _Inputs):
    from . import small_attention as sa
    q, k, v, g = _attention_inputs(case, inp, 4)
    scale = case.shape[-1] ** -0.5

    def kernel():
        return sa.small_attention_bwd(q, k, v, g, scale)

    def plain():
        return sa.small_attention_bwd_plain(q, k, v, g, scale)

    return Prepared(kernel, plain,
                    _named("dq", "dk", "dv", extra=_grad_terms(
                        case, q, k, v, g, scale)),
                    dict(q=q, k=k, v=v, g=g, scale=scale))


def _int8_matmul(case: Case, inp: _Inputs):
    from . import int8_matmul as i8
    m, f, n = case.shape
    cdt = _dtype(case.dtype)
    lead = 1 if "misaligned" in case.opts else 0
    # q one row into its allocation: f bytes, not 16-byte aligned for f = 30
    q = inp.randint(-127, 128, (m + lead, f), dtype=torch.int8)[lead:]
    w = inp.randn(f, n) * f ** -0.5
    b = inp.randn(n) * 0.1
    scale = torch.full((f,), 8.0 / 127, device=inp.device)
    offset = inp.randn(f) * 0.1 if "offset" in case.opts else None

    def kernel():
        return (i8.int8_matmul_dequant(q, w, b, scale, offset, cdt),)

    def plain():
        return (i8.int8_matmul_plain(q, w, b, scale, offset, cdt),)

    def outs(got, want):
        if cdt == torch.float32:
            return [Out("out", got[0], want[0])]
        # the two sum the F products in other f32 orders, then the rounding
        # of the sum and of the bias add may each flip by one ulp
        x = i8.dequant_plain(q, scale, offset).to(cdt).float()
        wc, bc = w.to(cdt).float(), b.to(cdt).float()
        return [Out("out", got[0], want[0],
                    mag=2 * (x @ wc).abs() + bc.abs(),
                    extra=f * 2.0 ** -24 * (x.abs() @ wc.abs()))]

    return Prepared(kernel, plain, outs, dict(q=q, w=w, b=b, scale=scale,
                                              offset=offset, cdt=cdt))


def _embedding_lookup(case: Case, inp: _Inputs):
    from . import embedding as emb
    b, nc, v, d = case.shape
    table = inp.randn(nc, v, d, dtype=_dtype(case.dtype))
    ids = inp.randint(0, v, (b, nc))
    ids[0], ids[1] = 0, v - 1
    if "edge" in case.opts:  # wrapped ids and ids past [-V, V): NaN rows
        ids.view(-1)[2:9] = torch.tensor([v, -1, -v, v - 1, 0, -v - 1, v + 5],
                                         dtype=torch.int32)

    def kernel():
        return (emb.embedding_lookup(table, ids),)

    def plain():
        return (emb.lookup_reference(table, ids),)

    return Prepared(kernel, plain, _named("out"), dict(table=table, ids=ids))


def _rows_update(case: Case, inp: _Inputs):
    from . import embedding as emb
    u, nc, v, d = case.shape
    rule = "sgd" if "sgd" in case.opts else "adadelta"
    unique = "unique" in case.opts
    table = inp.randn(nc, v, d, dtype=_dtype(case.dtype))
    slots = ((inp.randn(nc, v, d).square() * 1e-3,
              inp.randn(nc, v, d).square() * 1e-3)
             if rule == "adadelta" else ())
    if unique:  # each field's in-range ids unique; the sentinel V pads
        ids = torch.stack([torch.randperm(v, generator=inp.gen,
                                          device=inp.device)[:u]
                           for _ in range(nc)], 1).to(torch.int32)
        ids[:3] = v
    else:  # duplicates among the raw ids
        ids = inp.randint(0, v // 4, (u, nc))
    ids[3], ids[4] = -1, v  # skipped
    dense_g = inp.randn(nc, v, d)
    fields = torch.arange(nc, device=inp.device)[None, :]
    # duplicates of an id carry the same gradient row
    g_rows = dense_g[fields, ids.long().clamp(0, v - 1)]

    def run(fn, **kw):
        t, s = table.clone(), tuple(x.clone() for x in slots)
        fn(t, s, g_rows, ids, rule, 3e-3, **kw)
        return (t, *s)

    def kernel():
        return run(emb.fused_rows_update, unique=unique)

    def plain():
        return run(emb.rows_update_plain)

    return Prepared(kernel, plain, _named("table", "accu", "delta"),
                    dict(table=table, slots=slots, g_rows=g_rows, ids=ids,
                         rule=rule, lr=3e-3))


def _flash(case: Case, inp: _Inputs):
    from . import flash_attention as fa
    q, k, v, g = _attention_inputs(case, inp, 4)
    scale = case.shape[-1] ** -0.5
    inputs = dict(q=q, k=k, v=v, g=g, scale=scale)
    if case.kernel == "flash_fwd":
        def kernel():
            return fa.flash_fwd(q, k, v, scale)

        def plain():
            return fa.flash_fwd_plain(q, k, v, scale)

        return Prepared(kernel, plain, lambda got, want: [
            Out("out", got[0], want[0]),
            Out("lse", got[1], want[1], tol=F32)], inputs)
    out_p, lse = fa.flash_fwd_plain(q, k, v, scale)
    dres = fa.flash_dres(out_p, g)
    if case.kernel == "flash_bwd_dq":
        def kernel():
            return (fa.flash_bwd_dq(q, k, v, g, lse, dres, scale),)

        def plain():
            return (fa.flash_bwd_dq_plain(q, k, v, g, lse, dres, scale),)

        names = ("dq",)
    else:
        def kernel():
            return fa.flash_bwd_dkv(q, k, v, g, lse, dres, scale)

        def plain():
            return fa.flash_bwd_dkv_plain(q, k, v, g, lse, dres, scale)

        names = ("dk", "dv")
    return Prepared(kernel, plain, _named(
        *names, extra=_grad_terms(case, q, k, v, g, scale)), inputs)


def _named(*names, extra: float = 0.0):
    def outputs(got, want) -> list:
        return [Out(n, a, b, extra=extra) for n, a, b in zip(names, got,
                                                             want)]
    return outputs


def _grad_terms(case: Case, q, k, v, g, scale: float) -> float:
    """The absolute term of an attention gradient's tolerance: atol_max of
    the largest term its sums add, scale |g| |v| |q or k| (dq, dk: dS is
    dP - Dres, whose two f32 sums cancel where the softmax is peaked, at S
    = 1 to rounding noise) and |g| (dv); max |ref| can be far smaller."""
    def top(t):
        return float(t.float().abs().max()) if t.numel() else 0.0

    return case.atol_max * (scale * top(g) * top(v) * max(top(q), top(k))
                            + top(g))


RUNNERS: dict[str, Callable] = {
    "ft_block": _ft_block, "small_attention": _small_attention,
    "small_attention_bwd": _small_attention_bwd,
    "int8_matmul": _int8_matmul, "embedding_lookup": _embedding_lookup,
    "rows_update": _rows_update, "flash_fwd": _flash,
    "flash_bwd_dq": _flash, "flash_bwd_dkv": _flash}


# -- checking -------------------------------------------------------------------

def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view({4: torch.int32, 2: torch.int16,
                   1: torch.int8}[t.element_size()])


def _check(case: Case, out: Out) -> float:
    """Max |got - ref| of one output, raising SelftestError where it is
    out of tolerance."""
    got, want = out.got, out.want
    where = f"{case.label}: {out.name}"
    if got.shape != want.shape or got.dtype != want.dtype:
        raise SelftestError(f"{where}: {got.dtype} {tuple(got.shape)}, the "
                            f"plain version {want.dtype} "
                            f"{tuple(want.shape)}")
    if got.numel() == 0:
        return 0.0
    atol, rtol, atol_max = out.tol or (case.atol, case.rtol, case.atol_max)
    if atol == rtol == atol_max == 0.0:  # bitwise, NaN rows included
        if not torch.equal(_bits(got), _bits(want)):
            raise SelftestError(f"{where}: not bitwise equal to the plain "
                                "version")
        return 0.0
    g, w = got.float(), want.float()
    if not bool(torch.isfinite(g).all()):
        raise SelftestError(f"{where}: non-finite values in the kernel's "
                            "output")
    err = (g - w).abs()
    mag = w.abs() if out.mag is None else out.mag
    bound = atol + rtol * mag + out.extra + atol_max * float(w.abs().max())
    if bool((err > bound).any()):
        raise SelftestError(
            f"{where}: max |err| {err.max().item():.3e} exceeds atol {atol:g} "
            f"+ rtol {rtol:g} * |ref| + {atol_max:g} * max|ref|")
    return float(err.max())


def prepare(case: Case, device: torch.device) -> Prepared:
    """`case`'s inputs drawn from its seed on `device`, and its calls."""
    return RUNNERS[case.kernel](case, _Inputs(case.seed, device))


def run_case(case: Case, device: torch.device, repeat: int = 1) -> float:
    """Run `case` on `device` (the kernel `repeat` times); returns the max
    |err| over its outputs."""
    prep = prepare(case, device)
    with torch.no_grad():
        got = prep.kernel()
        want = prep.plain()
        err = max(_check(case, o) for o in prep.outputs(got, want))
        for i in range(1, repeat):
            again = prep.kernel()
            for a, b in zip(got, again):
                if not torch.equal(_bits(a), _bits(b)):
                    raise SelftestError(f"{case.label}: launch {i + 1} of "
                                        f"{repeat} differs from the first")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return err


# -- the guard allocator ----------------------------------------------------------

def install_guard() -> ctypes.CDLL:
    """Make `csrc/tools/guard_alloc.cu` this process's CUDA allocator; call
    before anything allocates on the card.  Returns the library (its
    counters)."""
    path = _build.build_tool("guard_alloc")
    alloc = torch.cuda.memory.CUDAPluggableAllocator(path, "guard_malloc",
                                                     "guard_free")
    torch.cuda.memory.change_current_allocator(alloc)
    lib = ctypes.CDLL(path)
    for fn in ("guard_allocations", "guard_violations", "guard_first_size",
               "guard_first_offset"):
        getattr(lib, fn).restype = ctypes.c_longlong
        getattr(lib, fn).argtypes = []
    return lib


def guard_control(guard: ctypes.CDLL, device: torch.device) -> None:
    """The guard's own check, through the lookup's C entry point (past its
    wrapper's checks, so that no counter moves): a launch into an output
    one element short must trip one guard, and rows read past a table's
    end must read the 0xFF fill.  Raises SelftestError otherwise."""
    from . import embedding as emb
    lib = emb._lookup_lib()
    stream = torch.cuda.current_stream(device).cuda_stream
    table = torch.arange(16, dtype=torch.float32, device=device)
    ids = torch.tensor([[0], [3]], dtype=torch.int32, device=device)
    before = guard.guard_violations()
    # (B = 2, Nc = 1, V = 4, D = 4): 8 floats into 7
    short = torch.empty(7, dtype=torch.float32, device=device)
    rc = lib.embedding_lookup_fwd(table.data_ptr(), ids.data_ptr(),
                                  short.data_ptr(), 2, 1, 4, 4, 0, stream)
    torch.cuda.synchronize(device)
    del short
    written = guard.guard_violations() - before
    # V given as 8: row 5 lies past the table, in its guard band
    far = torch.tensor([[5]], dtype=torch.int32, device=device)
    out = torch.empty(4, dtype=torch.float32, device=device)
    rc = rc or lib.embedding_lookup_fwd(table.data_ptr(), far.data_ptr(),
                                        out.data_ptr(), 1, 1, 8, 4, 0, stream)
    torch.cuda.synchronize(device)
    fill = bool((out.view(torch.int32) == -1).all())
    if rc or written != 1 or not fill:
        raise SelftestError(
            f"guard control: launches rc {rc}, {written} guards tripped by a "
            f"write one element past a tensor (1 expected), a read past a "
            f"table {'read' if fill else 'did not read'} the 0xFF fill")


# -- the command ------------------------------------------------------------------

def _device(name: str) -> torch.device:
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: CUDA is not available (pass "
                           "--device cpu to run the plain versions)")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"--device {name}: cuda or cpu")
    return dev


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m shifu_tpu_torch.ops.selftest",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--kernel", action="append", default=[],
                    choices=sorted(RUNNERS), metavar="NAME",
                    help="only this kernel's cases (repeatable): "
                         + ", ".join(sorted(RUNNERS)))
    ap.add_argument("--list", action="store_true",
                    help="print the cases and exit")
    ap.add_argument("--full", action="store_true",
                    help="add one case a kernel at the path's full width")
    ap.add_argument("--guard", action="store_true",
                    help="guard-band allocator (CUDA)")
    ap.add_argument("--repeat", action="store_true",
                    help=f"launch each case's kernel {REPEAT} times, bitwise "
                         "equal")
    args = ap.parse_args(argv)
    cases = select(args.kernel, args.full)
    if args.list:
        for c in cases:
            print(f"{c.label} seed {c.seed} atol {c.atol:g} rtol {c.rtol:g}"
                  f" atol_max {c.atol_max:g}")
        return 0
    dev = _device(args.device)
    if args.guard and dev.type != "cuda":
        raise ValueError("--guard takes a CUDA device")
    guard = install_guard() if args.guard else None
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    counters = launch_counters()
    if guard:
        try:
            guard_control(guard, dev)
        except SelftestError as e:
            print(f"FAIL {e}", flush=True)
            return 1
        print("ok guard control: a write one element past a tensor tripped "
              "its guard; a read past a table read the 0xFF fill",
              flush=True)
    baseline = guard.guard_violations() if guard else 0
    t0 = time.perf_counter()
    for case in cases:
        t_case = time.perf_counter()
        try:
            err = run_case(case, dev, REPEAT if args.repeat else 1)
            # the case's tensors are freed as it returns: their guards are
            # read then
            if guard and guard.guard_violations() != baseline:
                raise SelftestError(
                    f"{case.label}: a guard band was written (first: a "
                    f"tensor of {guard.guard_first_size()} bytes at byte "
                    f"{guard.guard_first_offset()} from its start)")
        except SelftestError as e:
            print(f"FAIL {e}", flush=True)
            return 1
        print(f"ok {case.label}: max|err| {err:.3e} "
              f"({time.perf_counter() - t_case:.2f} s)", flush=True)
    if guard:
        gc.collect()
        torch.cuda.synchronize(dev)
        if guard.guard_violations() != baseline:
            print(f"FAIL a guard band was written (first: a tensor of "
                  f"{guard.guard_first_size()} bytes at byte "
                  f"{guard.guard_first_offset()} from its start)",
                  flush=True)
            return 1
    print(f"{len(cases)} cases in {time.perf_counter() - t0:.1f} s on "
          f"{dev}" + (f"; guard: {guard.guard_allocations()} allocations, "
                      f"{guard.guard_violations() - baseline} violations"
                      if guard else ""))
    for name, fn in counters.items():
        print(f"launches: {name} {fn.launches}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
