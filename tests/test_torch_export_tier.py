"""The port's compiled-graph tier (export/artifact.py `scoring.pt2`,
export/scorer.py `ExportScorer`) and the `shifu_tpu_torch::` operators it
calls, against the JAX package's StableHLO tier, on the CPU.

- Every ladder model (MLP, Wide&Deep, DeepFM, multitask, MoE, and the FT
  fused, unfused and flash) on weights carried across from the JAX
  package's init, all in f32: `ExportScorer` within 1e-6 of `TorchScorer`,
  and within 1e-5 of the JAX `StableHloScorer` on the JAX artifact of the
  same weights, at 1 row and at 4096 rows (export
  specialises sizes 0 and 1; the batch is symbolic).
- The FT graphs call the kernels as `shifu_tpu_torch::` operators (#1 fused,
  #2 unfused, #7 flash, #5 wherever a table is looked up); no graph names a
  device, so a program traced on the CPU runs where it is loaded.
- A CUDA tensor (a FakeTensor on cuda:0, routed by its backend key) reaches
  each operator's CUDA implementation, the kernel launch; FLOP counts of
  the wrappers are the kernels' `cost(...)`, as before the operators.
- A failed export raises where the JAX package's is best-effort; a fresh
  process loads `scoring.pt2` only through the port, which registers the
  operators first; the daemon's threads share one exported module.
"""

import concurrent.futures
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from shifu_tpu.config import JobConfig as JaxJobConfig
from shifu_tpu.export import artifact as jax_artifact
from shifu_tpu.export.scorer import StableHloScorer
from shifu_tpu.train import init_state as jax_init_state
from shifu_tpu.train import make_forward_fn
from shifu_tpu_torch.export import artifact, scorer
from shifu_tpu_torch.models.registry import build_model
from shifu_tpu_torch.obs import flops
from shifu_tpu_torch.ops import embedding as emb
from shifu_tpu_torch.ops import flash_attention as fa
from shifu_tpu_torch.ops import ft_block as fb
from shifu_tpu_torch.ops import small_attention as sa

import test_torch_program as tp
from test_torch_embedding import _card_dispatch, _no_plain

F32_ATOL = 1e-6     # the exported graph against the model it traced
JAX_F32_ATOL = 1e-5  # the port against the JAX package, both in f32

# case -> (model_type, the port spec's knobs, the operators of its graph)
CASES = {
    "mlp": ("mlp", {}, set()),
    "wide_deep": ("wide_deep", {}, {"embedding_lookup"}),
    "deepfm": ("deepfm", {}, {"embedding_lookup"}),
    "multitask": ("multitask", {}, set()),
    "moe_mlp": ("moe_mlp", {}, set()),
    "ft_fused": ("ft_transformer", {"fused_block": "on"},
                 {"ft_block", "embedding_lookup"}),
    "ft_unfused": ("ft_transformer", {"fused_block": "off"},
                   {"small_attention", "embedding_lookup"}),
    "ft_flash": ("ft_transformer", {"fused_block": "off",
                                    "attention_impl": "flash"},
                 {"flash_fwd", "embedding_lookup"}),
}
N_CAT = 3


def _pair(tmp_path, case):
    """(JAX artifact dir, port artifact dir): the JAX init's weights saved
    by the JAX package (with its StableHLO export) and carried into the
    port's model, saved by the port (with scoring.pt2)."""
    model_type, knobs, _ = CASES[case]
    jspec = dataclasses.replace(tp._jax_spec(model_type), **knobs)
    jschema = tp._jax_schema(N_CAT)
    # the JAX package fuses only on a TPU: its artifact is the same math
    # through the unfused block
    jjob = JaxJobConfig(schema=jschema, model=dataclasses.replace(
        jspec, fused_block="off")).validate()
    state = jax_init_state(jjob, jschema.feature_count)
    jdir = str(tmp_path / f"jax-{case}")
    jax_artifact.save_artifact(state.params, jjob, jdir,
                               forward_fn=make_forward_fn(jjob,
                                                          state.apply_fn))
    pspec, pschema = tp._port(jspec, jschema)
    model = build_model(pspec, pschema, device="cpu")
    with np.load(os.path.join(jdir, "weights.npz")) as z:
        model.load_state_dict(artifact.params_from_jax(
            {k: z[k] for k in z.files}, model))
    pdir = artifact.save_artifact(model, pspec, pschema,
                                  str(tmp_path / f"port-{case}"))
    return jdir, pdir


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    root = tmp_path_factory.mktemp("export_tier")
    return {case: _pair(root, case) for case in CASES}


@pytest.mark.parametrize("case", sorted(CASES))
def test_export_tier_matches_torch_and_jax_stablehlo(pairs, case):
    jdir, pdir = pairs[case]
    x = tp._rows(4096, N_CAT, seed=21)
    ex = scorer.ExportScorer(pdir, device="cpu")
    assert ex.engine == "export" and ex.num_features == tp.F
    torch_sc = scorer.TorchScorer(pdir, device="cpu")
    jax_sc = StableHloScorer(jdir)
    for rows in (x[:1], x):
        got = ex.compute_batch(rows)
        assert got.shape == (rows.shape[0], 2 if case == "multitask" else 1)
        np.testing.assert_allclose(got, torch_sc.compute_batch(rows),
                                   rtol=0, atol=F32_ATOL)
        np.testing.assert_allclose(got, jax_sc.compute_batch(rows),
                                   rtol=0, atol=JAX_F32_ATOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_graphs_call_the_operators_and_name_no_device(pairs, case):
    program = torch.export.load(os.path.join(pairs[case][1],
                                             artifact.EXPORT_PROGRAM))
    want = {f"shifu_tpu_torch.{op}.default" for op in CASES[case][2]}
    assert artifact.program_operators(program) == want
    assert artifact.device_literals(program) == []
    assert not any(n.target is torch.ops.aten._assert_tensor_metadata.default
                   for n in program.graph.nodes)


def test_loading_moves_the_program_to_its_device(pairs, monkeypatch):
    """A program traced on the CPU is moved, weights and constants, to the
    device it is loaded for; the graph itself names none."""
    from torch.export import passes
    moved = []

    def move(program, device):
        moved.append(str(device))
        return program

    monkeypatch.setattr(passes, "move_to_device_pass", move)
    path = os.path.join(pairs["ft_fused"][1], artifact.EXPORT_PROGRAM)
    scorer.load_program(path, torch.device("cuda", 0))
    scorer.load_program(path, torch.device("cpu"))
    assert moved == ["cuda:0"]


def test_threads_share_one_exported_module(pairs):
    ex = scorer.ExportScorer(pairs["ft_unfused"][1], device="cpu")
    rows = [tp._rows(n, N_CAT, seed=22 + n) for n in (1, 7, 64, 300)]
    want = [ex.compute_batch(r) for r in rows]

    def work(i):
        return np.array_equal(ex.compute_batch(rows[i % 4]), want[i % 4])

    with concurrent.futures.ThreadPoolExecutor(max_workers=8) as pool:
        assert all(f.result(timeout=120)
                   for f in [pool.submit(work, i) for i in range(32)])


def test_a_failed_export_raises_where_jax_is_best_effort(tmp_path,
                                                         monkeypatch):
    """A deliberate difference: the JAX package skips a StableHLO export
    that fails (`export_stablehlo` returns False); the port's
    save_artifact raises, so no artifact ships without scoring.pt2."""
    def refuse(*a, **k):
        raise RuntimeError("export refused")

    assert jax_artifact.export_stablehlo(refuse, {}, tp.F,
                                         str(tmp_path / "x.mlir")) is False
    monkeypatch.setattr(torch.export, "export", refuse)
    with pytest.raises(RuntimeError, match="export refused"):
        tp._saved(tmp_path, "mlp", 0)


def test_a_fresh_process_loads_the_program_through_the_port(pairs):
    """`torch.export.load` cannot read a program whose operators are not
    registered; `ExportScorer` registers them before it loads."""
    path = os.path.join(pairs["ft_fused"][1], artifact.EXPORT_PROGRAM)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import sys, torch\n"
            "try:\n"
            f"    torch.export.load({path!r})\n"
            "    print('loaded without the operators')\n"
            "except Exception as e:\n"
            "    print('refused:', type(e).__name__)\n"
            "from shifu_tpu_torch.export.scorer import ExportScorer\n"
            f"s = ExportScorer({pairs['ft_fused'][1]!r}, device='cpu')\n"
            "import numpy as np\n"
            f"print('scored', s.compute_batch(np.zeros((3, {tp.F}), "
            "np.float32)).shape)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "refused:" in out.stdout
    assert "scored (3, 1)" in out.stdout


# -- the operators' CUDA implementations, reached without a card ---------------

def _fake(*specs):
    """FakeTensors on cuda:0 of the given (shape, dtype): metadata only."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode(allow_non_fake_inputs=True):
        return [torch.empty(shape, dtype=dtype, device="cuda")
                for shape, dtype in specs]


def test_a_card_tensor_reaches_the_fused_block_kernel(monkeypatch):
    d, r, h = 16, 2, 2
    x, out = _fake(((3, 5, d), torch.float32), ((3, 5, d), torch.float32))
    params = _fake(*[(s, torch.float32)
                     for s in fb._param_shapes(d, r).values()])
    spec = tp.port_schema.ModelSpec(model_type="ft_transformer",
                                    token_dim=d, num_attention_heads=h,
                                    mlp_ratio=r)
    calls = []
    monkeypatch.setattr(fb, "block_math", _no_plain)
    monkeypatch.setattr(fb, "_launch",
                        lambda *a: calls.append(a) or out)
    with _card_dispatch():
        got = fb.fused_transformer_block(
            x, dict(zip(fb._PARAM_ORDER, params)), spec)
    assert got is out
    assert len(calls) == 1 and calls[0][0] is x and calls[0][2:] == (h, r)


def test_a_card_tensor_reaches_the_small_attention_kernel(monkeypatch):
    q, k, v, out = _fake(*[((2, 2, 9, 8), torch.bfloat16)] * 4)
    calls = []
    monkeypatch.setattr(sa, "small_attention_plain", _no_plain)
    monkeypatch.setattr(sa, "_launch", lambda *a: calls.append(a) or out)
    with _card_dispatch():
        assert sa.small_token_attention(q, k, v, 0.5) is out
    assert calls == [(q, k, v, 0.5)]


def test_a_card_tensor_reaches_the_lookup_kernel(monkeypatch):
    table, ids, out = _fake(((3, 11, 4), torch.float32),
                            ((5, 3), torch.int32), ((5, 3, 4), torch.float32))
    calls = []
    monkeypatch.setattr(emb, "lookup_reference", _no_plain)
    monkeypatch.setattr(emb, "_launch_lookup",
                        lambda *a: calls.append(a) or out)
    with _card_dispatch():
        assert emb.embedding_lookup(table, ids) is out
    assert calls == [(table, ids)]


def test_a_card_tensor_reaches_the_flash_kernel(monkeypatch):
    q, k, v, out = _fake(*[((2, 2, 33, 8), torch.bfloat16)] * 4)
    (lse,) = _fake(((2, 2, 33), torch.float32))
    calls = []
    monkeypatch.setattr(fa, "flash_fwd_plain", _no_plain)
    monkeypatch.setattr(fa, "_launch_fwd",
                        lambda *a: calls.append(a) or (out, lse))
    with _card_dispatch():
        assert fa.flash_attention(q, k, v, 0.25) is out
    assert calls == [(q, k, v, 0.25)]


@pytest.mark.parametrize("which", ["ft_block", "small_attention",
                                   "embedding_lookup", "flash_fwd"])
def test_flop_counts_are_the_kernels_costs(which):
    """obs/flops.py counts each wrapper as its kernel's `cost(...)` and not
    the operator's body, on the CPU as on the card."""
    g = torch.Generator().manual_seed(3)
    if which == "ft_block":
        b, s, d, h, r = 4, 5, 16, 2, 2
        x = torch.randn((b, s, d), generator=g)
        p = {n: torch.randn(shape, generator=g)
             for n, shape in fb._param_shapes(d, r).items()}
        spec = tp.port_schema.ModelSpec(model_type="ft_transformer",
                                        token_dim=d, num_attention_heads=h,
                                        mlp_ratio=r)
        fn, args, want = (fb.fused_transformer_block, (x, p, spec),
                          fb.cost(b, s, d, h, r))
    elif which == "small_attention":
        q = torch.randn((3, 2, 9, 8), generator=g)
        fn, args, want = (sa.small_token_attention, (q, q, q, 0.5),
                          sa.cost(3, 2, 9, 8, q.dtype))
    elif which == "embedding_lookup":
        table = torch.randn((3, 11, 4), generator=g)
        ids = torch.randint(0, 11, (5, 3), generator=g, dtype=torch.int32)
        fn, args, want = (emb.embedding_lookup, (table, ids),
                          emb.lookup_cost(5, 3, 4, table.dtype))
    else:
        q = torch.randn((2, 2, 33, 8), generator=g)
        fn, args, want = (fa.flash_attention, (q, q, q, 0.25),
                          fa.cost_fwd(2, 2, 33, 8, q.dtype))
    _, got = flops.count(fn, *args)
    assert (got["flops"], got["bytes_accessed"], got["exponentials"]) \
        == tuple(float(v) for v in want)
