#!/usr/bin/env python3
"""Time other versions of the port's fused FT block (#1), embedding lookup
(#5) and small-token attention (#2 forward, #3 backward) beside this
checkout's, in one process on one GPU.

    python3 kernel_ab.py DIR [DIR ...]

Each DIR holds another version of `ft_block.cu`, `embedding_lookup.cu`
and/or `small_attention.cu` with the same C entry points: an earlier
commit's `shifu_tpu_torch/csrc` (`git archive <commit>
shifu_tpu_torch/csrc`, or only the sources to time and the headers they
include), or a copy of this checkout's source with one stage taken out.
Headers the version includes are taken from DIR first, then from this
checkout's csrc.  The sources any DIR holds build at once, the versions'
and this checkout's, with the port's nvcc flags.  Each kernel is then
timed at chip_smoke.py's path shapes (`FT_BLOCK_SHAPE`, `LOOKUP_SHAPE`,
`SMALL_ATTN_SHAPE`: the forward, the backward, and a whole training step
of chip_smoke.py's unfused FT path, whose blocks run both) through the
port's own wrapper, with the version's library in place of the
checkout's, in turns (version, this, this, version), by
`chip_smoke.device_ms`.  Each kernel's line gives the version's max
|err| against the plain version too: a version with a stage taken out
computes something else, and only its time means anything.  Nothing here is on a path the
port runs; chip_smoke.py checks the checkout's kernels.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import chip_smoke as cs

NAMES = ("ft_block", "embedding_lookup", "small_attention")


def start_builds(dirs: list[str]) -> dict:
    """One nvcc per (DIR, kernel) source present, all started together;
    returns {(dir, name): (process, library path)}."""
    from shifu_tpu_torch.ops import _build
    procs = {}
    for d in dirs:
        for name in NAMES:
            src = os.path.join(d, f"{name}.cu")
            if not os.path.exists(src):
                continue
            out = os.path.join(d, "_build", f"lib{name}.so")
            os.makedirs(os.path.dirname(out), exist_ok=True)
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", _build.CSRC,
                   "-o", out, src]
            procs[(d, name)] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True), out)
    return procs


def cases(device, gen, names) -> dict:
    """{case: (source name, call through the wrapper, max |err| against
    the plain version)} at the path shapes, for the sources in `names`."""
    import torch
    from shifu_tpu_torch.config.schema import ModelSpec
    from shifu_tpu_torch.ops import embedding as emb
    from shifu_tpu_torch.ops import ft_block
    from shifu_tpu_torch.ops import small_attention as sa

    def err(got, want) -> float:
        return float((got.float() - want.float()).abs().max())

    out = {}
    if "ft_block" in names:
        b, s, d, h, r = cs.FT_BLOCK_SHAPE
        spec = ModelSpec(model_type="ft_transformer", token_dim=d,
                         num_attention_heads=h, mlp_ratio=r)
        p = cs.block_params(d, r, gen, device)
        x = cs.randn_on(gen, device, b, s, d)
        want_ft = ft_block.block_math(x, p, h)

        def block():
            return ft_block.fused_transformer_block(x, p, spec)

        out["ft_block"] = ("ft_block", block, lambda: err(block(), want_ft))
    if "embedding_lookup" in names:
        lb, nc, v, ld = cs.LOOKUP_SHAPE
        table = cs.randn_on(gen, device, nc, v, ld).to(torch.bfloat16)
        ids = torch.randint(0, v, (lb, nc), generator=gen,
                            dtype=torch.int32).to(device)
        want_emb = emb.lookup_reference(table, ids)

        def lookup():
            return emb.embedding_lookup(table, ids)

        out["embedding_lookup"] = ("embedding_lookup", lookup,
                                   lambda: err(lookup(), want_emb))
    if "small_attention" in names:
        sb, sh, ss, sd = cs.SMALL_ATTN_SHAPE
        q, k, v, g = (cs.randn_on(gen, device, sb, sh, ss, sd)
                      .to(torch.bfloat16) for _ in range(4))
        scale = sd ** -0.5
        want_o = sa.small_attention_plain(q, k, v, scale)
        want_g = sa.small_attention_bwd_plain(q, k, v, g, scale)

        def attn_fwd():
            return sa.small_token_attention(q, k, v)

        def attn_bwd():
            return sa.small_attention_bwd(q, k, v, g, scale)

        out["small_attention"] = ("small_attention", attn_fwd,
                                  lambda: err(attn_fwd(), want_o))
        out["small_attention_bwd"] = (
            "small_attention", attn_bwd,
            lambda: max(err(x, y) for x, y in zip(attn_bwd(), want_g)))
        out["train FT unfused step"] = ("small_attention",
                                        unfused_ft_step(device), None)
    return out


def unfused_ft_step(device):
    """One training step of chip_smoke.py's unfused FT path (batch 8192,
    dropout 0.1: #2 and #3 in each of its 3 blocks) as a call: its device
    time is the step's, of which #2 and #3 are a part."""
    from shifu_tpu_torch.train.loop import init_state, to_device
    from shifu_tpu_torch.train.step import make_train_step
    job = cs.ft_unfused_job()
    train_ds, _ = cs.synthetic_datasets(job.schema, cs.FT_BATCH, 1,
                                        cs.SEED + 1)
    batch = to_device(cs.lockstep_batches(job, train_ds, 1)[0], job, device)
    step = make_train_step(job)
    state = [init_state(job, job.schema.feature_count, device)]

    def train_step():
        state[0], metrics = step(state[0], batch)
        return metrics

    return train_step


def main() -> None:
    import torch
    dirs = sys.argv[1:]
    if not dirs:
        cs.fail("usage: python3 kernel_ab.py DIR [DIR ...]")
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false: this needs a GPU")
    from shifu_tpu_torch.ops import _build
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    cs.say(smi.stdout.strip())
    procs = start_builds(dirs)
    names = sorted({name for _, name in procs})
    if not names:
        cs.fail(f"no DIR holds any of {NAMES}")
    _build.build_all(names)
    libs = {}
    for key, (proc, out) in procs.items():
        _, log = proc.communicate()
        if proc.returncode != 0:
            cs.fail(f"{key[0]}/{key[1]}.cu: nvcc failed:\n{log}")
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
        cs.say(f"build {key[0]}/{key[1]}.cu: {regs[0] if regs else ''}")
        libs[key] = ctypes.CDLL(out)
    device = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(cs.SEED)
    calls = cases(device, gen, names)
    for case, (name, fn, err) in calls.items():
        own = _build.load(name)
        if err is not None:
            cs.say(f"{case} this checkout: max|err| {err():.3e}")
        for d in dirs:
            if (d, name) not in libs:
                continue
            times = {"version": [], "this": []}
            try:
                for which in ("version", "this", "this", "version"):
                    _build._libs[name] = (libs[(d, name)]
                                          if which == "version" else own)
                    times[which].append(cs.device_ms(fn))
                _build._libs[name] = libs[(d, name)]
                version_err = (f"; the version's max|err| {err():.3e}"
                               if err is not None else "")
            finally:
                _build._libs[name] = own
            cs.say(f"{case} {d}: version {times['version'][0]:.4f} / "
                   f"{times['version'][1]:.4f} ms, this "
                   f"{times['this'][0]:.4f} / {times['this'][1]:.4f} ms "
                   f"(in turns: version, this, this, version){version_err}")


if __name__ == "__main__":
    main()
