#!/usr/bin/env python3
"""Time other versions of the port's fused FT block (#1), small-token
attention (#2 forward, #3 backward), int8 first layer (#4), embedding
lookup (#5) and rows-touched update (#6) beside this checkout's, in one
process on one GPU.

    python3 kernel_ab.py DIR [DIR ...]

Each DIR holds another version of `ft_block.cu`, `small_attention.cu`,
`int8_matmul.cu`, `embedding_lookup.cu` and/or `rows_update.cu` with the
same C entry points: an earlier commit's `shifu_tpu_torch/csrc` (`git
archive <commit> shifu_tpu_torch/csrc`, or only the sources to time and
the headers they include), or a copy of this checkout's source with one
stage taken out.  Headers the version includes are taken from DIR first,
then from this checkout's csrc.  The one entry point that changed, #6's
`rows_update`, is called as the version takes it: a version whose entry
point takes a scratch buffer (two passes, as before the one-pass design)
gets one, allocated per call as its wrapper did, and ignores `unique`.
The sources any DIR holds build at once, the versions' and this
checkout's, with the port's nvcc flags.  Each kernel is then timed at
chip_smoke.py's path shapes (`FT_BLOCK_SHAPE`, `SMALL_ATTN_SHAPE`,
`INT8_SHAPE`, `LOOKUP_SHAPE`, `ROWS_SHAPE` with unique and with raw ids)
and in whole training steps of the paths that run it (the unfused FT
path for #2 and #3; the headline MLP for #4; DeepFM at 100k vocab on
deduped and on raw ids for #6) through the port's own wrapper, with the
version's library in place of the checkout's, in turns (version, this,
this, version), by `chip_smoke.device_ms`.  Each kernel's line gives the
version's max |err| against the plain version too: a version with a
stage taken out computes something else, and only its time means
anything.  Nothing here is on a path the port runs; chip_smoke.py checks
the checkout's kernels.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import os
import subprocess
import sys

import chip_smoke as cs

NAMES = ("ft_block", "embedding_lookup", "small_attention", "int8_matmul",
         "rows_update")


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
    from shifu_tpu_torch.ops import int8_matmul as i8
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
    if "int8_matmul" in names:
        m, f, n = cs.INT8_SHAPE
        q = torch.randint(-127, 128, (m, f), generator=gen,
                          dtype=torch.int8).to(device)
        w = (torch.randn(f, n, generator=gen) * f ** -0.5).to(device)
        b = (torch.randn(n, generator=gen) * 0.1).to(device)
        scale = torch.full((f,), 8.0 / 127, device=device)
        want_i8 = i8.int8_matmul_plain(q, w, b, scale, None, torch.bfloat16)

        def int8():
            return i8.int8_matmul_dequant(q, w, b, scale, None,
                                          torch.bfloat16)

        out["int8_matmul"] = ("int8_matmul", int8,
                              lambda: err(int8(), want_i8))
        out["train MLP step"] = ("int8_matmul", train_step(
            cs.headline_job(), cs.TRAIN_BATCH, device), None)
    if "rows_update" in names:
        out.update(rows_cases(device, gen))
        job = cs.dlrm_job("deepfm", cs.deepfm_schema(cs.DEEPFM_VOCAB),
                          cs.DEEPFM_BATCH, staged=False)
        out["train DeepFM step, deduped ids"] = (
            "rows_update", train_step(job, cs.DEEPFM_BATCH, device), None)
        raw_job = dataclasses.replace(
            job, embed=dataclasses.replace(job.embed, dedup="off"))
        out["train DeepFM step, raw ids"] = (
            "rows_update", train_step(raw_job, cs.DEEPFM_BATCH, device), None)
    return out


def rows_cases(device, gen) -> dict:
    """#6 at ROWS_SHAPE, f32 Adadelta, on DeepFM's two tables (D 16 and
    D 1): a batch's deduped ids (the sentinel V pads them, `unique=True`)
    and the same batch's raw ids."""
    import torch
    from shifu_tpu_torch.embed.dedup import dedup_ids
    from shifu_tpu_torch.ops import embedding as emb
    u, nc, v, d16 = cs.ROWS_SHAPE
    raw = torch.randint(0, v, (u, nc), generator=gen, dtype=torch.int32)
    uniq = torch.from_numpy(dedup_ids(raw.numpy(), v)[0]).to(device)
    raw = raw.to(device)
    fields = torch.arange(nc, device=device)[None, :]
    out = {}
    for d in (d16, 1):
        dense_g = cs.randn_on(gen, device, nc, v, d)
        table = cs.randn_on(gen, device, nc, v, d)
        slots = tuple(cs.randn_on(gen, device, nc, v, d).square() * 1e-3
                      for _ in range(2))
        for label, ids, unique in (("unique ids", uniq, True),
                                   ("raw ids", raw, False)):
            g = dense_g[fields, ids.long().clamp(0, v - 1)]

            def update(ids=ids, g=g, unique=unique, table=table,
                       slots=slots):
                emb.fused_rows_update(table, slots, g, ids, "adadelta",
                                      3e-3, unique=unique)

            def update_err(ids=ids, g=g, unique=unique, table=table,
                           slots=slots) -> float:
                got = (table.clone(), tuple(x.clone() for x in slots))
                want = (table.clone(), tuple(x.clone() for x in slots))
                emb.fused_rows_update(*got, g, ids, "adadelta", 3e-3,
                                      unique=unique)
                emb.rows_update_plain(*want, g, ids, "adadelta", 3e-3)
                return max(float((x - y).abs().max()) for x, y in
                           zip((got[0], *got[1]), (want[0], *want[1])))

            out[f"rows_update D={d} {label}"] = ("rows_update", update,
                                                 update_err)
    return out


def train_step(job, batch: int, device):
    """One training step of `job` on a batch of synthetic rows as a call
    (the batch's ids deduped where the job dedups): its device time is
    the step's, of which the kernel is a part."""
    from shifu_tpu_torch.train.loop import init_state, to_device
    from shifu_tpu_torch.train.step import make_train_step
    train_ds, _ = cs.synthetic_datasets(job.schema, batch, 1, cs.SEED + 1)
    data = to_device(cs.lockstep_batches(job, train_ds, 1)[0], job, device)
    step = make_train_step(job)
    state = [init_state(job, job.schema.feature_count, device)]

    def call():
        state[0], metrics = step(state[0], data)
        return metrics

    return call


def unfused_ft_step(device):
    """One training step of chip_smoke.py's unfused FT path (batch 8192,
    dropout 0.1: #2 and #3 in each of its 3 blocks) as a call."""
    return train_step(cs.ft_unfused_job(), cs.FT_BATCH, device)


def takes_scratch(version_dir: str) -> bool:
    """Whether the version's rows_update.cu entry point takes a scratch
    buffer (the two-pass design) in place of a stamp and a call number."""
    with open(os.path.join(version_dir, "rows_update.cu")) as f:
        src = f.read()
    head = src[src.index("int rows_update("):]
    return "scratch" in head[:head.index(")")]


def scratch_launch(lib: ctypes.CDLL):
    """`_launch_rows_update` for a version whose entry point takes a
    scratch buffer: allocated per call, as its wrapper did; `unique` is
    not passed (that version treats every batch alike)."""
    import torch
    from shifu_tpu_torch.ops import embedding as emb
    fn = lib.rows_update
    fn.argtypes = ([ctypes.c_void_p] * 6
                   + [ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
                      ctypes.c_int, ctypes.c_int, ctypes.c_int,
                      ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int

    def launch(table, slots, g_rows, ids, rule, lr, unique):
        nc, v, d = table.shape
        u = ids.shape[0]
        ids = ids.to(torch.int32).contiguous()
        g_rows = g_rows.contiguous()
        scratch = torch.empty((len(slots) + 1, u, nc, d),
                              dtype=torch.float32, device=table.device)
        accu, delta = slots if slots else (None, None)
        stream = torch.cuda.current_stream(table.device).cuda_stream
        rc = fn(table.data_ptr(),
                accu.data_ptr() if accu is not None else None,
                delta.data_ptr() if delta is not None else None,
                g_rows.data_ptr(), ids.data_ptr(), scratch.data_ptr(), u, nc,
                v, d, emb.RULES.index(rule), emb._DTYPE_CODES[table.dtype],
                float(lr), stream)
        if rc != 0:
            cs.fail(f"the version's rows_update failed to launch: {rc}")
        emb.fused_rows_update.launches += 1

    return launch


@contextlib.contextmanager
def version_in_place(name: str, lib, version_dir: str | None):
    """The port's wrapper of `name` calls `lib` inside the block; with a
    version_dir whose rows_update takes a scratch buffer, through
    `scratch_launch`."""
    from shifu_tpu_torch.ops import _build
    from shifu_tpu_torch.ops import embedding as emb
    own, launch = _build._libs[name], emb._launch_rows_update
    _build._libs[name] = lib
    # a version may keep other values in the rows update's stamps (or none)
    emb._stamps.clear()
    if (version_dir is not None and name == "rows_update"
            and takes_scratch(version_dir)):
        emb._launch_rows_update = scratch_launch(lib)
    try:
        yield
    finally:
        _build._libs[name] = own
        emb._launch_rows_update = launch
        emb._stamps.clear()


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
            for which in ("version", "this", "this", "version"):
                with version_in_place(
                        name, libs[(d, name)] if which == "version" else own,
                        d if which == "version" else None):
                    times[which].append(cs.device_ms(fn))
            with version_in_place(name, libs[(d, name)], d):
                version_err = (f"; the version's max|err| {err():.3e}"
                               if err is not None else "")
            cs.say(f"{case} {d}: version {times['version'][0]:.4f} / "
                   f"{times['version'][1]:.4f} ms, this "
                   f"{times['this'][0]:.4f} / {times['this'][1]:.4f} ms "
                   f"(in turns: version, this, this, version){version_err}")


if __name__ == "__main__":
    main()
