"""AOT serving pack: the scoring programs of the bucket grid, and the
kernels they call, inside the artifact (port of shifu_tpu/export/aot.py).

A serving daemon pads batches up the power-of-two bucket ladder, so it
runs a finite set of shapes.  The JAX package moves their XLA compiles to
export time.  The port's cold-start wall is different: tracing, and nvcc
for every kernel the programs call (~80 s for `csrc/ft_block.cu` alone).
So `build_aot_pack` writes, into `aot/` inside the artifact:

    <export_dir>/aot/
      manifest.json              # the fingerprint + per-file blake2b digests
      bucket-000016.pt2          # one torch.export program per rung, static
      bucket-000032.pt2          # batch, the weights taken as an input
      ...
      lib/lib<kernel>-<hash>.so  # the kernel libraries those programs call

Each program computes `sigmoid(model(features))` as the exported tier does
(export/artifact.py), with the weights as its first input, a list in
sorted key order, as the JAX pack lowers over a plain list of leaves: one
copy of the weights (weights.npz) serves every rung.  `save_artifact`
writes the pack before `sync_manifest.json`, so the pack's files ride the
fleet digest like any other artifact file.

Load (`try_load_aot`, the `aot` tier of runtime/serve.load_engine and of
the `auto` order): the manifest's fingerprint (torch and CUDA versions,
device kind and compute capability, the kernel sources' hashes, feature
width, heads) must match this host, and every file its digest, before
anything is loaded: a library's digest is checked before ctypes loads it
(`ops/_build.adopt`; the pack's libraries are code, as JAX's pickled
executables are), so no nvcc runs.  Then each program is read with no
trace (journaled `aot_load`).  Any mismatch or error journals
`aot_fallback` and returns None; the caller serves through the exported
program on the same device (`ExportScorer`), never the CPU.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import time
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..device import DeviceLike, resolve_device
from .scorer import BatchScorer

AOT_DIR = "aot"
AOT_MANIFEST = "manifest.json"
AOT_LIB_DIR = "lib"
AOT_FORMAT = 1

_DIGEST_ALGO = "blake2b-16"  # same spelling as fleet's sync_manifest.json

# each `shifu_tpu_torch::` operator and the kernel library (`csrc/<name>.cu`)
# its CUDA implementation loads
_OPERATOR_LIBRARIES = {
    "shifu_tpu_torch.ft_block.default": "ft_block",
    "shifu_tpu_torch.small_attention.default": "small_attention",
    "shifu_tpu_torch.embedding_lookup.default": "embedding_lookup",
    "shifu_tpu_torch.flash_fwd.default": "flash_fwd",
}


def _digest(data: bytes) -> str:
    return hashlib.blake2b(data, digest_size=16).hexdigest()


def _bucket_file(bucket: int) -> str:
    return f"bucket-{int(bucket):06d}.pt2"


def pack_dir(export_dir: str) -> str:
    return os.path.join(export_dir, AOT_DIR)


def has_pack(export_dir: str) -> bool:
    """Cheap existence probe for the auto engine ladder."""
    return os.path.isfile(os.path.join(export_dir, AOT_DIR, AOT_MANIFEST))


def default_buckets() -> tuple[int, ...]:
    """The rung grid of the ServingConfig-default ladder."""
    from ..config.schema import ServingConfig
    from ..runtime.serve import bucket_ladder

    cfg = ServingConfig()
    return bucket_ladder(cfg.min_batch_bucket, cfg.max_batch)


def host_fingerprint(device: DeviceLike = None) -> dict:
    """The serving host's compatibility fields: every one must match the
    pack's manifest or the load falls back."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    return {
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "platform": dev.type,
        "device_kind": (torch.cuda.get_device_name(dev) if on_card
                        else "cpu"),
        "compute_capability": (
            "%d.%d" % torch.cuda.get_device_capability(dev) if on_card
            else None),
    }


def _kernel_sources(names) -> dict[str, str]:
    from ..ops import _build
    return {n: _build.source_hash(n) for n in sorted(names)}


class _LeafScoring(nn.Module):
    """(leaves, features) -> scores, the weights taken as a plain list in
    sorted key order (the JAX pack's `_leaf_fn`): the exported program
    holds no weights of its own."""

    def __init__(self, scoring: nn.Module, keys: list[str]):
        super().__init__()
        self._scoring = [scoring]  # not a submodule: its weights are inputs
        self.keys = keys

    def forward(self, leaves: list[torch.Tensor],
                features: torch.Tensor) -> torch.Tensor:
        return torch.func.functional_call(
            self._scoring[0], dict(zip(self.keys, leaves)), (features,))


def _leaf_keys(flat: dict) -> list[str]:
    return sorted(flat)


def _state_keys(keys: list[str]) -> list[str]:
    """Flax key names -> the scoring module's state_dict names."""
    return ["model." + k.replace("/", ".") for k in keys]


def build_aot_pack(export_dir: str, buckets: tuple[int, ...],
                   device: DeviceLike = None) -> Optional[dict]:
    """Export one static-batch program per bucket rung into
    `<export_dir>/aot/` and copy in the kernel libraries they call, built
    for `device` (default `cuda:0`; a CPU pack carries none); returns the
    manifest, or None when packing failed (journaled `aot_pack_failed`:
    the artifact still serves through the exported program).  Best-effort,
    as in JAX: packing is an export-time optimisation, never an export
    failure."""
    from .. import obs
    from ..ops import _build
    from .artifact import (finish_program, load_artifact,
                           program_operators, scoring_module)

    try:
        dev = resolve_device(device)
        art = load_artifact(export_dir)
        keys = _leaf_keys(art.weights)
        module = scoring_module(export_dir)
        state = module.state_dict()
        leaves = [state[k] for k in _state_keys(keys)]
        leaf_fn = _LeafScoring(module, _state_keys(keys))
        n_feat = int(art.topology["num_features"])

        out_dir = pack_dir(export_dir)
        shutil.rmtree(out_dir, ignore_errors=True)
        os.makedirs(out_dir)
        files: dict[str, str] = {}
        bucket_ms: dict[str, float] = {}
        operators: set[str] = set()
        grid = sorted({int(b) for b in buckets}, reverse=True)  # largest 1st
        t0 = time.perf_counter()
        for b in grid:
            t_b = time.perf_counter()
            with torch.no_grad():
                program = torch.export.export(
                    leaf_fn, (leaves, torch.zeros((b, n_feat))))
            finish_program(program)
            operators |= program_operators(program)
            name = _bucket_file(b)
            path = os.path.join(out_dir, name)
            torch.export.save(program, path)
            with open(path, "rb") as f:
                files[name] = _digest(f.read())
            bucket_ms[str(b)] = round((time.perf_counter() - t_b) * 1e3, 3)
        libraries: dict[str, str] = {}
        if dev.type == "cuda":
            names = sorted({_OPERATOR_LIBRARIES[o] for o in operators})
            _build.build_all(names)
            os.makedirs(os.path.join(out_dir, AOT_LIB_DIR))
            for n in names:
                src = _build.library_path(n)
                rel = os.path.join(AOT_LIB_DIR, os.path.basename(src))
                shutil.copyfile(src, os.path.join(out_dir, rel))
                with open(os.path.join(out_dir, rel), "rb") as f:
                    files[rel] = _digest(f.read())
                libraries[n] = rel
        manifest = {
            "format": AOT_FORMAT,
            **host_fingerprint(dev),
            "kernel_sources": _kernel_sources(libraries),
            "libraries": libraries,
            "num_features": n_feat,
            "num_heads": int(art.topology["num_heads"]),
            "buckets": sorted(grid),
            "weight_keys_digest": _digest("\n".join(keys).encode()),
            "weight_dtypes": {k: str(t.dtype).replace("torch.", "")
                              for k, t in zip(keys, leaves)},
            "algo": _DIGEST_ALGO,
            "files": files,
        }
        with open(os.path.join(out_dir, AOT_MANIFEST), "w") as f:
            json.dump(manifest, f, indent=2, sort_keys=True)
        obs.event("aot_pack", path=export_dir, buckets=sorted(grid),
                  bucket_ms=bucket_ms,
                  wall_ms=round((time.perf_counter() - t0) * 1e3, 3))
        return manifest
    except Exception as e:  # noqa: BLE001 - packing must not fail export
        try:
            obs.event("aot_pack_failed", path=export_dir,
                      error=f"{type(e).__name__}: {e}"[:300])
        except Exception:
            pass
        return None


def pack_bytes(export_dir: str) -> int:
    """Bytes of the pack's files."""
    d = pack_dir(export_dir)
    return sum(os.path.getsize(os.path.join(root, f))
               for root, _dirs, names in os.walk(d) for f in names)


class AotScorer(BatchScorer):
    """Scores through the pack's bucket programs on `device`: no trace and
    no nvcc.  A batch over the largest rung is scored in chunks of it; a
    smaller one is padded up to its rung."""

    engine = "aot"
    static_shapes = True

    def __init__(self, manifest: dict, modules: dict, leaves: list,
                 device: torch.device):
        self.num_features = int(manifest["num_features"])
        self.num_heads = int(manifest["num_heads"])
        self.buckets = tuple(sorted(int(b) for b in manifest["buckets"]))
        self.device = device
        self._modules = modules
        self._leaves = leaves

    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def _run(self, bucket: int, x: np.ndarray) -> np.ndarray:
        with torch.inference_mode():
            feats = torch.from_numpy(x).to(self.device)
            return self._modules[bucket](self._leaves, feats).cpu().numpy()

    def _score_batch(self, x: np.ndarray) -> np.ndarray:
        n = x.shape[0]
        top = self.buckets[-1]
        outs = []
        i = 0
        while i < n:
            take = min(n - i, top)
            b = self._bucket_for(take)
            if take == b and x.flags.writeable:
                xb = x[i:i + take]
            else:  # padded, or a wire frame's read-only buffer
                xb = np.zeros((b, self.num_features), np.float32)
                xb[:take] = x[i:i + take]
            outs.append(self._run(b, xb)[:take])
            i += take
        if not outs:
            return np.zeros((0, self.num_heads), np.float32)
        return outs[0] if len(outs) == 1 else np.concatenate(outs)


def _fingerprint_mismatches(manifest: dict, topo: dict,
                            device: torch.device) -> list[str]:
    """Field-by-field compatibility check; [] means safe to load."""
    bad = []
    host = host_fingerprint(device)
    for field in ("torch_version", "cuda_version", "platform", "device_kind",
                  "compute_capability"):
        want, got = manifest.get(field), host.get(field)
        if want != got:
            bad.append(f"{field}: pack={want!r} host={got!r}")
    libs = manifest.get("libraries", {})
    want_src = manifest.get("kernel_sources", {})
    got_src = _kernel_sources(libs)
    if want_src != got_src:
        bad.append(f"kernel_sources: pack={want_src} host={got_src}")
    n_feat = int(topo.get("num_features", -1))
    if int(manifest.get("num_features", -2)) != n_feat:
        bad.append(f"num_features: pack={manifest.get('num_features')} "
                   f"artifact={n_feat}")
    n_heads = topo.get("num_heads")
    if n_heads is not None \
            and int(manifest.get("num_heads", -2)) != int(n_heads):
        bad.append(f"num_heads: pack={manifest.get('num_heads')} "
                   f"artifact={n_heads}")
    return bad


def try_load_aot(export_dir: str, device: DeviceLike = None):
    """The AOT load tier on `device` (default `cuda:0`): the fingerprint
    and every digest checked, then the kernel libraries adopted from the
    pack (`ops/_build.adopt`) and each bucket program read, with no trace
    and no nvcc (journaled `aot_load`); returns an
    `AotScorer`.  Any mismatch, missing or corrupt file, or load error
    journals `aot_fallback` with the reason and returns None."""
    from .. import obs
    from ..ops import _build
    from .artifact import TOPOLOGY, WEIGHTS
    from .scorer import SIDE_CAR, _reject_extra_inputs, load_program

    dev = resolve_device(device)

    def fallback(reason: str):
        obs.event("aot_fallback", path=export_dir, reason=reason[:400])
        return None

    d = pack_dir(export_dir)
    try:
        with open(os.path.join(d, AOT_MANIFEST)) as f:
            manifest = json.load(f)
    except FileNotFoundError:
        return fallback("no aot pack (aot/manifest.json missing)")
    except Exception as e:
        return fallback(f"unreadable aot manifest: "
                        f"{type(e).__name__}: {e}")
    try:
        if int(manifest.get("format", -1)) != AOT_FORMAT:
            return fallback(
                f"aot pack format {manifest.get('format')!r} "
                f"(this build reads {AOT_FORMAT})")
        with open(os.path.join(export_dir, TOPOLOGY)) as f:
            topo = json.load(f)
        with open(os.path.join(export_dir, SIDE_CAR)) as f:
            _reject_extra_inputs(json.load(f), "aot")
        bad = _fingerprint_mismatches(manifest, topo, dev)
        if bad:
            return fallback("fingerprint mismatch: " + "; ".join(bad))

        with np.load(os.path.join(export_dir, WEIGHTS)) as z:
            flat = {k: z[k] for k in z.files}
        keys = _leaf_keys(flat)
        if _digest("\n".join(keys).encode()) \
                != manifest.get("weight_keys_digest"):
            return fallback("weight key set differs from the pack's "
                            "lowering order")
        files = manifest.get("files", {})
        blobs: dict[str, str] = {}
        for name in [*(_bucket_file(b) for b in manifest["buckets"]),
                     *manifest.get("libraries", {}).values()]:
            want = files.get(name)
            path = os.path.join(d, name)
            try:
                with open(path, "rb") as f:
                    blob = f.read()
            except OSError as e:
                return fallback(f"missing pack file {name}: {e}")
            if want is None or _digest(blob) != want:
                return fallback(f"digest mismatch on {name} "
                                "(corrupt or tampered pack)")
            blobs[name] = path

        t0 = time.perf_counter()
        for kernel, rel in sorted(manifest.get("libraries", {}).items()):
            _build.adopt(kernel, blobs[rel])
        dtypes = manifest.get("weight_dtypes", {})
        leaves = [torch.tensor(flat[k].astype(np.float32)
                               if flat[k].dtype.kind == "V" else flat[k],
                               dtype=getattr(torch, dtypes.get(k, "float32")),
                               device=dev)
                  for k in keys]
        modules = {}
        bucket_ms: dict[str, float] = {}
        for b in sorted(int(x) for x in manifest["buckets"]):
            t_b = time.perf_counter()
            modules[b] = load_program(blobs[_bucket_file(b)], dev)
            bucket_ms[str(b)] = round((time.perf_counter() - t_b) * 1e3, 3)
        scorer = AotScorer(manifest, modules, leaves, dev)
        obs.event("aot_load", path=export_dir,
                  buckets=list(scorer.buckets), bucket_ms=bucket_ms,
                  wall_ms=round((time.perf_counter() - t0) * 1e3, 3),
                  num_features=scorer.num_features,
                  num_heads=scorer.num_heads)
        return scorer
    except Exception as e:  # noqa: BLE001 - degrade, never refuse
        return fallback(f"load failed: {type(e).__name__}: {e}")
