"""Native scorer packaging, build, and ctypes binding (port of
shifu_tpu/runtime/native_scorer.py): the engine "native".

Pipeline: `pack_native(export_dir)` converts an artifact's topology.json +
weights.npz into the flat `model.bin` the C++ engine reads, byte for byte
what the JAX package's `pack_native` writes for the same artifact, so
either package's engine loads the other's file; `build_library()` compiles
the port's copy of `csrc/shifu_scorer.cc` once (g++, no deps, through
runtime/nativelib.py into `shifu_tpu_torch/_build/`); `NativeScorer` binds
the C ABI via ctypes with the same compute / compute_batch API as the
numpy `Scorer`.  Host code: it scores on the CPU, with no torch and no
CUDA at score time.
"""

from __future__ import annotations

import ctypes
import json
import os
import struct
from typing import Optional, Sequence

import numpy as np

_ACT_IDS = {"linear": 0, None: 0, "": 0, "sigmoid": 1, "tanh": 2,
            "relu": 3, "leakyrelu": 4, "gelu": 5, "softmax": 6}

_OP_CODES = {"dense": 0, "gather_cols": 1, "embed_lookup": 2,
             "numeric_embed": 3, "concat": 4, "flatten": 5, "sum_fields": 6,
             "add": 7, "fm_pair": 8, "activation": 9, "cls_prepend": 10,
             "layernorm": 11, "select_token": 12, "transformer_block": 13,
             "expert_dense": 14, "moe_combine": 15, "constant": 16}

_MAGIC = 0x55464853  # "SHFU"
_VERSION = 3  # model.bin format — must match kVersion in shifu_scorer.cc
# v3 adds kConstant (sidecar extra-input constants); v2 artifacts repack
# automatically from topology.json + the sidecar (_is_current)
_NO_BUF = 0xFFFFFFFF
MODEL_BIN = "model.bin"

# single source of truth for the 12-array serialization order; the C++
# reader's sizes[12] table (shifu_scorer.cc read_op kTransformerBlock)
# consumes them in this exact order
from ..export.program import WEIGHT_FIELDS as _WEIGHT_FIELDS

_TBLOCK_WEIGHTS = _WEIGHT_FIELDS["transformer_block"]


def _act_id(name) -> int:
    act = _ACT_IDS.get(name)
    if act is None:
        raise ValueError(f"unknown activation {name!r}")
    return act


def _src_digest(export_dir: str) -> str:
    """Digest of everything a packed model.bin derives from: topology and
    sidecar CONTENT (small json — hashing dodges mtime-granularity races on
    the runtime-configurable extra-input values), weights by (size, mtime)
    (they are written once at export and can be large)."""
    import hashlib

    h = hashlib.sha256()
    for name in ("topology.json", "GenericModelConfig.json"):
        p = os.path.join(export_dir, name)
        if os.path.exists(p):
            with open(p, "rb") as f:
                h.update(f.read())
        h.update(b"|")
    wp = os.path.join(export_dir, "weights.npz")
    if os.path.exists(wp):
        st = os.stat(wp)
        h.update(f"{st.st_size}:{st.st_mtime_ns}".encode())
    return h.hexdigest()


def pack_native(export_dir: str) -> str:
    """Pack topology.json + weights.npz (+ sidecar extra inputs) into
    model.bin (format v3, the binary mirror of export/program.py's op
    list); returns its path."""
    with open(os.path.join(export_dir, "topology.json")) as f:
        topo = json.load(f)
    program = topo.get("program")
    if not program:
        raise ValueError(
            f"artifact has no op-list program (model_type="
            f"{topo.get('model_type')!r}); score it with the torch engine")
    with np.load(os.path.join(export_dir, "weights.npz")) as z:
        weights = {k: np.asarray(z[k], dtype=np.float32) for k in z.files}

    # assign buffer ids; "input" is 0
    buf_ids: dict[str, int] = {"input": 0}

    def bid(name: str) -> int:
        if name not in buf_ids:
            buf_ids[name] = len(buf_ids)
        return buf_ids[name]

    records: list[bytes] = []

    # sidecar extra named inputs (TensorflowModel.java:74-87: inputNames[1:]
    # fed from GenericModelConfig properties): their values are load-time
    # constants, so they lower to kConstant ops seeding `input:<name>`
    # buffers before the program body runs.  Extraction/validation is shared
    # with the numpy Scorer (export.scorer.extra_inputs_from_sidecar) so the
    # two engines cannot desynchronize on the contract.
    sidecar_path = os.path.join(export_dir, "GenericModelConfig.json")
    if os.path.exists(sidecar_path):
        from ..export.scorer import extra_inputs_from_sidecar
        with open(sidecar_path) as f:
            sidecar = json.load(f)
        for name, value in extra_inputs_from_sidecar(sidecar).items():
            records.append(b"".join([
                struct.pack("<3I", _OP_CODES["constant"],
                            bid(f"input:{name}"), _NO_BUF),
                struct.pack("<I", value.shape[0]),
                np.ascontiguousarray(value).tobytes(),
            ]))
    prev_dst = None  # chain threading is per-PROGRAM op (constants excluded)
    for op in program:
        kind = op["op"]
        code = _OP_CODES.get(kind)
        if code is None:
            raise ValueError(f"native pack: unsupported op {kind!r}")
        # v1 artifacts: dense chain without src/out — thread implicitly
        src = (bid(op["src"]) if "src" in op
               else (prev_dst if prev_dst is not None else 0))
        dst = bid(op["out"]) if "out" in op else bid(f"__chain{len(records)}")
        parts = [struct.pack("<3I", code, dst,
                             _NO_BUF if kind in ("concat", "add",
                                                 "moe_combine") else src)]
        if kind == "dense":
            kernel, bias = weights[op["kernel"]], weights[op["bias"]]
            if kernel.ndim != 2 or bias.shape != (kernel.shape[1],):
                raise ValueError(f"bad shapes for {op['kernel']}: "
                                 f"{kernel.shape} / {bias.shape}")
            parts.append(struct.pack("<3I", _act_id(op.get("activation")),
                                     kernel.shape[0], kernel.shape[1]))
            parts.append(np.ascontiguousarray(kernel).tobytes())
            parts.append(np.ascontiguousarray(bias).tobytes())
        elif kind == "gather_cols":
            pos = np.asarray(op["positions"], np.uint32)
            parts.append(struct.pack("<I", len(pos)))
            parts.append(pos.tobytes())
        elif kind == "embed_lookup":
            table = weights[op["table"]]  # (nf, max_vocab, dim)
            nf, maxv, dim = table.shape
            pos = np.asarray(op["positions"], np.uint32)
            vocab = np.asarray(op["vocabs"], np.uint32)
            if len(pos) != nf or len(vocab) != nf:
                raise ValueError(f"embed_lookup field mismatch: table {nf} "
                                 f"vs positions {len(pos)}/vocabs {len(vocab)}")
            parts.append(struct.pack("<3I", nf, maxv, dim))
            parts.append(pos.tobytes())
            parts.append(vocab.tobytes())
            parts.append(np.ascontiguousarray(table).tobytes())
        elif kind == "numeric_embed":
            w, b = weights[op["weight"]], weights[op["bias"]]
            parts.append(struct.pack("<2I", w.shape[0], w.shape[1]))
            parts.append(np.ascontiguousarray(w).tobytes())
            parts.append(np.ascontiguousarray(b).tobytes())
        elif kind in ("concat", "add", "moe_combine"):
            srcs = np.asarray([bid(s) for s in op["srcs"]], np.uint32)
            parts.append(struct.pack("<I", len(srcs)))
            parts.append(srcs.tobytes())
        elif kind in ("flatten", "sum_fields", "fm_pair"):
            pass
        elif kind == "activation":
            parts.append(struct.pack("<I", _act_id(op.get("fn"))))
        elif kind == "cls_prepend":
            token = weights[op["token"]].reshape(-1)
            parts.append(struct.pack("<I", token.shape[0]))
            parts.append(np.ascontiguousarray(token).tobytes())
        elif kind == "layernorm":
            scale, bias = weights[op["scale"]], weights[op["bias"]]
            parts.append(struct.pack("<I", scale.shape[0]))
            parts.append(np.ascontiguousarray(scale).tobytes())
            parts.append(np.ascontiguousarray(bias).tobytes())
        elif kind == "select_token":
            parts.append(struct.pack("<I", int(op["index"])))
        elif kind == "expert_dense":
            kernel = weights[op["kernel"]]   # (E, I, O)
            bias = weights[op["bias"]]       # (E, O)
            if kernel.ndim != 3 or bias.shape != (kernel.shape[0],
                                                  kernel.shape[2]):
                raise ValueError(f"bad shapes for {op['kernel']}: "
                                 f"{kernel.shape} / {bias.shape}")
            parts.append(struct.pack("<4I", _act_id(op.get("activation")),
                                     *kernel.shape))
            parts.append(np.ascontiguousarray(kernel).tobytes())
            parts.append(np.ascontiguousarray(bias).tobytes())
        elif kind == "transformer_block":
            d = weights[op["ln_attn_scale"]].shape[0]
            mh = weights[op["mlp_in_kernel"]].shape[1]
            parts.append(struct.pack("<3I", d, int(op["num_heads"]), mh))
            for field in _TBLOCK_WEIGHTS:
                parts.append(
                    np.ascontiguousarray(weights[op[field]]).tobytes())
        records.append(b"".join(parts))
        prev_dst = dst

    out_path = os.path.join(export_dir, MODEL_BIN)
    with open(out_path, "wb") as f:
        f.write(struct.pack("<6I", _MAGIC, _VERSION, int(topo["num_features"]),
                            int(topo["num_heads"]), len(buf_ids),
                            len(records)))
        f.write(b"".join(records))
    with open(out_path + ".meta", "w") as f:
        json.dump({"format_version": _VERSION,
                   "src_digest": _src_digest(export_dir)}, f)
    return out_path


def build_library(out_dir: Optional[str] = None, force: bool = False) -> str:
    """Compile the C++ engine into a shared library (cached by content;
    `force` rebuilds a current one); returns its path."""
    from .nativelib import build_library as _build
    return _build("shifu_scorer.cc", extra_flags=["-pthread"],
                  out_dir=out_dir, force=force)


from ..export.scorer import BatchScorer


class NativeScorer(BatchScorer):
    """ctypes wrapper over the C ABI; API-compatible with export.Scorer
    (rides the shared BatchScorer dispatch seam, so the serving daemon
    wraps it like any other engine)."""

    engine = "native"

    def __init__(self, export_dir: str, lib_path: Optional[str] = None):
        bin_path = os.path.join(export_dir, MODEL_BIN)
        if not self._is_current(bin_path):
            pack_native(export_dir)
        self._lib = ctypes.CDLL(lib_path or build_library())
        self._lib.shifu_scorer_load.restype = ctypes.c_void_p
        self._lib.shifu_scorer_load.argtypes = [ctypes.c_char_p]
        self._lib.shifu_scorer_free.argtypes = [ctypes.c_void_p]
        self._lib.shifu_scorer_num_features.argtypes = [ctypes.c_void_p]
        self._lib.shifu_scorer_num_heads.argtypes = [ctypes.c_void_p]
        self._lib.shifu_scorer_compute_batch.restype = ctypes.c_int
        self._lib.shifu_scorer_compute_batch.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
            ctypes.POINTER(ctypes.c_float)]
        self._lib.shifu_scorer_compute.restype = ctypes.c_double
        self._lib.shifu_scorer_compute.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_double)]
        self._handle = self._lib.shifu_scorer_load(bin_path.encode())
        if not self._handle:
            raise RuntimeError(f"failed to load native model: {bin_path}")
        self.num_features = self._lib.shifu_scorer_num_features(self._handle)
        self.num_heads = self._lib.shifu_scorer_num_heads(self._handle)

    @staticmethod
    def _is_current(bin_path: str) -> bool:
        """True when model.bin exists with the current format version AND
        its recorded source digest matches the artifact's current sources —
        an edited sidecar (the reference's runtime-configurable extra-input
        values, TensorflowModel.java:74-87) or topology triggers a repack
        instead of silently serving stale baked-in constants.  Content
        digests, not mtimes: coarse-granularity filesystems make
        same-tick edits invisible to timestamp comparison."""
        try:
            with open(bin_path, "rb") as f:
                magic, version = struct.unpack("<2I", f.read(8))
            if magic != _MAGIC or version != _VERSION:
                return False
            meta_path = bin_path + ".meta"
            if not os.path.exists(meta_path):
                return False  # packed by an older release: repack
            with open(meta_path) as f:
                meta = json.load(f)
            return meta.get("src_digest") == _src_digest(
                os.path.dirname(bin_path))
        except Exception:
            return False

    def _as_batch(self, rows: np.ndarray) -> np.ndarray:
        # contiguity is part of the C ABI (raw pointer + row stride)
        x = np.ascontiguousarray(rows, dtype=np.float32)
        if x.ndim == 1:
            x = x[None, :]
        if x.shape[1] != self.num_features:
            raise ValueError(f"expected {self.num_features} features, got {x.shape[1]}")
        return x

    def _score_batch(self, x: np.ndarray) -> np.ndarray:
        x = np.ascontiguousarray(x)  # seam callers may pass non-contiguous
        n = x.shape[0]
        out = np.empty((n, self.num_heads), dtype=np.float32)
        rc = self._lib.shifu_scorer_compute_batch(
            self._handle,
            x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        if rc != 0:
            raise RuntimeError(f"native scorer error code {rc}")
        return out

    def compute(self, row: Sequence[float]) -> float:
        r = np.ascontiguousarray(row, dtype=np.float64)
        if r.shape[0] != self.num_features:
            raise ValueError(f"expected {self.num_features} features, got {r.shape[0]}")
        return float(self._lib.shifu_scorer_compute(
            self._handle, r.ctypes.data_as(ctypes.POINTER(ctypes.c_double))))

    def close(self) -> None:
        if getattr(self, "_handle", None):
            self._lib.shifu_scorer_free(self._handle)
            self._handle = None

    def __del__(self):  # best-effort
        try:
            self.close()
        except Exception:
            pass
