"""Frequency-tiered embedding placement: hot rows in memory, the cold tail
on a host memmap (port of shifu_tpu/embed/tiering.py).

A 10M x 16 f32 stacked table is ~640 MB a field before its optimizer
slots, but tabular id traffic is zipf-skewed: a small hot set serves
almost every lookup.  `TieredTable` keeps the hot rows in memory and
serves the cold tail from a disk-backed memmap in the cache-v2 entry
format (`embed_cold.npd/` with `entry.json` and `table.bin`, byte for byte
the JAX package's, so each package opens the other's store), the int8
rows on the feature wire's grid (data/pipeline.wire_quantize), a quarter
of the f32 bytes.  Cold fetches run on the host: `attach_dedup(tiered=)`
kicks `prefetch` for the coming batch's unique ids on the feeder's
assembly thread, so the step never waits on the disk.

Every cold read passes the chaos site `embed.offload`; on a fault the
table journals `embed_offload_fallback` and serves the rows from a fresh
memmap handle (or the retained source table with `keep_source=True`).

Host-side numpy, as in the JAX package: the table is not wired into the
train loop there either (`EmbedConfig.tiering` and its siblings are
validated, not read), and nothing here touches the card.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import OrderedDict
from typing import Optional

import numpy as np

_MANIFEST = "entry.json"
_PAYLOAD = "table.bin"
# the prefetch row cache's bound, (field, id) -> row, FIFO: a few batches
# of cold misses, not the vocab
_PREFETCH_CAP = 65536
# the build streams the payload in slices of about this many bytes of f32
_BUILD_SLICE_BYTES = 64 << 20


class TieredTable:
    """Host-side two-tier view of one stacked (Nc, V, D) embedding table."""

    def __init__(self, cold_dir: str, hot_ids: np.ndarray,
                 hot_rows: np.ndarray, source: Optional[np.ndarray] = None):
        self.cold_dir = cold_dir
        with open(os.path.join(cold_dir, _MANIFEST)) as f:
            self.manifest = json.load(f)
        self.shape = tuple(self.manifest["shape"])       # (Nc, V, D)
        self._dtype = self.manifest["dtype"]             # float32 | int8
        self._scale = float(self.manifest.get("scale", 1.0))
        self._mm = self._open()
        self.hot_ids = hot_ids                           # (Nc, H) sorted
        self.hot_rows = hot_rows                         # (Nc, H, D) f32
        self._source = source
        self._cache: OrderedDict = OrderedDict()
        self._lock = threading.Lock()
        self.stats = {"lookups": 0, "hits": 0, "misses": 0,
                      "cold_bytes": 0, "cold_seconds": 0.0,
                      "prefetch_hits": 0, "fallbacks": 0}

    # -- construction -------------------------------------------------------

    @staticmethod
    def build(table: np.ndarray, cold_dir: str, *, hot_rows: int = 0,
              hot_fraction: float = 0.05, freq: Optional[np.ndarray] = None,
              tier_dtype: str = "float32",
              keep_source: bool = False) -> "TieredTable":
        """Write the cold store of `table` (Nc, V, D) under
        `cold_dir/embed_cold.npd/` and return the tiered view.

        The hot set: the top `hot_rows` ids a field by `freq` ((Nc, V)
        counts) when given, else the lowest ids (Shifu's binning numbers a
        vocab in descending frequency).  `tier_dtype="int8"` stores the
        cold rows on the wire grid (scale max|x| / 127, symmetric): within
        half a step of f32; "float32" is exact.  `keep_source` retains the
        f32 table as the fallback of last resort (leave it off at 10M
        vocab).  The payload is written in ~64 MB slices, so the build
        never holds a second full-size copy."""
        from ..data.pipeline import wire_quantize

        table = np.asarray(table, np.float32)
        nc, v, d = table.shape
        entry = os.path.join(cold_dir, "embed_cold.npd")
        os.makedirs(entry, exist_ok=True)
        manifest = {"shape": [nc, v, d], "dtype": tier_dtype, "version": 1}
        chunk = max(1, _BUILD_SLICE_BYTES // max(d * 4, 1))
        if tier_dtype == "int8":
            amax = 0.0
            for f in range(nc):
                for lo in range(0, v, chunk):
                    amax = max(amax, float(
                        np.abs(table[f, lo:lo + chunk]).max(initial=0.0)))
            scale = max(amax, 1e-12) / 127.0
            manifest["scale"] = scale

            def enc(x):
                return wire_quantize(x, np.float32(scale), np.float32(0.0))
        elif tier_dtype == "float32":
            def enc(x):
                return np.ascontiguousarray(x, np.float32)
        else:
            raise ValueError(
                f"tier_dtype must be float32|int8: {tier_dtype!r}")
        with open(os.path.join(entry, _PAYLOAD), "wb") as fh:
            for f in range(nc):
                for lo in range(0, v, chunk):
                    fh.write(enc(table[f, lo:lo + chunk]).tobytes())
        with open(os.path.join(entry, _MANIFEST), "w") as f:
            json.dump(manifest, f)

        h = int(hot_rows) if hot_rows > 0 else max(1, int(v * hot_fraction))
        h = min(h, v)
        if freq is not None:
            order = np.argsort(-np.asarray(freq), axis=1, kind="stable")
            hot_ids = np.sort(order[:, :h].astype(np.int64), axis=1)
        else:
            hot_ids = np.tile(np.arange(h, dtype=np.int64)[None, :], (nc, 1))
        hot = np.stack([table[f, hot_ids[f]] for f in range(nc)])
        return TieredTable(entry, hot_ids, hot,
                           source=table if keep_source else None)

    def _open(self):
        mm_dtype = np.int8 if self._dtype == "int8" else np.float32
        return np.memmap(os.path.join(self.cold_dir, _PAYLOAD),
                         dtype=mm_dtype, mode="r", shape=self.shape)

    # -- reads --------------------------------------------------------------

    @property
    def hot_count(self) -> int:
        return self.hot_ids.shape[1]

    def _decode(self, rows: np.ndarray) -> np.ndarray:
        if self._dtype == "int8":
            from ..data.pipeline import wire_dequantize
            return wire_dequantize(rows, self._scale, 0.0)
        return np.asarray(rows, np.float32)

    def _cold_read(self, f: int, ids: np.ndarray) -> np.ndarray:
        """Cold rows of field f through the chaos site, with the journaled
        fallback on a fault."""
        from .. import chaos, obs
        t0 = time.perf_counter()
        try:
            chaos.maybe_fail("embed.offload", path=self.cold_dir, field=f)
            rows = np.asarray(self._mm[f, ids])
        except (chaos.ChaosError, OSError, ValueError) as e:
            self.stats["fallbacks"] += 1
            obs.event("embed_offload_fallback", field=f,
                      rows=int(ids.size), error=type(e).__name__,
                      detail=str(e)[:200])
            obs.counter("embed_offload_fallbacks_total",
                        "cold-tier read faults served by the fallback "
                        "chain").inc()
            if self._source is not None:
                rows = self._source[f, ids]
            else:
                self._mm = self._open()  # a fresh handle, then read again
                rows = np.asarray(self._mm[f, ids])
        self.stats["cold_seconds"] += time.perf_counter() - t0
        self.stats["cold_bytes"] += int(rows.nbytes)
        return self._decode(rows)

    def lookup(self, ids: np.ndarray) -> np.ndarray:
        """(B, Nc) int ids -> (B, Nc, D) f32: hot rows from memory, cold
        rows from the prefetch cache or the memmap.  Out-of-range ids (the
        dedup sentinel) give zero rows."""
        ids = np.asarray(ids)
        b, nc = ids.shape
        out = np.zeros((b, nc, self.shape[2]), np.float32)
        self.stats["lookups"] += 1
        for f in range(nc):
            col = ids[:, f]
            valid = (col >= 0) & (col < self.shape[1])
            pos = np.searchsorted(self.hot_ids[f], col)
            pos_c = np.minimum(pos, self.hot_count - 1)
            hot = valid & (self.hot_ids[f][pos_c] == col)
            out[hot, f] = self.hot_rows[f, pos_c[hot]]
            self.stats["hits"] += int(hot.sum())
            cold = valid & ~hot
            n_cold = int(cold.sum())
            if not n_cold:
                continue
            self.stats["misses"] += n_cold
            cold_ids = col[cold]
            rows = np.empty((n_cold, self.shape[2]), np.float32)
            need = np.ones(n_cold, bool)
            with self._lock:
                for j, cid in enumerate(cold_ids):
                    r = self._cache.get((f, int(cid)))
                    if r is not None:
                        rows[j] = r
                        need[j] = False
                        self.stats["prefetch_hits"] += 1
            if need.any():
                rows[need] = self._cold_read(f, cold_ids[need])
            out[cold, f] = rows
        return out

    # -- prefetch -----------------------------------------------------------

    def prefetch(self, ids: np.ndarray) -> threading.Thread:
        """Warm the row cache with a coming batch's cold rows on a
        background thread; returns the thread (joinable).  Faults take the
        same fallback."""
        ids = np.array(ids, copy=True)

        def work():
            for f in range(ids.shape[1]):
                col = np.unique(ids[:, f])
                col = col[(col >= 0) & (col < self.shape[1])]
                pos = np.minimum(np.searchsorted(self.hot_ids[f], col),
                                 self.hot_count - 1)
                cold = col[self.hot_ids[f][pos] != col]
                if not cold.size:
                    continue
                rows = self._cold_read(f, cold)
                with self._lock:
                    for cid, r in zip(cold, rows):
                        self._cache[(f, int(cid))] = r
                    while len(self._cache) > _PREFETCH_CAP:
                        self._cache.popitem(last=False)

        t = threading.Thread(target=work, name="embed-prefetch", daemon=True)
        t.start()
        return t

    # -- telemetry ----------------------------------------------------------

    def tier_report(self) -> dict:
        """Journal the counters as `embed_tier_report` (and gauges) and
        return them; `profile` and `top` render the event."""
        from .. import obs
        s = dict(self.stats)
        total = s["hits"] + s["misses"]
        s["hit_rate"] = round(s["hits"] / total, 4) if total else 1.0
        s["hot_rows"] = self.hot_count
        s["vocab"] = self.shape[1]
        obs.event("embed_tier_report", **s)
        obs.gauge("embed_tier_hit_rate",
                  "hot-tier hit rate over row lookups").set(s["hit_rate"])
        obs.gauge("embed_cold_fetch_bytes_total",
                  "bytes fetched from the cold tier").set(s["cold_bytes"])
        obs.gauge("embed_cold_fetch_seconds_total",
                  "host seconds spent in cold-tier reads").set(
                      round(s["cold_seconds"], 6))
        return s
