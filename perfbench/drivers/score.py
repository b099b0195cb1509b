"""Bulk scoring by one closed-loop caller through the serving daemon.

Set-up draws the weights from the seed, builds the model with them and
writes its artifact with `export.artifact.save_artifact` into a fresh
directory under TMPDIR; a `runtime.serve.ModelRegistry` loads it with the
traffic's engine on the device, warmed at the one batch shape the traffic
sends, and a `runtime.serve.ScoringDaemon` serves from that registry.
The pool of rows is made on the device from the seed and held on the
host, as a caller's float32 arrays; call k sends the `batch_rows` rows
that start at k * batch_rows, wrapping at the pool's end.  The caller
waits for each `score_batch` before it sends the next, and each call's
latency is the host clock around it.

After the window (and the traced segment) the daemon's model is freed and
the reference scores the whole pool once, in float32, in blocks; every
answer of every call is compared with it.
"""

from __future__ import annotations

import functools
import math
import os
import time

import numpy as np
import torch

from ..core import compare, inputs, trace
from ..core.session import Session
from ..reference import ft_transformer as ref_model
from .train import job_config


class Caller:
    """The daemon with its artifact, and the pool of rows the caller
    sends."""

    def __init__(self, s: Session):
        from shifu_tpu_torch.config.schema import ServingConfig
        from shifu_tpu_torch.export.artifact import save_artifact
        from shifu_tpu_torch.models.registry import build_model
        from shifu_tpu_torch.runtime.serve import (ModelRegistry,
                                                   ScoringDaemon,
                                                   load_engine)

        cfg, traffic = s.config, s.traffic
        self.b = traffic["batch_rows"]
        self.pool_rows = traffic["pool_rows"]
        f = cfg["n_num_features"]
        s.mark("imports")
        self.weights = inputs.ft_weights(cfg, s.seed, s.device)
        self.pool = inputs.numeric_rows(self.pool_rows, f, s.seed, s.device)
        host = self.pool.cpu()
        # the pool with its first batch repeated at the end, so that every
        # call's rows are one contiguous slice
        self.host = torch.cat([host, host[:self.b]]).numpy()
        s.mark("inputs")
        job = job_config(cfg, traffic, s.seed)
        model = build_model(job.model, job.schema, "cpu")
        model.load_state_dict({k: v.cpu() for k, v in self.weights.items()})
        self.export_dir = os.path.join(s.tmpdir, "artifact")
        save_artifact(model, job.model, job.schema, self.export_dir)
        del model
        s.mark("artifact")
        self.registry = ModelRegistry(
            loader=functools.partial(load_engine, device=s.device),
            warm_ladder=(self.b,))
        self.registry.load(self.export_dir, engine=traffic["engine"])
        self.daemon = ScoringDaemon(
            config=ServingConfig(engine=traffic["engine"], max_batch=self.b),
            registry=self.registry)
        s.mark("daemon")
        self.calls = 0
        self.outputs: list = []

    def call(self) -> float:
        """One call, the next slice of the pool; returns its seconds."""
        lo = (self.calls * self.b) % self.pool_rows
        rows = self.host[lo:lo + self.b]
        t0 = time.perf_counter()
        try:
            out = self.daemon.score_batch(rows)
        except Exception:  # a failed call has no answer; the loop goes on
            out = None
        dt = time.perf_counter() - t0
        self.outputs.append((lo, out))
        self.calls += 1
        return dt

    def close(self) -> None:
        self.registry.close()

    def answers_gap(self, ref: torch.Tensor) -> tuple[float, int]:
        """(the widest gap of a served answer from the reference's, the
        calls whose answer is missing or of the wrong shape)."""
        ref = ref.cpu()
        ref = torch.cat([ref, ref[:self.b]]).numpy()
        worst, missing = 0.0, 0
        for lo, out in self.outputs:
            want = ref[lo:lo + self.b]
            if out is None or np.shape(out) != want.shape:
                missing += 1
                continue
            d = np.abs(np.asarray(out, np.float32) - want)
            gap = float(d.max()) if np.isfinite(d).all() else math.inf
            worst = max(worst, gap)
        return worst, missing


def run(s: Session) -> dict:
    traffic = s.traffic
    c = Caller(s)
    for _ in range(traffic["warm_calls"]):
        c.call()
    c.outputs.clear()
    c.calls = 0
    s.sync()
    s.mark("warm_calls")
    t0 = s.now()
    setup_s = t0 - s.t_start
    latencies = []
    while True:
        latencies.append(c.call())
        if s.now() - t0 >= s.seconds:
            break
    s.sync()
    window_s = s.now() - t0
    n = len(latencies)

    reduced = None
    if s.trace:
        def segment():
            t1 = s.now()
            while s.now() - t1 < traffic["trace_seconds"]:
                c.call()
        reduced = trace.capture(segment, os.path.join(s.tmpdir,
                                                      "trace.json"), s.sync)
    peak = s.memory_peak_bytes()
    c.close()
    weights, pool = c.weights, c.pool
    c.daemon = c.registry = None
    s.free()

    ref = ref_model.probabilities(weights, pool, s.config, "f32")
    gap, missing = c.answers_gap(ref)
    return {"setup_s": setup_s, "window_s": window_s, "calls": n,
            "rows": n * traffic["batch_rows"], "latencies_s": latencies,
            "attempted": len(c.outputs), "failed": missing,
            "memory_peak_bytes": peak, "trace": reduced,
            "readings": {"score_gap": gap, "answers_compared":
                         len(c.outputs) - missing}}


def readings(s: Session) -> dict:
    """The numbers the limit is set from, for one seed: the program's
    answers for every row of the pool through the timed path, and the
    control (the reference in fp8 in the program's place), each against
    the float32 reference.  No window."""
    c = Caller(s)
    n_calls = -(-c.pool_rows // c.b)
    for _ in range(n_calls):
        c.call()
    c.close()
    weights, pool = c.weights, c.pool
    c.daemon = c.registry = None
    s.free()
    ref = ref_model.probabilities(weights, pool, s.config, "f32")
    gap, missing = c.answers_gap(ref)
    control = ref_model.probabilities(weights, pool, s.config, "fp8")
    return {"program": {"score_gap": gap, "missing": missing},
            "control": {"score_gap": compare.score_gap(control, ref)}}
