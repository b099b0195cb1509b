"""Telemetry of the port (the JAX package's `shifu_tpu/obs/`, in part):
the metrics registry (`metrics`), the run journal (`journal`), nested span
timing (`spans`), the per-epoch goodput ledger (`goodput`), the step
programs' FLOP and byte counts (`flops`), the device flight recorder
(`devprof`, with the trace rollups of `tracefmt`), the serving plane's
drift sketches and engine (`sketch`, `drift`), SLO engine (`slo`) and
trace context (`tracing`), with the process-global sinks of `_sinks`.

Until `configure(metrics_dir)` (or SHIFU_TPU_METRICS_DIR through
`configure_from_env`) the registry still collects in memory and `event()`
is a no-op, so instrumented call sites never need to know whether
telemetry is on.  The operator's views read what these write: `render`
(`metrics`, `profile`, `trace`, `top`, `drift`), `timeline` and
`aggregate` (with the pod's per-epoch cross-host gather, which finds
torch where a process group is up); they are imported by the commands
that use them, and import no torch.
"""

from __future__ import annotations

from . import (devprof, drift, flops, goodput, journal,  # noqa: F401
               metrics, sketch, slo, spans, tracefmt, tracing)
from ._sinks import (ENV_METRICS_DIR, SCRAPE_FILE, configure,  # noqa: F401
                     configure_from_env, event, flush, get_journal,
                     metrics_dir, reset_for_tests, resolve_metrics_dir,
                     shutdown)
from .journal import RunJournal, read_journal, tail_journal  # noqa: F401
from .metrics import (MetricsRegistry, counter, default_registry,  # noqa: F401
                      gauge, histogram)
from .spans import current_path, span  # noqa: F401
