"""Telemetry of the port (the JAX package's `shifu_tpu/obs/`, in part):
the metrics registry (`metrics`), the run journal (`journal`), nested span
timing (`spans`) and the per-epoch goodput ledger (`goodput`), with the
process-global sinks of `_sinks`; and the grammar of `obs.trace_epochs`
(`devprof`), which config validation reads.

Until `configure(metrics_dir)` (or SHIFU_TPU_METRICS_DIR through
`configure_from_env`) the registry still collects in memory and `event()`
is a no-op, so instrumented call sites never need to know whether
telemetry is on.  The flight recorder (devprof on torch.profiler), the
cross-host aggregation and the renderers wait for later slices
(ROADMAP.md queue A).
"""

from __future__ import annotations

from . import devprof, goodput, journal, metrics, spans  # noqa: F401
from ._sinks import (ENV_METRICS_DIR, SCRAPE_FILE, configure,  # noqa: F401
                     configure_from_env, event, flush, get_journal,
                     reset_for_tests, resolve_metrics_dir, shutdown)
from .journal import RunJournal, read_journal, tail_journal  # noqa: F401
from .metrics import (MetricsRegistry, counter, default_registry,  # noqa: F401
                      gauge, histogram)
from .spans import current_path, span  # noqa: F401
