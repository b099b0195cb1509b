"""Process-global telemetry sinks (port of shifu_tpu/obs/_sinks.py): where
the registry and the journal land.

One journal and one scrape file per process, configured once (explicitly,
or lazily from SHIFU_TPU_METRICS_DIR).  Call sites stay sink-agnostic:
`obs.event(...)` does nothing until a journal is configured, and the
default registry always collects in memory.
"""

from __future__ import annotations

import os
import threading
from typing import Optional

from ..data import fsio
from . import journal as journal_mod
from . import metrics as metrics_mod

ENV_METRICS_DIR = "SHIFU_TPU_METRICS_DIR"
SCRAPE_FILE = "metrics.prom"

_lock = threading.RLock()
_journal: Optional[journal_mod.RunJournal] = None
_scrape_path: Optional[str] = None
_metrics_dir: Optional[str] = None


def resolve_metrics_dir(explicit: Optional[str] = None) -> Optional[str]:
    """Explicit argument wins; else SHIFU_TPU_METRICS_DIR; else None."""
    return explicit or os.environ.get(ENV_METRICS_DIR) or None


def configure(metrics_dir: str, scrape: bool = True,
              flush_every: int = 16,
              journal_name: str = journal_mod.JOURNAL_FILE
              ) -> journal_mod.RunJournal:
    """Point this process's telemetry at `metrics_dir` (a local directory
    or a remote URI): the journal at <dir>/<journal_name>, the scrape file at
    <dir>/metrics.prom (unless `scrape=False`).  Reconfiguring closes the
    previous journal."""
    global _journal, _scrape_path, _metrics_dir
    with _lock:
        if _journal is not None:
            _journal.close()
        _metrics_dir = metrics_dir
        _journal = journal_mod.RunJournal(
            fsio.join(metrics_dir, journal_name), flush_every=flush_every)
        _scrape_path = fsio.join(metrics_dir, SCRAPE_FILE) if scrape else None
        return _journal


def set_journal(journal: Optional[journal_mod.RunJournal]) -> None:
    """Install a journal object directly (an in-memory journal for a tool
    that prints its records at the end)."""
    global _journal
    with _lock:
        _journal = journal


def configure_from_env() -> bool:
    """Configure sinks from SHIFU_TPU_METRICS_DIR, if set and nothing is
    configured yet.  Returns True when a journal is active after the call
    (the hook `train()` uses, so a bare env var is enough)."""
    with _lock:
        if _journal is not None:
            return True
        d = os.environ.get(ENV_METRICS_DIR)
        if not d:
            return False
        try:
            configure(d)
            return True
        except Exception:
            return False


def metrics_dir() -> Optional[str]:
    """The directory the sinks were configured at (None until then); the
    device-trace dir (obs/devprof.py) anchors beside it."""
    return _metrics_dir


def get_journal() -> Optional[journal_mod.RunJournal]:
    return _journal


def event(kind: str, **fields) -> Optional[dict]:
    """Journal one event; no-op (returns None) when no journal is
    configured.  Never raises: telemetry must not fail the caller."""
    j = _journal
    if j is None:
        return None
    try:
        return j.event(kind, **fields)
    except Exception:
        return None


def flush() -> None:
    """Flush the journal and (re)write the Prometheus scrape file."""
    with _lock:
        if _journal is not None:
            _journal.flush()
        if _scrape_path is not None:
            metrics_mod.write_scrape_file(_scrape_path)


def shutdown() -> None:
    """flush + close the journal (job end)."""
    global _journal
    with _lock:
        flush()
        if _journal is not None:
            _journal.close()
            _journal = None


def reset_for_tests() -> None:
    """Tear down all global telemetry state (tests only)."""
    global _journal, _scrape_path, _metrics_dir
    with _lock:
        if _journal is not None:
            try:
                _journal.close()
            except Exception:
                pass
        _journal = None
        _scrape_path = None
        _metrics_dir = None
        metrics_mod.default_registry().clear()
        from . import flops, goodput
        flops.reset_for_tests()
        goodput.reset_for_tests()
