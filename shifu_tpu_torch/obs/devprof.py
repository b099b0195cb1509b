"""The `obs.trace_epochs` grammar of the JAX package's `obs/devprof.py`.

The port has no flight recorder yet; `ObsConfig.validate` parses the
schedule with this copy so that a job refused there is refused here, with
the same message.  It accepts and refuses the same strings as the JAX
package's `parse_trace_epochs` (`tests/test_torch_data.py` holds the two
together).
"""

from __future__ import annotations

from typing import Callable

# the one definition of "tracing off"
_OFF_TOKENS = ("", "off", "0", "false", "none")


def trace_spec_off(spec: str) -> bool:
    return (spec or "").strip().lower() in _OFF_TOKENS


def parse_trace_epochs(spec: str) -> Callable[[int, int], bool]:
    """`obs.trace_epochs` -> predicate(epoch, start_epoch).

    Forms: "off"/"" (never), "first"/"on" (the first trained epoch only),
    "every:N" (every Nth epoch), or a comma list of epoch numbers
    ("0,2,5").  A malformed spec raises ValueError.
    """
    s = (spec or "").strip().lower()
    if trace_spec_off(s):
        return lambda epoch, start: False
    if s in ("first", "on", "true"):
        return lambda epoch, start: epoch == start
    if s.startswith("every:"):
        n = int(s.split(":", 1)[1])
        if n <= 0:
            raise ValueError(f"obs.trace_epochs every:N needs N > 0: {spec!r}")
        return lambda epoch, start, n=n: epoch % n == 0
    try:
        epochs = frozenset(int(tok) for tok in s.split(",") if tok.strip())
    except ValueError:
        raise ValueError(
            f"obs.trace_epochs must be off/first/every:N/or a comma list "
            f"of epoch numbers: {spec!r}")
    return lambda epoch, start, es=epochs: epoch in es
