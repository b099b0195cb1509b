"""Rows scored over the whole window, over the window's seconds (host
clock)."""


def read(run: dict):
    if "rows" not in run:
        return None
    return run["rows"] / run["window_s"]
