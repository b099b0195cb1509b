"""Rows trained over the whole window, over the window's seconds (host
clock, the window ending after a synchronise)."""


def read(run: dict):
    if "samples" not in run:
        return None
    return run["samples"] / run["window_s"]
