"""Seconds from the start of the process to the first timed step:
imports, inputs and weights, the program's set-up, kernel loads and
builds, and the warm-up (host clock)."""


def read(run: dict):
    return run.get("setup_s")
