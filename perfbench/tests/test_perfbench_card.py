"""On the card, at the cells' own sizes: a short run of each cell is
correct, and the control (the reference in fp8 in the program's place)
fails one of the cell's limits while the program meets them all.

    python -m pytest perfbench/tests/test_perfbench_card.py -q -m card
"""

import shutil
import tempfile
import time

import pytest

from perfbench import run
from perfbench.core import manifest
from perfbench.core.session import Session

CELLS = ("ft-b2-d128.train", "ft-b3-d192.score")


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_short_run_is_correct(card, cell):
    r = run.execute(cell, 2**31 + 101, 2.0, False, card)
    assert r["correct"], r["checks"]
    assert not r["missing"]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_program_meets_the_limits(card, cell):
    entry = manifest.cell(manifest.load(), cell)
    limits = entry["workload"]["limits"]
    s = Session(cell, 2**31 + 202, 0.0, False, card, entry["config_file"],
                dict(entry["traffic_file"]), time.perf_counter(),
                tempfile.mkdtemp())
    try:
        got = manifest.driver(entry["traffic_file"]["driver"]).readings(s)
    finally:
        shutil.rmtree(s.tmpdir)
    assert any(got["control"][k] > lim for k, lim in limits.items())
    assert all(got["program"][k] <= lim for k, lim in limits.items())
