"""`obs.aggregate.gather_host_summaries` with its byte cap, against the JAX
package's.

Two gloo ranks (spawned by `torch_mesh_helpers.run_ranks`, one process
each) gather the summaries of each case below; every rank must get JAX's
rows.  JAX's rows come from its own function on the CPU, with
`jax.process_count` and `multihost_utils.process_allgather` stood in for
by the two ranks' packed rows: each rank's row is what JAX packs from its
summary, and the gather returns them stacked in rank order.  The cases:
rows within the cap come back in rank order; an oversized summary comes
back as JAX's `_truncated` marker; a marker that the cap itself cuts no
longer decodes and comes back as JAX's `_undecodable` row.  A process
alone gets its summary back and runs no collective, in both packages.

The rank function lives here and imports JAX nowhere: a spawned rank
imports this module, and JAX only in the parent's tests.
"""

import json
import sys

import numpy as np
import pytest

import torch_mesh_helpers as helpers

BIG = "x" * 600
# (summaries by rank, max_bytes)
CASES = {
    "within_the_cap": ([{"host": "h0", "rank": 0, "input_s": 1.5},
                        {"host": "h1", "rank": 1, "input_s": 0.25,
                         "extra": [1, 2]}], 4096),
    "oversized": ([{"host": "h0", "rank": 0, "input_s": 1.0},
                   {"host": "h1", "rank": 1, "blob": BIG}], 256),
    "undecodable": ([{"host": "h0", "rank": 0, "blob": BIG},
                     {"rank": 1}], 24),
    "no_rank_key": ([{"host": "h0"}, {"host": "h1"}], 64),
}


def _gather_rank(rank, world, cases):
    from shifu_tpu_torch.obs import aggregate
    return {name: aggregate.gather_host_summaries(summaries[rank],
                                                  max_bytes=cap)
            for name, (summaries, cap) in cases.items()}


@pytest.fixture(scope="module")
def port_rows(tmp_path_factory):
    return helpers.run_ranks(_gather_rank, 2,
                             tmp_path_factory.mktemp("gather"), CASES)


def jax_rows(monkeypatch, summaries, cap):
    """JAX's gather over `summaries`, one per process."""
    import jax
    from jax.experimental import multihost_utils

    from shifu_tpu.obs import aggregate as jax_aggregate
    monkeypatch.setattr(jax, "process_count", lambda: len(summaries))
    packed = []
    monkeypatch.setattr(multihost_utils, "process_allgather",
                        lambda buf: packed.append(buf.copy())
                        or np.stack([buf] * len(summaries)))
    for s in summaries:
        jax_aggregate.gather_host_summaries(s, max_bytes=cap)
    monkeypatch.setattr(multihost_utils, "process_allgather",
                        lambda buf: np.stack(packed))
    return jax_aggregate.gather_host_summaries(summaries[0], max_bytes=cap)


@pytest.mark.parametrize("case", sorted(CASES))
def test_every_rank_gathers_jax_s_rows(port_rows, monkeypatch, case):
    summaries, cap = CASES[case]
    want = jax_rows(monkeypatch, summaries, cap)
    for rank, got in enumerate(port_rows):
        assert json.dumps(got[case], sort_keys=True) == json.dumps(
            want, sort_keys=True), f"rank {rank}"
    rows = port_rows[0][case]
    assert [r["rank"] for r in rows] == [0, 1]
    if case == "oversized":
        assert rows[1] == {"host": "h1", "rank": 1, "_truncated": True}
        assert rows[0] == summaries[0]
    if case == "undecodable":
        assert rows[0] == {"rank": 0, "_undecodable": True}
        assert rows[1] == {"rank": 1}


def test_alone_returns_the_summary_without_a_collective():
    from shifu_tpu.obs import aggregate as jax_aggregate
    from shifu_tpu_torch.obs import aggregate
    summary = {"host": "h", "rank": 0, "blob": BIG}
    assert "torch.distributed" not in sys.modules or not __import__(
        "torch").distributed.is_initialized()
    got = aggregate.gather_host_summaries(summary, max_bytes=16)
    assert got == jax_aggregate.gather_host_summaries(summary,
                                                      max_bytes=16)
    assert got == [summary] and got[0] is not summary
    assert aggregate.DEFAULT_MAX_BYTES == jax_aggregate.DEFAULT_MAX_BYTES
