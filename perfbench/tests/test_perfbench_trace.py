"""The reduction of a profiler trace: busy and idle time, per-kernel sums,
idle gaps put down to the host's work, and the readers that use them."""

import pytest

from perfbench.core import trace
from perfbench.core.manifest import metric_reader


def _x(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def _events():
    return [
        _x(trace.WINDOW, "user_annotation", 1000.0, 100.0),
        _x("train_step", "user_annotation", 1000.0, 60.0),
        _x("aten::mm", "cpu_op", 1005.0, 10.0),
        _x("cudaStreamSynchronize", "cuda_runtime", 1070.0, 25.0),
        # two streams overlapping: 1010-1040 and 1030-1050 -> 1010-1050
        _x("void ft_block_kernel<8, 16, 2>(float const*)", "kernel",
           1010.0, 30.0),
        _x("gemm", "kernel", 1030.0, 20.0),
        _x("Memcpy HtoD", "gpu_memcpy", 1060.0, 5.0),
        # clipped by the window's end at 1100
        _x("gemm", "kernel", 1095.0, 10.0),
        # outside the window: left out
        _x("gemm", "kernel", 900.0, 10.0),
        _x("train_step", "gpu_user_annotation", 1000.0, 60.0),
    ]


def test_busy_window_and_kernels():
    r = trace.reduce_events(_events())
    assert r["window_s"] == pytest.approx(100e-6)
    # union: 1010-1050, 1060-1065, 1095-1100
    assert r["busy_s"] == pytest.approx(50e-6)
    assert r["kernels"]["gemm"] == (2, pytest.approx(30e-6))
    assert r["kernels"]["Memcpy HtoD"][0] == 1
    assert "train_step" not in r["kernels"]


def test_idle_gaps_by_host_work():
    r = trace.reduce_events(_events())
    gaps = dict(r["breakdown"]["idle_gaps"])
    # 1000-1010 (mid 1005: inside aten::mm), 1050-1060 (mid 1055: only
    # train_step open), 1065-1095 (mid 1080: the sync)
    assert gaps["aten::mm"] == pytest.approx(10e-6)
    assert gaps["train_step"] == pytest.approx(10e-6)
    assert gaps["cudaStreamSynchronize"] == pytest.approx(30e-6)
    ops = r["breakdown"]["device_ops"]
    assert ops[0][0] == "ft_block_kernel<8, 16, 2>"
    assert len(ops) <= trace.TOP


def test_a_trace_without_its_window_is_refused():
    with pytest.raises(ValueError):
        trace.reduce_events([_x("gemm", "kernel", 0.0, 1.0)])


def test_readers_of_the_trace():
    r = trace.reduce_events(_events())
    cfg = {"n_num_features": 28, "token_dim": 128, "num_attention_heads": 8,
           "mlp_ratio": 2}
    run = {"trace": r, "config": cfg, "traffic": {"batch_rows": 8192}}
    idle = metric_reader("device_idle_pct.train").read(run)
    assert idle == pytest.approx(50.0)
    roof = metric_reader("ft_block_roofline.train").read(run)
    from perfbench.core import flops
    want = 100 * flops.ft_block_bound_s(8192, 29, 128, 8, 2) / 30e-6
    assert roof == pytest.approx(want)


def test_readers_find_nothing_without_device_work():
    empty = trace.reduce_events([_x(trace.WINDOW, "user_annotation",
                                    0.0, 10.0)])
    run = {"trace": empty, "config": {}, "traffic": {}}
    for name in ("device_idle_pct.train", "device_idle_pct.score",
                 "ft_block_roofline.train"):
        assert metric_reader(name).read(run) is None
        assert metric_reader(name).read({"trace": None}) is None
