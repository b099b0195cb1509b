"""The port's native C++ parser (shifu_tpu_torch/data/native_parser.py over
its own copy of shifu_parser.cc, built by g++) against the JAX package's
native parser and against the port's numpy tier: bitwise, NaN for NaN."""

import gzip
import shutil

import numpy as np
import pytest

from shifu_tpu.data import native_parser as jax_native
from shifu_tpu_torch.data import native_parser, reader

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="g++ is absent: no native parser")


def _bits_equal(a: np.ndarray, b: np.ndarray) -> bool:
    return (a.shape == b.shape and a.dtype == b.dtype
            and np.array_equal(a.view(np.uint32), b.view(np.uint32)))


def _rows(seed: int, n: int = 300, c: int = 7) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, c)) * 10.0 ** rng.integers(
        -3, 4, size=(n, c))).astype(np.float32)


def _text(arr: np.ndarray, delim: str = "|", eol: str = "\n") -> bytes:
    return (eol.join(delim.join(repr(float(v)) for v in row) for row in arr)
            + eol).encode()


CASES = {
    "plain": _text(_rows(1)),
    "crlf": _text(_rows(2), eol="\r\n"),
    "ragged": b"1|2|3\n4|5\n6|7|8|9\n\n  \n10|11|12\n",
    "bad_cells": b"1|x|3\n|5|nan\n7|8|-inf\n1e39|1e-50|+4\n",
    "blank_lines": b"\n\n1|2\n\n3|4\n\n",
    "one_column": b"1\n2\n3\n",
    "empty": b"",
}


@pytest.fixture(autouse=True)
def _fresh_library(monkeypatch):
    monkeypatch.delenv("SHIFU_TPU_NO_NATIVE_PARSER", raising=False)
    native_parser.reset_for_tests()
    yield
    native_parser.reset_for_tests()


def test_the_library_builds():
    assert native_parser.available(), native_parser.unavailable_reason()
    assert native_parser.unavailable_reason() is None


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("compress", [False, True], ids=["text", "gzip"])
def test_parse_file_matches_jax_and_the_numpy_tier(tmp_path, name, compress):
    raw = CASES[name]
    path = tmp_path / ("d.gz" if compress else "d.txt")
    path.write_bytes(gzip.compress(raw) if compress else raw)
    got = native_parser.parse_file(str(path))
    want = jax_native.parse_file(str(path))
    assert _bits_equal(got, want)
    if raw.strip():
        assert _bits_equal(got, reader.parse_rows(raw))
    else:
        assert got.shape[0] == 0
    assert native_parser.count_rows(str(path)) == got.shape[0] \
        == jax_native.count_rows(str(path)) == reader.count_rows([str(path)])


@pytest.mark.parametrize("name", sorted(CASES))
def test_parse_buffer_matches_jax(name):
    raw = CASES[name]
    assert _bits_equal(native_parser.parse_buffer(raw),
                       jax_native.parse_buffer(raw))
    if raw.strip():
        assert _bits_equal(reader._parse_bytes(raw, "|"),
                           reader.parse_rows(raw))


@pytest.mark.parametrize("threads", [1, 2, 3, 8])
def test_threads_give_the_same_bits(tmp_path, threads):
    raw = _text(_rows(3, n=5000, c=11))
    path = tmp_path / "big.gz"
    path.write_bytes(gzip.compress(raw))
    one = native_parser.parse_file(str(path), threads=1)
    got = native_parser.parse_file(str(path), threads=threads)
    assert _bits_equal(got, one)
    assert _bits_equal(got, jax_native.parse_file(str(path),
                                                  threads=threads))
    assert _bits_equal(got, reader.parse_rows(raw))


def test_multimember_gzip_and_a_comma_delimiter(tmp_path):
    a, b = _text(_rows(4, n=50), ","), _text(_rows(5, n=60), ",")
    path = tmp_path / "cat.gz"
    path.write_bytes(gzip.compress(a) + gzip.compress(b))
    got = native_parser.parse_file(str(path), ",")
    assert got.shape == (110, 7)
    assert _bits_equal(got, jax_native.parse_file(str(path), ","))
    assert _bits_equal(got, reader.parse_rows(a + b, ","))


def test_errors_match_jax(tmp_path):
    missing = str(tmp_path / "nope.gz")
    for mod in (native_parser, jax_native):
        with pytest.raises(FileNotFoundError):
            mod.parse_file(missing)
        with pytest.raises(FileNotFoundError):
            mod.count_rows(missing)
        with pytest.raises(ValueError, match="single-byte"):
            mod.parse_buffer(b"1||2\n", "||")
    bad = tmp_path / "trunc.gz"
    bad.write_bytes(gzip.compress(CASES["plain"])[:-20])
    for mod in (native_parser, jax_native):
        with pytest.raises(OSError, match="corrupt or truncated"):
            mod.parse_file(str(bad))


def test_read_file_records_its_tier(tmp_path, monkeypatch):
    path = tmp_path / "d.gz"
    path.write_bytes(gzip.compress(CASES["plain"]))
    native = reader.read_file(str(path))
    assert reader.last_io_stats()["tier"] == "native"
    assert reader.last_io_stats()["source_bytes"] == path.stat().st_size
    monkeypatch.setenv("SHIFU_TPU_NO_NATIVE_PARSER", "1")
    native_parser.reset_for_tests()
    assert not native_parser.available()
    assert "SHIFU_TPU_NO_NATIVE_PARSER" in native_parser.unavailable_reason()
    numpy_tier = reader.read_file(str(path))
    assert reader.last_io_stats()["tier"] == "numpy"
    assert _bits_equal(native, numpy_tier)


@pytest.mark.parametrize("width", [1, 2, 3, 64])
def test_pool_parser_threads_matches_jax(width, monkeypatch):
    assert native_parser.pool_parser_threads(width) \
        == jax_native.pool_parser_threads(width)
    monkeypatch.setenv("SHIFU_TPU_PARSER_THREADS", "3")
    assert native_parser.pool_parser_threads(width) == 3 \
        == jax_native.pool_parser_threads(width)


def test_parquet_reads_as_the_jax_reader_does(tmp_path):
    pa = pytest.importorskip("pyarrow")
    pq = pytest.importorskip("pyarrow.parquet")
    from shifu_tpu.data import reader as jax_reader
    arr = _rows(6, n=40, c=4)
    table = pa.table({f"c{i}": arr[:, i] for i in range(4)})
    path = str(tmp_path / "d.parquet")
    pq.write_table(table, path)
    got = reader.read_file(path)
    assert reader.last_io_stats()["tier"] == "parquet"
    assert _bits_equal(got, jax_reader.read_file(path))
    assert reader.count_rows([path]) == jax_reader.count_rows([path]) == 40
