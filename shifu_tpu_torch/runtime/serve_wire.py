"""Serving wire format and TCP front end for the scoring daemon (port of
shifu_tpu/runtime/serve_wire.py: the same frames, byte for byte).

The request payload rides the int8 wire encoding of the data plane
(data/pipeline.wire_quantize on the static grid, `q = round((x - offset)
/ scale)` saturated to [-127, 127]): one encoder for training ingest and
serving ingest, and a quarter of the bytes of float32 on the socket.
Decoding views the payload with `np.frombuffer` and expands it through
`wire_dequantize` in one vectorized pass.  Clients that want exact
float32 semantics send DTYPE_F32 frames.

Frame layout (little-endian), one request -> one response per frame;
frames pipeline freely on a persistent connection:

  request : magic u32 | version u16 | opcode u8 | dtype u8
            | n_rows u32 | n_cols u32 | scale f32 | offset f32
            | payload_len u32 | [20-byte trace context, version 2]
            | payload bytes
  response: magic u32 | version u16 | status u8 (0 ok) | pad u8
            | n_rows u32 | n_cols u32 | payload_len u32 | payload bytes

opcodes: SCORE (payload = rows; response payload = f32 scores (N, H)),
SWAP (payload = JSON {"export_dir", "engine"?}; response = JSON result),
STATS (response = JSON daemon stats), PING (empty echo), FEEDBACK
(payload = JSON {"scores", "labels", "weights"?, "model"?}; response =
JSON {"ok", "rows"}: the drift engine's live-AUC feed).  An error response
carries status=1 and a UTF-8 message; status=2 is admission-limit
backpressure (ServeOverload), distinct so clients can retry or shed
without parsing messages.
"""

from __future__ import annotations

import json
import socket
import struct
import threading
import time
from typing import Optional

import numpy as np

MAGIC = 0x57565253  # b"SRVW" little-endian
VERSION = 1
# version 2 = a version-1 frame plus a 20-byte trace-context extension
# (obs/tracing.WIRE_EXT: trace_id + attempt + sampled) between the fixed
# header and the payload.  `plen` still counts the payload only; servers
# accept both versions and clients emit v2 only when a trace rides along.
VERSION_TRACED = 2

OP_SCORE = 1
OP_SWAP = 2
OP_STATS = 3
OP_PING = 4
# labelled feedback for the drift engine (obs/drift.py): payload =
# JSON {"scores": [...], "labels": [...], "weights"?: [...],
# "model"?: str}; response = JSON {"ok": true, "rows": N}.  Feeds the
# trailing-window live-AUC accumulator behind `auc_decay`; rejected
# with STATUS_ERROR when shifu.drift.feedback is off.
OP_FEEDBACK = 5

DTYPE_F32 = 0
DTYPE_INT8 = 1

_REQ = struct.Struct("<IHBBIIffI")
_RSP = struct.Struct("<IHBBIII")

# the static int8 grid (data/pipeline.wire_params): scale = clip / 127,
# offset = 0, the training data plane's default clip, so a cache entry's
# byte is a valid request payload byte
DEFAULT_INT8_CLIP = 8.0


STATUS_OK = 0
STATUS_ERROR = 1
STATUS_OVERLOAD = 2  # admission-limit backpressure: retry/shed, distinct
#                      from a scoring error so clients need no string match


class WireError(RuntimeError):
    """Malformed frame or transport failure."""


class WireOverload(WireError):
    """The daemon rejected the request at its admission limit
    (STATUS_OVERLOAD) — backpressure, not a scoring failure."""


def encode_rows(rows: np.ndarray, dtype: int = DTYPE_INT8,
                clip: float = DEFAULT_INT8_CLIP) -> tuple[bytes, float,
                                                          float]:
    """Rows -> (payload, scale, offset) in the chosen wire dtype.  int8
    quantizes on the static grid through the data plane's encoder."""
    x = np.asarray(rows, np.float32)
    if x.ndim == 1:
        x = x[None, :]
    if dtype == DTYPE_F32:
        return np.ascontiguousarray(x).tobytes(), 1.0, 0.0
    if dtype != DTYPE_INT8:
        raise WireError(f"unknown wire dtype {dtype}")
    from ..data.pipeline import wire_quantize
    scale = np.float32(clip / 127.0)
    offset = np.float32(0.0)
    q = wire_quantize(x, scale, offset)
    return np.ascontiguousarray(q).tobytes(), float(scale), float(offset)


def decode_rows(payload: bytes, dtype: int, n_rows: int, n_cols: int,
                scale: float, offset: float) -> np.ndarray:
    """Payload bytes -> (N, F) float32 rows.  `np.frombuffer` views the
    buffer without copying; int8 expands through wire_dequantize."""
    want = n_rows * n_cols * (1 if dtype == DTYPE_INT8 else 4)
    if len(payload) != want:
        raise WireError(f"payload is {len(payload)} bytes, frame header "
                        f"says {want}")
    if dtype == DTYPE_F32:
        return np.frombuffer(payload, np.float32).reshape(n_rows, n_cols)
    if dtype == DTYPE_INT8:
        from ..data.pipeline import wire_dequantize
        q = np.frombuffer(payload, np.int8).reshape(n_rows, n_cols)
        return wire_dequantize(q, scale, offset)
    raise WireError(f"unknown wire dtype {dtype}")


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        k = sock.recv_into(view[got:], n - got)
        if k == 0:
            raise ConnectionError("peer closed mid-frame" if got
                                  else "peer closed")
        got += k
    return bytes(buf)


# payload ceilings before allocation: an untrusted header must not pin a
# giant buffer per connection.  SCORE must also match its own row
# geometry exactly.
MAX_SCORE_PAYLOAD = 64 << 20   # 64 MiB ≈ 16k rows x 1k f32 features
MAX_CONTROL_PAYLOAD = 1 << 20  # SWAP/STATS/PING bodies are tiny JSON


def read_request(sock: socket.socket, with_trace: bool = False):
    """One request frame -> (opcode, dtype, n_rows, n_cols, scale,
    offset, payload); raises ConnectionError on clean close.  With
    `with_trace=True` an 8th element is appended: the frame's
    TraceContext (version-2 frames) or None (version 1)."""
    hdr = _recv_exact(sock, _REQ.size)
    magic, ver, op, dtype, n_rows, n_cols, scale, offset, plen = \
        _REQ.unpack(hdr)
    if magic != MAGIC or ver not in (VERSION, VERSION_TRACED):
        raise WireError(f"bad frame magic/version {magic:#x}/{ver}")
    trace = None
    if ver == VERSION_TRACED:
        from ..obs import tracing
        trace = tracing.unpack(_recv_exact(sock, tracing.WIRE_EXT_BYTES))
    if op == OP_SCORE:
        itemsize = 1 if dtype == DTYPE_INT8 else 4
        want = n_rows * n_cols * itemsize
        if plen != want or plen > MAX_SCORE_PAYLOAD:
            raise WireError(
                f"score payload {plen} bytes vs {n_rows}x{n_cols} "
                f"{'int8' if itemsize == 1 else 'f32'} rows "
                f"(max {MAX_SCORE_PAYLOAD})")
    elif plen > MAX_CONTROL_PAYLOAD:
        raise WireError(f"oversized control payload {plen}")
    payload = _recv_exact(sock, plen) if plen else b""
    if with_trace:
        return op, dtype, n_rows, n_cols, scale, offset, payload, trace
    return op, dtype, n_rows, n_cols, scale, offset, payload


def write_response(sock: socket.socket, status: int, payload: bytes = b"",
                   n_rows: int = 0, n_cols: int = 0) -> None:
    sock.sendall(_RSP.pack(MAGIC, VERSION, status, 0, n_rows, n_cols,
                           len(payload)) + payload)


class ServeServer:
    """Threaded TCP front-end over a ScoringDaemon: one thread per
    connection, frames handled sequentially per connection (clients open
    more connections for parallelism), single-row SCORE frames ride the
    micro-batcher, multi-row frames take the direct batched path."""

    def __init__(self, daemon, host: str = "127.0.0.1", port: int = 0,
                 request_timeout: float = 30.0,
                 allow_swap: Optional[bool] = None):
        self.daemon = daemon
        self._timeout = request_timeout
        # trust model: SWAP hot-loads a filesystem path as the serving
        # model, so it defaults to loopback binds only; a non-loopback
        # server refuses wire swaps unless the caller opts in
        if allow_swap is None:
            allow_swap = host in ("127.0.0.1", "localhost", "::1", "")
        self.allow_swap = allow_swap
        self._listener = socket.create_server((host, port), backlog=128)
        self.host, self.port = self._listener.getsockname()[:2]
        self._accept_thread: Optional[threading.Thread] = None
        self._closing = False

    def start(self) -> "ServeServer":
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True, name="serve-accept")
        self._accept_thread.start()
        return self

    def close(self) -> None:
        self._closing = True
        try:
            # shutdown before close: closing the fd alone does not wake a
            # thread blocked in accept() on Linux
            self._listener.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._listener.close()
        except OSError:
            pass
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=5)

    # idle connections are reaped after this long without a frame
    IDLE_TIMEOUT_S = 300.0

    def _accept_loop(self) -> None:
        while not self._closing:
            try:
                conn, _addr = self._listener.accept()
            except OSError:
                if self._closing:
                    return  # listener closed
                time.sleep(0.05)  # transient (e.g. EMFILE burst): the
                continue          # server must not die silently
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            conn.settimeout(self.IDLE_TIMEOUT_S)
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True, name="serve-conn").start()

    def _serve_conn(self, conn: socket.socket) -> None:
        with conn:
            while True:
                try:
                    frame = read_request(conn, with_trace=True)
                except (ConnectionError, OSError):
                    return
                except WireError as e:
                    try:
                        write_response(conn, 1, str(e).encode())
                    except OSError:
                        pass
                    return  # framing lost: drop the connection
                # arrival stamps at frame receipt: decode and admission
                # ride the request's `admission` stage (obs/slo.py)
                t_arrival = time.perf_counter()
                try:
                    self._handle(conn, t_arrival, *frame)
                except (ConnectionError, OSError):
                    return

    def _handle(self, conn, t_arrival, op, dtype, n_rows, n_cols, scale,
                offset, payload, trace=None) -> None:
        daemon = self.daemon
        if op == OP_PING:
            write_response(conn, 0)
            return
        if op == OP_STATS:
            write_response(conn, 0, json.dumps(daemon.stats()).encode())
            return
        if op == OP_SWAP:
            if not self.allow_swap:
                write_response(conn, STATUS_ERROR,
                               b"wire swap disabled on this bind "
                               b"(non-loopback; restart with "
                               b"--allow-swap to permit)")
                return
            try:
                req = json.loads(payload.decode() or "{}")
                result = daemon.swap(req["export_dir"],
                                     engine=req.get("engine"))
            except Exception as e:  # noqa: BLE001 — report, keep serving
                result = {"ok": False,
                          "error": f"{type(e).__name__}: {e}"[:300]}
            write_response(conn, 0, json.dumps(result).encode())
            return
        if op == OP_FEEDBACK:
            try:
                req = json.loads(payload.decode() or "{}")
                rows = daemon.feedback(
                    req["scores"], req["labels"],
                    weights=req.get("weights"),
                    model_id=req.get("model", "default"))
                result = {"ok": True, "rows": int(rows)}
            except Exception as e:  # noqa: BLE001 — report, keep serving
                write_response(conn, STATUS_ERROR,
                               f"{type(e).__name__}: {e}"[:500].encode())
                return
            write_response(conn, 0, json.dumps(result).encode())
            return
        if op != OP_SCORE:
            write_response(conn, 1, f"unknown opcode {op}".encode())
            return
        try:
            rows = decode_rows(payload, dtype, n_rows, n_cols, scale,
                               offset)
            if n_rows == 1:
                scores = daemon.score(rows[0], timeout=self._timeout,
                                      t_arrival=t_arrival, trace=trace)
                scores = np.asarray(scores)[None, :]
            else:
                scores = daemon.score_batch(rows)
        except Exception as e:  # noqa: BLE001 — per-request error frame
            from .serve import ServeOverload
            status = (STATUS_OVERLOAD if isinstance(e, ServeOverload)
                      else STATUS_ERROR)
            write_response(conn, status,
                           f"{type(e).__name__}: {e}"[:500].encode())
            return
        out = np.ascontiguousarray(scores, np.float32)
        write_response(conn, 0, out.tobytes(),
                       n_rows=out.shape[0], n_cols=out.shape[1])


class ServeClient:
    """Blocking client for the wire protocol (runtime/loadtest.py's
    socket mode, tests, and a reference for other bindings)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 8571,
                 timeout: float = 30.0):
        self._sock = socket.create_connection((host, port),
                                              timeout=timeout)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._lock = threading.Lock()

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass

    def __enter__(self) -> "ServeClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _roundtrip(self, op: int, dtype: int = DTYPE_F32,
                   n_rows: int = 0, n_cols: int = 0, scale: float = 1.0,
                   offset: float = 0.0, payload: bytes = b"",
                   trace=None):
        # a traceless request is a version-1 frame: tracing off costs the
        # wire nothing
        ver = VERSION if trace is None else VERSION_TRACED
        ext = b"" if trace is None else trace.pack()
        with self._lock:
            self._sock.sendall(_REQ.pack(MAGIC, ver, op, dtype,
                                         n_rows, n_cols, scale, offset,
                                         len(payload)) + ext + payload)
            hdr = _recv_exact(self._sock, _RSP.size)
            magic, ver, status, _pad, rn, rc, plen = _RSP.unpack(hdr)
            if magic != MAGIC or ver != VERSION:
                raise WireError(f"bad response magic/version "
                                f"{magic:#x}/{ver}")
            body = _recv_exact(self._sock, plen) if plen else b""
        if status == STATUS_OVERLOAD:
            raise WireOverload(body.decode(errors="replace")
                               or "server overloaded")
        if status != STATUS_OK:
            raise WireError(body.decode(errors="replace")
                            or f"server error status {status}")
        return body, rn, rc

    def ping(self) -> bool:
        self._roundtrip(OP_PING)
        return True

    def score_rows(self, rows: np.ndarray, dtype: int = DTYPE_INT8,
                   clip: float = DEFAULT_INT8_CLIP,
                   trace=None) -> np.ndarray:
        x = np.asarray(rows, np.float32)
        if x.ndim == 1:
            x = x[None, :]
        payload, scale, offset = encode_rows(x, dtype=dtype, clip=clip)
        body, rn, rc = self._roundtrip(
            OP_SCORE, dtype=dtype, n_rows=x.shape[0], n_cols=x.shape[1],
            scale=scale, offset=offset, payload=payload, trace=trace)
        return np.frombuffer(body, np.float32).reshape(rn, rc)

    def swap(self, export_dir: str, engine: Optional[str] = None) -> dict:
        req = {"export_dir": export_dir}
        if engine:
            req["engine"] = engine
        body, _rn, _rc = self._roundtrip(OP_SWAP,
                                         payload=json.dumps(req).encode())
        return json.loads(body.decode())

    def feedback(self, scores, labels, weights=None,
                 model_id: str = "default") -> dict:
        """Ship labelled outcomes for rows this model scored (the drift
        engine's live-AUC feed).  Returns {"ok": True, "rows": N};
        raises WireError when the daemon's feedback path is disabled."""
        req = {"scores": np.asarray(scores, np.float64).ravel().tolist(),
               "labels": np.asarray(labels, np.float64).ravel().tolist()}
        if weights is not None:
            req["weights"] = np.asarray(
                weights, np.float64).ravel().tolist()
        if model_id != "default":
            req["model"] = model_id
        body, _rn, _rc = self._roundtrip(
            OP_FEEDBACK, payload=json.dumps(req).encode())
        return json.loads(body.decode())

    def stats(self) -> dict:
        body, _rn, _rc = self._roundtrip(OP_STATS)
        return json.loads(body.decode())
