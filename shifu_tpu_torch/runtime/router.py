"""The fleet's routing front end (port of shifu_tpu/runtime/router.py):
a consistent ring, one hedged retry, overload shedding and reconnect
backoff, speaking the serve_wire protocol on both faces.

A client points its ServeClient at the router as it would at one daemon.
The router picks a member (a per-model consistent ring, so a model's
requests keep landing on the same member's warm engine), applies a
per-request timeout, and on transport death hedges ONE retry to the next
healthy candidate while the dead member sits out a decorrelated-jitter
backoff (full jitter around the last sleep, so a herd of reconnects
spreads itself out).  Overload (`STATUS_OVERLOAD`, or a member's
`slo_burn_rate` at or above `shed_burn`) sheds the request to the
least-burned member instead of failing it.

The swap barrier (runtime/fleet.py `swap_fleet`) plugs in here: members
whose artifact generation predates `set_barrier(gen)` leave candidate
selection, so no request is served by a stale version once a fleet swap
has landed.

The chaos probe `fleet.route` fires once per routed request.

One difference from the JAX router: `RouterServer` forwards a SCORE
frame to the member in the wire dtype it arrived in (JAX re-encodes every
frame as int8), so a float32 client gets float32 semantics through the
fleet as it does from one daemon.
"""

from __future__ import annotations

import hashlib
import random
import socket
import threading
import time
from typing import Optional

from ..config.schema import FleetConfig

# fires once per routed score/swap/stats decision: a chaos plan here
# models front-end faults (lost routes, slow paths) apart from member
# health
ROUTE_SITE = "fleet.route"


class NoHealthyMember(ConnectionError):
    """Every candidate is down, backing off, or behind the swap barrier."""


class _Backoff:
    """Decorrelated-jitter reconnect backoff for one member: each failure
    sleeps `uniform(base, last*3)` capped — state is (until, last_sleep).
    """

    def __init__(self, base_s: float, cap_s: float):
        self._base = base_s
        self._cap = cap_s
        self._sleep = 0.0
        self._until = 0.0

    def fail(self, now: Optional[float] = None) -> float:
        now = time.monotonic() if now is None else now
        self._sleep = min(self._cap,
                          random.uniform(self._base,
                                         max(self._base,
                                             self._sleep * 3)))
        self._until = now + self._sleep
        return self._sleep

    def ok(self) -> None:
        self._sleep = 0.0
        self._until = 0.0

    def blocked(self, now: Optional[float] = None) -> bool:
        return (time.monotonic() if now is None else now) < self._until


class _Member:
    """Router-side view of one fleet member: endpoint, connection pool,
    backoff state, last pushed burn, artifact generation."""

    def __init__(self, member_id: str, host: str, port: int,
                 generation: int, cfg: FleetConfig,
                 host_id: str = ""):
        self.member_id = member_id
        self.host = host
        self.port = port
        self.host_id = host_id   # fleet placement id for hop attribution
        self.generation = generation
        self.burn = 0.0
        self.backoff = _Backoff(cfg.backoff_base_ms / 1e3,
                                cfg.backoff_cap_ms / 1e3)
        self._pool: list = []
        self._pool_lock = threading.Lock()
        self._timeout_s = cfg.route_timeout_ms / 1e3
        self._connect_s = cfg.connect_timeout_ms / 1e3

    def checkout(self):
        from . import serve_wire
        with self._pool_lock:
            if self._pool:
                return self._pool.pop()
        # connect under the (short) connect timeout, then widen to the
        # per-request route timeout for the round-trips
        client = serve_wire.ServeClient(self.host, self.port,
                                        timeout=self._connect_s)
        client._sock.settimeout(self._timeout_s)
        return client

    def checkin(self, client) -> None:
        with self._pool_lock:
            if len(self._pool) < 8:
                self._pool.append(client)
                return
        client.close()

    def invalidate(self, client) -> None:
        try:
            client.close()
        except Exception:
            pass

    def drain_pool(self) -> None:
        with self._pool_lock:
            pool, self._pool = self._pool, []
        for c in pool:
            try:
                c.close()
            except Exception:
                pass


class FleetRouter:
    """Membership table + routing policy.  The FleetManager owns the
    table (add/remove/set_generation/set_barrier/set_burn); request
    threads call `score_rows` / `stats` / `ping` concurrently."""

    def __init__(self, cfg: Optional[FleetConfig] = None):
        self.cfg = cfg or FleetConfig()
        self._lock = threading.RLock()
        self._members: dict[str, _Member] = {}
        self._ring: list = []       # sorted [(hash, member_id)] vnodes
        self._barrier = 0           # min admissible artifact generation
        self._routed = 0
        self._hedges = 0
        self._sheds = 0
        self._errors = 0
        # distributed-tracing ingress sampling: 1-in-N requests mint a
        # TraceContext here (obs/tracing.py) unless the wire frame
        # already carried one.  0 = off — no minting, no journaling, no
        # clock reads on the untraced path.  The FleetManager wires this
        # from ServingConfig.trace_sample.
        self.trace_sample = 0
        self._ingress = 0

    # -- membership (manager-facing) -----------------------------------

    def add(self, member_id: str, host: str, port: int, *,
            generation: int = 0, host_id: str = "") -> None:
        with self._lock:
            self._members[member_id] = _Member(
                member_id, host, port, generation, self.cfg,
                host_id=host_id)
            self._rebuild_ring()

    def remove(self, member_id: str) -> None:
        with self._lock:
            m = self._members.pop(member_id, None)
            self._rebuild_ring()
        if m is not None:
            m.drain_pool()

    def set_generation(self, member_id: str, generation: int) -> None:
        with self._lock:
            m = self._members.get(member_id)
            if m is not None:
                m.generation = generation

    def set_barrier(self, generation: int) -> None:
        """Swap barrier: members with generation < this are refused out
        of rotation until the fleet monitor catches them up."""
        with self._lock:
            self._barrier = generation

    def set_burn(self, member_id: str, burn: float) -> None:
        with self._lock:
            m = self._members.get(member_id)
            if m is not None:
                m.burn = float(burn)

    def member_ids(self) -> list:
        with self._lock:
            return sorted(self._members)

    def _rebuild_ring(self) -> None:
        # caller holds _lock
        ring = []
        for mid in self._members:
            for v in range(self.cfg.vnodes):
                h = hashlib.md5(
                    f"{mid}#{v}".encode()).digest()
                ring.append((int.from_bytes(h[:8], "big"), mid))
        ring.sort()
        self._ring = ring

    # -- candidate selection -------------------------------------------

    def _eligible(self, m: _Member, now: float) -> bool:
        return m.generation >= self._barrier and not m.backoff.blocked(now)

    def candidates(self, key: str) -> list:
        """Members in ring order from the key's position — [primary,
        hedge, ...], excluding backed-off / barrier-refused members.
        If the primary's burn crosses `shed_burn`, the least-burned
        eligible member is shed to first instead."""
        now = time.monotonic()
        with self._lock:
            if not self._ring:
                return []
            h = int.from_bytes(
                hashlib.md5(key.encode()).digest()[:8], "big")
            # first vnode clockwise of the key's hash
            lo, hi = 0, len(self._ring)
            while lo < hi:
                mid_i = (lo + hi) // 2
                if self._ring[mid_i][0] < h:
                    lo = mid_i + 1
                else:
                    hi = mid_i
            order, seen = [], set()
            n = len(self._ring)
            for i in range(n):
                mid = self._ring[(lo + i) % n][1]
                if mid in seen:
                    continue
                seen.add(mid)
                m = self._members[mid]
                if self._eligible(m, now):
                    order.append(m)
            if (len(order) > 1
                    and order[0].burn >= self.cfg.shed_burn):
                coolest = min(order, key=lambda m: m.burn)
                if coolest is not order[0]:
                    order.remove(coolest)
                    order.insert(0, coolest)
                    self._sheds += 1
            return order

    # -- request paths --------------------------------------------------

    @staticmethod
    def _hop(hops, attempt: int, m: _Member, outcome: str,
             t_hop: float) -> None:
        """Record one attempt's span — only when the request is sampled
        (`hops` is None otherwise: no clock math on the untraced path)."""
        if hops is None:
            return
        hops.append({"attempt": attempt, "member": m.member_id,
                     "host": m.host_id or m.host, "outcome": outcome,
                     "ms": round((time.perf_counter() - t_hop) * 1e3, 4)})

    def _journal_route(self, trace, hops, t0: float, outcome: str,
                       rows: int = 0) -> None:
        """The router's terminal `route_trace` event: every hop span of
        this trace plus the router-side residual (`queue_ms` = e2e minus
        the hops — candidate selection, backoff waits, hedge gaps), so
        ``sum(hop.ms) + queue_ms == e2e_ms`` by construction — the
        client-observed latency decomposes exactly."""
        if trace is None or not trace.sampled or hops is None:
            return
        from .. import obs
        e2e_ms = (time.perf_counter() - t0) * 1e3
        hop_ms = sum(h["ms"] for h in hops)
        obs.event("route_trace", trace_id=trace.trace_id, hops=hops,
                  hedged=len(hops) > 1,
                  queue_ms=round(max(e2e_ms - hop_ms, 0.0), 4),
                  e2e_ms=round(e2e_ms, 4), outcome=outcome,
                  rows=int(rows))

    def _roundtrip(self, attempt_fn, key: str, trace=None,
                   t_ingress: Optional[float] = None, n_rows: int = 0):
        """Route with per-request timeout + one hedged retry: try the
        primary; on transport death / timeout put it in backoff and hedge
        to the next candidate.  Overload from the primary sheds once to
        the least-burned alternative before surfacing.

        `attempt_fn(client, trace)` receives the per-attempt trace
        context (attempt index stamped in) so each hop's wire frame
        carries its own ordinal; a sampled trace journals a terminal
        `route_trace` with one span per attempt."""
        from .. import chaos
        from . import serve_wire

        chaos.maybe_fail(ROUTE_SITE, key=key)
        t0 = time.perf_counter() if t_ingress is None else t_ingress
        hops = [] if (trace is not None and trace.sampled) else None
        cands = self.candidates(key)
        if not cands:
            self._journal_route(trace, hops, t0, "no_member", n_rows)
            raise NoHealthyMember("no healthy fleet member in rotation")
        last_err: Optional[BaseException] = None
        hedged = False
        for i, m in enumerate(cands[:2]):   # primary + ONE hedge
            hop_trace = trace.with_attempt(i) if trace is not None \
                else None
            t_hop = time.perf_counter()
            # connect (checkout) and the request proper are SEPARATE
            # failure domains: the accepts-then-dies zombie (a kill()'d
            # member whose listener lingers) connects fine and dies on
            # every request — if connecting reset the ladder, that shape
            # would flap at full tightness forever
            try:
                client = m.checkout()
            except (ConnectionError, socket.timeout, OSError) as e:
                m.backoff.fail()
                m.drain_pool()
                last_err = e
                hedged = True
                self._hop(hops, i, m, "connect_error", t_hop)
                continue
            try:
                out = attempt_fn(client, hop_trace)
            except serve_wire.WireOverload as e:
                # member alive but shedding: it is NOT a transport
                # failure — no backoff, but try the other candidate once
                m.checkin(client)
                last_err = e
                with self._lock:
                    self._sheds += 1
                self._hop(hops, i, m, "overload", t_hop)
                continue
            except serve_wire.WireError as e:
                # application-level error from a healthy member: the
                # request itself is bad — hedging elsewhere won't help
                m.checkin(client)
                self._hop(hops, i, m, "error", t_hop)
                self._journal_route(trace, hops, t0, "error", n_rows)
                raise e
            except (ConnectionError, socket.timeout, OSError) as e:
                m.invalidate(client)
                m.backoff.fail()
                m.drain_pool()
                last_err = e
                hedged = True
                self._hop(hops, i, m,
                          ("timeout" if isinstance(e, socket.timeout)
                           else "connect_error"), t_hop)
                continue
            m.checkin(client)
            # the ONLY ladder reset: a COMPLETED round-trip — never a
            # bare successful connect (see the zombie note above)
            m.backoff.ok()
            self._hop(hops, i, m, "ok", t_hop)
            with self._lock:
                self._routed += 1
                if i > 0:
                    self._hedges += 1
            self._journal_route(trace, hops, t0, "ok", n_rows)
            return out
        with self._lock:
            self._errors += 1
        if isinstance(last_err, serve_wire.WireOverload):
            self._journal_route(trace, hops, t0, "overload", n_rows)
            raise last_err
        self._journal_route(trace, hops, t0, "route_failed", n_rows)
        raise ConnectionError(
            f"fleet route failed (hedged={hedged}): {last_err}")

    def _maybe_mint(self, trace):
        """Ingress sampling: 1-in-`trace_sample` traceless requests get
        a fresh sampled TraceContext.  A client-supplied trace always
        wins — the caller's sampling decision is authoritative."""
        if trace is not None or self.trace_sample <= 0:
            return trace
        with self._lock:
            self._ingress += 1
            if self._ingress % self.trace_sample:
                return None
        from ..obs import tracing
        return tracing.mint()

    def score_rows(self, rows, *, model_id: str = "default", trace=None,
                   t_ingress: Optional[float] = None,
                   dtype: Optional[int] = None):
        """Route one SCORE: `dtype` is the wire dtype to the member
        (default the client's, int8)."""
        from . import serve_wire

        trace = self._maybe_mint(trace)
        n = int(getattr(rows, "shape", (1,))[0]) if hasattr(
            rows, "shape") and getattr(rows, "ndim", 1) > 1 else 1
        wire = serve_wire.DTYPE_INT8 if dtype is None else int(dtype)
        return self._roundtrip(
            lambda c, t: c.score_rows(rows, dtype=wire, trace=t),
            key=model_id, trace=trace, t_ingress=t_ingress, n_rows=n)

    def stats(self, *, model_id: str = "default") -> dict:
        return self._roundtrip(lambda c, _t: c.stats(), key=model_id)

    def ping(self, *, model_id: str = "default") -> bool:
        return self._roundtrip(lambda c, _t: c.ping(), key=model_id)

    def router_stats(self) -> dict:
        with self._lock:
            return {"routed": self._routed, "hedges": self._hedges,
                    "sheds": self._sheds, "errors": self._errors,
                    "members": sorted(self._members),
                    "barrier": self._barrier}

    # alias used by fleet_forever's farewell line
    def stats_summary(self) -> dict:
        return self.router_stats()

    def close(self) -> None:
        with self._lock:
            members = list(self._members.values())
            self._members.clear()
            self._ring = []
        for m in members:
            m.drain_pool()


class RouterServer:
    """The fleet's wire face: accepts serve_wire connections exactly
    like ServeServer, but each request is ROUTED to a member instead of
    scored locally.  Thread-per-connection (client count = sender
    count, same envelope as ServeServer)."""

    IDLE_TIMEOUT_S = 300.0

    def __init__(self, router: FleetRouter, host: str = "127.0.0.1",
                 port: int = 0, manager=None):
        self.router = router
        self.manager = manager   # for SWAP fan-out + STATS rollup
        self._srv = socket.create_server((host, port), reuse_port=False)
        self.host, self.port = self._srv.getsockname()[:2]
        self._closing = threading.Event()
        self._accept_thread: Optional[threading.Thread] = None

    def start(self) -> "RouterServer":
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True, name="fleet-router")
        self._accept_thread.start()
        return self

    def close(self) -> None:
        self._closing.set()
        try:
            # wake the blocked accept() — see ServeServer.close
            self._srv.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._srv.close()
        except OSError:
            pass
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=5)

    def __enter__(self) -> "RouterServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    def _accept_loop(self) -> None:
        while not self._closing.is_set():
            try:
                conn, _addr = self._srv.accept()
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True, name="fleet-router-conn").start()

    def _serve_conn(self, conn) -> None:
        import json

        import numpy as np

        from . import serve_wire

        conn.settimeout(self.IDLE_TIMEOUT_S)
        try:
            while not self._closing.is_set():
                try:
                    (op, dtype, n_rows, n_cols, scale, offset, payload,
                     trace) = serve_wire.read_request(conn,
                                                      with_trace=True)
                except (ConnectionError, socket.timeout, OSError,
                        ValueError):
                    return
                # ingress stamp at frame receipt: the route_trace e2e
                # covers everything the client waited for past the wire
                t_ingress = time.perf_counter()
                try:
                    if op == serve_wire.OP_PING:
                        serve_wire.write_response(
                            conn, serve_wire.STATUS_OK, b"")
                    elif op == serve_wire.OP_SCORE:
                        rows = serve_wire.decode_rows(
                            payload, dtype, n_rows, n_cols, scale,
                            offset)
                        out = self.router.score_rows(
                            rows, trace=trace, t_ingress=t_ingress,
                            dtype=dtype)
                        body = np.ascontiguousarray(
                            out, dtype=np.float32).tobytes()
                        serve_wire.write_response(
                            conn, serve_wire.STATUS_OK, body,
                            n_rows=out.shape[0],
                            n_cols=out.shape[1] if out.ndim > 1 else 1)
                    elif op == serve_wire.OP_STATS:
                        body = json.dumps(self._stats_body()).encode()
                        serve_wire.write_response(
                            conn, serve_wire.STATUS_OK, body)
                    elif op == serve_wire.OP_SWAP:
                        self._handle_swap(conn, payload)
                    else:
                        serve_wire.write_response(
                            conn, serve_wire.STATUS_ERROR,
                            f"unknown op {op}".encode())
                except serve_wire.WireOverload:
                    serve_wire.write_response(
                        conn, serve_wire.STATUS_OVERLOAD,
                        b"fleet saturated")
                except serve_wire.WireError as e:
                    serve_wire.write_response(
                        conn, serve_wire.STATUS_ERROR,
                        str(e).encode()[:1024])
                except NoHealthyMember as e:
                    serve_wire.write_response(
                        conn, serve_wire.STATUS_ERROR,
                        str(e).encode()[:1024])
                except (ConnectionError, socket.timeout) as e:
                    serve_wire.write_response(
                        conn, serve_wire.STATUS_ERROR,
                        f"fleet: {e}".encode()[:1024])
        except (ConnectionError, BrokenPipeError, OSError):
            return
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _stats_body(self) -> dict:
        """Fleet STATS: a member's stats (so wire clients — loadtest's
        num_features probe included — see a daemon-shaped dict) plus the
        router's own table under "fleet"."""
        body = {}
        try:
            body = dict(self.router.stats())
        except Exception as e:  # noqa: BLE001 — stats must not kill conn
            body = {"error": f"{type(e).__name__}: {e}"[:200]}
        body["fleet"] = self.router.router_stats()
        if self.manager is not None:
            try:
                body["fleet"].update(self.manager.summary())
            except Exception:
                pass
        return body

    def _handle_swap(self, conn, payload: bytes) -> None:
        import json

        from . import serve_wire

        if self.manager is None:
            serve_wire.write_response(
                conn, serve_wire.STATUS_ERROR,
                b"fleet router has no manager: swap refused")
            return
        try:
            req = json.loads(payload.decode() or "{}")
            target = req.get("export_dir") or req["path"]
            out = self.manager.swap_fleet(target,
                                          engine=req.get("engine"))
        except Exception as e:  # noqa: BLE001
            serve_wire.write_response(
                conn, serve_wire.STATUS_ERROR,
                f"fleet swap: {type(e).__name__}: {e}".encode()[:1024])
            return
        status = (serve_wire.STATUS_OK if out.get("ok")
                  else serve_wire.STATUS_ERROR)
        serve_wire.write_response(conn, status,
                                  json.dumps(out).encode())
