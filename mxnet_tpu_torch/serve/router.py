"""Router — the resilience plane over N InferenceServer replicas (≙
``mxnet_tpu/serve/router.py``: the same gates, knobs, counters and wire
format; stdlib HTTP, the server's listen backlog).

A reverse proxy that makes a fleet of single-process serving replicas
(server.py) survive member failure: tolerate a member loss, absorb it
with bounded waiting, keep the aggregate making progress.

Per replica, three independent gates decide routability:

- **health** — an active prober hits ``/healthz`` every
  ``MXNET_ROUTER_PROBE_MS``; the readiness-aware endpoint (server.py)
  returns 200 only when every model's bucket ladder is compiled and the
  replica is not draining.  ``MXNET_ROUTER_UNHEALTHY_AFTER``
  consecutive probe *errors* eject the replica (``router.ejections``);
  an explicit 503 (warming / draining) un-routes it immediately without
  counting as an ejection.  The same sweep scrapes ``/metrics`` for
  ``serve.queue_depth`` and the ``serve.e2e_us`` histogram (p99 via
  ``telemetry.quantile_from_hist`` on de-cumulated Prometheus buckets).
- **circuit breaker** — closed → open after
  ``MXNET_ROUTER_BREAKER_FAILS`` consecutive *request* failures
  (connection error, per-attempt timeout, 5xx); open → half-open after
  ``MXNET_ROUTER_COOLDOWN_MS`` (one trial request allowed); half-open →
  closed on trial success, back to open on trial failure.  Transitions
  are counted (``router.breaker_open`` / ``_half_open`` / ``_close``).
  429/503 from a replica is ALIVE pushback — rerouted, never a breaker
  failure.
- **load** — among routable replicas the pick minimizes
  ``inflight + scraped queue_depth`` with the scraped p99 as tiebreak
  (weighted least-loaded), except that a half-open replica with no
  trial in flight is picked first so breakers actually get to close.

``forward()`` retries failures across replicas with exponential
backoff + full jitter (``MXNET_ROUTER_RETRIES`` attempts total) — safe
because an inference forward holds no state and repeats bit for bit.  Retry budget exhaustion → 502.
With ``MXNET_ROUTER_HEDGE=1`` a hedge request is fired at a second
replica once the first has been silent for a p99-derived delay; the
winner's response is used and the loser's connection is closed (real
cancellation, counted neutral for its breaker).

The router's own HTTP front end mirrors the replica surface:
``POST /v1/predict`` (proxied), ``GET /healthz`` (200 while ≥1 replica
is routable, with the per-replica gate states), ``GET /metrics`` (the
router's OWN telemetry — ``router.*`` section), ``GET /v1/models``
(proxied to one routable replica).
"""
from __future__ import annotations

import http.client
import json
import os
import random
import threading
import time
from http.server import BaseHTTPRequestHandler
from typing import Dict, List, Optional, Sequence, Tuple

from .. import telemetry as _telemetry
from .server import _HTTPServer

__all__ = ["Router", "Replica"]


_US = 1e6


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, ""))
    except ValueError:
        return default


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, ""))
    except ValueError:
        return default


# --------------------------------------------------------------- replica
class Replica:
    """Router-side state for one backend: address + the three gates."""

    __slots__ = ("host", "port", "key",
                 "status", "probe_failures",
                 "breaker", "fails", "opened_at", "trial_busy",
                 "inflight", "queue_depth", "p99_us")

    def __init__(self, spec):
        if isinstance(spec, (tuple, list)):
            host, port = spec
        else:
            host, _, port = str(spec).rpartition(":")
        self.host = host or "127.0.0.1"
        self.port = int(port)
        self.key = f"{self.host}:{self.port}"
        self.status = "unprobed"    # ready|warming|draining|down|unprobed
        self.probe_failures = 0
        self.breaker = "closed"     # closed|open|half_open
        self.fails = 0
        self.opened_at = 0.0
        self.trial_busy = False     # half-open single-trial latch
        self.inflight = 0
        self.queue_depth = 0.0
        self.p99_us: Optional[float] = None

    def state(self) -> dict:
        return {"key": self.key, "status": self.status,
                "breaker": self.breaker, "inflight": self.inflight,
                "queue_depth": self.queue_depth, "p99_us": self.p99_us}


def _parse_metrics(text: str) -> Tuple[Optional[float], Optional[float]]:
    """(serve.queue_depth, p99 of serve.e2e_us in µs) from one replica's
    Prometheus exposition.  Buckets arrive cumulative with a final +Inf;
    quantile_from_hist wants per-bucket counts, so de-cumulate."""
    depth = None
    le: List[float] = []
    cum: List[float] = []
    count = 0
    for line in text.splitlines():
        if line.startswith("mxtpu_serve_queue_depth "):
            depth = float(line.split()[-1])
        elif line.startswith("mxtpu_serve_e2e_us_bucket{le="):
            bound = line.split('"', 2)[1]
            if bound != "+Inf":
                le.append(float(bound))
            cum.append(float(line.split()[-1]))
        elif line.startswith("mxtpu_serve_e2e_us_count "):
            count = int(float(line.split()[-1]))
    p99 = None
    if count > 0 and cum:
        counts = [cum[0]] + [cum[i] - cum[i - 1]
                             for i in range(1, len(cum))]
        p99 = _telemetry.quantile_from_hist(
            {"le": le, "counts": counts, "count": count, "sum": 0.0}, 0.99)
    return depth, p99


# ----------------------------------------------------------------- router
class Router:
    """Health-gated, breaker-protected, least-loaded proxy over replicas.

    ``replicas`` is a sequence of ``"host:port"`` strings (or
    ``(host, port)`` pairs).  ``start()`` runs one synchronous probe
    sweep (so routing decisions never run blind), starts the prober
    thread and the HTTP front end; ``forward()`` is the in-process
    client API the front end itself uses.
    """

    def __init__(self, replicas: Sequence, host: Optional[str] = None,
                 port: Optional[int] = None, *,
                 probe_interval_ms: Optional[float] = None,
                 probe_timeout_ms: Optional[float] = None,
                 unhealthy_after: Optional[int] = None,
                 breaker_fails: Optional[int] = None,
                 cooldown_ms: Optional[float] = None,
                 retries: Optional[int] = None,
                 backoff_ms: Optional[float] = None,
                 timeout_ms: Optional[float] = None,
                 hedge: Optional[bool] = None,
                 hedge_floor_ms: Optional[float] = None):
        self.replicas = [Replica(s) for s in replicas]
        if not self.replicas:
            raise ValueError("Router needs at least one replica")
        self.probe_interval_s = (_env_float("MXNET_ROUTER_PROBE_MS", 500.0)
                                 if probe_interval_ms is None
                                 else float(probe_interval_ms)) / 1e3
        self.probe_timeout_s = (
            _env_float("MXNET_ROUTER_PROBE_TIMEOUT_MS", 1000.0)
            if probe_timeout_ms is None else float(probe_timeout_ms)) / 1e3
        self.unhealthy_after = _env_int("MXNET_ROUTER_UNHEALTHY_AFTER", 3) \
            if unhealthy_after is None else int(unhealthy_after)
        self.breaker_fails = _env_int("MXNET_ROUTER_BREAKER_FAILS", 3) \
            if breaker_fails is None else int(breaker_fails)
        self.cooldown_s = (_env_float("MXNET_ROUTER_COOLDOWN_MS", 1000.0)
                           if cooldown_ms is None else float(cooldown_ms)) \
            / 1e3
        self.max_attempts = max(1, _env_int("MXNET_ROUTER_RETRIES", 3)
                                if retries is None else int(retries))
        self.backoff_s = (_env_float("MXNET_ROUTER_BACKOFF_MS", 25.0)
                          if backoff_ms is None else float(backoff_ms)) / 1e3
        self.timeout_s = (_env_float("MXNET_ROUTER_TIMEOUT_MS", 10000.0)
                          if timeout_ms is None else float(timeout_ms)) / 1e3
        self.hedge = (os.environ.get("MXNET_ROUTER_HEDGE", "0").lower()
                      in ("1", "true", "on")) if hedge is None else bool(hedge)
        self.hedge_floor_s = (
            _env_float("MXNET_ROUTER_HEDGE_FLOOR_MS", 50.0)
            if hedge_floor_ms is None else float(hedge_floor_ms)) / 1e3

        self._mu = threading.Lock()
        self._stop = threading.Event()
        self._prober: Optional[threading.Thread] = None

        self.host = host if host is not None else \
            os.environ.get("MXNET_ROUTER_HOST", "127.0.0.1")
        if port is None:
            port = int(os.environ.get("MXNET_ROUTER_PORT", "8090"))
        handler = type("_BoundRouterHandler", (_RouterHandler,),
                       {"router": self})
        self._httpd = _HTTPServer((self.host, int(port)), handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None
        _telemetry.gauge_set("router.replicas", len(self.replicas))

    # ------------------------------------------------------------ probing
    def _http(self, rep: Replica, method: str, path: str,
              body: Optional[bytes] = None,
              timeout: Optional[float] = None):
        conn = http.client.HTTPConnection(
            rep.host, rep.port,
            timeout=self.probe_timeout_s if timeout is None else timeout)
        try:
            conn.request(method, path, body=body,
                         headers={"Content-Type": "application/json"}
                         if body is not None else {})
            resp = conn.getresponse()
            return resp.status, resp.read()
        finally:
            conn.close()

    def probe_once(self, rep: Replica):
        """One health + metrics sweep for one replica; updates its
        status gate and load estimates."""
        try:
            status, body = self._http(rep, "GET", "/healthz")
        except OSError:
            with self._mu:
                rep.probe_failures += 1
                if rep.probe_failures >= self.unhealthy_after \
                        and rep.status != "down":
                    rep.status = "down"
                    _telemetry.counter_add("router.ejections")
            self._publish_gauges()
            return
        with self._mu:
            rep.probe_failures = 0
            if status == 200:
                if rep.status != "ready":
                    if rep.status == "down":
                        _telemetry.counter_add("router.reinstatements")
                    rep.status = "ready"
            else:
                try:
                    rep.status = json.loads(body).get("status", "warming")
                except (ValueError, AttributeError):
                    rep.status = "warming"
        try:
            _, mtext = self._http(rep, "GET", "/metrics")
            depth, p99 = _parse_metrics(mtext.decode("utf-8", "replace"))
            with self._mu:
                if depth is not None:
                    rep.queue_depth = depth
                if p99 is not None:
                    rep.p99_us = p99
        except OSError:
            pass
        self._publish_gauges()

    def probe_all(self):
        for rep in self.replicas:
            self.probe_once(rep)

    def _publish_gauges(self):
        with self._mu:
            routable = sum(1 for r in self.replicas
                           if self._routable_locked(r, time.monotonic()))
            for r in self.replicas:
                # 2=routable, 1=alive-but-gated (warming/draining/open
                # breaker), 0=down — prometheus-safe after name mangling
                v = 2 if self._routable_locked(r, time.monotonic()) else \
                    (0 if r.status == "down" else 1)
                _telemetry.gauge_set(f"router.replica_state.{r.key}", v)
        _telemetry.gauge_set("router.replicas_routable", routable)

    def _probe_loop(self):
        while not self._stop.wait(self.probe_interval_s):
            self.probe_all()

    # ------------------------------------------------------------ breaker
    def _routable_locked(self, rep: Replica, now: float) -> bool:
        if rep.status != "ready":
            return False
        if rep.breaker == "closed":
            return True
        if rep.breaker == "open":
            return now - rep.opened_at >= self.cooldown_s
        return not rep.trial_busy          # half_open: one trial at a time

    def _pick(self, exclude: Optional[set] = None) -> Optional[Replica]:
        """Least-loaded routable replica; half-open replicas with a free
        trial slot are preferred so their breakers can close."""
        now = time.monotonic()
        exclude = exclude or set()
        with self._mu:
            cands = [r for r in self.replicas
                     if r.key not in exclude
                     and self._routable_locked(r, now)]
            if not cands and exclude:
                cands = [r for r in self.replicas
                         if self._routable_locked(r, now)]
            if not cands:
                return None
            trial = [r for r in cands if r.breaker != "closed"]
            if trial:
                rep = trial[0]
                if rep.breaker == "open":
                    rep.breaker = "half_open"
                    _telemetry.counter_add("router.breaker_half_open")
                rep.trial_busy = True
            else:
                rep = min(cands, key=lambda r: (
                    r.inflight + r.queue_depth,
                    r.p99_us if r.p99_us is not None else float("inf")))
            rep.inflight += 1
            return rep

    def _settle(self, rep: Replica, outcome: str):
        """Breaker bookkeeping after one attempt.  outcome ∈ ok | shed |
        fail | cancelled — shed (429/503) is alive pushback and counts
        as breaker success; cancelled (hedge loser) is neutral."""
        with self._mu:
            rep.inflight = max(0, rep.inflight - 1)
            was_trial = rep.breaker == "half_open" and rep.trial_busy
            if was_trial:
                rep.trial_busy = False
            if outcome in ("ok", "shed"):
                rep.fails = 0
                if rep.breaker != "closed":
                    rep.breaker = "closed"
                    _telemetry.counter_add("router.breaker_close")
            elif outcome == "fail":
                rep.fails += 1
                if rep.breaker == "half_open" or \
                        rep.fails >= self.breaker_fails:
                    if rep.breaker != "open":
                        _telemetry.counter_add("router.breaker_open")
                    rep.breaker = "open"
                    rep.fails = 0
                    rep.opened_at = time.monotonic()
            # cancelled: no breaker movement
        self._publish_gauges()

    # ------------------------------------------------------------ attempt
    def _attempt(self, rep: Replica, body: bytes, path: str,
                 slot: dict, tag: str, trace_ctx=None):
        """One proxied POST.  Results land in ``slot`` under ``tag`` as
        (class, status, headers, payload); the connection is parked in
        the slot so a hedging rival can close it (cancellation).
        ``trace_ctx`` is the caller's (trace_id, span_id) — attempts run
        in their own threads, so parentage must be handed over
        explicitly; the attempt span's id rides to the replica in
        X-MXNet-Trace so the replica's spans nest under THIS attempt."""
        conn = http.client.HTTPConnection(rep.host, rep.port,
                                          timeout=self.timeout_s)
        with slot["mu"]:
            slot[tag + "_conn"] = conn
        t0 = time.perf_counter()
        with _telemetry.span("router.attempt", parent=trace_ctx,
                             replica=rep.key,
                             hedge=(tag == "hed")) as sp:
            try:
                hdrs = {"Content-Type": "application/json"}
                th = sp.header()
                if th:
                    hdrs[_telemetry.TRACE_HEADER] = th
                conn.request("POST", path, body=body, headers=hdrs)
                resp = conn.getresponse()
                payload = resp.read()
                status = resp.status
                headers = {k: v for k, v in resp.getheaders()
                           if k.lower() in ("retry-after", "content-type")}
            except OSError:
                with slot["mu"]:
                    # a rival that already won closed this connection from
                    # under us: that is cancellation, not a replica failure
                    cancelled = slot.get("winner") is not None and \
                        slot["winner"] != tag
                    slot[tag] = ("cancelled" if cancelled else "fail",
                                 0, {}, b"")
                sp.set(outcome=slot[tag][0])
                if slot[tag][0] == "cancelled":
                    sp.set(cancelled=True)
                _telemetry.observe("router.attempt_us",
                                   (time.perf_counter() - t0) * _US)
                # settle BEFORE signalling so breaker state is consistent
                # by the time the caller consumes the result
                self._settle(rep, slot[tag][0])
                slot["done"].set()
                return
            finally:
                conn.close()
            if status < 300:
                cls = "ok"
            elif status in (400, 404):
                cls = "ok"      # pass through: caller error, replica fine
            elif status in (429, 503):
                cls = "shed"
            else:
                cls = "fail"    # 5xx and anything unclassified
            sp.set(status=status, outcome=cls)
            _telemetry.observe("router.attempt_us",
                               (time.perf_counter() - t0) * _US)
            with slot["mu"]:
                slot[tag] = (cls, status, headers, payload)
                if cls == "ok" and slot.get("winner") is None:
                    slot["winner"] = tag
            self._settle(rep, cls)
            slot["done"].set()

    def _hedge_delay_s(self, rep: Replica) -> float:
        p99 = rep.p99_us
        return max(self.hedge_floor_s,
                   (p99 / _US) if p99 is not None else 0.0)

    def _attempt_hedged(self, rep: Replica, body: bytes, path: str):
        """Primary attempt with an optional hedge to a second replica
        after a p99-derived silence.  Returns (class, status, headers,
        payload) of the winner."""
        slot = {"mu": threading.Lock(), "done": threading.Event(),
                "winner": None}
        # attempts run in worker threads: hand the caller's trace
        # context over explicitly (thread-locals stay behind)
        trace_ctx = _telemetry.current_context()
        t_pri = threading.Thread(
            target=self._attempt,
            args=(rep, body, path, slot, "pri", trace_ctx),
            name="router-attempt-pri", daemon=True)
        t_pri.start()
        hedged = None
        if self.hedge:
            if not slot["done"].wait(self._hedge_delay_s(rep)):
                hedged = self._pick(exclude={rep.key})
                if hedged is not None and hedged.key != rep.key:
                    _telemetry.counter_add("router.hedges")
                    threading.Thread(
                        target=self._attempt,
                        args=(hedged, body, path, slot, "hed", trace_ctx),
                        name="router-attempt-hed", daemon=True).start()
                elif hedged is not None:
                    self._settle(hedged, "cancelled")
                    hedged = None
        deadline = time.monotonic() + self.timeout_s + 1.0
        result, win, loser_conn = None, None, None
        while time.monotonic() < deadline:
            slot["done"].wait(max(0.0, deadline - time.monotonic()))
            with slot["mu"]:
                slot["done"].clear()
                pri, hed = slot.get("pri"), slot.get("hed")
                for tag, res in (("pri", pri), ("hed", hed)):
                    if res is not None and res[0] == "ok":
                        win = (tag, res)
                        break
                if win is not None:
                    result = win[1]
                    slot["winner"] = win[0]
                    loser = "hed" if win[0] == "pri" else "pri"
                    loser_conn = slot.get(loser + "_conn")
                elif pri is not None and (hedged is None
                                          or hed is not None):
                    # both settled, nobody ok: a shed beats a fail
                    # (it carries Retry-After the caller passes through)
                    result = pri if pri[0] == "shed" or hed is None \
                        else hed
                else:
                    continue
            break
        if win is not None:
            if hedged is not None:
                _telemetry.counter_add(
                    "router.hedge_wins" if win[0] == "hed"
                    else "router.hedge_losses")
            if loser_conn is not None:
                try:
                    loser_conn.close()   # real cancellation
                    _telemetry.counter_add("router.cancelled")
                except OSError:
                    pass
        if result is None:
            result = ("fail", 0, {}, b"")
        return result

    # ------------------------------------------------------------ forward
    def forward(self, body: bytes, path: str = "/v1/predict"
                ) -> Tuple[int, Dict[str, str], bytes]:
        """Proxy one predict with retries/backoff/hedging; the client
        API used by the router's own HTTP front end, chaos harness and
        tests.  Returns (status, headers, payload)."""
        _telemetry.counter_add("router.requests")
        t0 = time.perf_counter()
        shed = None
        backoff = self.backoff_s
        tried_failed: set = set()
        with _telemetry.span("router.forward", path=path) as fsp:
            for attempt in range(self.max_attempts):
                if attempt > 0:
                    _telemetry.counter_add("router.retries")
                rep = self._pick(exclude=tried_failed)
                if rep is None:
                    _telemetry.counter_add("router.no_replica")
                    time.sleep(min(self.cooldown_s, 0.05)
                               * random.uniform(0.5, 1.5))
                    continue
                # one child span per retry leg; the per-connection
                # router.attempt spans (pri + optional hedge) nest under
                # it via the context handoff in _attempt_hedged
                with _telemetry.span("router.try", attempt=attempt,
                                     replica=rep.key):
                    cls, status, headers, payload = \
                        self._attempt_hedged(rep, body, path)
                if cls == "ok":
                    _telemetry.counter_add("router.ok")
                    _telemetry.observe("router.e2e_us",
                                       (time.perf_counter() - t0) * _US)
                    fsp.set(attempts=attempt + 1, outcome="ok")
                    return status, headers, payload
                if cls == "shed":
                    _telemetry.counter_add("router.reroutes")
                    shed = (status, headers, payload)
                    continue        # alive pushback: next replica, now
                _telemetry.counter_add("router.failures")
                tried_failed.add(rep.key)
                time.sleep(backoff * random.uniform(0.0, 1.0))  # jitter
                backoff = min(backoff * 2.0, 1.0)
            fsp.set(attempts=self.max_attempts,
                    outcome="shed" if shed is not None else "fail")
        _telemetry.observe("router.e2e_us",
                           (time.perf_counter() - t0) * _US)
        if shed is not None:
            # every routable replica is shedding: pass the pushback (and
            # its Retry-After) through rather than fabricating a 502
            return shed
        _telemetry.counter_add("router.http_502")
        return 502, {}, json.dumps(
            {"error": f"no replica served the request after "
                      f"{self.max_attempts} attempts"}).encode()

    # -------------------------------------------------------------- admin
    def stats(self) -> dict:
        with self._mu:
            states = [r.state() for r in self.replicas]
        now = time.monotonic()
        with self._mu:
            routable = sum(1 for r in self.replicas
                           if self._routable_locked(r, now))
        return {"replicas": states, "routable": routable,
                "hedge": self.hedge, "max_attempts": self.max_attempts}

    def start(self):
        if self._thread is not None:
            return self
        self.probe_all()            # never route blind
        self._prober = threading.Thread(
            target=self._probe_loop, name="router-prober", daemon=True)
        self._prober.start()
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name=f"router-http-{self.port}", daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._prober is not None:
            self._prober.join(5.0)
            self._prober = None
        if self._thread is not None:
            self._httpd.shutdown()
            self._thread.join(10.0)
            self._thread = None
        self._httpd.server_close()

    def serve_forever(self):
        try:
            self.probe_all()
            self._prober = threading.Thread(
                target=self._probe_loop, name="router-prober", daemon=True)
            self._prober.start()
            self._httpd.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            self.stop()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


# ------------------------------------------------------------- front end
class _RouterHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    router: Router = None       # type: ignore[assignment]

    def log_message(self, fmt, *args):
        pass

    def _reply(self, code: int, body, content_type="application/json",
               headers=None):
        raw = body if isinstance(body, bytes) else \
            json.dumps(body).encode()
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(raw)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(raw)

    def do_GET(self):
        r = self.router
        if self.path == "/healthz":
            st = r.stats()
            ok = st["routable"] > 0
            st["status"] = "ok" if ok else "no_routable_replicas"
            self._reply(200 if ok else 503, st)
        elif self.path == "/metrics":
            self._reply(200, _telemetry.dump_prometheus().encode(),
                        content_type="text/plain; version=0.0.4")
        elif self.path == "/v1/models":
            rep = r._pick()
            if rep is None:
                self._reply(503, {"error": "no routable replica"})
                return
            try:
                status, body = r._http(rep, "GET", "/v1/models",
                                       timeout=r.timeout_s)
                r._settle(rep, "ok")
                self._reply(status, body)
            except OSError as e:
                r._settle(rep, "fail")
                self._reply(502, {"error": f"replica {rep.key}: {e}"})
        else:
            self._reply(404, {"error": f"no route {self.path}"})

    def do_POST(self):
        if self.path != "/v1/predict":
            self._reply(404, {"error": f"no route {self.path}"})
            return
        try:
            n = int(self.headers.get("Content-Length", 0))
            if n <= 0:
                raise ValueError("missing body")
            body = self.rfile.read(n)
        except ValueError as e:
            self._reply(400, {"error": f"bad request: {e}"})
            return
        trace_hdr = self.headers.get(_telemetry.TRACE_HEADER)
        with _telemetry.span("router.request", parent=(trace_hdr or None)):
            status, headers, payload = self.router.forward(body)
        self._reply(status, payload,
                    content_type=headers.get("Content-Type",
                                             "application/json"),
                    headers={k: v for k, v in headers.items()
                             if k.lower() == "retry-after"})


def _main(argv):
    import argparse

    p = argparse.ArgumentParser(prog="mxnet_tpu_torch.serve.router")
    p.add_argument("--replica", action="append", required=True,
                   metavar="HOST:PORT", help="backend replica (repeat)")
    p.add_argument("--host", default=None)
    p.add_argument("--port", type=int, default=None)
    p.add_argument("--hedge", action="store_true", default=None)
    args = p.parse_args(argv)
    r = Router(args.replica, host=args.host, port=args.port,
               hedge=args.hedge)
    print(f"[router] listening on {r.host}:{r.port} "
          f"replicas={[x.key for x in r.replicas]}")
    r.serve_forever()
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(_main(sys.argv[1:]))
