"""The per-process diagnostics server: the port of ``paddle_tpu/profiler/diag.py``.

A stdlib ``ThreadingHTTPServer`` daemon (``FLAGS_diag_port``; -1 = off,
0 = ephemeral, > 0 = fixed) bound to ``FLAGS_diag_host`` (the loopback
interface by default) serving read-only endpoints built on DETACHED
snapshots, so a scrape never blocks or tears a training step:

  GET /metrics       Prometheus text exposition v0.0.4
                     (``metrics.prometheus_text()``: registry-native
                     metrics + the adopted dispatch-counter family)
  GET /healthz       liveness, HTTP 200/503 + JSON body: 503 when the
                     step heartbeat is older than FLAGS_trace_stall_ms,
                     when the perf-regression sentinel is tripped
                     (status 'degraded', reason 'perf_regression'), or
                     when every registered serving engine is dead
  GET /readyz        readiness: /healthz AND (when serving engines are
                     registered) at least one engine past 'warming' that
                     still accepts work
  GET /flight        flight-recorder tail as JSON;
                     ``?kind=&site=&last=N`` filter server-side
  GET /postmortems   list the FLAGS_postmortem_dir dumps;
                     /postmortems/<name> fetches one
  GET /programz      the attribution layer's program costs and telemetry
  GET /statusz       one human-readable page: capture state, ladder,
                     checkpoint cadence, attribution, sentinel baselines,
                     engine health / queue depth / pool occupancy
  GET /clockz        {wall, perf_ns}: the clock-offset handshake

``start()`` is idempotent and a no-op while FLAGS_diag_port is -1; serving
engines register themselves (weakly) at construction. Host code, copied;
the elastic-rescale section of /statusz comes with item 13c. The "memory
plan & offload" section lists the last remat plan per source
(``analysis.plan.state()``) and every offload scheduler
(``optimizer.offload.state()``), when there are any.
"""
from __future__ import annotations

import json
import os
import threading
import time
import weakref
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Tuple
from urllib.parse import parse_qs, urlsplit

from ..core import flags as _flags
from . import metrics as _metrics
from . import sentinel as _sentinel
from . import trace as _trace

__all__ = [
    "address",
    "engines",
    "health_doc",
    "ready_doc",
    "register_engine",
    "start",
    "started",
    "statusz_text",
    "stop",
    "unregister_engine",
]

_lock = threading.Lock()
_server: Optional[ThreadingHTTPServer] = None
_thread: Optional[threading.Thread] = None
_started_at: Optional[float] = None

# serving engines whose health /healthz aggregates. Weak: a dropped engine
# must not be pinned alive (its pool holds the K/V arrays) by diagnostics.
_engines: "weakref.WeakSet" = weakref.WeakSet()


def register_engine(engine) -> None:
    """Called by ``serving.Engine.__init__``; safe to call repeatedly."""
    _engines.add(engine)


def unregister_engine(engine) -> None:
    _engines.discard(engine)


def engines() -> List[Any]:
    """Live registered engines (sorted by uid for stable output)."""
    return sorted(_engines, key=lambda e: getattr(e, "_uid", 0))


# ---------------------------------------------------------------------------
# health / readiness
# ---------------------------------------------------------------------------
def health_doc() -> Tuple[int, Dict[str, Any]]:
    """(http_status, body) for /healthz — liveness. Unhealthy (503) when:
    the step heartbeat is stale past FLAGS_trace_stall_ms (one watchdog
    period), the perf-regression sentinel is tripped, or every registered
    serving engine is dead."""
    reasons: List[str] = []
    hb_age = _trace.heartbeat_age_ms()
    stall_ms = float(_flags.flag("trace_stall_ms"))
    if stall_ms > 0 and hb_age is not None and hb_age > stall_ms:
        reasons.append("stalled")
    tripped = _sentinel.tripped()
    # straggler[<node>] keys are latched by the FLEET detector (this
    # worker measurably slower than the fleet median) — same degraded
    # semantics, distinct reason so operators see WHICH defense fired
    if any(k.startswith("straggler[") for k in tripped):
        reasons.append("straggler")
    if any(not k.startswith("straggler[") for k in tripped):
        reasons.append("perf_regression")
    engs = engines()
    eng_health = {str(getattr(e, "_uid", i)): e.health
                  for i, e in enumerate(engs)}
    if engs and all(h == "dead" for h in eng_health.values()):
        reasons.append("engines_dead")
    if not reasons:
        status = "ok"
    elif all(r in ("perf_regression", "straggler") for r in reasons):
        status = "degraded"  # still alive — but measurably slower
    else:
        status = "unhealthy"
    try:
        from ..resilience import faults as _faults

        step = _faults.current_step()
    except Exception:
        step = None
    doc = {
        "status": status,
        "reasons": reasons,
        "pid": os.getpid(),
        "wall": time.time(),
        "step": step,
        "heartbeat_age_ms": (None if hb_age is None else round(hb_age, 1)),
        "stall_threshold_ms": stall_ms or None,
        "sentinel_tripped": tripped,
        "engines": eng_health,
    }
    return (200 if not reasons else 503), doc


def ready_doc() -> Tuple[int, Dict[str, Any]]:
    """(http_status, body) for /readyz — may this replica take NEW work?
    Liveness plus, when serving engines are registered, at least one
    engine past 'warming' that still accepts admissions."""
    code, doc = health_doc()
    engs = engines()
    if engs:
        serviceable = [uid for uid, h in doc["engines"].items()
                       if h in ("ready", "degraded")]
        doc["serviceable_engines"] = serviceable
        if not serviceable:
            doc["reasons"] = list(doc["reasons"]) + ["no_serviceable_engine"]
            doc["status"] = ("unhealthy" if doc["status"] == "ok"
                             else doc["status"])
            code = 503
    return code, doc


# ---------------------------------------------------------------------------
# /statusz
# ---------------------------------------------------------------------------
def _section(title: str) -> str:
    return f"\n== {title} " + "=" * max(0, 58 - len(title)) + "\n"


def statusz_text() -> str:
    """The one human-readable page: what tier each step runs at, ladder
    state, cadence, sentinel baselines, pool occupancy, queue depths.
    Every section degrades independently — a broken subsystem renders as
    an error line, never a dead page."""
    out: List[str] = []
    code, health = health_doc()
    up = None if _started_at is None else round(time.time() - _started_at, 1)
    out.append(
        f"paddle_tpu_torch statusz  pid={os.getpid()}  status={health['status']} "
        f"({code})  step={health['step']}  diag_uptime_s={up}\n")
    hb = health["heartbeat_age_ms"]
    out.append(f"heartbeat_age_ms={hb}  "
               f"stall_threshold_ms={health['stall_threshold_ms']}\n")
    try:
        from ..core import lazy as _lazy

        out.append(_section("whole-step capture"))
        for k, v in sorted(_lazy.step_capture_state().items()):
            out.append(f"  {k} = {v}\n")
        out.append("  serve_capture = "
                   f"{_lazy.serve_capture_state()}\n")
    except Exception as e:
        out.append(f"  <capture state unavailable: {e!r}>\n")
    try:
        from ..resilience import runtime as _rt

        out.append(_section("resilience ladder"))
        st = _rt.state()
        out.append(f"  fault_inject = {st['fault_inject']!r}  "
                   f"retry_max = {st['retry_max']}  "
                   f"numeric_rescue = {st['numeric_rescue']!r}\n")
        ladder = st["ladder"]
        out.append(f"  demoted tiers = {ladder['demoted'] or 'none'}\n")
        out.append(f"  fault counts = {ladder['faults'] or {}}\n")
    except Exception as e:
        out.append(f"  <ladder state unavailable: {e!r}>\n")
    try:
        from .. import profiler

        c = profiler.dispatch_counters()
        out.append(_section("checkpoint cadence"))
        out.append(
            f"  auto_save_freq = {c.get('ckpt_auto_save_freq', 0)}  "
            f"snapshots = {c.get('ckpt_snapshots', 0)}  "
            f"async_saves = {c.get('ckpt_async_saves', 0)}  "
            f"stall_ms = {round(c.get('ckpt_pipeline_stall_ms', 0.0), 2)}\n")
    except Exception as e:
        out.append(f"  <checkpoint counters unavailable: {e!r}>\n")
    try:
        from . import attribution as _attribution

        costs = _attribution.costs_summary(8)
        tele = _attribution.telemetry_state()
        out.append(_section("attribution"))
        if not costs:
            out.append("  no measured programs yet\n")
        for row in costs:
            out.append(
                f"  {row['key']}: {row['ema_ms']}ms ema "
                f"({row['category']}, {row['runs']} runs, "
                f"drift={row['drift_pct']}%)\n")
        out.append(f"  telemetry: enabled={tele['enabled']} "
                   f"steps={tele['steps']} groups={len(tele['groups'])}\n")
        for name, g in sorted(tele["groups"].items()):
            out.append(
                f"    {name}: grad_norm={g['grad_norm']} "
                f"update_ratio={g['update_ratio']} spikes={g['spikes']}\n")
    except Exception as e:
        out.append(f"  <attribution state unavailable: {e!r}>\n")
    try:
        from ..analysis import plan as _plan
        from ..optimizer import offload as _offload

        plans = _plan.state()
        offl = _offload.state()
        if plans or offl:
            out.append(_section("memory plan & offload"))
            for src, doc in sorted(plans.items()):
                if doc.get("failed"):
                    out.append(f"  {src}: FAILED {doc.get('error')}\n")
                    continue
                out.append(
                    f"  {src}: {'feasible' if doc['feasible'] else 'best-effort'} "
                    f"peak {doc['peak_before_mb']}->{doc['peak_after_mb']}MB "
                    f"(budget {doc['budget_mb']}MB) recompute={doc['recompute_pct']}% "
                    f"cuts={doc['cut_points']} layers={len(doc['remat_layers'])} "
                    f"fingerprint={doc['fingerprint']} evals={doc['evals']} "
                    f"build_ms={doc['build_ms']}\n")
            for st in offl:
                out.append(
                    f"  offload[{st['cold_source']}]: {st['groups_selected']}/"
                    f"{st['groups_total']} groups {st['offloaded_mb']}MB parked  "
                    f"overhead={st['overhead_pct_ema']}% (budget {st['overhead_budget_pct']}%)  "
                    f"d2h={st['d2h_count']}x{st['d2h_ema_ms']}ms "
                    f"h2d={st['h2d_count']}x{st['h2d_ema_ms']}ms "
                    f"blocked_ema={st['blocked_ema_ms']}ms "
                    f"shrinks={st['shrinks']} regrows={st['regrows']}\n")
    except Exception as e:
        out.append(f"  <memory plan state unavailable: {e!r}>\n")
    try:
        out.append(_section("perf-regression sentinel"))
        st = _sentinel.state()
        out.append(f"  enabled = {st['enabled']}  pct = {st['pct']}  "
                   f"warmup = {st['warmup_steps']}  "
                   f"sustain = {st['sustain_steps']}\n")
        out.append(f"  tripped = {st['tripped'] or 'none'}\n")
        for k, v in sorted(st["keys"].items()):
            out.append(
                f"  {k}: baseline={v['baseline_ms']}ms "
                f"ema={v['ema_ms']}ms drift={v['drift_pct']}% "
                f"armed={v['armed']} tripped={v['tripped']} "
                f"trips={v['trips']} suppressed={v['suppressed']}\n")
    except Exception as e:
        out.append(f"  <sentinel state unavailable: {e!r}>\n")
    out.append(_section("serving engines"))
    engs = engines()
    if not engs:
        out.append("  none registered\n")
    for e in engs:
        try:
            stats = e.stats()
            out.append(
                f"  engine {getattr(e, '_uid', '?')}: "
                f"health={stats['health']} pending={stats['pending']} "
                f"queued={len(e._queue)} active={len(e._active)} "
                f"pool={stats['pool_occupancy']:.2f} "
                f"(peak {stats['pool_peak_occupancy']:.2f}) "
                f"completed={stats['completed']} shed={stats['shed']} "
                f"expired={stats['expired']} "
                f"p50={stats['token_lat_p50_ms']}ms "
                f"p99={stats['token_lat_p99_ms']}ms\n")
        except Exception as ex:
            out.append(f"  engine <error: {ex!r}>\n")
    try:
        ring = _trace.events()
        kinds: Dict[str, int] = {}
        for ev in ring:
            kinds[ev.kind] = kinds.get(ev.kind, 0) + 1
        out.append(_section("flight recorder"))
        out.append(f"  ring = {len(ring)} events  by kind = "
                   f"{dict(sorted(kinds.items()))}\n")
        out.append(f"  last postmortem = {_trace.last_postmortem_path()}\n")
    except Exception as e:
        out.append(f"  <flight ring unavailable: {e!r}>\n")
    return "".join(out)


# ---------------------------------------------------------------------------
# the HTTP server
# ---------------------------------------------------------------------------
_INDEX = (
    "paddle_tpu_torch diagnostics server\n"
    "endpoints: /metrics /healthz /readyz /flight?kind=&site=&last=N "
    "/postmortems /postmortems/<name> /programz /statusz /clockz\n"
)


def _q1(qs: Dict[str, List[str]], key: str) -> Optional[str]:
    v = qs.get(key)
    return v[0] if v else None


def _route(path: str, qs: Dict[str, List[str]]) -> Tuple[int, str, bytes]:
    """(status, content_type, body) for one GET. Raises propagate to the
    handler's 500 wrapper."""
    if path in ("", "/"):
        return 200, "text/plain; charset=utf-8", _INDEX.encode()
    if path == "/metrics":
        t0 = time.perf_counter()
        text = _metrics.prometheus_text(include_dispatch=True)
        dt_ms = (time.perf_counter() - t0) * 1000.0
        reg = _metrics.default_registry()
        reg.counter("diag_scrapes",
                    doc="GET /metrics requests served").inc()
        reg.histogram(
            "diag_scrape_ms",
            doc="server-side /metrics exposition build time, ms",
        ).observe(dt_ms)
        return (200, "text/plain; version=0.0.4; charset=utf-8",
                text.encode())
    if path == "/healthz":
        code, doc = health_doc()
        return code, "application/json", json.dumps(doc).encode()
    if path == "/readyz":
        code, doc = ready_doc()
        return code, "application/json", json.dumps(doc).encode()
    if path == "/flight":
        kind = _q1(qs, "kind")
        site = _q1(qs, "site")
        last_s = _q1(qs, "last")
        last = int(last_s) if last_s else None
        evs = _trace.events(last=last, kind=kind, site=site)
        doc = {"count": len(evs), "kind": kind, "site": site,
               "events": [e.as_dict() for e in evs]}
        return 200, "application/json", json.dumps(doc).encode()
    if path == "/clockz":
        doc = {"wall": time.time(), "perf_ns": time.perf_counter_ns(),
               "pid": os.getpid()}
        return 200, "application/json", json.dumps(doc).encode()
    if path == "/programz":
        # attribution layer: per-program cost profiles (static
        # flop/byte/top-ops estimates + measured wall-time EMAs) and the
        # fused-telemetry state — everything a "which program got slower /
        # which group blew up" question needs, as one JSON doc
        from . import attribution as _attribution

        static = _q1(qs, "static") not in ("0", "false", "off")
        k_s = _q1(qs, "top")
        doc = {
            "programs": _attribution.program_costs(
                top_k=int(k_s) if k_s else 5, static=static),
            "telemetry": _attribution.telemetry_state(),
        }
        return (200, "application/json",
                json.dumps(doc, default=str).encode())
    if path == "/statusz":
        return 200, "text/plain; charset=utf-8", statusz_text().encode()
    if path == "/postmortems" or path.startswith("/postmortems/"):
        return _postmortems_route(path)
    return 404, "text/plain", f"unknown path {path!r}\n{_INDEX}".encode()


def _postmortems_route(path: str) -> Tuple[int, str, bytes]:
    directory = str(_flags.flag("postmortem_dir"))
    if path == "/postmortems":
        entries = []
        if directory and os.path.isdir(directory):
            for name in sorted(os.listdir(directory)):
                if not name.startswith("postmortem_"):
                    continue
                p = os.path.join(directory, name)
                try:
                    st = os.stat(p)
                    entries.append({"name": name, "bytes": st.st_size,
                                    "mtime": st.st_mtime})
                except OSError:
                    continue
        try:
            from .. import profiler

            pruned = int(profiler.dispatch_counters().get(
                "postmortems_pruned", 0) or 0)
        except Exception:
            pruned = 0
        doc = {"dir": directory or None, "postmortems": entries,
               "keep": int(_flags.flag("postmortem_keep")),
               "pruned": pruned}
        return 200, "application/json", json.dumps(doc).encode()
    name = path[len("/postmortems/"):]
    # strict basename allowlist: this endpoint must never become a file
    # server (no separators, no traversal, only postmortem dumps)
    if (os.path.basename(name) != name or not name.startswith("postmortem_")
            or not name.endswith(".json")):
        return 404, "text/plain", b"not a postmortem name"
    if not directory:
        return 404, "text/plain", b"FLAGS_postmortem_dir is unset"
    p = os.path.join(directory, name)
    if not os.path.isfile(p):
        return 404, "text/plain", b"no such postmortem"
    with open(p, "rb") as f:
        return 200, "application/json", f.read()


class _Handler(BaseHTTPRequestHandler):
    server_version = "paddle-diag/1.0"
    protocol_version = "HTTP/1.1"

    def log_message(self, *args):  # no stderr chatter from scrapes
        pass

    def do_GET(self):  # noqa: N802 (stdlib naming)
        try:
            parts = urlsplit(self.path)
            code, ctype, body = _route(parts.path, parse_qs(parts.query))
        except Exception as e:
            # diagnostics must never add a second failure: a broken
            # endpoint answers 500 with the error, the process keeps going
            code, ctype = 500, "text/plain"
            body = f"diag error: {type(e).__name__}: {e}".encode()
        try:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        except (BrokenPipeError, ConnectionResetError):
            pass  # scraper went away mid-response


def start(port: Optional[int] = None,
          host: Optional[str] = None) -> Optional[str]:
    """Start the diagnostics server (idempotent). ``port``/``host`` default
    to FLAGS_diag_port / FLAGS_diag_host; a port of -1 (the flag default)
    means off and returns None. Returns the bound address "host:port"."""
    global _server, _thread, _started_at
    with _lock:
        if _server is not None:
            return address()
        if port is None:
            port = int(_flags.flag("diag_port"))
        if port < 0:
            return None
        host = host if host is not None else str(_flags.flag("diag_host"))
        srv = ThreadingHTTPServer((host, int(port)), _Handler)
        srv.daemon_threads = True
        # a 50 ms shutdown poll (the stdlib's is 500 ms): stop() returns fast
        t = threading.Thread(target=srv.serve_forever, kwargs={"poll_interval": 0.05},
                             daemon=True, name="paddle-diag")
        _server, _thread, _started_at = srv, t, time.time()
        t.start()
    addr = address()
    _trace.emit("diag", site="server", phase="start", address=addr)
    return addr


def stop() -> None:
    """Shut the server down (idempotent)."""
    global _server, _thread, _started_at
    with _lock:
        srv, _server = _server, None
        _thread, _started_at = None, None
    if srv is not None:
        try:
            srv.shutdown()
            srv.server_close()
        except Exception:
            pass


def started() -> bool:
    return _server is not None


def port() -> Optional[int]:
    srv = _server
    return None if srv is None else int(srv.server_address[1])


def address() -> Optional[str]:
    """The address a peer (the fleet aggregator) can reach this server at,
    or None when not running."""
    srv = _server
    if srv is None:
        return None
    host, prt = srv.server_address[0], srv.server_address[1]
    if host in ("0.0.0.0", "::", ""):
        host = "127.0.0.1"  # a wildcard bind answers on the loopback too
    return f"{host}:{prt}"
