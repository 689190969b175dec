"""Serving: an embedded HTTP front end with reply routing + replay.

The port's counterpart of the reference package's ``io/serving.py``
(Spark Serving v2, ref: HTTPSourceV2.scala ``WorkerServer``:475-696,
HTTPSinkV2.scala:55-150, ServingUDFs.scala:17-51). Ported: the single
front end — :class:`WorkerServer` with its handler (request ids, W3C
``traceparent``, deadlines, the 429/503/504 shed paths, the output
digest, the epoch commit/recover/replay contract, the health, metrics,
span, trace and ``/debug`` routes), :class:`HTTPSourceStateHolder`,
:class:`ContinuousServer` (collector, scorers and reply thread, each
supervised; coalescing, the deadline shed, transient retry and poison
bisection), ``POST /generate`` over a
:class:`~synapseml_tpu_torch.runtime.decode.DecodeScheduler` and the
container entry ``python -m synapseml_tpu_torch.io.serving`` (``--decode``
serves a share-buffer decoder graph), and Serving v1's layout
(ref: DistributedHTTPSource.scala): :class:`DistributedServer`, one
shared front end whose requests fan out over worker channels through a
depth-aware :class:`MultiChannelMap`, each channel with a circuit
breaker (trip, quarantine, redisperse), a one-shot failover of an
in-hand batch and a half-open probe that re-admits it, and
:func:`device_for_channel`. Not ported yet: incident capture, the trace
archive and the ``/debug/capture``, ``/debug/cost``, ``/debug/memory``
and ``/debug/profile`` routes (ROADMAP Queue 1 item 6) — those paths
answer as unknown routes do.

Architecture: an arriving request parks its connection on an event,
rides the micro-batch as a row, and the reply routed back through
:class:`HTTPSourceStateHolder` releases the connection — request ->
score -> reply without any polling. A :class:`ContinuousServer` drives
source -> pipeline -> sink on its own threads (the serving query). The
front end imports no torch: a pipeline that scores on the card (the
entry's :func:`_model_pipeline` over ``ONNXModel``) brings it in.
"""
from __future__ import annotations

import errno
import hashlib
import http.server
import json
import math
import os
import queue
import random
import re
import socket
import sys
import threading
import time
import uuid
import warnings
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from synapseml_tpu_torch.data.table import Table
from synapseml_tpu_torch.io.http import HTTPRequestData, HTTPResponseData
from synapseml_tpu_torch.runtime import blackbox as _bb
from synapseml_tpu_torch.runtime import faults as _flt
from synapseml_tpu_torch.runtime import slo as _slo
from synapseml_tpu_torch.runtime import structlog as _slog
from synapseml_tpu_torch.runtime import telemetry as _tm
from synapseml_tpu_torch.runtime.faults import PipelineBrokenError

_REGISTRY_LOCK = threading.Lock()

# client-supplied X-Request-Id acceptance: a well-formed external id
# becomes THE rid — span, logs, flight events, and the echoed reply
# header all carry the caller's own correlation key. Anything else
# (missing, oversized, exotic charset) falls back to a minted uuid;
# never reject a request over its id.
_RID_RE = re.compile(r"^[A-Za-z0-9._-]{1,128}$")

# flight-recorder slow-batch threshold: a pipeline_fn call slower than
# this lands a "slow_batch" event (with its rids) in the ring — the
# breadcrumb a latency incident is diagnosed from. 0 disables.
_SLOW_BATCH_S = float(os.environ.get("SYNAPSEML_SLOW_BATCH_MS",
                                     "1000")) / 1e3

# fault-injection points (runtime/faults.py) — resolved once at import;
# fire() is a single attribute test when no fault is armed. Unlike the
# executor's kill points (which fire with a unit in hand, because the
# supervision registry fails its futures), every serving thread_kill
# fires at the loop top BEFORE the blocking get: a dying serving thread
# must never take a request batch with it — there is no failure channel
# for an in-hand batch except the client's reply_timeout.
_F_REPLY = _flt.point("reply")
_F_LAT_SCORE = _flt.point("latency", "score")
# channel-scoped stall: fires inside EVERY channel's scoring path (the
# per-channel compute points are resolved lazily — channel counts are a
# runtime property, see DistributedServer._channel_point)
_F_LAT_STALL = _flt.point("latency", "channel_stall")
_F_KILL_SCORER = _flt.point("thread_kill", "scorer")
_F_KILL_REPLY = _flt.point("thread_kill", "reply")
_F_KILL_COLLECT = _flt.point("thread_kill", "collector")
_F_KILL_DIST = _flt.point("thread_kill", "distributor")


def _retry_rng(injected=None):
    """The PRNG behind transient-retry jitter. Injectable (``retry_rng=``)
    so tests control the draw; ``SYNAPSEML_RETRY_SEED`` seeds a private
    deterministic stream (retry-timing assertions stop depending on
    wall-clock luck); default is the shared module PRNG."""
    if injected is not None:
        return injected
    seed = os.environ.get("SYNAPSEML_RETRY_SEED")
    if seed:
        try:
            return random.Random(int(seed))
        except ValueError:
            pass  # malformed seed: fall through to the shared PRNG
    return random


def _drain_queue(q: "queue.Queue", max_rows: int,
                 timeout: float, linger: float = 0.0,
                 coalesce: float = 0.0) -> List["CachedRequest"]:
    """Deadline-bounded drain: block up to ``timeout`` for the first item,
    then keep collecting for up to ``linger`` seconds more (micro-batch
    coalescing — with concurrent clients a few ms of linger turns N serial
    device round trips into one batched trip; 0 preserves the
    take-what's-there behavior for latency-first pipelines).

    ``coalesce`` is the deadline-based variant: the collection window is
    anchored at the FIRST request's *arrival* time (stamped on enqueue),
    not at the moment the drain observes it — so concurrent low-QPS
    clients whose requests land within the window batch into one device
    round trip, while a request that already waited ``coalesce`` seconds
    (e.g. behind a busy scorer) pays zero additional delay. The two
    windows compose: the drain keeps collecting until the LATER of the
    linger and coalesce deadlines."""
    out: List[CachedRequest] = []
    deadline = time.monotonic() + timeout
    while len(out) < max_rows:
        if not out:
            remaining = deadline - time.monotonic()
        elif linger > 0 or coalesce > 0:
            # expired window clamps to a NON-blocking sweep, not a break:
            # under a backlog (head already older than the window) the
            # drain must still take everything instantly available, like
            # the windowless path — breaking at a singleton would make
            # the coalescing knob degrade batching exactly under load
            remaining = max(0.0, deadline - time.monotonic())
        else:
            remaining = 0.0
        try:
            out.append(q.get(timeout=max(0.0, remaining)))
        except queue.Empty:
            break
        if len(out) == 1:
            deadline = time.monotonic() + linger
            if coalesce > 0:
                arrival = getattr(out[0], "arrival", None)
                if arrival is not None:
                    deadline = max(deadline, arrival + coalesce)
    return out


def _drain_all(q: "queue.Queue") -> List["CachedRequest"]:
    """Non-blocking pop-until-empty — the shed/redisperse paths all
    take EVERYTHING off a queue before acting on it (acting while
    popping can chase concurrent re-puts forever)."""
    out: List[CachedRequest] = []
    while True:
        try:
            out.append(q.get_nowait())
        except queue.Empty:
            return out


def find_open_port(base: int = 12400, host: str = "127.0.0.1") -> int:
    """Ascending port search (ref: TrainUtils.findOpenPort:193-220).

    Inherently TOCTOU — the port is free when probed, not when the
    caller binds it. :class:`WorkerServer` therefore retries the bind
    itself on the next ports (``port_attempts``) instead of trusting a
    probe; keep this helper for non-HTTP uses (e.g. distributed
    coordinator ports) where the consumer cannot retry."""
    for port in range(base, base + 1000):
        with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
            try:
                s.bind((host, port))
                return port
            except OSError:
                continue
    raise OSError(f"no open port in [{base}, {base + 1000})")


def _supervise_loop(fn: Callable[[], Any], stop: threading.Event,
                    on_restart: Callable[[BaseException], None]):
    """The supervision boundary every serving-stage thread body runs
    under: an exception escaping ``fn`` (injected kill, bug) used to
    kill the thread silently — every subsequent request then parked
    until its reply_timeout. Instead ``on_restart`` records/counts the
    death and the loop RESTARTS ``fn``. Exits only when ``fn`` returns
    cleanly (stop requested) or the death raced ``stop``."""
    while True:
        try:
            fn()
            return
        except BaseException as e:  # noqa: BLE001 - supervision boundary
            if stop.is_set():
                return
            on_restart(e)
            # tiny pause: a persistent crash (e.g. prob-1.0 injected
            # kill) degrades to a slow restart loop, not a hot spin
            time.sleep(0.01)


_BUILD_STATIC: Optional[Dict[str, Any]] = None
_BUILD_LOCK = threading.Lock()


def _build_static() -> Dict[str, Any]:
    """The immutable half of the /debug/build payload, resolved once:
    git sha (``SYNAPSEML_GIT_SHA`` — the image build arg — else a
    best-effort ``git rev-parse`` over the source tree), python and the
    torch version via importlib.metadata (NO torch import: a torch-free
    front end answering /debug/build must stay torch-free)."""
    global _BUILD_STATIC
    if _BUILD_STATIC is not None:
        return _BUILD_STATIC
    # Resolve OUTSIDE the lock: the git subprocess can park the thread
    # for up to its 5s timeout, and the payload is deterministic per
    # process, so racing resolvers compute identical values — only
    # publication needs the lock.
    import platform
    import subprocess

    sha = os.environ.get("SYNAPSEML_GIT_SHA", "").strip()
    if not sha:
        try:
            root = os.path.dirname(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__))))
            sha = subprocess.run(
                ["git", "rev-parse", "HEAD"], cwd=root, timeout=5,
                capture_output=True, text=True).stdout.strip()
        except Exception:  # noqa: BLE001 - no git in the image
            sha = ""

    def _ver(dist: str) -> Optional[str]:
        try:
            from importlib import metadata

            return metadata.version(dist)
        except Exception:  # noqa: BLE001 - dist absent
            return None

    built = {
        "git_sha": sha or None,
        "python": platform.python_version(),
        "torch": _ver("torch"),
        "pid": os.getpid(),
    }
    with _BUILD_LOCK:
        if _BUILD_STATIC is None:
            _BUILD_STATIC = built
        return _BUILD_STATIC


def _build_info(server: "WorkerServer") -> Dict[str, Any]:
    """``GET /debug/build``: version-skew + lifecycle diagnosis for one
    replica — what a fleet operator diffs across pods. The CUDA version
    is read only where the process already imported torch, the backend
    and device name only where CUDA is already initialised: the
    endpoint itself never imports torch nor initialises the card."""
    info = dict(_build_static())
    cuda = device_kind = None
    backend = "uninitialized"
    torch = sys.modules.get("torch")
    if torch is not None:
        try:
            cuda = torch.version.cuda
            if torch.cuda.is_initialized():
                backend = "cuda"
                device_kind = torch.cuda.get_device_name(
                    torch.cuda.current_device())
        except Exception:  # noqa: BLE001 - introspection is best-effort
            pass
    info.update({
        "cuda": cuda,
        "backend": backend,
        "device_kind": device_kind,
        "server": server.name,
        "ready": server.ready,
        "draining": server.draining,
    })
    return info


class _PendingReply:
    __slots__ = ("event", "response")

    def __init__(self):
        self.event = threading.Event()
        self.response: Optional[HTTPResponseData] = None


class CachedRequest:
    """(ref: HTTPSourceV2.scala CachedRequest). ``arrival`` (monotonic
    enqueue time) anchors the deadline-based coalescing window and the
    span's ``queue_wait`` stage; ``span`` is the request's telemetry
    trace (a shared no-op when telemetry is disabled), ``drained`` the
    moment a drain took it off the queue (stamped in
    ``_record_epoch``).
    ``deadline`` is the absolute monotonic instant the client stops
    caring (``X-Deadline-Ms`` header or the server default; None = no
    deadline) — a request already past it at batch-form time is shed
    504 before any scoring work is wasted.
    ``trace_id``/``parent_span_id``/``span_id`` thread the request's
    W3C trace context (accepted from ``traceparent`` or minted at
    enqueue) into its span, so this server's leg stitches into the
    caller's distributed trace; ``origin`` names the server on the
    span for multi-leg disambiguation."""
    __slots__ = ("rid", "request", "epoch", "replied", "arrival", "span",
                 "drained", "deadline")

    def __init__(self, rid: str, request: HTTPRequestData,
                 deadline_ms: Optional[float] = None,
                 trace_id: Optional[str] = None,
                 parent_span_id: Optional[str] = None,
                 span_id: Optional[str] = None,
                 origin: str = ""):
        self.rid = rid
        self.request = request
        self.epoch: Optional[int] = None
        self.replied = False
        self.arrival = time.monotonic()
        self.span = _tm.start_span(rid, trace_id=trace_id,
                                   parent_span_id=parent_span_id,
                                   span_id=span_id, origin=origin)
        self.drained = 0.0
        self.deadline = (None if not deadline_ms
                         else self.arrival + deadline_ms / 1e3)


class WorkerServer:
    """One shard's embedded HTTP server
    (ref: HTTPSourceV2.scala WorkerServer:475-696).

    Requests park their connection until :meth:`reply_to` releases them;
    dequeued-but-uncommitted requests are kept in per-epoch history so a
    restarted shard can replay them (``historyQueues`` ->
    ``recoveredPartitions``, :488-505,608-613).
    """

    def __init__(self, name: str, host: str = "127.0.0.1",
                 port: Optional[int] = None, api_path: str = "/",
                 reply_timeout: float = 60.0, ready: bool = True,
                 default_deadline_ms: Optional[float] = None,
                 max_queue: Optional[int] = None,
                 port_attempts: int = 32,
                 retry_after_s: float = 1.0):
        """``default_deadline_ms``: per-request deadline applied when the
        client sends no ``X-Deadline-Ms`` header (None/0 = none).
        ``max_queue``: admission control — a request arriving while that
        many are already queued is shed 429 at enqueue instead of
        parking a connection it will likely time out on (None =
        unbounded). ``port_attempts``: how many successive ports to try
        when an explicit ``port`` is already bound — the bind itself
        retries, closing the probe-then-bind TOCTOU race two
        concurrently constructed servers used to crash on (read the
        actual port back from ``self.port``). ``retry_after_s``: the
        ``Retry-After`` hint every shed path (429/503/504) carries so
        load balancers and clients back off on a schedule instead of
        immediately re-hammering a saturated or draining replica."""
        self.name = name
        self.host = host
        self.default_deadline_ms = default_deadline_ms
        self.max_queue = max_queue
        self.retry_after_s = retry_after_s
        # decode mode (runtime/decode.py): when a DecodeScheduler is
        # attached here, POST /generate admits autoregressive sequences
        # instead of riding the scoring queue — see Handler._generate
        self.decode = None
        # readiness gate: /health answers 503 until set_ready(True) —
        # a k8s replica that is still AOT-warming its compile cache must
        # not receive traffic (the serving entry's --warmup flow)
        self._ready = threading.Event()
        if ready:
            self._ready.set()
        # graceful-drain gate: while draining, /health/ready answers 503
        # (the load balancer routes away) and NEW enqueues are refused
        # 503 + Retry-After — already-accepted requests keep scoring to
        # a real reply (the SIGTERM rolling-restart contract)
        self._draining = threading.Event()
        # port=0 lets the OS assign one race-free; the actual port is read
        # back from server_address after bind
        self.port = 0 if port is None else port
        self.api_path = api_path
        self.reply_timeout = reply_timeout
        self.requests: "queue.Queue[CachedRequest]" = queue.Queue()
        self.routing: Dict[str, _PendingReply] = {}
        self.history: Dict[int, List[CachedRequest]] = {}
        self.current_epoch = 0
        self._lock = threading.Lock()
        # telemetry handles, resolved once per server (docs/
        # observability.md catalogs the series); the queue-depth gauge
        # samples qsize() at scrape time — nothing on the request path
        self._m_requests = _tm.counter("serving_requests_total",
                                       server=name)
        self._m_batch_size = _tm.histogram(
            "serving_batch_size", buckets=_tm.SIZE_BUCKETS, server=name)
        self._m_queue_wait = _tm.histogram("serving_queue_wait_seconds",
                                           server=name)
        self._m_coalesce = _tm.histogram(
            "serving_coalesce_delay_seconds", server=name)
        self._m_roundtrip = _tm.histogram("serving_request_seconds",
                                          server=name)
        self._m_reply_timeout = _tm.counter("serving_reply_timeout_total",
                                            server=name)
        self._m_queue_shed = _tm.counter("serving_queue_shed_total",
                                         server=name)
        self._m_drain_shed = _tm.counter("serving_drain_shed_total",
                                         server=name)
        self._m_drain_s = _tm.histogram("serving_drain_seconds",
                                        server=name)
        self._m_replies: Dict[int, _tm.Counter] = {}
        _tm.gauge_fn("serving_queue_depth", self.requests.qsize,
                     server=name)
        # SLO accounting (runtime/slo.py; methodology in docs/
        # observability.md "SLO accounting"): scrape-time views over
        # the reply counters and roundtrip histogram this server
        # already feeds — nothing new on the request path. Targets are
        # env-configured once per server (the chart wires them); the
        # attributes stay writable for tests/embedding callers.
        self.slo_availability_target = float(os.environ.get(
            "SYNAPSEML_SLO_AVAILABILITY",
            str(_slo.DEFAULT_AVAILABILITY_TARGET)))
        self.slo_latency_target = float(os.environ.get(
            "SYNAPSEML_SLO_LATENCY_TARGET", "0.99"))
        self.slo_latency_threshold_s = float(os.environ.get(
            "SYNAPSEML_SLO_LATENCY_MS",
            str(_slo.DEFAULT_LATENCY_MS))) / 1e3
        _tm.gauge_fn("serving_slo_availability",
                     self._slo_availability, server=name)
        _tm.gauge_fn(
            "serving_slo_availability_burn_rate",
            lambda: _slo.burn_rate(self._slo_availability(),
                                   self.slo_availability_target),
            server=name)
        _tm.gauge_fn("serving_slo_latency_good_fraction",
                     self._slo_latency_good, server=name)
        _tm.gauge_fn(
            "serving_slo_latency_burn_rate",
            lambda: _slo.burn_rate(self._slo_latency_good(),
                                   self.slo_latency_target),
            server=name)
        _tm.gauge_fn("serving_slo_latency_threshold_ms",
                     lambda: self.slo_latency_threshold_s * 1e3,
                     server=name)
        outer = self

        class Handler(http.server.BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            # without these, headers and body leave as separate unbuffered
            # TCP segments and Nagle + delayed-ACK stalls every keep-alive
            # request ~40ms; buffered writes + TCP_NODELAY keep the reply
            # to one immediate segment (sub-millisecond round trips)
            disable_nagle_algorithm = True
            wbufsize = 64 * 1024

            def log_message(self, *a):  # quiet
                pass

            def _enqueue(self):
                length = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(length) if length else b""
                req = HTTPRequestData(
                    url=self.path, method=self.command,
                    headers=dict(self.headers.items()), entity=body)
                # client-supplied X-Request-Id becomes THE rid when
                # well-formed (validated + length-capped), so the
                # caller's own logs correlate with ours; otherwise mint.
                # Echoed on EVERY reply path — sheds included — below.
                client_rid = (self.headers.get("X-Request-Id")
                              or "").strip()
                rid = (client_rid if _RID_RE.match(client_rid)
                       else uuid.uuid4().hex)
                # W3C trace context: a well-formed traceparent is
                # ADOPTED (this server's span becomes one leg of the
                # caller's trace); anything else mints a fresh trace.
                # One regex fullmatch + two uuid4 draws — no lock, and
                # the echoed header names OUR span as the parent so
                # every reply path (sheds included) continues the
                # trace (docs/observability.md "Distributed tracing")
                parsed_tp = _tm.parse_traceparent(
                    self.headers.get("traceparent"))
                if parsed_tp is not None:
                    trace_id, parent_span_id = parsed_tp
                else:
                    trace_id, parent_span_id = _tm.mint_trace_id(), None
                span_id = _tm.mint_span_id()
                tp_echo = _tm.format_traceparent(trace_id, span_id)
                outer._m_requests.inc()
                if _slog.enabled("debug"):
                    _slog.log("debug", "request", rid=rid,
                              trace=trace_id,
                              server=outer.name, method=self.command,
                              path=self.path, bytes=length)
                retry_hdr = (("Retry-After", outer._retry_after_value()),
                             ("X-Request-Id", rid),
                             ("traceparent", tp_echo))
                if outer._draining.is_set():
                    # graceful drain: the replica is going away — refuse
                    # NEW work with an explicit 503 + Retry-After (the
                    # LB's cue to route elsewhere) while accepted
                    # requests keep scoring to a real reply
                    outer._m_drain_shed.inc()
                    outer._reply_counter(503).inc()
                    _bb.record("shed_drain", rid=rid, level="warn",
                               trace=trace_id, server=outer.name)
                    self._send_plain(503, b"draining", headers=retry_hdr)
                    return
                if (outer.decode is not None
                        and self.path.split("?", 1)[0].rstrip("/")
                        == "/generate"):
                    # decode mode: sequences go to the continuous-
                    # batching scheduler, not the scoring queue — its
                    # admission control (max_waiting) replaces the
                    # queue-depth shed below
                    self._generate(req, rid, trace_id, tp_echo, retry_hdr)
                    return
                if (outer.max_queue is not None
                        and outer.requests.qsize() >= outer.max_queue):
                    # admission control: shed at enqueue with 429 — a
                    # request this far over capacity would only park a
                    # connection it will likely 504 on anyway.
                    # Retry-After makes the client's backoff principled
                    # instead of an immediate re-hammer
                    outer._m_queue_shed.inc()
                    outer._reply_counter(429).inc()
                    _bb.record("shed_queue", rid=rid, level="warn",
                               trace=trace_id, server=outer.name,
                               depth=outer.requests.qsize())
                    self._send_plain(429, b"request queue full",
                                     headers=retry_hdr)
                    return
                deadline_ms = outer.default_deadline_ms
                hdr = self.headers.get("X-Deadline-Ms")
                if hdr:
                    try:
                        deadline_ms = float(hdr)
                    except ValueError:
                        pass  # malformed header: keep the server default
                pending = _PendingReply()
                with outer._lock:
                    collided = rid in outer.routing
                    if collided:
                        # a client reusing an id while its first request
                        # is still in flight must not hijack that
                        # request's reply slot: the second gets a minted
                        # id (still echoed back, so the caller sees the
                        # substitution)
                        requested_rid, rid = rid, uuid.uuid4().hex
                    outer.routing[rid] = pending
                if collided and _slog.enabled("debug"):
                    # keep the grep-by-rid trail intact both ways: the
                    # "request" line above carries the requested id,
                    # this one links it to the id the reply will carry
                    _slog.log("debug", "rid_substituted", rid=rid,
                              server=outer.name,
                              requested=requested_rid)
                cr = CachedRequest(rid, req, deadline_ms,
                                   trace_id=trace_id,
                                   parent_span_id=parent_span_id,
                                   span_id=span_id, origin=outer.name)
                outer.requests.put(cr)
                pending.event.wait(outer.reply_timeout)
                with outer._lock:
                    # claim-or-expire under the lock: if reply_to committed
                    # first, response is set (deliver it even at the timeout
                    # boundary); otherwise popping rid guarantees a late
                    # reply_to returns False and the request stays replayable
                    outer.routing.pop(rid, None)
                    resp = pending.response
                status = resp.status_code if resp is not None else 504
                outer._reply_counter(status).inc()
                dt = time.monotonic() - cr.arrival
                # output digest: sha256 over the exact reply bytes,
                # echoed as X-Output-Digest and stamped on the span —
                # the determinism fingerprint a client verifies
                # against a replay without storing the output.
                # Computed once per reply, before the headers leave.
                body = (resp.entity or b"") if resp is not None else b""
                if resp is not None:
                    digest = hashlib.sha256(body).hexdigest()
                    if cr.span.span_id:
                        # raw attribute write, so it must skip the
                        # shared _NOOP_SPAN (span_id "") telemetry
                        # hands out when disabled — stamping that
                        # singleton would smear one request's digest
                        # across every concurrent handler
                        cr.span.output_digest = digest
                else:
                    # a reply-timeout 504 sends no body and no digest
                    # header: stamping sha256(b"") would hand forensics
                    # a concrete-looking fingerprint for a reply that
                    # carried none
                    digest = ""
                # exemplar: this trace becomes the covering latency
                # bucket's link-out (last-write-wins slot assignment —
                # still no lock on the request path)
                outer._m_roundtrip.observe(dt, exemplar=trace_id)
                if _slog.enabled("debug"):
                    _slog.log("debug", "reply", rid=rid,
                              trace=trace_id,
                              server=outer.name, status=status,
                              seconds=round(dt, 6))
                try:
                    if resp is None:
                        # the wait expired with no response set: an
                        # explicit 504, never a silent empty wait-out
                        outer._m_reply_timeout.inc()
                        self.send_response(504)
                        # the id still goes back: a timed-out client
                        # can ask /span/<rid> where its request got
                        # stuck
                        self.send_header("X-Request-Id", rid)
                        self.send_header("traceparent", tp_echo)
                        self.send_header("Content-Length", "0")
                        self.end_headers()
                    else:
                        self.send_response(resp.status_code)
                        for k, v in resp.headers.items():
                            if k.lower() not in ("content-length",
                                                 "date", "server"):
                                self.send_header(k, v)
                        # rid correlates the reply with its trace span
                        # (the telemetry e2e test asserts this header
                        # matches the span record); traceparent hands
                        # the caller its continued trace context back;
                        # X-Output-Digest lets the caller assert
                        # determinism against a replay without either
                        # side storing the body
                        self.send_header("X-Request-Id", rid)
                        self.send_header("traceparent", tp_echo)
                        self.send_header("X-Output-Digest", digest)
                        self.send_header("Content-Length",
                                         str(len(body)))
                        self.end_headers()
                        self.wfile.write(body)
                finally:
                    # the reply bytes must be ON the socket before the
                    # handler returns: a process exiting mid-drain kills
                    # daemon handler threads, turning committed replies
                    # still in the wfile buffer into connection resets
                    try:
                        self.wfile.flush()
                    except OSError:
                        pass  # client hung up

            def _generate(self, req, rid, trace_id, tp_echo, retry_hdr):
                """POST /generate — decode-mode sequence admission.

                Body: ``{"tokens": [...], "max_new_tokens": N,
                "stream": bool}``. Non-streamed replies are one JSON
                body (``{"prompt_len", "tokens", "finish_reason"}``)
                with X-Output-Digest, the sha256 over the exact reply
                bytes. Streamed replies are chunked NDJSON: rid +
                traceparent ride the response headers (sent before the
                first token), one ``{"i", "t"}`` line per token as it
                decodes, and the final line carries ``finish_reason``
                plus ``digest`` — sha256 of the CANONICAL (non-streamed)
                reply body for the same result, so a streamed client can
                assert the same fingerprint a replay recomputes. A token
                outside the model's vocabulary, like any prompt the
                geometry cannot hold, is a 400."""
                t0 = time.monotonic()
                try:
                    payload = json.loads(req.entity or b"{}")
                    tokens = [int(t) for t in payload["tokens"]]
                    max_new = int(payload.get("max_new_tokens", 16))
                    stream = bool(payload.get("stream", False))
                except (ValueError, KeyError, TypeError) as e:
                    outer._reply_counter(400).inc()
                    self._send_plain(
                        400, f"bad decode request: {e!r}".encode(),
                        headers=retry_hdr[1:])
                    return
                deadline_ms = outer.default_deadline_ms
                hdr = self.headers.get("X-Deadline-Ms")
                if hdr:
                    try:
                        deadline_ms = float(hdr)
                    except ValueError:
                        pass
                try:
                    handle = outer.decode.submit(
                        tokens, max_new,
                        deadline_s=(deadline_ms / 1e3
                                    if deadline_ms else None))
                except ValueError as e:
                    outer._reply_counter(400).inc()
                    self._send_plain(400, repr(e).encode(),
                                     headers=retry_hdr[1:])
                    return
                except RuntimeError:
                    # admission queue full (or scheduler stopping):
                    # same shed contract as the scoring queue
                    outer._m_queue_shed.inc()
                    outer._reply_counter(429).inc()
                    _bb.record("shed_queue", rid=rid, level="warn",
                               trace=trace_id, server=outer.name,
                               path="/generate")
                    self._send_plain(429, b"decode queue full",
                                     headers=retry_hdr)
                    return

                def canonical_body(toks, reason):
                    return json.dumps(
                        {"prompt_len": len(tokens), "tokens": toks,
                         "finish_reason": reason}).encode()

                if not stream:
                    try:
                        toks, reason = handle.result(
                            timeout=outer.reply_timeout)
                    except TimeoutError:
                        outer._m_reply_timeout.inc()
                        outer._reply_counter(504).inc()
                        self._send_plain(504, b"", headers=retry_hdr)
                        return
                    except Exception as e:  # noqa: BLE001 - loop fault
                        outer._reply_counter(500).inc()
                        self._send_plain(500, repr(e).encode(),
                                         headers=retry_hdr[1:])
                        return
                    body = canonical_body(toks, reason)
                    digest = hashlib.sha256(body).hexdigest()
                    outer._reply_counter(200).inc()
                    outer._m_roundtrip.observe(time.monotonic() - t0,
                                               exemplar=trace_id)
                    self._send_plain(
                        200, body, content_type="application/json",
                        headers=(("X-Request-Id", rid),
                                 ("traceparent", tp_echo),
                                 ("X-Output-Digest", digest)))
                    return
                # streamed: headers (rid + traceparent) leave before
                # the first token; tokens flush per decode step so the
                # client's inter-token latency measures the scheduler,
                # not this buffer
                self.send_response(200)
                self.send_header("X-Request-Id", rid)
                self.send_header("traceparent", tp_echo)
                self.send_header("Content-Type", "application/x-ndjson")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()

                def chunk(b: bytes):
                    self.wfile.write(f"{len(b):x}\r\n".encode()
                                     + b + b"\r\n")

                toks = []
                status = 200
                try:
                    for tok in handle:
                        line = json.dumps(
                            {"i": len(toks), "t": tok}).encode()
                        toks.append(tok)
                        chunk(line + b"\n")
                        self.wfile.flush()
                    reason = handle.finish_reason or "completed"
                    digest = hashlib.sha256(
                        canonical_body(toks, reason)).hexdigest()
                    final = json.dumps(
                        {"done": True, "n": len(toks),
                         "finish_reason": reason,
                         "digest": digest}).encode()
                    chunk(final + b"\n")
                    chunk(b"")  # 0\r\n\r\n terminator
                    self.wfile.flush()
                except OSError:
                    # client hung up mid-stream: the scheduler-side
                    # finish already happened or will via deadline
                    status = 499
                except Exception as e:  # noqa: BLE001 - loop fault
                    # headers are gone — terminate the chunk stream
                    # with an error line instead of a silent cut
                    status = 500
                    try:
                        chunk(json.dumps(
                            {"done": True, "error": repr(e)}).encode()
                            + b"\n")
                        chunk(b"")
                        self.wfile.flush()
                    except OSError:
                        pass
                outer._reply_counter(status).inc()
                outer._m_roundtrip.observe(time.monotonic() - t0,
                                           exemplar=trace_id)

            def _send_plain(self, status: int, body: bytes,
                            content_type: str = "text/plain",
                            headers: Tuple[Tuple[str, str], ...] = ()):
                self.send_response(status)
                self.send_header("Content-Type", content_type)
                for k, v in headers:
                    self.send_header(k, v)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                # flush NOW, not at handler return: the wfile is a
                # 64KB buffer, and a draining process exits by killing
                # daemon handler threads — a 503 still buffered would
                # turn a clean shed into a client-visible connection
                # reset. OSError-tolerant: the client may have hung up
                try:
                    self.wfile.flush()
                except OSError:
                    pass

            def do_GET(self):
                if self.path == "/health/live":
                    # liveness: the PROCESS is up and its accept loop
                    # answers — true throughout warmup AND drain, so k8s
                    # never kills a replica that is merely warming or
                    # gracefully draining (that is readiness's job)
                    self._send_plain(200, b"alive")
                    return
                if self.path in ("/health", "/health/ready"):
                    # readiness fast-path: never rides the pipeline.
                    # 503 while warming keeps the load balancer away
                    # from a replica that would park requests on a
                    # compiling (or not-yet-started) scoring query; 503
                    # while DRAINING routes rollouts away before the
                    # replica exits. /health stays an alias for ready —
                    # existing probes keep their semantics.
                    if outer._draining.is_set():
                        self._send_plain(
                            503, b"draining",
                            headers=(("Retry-After",
                                      outer._retry_after_value()),))
                    elif outer._ready.is_set():
                        self._send_plain(200, b"ok")
                    else:
                        self._send_plain(503, b"warming")
                    return
                if self.path == "/metrics":
                    # Prometheus scrape surface: the whole process-wide
                    # registry (executor + serving + compile cache), off
                    # the scoring pipeline entirely. OpenMetrics (with
                    # histogram exemplars linking latency buckets to
                    # trace ids) is negotiated on the Accept header or
                    # forced by SYNAPSEML_OPENMETRICS=1; the default
                    # 0.0.4 exposition never carries an exemplar, so
                    # strict format-0.0.4 parsers are unaffected
                    om = ("application/openmetrics-text"
                          in (self.headers.get("Accept") or "")
                          or os.environ.get("SYNAPSEML_OPENMETRICS",
                                            "") == "1")
                    self._send_plain(
                        200,
                        _tm.prometheus_text(
                            openmetrics=om).encode("utf-8"),
                        ("application/openmetrics-text; version=1.0.0; "
                         "charset=utf-8") if om else
                        "text/plain; version=0.0.4; charset=utf-8")
                    return
                if (self.path.startswith("/debug/")
                        and os.environ.get("SYNAPSEML_DEBUG_ENDPOINTS",
                                           "") == "0"):
                    # locked-down deployments: thread stacks + event
                    # history are internals no unauthenticated client
                    # should read — one switch gates the whole /debug
                    # surface
                    self._send_plain(403, b"debug endpoints disabled")
                    return
                if self.path == "/debug/flight":
                    # live flight-recorder snapshot: ring events +
                    # telemetry + per-thread stacks — what a dump file
                    # contains, without waiting for a trigger
                    self._send_plain(
                        200,
                        json.dumps(_bb.snapshot(),
                                   default=repr).encode("utf-8"),
                        "application/json")
                    return
                if self.path == "/debug/threads":
                    # every live thread's current stack (pipeline/
                    # scorer/probe supervision forensics)
                    self._send_plain(
                        200,
                        json.dumps(_bb.thread_stacks()).encode("utf-8"),
                        "application/json")
                    return
                if self.path == "/debug/build":
                    # fleet version-skew diagnosis: git sha + torch/
                    # CUDA/backend + device kind + lifecycle state,
                    # per replica (docs/observability.md "Debug
                    # endpoints"; behind the SYNAPSEML_DEBUG_ENDPOINTS
                    # gate above like the whole /debug surface)
                    self._send_plain(
                        200,
                        json.dumps(_build_info(outer)).encode("utf-8"),
                        "application/json")
                    return
                if self.path.startswith("/span/"):
                    span = _tm.get_span(self.path[len("/span/"):])
                    if span is None:
                        self._send_plain(404, b"no such span")
                        return
                    self._send_plain(
                        200, json.dumps(span.breakdown()).encode("utf-8"),
                        "application/json")
                    return
                if self.path.startswith("/trace/"):
                    # this replica's legs of one distributed trace —
                    # what the controller's /fleet/trace fans out to.
                    # Span storage is process-wide, so every leg any
                    # server in this process created comes back, each
                    # labeled with its origin server
                    tid = self.path[len("/trace/"):].strip("/").lower()
                    if not re.fullmatch(r"[0-9a-f]{32}", tid):
                        self._send_plain(400, b"trace id must be 32 "
                                              b"lowercase hex chars")
                        return
                    legs = _tm.trace_spans(tid)
                    if not legs:
                        self._send_plain(404, b"no spans for trace")
                        return
                    self._send_plain(
                        200,
                        json.dumps({"trace_id": tid,
                                    "server": outer.name,
                                    "pid": os.getpid(),
                                    "legs": legs}).encode("utf-8"),
                        "application/json")
                    return
                self._enqueue()

            do_POST = _enqueue
            do_PUT = _enqueue

        class Server(http.server.ThreadingHTTPServer):
            # default backlog (5) resets connections under concurrent
            # client bursts — the whole point of micro-batch serving
            request_queue_size = 128

        # bind-with-next-port retry: an explicit port may have been
        # probed free (find_open_port) and grabbed since — the TOCTOU
        # window closes by retrying the BIND, not re-probing. port=0
        # stays single-shot (the OS assigns race-free).
        last_err: Optional[OSError] = None
        for attempt in range(max(1, port_attempts) if self.port else 1):
            try:
                self._httpd = Server((host, self.port + attempt), Handler)
                last_err = None
                break
            except OSError as e:
                if e.errno != errno.EADDRINUSE:
                    # only in-use is the TOCTOU race; EACCES/
                    # EADDRNOTAVAIL etc. would either silently serve a
                    # port nobody is pointing at or retry futilely
                    raise
                last_err = e
        if last_err is not None:
            raise last_err
        if self.port and self._httpd.server_address[1] != self.port:
            # drift must be LOUD: a fixed-port deployment (k8s Service
            # targetPort, a peer holding a pre-advertised probe result)
            # routes to the REQUESTED port — only callers that read
            # server.port back can follow the retry
            warnings.warn(
                f"WorkerServer {name!r}: requested port {self.port} in "
                f"use; bound {self._httpd.server_address[1]} instead — "
                "fixed-port consumers must read server.port back",
                RuntimeWarning, stacklevel=2)
        self.port = self._httpd.server_address[1]
        self._httpd.daemon_threads = True
        # socketserver owns this loop's fault handling: per-request
        # errors route to handle_error, and serve_forever only exits via
        # stop()'s shutdown()
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name=f"serving-{name}",
            daemon=True)
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}{self.api_path}"

    @property
    def ready(self) -> bool:
        return self._ready.is_set()

    def set_ready(self, ready: bool = True):
        """Flip the /health readiness gate (the serving entry calls this
        after AOT warmup completes)."""
        if ready:
            self._ready.set()
        else:
            self._ready.clear()

    @property
    def draining(self) -> bool:
        return self._draining.is_set()

    def begin_drain(self):
        """Flip the graceful-drain gate: /health/ready (and /health)
        answer 503 so the load balancer routes away, and NEW enqueues
        are refused 503 + Retry-After — while every already-accepted
        request keeps scoring to a real reply. The SIGTERM half of the
        k8s rolling-restart contract (ContinuousServer.drain drives the
        wait-then-stop half)."""
        if not self._draining.is_set():
            _bb.record("drain_begin", server=self.name)
        self._draining.set()

    def wait_drained(self, timeout: float) -> bool:
        """Block until every ACCEPTED request has a terminal reply —
        the queue is empty and no connection is parked in the routing
        table — or ``timeout`` elapses. Call after :meth:`begin_drain`
        (otherwise new arrivals can keep this from ever converging).
        Returns True when fully drained."""
        deadline = time.monotonic() + max(0.0, timeout)
        while True:
            with self._lock:
                empty = not self.routing
            if empty and self.requests.qsize() == 0:
                return True
            if time.monotonic() >= deadline:
                return False
            time.sleep(0.01)

    def drain(self, timeout_ms: float = 5000.0) -> bool:
        """Graceful drain, one call (the SIGTERM half of a k8s rolling
        restart — the chart's preStop + terminationGracePeriodSeconds
        budget this window): flip the drain gate (new enqueues 503 +
        Retry-After, /health/ready goes 503 so the LB routes away),
        then wait up to ``timeout_ms`` for every accepted request to
        reach a terminal reply. Observes ``serving_drain_seconds``;
        returns True when nothing in flight remained. Both serving
        front-ends (:meth:`ContinuousServer.drain` and
        :meth:`DistributedServer.drain`) delegate here — parked
        connections live in THIS routing table until replied, whatever
        queue their requests ride. Call the front-end's ``stop`` after:
        anything still queued past the deadline gets an explicit 503
        there, never a silent drop."""
        t0 = time.monotonic()
        self.begin_drain()
        drained = self.wait_drained(timeout_ms / 1e3)
        dt = time.monotonic() - t0
        self._m_drain_s.observe(dt)
        _bb.record("drain_end", server=self.name, drained=drained,
                   seconds=round(dt, 6))
        return drained

    def _slo_availability(self) -> float:
        """Good-reply fraction over every terminal reply this server
        committed (5xx = bad; see runtime/slo.py for the policy)."""
        return _slo.availability(
            {code: c.value for code, c in list(self._m_replies.items())})

    def _slo_latency_good(self) -> float:
        """Fraction of roundtrips at or under the latency threshold,
        estimated from the roundtrip histogram's buckets."""
        counts, _total, _n = self._m_roundtrip._aggregate()
        return _slo.fraction_le(self._m_roundtrip.bounds, counts,
                                self.slo_latency_threshold_s)

    def _retry_after_value(self) -> str:
        """``Retry-After`` is integer seconds (RFC 9110): round the
        configured hint UP so a sub-second hint never renders as 0
        (= retry immediately, the exact re-hammer the header exists to
        prevent)."""
        return str(max(1, math.ceil(self.retry_after_s)))

    def _reply_counter(self, status: int) -> "_tm.Counter":
        """Per-status reply counter, registered on first use."""
        c = self._m_replies.get(status)
        if c is None:
            c = self._m_replies.setdefault(status, _tm.counter(
                "serving_replies_total", server=self.name,
                code=str(status)))
        return c

    # -- source side ----------------------------------------------------
    def get_batch(self, max_rows: int = 64, timeout: float = 0.1,
                  linger: float = 0.0,
                  coalesce: float = 0.0) -> List[CachedRequest]:
        """Drain up to ``max_rows`` requests as one epoch's batch.
        ``coalesce`` holds the batch open until the first request is
        that many seconds old (deadline-based coalescing window — see
        :func:`_drain_queue`)."""
        out = _drain_queue(self.requests, max_rows, timeout, linger,
                           coalesce)
        self._record_epoch(out)
        return out

    def _record_epoch(self, out: List[CachedRequest]):
        """Stamp a batch with an epoch and park it in replay history —
        every consumption path (direct or via DistributedServer channels)
        must pass through here or recover() cannot replay it. Also the
        single choke point where batch-size / queue-wait / coalesce-delay
        telemetry gets recorded (outside the lock)."""
        if out:
            now = time.monotonic()
            self._m_batch_size.observe(len(out))
            # coalesce delay: how long the batch's HEAD request waited
            # from arrival to being drained — the price the coalescing
            # window charged (0 linger/coalesce => just scheduling lag)
            self._m_coalesce.observe(now - out[0].arrival)
            for cr in out:
                wait = now - cr.arrival
                cr.drained = now
                self._m_queue_wait.observe(wait)
                cr.span.note("queue_wait", wait)
            with self._lock:
                epoch = self.current_epoch
                self.current_epoch += 1
                for cr in out:
                    cr.epoch = epoch
                self.history[epoch] = list(out)

    def commit(self, epoch: int, exact: bool = False):
        """Prune replay history through ``epoch`` (ref: commit :555-567).

        ``exact=True`` prunes ONLY that epoch — required when epochs
        complete out of order (concurrent scoring workers): a cumulative
        commit of a later epoch would silently drop an earlier,
        still-in-flight epoch's replay history."""
        with self._lock:
            if exact:
                self.history.pop(epoch, None)
                return
            for e in [e for e in self.history if e <= epoch]:
                del self.history[e]

    def recover(self):
        """Re-enqueue uncommitted, unreplied requests (task-retry replay,
        ref: HTTPSourceV2.scala:488-505 recoveredPartitions)."""
        with self._lock:
            pending = [
                cr for ep in sorted(self.history)
                for cr in self.history[ep] if not cr.replied
            ]
            self.history.clear()
        for cr in pending:
            self.requests.put(cr)
        return len(pending)

    # -- sink side ------------------------------------------------------
    def reply_to(self, rid: str, response: HTTPResponseData) -> bool:
        """(ref: WorkerServer.replyTo via HTTPSourceStateHolder :535-553).

        Returns True only when a waiter will actually consume the response;
        an already-expired request is left unreplied so :meth:`recover`
        replays it."""
        with self._lock:
            pending = self.routing.pop(rid, None)
            if pending is None:
                return False
            pending.response = response
            for ep_items in self.history.values():
                for cr in ep_items:
                    if cr.rid == rid:
                        cr.replied = True
        pending.event.set()
        return True

    def fail_queued(self, status: int = 503,
                    reason: str = "server stopping",
                    q: Optional["queue.Queue"] = None) -> int:
        """Reply ``status`` to every request still parked on ``q``
        (default: this server's intake queue; DistributedServer passes
        its channel queues) — the explicit-shed half of shutdown/drain.
        Counted in ``serving_drain_shed_total``; carries Retry-After so
        clients back off before re-trying the replacement replica.
        Returns how many were failed."""
        hdrs = {"Retry-After": self._retry_after_value()}
        shed = _drain_all(self.requests if q is None else q)
        for cr in shed:
            self._m_drain_shed.inc()
            self.reply_to(cr.rid, HTTPResponseData(
                status_code=status, reason=reason, headers=hdrs))
            cr.span.finish("shed")
        if shed:
            _bb.record("shed_stop", level="warn", server=self.name,
                       status=status, n=len(shed),
                       rids=[cr.rid for cr in shed[:8]],
                       trace_ids=[cr.span.trace_id for cr in shed[:8]])
        return len(shed)

    def stop(self):
        # unhook the scrape-time samplers first: a scrape racing the
        # shutdown must read 0, not call into a closed server
        _tm.unregister("serving_queue_depth", server=self.name)
        for slo_series in ("serving_slo_availability",
                           "serving_slo_availability_burn_rate",
                           "serving_slo_latency_good_fraction",
                           "serving_slo_latency_burn_rate",
                           "serving_slo_latency_threshold_ms"):
            _tm.unregister(slo_series, server=self.name)
        _slog.log("info", "server_stop", server=self.name)
        # queued-but-unconsumed requests get an explicit 503 + Retry-
        # After instead of a silent drop that parks their clients until
        # reply_timeout (their handler threads still hold live
        # connection sockets; only the accept loop closes below).
        # Gate first: a handler racing this shed would otherwise pass
        # the drain check and re-park on the just-emptied queue with no
        # consumer left — then shed again after the accept loop stops,
        # for handlers that were already past the gate check.
        self._draining.set()
        self.fail_queued()
        self._httpd.shutdown()
        self.fail_queued()
        self._httpd.server_close()


class HTTPSourceStateHolder:
    """Process-wide registry name -> WorkerServer
    (ref: HTTPSourceV2.scala HTTPSourceStateHolder:337)."""

    _servers: Dict[str, WorkerServer] = {}

    @classmethod
    def get_or_create_server(cls, name: str, host: str = "127.0.0.1",
                             port: Optional[int] = None,
                             **kw) -> WorkerServer:
        with _REGISTRY_LOCK:
            srv = cls._servers.get(name)
            if srv is None:
                srv = WorkerServer(name, host, port, **kw)
                cls._servers[name] = srv
            return srv

    @classmethod
    def get_server(cls, name: str) -> WorkerServer:
        return cls._servers[name]

    @classmethod
    def remove(cls, name: str):
        with _REGISTRY_LOCK:
            srv = cls._servers.pop(name, None)
        if srv is not None:
            srv.stop()


class MultiChannelMap:
    """Depth-aware request distribution across N consumer channels
    (ref: DistributedHTTPSource.scala MultiChannelMap:27-80 — adds rotate
    through channel lists; updateNLists disperses orphaned channels on
    elastic resize).

    Placement is least-loaded-first among ENABLED channels (rotation
    order breaks ties, so an idle map degrades to exact round-robin):
    a channel whose consumer backs up sheds new load to its siblings
    instead of accumulating it — the queue-depth half of the channel
    circuit breakers. ``set_channel_enabled(i, False)`` quarantines a
    channel (breaker OPEN): placement never picks it while any enabled
    channel exists, and its parked requests re-disperse immediately.
    When EVERY channel is disabled, placement degrades to least-loaded
    over all of them — availability over purity; the half-open probes
    re-admit channels as they heal.

    All channel-list access stays under the lock (queue puts included —
    they never block, so holding the lock is safe): a put outside it
    could land on a channel a concurrent shrink already drained, losing
    the request."""

    def __init__(self, n_channels: int):
        self._lock = threading.Lock()
        self._channels: List["queue.Queue[CachedRequest]"] = [
            queue.Queue() for _ in range(max(1, n_channels))
        ]
        self._add_index = 0
        self._disabled: set = set()

    @property
    def n_channels(self) -> int:
        with self._lock:
            return len(self._channels)

    def depths(self) -> List[int]:
        """Current queue depth per channel (one consistent snapshot)."""
        with self._lock:
            return [q.qsize() for q in self._channels]

    def enabled_channels(self) -> List[int]:
        """Indices placement may currently target (breaker CLOSED)."""
        with self._lock:
            return [i for i in range(len(self._channels))
                    if i not in self._disabled]

    def _place(self, item: CachedRequest):
        """Least-loaded enabled channel, rotation-order tiebreak —
        caller holds the lock. With no consumers draining, depths grow
        uniformly and this IS round-robin; under skewed drain rates the
        deepest channel stops receiving."""
        n = len(self._channels)
        candidates = [i for i in range(n) if i not in self._disabled] \
            or list(range(n))
        start = self._add_index
        best = min(candidates,
                   key=lambda i: (self._channels[i].qsize(),
                                  (i - start) % n))
        self._add_index = (best + 1) % n
        self._channels[best].put(item)

    def add(self, item: CachedRequest):
        with self._lock:
            self._place(item)

    def channel(self, i: int) -> "queue.Queue[CachedRequest]":
        """Current queue for channel ``i`` (clamped: a concurrent shrink
        must degrade to serving a live channel, not IndexError)."""
        with self._lock:
            return self._channels[i % len(self._channels)]

    def set_channel_enabled(self, i: int, enabled: bool) -> int:
        """Quarantine (``False``) or re-admit (``True``) channel ``i``.
        Quarantining re-disperses its parked requests onto enabled
        channels — a request must never sit on a queue no healthy
        consumer drains. Returns how many requests moved. The breaker
        calls this under its own lock (breaker -> map, one way: the map
        never calls back into the breaker)."""
        with self._lock:
            if not 0 <= i < len(self._channels):
                return 0
            if enabled:
                self._disabled.discard(i)
                return 0
            self._disabled.add(i)
            # drain FULLY before re-placing: when every channel is
            # disabled _place's availability fallback may legitimately
            # pick this channel again
            orphaned = _drain_all(self._channels[i])
            for item in orphaned:
                self._place(item)
        if orphaned:
            # the flight-recorder breadcrumb a trip forensic needs:
            # WHICH requests moved off the quarantined channel (rids
            # capped — counts tell the scale, ids tell the story)
            _bb.record("redisperse", channel=i, level="warn",
                       n=len(orphaned),
                       rids=[cr.rid for cr in orphaned[:8]])
        return len(orphaned)

    def update_n_channels(self, n: int):
        """Resize; requests parked on removed channels are re-dispersed
        (ref: updateNLists:39-52). Quarantine state for surviving
        indices is preserved; removed indices forget theirs."""
        n = max(1, n)
        with self._lock:
            orphaned: List[CachedRequest] = []
            while len(self._channels) > n:
                dead = self._channels.pop()
                self._disabled.discard(len(self._channels))
                orphaned.extend(_drain_all(dead))
            while len(self._channels) < n:
                self._channels.append(queue.Queue())
            self._add_index %= len(self._channels)
            for item in orphaned:
                self._place(item)


def device_for_channel(channel: int, devices=None):
    """Round-robin map of a serving channel index onto a local device.

    Shard i of a :class:`DistributedServer` scores on
    ``device_for_channel(i)``, so with several cards concurrent channels
    use distinct ones (ref: one ONNX Runtime instance a Spark partition,
    ONNXModel.scala:497-508). ``devices`` defaults to every
    visible CUDA device, as ``torch.device("cuda", i)``; without CUDA and
    without ``devices`` it raises — it never falls back to the CPU (pass
    ``devices=[torch.device("cpu")]`` to map channels onto the CPU).
    torch is imported here, so the front end stays importable without it.

    On one card every channel maps to ``cuda:0``: the channels are
    scorer threads sharing the device. A channel's failover then re-runs
    the same work on the same card — it masks a host-side fault of the
    channel's scoring path (an exception in its thread), not a device
    fault. A sticky CUDA error (a device-side assert) poisons the
    process's CUDA context for every channel; no failover can hide it."""
    import torch

    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device_for_channel: no CUDA device is available and no "
                "devices were given; pass devices=[torch.device('cpu')] "
                "to map channels onto the CPU")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if not devices:
        raise ValueError("device_for_channel: devices is empty")
    return devices[channel % len(devices)]


# circuit-breaker states, exported on the
# serving_channel_breaker_state{channel=} gauge. CLOSED = traffic flows
# (electrical convention: the circuit conducts); OPEN = quarantined;
# HALF_OPEN = a canary probe is in flight.
BREAKER_CLOSED, BREAKER_OPEN, BREAKER_HALF_OPEN = 0, 1, 2
_BREAKER_STATE_NAMES = {BREAKER_CLOSED: "closed", BREAKER_OPEN: "open",
                        BREAKER_HALF_OPEN: "half_open"}


class DistributedServer:
    """Serving v1 analogue: ONE shared HTTP server per host whose
    requests distribute across worker channels
    (ref: DistributedHTTPSource.scala JVMSharedServer:90 shared via
    SharedSingleton :384, MultiChannelMap :27, DistributedHTTPSink:364).
    Each shard drains its own channel with ``get_batch(channel=i)`` and
    replies through the shared server — or :meth:`serve` runs the
    per-channel scoring loops in-process.

    The CHANNEL is the unit of fault tolerance: each channel carries a
    circuit breaker. ``breaker_threshold`` consecutive scoring failures —
    or a score stalled past ``stall_timeout`` — trip it OPEN: the channel
    is quarantined, its parked requests re-disperse onto healthy
    channels, and new placement avoids it. A background probe then
    flips it HALF_OPEN, re-scores a canary under the channel's own
    fault points, and re-admits (CLOSED) on success. An in-hand batch
    whose channel breaks mid-score fails over ONCE to a healthy channel
    (:meth:`score_on_channel`) before any client-visible error —
    bit-identically, since the failover re-runs the same scoring fn
    (on one card, on the same device: :func:`device_for_channel`)."""

    def __init__(self, name: str, n_channels: int,
                 host: str = "127.0.0.1", port: Optional[int] = None,
                 reply_timeout: float = 60.0,
                 breaker_threshold: int = 3,
                 probe_interval: float = 0.25,
                 stall_timeout: Optional[float] = None,
                 canary_fn: Optional[Callable[[int], Any]] = None):
        """``breaker_threshold``: consecutive failures that trip a
        channel OPEN (1 = first failure quarantines). ``probe_interval``
        seconds between half-open canary probes of OPEN channels.
        ``stall_timeout``: a score wall-time past this counts as a
        breaker failure even though its result still returns (the
        slow-channel trip condition; None = off). ``canary_fn(ch)``:
        extra health work the half-open probe runs on the quarantined
        channel (e.g. re-score a pinned canary batch on its device);
        when None, :meth:`serve` wires a default that re-scores the
        first successfully scored row through the real pipeline. The
        probe always fires the channel's fault points, so injected
        chaos alone round-trips OPEN -> HALF_OPEN -> CLOSED."""
        self.server = HTTPSourceStateHolder.get_or_create_server(
            name, host, port, reply_timeout=reply_timeout)
        # exactly one distributor may own a server's request queue: a
        # second consumer would silently steal an arbitrary subset.
        # check-and-claim happens atomically under the server's lock, so
        # two concurrent constructors cannot both pass the check
        with self.server._lock:
            if getattr(self.server, "_dist_owner", None) is not None:
                raise ValueError(
                    f"server {name!r} already has a DistributedServer "
                    f"attached; reuse that instance or pick another name")
            self.server._dist_owner = self
        self.channels = MultiChannelMap(n_channels)
        self.breaker_threshold = max(1, int(breaker_threshold))
        self.probe_interval = float(probe_interval)
        self.stall_timeout = stall_timeout
        self.canary_fn = canary_fn
        # breaker state: guarded by its own lock. Lock order is
        # breaker -> map, ONE direction — state flips and their matching
        # map enable/disable happen together under the breaker lock
        # (map calls never block: queue puts only), so a channel can
        # never be breaker-OPEN yet placement-enabled, which would park
        # requests on a queue whose consumer loop is idling
        self._breaker_lock = threading.Lock()
        self._breaker_state: Dict[int, int] = {}
        self._breaker_fails: Dict[int, int] = {}
        # one-row snapshot of the first successfully scored input:
        # serve()'s default canary re-scores it through the REAL
        # pipeline so the half-open probe proves the channel scores, not
        # just that a no-op returns (benign last-write-wins race between
        # channel loops: every candidate snapshot is known-good)
        self._canary_table: Optional[Table] = None
        self._channel_points: Dict[int, "_flt.FaultPoint"] = {}
        self._m_failover = _tm.counter("serving_failover_total",
                                       server=name)
        self._m_redispersed = _tm.counter("serving_redispersed_total",
                                          server=name)
        self._m_trips = _tm.counter("serving_channel_trips_total",
                                    server=name)
        self._probe_thread: Optional[threading.Thread] = None
        self._probe_wake = threading.Event()
        self._serve_threads: List[threading.Thread] = []
        self._n_channel_gauges = 0
        self._sync_channel_gauges()
        self._stop = threading.Event()
        self._m_dist_restarts = _tm.counter(
            "serving_thread_restarts_total", server=name,
            thread="distributor")
        self._distributor = threading.Thread(
            target=self._distribute_supervised, name=f"dist-{name}",
            daemon=True)
        self._distributor.start()

    def _sync_channel_gauges(self):
        """One scrape-time depth sampler + breaker-state gauge per live
        channel (re-synced on elastic resize; samplers beyond the new
        count are dropped)."""
        n = self.channels.n_channels
        for i in range(n):
            _tm.gauge_fn(
                "serving_channel_depth",
                lambda ch=i: self.channels.channel(ch).qsize(),
                server=self.server.name, channel=str(i))
            _tm.gauge_fn(
                "serving_channel_breaker_state",
                lambda ch=i: self.channel_state(ch),
                server=self.server.name, channel=str(i))
        for i in range(n, self._n_channel_gauges):
            _tm.unregister("serving_channel_depth",
                           server=self.server.name, channel=str(i))
            _tm.unregister("serving_channel_breaker_state",
                           server=self.server.name, channel=str(i))
        self._n_channel_gauges = n

    @property
    def url(self) -> str:
        return self.server.url

    # -- channel circuit breakers ---------------------------------------

    def channel_state(self, channel: int) -> int:
        """BREAKER_CLOSED / BREAKER_OPEN / BREAKER_HALF_OPEN."""
        with self._breaker_lock:
            return self._breaker_state.get(channel, BREAKER_CLOSED)

    def _set_state_locked(self, channel: int, state: int):
        # caller holds _breaker_lock. Transitions are COUNTED (not just
        # gauged): a probe's OPEN->HALF_OPEN->OPEN bounce is faster than
        # any scrape interval, so the chaos check asserts the counter,
        # the dashboards plot the gauge.
        prev = self._breaker_state.get(channel, BREAKER_CLOSED)
        if prev == state:
            return
        self._breaker_state[channel] = state
        _tm.counter("serving_breaker_transitions_total",
                    server=self.server.name, channel=str(channel),
                    state=_BREAKER_STATE_NAMES[state]).inc()
        # ring + log breadcrumb (blackbox.record takes only its own leaf
        # lock): every state entry, including the OPEN->HALF_OPEN->OPEN
        # probe bounces no scrape ever sees
        _bb.record("breaker_transition", channel=channel,
                   level="warn" if state != BREAKER_CLOSED else "info",
                   server=self.server.name,
                   state=_BREAKER_STATE_NAMES[state],
                   prev=_BREAKER_STATE_NAMES[prev])

    def _channel_point(self, channel: int) -> "_flt.FaultPoint":
        """The channel's ``compute.channel<N>`` fault point, resolved
        lazily — channel counts are a runtime property, unlike the
        import-time module points."""
        p = self._channel_points.get(channel)
        if p is None:
            p = self._channel_points.setdefault(
                channel, _flt.point("compute", f"channel{channel}"))
        return p

    def _record_channel_success(self, channel: int):
        with self._breaker_lock:
            self._breaker_fails[channel] = 0
            if self._breaker_state.get(channel,
                                       BREAKER_CLOSED) != BREAKER_CLOSED:
                # state flip + map re-enable are ATOMIC under the
                # breaker lock: a racing trip on another thread cannot
                # interleave its disable between them and leave the
                # channel OPEN-but-enabled (a request black hole)
                self._set_state_locked(channel, BREAKER_CLOSED)
                self.channels.set_channel_enabled(channel, True)

    def _record_channel_failure(self, channel: int) -> bool:
        """Count one failure against the channel; returns True when it
        tripped the breaker just now (quarantine + redisperse done)."""
        with self._breaker_lock:
            if self._breaker_state.get(channel,
                                       BREAKER_CLOSED) == BREAKER_OPEN:
                return False
            fails = self._breaker_fails.get(channel, 0) + 1
            self._breaker_fails[channel] = fails
            if fails < self.breaker_threshold:
                return False
            self._set_state_locked(channel, BREAKER_OPEN)
            # quarantine atomically with the state flip (breaker -> map
            # order): re-disperse what was parked on the channel
            moved = self.channels.set_channel_enabled(channel, False)
        if moved:
            self._m_redispersed.inc(moved)
        self._m_trips.inc()
        # the incident trigger: the trip event lands in the ring, then
        # the recorder dumps ring + gauges + thread stacks to the dump
        # dir (debounced) — the forensic file to pull first. Runs with
        # no locks held.
        _bb.trigger("breaker_trip", channel=channel,
                    server=self.server.name, fails=fails,
                    redispersed=moved)
        self._ensure_probe_thread()
        self._probe_wake.set()
        return True

    def _channel_score(self, channel: int, score_fn: Callable[[], Any]):
        """Run one unit of scoring work AS channel ``channel``: fires
        the shared stall point and the channel's own compute point
        first, so injected channel faults land exactly here."""
        _F_LAT_STALL.fire()
        self._channel_point(channel).fire()
        return score_fn()

    def _failover_target(self, exclude: int) -> Optional[int]:
        """Least-loaded healthy channel other than ``exclude`` (depth-
        aware, same policy as placement), or None when no healthy
        sibling exists."""
        depths = self.channels.depths()
        best, best_depth = None, None
        for ch in self.channels.enabled_channels():
            if ch == exclude or self.channel_state(ch) != BREAKER_CLOSED:
                continue
            d = depths[ch] if ch < len(depths) else 0
            if best is None or d < best_depth:
                best, best_depth = ch, d
        return best

    def score_on_channel(self, channel: int,
                         score_fn: Callable[[], Any],
                         rids: Optional[List[str]] = None,
                         trace_ids: Optional[List[str]] = None):
        """Failover dispatch: run ``score_fn`` as channel ``channel``'s
        scoring work under its fault points and breaker accounting. On
        failure, the SAME in-hand work is re-dispatched ONCE to a
        healthy channel before any client-visible error — bit-identical
        output, because the failover re-runs the identical fn (the
        channel only selects WHERE it runs). A score stalled past
        ``stall_timeout`` counts as a breaker failure even though its
        result still returns. ``rids``: the request ids riding the
        in-hand work — they ride the flight-recorder failover event so
        a dump names WHICH requests moved channels."""
        t0 = time.monotonic()
        try:
            out = self._channel_score(channel, score_fn)
        except Exception as first_err:
            self._record_channel_failure(channel)
            target = self._failover_target(exclude=channel)
            if target is None:
                raise  # no healthy sibling: the caller's error path
            self._m_failover.inc()
            _bb.record("failover", channel=channel, level="warn",
                       server=self.server.name, to_channel=target,
                       rids=(rids or [])[:8],
                       trace_ids=(trace_ids or [])[:8],
                       error=repr(first_err)[:200])
            t1 = time.monotonic()
            try:
                out = self._channel_score(target, score_fn)
            except Exception:
                # the same work failed on a healthy channel too: likely
                # the BATCH, not the channel — but count it anyway; a
                # wrongly tripped channel is re-admitted by its probe
                self._record_channel_failure(target)
                raise
            self._record_outcome(target, t1)
            return out
        self._record_outcome(channel, t0)
        return out

    def _record_outcome(self, channel: int, t0: float):
        """Success-or-stall accounting for one completed score: a score
        stalled past ``stall_timeout`` counts as a breaker failure even
        though its result still returns — on the FAILOVER attempt too,
        or a degraded channel every failover lands on would be recorded
        as an unconditional success and convoy the cluster."""
        if (self.stall_timeout is not None
                and time.monotonic() - t0 > self.stall_timeout):
            self._record_channel_failure(channel)
        else:
            self._record_channel_success(channel)

    def _ensure_probe_thread(self):
        # check-and-start under the breaker lock: two channels tripping
        # in the same instant must not each spawn a probe loop (the
        # loser's thread would double-probe quarantined channels and
        # escape stop()'s join, which only knows self._probe_thread)
        with self._breaker_lock:
            if (self._probe_thread is not None
                    and self._probe_thread.is_alive()):
                return
            self._probe_thread = threading.Thread(
                target=self._probe_loop_supervised,
                name=f"breaker-probe-{self.server.name}", daemon=True)
            self._probe_thread.start()

    def _probe_loop_supervised(self):
        """:func:`_supervise_loop` around :meth:`_probe_loop`: a dead
        probe thread would strand every OPEN channel quarantined
        forever — the breaker re-admits channels through this loop."""
        def on_restart(e: BaseException):
            _tm.counter("serving_thread_restarts_total",
                        server=self.server.name, thread="probe").inc()
            _bb.record("thread_restart", level="error",
                       server=self.server.name, thread="probe",
                       error=repr(e)[:200])

        _supervise_loop(self._probe_loop, self._stop, on_restart)

    def _probe_loop(self):
        """Half-open probe: every ``probe_interval`` seconds, each OPEN
        channel goes HALF_OPEN and re-scores a canary under its own
        fault points (plus ``canary_fn``); success re-admits it CLOSED
        (and re-enables placement), failure re-opens it."""
        while not self._stop.is_set():
            self._probe_wake.wait(self.probe_interval)
            self._probe_wake.clear()
            if self._stop.is_set():
                return
            with self._breaker_lock:
                open_chs = [ch for ch, st in self._breaker_state.items()
                            if st == BREAKER_OPEN]
            for ch in open_chs:
                with self._breaker_lock:
                    self._set_state_locked(ch, BREAKER_HALF_OPEN)
                t0 = time.monotonic()
                try:
                    self._channel_score(
                        ch, (lambda: self.canary_fn(ch))
                        if self.canary_fn is not None else lambda: None)
                except Exception:
                    ok = False
                else:
                    # the canary gets the SAME stall accounting as a
                    # real score: a channel tripped for slowness must
                    # not be re-admitted by a canary that itself
                    # stalled (trip -> re-admit -> trip flapping, with
                    # a redisperse every cycle)
                    ok = (self.stall_timeout is None
                          or time.monotonic() - t0 <= self.stall_timeout)
                _tm.counter("serving_channel_probe_total",
                            server=self.server.name,
                            outcome="ok" if ok else "fail").inc()
                _bb.record("breaker_probe", channel=ch,
                           server=self.server.name,
                           outcome="ok" if ok else "fail")
                if ok:
                    self._record_channel_success(ch)
                else:
                    with self._breaker_lock:
                        self._set_state_locked(ch, BREAKER_OPEN)

    def _distribute_supervised(self):
        """:func:`_supervise_loop` around :meth:`_distribute`: an
        exception there would otherwise silently stop ALL traffic."""
        def on_restart(e: BaseException):
            self._m_dist_restarts.inc()
            _bb.record("thread_restart", level="error",
                       server=self.server.name, thread="distributor",
                       error=repr(e)[:200])

        _supervise_loop(self._distribute, self._stop, on_restart)

    def _distribute(self):
        while not self._stop.is_set():
            # kill point BEFORE the get: a dying distributor must never
            # take an already-dequeued request with it
            _F_KILL_DIST.fire()
            try:
                item = self.server.requests.get(timeout=0.05)
            except queue.Empty:
                continue
            self.channels.add(item)

    def get_batch(self, channel: int, max_rows: int = 64,
                  timeout: float = 0.1, linger: float = 0.0,
                  coalesce: float = 0.0) -> List[CachedRequest]:
        out = _drain_queue(self.channels.channel(channel), max_rows,
                           timeout, linger, coalesce)
        # same epoch/history bookkeeping as the direct path, so a shard
        # that dies mid-batch stays replayable through server.recover()
        self.server._record_epoch(out)
        return out

    def device_for_channel(self, channel: int):
        """Map a serving channel onto a local CUDA device, round-robin —
        the per-channel scorer scores there, so N channels fan their
        micro-batches out over N cards instead of convoying on device 0.
        With more channels than cards, channels share devices
        round-robin (on one card, all of them); raises without CUDA."""
        return device_for_channel(channel)

    def reply_to(self, rid: str, response: HTTPResponseData) -> bool:
        return self.server.reply_to(rid, response)

    def update_n_channels(self, n: int):
        if self._serve_threads:
            # serve() snapshots the channel count: growing it now would
            # route new requests (depth-aware _place prefers the empty
            # newcomers) onto queues NO scorer loop drains — clients
            # would park until reply_timeout with no error at the
            # resize call
            raise ValueError(
                f"server {self.server.name!r} has channel scorers "
                "running; resize while serving is not supported "
                "(stop, resize, re-serve)")
        self.channels.update_n_channels(n)
        self._sync_channel_gauges()

    # -- in-process channel scoring loops -------------------------------

    def serve(self, pipeline_fn: Callable[[Table], Table],
              max_batch: int = 64, linger: float = 0.0,
              coalesce: float = 0.0, parse_json: bool = True,
              reply_col: str = "reply") -> "DistributedServer":
        """Start one supervised scorer thread per channel — the
        multi-channel serving query. Each loop drains its own channel
        and scores through :meth:`score_on_channel`, so a channel whose
        scoring breaks mid-score fails its in-hand batch over to a
        healthy sibling (200, bit-identical) instead of 500ing, and a
        tripped channel idles until its half-open probe re-admits it
        (its parked requests having re-dispersed at trip time). The
        channel-count is snapshotted here; resize while serving is not
        supported (stop, resize, re-serve)."""
        if self._serve_threads:
            raise ValueError(
                f"server {self.server.name!r} already has channel "
                "scorers running")
        if self.canary_fn is None:
            # a no-op canary would re-admit a genuinely broken channel
            # every probe_interval (trip -> re-admit flapping, one
            # redisperse per cycle): probe with the real pipeline
            self.canary_fn = self._pipeline_canary(pipeline_fn)
        for ch in range(self.channels.n_channels):
            t = threading.Thread(
                target=self._channel_loop_supervised,
                args=(ch, pipeline_fn, max_batch, linger, coalesce,
                      parse_json, reply_col),
                name=f"chan-scorer-{self.server.name}-{ch}", daemon=True)
            t.start()
            self._serve_threads.append(t)
        return self

    def _pipeline_canary(self, pipeline_fn) -> Callable[[int], Any]:
        """Default half-open canary for :meth:`serve`: re-score the
        captured known-good one-row input through the REAL pipeline, so
        re-admission proves the channel can score — not just that a
        no-op returns. Before the first successful score nothing is
        known-good, so the probe degrades to firing the channel's fault
        points only (injected chaos still round-trips the breaker)."""
        def canary(ch: int):
            table = self._canary_table
            if table is not None:
                pipeline_fn(table)
        return canary

    def _channel_loop_supervised(self, ch: int, *args):
        def on_restart(e: BaseException):
            _tm.counter("serving_thread_restarts_total",
                        server=self.server.name,
                        thread=f"channel{ch}").inc()
            _bb.record("thread_restart", channel=ch, level="error",
                       server=self.server.name,
                       thread=f"channel{ch}", error=repr(e)[:200])

        _supervise_loop(
            lambda: self._channel_loop(ch, *args), self._stop,
            on_restart)

    def _channel_loop(self, ch: int, pipeline_fn, max_batch, linger,
                      coalesce, parse_json, reply_col):
        while not self._stop.is_set():
            if self.channel_state(ch) != BREAKER_CLOSED:
                # quarantined: parked requests re-dispersed at trip
                # time and placement avoids this channel — idle until
                # the probe re-admits it
                time.sleep(0.02)
                continue
            batch = self.get_batch(ch, max_batch, timeout=0.05,
                                   linger=linger, coalesce=coalesce)
            if not batch:
                continue
            self._score_channel_batch(ch, batch, pipeline_fn,
                                      parse_json, reply_col)

    def _score_channel_batch(self, ch: int, batch: List[CachedRequest],
                             pipeline_fn, parse_json, reply_col):
        """Score one channel's micro-batch (with one-shot failover via
        :meth:`score_on_channel`) and reply; a batch that failed on TWO
        channels gets an explicit 500 — never a hang, never a silent
        drop."""
        def run():
            table = requests_to_table(batch)
            if parse_json:
                table = parse_request(table)
            out = pipeline_fn(table)
            if self._canary_table is None:
                # first known-good input: one row is all the probe
                # needs (copied so the slice doesn't pin the batch)
                snap = Table({c: table[c][:1].copy()
                              for c in table.columns})
                with self._breaker_lock:
                    if self._canary_table is None:
                        self._canary_table = snap
            return out

        err: Optional[BaseException] = None
        t0 = time.monotonic()
        try:
            out = self.score_on_channel(
                ch, run, rids=[cr.rid for cr in batch],
                trace_ids=[cr.span.trace_id for cr in batch])
        except Exception as e:  # noqa: BLE001 - channel loop must survive
            err = e
        dt = time.monotonic() - t0
        if _SLOW_BATCH_S and dt > _SLOW_BATCH_S:
            _bb.record("slow_batch", channel=ch, level="warn",
                       server=self.server.name, seconds=round(dt, 6),
                       size=len(batch),
                       rids=[cr.rid for cr in batch[:8]],
                       trace_ids=[cr.span.trace_id for cr in batch[:8]])
        if err is None:
            try:
                send_replies(self.server, out, reply_col)
            except Exception as e:  # noqa: BLE001 - bad reply col etc.
                err = e
        if err is not None:
            for cr in batch:
                self.server.reply_to(cr.rid, HTTPResponseData(
                    status_code=500, reason="channel scoring error",
                    entity=repr(err).encode()))
        for cr in batch:
            cr.span.finish("ok" if err is None else "error")
        for ep in sorted({cr.epoch for cr in batch}):
            self.server.commit(ep, exact=True)

    def drain(self, timeout_ms: float = 5000.0) -> bool:
        """Graceful drain across ALL channels — delegates to
        :meth:`WorkerServer.drain` (requests fanned out onto channel
        queues still park their connections in the shared server's
        routing table, so its convergence check covers them). Returns
        True when fully drained; call :meth:`stop` after either way."""
        return self.server.drain(timeout_ms)

    def stop(self):
        self._stop.set()
        self._probe_wake.set()
        self._distributor.join(timeout=2)
        for t in self._serve_threads:
            t.join(timeout=5)
        self._serve_threads = []
        if self._probe_thread is not None:
            self._probe_thread.join(timeout=2)
        # requests still parked on channel queues when the scorers exit
        # get an explicit 503 + Retry-After (counted), never a silent
        # drop into reply_timeout; the shared server's own intake queue
        # is shed the same way by server.stop() via the registry
        # removal below
        for ch in range(self.channels.n_channels):
            self.server.fail_queued(q=self.channels.channel(ch))
        for i in range(self._n_channel_gauges):
            _tm.unregister("serving_channel_depth",
                           server=self.server.name, channel=str(i))
            _tm.unregister("serving_channel_breaker_state",
                           server=self.server.name, channel=str(i))
        self._n_channel_gauges = 0
        with self.server._lock:
            self.server._dist_owner = None
        HTTPSourceStateHolder.remove(self.server.name)


# ---------------------------------------------------------------------------
# source/sink as table operations (IOImplicits + ServingUDFs analogues)
# ---------------------------------------------------------------------------

ID_COL = "id"
REQUEST_COL = "request"


def requests_to_table(batch: List[CachedRequest]) -> Table:
    """Micro-batch of requests -> Table (ref: HTTPInputPartitionReader row
    conversion :698; columns: id, request)."""
    ids = np.array([cr.rid for cr in batch], dtype=object)
    reqs = np.empty(len(batch), dtype=object)
    reqs[:] = [cr.request for cr in batch]
    return Table({ID_COL: ids, REQUEST_COL: reqs})


# the JSON decode of a batch's bodies, on the scorer thread
_M_PARSE_S = _tm.histogram("request_parse_seconds")


def parse_request(table: Table, as_json: bool = True,
                  output_col: str = "value") -> Table:
    """``.parseRequest`` fluent helper (ref: IOImplicits.scala:20-189).
    A JSON decode's seconds a batch land in ``request_parse_seconds``."""
    t0 = time.monotonic()
    vals = np.empty(table.num_rows, dtype=object)
    for i, req in enumerate(table[REQUEST_COL]):
        body = req.entity or b""
        if as_json:
            try:
                vals[i] = json.loads(body.decode("utf-8"))
            except (json.JSONDecodeError, UnicodeDecodeError):
                vals[i] = None
        else:
            vals[i] = body
    if as_json:
        _M_PARSE_S.observe(time.monotonic() - t0)
    return table.with_column(output_col, vals)


def make_reply(value: Any, status: int = 200,
               content_type: str = "application/json") -> HTTPResponseData:
    """``ServingUDFs.makeReplyUDF`` analogue (ref: ServingUDFs.scala:17-36)."""
    from synapseml_tpu_torch.core.param import _json_default

    if isinstance(value, (bytes, bytearray)):
        body = bytes(value)
    elif isinstance(value, str):
        body = value.encode("utf-8")
    else:
        # _json_default handles numpy scalars/arrays nested anywhere
        body = json.dumps(value, default=_json_default).encode("utf-8")
    return HTTPResponseData(status_code=status,
                            headers={"Content-Type": content_type},
                            entity=body)


def send_replies(server: WorkerServer, table: Table,
                 reply_col: str = "reply", id_col: str = ID_COL) -> int:
    """``ServingUDFs.sendReplyUDF`` analogue (ref: ServingUDFs.scala:37-51,
    HTTPDataWriter.write)."""
    sent = 0
    for rid, rep in zip(table[id_col], table[reply_col]):
        if not isinstance(rep, HTTPResponseData):
            rep = make_reply(rep)
        if server.reply_to(rid, rep):
            sent += 1
    return sent


class ContinuousServer:
    """The serving query: source -> pipeline -> reply sink in a loop thread
    (the ``spark.readStream.server() ... writeStream.server()`` pattern,
    ref: IOImplicits.scala + HTTPv2Suite).

    ``pipeline_fn``: Table(id, request, value) -> Table with ``reply_col``.
    """

    def __init__(self, name: str, pipeline_fn: Callable[[Table], Table],
                 host: str = "127.0.0.1", port: Optional[int] = None,
                 max_batch: int = 64, parse_json: bool = True,
                 reply_col: str = "reply", reply_timeout: float = 60.0,
                 batch_linger: float = 0.0, pipelined: bool = True,
                 scoring_workers: int = 1, batch_coalesce: float = 0.0,
                 ready: bool = True, max_errors: int = 256,
                 deadline_ms: Optional[float] = None,
                 max_queue: Optional[int] = None,
                 retry_transient: int = 1,
                 retry_backoff: float = 0.05,
                 retry_rng: Optional[Any] = None,
                 retry_after_s: Optional[float] = None):
        """``batch_linger``: seconds to keep collecting after the first
        request of a batch arrives. A few ms turns concurrent clients'
        requests into ONE scored micro-batch (one device round trip
        amortized over the batch) instead of serial singletons.

        ``batch_coalesce`` (default 0 = off): deadline-based coalescing —
        hold the batch open until its FIRST request is this many seconds
        old (arrival-anchored, see :func:`_drain_queue`). Unlike linger,
        a request that already sat in the queue that long pays no added
        wait, so concurrent low-QPS clients coalesce into one scored
        micro-batch while worst-case added latency stays bounded by the
        window — coalescing amortizes concurrent clients without
        taxing a lone one.

        ``pipelined``: run collection and scoring as a staged pipeline
        (a collector thread drains + lingers on batch k+1 WHILE the device
        scores batch k, and keeps coalescing for as long as every scorer is
        busy — adaptive linger). ``False`` restores the strictly serial
        drain->score loop.

        ``scoring_workers``: concurrent scorer threads (pipelined mode).
        Default 1: ``pipeline_fn`` is never called concurrently unless
        the caller opts in (>1 requires a thread-safe pipeline —
        ``ONNXModel.transform`` is; ad-hoc host state may not be).
        Where the per-batch wall time is dominated by host work or a
        round trip, not device compute, N workers keep N micro-batches
        in flight, so throughput scales toward N/RTT while per-request
        latency stays one RTT (replies are
        per-request ids; epochs commit independently, so ordering is
        preserved per epoch, as in the reference's partition-parallel
        HTTPSourceV2 writers).

        Pipelined mode is a THREE-stage pipeline: collect -> score ->
        reply. Reply serialization + socket writes + epoch commits for
        batch k run on a dedicated reply thread while the scorer already
        scores batch k+1 — and since the scorer itself feeds the
        executor's async submit/drain pipeline (runtime/executor.py),
        host staging, H2D, device compute, and D2H fetch of consecutive
        micro-batches all overlap instead of alternating.

        ``ready=False`` starts the embedded server with its /health
        readiness gate CLOSED (503): the caller warms the compile cache
        first, then flips ``self.server.set_ready(True)`` — so traffic
        never lands on a compiling chip (the ``main()`` --warmup flow).

        Robustness knobs (docs/robustness.md): ``deadline_ms`` is the
        default per-request deadline (clients override per request via
        the ``X-Deadline-Ms`` header); a request already expired at
        batch-form time is shed 504 BEFORE scoring. ``max_queue`` sheds
        429 at enqueue past that backlog. ``retry_transient`` bounds
        how many times a :class:`PipelineBrokenError` from the scoring
        pipeline is retried (with ``retry_backoff``-scaled jittered
        sleep) against the supervision-restarted executor pipeline
        before the batch takes the 500 path. ``retry_rng``: the PRNG
        behind the jitter — inject a seeded ``random.Random`` so retry
        timing is deterministic under test (``SYNAPSEML_RETRY_SEED``
        is the env route, see :func:`_retry_rng`). ``retry_after_s``
        overrides the server's Retry-After hint on shed replies."""
        self.server = HTTPSourceStateHolder.get_or_create_server(
            name, host, port, reply_timeout=reply_timeout, ready=ready,
            default_deadline_ms=deadline_ms, max_queue=max_queue)
        if not ready:
            # the registry may have returned an EXISTING server (ctor
            # kwargs ignored): close the gate explicitly so a reused name
            # still holds /health at 503 through warmup
            self.server.set_ready(False)
        if deadline_ms is not None:
            self.server.default_deadline_ms = deadline_ms
        if max_queue is not None:
            self.server.max_queue = max_queue
        if retry_after_s is not None:
            self.server.retry_after_s = retry_after_s
        self.name = name
        self.pipeline_fn = pipeline_fn
        self.max_batch = max_batch
        self.batch_linger = batch_linger
        self.batch_coalesce = batch_coalesce
        self.parse_json = parse_json
        self.reply_col = reply_col
        self.pipelined = pipelined
        self.scoring_workers = max(1, int(scoring_workers))
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._collector: Optional[threading.Thread] = None
        self._extra_scorers: List[threading.Thread] = []
        self._handoff: Optional["queue.Queue"] = None
        self._reply_q: Optional["queue.Queue"] = None
        self._reply_thread: Optional[threading.Thread] = None
        # appended from every scorer thread AND the reply thread; guarded
        # so concurrent failures can't lose entries (list.append happens
        # to be GIL-atomic today, but the discipline is the contract).
        # BOUNDED: under sustained failure the list used to grow without
        # limit — now the oldest entry is dropped past ``max_errors`` and
        # the drop is counted (serving_errors_dropped_total), so a
        # long-lived server keeps the *recent* errors and a flat memory
        # profile
        self._err_lock = threading.Lock()
        self.errors: List[str] = []
        self.max_errors = max(1, int(max_errors))
        self.errors_dropped = 0
        self._m_errors = _tm.counter("serving_errors_total", server=name)
        self._m_err_dropped = _tm.counter("serving_errors_dropped_total",
                                          server=name)
        self._m_shed = _tm.counter("serving_shed_total", server=name)
        self._m_score_s = _tm.histogram("serving_score_seconds",
                                        server=name)
        self.retry_transient = max(0, int(retry_transient))
        self.retry_backoff = float(retry_backoff)
        self._retry_rng = _retry_rng(retry_rng)
        self._m_deadline_shed = _tm.counter("serving_deadline_shed_total",
                                            server=name)
        self._m_retry = _tm.counter("serving_retry_total", server=name)
        self._m_bisect = _tm.counter("serving_poison_bisect_total",
                                     server=name)
        self._m_poison = _tm.counter("serving_poison_requests_total",
                                     server=name)
        # per-thread restart counters (supervision), registered lazily
        # like the per-status reply counters
        self._m_restarts: Dict[str, _tm.Counter] = {}

    def _record_error(self, exc: BaseException):
        self._m_errors.inc()
        with self._err_lock:
            if len(self.errors) >= self.max_errors:
                del self.errors[0]
                self.errors_dropped += 1
                self._m_err_dropped.inc()
            self.errors.append(repr(exc))
        _slog.log("error", "serving_error", server=self.name,
                  error=repr(exc)[:400])

    def _restart_counter(self, thread: str) -> "_tm.Counter":
        c = self._m_restarts.get(thread)
        if c is None:
            c = self._m_restarts.setdefault(thread, _tm.counter(
                "serving_thread_restarts_total", server=self.name,
                thread=thread))
        return c

    def _supervised(self, thread: str, fn: Callable, *args):
        """:func:`_supervise_loop` around one serving-stage loop: a
        dead scorer/reply/collector thread is recorded, counted, and
        restarted — never a silently wedged stage."""

        def on_restart(e: BaseException):
            self._record_error(e)
            self._restart_counter(thread).inc()
            _bb.record("thread_restart", level="error",
                       server=self.name, thread=thread,
                       error=repr(e)[:200])

        _supervise_loop(lambda: fn(*args), self._stop, on_restart)

    @property
    def url(self) -> str:
        return self.server.url

    def _score_only(self, batch: List[CachedRequest]):
        """Stage 2 of the pipeline: score one micro-batch WITHOUT sending
        replies. Returns ``(out_table, error)`` — exactly one is None.

        The batch's trace spans become the scorer thread's ambient span
        context for the duration of ``pipeline_fn``: any
        ``BatchedExecutor.submit`` the pipeline makes (ONNXModel et al.)
        captures them, so the executor's stage/compute/drain stages land
        on each request's span without any pipeline-fn API change."""
        t0 = time.monotonic()
        token = None
        if _tm.enabled():
            for cr in batch:
                if cr.drained:
                    cr.span.note("batch_form", t0 - cr.drained)
            token = _tm.set_current_spans(cr.span for cr in batch)
        try:
            _F_LAT_SCORE.fire()
            table = requests_to_table(batch)
            if self.parse_json:
                table = parse_request(table)
            return self.pipeline_fn(table), None
        except Exception as e:  # noqa: BLE001 - serving loop must survive
            self._record_error(e)
            return None, e
        finally:
            if token is not None:
                _tm.reset_current_spans(token)
            dt = time.monotonic() - t0
            self._m_score_s.observe(dt)
            if _SLOW_BATCH_S and dt > _SLOW_BATCH_S:
                _bb.record("slow_batch", level="warn",
                           server=self.name, seconds=round(dt, 6),
                           size=len(batch), stage="score",
                           rids=[cr.rid for cr in batch[:8]],
                           trace_ids=[cr.span.trace_id
                                      for cr in batch[:8]])

    def _reply_scored(self, batch: List[CachedRequest], out, err,
                      err_status: int = 500,
                      commit_epochs: Optional[List[int]] = None):
        """Stage 3: reply-send + exact epoch commits for one scored batch.
        A pipelined batch may merge several drain epochs (each already
        recorded for replay), so every distinct epoch is committed —
        exact commits, because concurrent workers finish epochs out of
        order and a cumulative commit of a later epoch would erase an
        earlier in-flight epoch's replay history. ``err_status`` is the
        reply code for a failed batch: 500 for pipeline errors, 400 for
        a poison request the bisection isolated. ``commit_epochs``
        overrides WHICH epochs commit (``()`` = none): bisection
        segments of one batch share epochs, so only the last segment
        commits them — committing per segment would prune replay
        history for requests still unreplied in sibling segments."""
        t0 = time.monotonic()
        try:
            if err is None:
                try:
                    _F_REPLY.fire()
                    send_replies(self.server, out, self.reply_col)
                    return
                except Exception as e:  # noqa: BLE001 - bad reply col etc.
                    self._record_error(e)
                    err = e
                    err_status = 500
            for cr in batch:
                self.server.reply_to(cr.rid, HTTPResponseData(
                    status_code=err_status,
                    reason=("bad request" if err_status == 400
                            else "pipeline error"),
                    entity=repr(err).encode()))
        finally:
            dt = time.monotonic() - t0
            for cr in batch:
                cr.span.note("reply", dt)
                cr.span.finish("ok" if err is None else "error")
            eps = (sorted({cr.epoch for cr in batch})
                   if commit_epochs is None else commit_epochs)
            for ep in eps:
                self.server.commit(ep, exact=True)

    def _shed_expired(self, batch: List[CachedRequest]
                      ) -> List[CachedRequest]:
        """Wasted-work elimination at batch-form time: a request whose
        deadline already passed gets 504 NOW — scoring it would burn
        device time on an answer nobody is waiting for. Returns the
        still-live remainder; epochs only covered by shed requests are
        committed here (shed requests are replied, so they are not
        replayable either way)."""
        now = time.monotonic()
        live: List[CachedRequest] = []
        expired: List[CachedRequest] = []
        for cr in batch:
            (expired if cr.deadline is not None and cr.deadline <= now
             else live).append(cr)
        if expired:
            self._m_deadline_shed.inc(len(expired))
            _bb.record("shed_deadline", level="warn", server=self.name,
                       n=len(expired),
                       rids=[cr.rid for cr in expired[:8]],
                       trace_ids=[cr.span.trace_id
                                  for cr in expired[:8]])
            # Retry-After rides the shed 504 too: a deadline-expired
            # request usually means the replica is saturated — backing
            # off beats an immediate re-hammer that will expire again
            hdrs = {"Retry-After": self.server._retry_after_value()}
            for cr in expired:
                self.server.reply_to(cr.rid, HTTPResponseData(
                    status_code=504, reason="deadline exceeded before "
                    "scoring", headers=hdrs))
                cr.span.finish("shed")
            live_eps = {cr.epoch for cr in live}
            for ep in sorted({cr.epoch for cr in expired} - live_eps):
                self.server.commit(ep, exact=True)
        return live

    def _bisect_score(self, batch: List[CachedRequest]):
        """Poison isolation: recursively re-score halves (log2 n levels)
        until the failing request(s) are singletons. Healthy halves
        reply 200 with their real scores; an isolated poison request
        replies 400 — one bad payload no longer fails its neighbors."""
        out, err = self._score_only(batch)
        if err is None:
            return [(batch, out, None, 200)]
        if isinstance(err, PipelineBrokenError):
            # the pipeline died MID-bisection: that is transient
            # infrastructure failure, not a poison payload — 500, never
            # a client-blaming 400, and stop burning re-scores against
            # a dead pipeline
            return [(batch, None, err, 500)]
        if len(batch) == 1:
            # confirm before blaming the client: under probabilistic
            # faults (chaos) a TRANSIENT failure can land on a healthy
            # singleton's re-score — one more score must fail too
            # before this counts as poison; a flake scores 200
            out, err2 = self._score_only(batch)
            if err2 is None:
                return [(batch, out, None, 200)]
            if isinstance(err2, PipelineBrokenError):
                return [(batch, None, err2, 500)]
            self._m_poison.inc()
            _bb.record("poison_isolated", rid=batch[0].rid,
                       level="warn", server=self.name,
                       error=repr(err2)[:200])
            return [(batch, None, err2, 400)]
        mid = len(batch) // 2
        return (self._bisect_score(batch[:mid])
                + self._bisect_score(batch[mid:]))

    def _score_resilient(self, batch: List[CachedRequest]):
        """Score one micro-batch through the full degradation ladder:
        (1) a transient :class:`PipelineBrokenError` (an executor
        pipeline thread died; supervision restarts it) gets
        ``retry_transient`` bounded retries with jittered backoff;
        (2) any other error on a batch of n>1 is bisected to isolate
        the poison request(s); (3) what remains fails with its status.
        Returns ``[(sub_batch, out, err, err_status, commit_epochs),
        ...]`` segments ready for :meth:`_reply_scored` — only the LAST
        segment carries the batch's epochs to commit, so an epoch's
        replay history is never pruned while sibling segments are still
        unreplied (segments reply in order on one thread)."""
        segments = self._score_segments(batch)
        eps = sorted({cr.epoch for cr in batch})
        return [(b, o, e, st, eps if i == len(segments) - 1 else ())
                for i, (b, o, e, st) in enumerate(segments)]

    def _score_segments(self, batch: List[CachedRequest]):
        out, err = self._score_only(batch)
        for _ in range(self.retry_transient):
            if not isinstance(err, PipelineBrokenError):
                break
            self._m_retry.inc()
            time.sleep(self.retry_backoff
                       * (0.5 + self._retry_rng.random()))
            out, err = self._score_only(batch)
        if err is None:
            return [(batch, out, None, 200)]
        if isinstance(err, PipelineBrokenError) or len(batch) == 1:
            # still-broken pipeline fails the whole batch (bisecting
            # would just re-fail against the same dead pipeline)
            return [(batch, None, err, 500)]
        self._m_bisect.inc()
        _bb.record("poison_bisect", level="warn", server=self.name,
                   size=len(batch), error=repr(err)[:200],
                   rids=[cr.rid for cr in batch[:8]])
        mid = len(batch) // 2
        return (self._bisect_score(batch[:mid])
                + self._bisect_score(batch[mid:]))

    def _score_batch(self, batch: List[CachedRequest]):
        """Score + reply inline (the strictly serial path)."""
        batch = self._shed_expired(batch)
        if not batch:
            return
        for seg in self._score_resilient(batch):
            self._reply_scored(*seg)

    def _loop(self):
        while not self._stop.is_set():
            _F_KILL_SCORER.fire()
            batch = self.server.get_batch(self.max_batch, timeout=0.05,
                                          linger=self.batch_linger,
                                          coalesce=self.batch_coalesce)
            if not batch:
                continue
            self._score_batch(batch)

    def _fail_batch(self, batch: List[CachedRequest], status: int = 503,
                    reason: str = "server stopping"):
        """Fast-fail a drained-but-unscored batch (shutdown path): the
        clients would otherwise block until reply_timeout."""
        self._m_shed.inc(len(batch))
        for cr in batch:
            self.server.reply_to(cr.rid, HTTPResponseData(
                status_code=status, reason=reason))
            cr.span.finish("shed")
        for ep in sorted({cr.epoch for cr in batch}):
            self.server.commit(ep, exact=True)

    def _collect_loop(self, handoff: "queue.Queue"):
        """Stage 1: drain + linger concurrently with device scoring.
        While the scorer holds the handoff slot, the wait itself becomes
        extra coalescing time — the linger adapts to the service rate
        instead of being a fixed prepaid delay."""
        while not self._stop.is_set():
            _F_KILL_COLLECT.fire()
            batch = self.server.get_batch(self.max_batch, timeout=0.05,
                                          linger=self.batch_linger,
                                          coalesce=self.batch_coalesce)
            if not batch:
                continue
            placed = False
            while not self._stop.is_set():
                try:
                    handoff.put(batch, timeout=0.05)
                    placed = True
                    break
                except queue.Full:
                    if len(batch) < self.max_batch:
                        batch.extend(self.server.get_batch(
                            self.max_batch - len(batch), timeout=0.001))
            if not placed:
                # stop() raced us while the batch was in hand: it can't
                # see this batch in the handoff, so fail it here
                self._fail_batch(batch)

    def _score_loop(self, handoff: "queue.Queue"):
        """Stage 2: score, then hand the scored batch to the reply
        thread — the scorer starts on batch k+1 while batch k's replies
        serialize and its epochs commit on the reply thread."""
        while not self._stop.is_set():
            _F_KILL_SCORER.fire()
            try:
                batch = handoff.get(timeout=0.05)
            except queue.Empty:
                continue
            batch = self._shed_expired(batch)
            if not batch:
                continue
            segments = self._score_resilient(batch)
            rq = self._reply_q
            if rq is None or self._stop.is_set():
                # reply stage not running — or stop() raced a long score
                # and the reply thread may already have exited: reply
                # inline so the batch's clients never hang
                for seg in segments:
                    self._reply_scored(*seg)
                continue
            for seg in segments:
                rq.put(seg)
            if self._stop.is_set():
                # stop() landed between the check and the put — the
                # reply thread may have seen an empty queue and exited
                # (or be about to). Wait out its exit, then drain any
                # leftovers here (get_nowait races with stop()'s own
                # drain safely — each item is taken once)
                self._reply_thread.join(timeout=10)
                while True:
                    try:
                        item = rq.get_nowait()
                    except queue.Empty:
                        break
                    self._reply_scored(*item)

    def _reply_loop(self):
        """Stage 3: reply-send + commits off the scoring threads. Exits
        only once stopped AND drained, so scored batches always reply."""
        while True:
            _F_KILL_REPLY.fire()
            try:
                item = self._reply_q.get(timeout=0.05)
            except queue.Empty:
                if self._stop.is_set():
                    return
                continue
            self._reply_scored(*item)

    def _pipelined_loop(self):
        handoff: "queue.Queue[List[CachedRequest]]" = queue.Queue(
            maxsize=self.scoring_workers)
        self._handoff = handoff
        # bounded: a stalled reply sink backpressures scoring instead of
        # queueing scored-but-unreplied batches without limit
        self._reply_q = queue.Queue(maxsize=max(2, 2 * self.scoring_workers))
        # every stage thread runs under _supervised: a dead scorer/
        # reply/collector thread restarts (counted) instead of silently
        # wedging its stage of the pipeline
        self._reply_thread = threading.Thread(
            target=self._supervised, args=("reply", self._reply_loop),
            name=f"serving-reply-{self.name}", daemon=True)
        self._reply_thread.start()
        self._collector = threading.Thread(
            target=self._supervised,
            args=("collector", self._collect_loop, handoff),
            name=f"serving-collect-{self.name}", daemon=True)
        self._collector.start()
        for i in range(self.scoring_workers - 1):
            t = threading.Thread(
                target=self._supervised,
                args=("scorer", self._score_loop, handoff),
                name=f"serving-score-{self.name}-{i + 1}", daemon=True)
            t.start()
            self._extra_scorers.append(t)
        self._supervised("scorer", self._score_loop, handoff)

    def start(self) -> "ContinuousServer":
        target = (self._pipelined_loop if self.pipelined
                  else lambda: self._supervised("scorer", self._loop))
        # both branches of `target` run under supervision:
        # _pipelined_loop runs every stage under _supervised, the scorer
        # lambda wraps _loop in it
        self._thread = threading.Thread(
            target=target, name=f"serving-query-{self.name}", daemon=True)
        self._thread.start()
        return self

    def drain(self, timeout_ms: float = 5000.0) -> bool:
        """Graceful drain — delegates to :meth:`WorkerServer.drain`
        (the SIGTERM half of a k8s rolling restart; ``main()`` calls
        this on signal, then :meth:`stop`)."""
        return self.server.drain(timeout_ms)

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        if self._collector is not None:
            self._collector.join(timeout=5)
        for t in self._extra_scorers:
            t.join(timeout=5)
        # scorers are down: the reply thread drains what they queued and
        # exits (scored batches get their real replies, not 503s)
        if self._reply_thread is not None:
            self._reply_thread.join(timeout=5)
        if self._reply_q is not None:
            while True:
                try:
                    item = self._reply_q.get_nowait()
                except queue.Empty:
                    break
                self._reply_scored(*item)
        # batches parked in the handoff when the scorers exited would
        # leave their clients blocked until reply_timeout: fail them
        # fast with 503 (the old serial loop always finished its batch)
        if self._handoff is not None:
            while True:
                try:
                    batch = self._handoff.get_nowait()
                except queue.Empty:
                    break
                self._fail_batch(batch)
        HTTPSourceStateHolder.remove(self.name)


def _model_pipeline(model_path: str, cache_dir=None, device: str = "cuda",
                    devices=None):
    """JSON {"features": [...]} -> ONNX-scored reply — the deployment
    entry's default pipeline. ``cache_dir`` enables the executable store
    (--cache-dir / SYNAPSEML_COMPILE_CACHE); ``device`` is where
    ``ONNXModel.transform`` runs (the card unless the caller asks for
    the CPU); ``devices`` runs each scored micro-batch data-parallel over
    that device spec (``ONNXModel.devices`` -> runtime/executor.py).
    Returns ``(pipeline, model)`` so ``main`` can drive ``model.warmup``
    before the readiness gate.

    The scorer thread's seconds a batch land in
    ``model_pipeline_seconds{part=}``: ``features`` (the parsed rows'
    lists to one array), ``transform`` and ``replies`` (the reply
    bodies' JSON); the JSON decode before them is
    ``request_parse_seconds``."""
    from synapseml_tpu_torch.onnx import ONNXModel

    model = ONNXModel(model_path=model_path)
    if devices is not None:
        model.set(devices=devices)
    if cache_dir is not None:
        model.set(compile_cache_dir=cache_dir)
    feed = model.graph.input_names[0]
    # cast features to the graph's DECLARED input dtype — token-id
    # models feed int32/int64, not float32; unknown/absent dtype keeps
    # the float32 default
    feed_dtype, _ = getattr(model.graph, "input_info", {}).get(feed) \
        or (None, None)
    feed_np = np.dtype(feed_dtype) if feed_dtype is not None else np.float32
    first_out = model.graph.output_names[0]
    m_part = {part: _tm.histogram("model_pipeline_seconds", part=part)
              for part in ("features", "transform", "replies")}

    def pipeline(table: Table) -> Table:
        t0 = time.monotonic()
        feats = np.stack([np.asarray(v["features"], feed_np)
                          for v in table["value"]])
        t1 = time.monotonic()
        scored = model.transform(Table({feed: feats}), device=device)
        out_col = np.asarray(scored[first_out])
        t2 = time.monotonic()
        replies = np.empty(table.num_rows, dtype=object)
        for i in range(table.num_rows):
            replies[i] = make_reply({"output": out_col[i].tolist()})
        m_part["features"].observe(t1 - t0)
        m_part["transform"].observe(t2 - t1)
        m_part["replies"].observe(time.monotonic() - t2)
        return table.with_column("reply", replies)

    # ONNXModel resolves feed_dict lazily; set it for the raw-name feed
    model.set(feed_dict={feed: feed})
    return pipeline, model


def _echo_pipeline(table: Table) -> Table:
    replies = np.empty(table.num_rows, dtype=object)
    for i, v in enumerate(table["value"]):
        replies[i] = make_reply(v)
    return table.with_column("reply", replies)


def _release_model(model) -> None:
    """Close the model's executors and free what they hold on the card
    (pinned buffers, weights, CUDA graphs and their pool) while the
    interpreter still runs — their threads joined before teardown.
    ``model`` None frees what an already closed decode scheduler
    left."""
    import gc

    cache = (model.__dict__.get("_executor_cache") or {}
             if model is not None else {})
    for ex in list(cache.values()):
        ex.close(wait=True)
    cache.clear()
    gc.collect()
    torch = sys.modules.get("torch")
    if torch is not None and torch.cuda.is_initialized():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def main(argv=None):
    """``python -m synapseml_tpu_torch.io.serving`` — the container
    entry: load --model (SYNAPSEML_MODEL_PATH), or echo when unset,
    serve on --port with /health, block until SIGTERM/SIGINT, drain,
    and print the exit accounting."""
    import argparse
    import signal

    ap = argparse.ArgumentParser()
    ap.add_argument("--port", type=int, default=8898)
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--model", default=os.environ.get(
        "SYNAPSEML_MODEL_PATH"))
    ap.add_argument("--name", default="serving")
    ap.add_argument("--device", default="cuda",
        help="where the model scores: 'cuda' (default; exits 2 without "
             "a CUDA device, never falling back) or 'cpu'. An echo "
             "server (no --model) runs nothing on a device")
    ap.add_argument("--devices", default=os.environ.get(
        "SYNAPSEML_DEVICES"),
        help="data-parallel device spec: 'all' or an int N (the first N "
             "CUDA devices); each scored micro-batch is sharded over them "
             "or run whole on the next one (ONNXModel.devices). A spec "
             "that does not resolve exits 2")
    ap.add_argument("--tensor-parallel", type=int,
                    default=int(os.environ.get(
                        "SYNAPSEML_TENSOR_PARALLEL", "1")),
        help="tensor-parallel ways of the reference; only 1 is ported "
             "(ROADMAP Queue 1 item 4)")
    ap.add_argument("--partition-rules", default=os.environ.get(
        "SYNAPSEML_PARTITION_RULES") or None,
        help="partition-rule overrides for --tensor-parallel; not "
             "ported yet (ROADMAP Queue 1 item 4): any value exits 2")
    ap.add_argument("--decode", action="store_true",
                    default=bool(os.environ.get("SYNAPSEML_DECODE", "")),
        help="decode serving mode: POST /generate admits autoregressive "
             "sequences into the continuous-batching scheduler "
             "(runtime/decode.py) with a paged device-resident KV cache "
             "— requires --model pointing at a share-buffer decoder "
             "graph (past_key/past_value + seqlens_k inputs). Geometry "
             "and capacity ride the SYNAPSEML_DECODE_*/SYNAPSEML_KV_* "
             "env knobs; per-request max_new_tokens in the body, "
             "deadline via X-Deadline-Ms. Every (phase, KV bucket) "
             "signature is captured as a CUDA graph before /health "
             "goes ready")
    ap.add_argument("--coalesce-ms", type=float, default=float(os.environ.get(
        "SYNAPSEML_COALESCE_MS", "0")),
        help="deadline-based batching window in ms (0 = off)")
    ap.add_argument("--deadline-ms", type=float, default=float(os.environ.get(
        "SYNAPSEML_DEADLINE_MS", "0")),
        help="default per-request deadline in ms (clients override via "
             "the X-Deadline-Ms header); a request already expired at "
             "batch-form time is shed 504 before scoring. 0 = none")
    ap.add_argument("--max-queue", type=int, default=int(os.environ.get(
        "SYNAPSEML_MAX_QUEUE", "0")),
        help="admission control: shed requests 429 at enqueue once this "
             "many are already queued (0 = unbounded)")
    ap.add_argument("--drain-timeout-ms", type=float,
                    default=float(os.environ.get(
                        "SYNAPSEML_DRAIN_TIMEOUT_MS", "5000")),
        help="graceful-drain budget on SIGTERM: new requests get 503 + "
             "Retry-After immediately, accepted requests get up to this "
             "long to finish to a real reply before the process exits")
    ap.add_argument("--cache-dir", default=os.environ.get(
        "SYNAPSEML_COMPILE_CACHE") or None,
        help="executable-store directory (warmup records each bucket's "
             "warm program there); unset = off")
    ap.add_argument("--warmup", default=os.environ.get(
        "SYNAPSEML_WARMUP", ""),
        help="capture model buckets as CUDA graphs before going ready: "
             "'auto' (the executor's full bucket ladder) or "
             "comma-separated bucket sizes; empty = no warmup. /health "
             "answers 503 until warmup completes")
    ap.add_argument("--log", default=os.environ.get(
        "SYNAPSEML_LOG", ""),
        help="structured-log emission: 'json' (JSON lines on stderr), "
             "'text', or '0'/empty = silent")
    ap.add_argument("--dump-dir", default=os.environ.get(
        "SYNAPSEML_DUMP_DIR") or None,
        help="flight-recorder dump directory (pipeline breaks and "
             "SIGUSR2 snapshot ring+stacks+gauges here); default: "
             "<tmpdir>/synapseml_flight")
    args = ap.parse_args(argv)
    try:
        _slog.set_mode(args.log.strip().lower())
    except ValueError as e:
        print(f"error: --log {args.log!r}: {e}", flush=True)
        return 2
    # the reference's options whose machinery is not ported fail fast,
    # naming the ROADMAP item that ports each — never a pod that goes
    # Ready while ignoring its configuration
    devices = args.devices or None  # unset env var arrives as ""
    if devices is not None:
        # fail fast on a bad spec — discovering it per request would
        # leave a "healthy" pod 500-ing every score
        from synapseml_tpu_torch.runtime.executor import resolve_devices
        try:
            if devices != "all":
                devices = int(devices)
            resolve_devices(devices)
        except (ValueError, RuntimeError) as e:
            print(f"error: --devices {args.devices!r}: {e}", flush=True)
            return 2
    if int(args.tensor_parallel or 1) > 1:
        print(f"error: --tensor-parallel {args.tensor_parallel}: tensor "
              "parallelism is not ported yet (ROADMAP Queue 1 item 4)",
              flush=True)
        return 2
    if args.partition_rules:
        print(f"error: --partition-rules {args.partition_rules!r}: "
              "partition rules are not ported yet (ROADMAP Queue 1 item "
              "4)", flush=True)
        return 2
    if args.dump_dir:
        _bb.set_dump_dir(args.dump_dir)
    # kill -USR2 <pid> snapshots the flight recorder to the dump dir —
    # the operator's "what is this replica doing right now" surface
    _bb.install_signal_trigger()
    if args.model and not os.path.exists(args.model):
        # a configured-but-missing model must NOT silently degrade to
        # echo: the pod would go Ready and serve request bodies as
        # "scores" — fail fast so k8s restarts against the mounted model
        print(f"error: model path {args.model!r} does not exist",
              flush=True)
        return 2
    if args.decode and not args.model:
        print("error: --decode requires --model (a share-buffer "
              "decoder graph)", flush=True)
        return 2
    model = None
    decode_sched = None
    if args.model:
        from synapseml_tpu_torch import device as device_policy

        try:
            dev = device_policy.resolve(args.device)
        except (RuntimeError, ValueError) as e:
            print(f"error: --device {args.device!r}: {e}", flush=True)
            return 2
        if devices is not None and dev.type != "cuda":
            print(f"error: --devices {args.devices!r} names CUDA devices "
                  f"but --device is {args.device!r}", flush=True)
            return 2
    if args.decode:
        from synapseml_tpu_torch.onnx.importer import import_model
        from synapseml_tpu_torch.runtime import compile_cache as _cc
        from synapseml_tpu_torch.runtime.decode import DecodeScheduler

        with open(args.model, "rb") as f:
            payload = f.read()
        decode_sched = DecodeScheduler(
            import_model(payload), name=args.name,
            cache_dir=args.cache_dir, cache_key=_cc.content_hash(payload),
            device=args.device)
        del payload
        # "/" still answers, as echo: decode traffic is POST /generate
        pipeline = _echo_pipeline
        what = (f"decode {args.model} [device={args.device} "
                f"B={decode_sched.B} S_pre={decode_sched.S_pre} "
                f"page={decode_sched.page} max_seq={decode_sched.max_seq} "
                f"kv_pages={decode_sched.kv.capacity_pages}]")
    elif args.model:
        pipeline, model = _model_pipeline(
            args.model, cache_dir=args.cache_dir, device=args.device,
            devices=devices)
        what = f"scoring {args.model} [device={args.device}" + (
            "]" if devices is None else f" devices={devices}]")
    else:
        pipeline = _echo_pipeline
        what = "echo (no SYNAPSEML_MODEL_PATH)"

    do_warmup = bool(args.warmup) and model is not None
    # the server binds (and answers /health 503) BEFORE warmup: k8s sees
    # the pod alive-but-unready instead of probe-timing-out a silent one
    cs = ContinuousServer(args.name, pipeline, host=args.host,
                          port=args.port,
                          batch_coalesce=args.coalesce_ms / 1e3,
                          deadline_ms=args.deadline_ms or None,
                          max_queue=args.max_queue or None,
                          ready=not (do_warmup or decode_sched is not None))
    if decode_sched is not None:
        # decode warmup is NOT optional: every (S, T) signature is
        # captured before the first sequence, or steady-state steps run
        # eagerly and the recompile sentinel fires. Single-threaded
        # startup: the readiness gate is still closed, so no handler
        # thread reads `decode` before this write
        cs.server.decode = decode_sched
        print(f"warming up [{what}] ...", flush=True)
        rep = decode_sched.warmup()
        statuses = [st for sig in rep["signatures"]
                    for st in sig["entries"]]
        decode_sched.start()
        print(f"warmup done: decode signatures={len(statuses)}, "
              f"compiled={statuses.count('compiled')}, "
              f"loaded={statuses.count('loaded')}, "
              f"errors={statuses.count('error')}", flush=True)
        cs.server.set_ready(True)
    if do_warmup:
        buckets = None if args.warmup == "auto" else \
            [int(b) for b in args.warmup.split(",") if b.strip()]
        print(f"warming up [{what}] buckets="
              f"{'auto' if buckets is None else buckets} "
              f"cache_dir={args.cache_dir!r} ...", flush=True)
        try:
            rep = model.warmup(buckets=buckets, device=args.device)
            print(f"warmup done: {rep!r}", flush=True)
        except Exception as e:  # noqa: BLE001 - degrade, never crash-loop
            # e.g. a graph input with dynamic non-batch dims warmup can't
            # synthesize: serve with lazy per-bucket programs rather than
            # CrashLoopBackOff the replica — the cold-start optimization
            # must never cost availability
            print(f"warmup skipped ({e!r}); serving with lazy "
                  "compilation", flush=True)
        cs.server.set_ready(True)
    cs.start()
    print(f"serving [{what}] on {cs.url} (GET /health ready)", flush=True)
    _slog.log("info", "server_start", server=args.name, url=cs.url,
              what=what, dump_dir=_bb.dump_dir())
    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: stop.set())
    stop.wait()
    # graceful lifecycle: readiness flips 503 (+ Retry-After on new
    # enqueues) IMMEDIATELY, accepted requests drain to real replies
    # under the deadline, then stop() 503s any stragglers explicitly —
    # a k8s rolling restart drops zero accepted requests
    print(f"SIGTERM: draining (budget {args.drain_timeout_ms:.0f}ms) ...",
          flush=True)
    drained = cs.drain(args.drain_timeout_ms)
    if decode_sched is not None:
        # in-flight sequences finish to real (streamed) replies under
        # the same budget; new /generate admissions were already shed
        # 503 by the drain gate
        drained = decode_sched.drain(
            args.drain_timeout_ms / 1e3) and drained
    print(f"drain {'complete' if drained else 'timed out'}; stopping",
          flush=True)
    cs.stop()
    if decode_sched is not None:
        decode_sched.close()
    if model is not None or decode_sched is not None:
        # the executors' threads joined and their graphs freed before
        # interpreter teardown, never during it
        _release_model(model)

    # exact zero-drop accounting for the rolling-restart contract:
    # serving_requests_total counts every request the HTTP layer saw,
    # serving_replies_total counts every terminal reply (incremented
    # before the socket send, so a dead client still counts) — equal
    # numbers prove no admitted request exited without a reply. Handler
    # threads woken by the drain/stop shed may not have been scheduled
    # yet when stop() returns (nothing joins daemon handlers), so wait
    # briefly for the counters to converge; a genuinely dropped request
    # has nothing left to wake it and still reports a mismatch
    def _accounting() -> Tuple[float, float]:
        counters = _tm.snapshot()["counters"]
        admitted = sum(v for k, v in counters.items()
                       if k.startswith("synapseml_serving_requests_total")
                       and f'server="{args.name}"' in k)
        replied = sum(v for k, v in counters.items()
                      if k.startswith("synapseml_serving_replies_total")
                      and f'server="{args.name}"' in k)
        return admitted, replied

    admitted, replied = _accounting()
    deadline = time.monotonic() + 2.0
    while admitted != replied and time.monotonic() < deadline:
        time.sleep(0.02)
        admitted, replied = _accounting()
    print(f"exit accounting: admitted={admitted:.0f} "
          f"replied={replied:.0f}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
