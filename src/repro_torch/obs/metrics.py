"""Prometheus-style metrics (port of the JAX package's ``obs/metrics.py``;
stdlib only, copied): Counter/Gauge/Histogram instruments, a registry
rendering the text exposition format, and the adapter that exposes a
serving :class:`~repro_torch.serving.engine.Engine`'s live stats.

The metric names (``repro_*``), their label sets and the bucket layout
are the reference's, so one dashboard reads both packages.

The :class:`Histogram` keeps fixed log-spaced buckets observed in
O(log buckets) per sample, with *whole-run* exact ``count``/``sum``/
per-bucket counts at any run length: its quantiles never window (a ring
percentile does once a series outgrows its capacity) and walk the
cumulative bucket counts in O(buckets).

Rendering is snapshot-style: :func:`engine_registry` builds a fresh
registry from the engine's live counters at scrape time (off the hot
path), registering the engine's *live* histogram objects directly so
bucket counts are never copied.  A scrape reads Python numbers only,
never a tensor, so it can run on another thread while the engine steps
or captures a graph.  A histogram's ``+Inf`` bucket and ``_count`` are
both taken from one pass over its bucket counts, so a sample the engine
thread observes mid-render cannot make them disagree (the reference
reads ``count`` separately; the two render the same bytes whenever no
sample lands mid-render).

The quality-monitor and flight-recorder rows are the reference's names;
the ``repro_quality_roofline_*`` values and the decode utilization are
the port's own count (:func:`repro_torch.launch.roofline.step_costs`),
where the reference reads XLA's cost analysis.

``validate_exposition`` is the parser the tests and the chip smoke
share: it asserts the text parses, counters are non-negative, and every
histogram's ``+Inf`` bucket equals its ``_count`` with monotone
cumulative buckets.
"""
from __future__ import annotations

import math
import re
import threading
from bisect import bisect_left
from typing import Dict, List, Optional, Sequence, Tuple


def log_buckets(lo: float = 1e-5, hi: float = 10.0,
                per_decade: int = 5) -> Tuple[float, ...]:
    """Fixed log-spaced bucket upper bounds covering [lo, hi]."""
    if not 0 < lo < hi:
        raise ValueError(f"need 0 < lo < hi, got ({lo}, {hi})")
    if per_decade < 1:
        raise ValueError(f"per_decade must be >= 1, got {per_decade}")
    n = int(round(math.log10(hi / lo) * per_decade))
    return tuple(lo * 10 ** (i / per_decade) for i in range(n + 1))


# 10 microseconds .. 10 seconds, 5 buckets per decade: resolves a
# sub-millisecond decode step and a multi-second cold prefill with the
# same fixed 31-bucket layout (fixed = every engine's histograms are
# mergeable and the exposition cardinality is bounded)
DEFAULT_LATENCY_BUCKETS = log_buckets(1e-5, 10.0, per_decade=5)


class Counter:
    """Monotone counter (float-valued; Prometheus counter semantics)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, v: float = 1.0) -> None:
        if v < 0:
            raise ValueError(f"counters only go up, got inc({v})")
        self.value += v


class Gauge:
    """Set-anywhere instantaneous value."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Fixed-bucket histogram with exact whole-run aggregates.

    ``bounds`` are the bucket *upper* bounds (``le`` in the exposition);
    an implicit +Inf bucket catches overflow.  ``observe`` is one bisect
    plus three increments — cheap enough to run unconditionally next to
    the engine's ring buffers.  ``quantile`` is exact at bucket
    resolution over the whole run (it never windows), reporting the
    selected bucket's upper bound."""

    __slots__ = ("bounds", "counts", "count", "sum")

    def __init__(self, bounds: Optional[Sequence[float]] = None):
        bs = tuple(DEFAULT_LATENCY_BUCKETS if bounds is None else bounds)
        if not bs or list(bs) != sorted(bs) or len(set(bs)) != len(bs):
            raise ValueError(
                f"bounds must be non-empty and strictly increasing: {bs}")
        self.bounds = bs
        self.counts = [0] * (len(bs) + 1)      # last slot = +Inf overflow
        self.count = 0
        self.sum = 0.0

    def observe(self, v) -> None:
        v = float(v)
        self.counts[bisect_left(self.bounds, v)] += 1
        self.count += 1
        self.sum += v

    def __bool__(self) -> bool:
        return self.count > 0

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def cumulative(self) -> List[int]:
        """Cumulative bucket counts (exposition ``le`` semantics; the
        final entry equals ``count``)."""
        out, acc = [], 0
        for c in self.counts:
            acc += c
            out.append(acc)
        return out

    def quantile(self, p: float) -> float:
        """Nearest-rank percentile (``p`` in [0, 100], matching
        :func:`repro_torch.serving.metrics.percentile`'s rank convention) at
        bucket resolution: returns the selected bucket's *upper* bound —
        conservative (never under-reports a latency percentile), and
        exact when bounds are the observable values themselves (e.g.
        unit-width integer buckets).  O(buckets)."""
        if not self.count:
            return float("nan")
        rank = max(1, min(self.count,
                          int(round(p / 100.0 * (self.count - 1))) + 1))
        acc = 0
        for i, c in enumerate(self.counts):
            acc += c
            if acc >= rank:
                # overflow bucket: clamp to the last finite bound
                return self.bounds[min(i, len(self.bounds) - 1)]
        return self.bounds[-1]


_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")


class MetricsRegistry:
    """Ordered name -> instrument mapping with text-exposition rendering.

    Instruments can be created by the registry (``counter``/``gauge``/
    ``histogram``) or attached (``register_histogram``) so a live,
    externally-owned histogram — e.g. one inside ``EngineStats`` — is
    rendered without copying its buckets."""

    def __init__(self):
        self._metrics: Dict[str, Tuple[str, str, object]] = {}

    def _add(self, name: str, kind: str, help_: str, inst):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        if name in self._metrics:
            prev_kind, _, prev = self._metrics[name]
            if prev_kind != kind:
                raise ValueError(
                    f"metric {name!r} already registered as {prev_kind}")
            return prev
        self._metrics[name] = (kind, help_, inst)
        return inst

    def counter(self, name: str, help_: str = "") -> Counter:
        return self._add(name, "counter", help_, Counter())

    def gauge(self, name: str, help_: str = "") -> Gauge:
        return self._add(name, "gauge", help_, Gauge())

    def histogram(self, name: str, help_: str = "",
                  bounds: Optional[Sequence[float]] = None) -> Histogram:
        return self._add(name, "histogram", help_, Histogram(bounds))

    def register_histogram(self, name: str, hist: Histogram,
                           help_: str = "") -> Histogram:
        return self._add(name, "histogram", help_, hist)

    @staticmethod
    def _fmt(v: float) -> str:
        if v == int(v) and abs(v) < 1e15:
            return str(int(v))
        return repr(float(v))

    def render(self) -> str:
        """Prometheus text exposition format, version 0.0.4."""
        lines: List[str] = []
        for name, (kind, help_, inst) in self._metrics.items():
            if help_:
                lines.append(f"# HELP {name} {help_}")
            lines.append(f"# TYPE {name} {kind}")
            if kind in ("counter", "gauge"):
                lines.append(f"{name} {self._fmt(inst.value)}")
            else:
                cum = inst.cumulative()
                for bound, c in zip(inst.bounds, cum):
                    lines.append(
                        f'{name}_bucket{{le="{self._fmt(bound)}"}} {c}')
                # +Inf and _count from the same pass (see the module
                # docstring): equal even if a sample lands mid-render
                lines.append(f'{name}_bucket{{le="+Inf"}} {cum[-1]}')
                lines.append(f"{name}_sum {self._fmt(inst.sum)}")
                lines.append(f"{name}_count {cum[-1]}")
        return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# engine adapter
# ---------------------------------------------------------------------------

def engine_registry(engine) -> MetricsRegistry:
    """Snapshot registry over a live engine's stats (duck-typed: anything
    with ``.stats``/``.scheduler``/``.pool`` shaped like the serving
    engine).  Built fresh per scrape — cheap, off the hot path, and it
    reads Python counters only."""
    reg = MetricsRegistry()
    s = engine.stats

    def c(name, value, help_=""):
        reg.counter(name, help_).inc(value)

    def g(name, value, help_=""):
        reg.gauge(name, help_).set(value)

    c("repro_requests_submitted_total", s.submitted, "requests accepted")
    c("repro_requests_finished_total", s.finished, "requests completed")
    c("repro_prefill_chunks_total", s.prefill_chunks, "prefill steps run")
    c("repro_prefill_tokens_total", s.prefill_tokens,
      "real (non-pad) prompt tokens prefilled")
    c("repro_decode_steps_total", s.decode_steps, "batched decode steps")
    c("repro_decode_tokens_total", s.decode_tokens, "generated tokens")
    c("repro_prefill_seconds_total", s.prefill_time,
      "seconds spent in prefill steps")
    c("repro_decode_seconds_total", s.decode_time,
      "seconds spent in decode steps")
    g("repro_queue_depth", engine.scheduler.queue_depth,
      "requests waiting for a slot")
    g("repro_slot_occupancy", engine.pool.num_occupied, "occupied KV slots")
    g("repro_rung", engine.rung, "active ladder rung (0 = densest)")
    # the port builds (captures) a decode graph where the reference
    # traces; the name stays the reference's
    retr = engine.decode_retraces_after_warmup
    if retr is not None:
        c("repro_decode_retraces_after_warmup_total", retr,
          "decode executable (re)traces since warmup (invariant: 0)")

    reg.register_histogram("repro_tpot_seconds", s.tpot_hist,
                           "inter-token latency (whole-run, exact)")
    reg.register_histogram("repro_ttft_seconds", s.ttft_hist,
                           "time to first token (whole-run, exact)")
    reg.register_histogram("repro_decode_step_seconds", s.decode_step_hist,
                           "batched decode step latency")
    reg.register_histogram("repro_prefill_step_seconds", s.prefill_step_hist,
                           "prefill step latency")

    if s.spec_rounds:
        c("repro_spec_rounds_total", s.spec_rounds, "draft+verify rounds")
        c("repro_spec_draft_tokens_total", s.spec_draft_tokens,
          "drafted tokens")
        c("repro_spec_accepted_tokens_total", s.spec_accepted_tokens,
          "drafts surviving verification")
        c("repro_spec_committed_tokens_total", s.spec_committed_tokens,
          "tokens emitted by spec rounds (incl. bonus)")
        reg.register_histogram("repro_spec_draft_seconds", s.spec_draft_hist,
                               "per-round draft phase latency")
        reg.register_histogram("repro_spec_verify_seconds",
                               s.spec_verify_hist,
                               "per-round verify forward latency")
        reg.register_histogram("repro_spec_accepted_per_verify",
                               s.spec_accepted_hist,
                               "accepted draft tokens per slot per verify")
    if s.prefix_lookups:
        c("repro_prefix_lookups_total", s.prefix_lookups,
          "admissions that consulted the prefix cache")
        c("repro_prefix_hits_total", s.prefix_hits,
          "admissions that reused cached KV")
        c("repro_prefix_tokens_saved_total", s.prefix_tokens_saved,
          "prompt tokens not re-prefilled")
        c("repro_prefix_evicted_segments_total", s.prefix_evicted_segments,
          "segments dropped by LRU eviction")
    if engine.prefix_cache is not None:
        g("repro_prefix_cached_tokens", engine.prefix_cache.cached_tokens,
          "physical tokens held by the prefix cache")
        g("repro_prefix_segments", engine.prefix_cache.num_segments,
          "payload segments in the radix tree")
    if getattr(engine.ecfg, "scheduler", None) is not None:
        g("repro_suspended_requests", len(engine.scheduler.suspended),
          "preempted requests holding KV state on the host")
        c("repro_preemptions_total", s.preemptions,
          "decoding requests suspended to admit higher-priority work")
        c("repro_resumes_total", s.resumes,
          "suspended requests restored into a slot")
        c("repro_requests_rejected_total", s.rejected,
          "submissions refused with queue-full backpressure")
        c("repro_requests_expired_total", s.expired,
          "queued requests dropped at their queue-wait deadline")
        reg.register_histogram("repro_queue_wait_seconds", s.queue_wait_hist,
                               "seconds queued before admission")
        reg.register_histogram("repro_preempted_seconds", s.preempted_hist,
                               "seconds suspended before resume")
    fr = getattr(getattr(engine, "obs", None), "flight", None)
    if fr is not None:
        c("repro_flight_records_total", fr.count,
          "records captured by the flight recorder")
        c("repro_flight_dropped_total", fr.dropped,
          "records evicted from the flight ring (0 = ring-replayable)")
        c("repro_flight_dumps_total", len(fr.dumps),
          "triggered black-box dumps written")
    q = getattr(getattr(engine, "obs", None), "quality", None)
    if q is not None and q.armed:
        # per-rung families are name-suffixed: the registry renders
        # label-free samples, and rung cardinality is small and fixed
        c("repro_quality_probes_total", q.probes,
          "decode steps shadow-probed against the dense reference")
        c("repro_quality_probe_tokens_total", q.probe_tokens,
          "tokens compared by shadow probes")
        c("repro_quality_recon_passes_total", q.recon_passes,
          "online block-reconstruction evaluations")
        c("repro_quality_drift_events_total", q.drift_events,
          "saliency-drift threshold crossings")
        g("repro_quality_pressure", q.pressure,
          "active-rung saliency-drift pressure in [0, 1]")
        for r in range(len(q.agreement_hists)):
            reg.register_histogram(
                f"repro_quality_probe_agreement_rung{r}",
                q.agreement_hists[r],
                f"probe argmax-token agreement vs dense, rung {r}")
            reg.register_histogram(
                f"repro_quality_topk_overlap_rung{r}", q.overlap_hists[r],
                f"probe top-k logit-set overlap vs dense, rung {r}")
            reg.register_histogram(
                f"repro_quality_recon_error_rung{r}", q.recon_hists[r],
                f"online Eq.6 block reconstruction MSE, rung {r}")
            base = q.recon_baseline_mean(r)
            if base is not None:
                g(f"repro_quality_recon_baseline_rung{r}", base,
                  f"calibration-time mean block reconstruction MSE, "
                  f"rung {r}")
        for (phase, r), cost in sorted(q.roofline.items()):
            g(f"repro_quality_roofline_flops_{phase}_rung{r}",
              cost["flops"], f"step FLOPs, {phase} at rung {r}")
            g(f"repro_quality_roofline_bytes_{phase}_rung{r}",
              cost["bytes"], f"step bytes moved, {phase} at rung {r}")
        step_mean = s.decode_step_hist.mean if s.decode_step_hist else 0.0
        for r, util in sorted(q.decode_utilization(step_mean).items()):
            g(f"repro_quality_decode_utilization_rung{r}", util,
              f"roofline step time over measured mean decode step, "
              f"rung {r}")
    return reg


def engine_exposition(engine) -> str:
    """Prometheus text exposition for a live engine (one scrape)."""
    return engine_registry(engine).render()


# ---------------------------------------------------------------------------
# exposition validation (shared by tests and the CI artifact check)
# ---------------------------------------------------------------------------

_SAMPLE_RE = re.compile(
    r'^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)'
    r'(?:\{(?P<labels>[^}]*)\})?\s+(?P<value>\S+)$')


def parse_exposition(text: str):
    """Parse exposition text into ``(types, samples)`` where ``types``
    maps metric name -> declared type and ``samples`` is a list of
    ``(name, labels_dict, value)``."""
    types: Dict[str, str] = {}
    samples: List[Tuple[str, Dict[str, str], float]] = []
    for ln, line in enumerate(text.splitlines(), 1):
        line = line.strip()
        if not line:
            continue
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split(None, 3)
            types[name] = kind
            continue
        if line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            raise ValueError(f"line {ln}: unparseable sample {line!r}")
        labels = {}
        if m.group("labels"):
            for part in m.group("labels").split(","):
                k, _, v = part.partition("=")
                labels[k.strip()] = v.strip().strip('"')
        samples.append((m.group("name"), labels, float(m.group("value"))))
    return types, samples


def validate_exposition(text: str) -> int:
    """Assert the exposition text is well-formed: every sample belongs to
    a declared metric family, counters/gauges are finite (counters
    non-negative), and each histogram has monotone cumulative buckets
    whose ``+Inf`` entry equals its ``_count``.  Returns the number of
    samples checked; raises ``ValueError`` on any violation."""
    types, samples = parse_exposition(text)
    if not samples:
        raise ValueError("no samples in exposition")
    hist: Dict[str, Dict[str, float]] = {}
    buckets: Dict[str, List[Tuple[float, float]]] = {}
    for name, labels, value in samples:
        base = name
        for suffix in ("_bucket", "_sum", "_count"):
            if name.endswith(suffix) and name[:-len(suffix)] in types \
                    and types[name[:-len(suffix)]] == "histogram":
                base = name[:-len(suffix)]
                break
        if base not in types:
            raise ValueError(f"sample {name!r} has no # TYPE declaration")
        kind = types[base]
        if not math.isfinite(value):
            raise ValueError(f"{name}: non-finite value {value}")
        if kind == "counter" and value < 0:
            raise ValueError(f"{name}: negative counter {value}")
        if kind == "histogram":
            h = hist.setdefault(base, {})
            if name.endswith("_bucket"):
                le = labels.get("le")
                bound = math.inf if le == "+Inf" else float(le)
                buckets.setdefault(base, []).append((bound, value))
            elif name.endswith("_sum"):
                h["sum"] = value
            elif name.endswith("_count"):
                h["count"] = value
            else:
                raise ValueError(f"bare sample {name!r} for histogram")
    for base, bs in buckets.items():
        bs.sort(key=lambda bv: bv[0])
        cum = [v for _, v in bs]
        if any(b > a for a, b in zip(cum[1:], cum)):
            raise ValueError(f"{base}: cumulative buckets not monotone")
        if not bs or bs[-1][0] != math.inf:
            raise ValueError(f"{base}: missing +Inf bucket")
        h = hist.get(base, {})
        if "count" not in h or "sum" not in h:
            raise ValueError(f"{base}: missing _sum/_count")
        if bs[-1][1] != h["count"]:
            raise ValueError(
                f"{base}: +Inf bucket {bs[-1][1]} != count {h['count']}")
    return len(samples)


# ---------------------------------------------------------------------------
# optional stdlib /metrics endpoint
# ---------------------------------------------------------------------------

def serve_metrics(render_fn, port: int = 0, host: str = "127.0.0.1"):
    """Start a daemon-thread ``http.server`` exposing ``render_fn()`` at
    ``/metrics`` (and ``/``).  Returns the live ``HTTPServer`` — read
    ``server_port`` for the bound port (``port=0`` picks one), call
    ``shutdown()`` to stop."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):                      # noqa: N802 (stdlib API)
            if self.path not in ("/metrics", "/"):
                self.send_error(404)
                return
            body = render_fn().encode()
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):             # quiet: no per-scrape stderr
            pass

    server = ThreadingHTTPServer((host, port), Handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True,
                              name="repro-metrics")
    thread.start()
    return server
