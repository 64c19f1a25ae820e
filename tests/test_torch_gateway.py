"""The port's HTTP gateway against the JAX package's, over the same
JAX-initialised weights (reduced llama31_8b, f32, ``device="cpu"``).

Requests go one after another to a JAX gateway and a port gateway; the
raw HTTP responses (status line, headers and body, JSON or chunked SSE)
must be byte-equal, and so must the 400/404/429/503/504 answers (429's
``Retry-After`` is a time estimate: both must carry one of at least 1).
``/v1/health`` has the same keys (and, idle, the same bytes), and
``/v1/debug/flight`` gives the JAX gateway's bytes: its 404 without a
recorder, and with one (both engines on one scripted clock) the same
ring and the same dump.  Also: concurrent ``/metrics`` scrapes during
decode (every scrape valid, counters never fall), drain closing the
engine, an engine-thread exception answered with 500 and re-raised, the
serve CLI's accepted and refused flags against the JAX CLI's messages
(``tests/test_gateway.py``), its metrics
sinks, and ``serve --gateway`` in a subprocess draining an in-flight
streaming request on SIGTERM and exiting 0, and dumping its flight ring
on SIGUSR1 into a dump that replays."""
import json
import os
import signal
import socket
import subprocess
import sys
import threading

import jax
import numpy as np
import pytest

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.data import DataConfig, SyntheticLM
from repro.launch import serve as jserve
from repro.models import api as japi
from repro.serving import Engine as JEngine
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import SchedulerConfig as JSchedulerConfig
from repro.serving.gateway import Gateway as JGateway
from repro_torch import obs
from repro_torch.configs import get_config, reduced
from repro_torch.launch import serve
from repro_torch.models import params as P
from repro_torch.serving import (Engine, EngineConfig, Gateway,
                                 SchedulerConfig)
from torch_threads import ONE_THREAD_ENV
from torch_threads import one_thread_module  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def model():
    jcfg = jreduced(jget_config("llama31_8b"))
    jparams = japi.init_model(jcfg, 0)
    return dict(jcfg=jcfg, jparams=jparams,
                cfg=reduced(get_config("llama31_8b")),
                params=P.from_numpy(jax.tree_util.tree_map(np.asarray,
                                                           jparams)))


def _prompt(cfg, seq, step=0):
    return [int(t) for t in np.asarray(SyntheticLM(
        DataConfig(cfg.vocab_size, seq, 1)).batch(step))[0]]


def _engines(model, scheduler=None, **kw):
    """The same engine config in both packages -> (JAX, port)."""
    kw = dict(dict(max_slots=2, max_len=32, prefill_chunk=8), **kw)
    return (JEngine(model["jparams"], model["jcfg"], JEngineConfig(
                scheduler=None if scheduler is None
                else JSchedulerConfig(**scheduler), **kw)),
            Engine(model["params"], model["cfg"], EngineConfig(
                scheduler=None if scheduler is None
                else SchedulerConfig(**scheduler), **kw), device="cpu"))


def _raw(port, method, path, body=None, timeout=60):
    """One request on a raw socket -> the whole response, bytes (the
    gateway closes every connection after its response)."""
    payload = b"" if body is None else json.dumps(body).encode()
    head = f"{method} {path} HTTP/1.1\r\nHost: x\r\n"
    if body is not None:
        head += ("Content-Type: application/json\r\n"
                 f"Content-Length: {len(payload)}\r\n")
    with socket.create_connection(("127.0.0.1", port), timeout=timeout) as s:
        s.sendall(head.encode() + b"\r\n" + payload)
        raw = b""
        while True:
            chunk = s.recv(65536)
            if not chunk:
                return raw
            raw += chunk


def _split(raw):
    head, _, body = raw.partition(b"\r\n\r\n")
    lines = head.decode("latin-1").split("\r\n")
    headers = dict(ln.split(": ", 1) for ln in lines[1:])
    return int(lines[0].split()[1]), headers, body


def _sse_events(body):
    """De-chunk an SSE body -> its data payloads."""
    out, buf = b"", body
    while buf:
        size, _, buf = buf.partition(b"\r\n")
        n = int(size, 16)
        if n == 0:
            break
        out += buf[:n]
        buf = buf[n + 2:]
    return [e[len("data: "):] for e in out.decode().split("\n\n") if e]


@pytest.fixture(scope="module")
def gateways(model):
    jeng, teng = _engines(model, dict(max_queue=8, preemption=True))
    pair = [JGateway(jeng, port=0), Gateway(teng, port=0)]
    ports = [g.start() for g in pair]
    yield pair, ports
    for g in pair:
        g.stop()


# ---------------------------------------------------------------------------
# the port gateway against the JAX gateway, byte for byte
# ---------------------------------------------------------------------------

def test_generate_bodies_are_byte_equal_to_jax(gateways, model):
    (_, tgw), ports = gateways
    cfg = model["cfg"]
    requests = [
        {"prompt": _prompt(cfg, 10), "max_new_tokens": 5,
         "priority": "interactive"},
        {"prompt": _prompt(cfg, 8, step=3), "max_new_tokens": 3,
         "stream": True},
        {"prompt": _prompt(cfg, 13, step=4), "max_new_tokens": 6,
         "stream": True, "tenant": "chat", "priority": "best_effort"},
        {"prompt": _prompt(cfg, 9, step=5), "max_new_tokens": 4,
         "queue_deadline_s": 30},
    ]
    first = _prompt(cfg, 11, step=6)
    jraw = _raw(ports[0], "POST", "/v1/generate",
                {"prompt": first, "max_new_tokens": 6})
    eos = json.loads(_split(jraw)[2])["tokens"][2]
    requests.append({"prompt": first, "max_new_tokens": 6, "eos_id": eos,
                     "stream": True})
    for req in requests:
        j = _raw(ports[0], "POST", "/v1/generate", req)
        t = _raw(ports[1], "POST", "/v1/generate", req)
        assert t == j, req
        status, headers, body = _split(t)
        assert status == 200
        if req.get("stream"):
            assert headers["Transfer-Encoding"] == "chunked"
            events = _sse_events(body)
            assert events[-1] == "[DONE]"
            done = json.loads(events[-2])
            toks = [json.loads(e)["index"] for e in events[:-2]]
            assert toks == list(range(done["usage"]["completion_tokens"]))
        else:
            out = json.loads(body)
            assert out["usage"]["completion_tokens"] == len(out["tokens"])
    assert json.loads(_split(_raw(ports[1], "POST", "/v1/generate", {
        "prompt": first, "max_new_tokens": 6, "eos_id": eos}))[2])[
            "finish_reason"] == "eos"
    assert tgw.engine.stats.finished == len(requests) + 1


@pytest.mark.parametrize("method,path,body", [
    ("POST", "/v1/generate", {}),
    ("POST", "/v1/generate", {"prompt": []}),
    ("POST", "/v1/generate", {"prompt": [1.5]}),
    ("POST", "/v1/generate", {"prompt": [True]}),
    ("POST", "/v1/generate", {"prompt": [1], "max_new_tokens": 0}),
    ("POST", "/v1/generate", {"prompt": [1], "priority": "vip"}),
    ("POST", "/v1/generate", {"prompt": [1], "tenant": ""}),
    ("POST", "/v1/generate", {"prompt": [1], "eos_id": "x"}),
    ("POST", "/v1/generate", {"prompt": [1], "queue_deadline_s": -1}),
    ("POST", "/v1/generate", [1, 2]),
    ("POST", "/v1/generate", {"prompt": list(range(40))}),
    ("GET", "/nope", None),
    ("GET", "/v1/health", None),
])
def test_error_and_health_answers_equal_jax(gateways, method, path, body):
    _, ports = gateways
    j = _raw(ports[0], method, path, body)
    t = _raw(ports[1], method, path, body)
    assert t == j
    status = _split(t)[0]
    if path == "/v1/health":
        assert status == 200
        assert set(json.loads(_split(t)[2])) == {
            "status", "queue_depth", "occupancy", "suspended", "rung"}
    else:
        assert status in (400, 404) and "error" in json.loads(_split(t)[2])


def test_debug_flight_is_404_without_a_recorder(gateways):
    _, ports = gateways
    raws = [_raw(port, "GET", "/v1/debug/flight") for port in ports]
    assert raws[1] == raws[0]
    status, _, body = _split(raws[1])
    assert status == 404 and "flight-record" in json.loads(body)["error"]


class _ScriptedClock:
    """The n-th read returns ``100 + n/250``, in both packages alike."""

    def __init__(self):
        self.n = 0

    def now(self, site=""):
        self.n += 1
        return 100.0 + self.n / 250


def test_debug_flight_serves_the_ring_and_a_dump_like_jax(model, tmp_path):
    """With a recorder (and both engines on one scripted clock) the raw
    ``/v1/debug/flight`` answer is the JAX gateway's byte for byte: the
    same ring after the same request, the same counters, and a dump whose
    file holds the same records."""
    from repro.obs import Telemetry as JTelemetry
    from repro.obs.flight import FlightRecorder as JFlightRecorder
    kw = dict(max_slots=2, max_len=32, prefill_chunk=8)
    raws, dumps = [], []
    for pkg in ("jax", "port"):
        # equal-length directory names keep Content-Length comparable
        dump_dir = tmp_path / {"jax": "jaxdump", "port": "ptdump0"}[pkg]
        if pkg == "jax":
            fr = JFlightRecorder(dump_dir=str(dump_dir))
            eng = JEngine(model["jparams"], model["jcfg"],
                          JEngineConfig(**kw), None,
                          telemetry=JTelemetry(flight=fr),
                          clock=_ScriptedClock())
            gw = JGateway(eng, port=0)
        else:
            fr = obs.FlightRecorder(dump_dir=str(dump_dir))
            eng = Engine(model["params"], model["cfg"], EngineConfig(**kw),
                         device="cpu", telemetry=obs.Telemetry(flight=fr),
                         clock=_ScriptedClock())
            gw = Gateway(eng, port=0)
        port = gw.start()
        try:
            _raw(port, "POST", "/v1/generate",
                 {"prompt": _prompt(model["cfg"], 9), "max_new_tokens": 4})
            raws.append(_raw(port, "GET", "/v1/debug/flight"))
        finally:
            gw.stop()
        dumps.append((dump_dir / "flight-http-0.jsonl").read_bytes())
    # the dump path differs by directory; everything else is equal
    assert raws[1].replace(b"ptdump0", b"jaxdump") == raws[0]
    assert dumps[1] == dumps[0]
    status, _, body = _split(raws[1])
    snap = json.loads(body)
    assert status == 200 and snap["complete"] and snap["dropped"] == 0
    assert snap["count"] == snap["retained"] == len(snap["records"])
    assert [r["k"] for r in snap["records"]][:3] == [
        "header", "submit", "clock"]
    assert snap["records"][-1]["k"] == "finish"
    assert snap["dump_path"].endswith("flight-http-0.jsonl")


def test_debug_flight_copy_survives_concurrent_appends(model):
    """The handler copies the ring while the engine thread appends: a
    reader on another thread never sees "deque mutated during
    iteration", and every copy is a consistent prefix of the history."""
    fr = obs.FlightRecorder(capacity=64)
    fr._attached = True
    stop = threading.Event()

    def writer():
        i = 0
        while not stop.is_set():
            fr._append({"k": "clock", "t": float(i), "s": "x"})
            i += 1

    th = threading.Thread(target=writer)
    th.start()
    try:
        for _ in range(300):
            snap = fr.debug_snapshot()
            ts = [r["t"] for r in snap["records"]]
            assert ts == sorted(ts)
            assert snap["retained"] == len(ts) <= 64
            if ts:
                assert ts[-1] == snap["count"] - 1
    finally:
        stop.set()
        th.join()


def test_draining_answers_503_like_jax(gateways, model):
    (jgw, tgw), ports = gateways
    req = {"prompt": _prompt(model["cfg"], 8), "max_new_tokens": 2}
    raws = []
    for gw, port in zip((jgw, tgw), ports):
        gw._draining = True                 # as after SIGTERM, listener open
        try:
            raws.append(_raw(port, "POST", "/v1/generate", req))
        finally:
            gw._draining = False
    assert raws[0] == raws[1]
    status, headers, _ = _split(raws[1])
    assert status == 503 and headers["Retry-After"] == "1"


def _busy(eng, prompt, gen):
    """Occupy the engine's only slot with a long request (admitted and
    prefilled before the gateway starts)."""
    rs = eng.submit(prompt, gen)
    eng.step()
    return rs


def test_queue_full_is_429_and_deadline_is_504_like_jax(model):
    """One slot held by a long request: with the queue at its bound a
    submission is refused (429 + Retry-After, counted in ``rejected``);
    without a bound, one whose queue deadline passes gets 504."""
    cfg = model["cfg"]
    long_prompt = _prompt(cfg, 12, step=7)
    out = {}
    for case in ("429", "504"):
        sched = dict(max_queue=1) if case == "429" else None
        raws = []
        for eng in _engines(model, sched, max_slots=1, max_len=64):
            gw = (Gateway if isinstance(eng, Engine) else JGateway)(eng)
            _busy(eng, long_prompt, 48)
            if case == "429":
                eng.submit(_prompt(cfg, 6, step=8), 2)     # fills the queue
            port = gw.start()
            try:
                raws.append(_raw(port, "POST", "/v1/generate", {
                    "prompt": _prompt(cfg, 7, step=9), "max_new_tokens": 2,
                    **({"queue_deadline_s": 1e-3} if case == "504" else {})}))
            finally:
                gw.stop()
            assert eng.stats.rejected == (1 if case == "429" else 0)
            assert eng.stats.expired == (1 if case == "504" else 0)
        out[case] = [_split(r) for r in raws]
    (js, jh, jb), (ts, th, tb) = out["429"]
    assert js == ts == 429 and jb == tb
    assert int(th["Retry-After"]) >= 1 and int(jh["Retry-After"]) >= 1
    (js, _, jb), (ts, _, tb) = out["504"]
    assert js == ts == 504 and jb == tb
    assert json.loads(tb)["error"] == "queue_deadline_exceeded"


# ---------------------------------------------------------------------------
# the port gateway alone
# ---------------------------------------------------------------------------

def _counters(text):
    types, samples = obs.parse_exposition(text)
    return {n: v for n, _lb, v in samples if types.get(n) == "counter"}


def test_concurrent_scrapes_during_decode(gateways, model):
    """/metrics from several threads while a generation decodes: every
    scrape is a valid exposition, no counter ever falls, and the
    generation gives the tokens of the same request run alone."""
    (_, tgw), ports = gateways
    port = ports[1]
    req = {"prompt": _prompt(model["cfg"], 10, step=11),
           "max_new_tokens": 16}
    alone = json.loads(_split(_raw(port, "POST", "/v1/generate", req))[2])
    scrapes, gen_out, errors = [], [], []
    done = threading.Event()

    def scrape():
        try:
            while not done.is_set():
                status, _, body = _split(_raw(port, "GET", "/metrics"))
                assert status == 200
                obs.validate_exposition(body.decode())
                scrapes.append(_counters(body.decode()))
        except Exception as e:                      # noqa: BLE001
            errors.append(e)

    def generate():
        try:
            gen_out.append(json.loads(_split(_raw(
                port, "POST", "/v1/generate", req))[2]))
        except Exception as e:                      # noqa: BLE001
            errors.append(e)
        finally:
            done.set()

    threads = [threading.Thread(target=scrape) for _ in range(4)]
    g = threading.Thread(target=generate)
    g.start()
    for t in threads:
        t.start()
    g.join(timeout=120)
    for t in threads:
        t.join(timeout=60)
    assert not g.is_alive() and not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert gen_out == [alone] and len(scrapes) >= 4
    for a, b in zip(scrapes, scrapes[1:]):
        assert b.keys() == a.keys()
    final = _counters(tgw.engine.metrics_exposition())
    for s in scrapes:
        assert all(s[k] <= final[k] for k in s)


def test_scrapes_from_one_thread_never_fall(gateways, model):
    (_, tgw), ports = gateways
    req = {"prompt": _prompt(model["cfg"], 9, step=12), "max_new_tokens": 12}
    done = threading.Event()
    seen = []

    def generate():
        try:
            _raw(ports[1], "POST", "/v1/generate", req)
        finally:
            done.set()

    g = threading.Thread(target=generate)
    g.start()
    while not done.is_set():
        seen.append(_counters(_split(_raw(ports[1], "GET", "/metrics"))[2]
                              .decode()))
    g.join(timeout=60)
    seen.append(_counters(tgw.engine.metrics_exposition()))
    for a, b in zip(seen, seen[1:]):
        assert all(b[k] >= a[k] for k in a), (a, b)


def test_drain_closes_the_engine_and_the_listener(model):
    _, eng = _engines(model)
    gw = Gateway(eng, port=0)
    assert eng.decode_retraces_after_warmup == 0    # built before serving
    port = gw.start()
    status, _, body = _split(_raw(port, "POST", "/v1/generate", {
        "prompt": _prompt(model["cfg"], 8), "max_new_tokens": 2}))
    assert status == 200
    gw.stop()
    assert eng._closed and gw.error is None
    with pytest.raises(ConnectionRefusedError):
        socket.create_connection(("127.0.0.1", port), timeout=2)


def test_engine_thread_exception_is_not_swallowed(model):
    """A step that raises: the waiting request gets 500, the exception
    reaches ``threading.excepthook`` and ``stop()`` raises from it, and
    the engine is still closed (its sinks flushed)."""
    _, eng = _engines(model)
    gw = Gateway(eng, port=0)
    real_step, calls = eng.step, []

    def step():
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError("boom on the engine thread")
        return real_step()

    eng.step = step
    hooked = []
    old_hook = threading.excepthook
    threading.excepthook = hooked.append
    try:
        port = gw.start()
        status, _, body = _split(_raw(port, "POST", "/v1/generate", {
            "prompt": _prompt(model["cfg"], 8), "max_new_tokens": 6}))
        assert status == 500 and "boom" in json.loads(body)["error"]
        with pytest.raises(RuntimeError, match="engine thread failed"):
            gw.stop()
    finally:
        threading.excepthook = old_hook
    assert [h.exc_type for h in hooked] == [RuntimeError]
    assert hooked[0].thread.name == "gateway-engine"
    assert isinstance(gw.error, RuntimeError) and eng._closed


def test_gateway_steps_the_engine_on_its_own_thread(model):
    _, eng = _engines(model)
    gw = Gateway(eng, port=0)
    threads, real_step = set(), eng.step

    def step():
        threads.add(threading.current_thread().name)
        return real_step()

    eng.step = step
    port = gw.start()
    try:
        _raw(port, "POST", "/v1/generate", {
            "prompt": _prompt(model["cfg"], 8), "max_new_tokens": 3})
    finally:
        gw.stop()
    assert threads == {"gateway-engine"}


# ---------------------------------------------------------------------------
# the serve CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("argv,msg", [
    (["--spec-gamma", "2"], "needs --ladder"),
    (["--spec-adaptive"], "--spec-gamma"),
    (["--ladder", "x.npz", "--spec-gamma", "2", "--slo-tpot-p95", "0.1"],
     "conflicts"),
    (["--rung", "3"], "needs --ladder"),
    (["--sparsity", "1.5"], "sparsity"),
    (["--gen", "0"], "--gen"),
    (["--chunk", "0"], "--chunk"),
    (["--max-queue", "-1"], "--max-queue"),
    (["--gateway", "--metrics-out", "m.jsonl"], "owns the engine loop"),
    (["--gateway", "--metrics-port", "9090"], "already serves /metrics"),
    (["--gateway", "--gateway-port", "-1"], "gateway-port must be >= 0"),
    (["--gateway-port", "9999"], "need --gateway"),
    (["--gateway-host", "0.0.0.0"], "need --gateway"),
    (["--quality-probe-rate", "1.5"], "quality-probe-rate"),
    (["--quality-probe-rate", "-0.1"], "quality-probe-rate"),
    (["--quality-drift-threshold", "0.3"], "quality-probe-rate > 0"),
    (["--quality-probe-rate", "0.5", "--quality-drift-threshold", "1.0"],
     "quality-drift-threshold must be in"),
    (["--quality-probe-rate", "0.5", "--quality-drift-threshold", "0.0"],
     "quality-drift-threshold must be in"),
    (["--flight-record", "f.jsonl", "--flight-ring", "0"],
     "--flight-ring must be > 0"),
    (["--flight-record", "f.jsonl", "--flight-ring", "-8"],
     "--flight-ring must be > 0"),
    (["--flight-ring", "1024"], "needs --flight-record"),
    (["--flight-dump-dir", "/tmp"], "needs --flight-record"),
    (["--gateway", "--legacy"], "engine path"),
    (["--preemption", "--legacy"], "engine path"),
    (["--max-queue", "4", "--legacy"], "engine path"),
    (["--quality-probe-rate", "0.5", "--legacy"], "engine path"),
    (["--flight-record", "f.jsonl", "--legacy"], "engine path"),
    (["--prefix-cache", "--legacy"], "engine path"),
    (["--legacy", "--trace-out", "t.json"], "telemetry flags"),
    (["--legacy", "--events-out", "e.jsonl"], "telemetry flags"),
    (["--legacy", "--metrics-out", "m.jsonl"], "telemetry flags"),
    (["--legacy", "--metrics-port", "9090"], "telemetry flags"),
    (["--legacy", "--gateway", "--metrics-out", "m.jsonl"],
     "telemetry flags"),
])
def test_serve_cli_rejects_bad_flags_like_jax(argv, msg):
    errs = []
    for mod in (serve, jserve):
        with pytest.raises(SystemExit, match=msg) as exc:
            mod.validate_args(mod.build_parser().parse_args(argv))
        errs.append(str(exc.value))
    if argv[0] != "--sparsity":     # the port's range is [0, 1)
        assert errs[0] == errs[1]


@pytest.mark.parametrize("argv,msg", [
    (["--metrics-every", "0"], "--metrics-every"),
    (["--max-slots", "-1"], "--max-slots"),
    (["--max-len", "-2"], "--max-len"),
])
def test_serve_cli_rejects_the_ports_own_bad_flags(argv, msg):
    with pytest.raises(SystemExit, match=msg):
        serve.validate_args(serve.build_parser().parse_args(argv))


def test_serve_cli_accepts_good_flags():
    for argv in ([], ["--gateway", "--max-queue", "8", "--preemption"],
                 ["--ladder", "x.npz", "--rung", "1"],
                 ["--ladder", "x.npz", "--spec-gamma", "2",
                  "--spec-drafter", "1"],
                 ["--gateway", "--gateway-port", "0", "--trace-out",
                  "t.json", "--events-out", "e.jsonl", "--profile-dir",
                  "p"],
                 ["--metrics-out", "m.prom", "--metrics-format", "prom",
                  "--metrics-every", "4", "--metrics-port", "9100"],
                 ["--max-slots", "4", "--max-len", "128", "--chunk", "16",
                  "--prefill-strategy", "whole"],
                 ["--quality-probe-rate", "0.25"],
                 ["--quality-probe-rate", "1.0",
                  "--quality-drift-threshold", "0.3"],
                 ["--flight-record"],          # bounded ring, no sink
                 ["--flight-record", "f.jsonl", "--flight-ring", "1024",
                  "--flight-dump-dir", ROOT],
                 ["--gateway", "--flight-record", "f.jsonl"]):
        for mod in (serve, jserve):
            mod.validate_args(mod.build_parser().parse_args(argv))


def test_serve_cli_flight_dump_dir_must_be_writable_dir_like_jax(tmp_path):
    not_dir = tmp_path / "plainfile"
    not_dir.write_text("x")
    errs = []
    for mod in (serve, jserve):
        args = mod.build_parser().parse_args(
            ["--flight-record", "f.jsonl", "--flight-dump-dir",
             str(not_dir)])
        with pytest.raises(SystemExit, match="not a directory") as exc:
            mod.validate_args(args)
        errs.append(str(exc.value))
    assert errs[0] == errs[1]


def test_serve_cli_rung_range_checked_against_ladder():
    for mod in (serve, jserve):
        args = mod.build_parser().parse_args(["--ladder", "x.npz", "--rung",
                                              "3"])
        with pytest.raises(SystemExit, match="out of range"):
            mod.validate_rungs(args, num_rungs=2)
        args = mod.build_parser().parse_args(
            ["--ladder", "x.npz", "--spec-gamma", "2", "--spec-drafter", "5"])
        with pytest.raises(SystemExit, match="spec-drafter 5 out of range"):
            mod.validate_rungs(args, num_rungs=2)


@pytest.mark.parametrize("fmt", ["jsonl", "prom"])
def test_serve_cli_metrics_out(tmp_path, capsys, fmt):
    path = str(tmp_path / f"m.{fmt}")
    out = serve.main(["--reduced", "--device", "cpu", "--sparsity", "0",
                      "--batch", "3", "--max-slots", "2", "--prompt-len",
                      "12", "--gen", "4", "--chunk", "8", "--metrics-out",
                      path, "--metrics-format", fmt, "--metrics-every", "2",
                      "--trace-out", str(tmp_path / "t.json"),
                      "--events-out", str(tmp_path / "e.jsonl")])
    assert sorted(out) == [0, 1, 2]
    text = open(path).read()
    if fmt == "prom":
        assert obs.validate_exposition(text) > 0
        assert "repro_requests_finished_total 3" in text
    else:
        snaps = [json.loads(ln) for ln in text.splitlines()]
        assert len(snaps) >= 2 and snaps[-1]["finished"] == 3
        assert all(s["schema_version"] == 7 for s in snaps)
    with open(tmp_path / "t.json") as f:
        assert obs.validate_chrome_trace(json.load(f)) > 0
    printed = capsys.readouterr().out
    assert "wrote" in printed and "logged" in printed


def test_serve_gateway_drains_on_sigterm(tmp_path):
    """``serve --gateway --gateway-port 0`` prints its port; a streaming
    request in flight when SIGTERM arrives still completes, the process
    exits 0, and the trace and event files are complete."""
    trace, events = str(tmp_path / "t.json"), str(tmp_path / "e.jsonl")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               **ONE_THREAD_ENV)
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", "--reduced",
         "--device", "cpu", "--sparsity", "0", "--gateway",
         "--gateway-port", "0", "--max-slots", "2", "--prompt-len", "16",
         "--gen", "32", "--trace-out", trace, "--events-out", events],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=ROOT)
    try:
        port = None
        for line in proc.stdout:
            if line.startswith("gateway listening on http://"):
                port = int(line.split()[3].rsplit(":", 1)[1])
                break
        assert port is not None, "the gateway never printed its port"
        payload = json.dumps({"prompt": list(range(1, 17)),
                              "max_new_tokens": 24, "stream": True}).encode()
        with socket.create_connection(("127.0.0.1", port), timeout=60) as s:
            s.sendall(b"POST /v1/generate HTTP/1.1\r\nHost: x\r\n"
                      b"Content-Length: " + str(len(payload)).encode()
                      + b"\r\n\r\n" + payload)
            raw = s.recv(65536)
            while b'"token"' not in raw:            # generation under way
                raw += s.recv(65536)
            proc.send_signal(signal.SIGTERM)
            while True:
                chunk = s.recv(65536)
                if not chunk:
                    break
                raw += chunk
        rest = proc.communicate(timeout=120)[0]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, rest
    events_seen = _sse_events(_split(raw)[2])
    assert events_seen[-1] == "[DONE]"
    assert json.loads(events_seen[-2])["usage"]["completion_tokens"] == 24
    assert "gateway drained" in rest
    with open(trace) as f:
        doc = json.load(f)
    assert obs.validate_chrome_trace(doc) > 0
    assert {"submit", "finish"} <= {e["name"] for e in doc["traceEvents"]}
    with open(events) as f:
        kinds = [json.loads(ln)["kind"] for ln in f]
    assert kinds and set(kinds) == {"compile"}


def test_serve_gateway_dumps_its_flight_ring_on_sigusr1(tmp_path):
    """``serve --gateway --flight-record PATH --flight-dump-dir D``: after
    one request, SIGUSR1 writes the ring to ``D/flight-sigusr1-0.jsonl``;
    SIGTERM then seals the sink; both files replay through ``python -m
    repro_torch.obs.flight.replay`` (the engine rebuilt from the header)
    with exit 0."""
    sink, dump_dir = str(tmp_path / "f.jsonl"), tmp_path / "dumps"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               **ONE_THREAD_ENV)
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", "--reduced",
         "--device", "cpu", "--sparsity", "0", "--gateway",
         "--gateway-port", "0", "--max-slots", "2", "--prompt-len", "16",
         "--gen", "16", "--flight-record", sink, "--flight-dump-dir",
         str(dump_dir)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=ROOT)
    try:
        port = None
        for line in proc.stdout:
            if line.startswith("gateway listening on http://"):
                port = int(line.split()[3].rsplit(":", 1)[1])
                break
        assert port is not None, "the gateway never printed its port"
        status, _, body = _split(_raw(port, "POST", "/v1/generate", {
            "prompt": list(range(1, 13)), "max_new_tokens": 6}))
        assert status == 200
        proc.send_signal(signal.SIGUSR1)
        dump = dump_dir / "flight-sigusr1-0.jsonl"
        for _ in range(600):
            if dump.exists() and dump.read_text().count("\n") > 2:
                break
            threading.Event().wait(0.05)
        proc.send_signal(signal.SIGTERM)
        rest = proc.communicate(timeout=120)[0]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, rest
    with open(dump) as f:
        prologue = json.loads(f.readline())
    assert prologue["reason"] == "sigusr1" and prologue["complete"]
    for path in (str(dump), sink):
        rep = subprocess.run(
            [sys.executable, "-m", "repro_torch.obs.flight.replay", path,
             "--device", "cpu"], capture_output=True, text=True, env=env,
            cwd=ROOT, timeout=300)
        assert rep.returncode == 0, rep.stdout + rep.stderr
        report = json.loads(rep.stdout)
        assert report["ok"] and report["requests"] == 1
        assert report["tokens"] == 6
