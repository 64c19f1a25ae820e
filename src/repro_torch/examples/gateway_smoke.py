"""End-to-end gateway smoke (the counterpart of the JAX package's
``examples/gateway_smoke.py``, its CI ``gateway-smoke`` job).

Launches ``repro_torch.launch.serve --reduced --gateway`` as a real
subprocess on a random free port, then exercises the full client-visible
surface:

1. polls ``GET /v1/health`` until every step is built and it serves,
2. streams one request over a raw HTTP/1.1 socket and asserts the SSE
   protocol end to end: chunked transfer framing, one ``data:`` event
   per token with monotonically increasing ``index``, a ``done`` event
   carrying the usage payload, the ``data: [DONE]`` sentinel, and the
   terminating zero-length chunk,
3. scrapes ``GET /metrics`` and validates the exposition with
   ``repro_torch.obs.validate_exposition``,
4. sends SIGTERM and asserts the server drains and exits 0.

Doubles as a reference client: everything here is stdlib plus one
validation helper, so it also documents the wire protocol the gateway
speaks.  Run it as a module::

    PYTHONPATH=src python -m repro_torch.examples.gateway_smoke [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request

import repro_torch
from repro_torch.obs import validate_exposition
from repro_torch.obs.clock import now

STARTUP_TIMEOUT_S = 300.0
DRAIN_TIMEOUT_S = 120.0


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def child_env() -> dict:
    """This process's environment with the package's ``src`` directory
    first on ``PYTHONPATH``, so a ``python -m repro_torch...`` child
    imports this tree."""
    src = os.path.dirname(os.path.dirname(os.path.abspath(
        repro_torch.__file__)))
    path = os.environ.get("PYTHONPATH")
    return dict(os.environ,
                PYTHONPATH=src if not path else src + os.pathsep + path)


def wait_healthy(port: int, deadline: float, proc=None) -> None:
    url = f"http://127.0.0.1:{port}/v1/health"
    while now() < deadline:
        if proc is not None and proc.poll() is not None:
            raise SystemExit(f"the server exited {proc.returncode} before "
                             "it became healthy")
        try:
            with urllib.request.urlopen(url, timeout=2) as resp:
                health = json.load(resp)
            if health["status"] != "ok":
                raise SystemExit(f"unhealthy gateway: {health}")
            return
        except (urllib.error.URLError, ConnectionError, OSError):
            time.sleep(0.5)
    raise SystemExit("gateway never became healthy")


def stream_one(port: int, prompt: list, max_new: int) -> None:
    """One streaming generate over a raw socket; asserts SSE framing."""
    payload = json.dumps({"prompt": prompt, "max_new_tokens": max_new,
                          "priority": "interactive",
                          "stream": True}).encode()
    req = (b"POST /v1/generate HTTP/1.1\r\nHost: smoke\r\n"
           b"Content-Type: application/json\r\n"
           b"Content-Length: " + str(len(payload)).encode()
           + b"\r\n\r\n" + payload)
    with socket.create_connection(("127.0.0.1", port), timeout=60) as s:
        s.sendall(req)
        raw = b""
        while b"0\r\n\r\n" not in raw:
            chunk = s.recv(65536)
            if not chunk:
                break
            raw += chunk
    head, _, rest = raw.partition(b"\r\n\r\n")
    assert b"HTTP/1.1 200" in head, head
    assert b"Transfer-Encoding: chunked" in head, head
    assert b"Content-Type: text/event-stream" in head, head
    body, buf = b"", rest                     # de-chunk
    while buf:
        size, _, buf = buf.partition(b"\r\n")
        if int(size, 16) == 0:
            break
        n = int(size, 16)
        body += buf[:n]
        buf = buf[n + 2:]
    events = [e for e in body.decode().split("\n\n") if e.strip()]
    assert events[-1] == "data: [DONE]", events[-1]
    parsed = [json.loads(e[len("data: "):]) for e in events[:-1]]
    tokens = [e for e in parsed if "token" in e]
    assert [e["index"] for e in tokens] == list(range(max_new)), tokens
    done = parsed[-1]
    assert done.get("done") is True, done
    assert done["usage"] == {"prompt_tokens": len(prompt),
                             "completion_tokens": max_new}, done
    print(f"SSE stream OK: {max_new} token events + usage payload")


def scrape_metrics(port: int) -> None:
    url = f"http://127.0.0.1:{port}/metrics"
    with urllib.request.urlopen(url, timeout=10) as resp:
        text = resp.read().decode()
    n = validate_exposition(text)
    assert n > 0
    for name in ("repro_requests_finished_total", "repro_preemptions_total",
                 "repro_queue_wait_seconds"):
        assert name in text, f"{name} missing from exposition"
    print(f"exposition: {n} samples OK")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="repro_torch.examples.gateway_smoke")
    ap.add_argument("--device", default="cuda",
                    help="the server's torch device (default cuda; cpu is "
                         "an opt-in)")
    args = ap.parse_args(argv)
    port = free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", "--reduced",
         "--device", args.device, "--gateway", "--gateway-port", str(port),
         "--max-queue", "8", "--preemption", "--prompt-len", "16", "--gen",
         "8", "--batch", "2", "--chunk", "8"], env=child_env())
    try:
        wait_healthy(port, now() + STARTUP_TIMEOUT_S, proc)
        stream_one(port, prompt=list(range(1, 9)), max_new=4)
        scrape_metrics(port)
    except BaseException:
        proc.kill()
        proc.wait()
        raise
    proc.send_signal(signal.SIGTERM)
    rc = proc.wait(timeout=DRAIN_TIMEOUT_S)
    assert rc == 0, f"gateway exited {rc}, expected a clean drain (0)"
    print("SIGTERM drain OK (exit 0)")


if __name__ == "__main__":
    main()
