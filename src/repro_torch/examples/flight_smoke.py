"""End-to-end flight-recorder smoke (the counterpart of the JAX
package's ``examples/flight_smoke.py``, its CI ``flight-replay-smoke``
job).

Records a short gateway run of ``repro_torch.launch.serve --reduced``
with forced rung switches (a controller under an impossible TPOT SLO)
and a preemption (an interactive arrival over a full pool of best-effort
decoders), then:

1. asserts ``GET /v1/debug/flight`` serves the ring and triggers a dump,
2. drains the gateway and replays the full JSONL recording in a fresh
   process (``python -m repro_torch.obs.flight.replay``), gating
   whole-trace token bit-identity, matching rung residency, identical
   decision streams, and no step built after warmup,
3. asserts the recorded incident actually contains a ``rung_switch``
   and a ``preempt`` decision (the scenario did what it claims),
4. re-runs the replay with ``--inject-divergence`` and asserts it exits
   nonzero with a structured first-divergence report.

Run it as a module::

    PYTHONPATH=src python -m repro_torch.examples.flight_smoke \\
        --out-dir /tmp/flight [--device cpu] [--gen 1024]

``--gen`` sets the best-effort requests' new tokens (and the server's
``--gen``): they must keep both slots decoding until the interactive
arrival lands.
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.request

from repro_torch.examples.gateway_smoke import (child_env, free_port,
                                                wait_healthy)
from repro_torch.obs.clock import now

STARTUP_TIMEOUT_S = 300.0
DRAIN_TIMEOUT_S = 120.0
REPLAY_TIMEOUT_S = 300.0


def generate(port: int, prompt, max_new: int, priority: str) -> dict:
    payload = json.dumps({"prompt": list(prompt),
                          "max_new_tokens": max_new,
                          "priority": priority}).encode()
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/generate", data=payload,
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return json.load(resp)


def build_ladder(path: str, device: str) -> None:
    """Save the 3-rung uniform ladder the recorded engine serves with,
    from the weights the server builds (seed 0 on ``device``: each
    device's generator gives its own init)."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import api
    from repro_torch.sparsity import PolicyLadder
    cfg = reduced(get_config("llama31_8b"))
    params = api.init_model(cfg, 0, device=device)
    PolicyLadder.uniform(params, cfg, [0.0, 0.5, 0.7]).save(path)
    print(f"ladder artifact at {path}")


def replay(recording: str, device: str, *extra):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.obs.flight.replay", recording,
         "--device", device, *extra], capture_output=True, text=True,
        timeout=REPLAY_TIMEOUT_S, env=child_env())


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="repro_torch.examples.flight_smoke")
    ap.add_argument("--out-dir", default="/tmp/flight")
    ap.add_argument("--device", default="cuda",
                    help="the server's and the replay's torch device "
                         "(default cuda; cpu is an opt-in)")
    ap.add_argument("--gen", type=int, default=1024,
                    help="new tokens of each best-effort request")
    args = ap.parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    ladder = os.path.join(args.out_dir, "ladder.npz")
    recording = os.path.join(args.out_dir, "gateway.jsonl")
    dump_dir = os.path.join(args.out_dir, "dumps")
    build_ladder(ladder, args.device)

    port = free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", "--reduced",
         "--device", args.device, "--gateway", "--gateway-port", str(port),
         "--max-queue", "8", "--preemption", "--prompt-len", "16", "--gen",
         str(args.gen), "--batch", "2", "--chunk", "8", "--ladder", ladder,
         "--slo-tpot-p95", "1e-9", "--flight-record", recording,
         "--flight-ring", "32768", "--flight-dump-dir", dump_dir],
        env=child_env())
    try:
        wait_healthy(port, now() + STARTUP_TIMEOUT_S, proc)

        # two best-effort long generations fill both slots (``--gen``
        # tokens each keeps both decoding, so the interactive arrival
        # below lands mid-decode)...
        threads = [threading.Thread(
            target=generate,
            args=(port, range(1, 17), args.gen, "best_effort"))
            for _ in range(2)]
        for t in threads:
            t.start()
        time.sleep(0.4)
        # ...then an interactive arrival must preempt one of them
        out = generate(port, range(20, 36), 8, "interactive")
        assert len(out["tokens"]) == 8, out
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads), \
            "a best-effort request did not finish"

        # the debug endpoint serves the ring and triggers an http dump
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/v1/debug/flight",
                timeout=10) as resp:
            snap = json.load(resp)
        assert snap["count"] > 0 and snap["records"], snap["count"]
        assert snap.get("dump_path"), "debug endpoint should trigger a dump"
        print(f"debug endpoint OK: {snap['count']} records, "
              f"dump at {snap['dump_path']}")
    except BaseException:
        proc.kill()
        proc.wait()
        raise
    proc.send_signal(signal.SIGTERM)
    rc = proc.wait(timeout=DRAIN_TIMEOUT_S)
    assert rc == 0, f"gateway exited {rc}, expected a clean drain (0)"

    # the incident the recording claims: rung switches + a preemption
    with open(recording) as f:
        records = [json.loads(ln) for ln in f if ln.strip()]
    kinds = {(r.get("k"), r.get("kind")) for r in records}
    assert ("decision", "rung_switch") in kinds, "no rung switch recorded"
    assert ("decision", "preempt") in kinds, "no preemption recorded"
    n_finish = sum(1 for r in records if r.get("k") == "finish")
    print(f"recorded {len(records)} records, {n_finish} finishes, "
          f"rung switches + preemption present")

    # bit-identical replay in a fresh process
    out = replay(recording, args.device)
    print(out.stdout)
    assert out.returncode == 0, f"replay failed:\n{out.stdout}{out.stderr}"
    report = json.loads(out.stdout)
    assert report["ok"] and not report["failures"], report
    assert all(v == 0 for v in report["retraces"].values()), report
    print(f"replay OK: {report['tokens']} tokens bit-identical, "
          f"builds after warmup {report['retraces']}")

    # injected divergence must exit nonzero with a structured report
    out = replay(recording, args.device, "--inject-divergence")
    assert out.returncode == 1, \
        f"injected divergence not caught (exit {out.returncode})"
    report = json.loads(out.stdout)
    div = report["divergence"]
    assert div and "record" in div and "token_index" in div, report
    print(f"divergence report OK: request {div.get('request')} token "
          f"{div.get('token_index')} at record {div['record']}")


if __name__ == "__main__":
    main()
