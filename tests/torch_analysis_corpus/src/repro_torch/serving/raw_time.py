"""Raw clock reads in the serving tree.  Every serving timestamp must
flow through ``repro_torch.obs.clock`` so the flight recorder can
capture the stream live and replay it bit-identically."""
import time
from time import perf_counter  # EXPECT: no-raw-time


def stamp_request(req: dict) -> dict:
    req["arrival"] = time.time()  # EXPECT: no-raw-time
    return req


def measure(fn):
    t0 = time.monotonic()  # EXPECT: no-raw-time
    fn()
    return time.monotonic() - t0  # EXPECT: no-raw-time


def stamp_suppressed(req: dict) -> dict:
    # a justified escape hatch: this site is outside any replayed path
    req["wall"] = time.time()  # repro: ignore[no-raw-time]
    req["t"] = perf_counter()
    time.sleep(0)
    return req
