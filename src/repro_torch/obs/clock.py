"""One monotonic clock for the port's serving stack (from the JAX
package's ``obs/clock.py``).

Every serving timestamp routes through :func:`now`, so engine stats and
CLI timings are mutually orderable.  The injectable and replay clocks
come with the flight recorder."""
from __future__ import annotations

import time


def now() -> float:
    """Monotonic seconds — THE serving timestamp source."""
    return time.monotonic()  # repro: ignore[no-raw-time] -- this module is the port's clock
