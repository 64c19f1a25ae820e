"""The clock module holds the port's only raw clock reads: exempt from
``no-raw-time``."""
import time


def now() -> float:
    return time.monotonic()
