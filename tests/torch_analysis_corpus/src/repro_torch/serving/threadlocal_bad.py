"""Thread-local execution state in the serving tree.  A thread-local
mode read inside a captured step is invisible to the step's key, so two
threads serving different modes would replay one graph.  Serving state
must ride in the :class:`SparsityPolicy` value instead."""
import contextvars
import threading

_MODE = threading.local()  # EXPECT: no-thread-local-serving

_PHASE = contextvars.ContextVar("phase", default="decode")  # EXPECT: no-thread-local-serving


def set_mode(mode: str) -> None:
    _MODE.value = mode


def current_mode() -> str:
    return getattr(_MODE, "value", "dense")
