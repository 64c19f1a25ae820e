"""Unguarded hot-path telemetry, which the zero-cost-when-off contract
forbids.  Named ``engine.py`` because ``hot-path-zero-cost`` audits the
engine and scheduler hot path only.  Every emit below must be dominated
by an ``is not None`` identity check on the sink."""


class FakeEngine:
    def __init__(self, obs):
        self.obs = obs

    def decode_step_bad(self, t0: float, t1: float, n: int) -> None:
        # no guard at all: attribute dispatch + kwargs dict per step
        self.obs.events.emit("decode", t0=t0, dur=t1 - t0, n=n)  # EXPECT: hot-path-zero-cost

    def decode_step_wrong_guard(self, t0: float, t1: float) -> None:
        # truthiness is not identity: an armed-but-empty sink is falsy
        if self.obs.tracer:
            self.obs.tracer.complete("decode", t0, t1)  # EXPECT: hot-path-zero-cost

    def decode_step_good(self, t0: float, t1: float) -> None:
        ev = self.obs.events
        if ev is not None:
            ev.emit("decode", t0=t0, dur=t1 - t0)

    def decode_step_early_return(self, t0: float) -> None:
        if self.obs.metrics is None:
            return
        self.obs.metrics.observe("decode.t0", t0)
