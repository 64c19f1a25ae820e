"""Self-speculative decoding: sparse rungs draft, the dense rung verifies
(port of the JAX package's ``serving/spec.py``).

WiSparse's training-free sparsity gives a family of cheaper variants of
the same model (the ladder rungs) sharing weights and KV cache with the
dense model.  Per engine decode action the :class:`SpecDecoder` runs
``gamma`` sequential single-token draft steps at the (sparse) drafter
rung, then one batched length-``(gamma+1)`` verify forward at the
verifier rung, accepts each slot's longest draft prefix matching the
verifier's greedy tokens, commits the verifier-faithful KV the verify
wrote in place, and rolls the rejected suffix back out of the pool
(``SlotKVPool.rollback_many``).

Greedy-verify semantics: every committed token (accepted drafts and the
verifier's bonus token after the last accepted draft) is exactly the
token the verifier's own greedy decode would have produced, so the
output stream is token-identical to verifier-only decode.  The drafter's
fidelity moves only the speed (through the acceptance rate).

Built-once discipline (``repro_torch.serving.graphs``): drafting replays
the drafter rung's captured decode step, feeding each draft to the next
replay as a device copy with no host read in between; the verify is one
captured graph per reachable gamma, built by ``Engine.warmup()``, so
rung and gamma switches build nothing.  A round reads the host twice:
once after the drafts (to split draft time from verify time, as the
reference blocks there) and once for the drafts and the verify argmax.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import obs
from repro_torch.models import api
from repro_torch.serving.controller import SpecController
from repro_torch.serving.graphs import VerifySteps


@dataclasses.dataclass(frozen=True)
class SpecConfig:
    """Speculative-decoding execution config.

    gamma          draft tokens per verify (the classic draft length).
    drafter_rung   ladder rung that drafts (must be sparser, higher, than
                   the verifier).
    verifier_rung  ladder rung whose greedy tokens the output is
                   guaranteed to match (0 = densest; the engine serves
                   prefill and emits tokens at this rung).  Its decode
                   policy must be dense (the engine checks): under a
                   sparse policy the shared top-k channel set depends on
                   the call's token rows, so the multi-token verify and
                   single-token decode would diverge.
    adaptive       arm the :class:`SpecController`: tune gamma within
                   [gamma_min, gamma_max] (and, with ``adapt_drafter``,
                   the drafter rung) from the acceptance EWMA.
    accept_ewma_alpha / raise_at / lower_at / dwell
                   controller tuning (see :class:`SpecController`).
    """

    gamma: int = 2
    drafter_rung: int = 1
    verifier_rung: int = 0
    adaptive: bool = False
    gamma_min: int = 1
    gamma_max: int = 4
    adapt_drafter: bool = False
    accept_ewma_alpha: float = 0.2
    raise_at: float = 0.8
    lower_at: float = 0.4
    dwell: int = 8

    def __post_init__(self):
        if self.gamma < 1:
            raise ValueError(f"gamma must be >= 1, got {self.gamma}")
        if self.verifier_rung < 0:
            raise ValueError(
                f"verifier_rung must be >= 0, got {self.verifier_rung}")
        if self.drafter_rung <= self.verifier_rung:
            raise ValueError(
                f"drafter_rung {self.drafter_rung} must be a sparser "
                f"(higher) rung than verifier_rung {self.verifier_rung} — "
                "drafting at the verifier's own cost cannot speed it up")
        if self.adaptive and not \
                1 <= self.gamma_min <= self.gamma <= self.gamma_max:
            raise ValueError(
                f"adaptive spec needs 1 <= gamma_min <= gamma <= gamma_max,"
                f" got ({self.gamma_min}, {self.gamma}, {self.gamma_max})")
        if self.adapt_drafter and not self.adaptive:
            raise ValueError("adapt_drafter needs adaptive=True")

    @property
    def max_gamma(self) -> int:
        """Largest draft length any operating point can use (sizes the
        pool slack and the warmup sweep)."""
        return self.gamma_max if self.adaptive else self.gamma

    def gammas(self):
        """Every draft length warmup must build a verify for."""
        if self.adaptive:
            return range(self.gamma_min, self.gamma_max + 1)
        return (self.gamma,)


class SpecDecoder:
    """Per-engine speculative decoding loop (created by the engine when
    ``EngineConfig.spec`` is set).

    Owns the verify steps (:class:`VerifySteps`, one per gamma), the
    acceptance EWMA and, in adaptive mode, the :class:`SpecController`.
    ``step()`` replaces the engine's plain batched decode step and may
    emit up to ``gamma + 1`` tokens per decoding request."""

    def __init__(self, engine, scfg: SpecConfig):
        self.engine = engine
        self.scfg = scfg
        self.gamma = scfg.gamma
        self.drafter_rung = scfg.drafter_rung
        self.verifier_rung = scfg.verifier_rung
        self._accept_ewma = None      # non-adaptive mode only; adaptive
        #                               mode's EWMA lives in the controller
        _, _, ver_pol = engine._rung_phases[scfg.verifier_rung]
        self.verify_steps = VerifySteps(
            api.make_verify_step(engine.cfg), engine.params,
            engine.pool.caches, ver_pol, engine._rung_sp[scfg.verifier_rung],
            list(scfg.gammas()), engine.ecfg.max_slots, engine.pool_len,
            engine.graph_space)
        self.controller = None
        if scfg.adaptive:
            self.controller = SpecController(
                scfg.gamma, scfg.gamma_min, scfg.gamma_max,
                drafter_rung=scfg.drafter_rung,
                drafter_min=scfg.verifier_rung + 1,
                drafter_max=engine.num_rungs - 1,
                adapt_drafter=scfg.adapt_drafter,
                alpha=scfg.accept_ewma_alpha, raise_at=scfg.raise_at,
                lower_at=scfg.lower_at, dwell=scfg.dwell)

    # ------------------------------------------------------------------
    @property
    def accept_ewma(self):
        """Acceptance EWMA: the controller's (reset per switch) in
        adaptive mode, the decoder's lifetime EWMA otherwise."""
        if self.controller is not None:
            return self.controller.accept_ewma
        return self._accept_ewma

    def set_gamma(self, gamma: int) -> None:
        """Pin a draft length (tests / manual tuning).  Must be one the
        warmup built a verify for."""
        if gamma not in self.scfg.gammas():
            raise ValueError(
                f"gamma {gamma} outside the precompiled set "
                f"{list(self.scfg.gammas())}; other values would retrace "
                "the verify executable")
        self.gamma = gamma
        if self.controller is not None:     # else the next round's update
            self.controller.gamma = gamma   # would clobber the pin

    # ------------------------------------------------------------------
    def step(self) -> None:
        """One spec round: gamma batched draft steps at the drafter rung,
        one batched verify at the verifier rung, then per-slot
        accept/commit/rollback."""
        eng = self.engine
        decoding = dict(eng.scheduler.decoding)
        if not decoding:
            return
        g = self.gamma
        S = eng.ecfg.max_slots
        dev = eng.device

        # inactive slots window into the pool's slack region (beyond every
        # reachable real position, like the plain decode scratch slot)
        start = np.full((S,), eng.pool_len - (g + 1), np.int64)
        cur = np.zeros((S,), np.int64)
        active = np.zeros((S,), np.float32)
        for slot, rs in decoding.items():
            start[slot] = rs.position
            cur[slot] = rs.last_token
            active[slot] = 1.0
        pos = torch.from_numpy(start[None] + np.arange(g + 1)[:, None]).to(
            dev)                                            # (g+1, S)
        cur_d = torch.from_numpy(cur).to(dev)
        act_d = torch.from_numpy(active).to(dev)

        # --- draft: g replays of the drafter's decode step -------------
        # each draft feeds the next as a device copy; the replay's static
        # output is overwritten by the next replay, so each column is
        # copied out first
        t0 = obs.now()
        drafts = torch.empty((S, g), dtype=torch.long, device=dev)
        toks = cur_d
        for i in range(g):
            nxt, _ = eng._decode.replay(self.drafter_rung, toks, pos[i],
                                        act_d)
            drafts[:, i].copy_(nxt)
            toks = drafts[:, i]
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t1 = obs.now()

        # --- verify: one batched (g+1)-token forward --------------------
        vtokens = torch.cat([cur_d[:, None], drafts], 1)
        weights = act_d[:, None].expand(S, g + 1)
        ver, _ = self.verify_steps(g, vtokens, pos[0], weights)
        both = torch.cat([drafts, ver], 1).cpu().numpy()    # one host read
        drafts_h, ver_h = both[:, :g], both[:, g:]
        t2 = obs.now()

        stats = eng.stats
        stats.spec_rounds += 1
        stats.spec_draft_steps += g
        stats.decode_steps += g
        stats.spec_draft_s.append(t1 - t0)
        stats.spec_verify_s.append(t2 - t1)

        # --- accept, then one batched rollback, then emit ---------------
        accept_fracs = []
        commits = {}
        rollbacks = {}
        for slot, rs in decoding.items():
            d, v = drafts_h[slot], ver_h[slot]
            n_acc = 0
            while n_acc < g and d[n_acc] == v[n_acc]:
                n_acc += 1
            # accepted drafts + the verifier's bonus token: exactly the
            # verifier's own greedy continuation
            cand = [int(t) for t in d[:n_acc]] + [int(v[n_acc])]
            # the request's budget and EOS truncate the commit so that
            # only the last committed token can finish the request
            # (matching plain decode's one-finish-check-per-step)
            m = min(len(cand), rs.request.max_new_tokens - len(rs.tokens))
            eos = rs.request.eos_id
            if eos is not None and eos in cand[:m]:
                m = cand[:m].index(eos) + 1
            # the verify wrote g+1 verifier-faithful positions at
            # [start, start+g]; keep the m committed ones (the last
            # committed token's own KV is written by the next round, like
            # plain decode) and truncate the rest out of the cache
            eng.pool.commit(slot, g + 1)
            rollbacks[slot] = g + 1 - m
            commits[slot] = (rs, cand[:m], n_acc)
        eng.pool.rollback_many(rollbacks)
        t3 = obs.now()
        # the round's decode cost includes the rollback: real per-round
        # work plain decode doesn't pay
        stats.decode_time += t3 - t0

        for slot, (rs, committed, n_acc) in commits.items():
            m = len(committed)
            accept_fracs.append(n_acc / g)
            stats.spec_verifies += 1
            stats.spec_draft_tokens += g
            stats.spec_accepted_tokens += n_acc
            stats.spec_committed_tokens += m
            stats.spec_accepted_per_verify.append(n_acc)
            if rs.last_token_time is not None:
                gap = (t3 - rs.last_token_time) / m   # amortized TPOT
                for _ in range(m):
                    stats.tpot_s.append(gap)
            rs.last_token_time = t3
            for tok in committed:
                eng._emit(rs, tok)
            eng._maybe_finish(rs, committed[-1])

        # --- adapt -------------------------------------------------------
        frac = float(np.mean(accept_fracs))
        if self.controller is not None:
            self.gamma, self.drafter_rung = self.controller.update(frac)
        else:
            a = self.scfg.accept_ewma_alpha
            self._accept_ewma = frac if self._accept_ewma is None else \
                (1 - a) * self._accept_ewma + a * frac

    # ------------------------------------------------------------------
    def snapshot(self) -> dict:
        """Spec state: gamma, drafter rung, acceptance EWMA (and the
        controller's switch count in adaptive mode)."""
        ewma = self.accept_ewma
        out = {
            "spec_gamma": self.gamma,
            "spec_drafter_rung": self.drafter_rung,
            "spec_accept_ewma": None if ewma is None else round(ewma, 4),
        }
        if self.controller is not None:
            out["spec_switches"] = len(self.controller.transitions)
        return out
