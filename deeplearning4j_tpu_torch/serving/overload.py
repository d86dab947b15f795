"""SLO-aware overload control: shed, reject early, brown out.

Counterpart of ``deeplearning4j_tpu/serving/overload.py`` (pure host
policy, the same knobs and decisions).

An overloaded serving engine that admits everything serves nobody: the
queue grows, every request's time-to-first-token blows through the SLO,
and prefill work is wasted on requests that will be dead on delivery.
This module is the admission-side counterweight, three independent
levers in escalating order of reach (under pressure degrade FEATURES,
never availability):

1. **Shedding** — the engine feeds observed queue-wait / TTFT samples
   to the controller; when a configured SLO is in *sustained* breach
   (a breach fraction over a sample window, not one slow request), the
   lowest-priority most-recent queued work is shed with a typed
   :class:`~.errors.ServingOverloaded` until the queue is back to a
   servable depth. Shedding queued (never-prefilled) work costs zero
   device cycles and immediately shortens every survivor's wait.
2. **Early rejection** — a request submitted with a deadline that
   provably cannot be met given the queue estimate (position-ahead ÷
   observed admission rate, or an injected estimator) is refused AT
   SUBMIT with ``ServingOverloaded``: failing in O(1) at the front
   door beats spending a prefill dispatch on a corpse and beats making
   the caller discover the timeout themselves `deadline` seconds later.
3. **Brownout** — under KV-page pressure the engine degrades features
   in a fixed ladder: drop the speculation gamma → disable speculation
   → stop prefix-cache inserts; each rung restores automatically (with
   hysteresis) when pressure clears. Every rung keeps the dispatch
   shapes canonical: a reduced gamma pads the SAME widened verify
   dispatch with fewer real proposals.

The controller is pure host-side policy: the engine owns all device
work and all handle failures; the controller only decides. Sampling
state is lock-guarded because ``reject_at_submit`` runs on caller
threads while observations arrive from the engine's step loop.
"""

from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

__all__ = ["OverloadConfig", "OverloadController"]

#: brownout rungs (the ladder order is part of the contract)
BROWNOUT_OFF = 0
BROWNOUT_REDUCED_GAMMA = 1
BROWNOUT_NO_SPECULATION = 2
BROWNOUT_NO_PREFIX_INSERTS = 3


@dataclass
class OverloadConfig:
    """Knobs for :class:`OverloadController`.

    ``ttft_slo_s`` / ``queue_wait_slo_s``: the latency objectives; a
    sustained breach of EITHER (at least ``breach_fraction`` of the
    last ``breach_window`` admissions over the objective, with at least
    ``min_samples`` observed) triggers shedding down to
    ``shed_to_depth`` queued requests (default: the engine's slot
    count — one ready successor per slot is servable depth; deeper is
    speculation about the future).

    ``early_reject``: refuse deadline-carrying submits whose deadline
    cannot be met given ``queue_eta`` (an injectable
    ``(engine, request, now) -> seconds`` estimator; default: queue
    position ahead ÷ the observed admission rate over the sample
    window, never rejecting before ``min_samples`` admissions have
    calibrated the rate).

    ``brownout_enter_fracs``: free-page fractions at which rungs 1..3
    of the brownout ladder engage; a rung releases when the free
    fraction recovers past its threshold + ``brownout_clear_margin``
    (hysteresis — a pool oscillating at a threshold must not flap;
    the release point is capped at 1.0 so a fully free pool always
    releases even when threshold + margin exceeds it).
    ``brownout_gamma`` is the reduced speculation gamma at rung 1
    (default: half the configured gamma, at least 1)."""

    ttft_slo_s: Optional[float] = None
    queue_wait_slo_s: Optional[float] = None
    breach_window: int = 16
    breach_fraction: float = 0.5
    min_samples: int = 4
    shed_to_depth: Optional[int] = None
    early_reject: bool = True
    queue_eta: Optional[Callable] = None
    #: admission-rate samples older than this never inform eta(): after
    #: a traffic lull the stale span would read as a dismal rate and
    #: spuriously reject meetable deadlines at the next burst's start
    rate_horizon_s: float = 60.0
    brownout_enter_fracs: Tuple[float, float, float] = (0.15, 0.08, 0.03)
    brownout_clear_margin: float = 0.10
    brownout_gamma: Optional[int] = None

    def __post_init__(self):
        if not 0.0 < self.breach_fraction <= 1.0:
            raise ValueError(f"breach_fraction must be in (0, 1], got "
                             f"{self.breach_fraction}")
        if self.breach_window < 1:
            raise ValueError(f"breach_window must be >= 1, got "
                             f"{self.breach_window}")
        if self.min_samples < 1:
            raise ValueError(f"min_samples must be >= 1, got "
                             f"{self.min_samples}")
        fr = self.brownout_enter_fracs
        if len(fr) != 3 or not all(
                0.0 <= b <= a <= 1.0
                for a, b in zip(fr, fr[1:])) or not 0 <= fr[0] <= 1:
            raise ValueError(
                "brownout_enter_fracs must be 3 non-increasing "
                f"fractions in [0, 1], got {fr!r}")
        if self.brownout_clear_margin < 0:
            raise ValueError(f"brownout_clear_margin must be >= 0, got "
                             f"{self.brownout_clear_margin}")
        if self.brownout_gamma is not None and self.brownout_gamma < 1:
            raise ValueError(f"brownout_gamma must be >= 1, got "
                             f"{self.brownout_gamma}")


class OverloadController:
    """Decides shedding, early rejection, and the brownout rung for one
    engine. All inputs are observations the engine pushes; all outputs
    are decisions the engine executes."""

    def __init__(self, config: Optional[OverloadConfig] = None):
        self.config = config if config is not None else OverloadConfig()
        w = self.config.breach_window
        self._mu = threading.Lock()
        self._engine = None
        self._ttft = deque(maxlen=w)
        self._queue_wait = deque(maxlen=w)
        self._admit_t = deque(maxlen=max(2, w))
        self.level = BROWNOUT_OFF
        self.shed_total = 0
        self.early_rejected_total = 0

    def _bind(self, engine) -> None:
        """One controller per engine: the sample windows are SLO
        evidence for a SINGLE engine's traffic — shared across two
        engines, one engine's slow TTFTs would shed the other's queue
        and skew its admission-rate estimate. (The same contract as
        ``EngineSupervisor._bind``.)"""
        if self._engine is not None and self._engine is not engine:
            raise ValueError(
                "one OverloadController controls one engine — construct "
                "a fresh controller (or pass OverloadConfig) per "
                "GenerationEngine")
        self._engine = engine

    # -- observations (engine step loop) -------------------------------
    def observe_queue_wait(self, seconds: float) -> None:
        with self._mu:
            self._queue_wait.append(float(seconds))

    def observe_ttft(self, seconds: float, now: float) -> None:
        """One admission completed prefill: record its TTFT and the
        admission instant (the rate base for the queue estimate)."""
        with self._mu:
            self._ttft.append(float(seconds))
            self._admit_t.append(float(now))

    def reset_observations(self) -> None:
        """Drop the sample windows (breach evidence + admission-rate
        base). The engine calls this after ``warmup()``: synthetic
        warmup admissions carry COMPILE time in their TTFT and would
        otherwise read as a sustained breach (and a dismal admission
        rate) the moment real traffic arrives."""
        with self._mu:
            self._ttft.clear()
            self._queue_wait.clear()
            self._admit_t.clear()

    # -- shedding -------------------------------------------------------
    def _breached(self, samples, slo: Optional[float]) -> bool:
        if slo is None or len(samples) < self.config.min_samples:
            return False
        over = sum(1 for s in samples if s > slo)
        return over >= self.config.breach_fraction * len(samples)

    def sustained_breach(self) -> bool:
        with self._mu:
            return (self._breached(self._ttft, self.config.ttft_slo_s)
                    or self._breached(self._queue_wait,
                                      self.config.queue_wait_slo_s))

    def shed(self, engine) -> List:
        """Victims to fail with ``ServingOverloaded`` this step: under a
        sustained breach, the queue's lowest-priority tail beyond the
        servable depth. The breach window resets after a shed so the
        next round needs fresh post-shed evidence (one burst of slow
        admissions must not bleed the queue dry for `window` more
        steps)."""
        if not self.sustained_breach():
            return []
        keep = self.config.shed_to_depth
        if keep is None:
            keep = engine.slots
        victims = engine._pending.shed_lowest(keep)
        if victims:
            with self._mu:
                self._ttft.clear()
                self._queue_wait.clear()
            self.shed_total += len(victims)
        return victims

    # -- early rejection ------------------------------------------------
    def eta(self, engine, req, now: float) -> Optional[float]:
        """Estimated seconds until `req` would be admitted, or None when
        no estimate is available yet (never reject on ignorance)."""
        if self.config.queue_eta is not None:
            return self.config.queue_eta(engine, req, now)
        with self._mu:
            # age out lull-stale samples: a 10-minute-old admission
            # must not stretch the span into a near-zero rate
            cut = now - self.config.rate_horizon_s
            while self._admit_t and self._admit_t[0] < cut:
                self._admit_t.popleft()
            if len(self._admit_t) < max(2, self.config.min_samples):
                return None
            span = self._admit_t[-1] - self._admit_t[0]
            if span <= 0:
                return None
            rate = (len(self._admit_t) - 1) / span
        ahead = engine._pending.depth_ahead(req.priority)
        return ahead / rate

    def reject_at_submit(self, engine, req,
                         now: float) -> Optional[str]:
        """A reason string when `req`'s deadline provably cannot be met
        given the queue estimate (the engine raises ServingOverloaded
        with it); None admits."""
        if not self.config.early_reject or req.deadline is None:
            return None
        est = self.eta(engine, req, now)
        if est is None:
            return None
        if now + est >= req.deadline:
            with self._mu:       # submit runs on caller threads
                self.early_rejected_total += 1
            return (f"deadline cannot be met: ~{est:.3f}s queue ahead "
                    f"vs {req.deadline - now:.3f}s of deadline budget "
                    f"(early rejection beats wasted prefill)")
        return None

    # -- brownout -------------------------------------------------------
    def brownout_gamma(self, gamma: int) -> int:
        g = self.config.brownout_gamma
        return max(1, gamma // 2) if g is None else min(g, gamma)

    def brownout_level(self, engine) -> int:
        """Current rung of the brownout ladder for `engine`, with
        hysteresis: rungs engage at ``brownout_enter_fracs`` free-page
        fractions and release ``brownout_clear_margin`` above them.
        Engines without a paged pool never brown out (no page-pressure
        signal)."""
        pool = engine.page_pool
        if pool is None or pool.usable <= 0:
            return BROWNOUT_OFF
        free_frac = pool.free_count() / pool.usable
        fracs = self.config.brownout_enter_fracs
        desired = BROWNOUT_OFF
        for rung, frac in enumerate(fracs, start=1):
            if free_frac < frac:
                desired = rung
        if desired > self.level:
            self.level = desired
        else:
            margin = self.config.brownout_clear_margin
            while self.level > BROWNOUT_OFF and free_frac >= min(
                    1.0, fracs[self.level - 1] + margin):
                self.level -= 1
        return self.level
