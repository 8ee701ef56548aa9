"""Fleet resilience primitives: retry budgets, circuit breakers, brownout
(reference ``spark_bam_tpu/fabric/resilience.py``, the same state machines).

Three small mechanisms the router composes so a worker storm degrades the
fleet gracefully instead of amplifying into one:

- :class:`RetryBudget` — a router-wide token bucket every failover
  re-dispatch and paced shed-retry round must spend from. The bucket
  refills proportionally to *admitted* request volume
  (``budget_rate`` tokens per routed request, capped at ``budget``),
  so steady-state retry amplification is bounded by ``1 + budget_rate``
  no matter how hard the chaos layer pushes — retries can't outnumber
  the traffic that earned them.

- :class:`CircuitBreaker` — per-worker-link closed/open/half-open state
  behind fabric/health.py's ejection and doubling re-probe: a failure opens the breaker for ``eject_ms`` (doubling to
  the ``eject_max_ms`` ceiling), expiry admits exactly ONE half-open
  probe, and its outcome either closes the breaker or re-opens it with
  a longer delay. Flap suppression rides on top: ``flap_k`` openings
  within ``flap_window_ms`` put the breaker in hold-down
  (``holddown_ms`` floor on the re-probe delay), so a crash-looping
  worker can't oscillate in and out of rotation taking a slice of live
  traffic down with it on every lap.

- :func:`brownout_level` — the shed-by-admission-class decision: when
  the healthy fraction of the fleet falls under ``brownout_frac`` the
  router sheds ``scan``-class ops (the expensive ones) at the edge with
  a typed ``Overloaded`` before their queues collapse; under half that
  fraction — or when the retry budget is simultaneously exhausted — it
  sheds every work op. Cheap control-plane ops keep answering so
  operators can see the brownout they are in.

Everything here runs on the router's single event loop, so no locks;
the breaker takes an injectable clock for deterministic tests.
"""

from __future__ import annotations

import time
from collections import deque

#: circuit-breaker states (strings: they appear in flight-recorder events
#: and ``stats`` payloads).
CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"


class RetryBudget:
    """Router-wide token bucket gating retry/failover amplification.

    ``note_request()`` on every admitted request earns ``rate`` tokens
    (capped at ``capacity``); ``try_spend()`` before every re-dispatch
    consumes one. A bucket that starts at ``capacity`` lets a cold
    fleet absorb an initial burst of failovers (worker respawn storms)
    while the steady-state amplification bound stays ``1 + rate``.
    """

    def __init__(self, capacity: int, rate: float):
        self.capacity = float(capacity)
        self.rate = float(rate)
        self.tokens = float(capacity)
        self.spent = 0
        self.denied = 0

    def note_request(self) -> None:
        self.tokens = min(self.capacity, self.tokens + self.rate)

    def try_spend(self, n: float = 1.0) -> bool:
        if self.tokens >= n:
            self.tokens -= n
            self.spent += 1
            return True
        self.denied += 1
        return False

    @property
    def exhausted(self) -> bool:
        return self.tokens < 1.0


class CircuitBreaker:
    """Closed/open/half-open breaker for one worker link.

    State machine (driven by fabric/health.py's monitor loop):

    - ``record_failure`` → OPEN until ``now + backoff``; backoff doubles
      per consecutive failure, capped at ``eject_max_ms``. When the
      recent-openings window shows ``flap_k`` openings inside
      ``flap_window_ms``, the backoff is floored at ``holddown_ms``
      (flap suppression) and ``holddowns`` increments.
    - ``allow_probe`` → True exactly once per OPEN period after the
      backoff expires, moving the breaker HALF_OPEN (probe in flight).
    - ``record_success`` → CLOSED, backoff reset to ``eject_ms``.
    """

    def __init__(self, fcfg, clock=time.monotonic):
        self._clock = clock
        self._eject_s = fcfg.eject_ms / 1000.0
        self._eject_max_s = fcfg.eject_max_ms / 1000.0
        self._flap_k = int(fcfg.flap_k)
        self._flap_window_s = fcfg.flap_window_ms / 1000.0
        self._holddown_s = fcfg.holddown_ms / 1000.0
        self.state = CLOSED
        self.backoff_s = self._eject_s
        self.open_until = 0.0
        self.opened = 0
        self.holddowns = 0
        self._recent: "deque[float]" = deque(maxlen=max(1, self._flap_k))

    def record_failure(self, cause: str = "probe") -> str:
        """Open (or re-open) the breaker; returns the new state. The
        first failure opens at ``eject_ms``; consecutive failures double
        toward the cap; flapping floors the delay at ``holddown_ms``."""
        now = self._clock()
        if self.state == CLOSED:
            self.backoff_s = self._eject_s
        else:
            self.backoff_s = min(self.backoff_s * 2, self._eject_max_s)
        self._recent.append(now)
        delay = self.backoff_s
        if (len(self._recent) == self._flap_k
                and now - self._recent[0] <= self._flap_window_s
                and delay < self._holddown_s):
            delay = self._holddown_s
            self.holddowns += 1
        self.state = OPEN
        self.open_until = now + delay
        self.opened += 1
        return self.state

    def allow_probe(self) -> bool:
        """True when an OPEN breaker's delay has expired — transitions to
        HALF_OPEN so only one probe flies per open period."""
        if self.state == OPEN and self._clock() >= self.open_until:
            self.state = HALF_OPEN
            return True
        return False

    def record_success(self) -> str:
        self.state = CLOSED
        self.backoff_s = self._eject_s
        self.open_until = 0.0
        return self.state

    def delay_s(self) -> float:
        """Seconds until the next probe may fly (0 when due/closed)."""
        if self.state != OPEN:
            return 0.0
        return max(0.0, self.open_until - self._clock())


def brownout_level(healthy: int, total: int, fcfg,
                   budget_exhausted: bool = False) -> int:
    """Shed level for the current fleet state: 0 = serve everything,
    1 = shed ``scan``-class work ops, 2 = shed all work ops. Pure — the
    router evaluates it per routed request from live link state."""
    if not fcfg.brownout or total <= 0 or healthy <= 0:
        return 0
    frac = healthy / total
    if frac > fcfg.brownout_frac:
        return 0
    if frac <= fcfg.brownout_frac / 2 or budget_exhausted:
        return 2
    return 1
