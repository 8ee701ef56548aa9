"""Per-worker health: ping probes, circuit breakers, flap suppression
(reference ``spark_bam_tpu/fabric/health.py``).

One :func:`monitor_worker` task per link runs forever on the router's
loop, driving the link's
:class:`~spark_bam_tpu_torch.fabric.resilience.CircuitBreaker`. Healthy workers (breaker CLOSED) get a ``ping`` every
``probe_ms``; a probe that times out (``probe_timeout_ms``) or errors
ejects the worker — the breaker OPENs, placement stops immediately, and
pending requests on the link fail with ``WorkerLost`` so they can fail
over instead of hanging on a wedged (SIGSTOPped) worker. An OPEN breaker
admits exactly one HALF_OPEN reconnect+ping probe after its delay
(``eject_ms`` doubling to ``eject_max_ms``); success reinstates the
worker (breaker CLOSED), failure re-opens with a longer delay. A worker
that flaps — ``flap_k`` openings inside ``flap_window_ms`` — is held
down for at least ``holddown_ms`` per re-probe so a crash-looping
process can't oscillate in and out of rotation.

Connection-level death (reader EOF on a kill) does NOT wait for a probe:
the link marks itself unhealthy the moment the socket dies
(``WorkerLink._fail``), so failover latency is bounded by TCP teardown,
not the probe period. The monitor's job is then just reinstatement.
"""

from __future__ import annotations

import asyncio

from spark_bam_tpu_torch.fabric.resilience import CLOSED, CircuitBreaker
from spark_bam_tpu_torch.obs import flight


async def _ping(link, timeout_s: float) -> None:
    await asyncio.wait_for(link.request({"op": "ping"}), timeout=timeout_s)


async def monitor_worker(link, fcfg, count) -> None:
    """Probe loop for one worker link; ``count`` is the router's counter
    hook (``ejected`` / ``reinstated`` / ``breaker.*``). Ejections and
    reinstatements also land in the flight-recorder ring — a postmortem
    dump shows the health history around the death, not just the death
    itself."""
    breaker = link.breaker = CircuitBreaker(fcfg)
    timeout_s = fcfg.probe_timeout_ms / 1000.0

    def _opened(cause: str, exc=None) -> None:
        breaker.record_failure(cause)
        count("ejected")
        count("breaker.opened")
        if breaker.holddowns > _opened.holddowns:
            _opened.holddowns = breaker.holddowns
            count("breaker.holddowns")
            flight.record("breaker_holddown", worker=link.wid,
                          delay_ms=round(breaker.delay_s() * 1000, 1))
        flight.record("ejected", worker=link.wid, cause=cause,
                      **({"error": str(exc)} if exc is not None else {}))

    _opened.holddowns = 0

    while True:
        if link.healthy:
            await asyncio.sleep(fcfg.probe_ms / 1000.0)
            if not link.healthy:
                # Died between probes (connection-level ejection).
                _opened("connection")
                continue
            try:
                await _ping(link, timeout_s)
            except asyncio.CancelledError:
                raise
            except Exception as exc:
                # eject() fails pending futures with WorkerLost — a
                # wedged worker holds requests forever otherwise.
                link.eject(exc)
                _opened("probe", exc)
        else:
            if breaker.state == CLOSED:
                # _fail() marked the link dead but nothing opened the
                # breaker yet (death raced the healthy-branch sleep).
                _opened("connection")
            await asyncio.sleep(max(breaker.delay_s(), 0.001))
            if not breaker.allow_probe():
                continue  # still not due (clock granularity); re-sleep
            count("breaker.half_open")
            try:
                await link.connect()
                # connect() marks the link healthy for the request path;
                # a HALF_OPEN probe must not re-admit placement before
                # the ping proves the worker ANSWERS — a wedged
                # (SIGSTOPped) worker accepts connections happily.
                link.healthy = False
                await _ping(link, timeout_s)
                link.healthy = True
                breaker.record_success()
                count("reinstated")
                count("breaker.closed")
                flight.record("reinstated", worker=link.wid)
            except asyncio.CancelledError:
                raise
            except Exception as exc:
                link.healthy = False
                link._teardown()
                _opened("reprobe", exc)
