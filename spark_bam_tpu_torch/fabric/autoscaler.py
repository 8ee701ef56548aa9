"""Latency autoscaler: one control loop per worker (reference
``spark_bam_tpu/fabric/autoscaler.py``, as it runs without ``--slo``).

Every ``autoscale_ms`` the loop reads the worker's ``stats`` op, the same
per-op p50/p99 ledger operators read, and steers on ``latency_p99_ms``
against ``FabricConfig.slo_p99_ms``:

- p99 above the target: step every knob toward its floor (halve
  ``batch_rows`` and ``tick_ms``, halve the scan and plan admission caps):
  smaller ticks finish sooner, lower caps shed earlier so queue wait stops
  compounding the tail;
- p99 under half the target: step gently toward the ceilings (+25%), to
  reclaim batching throughput while there is headroom;
- otherwise, or when no request was served since the last look (no fresh
  samples), hold: hysteresis against flapping on stale tails.

The port's workers run no SLO engine, so the reference's burn-rate block
(``stats["slo"]``, which it reads first) is not read here (ROADMAP item
15). Decisions are pure (:func:`decide_with_reason`); actuation is one
``tune`` op per move (counted ``autoscale_moves``, each reported to the
router's ledger through ``note_move``). Floors and ceilings live in
:class:`~spark_bam_tpu_torch.fabric.config.FabricConfig`; the worker
applies whatever it is told (``serve/service.py`` ``tune``).
"""

from __future__ import annotations

import asyncio


def _down(value, floor):
    return max(floor, min(value, floor) if value <= floor else value / 2)


def _up(value, ceil):
    return min(ceil, max(value + 1, value * 1.25))


def _direction(stats: dict, fcfg) -> "tuple[int, str | None]":
    """(+1 scale up, -1 scale down, 0 hold) and the cited reason, from the
    worker's ``latency_p99_ms`` against the target."""
    p99 = stats.get("latency_p99_ms")
    if p99 is None:
        return 0, None
    if p99 > fcfg.slo_p99_ms:
        return -1, f"p99={p99}ms>slo={fcfg.slo_p99_ms}ms"
    if p99 < 0.5 * fcfg.slo_p99_ms:
        return 1, f"p99={p99}ms<0.5*slo"
    return 0, None


def decide_with_reason(stats: dict,
                       fcfg) -> "tuple[dict | None, str | None]":
    """The tune fields (if any) for one worker given its ``stats``
    payload, and the reason the move cites (the router's move ledger and
    flight entries).

    Returns (None, None) to hold. Values are already clamped to the
    config's floors/ceilings; ints stay ints (batch_rows/caps), tick
    stays float.
    """
    direction, reason = _direction(stats, fcfg)
    if direction == 0:
        return None, None
    batch = int(stats.get("batch_rows") or 1)
    tick = float(stats.get("tick_ms") or 0.0)
    limits = stats.get("limits") or {}
    scanq = int(limits.get("scan") or fcfg.scanq_ceil)
    planq = int(limits.get("plan") or fcfg.planq_ceil)
    move: dict = {}
    if direction < 0:
        new_batch = int(_down(min(batch, fcfg.batch_ceil), fcfg.batch_floor))
        new_tick = float(_down(min(tick, fcfg.tick_ceil), fcfg.tick_floor))
        new_scanq = int(_down(min(scanq, fcfg.scanq_ceil), fcfg.scanq_floor))
        new_planq = int(_down(min(planq, fcfg.planq_ceil), fcfg.planq_floor))
    else:
        new_batch = int(_up(batch, fcfg.batch_ceil))
        new_tick = min(float(_up(tick, fcfg.tick_ceil)), fcfg.tick_ceil)
        new_scanq = int(_up(scanq, fcfg.scanq_ceil))
        new_planq = int(_up(planq, fcfg.planq_ceil))
    if new_batch != batch:
        move["batch_rows"] = new_batch
    if abs(new_tick - tick) > 1e-9:
        move["tick_ms"] = round(new_tick, 3)
    if new_scanq != scanq:
        move["scan_queue"] = new_scanq
    if new_planq != planq:
        move["plan_queue"] = new_planq
    return (move, reason) if move else (None, None)


def decide(stats: dict, fcfg) -> "dict | None":
    """Just the move dict (or None to hold)."""
    move, _ = decide_with_reason(stats, fcfg)
    return move


async def autoscale_worker(link, fcfg, count, note_move=None,
                           hold=None) -> None:
    """Control loop for one worker link; ``count`` is the router's
    counter hook (``autoscale_moves``), ``note_move`` its move-ledger
    hook — called with ``{worker, move, reason}`` per actuated move.
    ``hold`` (optional callable → bool) freezes actuation while true:
    the router holds during brownout, because stats measured under
    edge-shed traffic would read as idleness and downscale the exact
    capacity the fleet needs back."""
    prev_served = None
    while True:
        await asyncio.sleep(fcfg.autoscale_ms / 1000.0)
        if not link.healthy or link.draining:
            continue
        if hold is not None and hold():
            continue
        try:
            stats = await link.request({"op": "stats"})
        except asyncio.CancelledError:
            raise
        except Exception:
            continue
        served = stats.get("served")
        if prev_served is not None and served == prev_served:
            continue                 # no fresh samples → hold
        prev_served = served
        move, reason = decide_with_reason(stats, fcfg)
        if not move:
            continue
        try:
            await link.request({"op": "tune", **move})
            count("autoscale_moves")
            if note_move is not None:
                note_move({"worker": link.wid, "move": move,
                           "reason": reason})
        except asyncio.CancelledError:
            raise
        except Exception:
            continue
