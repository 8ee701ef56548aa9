"""The funnel's stage-1 kernels (``bad_op_tables``, ``survivor_table``,
``walk_lanes`` and ``count_lanes``, ``csrc/lanes.cu``) held against their
plain versions on the card. Shared by the card tests and ``chip_smoke.py``.

``hold_lanes`` runs one window through the kernels twice on the current
stream and once on a second one, on the same stage-0 inputs (the
prefilter kernel's flags, survivor list and count) as the plain versions
(``_bad_op_tables``, ``_survivor_table``, ``_walk_lanes``,
``_count_lanes``), and returns the largest difference of each kernel's
outputs (0 = bit-identical; the survivor table over the entries of the
survivors present, the rows a card leaves unwritten past them aside).

``replay_lanes`` captures the four wrappers once in a CUDA graph over a
static window with 0-d ``n``, ``at_eof``, ``lo`` and ``own`` tensors, and
replays it over each given window in turn (on the current stream or on
another), with eager launches of the same kernels on the same stream
between replays: the count's ticket counter and each replay's values must
not leak from one replay into the next. ``graph_ms`` times a call by
CUDA-graph replay (the device's time alone).
"""

from __future__ import annotations

import torch

from spark_bam_tpu_torch.tpu import kernels as K

LANE_KEYS = ("res", "fail_mask", "reads_before", "reads_parsed", "exact")


def graph_ms(fn, reps: int = 20) -> float:
    """Device time a call of ``fn``: ``reps`` calls captured in one CUDA
    graph, one replay between CUDA events, over ``reps`` (no host work in
    the figure, unlike one call between two events)."""
    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side,
                          capture_error_mode="thread_local"):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    z = torch.cuda.Event(enable_timing=True)
    a.record()
    graph.replay()
    z.record()
    z.synchronize()
    return a.elapsed_time(z) / reps


def _err(pairs) -> int:
    err = 0
    for g, w in pairs:
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"{tuple(g.shape)} {g.dtype} against "
                                 f"{tuple(w.shape)} {w.dtype}")
        if g.numel():
            err = max(err, int((g.long() - w.long()).abs().max()))
    return err


def _kernels(padded, lengths, nc, n, at_eof, lo, own, rtc, stage0):
    F, cand, n_set = stage0
    tables = K.bad_op_tables(padded, n)
    table = K.survivor_table(padded, lengths, nc, n, F, cand, n_set, tables)
    lanes = K.walk_lanes(padded, lengths, nc, n, at_eof, F, cand, n_set,
                         tables, rtc)
    count = K.count_lanes(padded, lengths, nc, n, at_eof, F, cand, n_set,
                          tables, lo, own, rtc)
    return tables, lanes, count, table, n_set


def _plain(padded, lengths, nc, n, at_eof, lo, own, rtc, stage0):
    F, cand, n_set = stage0
    tables = K._bad_op_tables(padded, n)
    table = K._survivor_table(padded, lengths, nc, n, F, cand, n_set, tables)
    lanes = K._walk_lanes(padded, lengths, nc, n, at_eof, F, cand, n_set,
                          tables, rtc)
    count = K._count_lanes(padded, lengths, nc, n, at_eof, F, cand, n_set,
                           tables, lo, own, rtc)
    return tables, lanes, count, table, n_set


def _errors(got, want) -> dict:
    live = min(int(want[4]), want[3].shape[0])
    return {"bad_op_tables": _err(zip(got[0], want[0])),
            "survivor_table": _err([(got[3][:live], want[3][:live])]),
            "walk_lanes": max(_err([(got[1][k], want[1][k])
                                    for k in LANE_KEYS]),
                              _err([(got[2], want[2])]))}


def hold_lanes(padded, lengths, nc: int, n: int, at_eof: bool, lo: int,
               own: int, rtc: int, side: torch.cuda.Stream) -> dict:
    """``{"bad_op_tables": err, "survivor_table": err, "walk_lanes": err,
    "count": (3,) list}``
    over two launches on the current stream and one on ``side``
    (``walk_lanes`` covers both of its wrappers: the per-lane outputs and
    the count)."""
    dev = padded.device
    stage0 = K.prefilter_check_flags(padded, lengths, nc, n)
    want = _plain(padded, lengths, nc, n, at_eof, lo, own, rtc, stage0)
    runs = [_kernels(padded, lengths, nc, n, at_eof, lo, own, rtc, stage0)
            for _ in range(2)]
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        runs.append(_kernels(padded, lengths, nc, n, at_eof, lo, own, rtc,
                             stage0))
    side.synchronize()
    out = {"bad_op_tables": 0, "survivor_table": 0, "walk_lanes": 0}
    for got in runs:
        for k, e in _errors(got, want).items():
            out[k] = max(out[k], e)
    out["count"] = want[2].tolist()
    return out


def replay_lanes(windows, lengths, nc: int, rtc: int,
                 stream: torch.cuda.Stream | None = None) -> dict:
    """Capture the three wrappers once and replay them over ``windows``
    (``[(padded (W + PAD,) u8 CUDA tensor, n, at_eof, lo, own), ...]``,
    one W). Returns ``{"replays": R, "max_abs_err": {kernel: e},
    "eager_err": {kernel: e}}`` against the plain versions."""
    dev = windows[0][0].device
    static = torch.zeros_like(windows[0][0])
    scalars = torch.zeros(4, dtype=torch.int32, device=dev)
    n_d, ae_d, lo_d, own_d = scalars
    stream = stream or torch.cuda.current_stream(dev)
    stream.wait_stream(torch.cuda.current_stream(dev))

    def body(padded, n, ae, lo, own):
        stage0 = K.prefilter_check_flags(padded, lengths, nc, n)
        return stage0, _kernels(padded, lengths, nc, n, ae, lo, own, rtc,
                                stage0)

    with torch.cuda.stream(stream):
        body(static, n_d, ae_d, lo_d, own_d)     # outside any capture
    stream.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        stage0_g, res = body(static, n_d, ae_d, lo_d, own_d)
    err = {"bad_op_tables": 0, "survivor_table": 0, "walk_lanes": 0}
    eager_err = dict(err)
    with torch.cuda.stream(stream):
        for padded, n, ae, lo, own in windows:
            static.copy_(padded)
            scalars.copy_(torch.tensor([n, int(ae), lo, own],
                                       dtype=torch.int32))
            graph.replay()
            stage0 = tuple(t.clone() for t in stage0_g)
            got = (tuple(t.clone() for t in res[0]),
                   {k: v.clone() for k, v in res[1].items()}, res[2].clone(),
                   res[3].clone(), res[4].clone())
            eager = _kernels(padded, lengths, nc, n, ae, lo, own, rtc,
                             stage0)
            want = _plain(padded, lengths, nc, n, ae, lo, own, rtc, stage0)
            for k, e in _errors(got, want).items():
                err[k] = max(err[k], e)
            for k, e in _errors(eager, want).items():
                eager_err[k] = max(eager_err[k], e)
    stream.synchronize()
    return {"replays": len(windows), "max_abs_err": err,
            "eager_err": eager_err}
