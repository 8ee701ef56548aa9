"""The two flag kernels inside captured CUDA graphs, replayed over rows
whose bytes and valid lengths change from replay to replay.

A launch captured into a CUDA graph reruns with every argument it was
captured with. The flag kernels take tiles by ticket and publish
epoch-tagged tile records (``kernels.TileStatus``): were the captured
ticket base and epoch reused against records that the previous replay
left, the second replay would read the first one's records as its own.
The plain-versus-kernel check of a single replay cannot see that; only
replays after the first can. So each kernel is captured once over a static
window and a static 0-d ``n``, and replayed over each given window in
turn, on the current stream or on another one, with an eager launch of the
same kernel on the same stream between replays; every replay's outputs
are held against the plain versions (``_prefilter_compact``,
``_compute_flags``). Shared by the card tests and ``chip_smoke.py``.
"""

from __future__ import annotations

import torch

from spark_bam_tpu_torch.tpu import kernels as K


def _max_abs_err(got, want) -> int:
    err = 0
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"{tuple(g.shape)} {g.dtype} against "
                                 f"{tuple(w.shape)} {w.dtype}")
        if g.numel():
            err = max(err, int((g.long() - w.long()).abs().max()))
    return err


def replay_flag_kernels(windows, lengths, num_contigs: int,
                        stream: torch.cuda.Stream | None = None) -> dict:
    """Capture ``prefilter_check_flags`` and ``full_check_flags`` once
    each and replay them over ``windows`` (``[(padded (W + PAD,) u8 CUDA
    tensor, n), ...]``, one W) on ``stream`` (default: the current one).
    Returns ``{kernel: {"replays": R, "max_abs_err": e, "eager_err": e'}}``:
    the largest difference of any replay's outputs, and of the eager
    launches between replays, from the plain versions (0 = identical)."""
    dev = windows[0][0].device
    w = windows[0][0].numel() - K.PAD
    cap = K.lane_capacity(w)
    static = torch.zeros_like(windows[0][0])
    n_dev = torch.zeros((), dtype=torch.int32, device=dev)
    stream = stream or torch.cuda.current_stream(dev)
    stream.wait_stream(torch.cuda.current_stream(dev))
    kernels = {
        "prefilter_check_flags": (
            K.prefilter_check_flags,
            lambda p, n: K._prefilter_compact(p, lengths, num_contigs, n,
                                              cap)),
        "full_check_flags": (
            lambda *a: (K.full_check_flags(*a),),
            lambda p, n: (K._compute_flags(p, lengths, num_contigs, n),)),
    }
    out = {}
    for name, (launch, plain) in kernels.items():
        # Outside any capture first: builds and loads the kernels.
        with torch.cuda.stream(stream):
            launch(static, lengths, num_contigs, n_dev)
        stream.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            res = launch(static, lengths, num_contigs, n_dev)
        err = eager_err = 0
        with torch.cuda.stream(stream):
            for padded, n in windows:
                static.copy_(padded)
                n_dev.fill_(n)
                graph.replay()
                got = [r.clone() for r in res]
                eager = launch(padded, lengths, num_contigs, n)
                want = plain(padded, n)
                err = max(err, _max_abs_err(got, want))
                eager_err = max(eager_err, _max_abs_err(eager, want))
        stream.synchronize()
        out[name] = {"replays": len(windows), "max_abs_err": err,
                     "eager_err": eager_err}
    return out
