"""Newline-delimited JSON wire protocol of the split service (reference
``spark_bam_tpu/serve/protocol.py``, unchanged on the wire).

One request object per line, one response object per line. Requests carry
an ``op`` plus op-specific fields and an optional client-chosen ``id``
echoed back verbatim, so clients may pipeline. Responses are either

    {"id": ..., "ok": true, ...payload}
    {"id": ..., "ok": false, "error": "<Type>", "message": "...", ...}

The ``batch`` and ``aggregate`` ops stream binary frames after their JSON
line: the payload's ``binary_frames`` counts the frames that follow, each
written as a little-endian u64 length prefix and that many bytes.
Concatenated, a ``batch`` response's frames are a native columnar
container (``columnar/native.py``), byte-identical to the export's file
for the same query; with ``wire=arrow`` they are an Arrow IPC stream.
Handlers stage the frames on the in-process response under ``"_binary"``;
the server pops them before encoding the JSON line.

``hello`` negotiates the connection's transport and is answered by the
accept loop (``serve/server.py``), never the service:
``{"op": "hello", "transport": "shm"}`` asks for the shared-memory frame
transport (``serve/shm.py``); any other answer keeps socket framing.

``batch`` and ``aggregate`` accept ``resume_from=N``: the frame list for
an unchanged file and query is deterministic, so the response carries
frames ``N..`` only, plus ``total_frames``.

Admin ops (``drain``, ``tune``, ``alerts``, ``telemetry``) bypass
admission like ``ping`` and ``stats``. Requests may carry a ``tenant``
string the cost accountant (``obs/account.py``) rolls up by.

Error types are stable strings (``Overloaded``, ``DeadlineExceeded``,
``ProtocolError``, ``NotFound``, ``Unsupported``, ``Internal``,
``Draining``, ``ResourceExhausted``).
"""

from __future__ import annotations

import json

#: ops the protocol knows; anything else is a ProtocolError. The port's
#: service answers some of them ``Unsupported`` (serve/service.py).
OPS = ("ping", "stats", "plan", "record_starts", "count", "fleet", "batch",
       "aggregate", "rewrite", "drain", "tune", "telemetry", "alerts",
       "submit", "job_status", "job_cancel", "hello")


class ProtocolError(ValueError):
    """Malformed request line (bad JSON, missing/unknown fields)."""


def decode_request(line: "str | bytes") -> dict:
    try:
        req = json.loads(line)
    except Exception as exc:
        raise ProtocolError(f"request is not valid JSON: {exc}") from exc
    if not isinstance(req, dict):
        raise ProtocolError(f"request must be a JSON object, got {type(req).__name__}")
    op = req.get("op")
    if op not in OPS:
        raise ProtocolError(f"unknown op {op!r}: expected one of {', '.join(OPS)}")
    return req


def encode(obj: dict) -> bytes:
    return (json.dumps(obj, separators=(",", ":"), sort_keys=True) + "\n").encode()


def ok_response(req: dict, **payload) -> dict:
    return {"id": req.get("id"), "ok": True, **payload}


def error_response(req: dict, error: str, message: str, **extra) -> dict:
    return {"id": req.get("id"), "ok": False, "error": error,
            "message": message, **extra}
