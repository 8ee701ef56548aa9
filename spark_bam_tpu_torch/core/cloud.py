"""The built-in ``gs://`` and ``s3://`` channels (reference
``spark_bam_tpu/core/cloud.py``): an ``HttpRangeChannel`` against the
store's HTTPS endpoint behind the remote data plane
(``core/remote_plan.py::wrap_remote``).

Auth comes from the environment; no SDK is needed:

- ``gs://bucket/object``: ``https://storage.googleapis.com/bucket/object``
  with ``Authorization: Bearer`` from ``SPARK_BAM_GS_TOKEN`` or
  ``GOOGLE_OAUTH_ACCESS_TOKEN``, read again on every request so a job can
  rotate it; no token for a public bucket.
- ``s3://bucket/key``: SigV4 signing (stdlib hmac and sha256) from
  ``AWS_ACCESS_KEY_ID`` / ``AWS_SECRET_ACCESS_KEY`` (and
  ``AWS_SESSION_TOKEN``), the region from ``AWS_REGION`` /
  ``AWS_DEFAULT_REGION`` (default us-east-1); unsigned without them.

``SPARK_BAM_GS_ENDPOINT`` and ``SPARK_BAM_S3_ENDPOINT`` replace the
service's base URL (an emulator, or ``benchmarks/fakestore.py`` in the
tests). Importing the module registers both schemes with
``core/channel.py::register_scheme``.
"""


from __future__ import annotations

import datetime
import hashlib
import hmac
import os
import urllib.parse

from spark_bam_tpu_torch.core.channel import ByteChannel, register_scheme
from spark_bam_tpu_torch.core.remote import HttpRangeChannel
from spark_bam_tpu_torch.core.remote_plan import wrap_remote


def _split_bucket_key(url: str, scheme: str) -> tuple[str, str]:
    u = urllib.parse.urlsplit(url)
    if u.scheme != scheme or not u.netloc:
        raise ValueError(f"not a {scheme}:// url: {url}")
    return u.netloc, u.path.lstrip("/")


# ------------------------------------------------------------------- gs://

def gs_https_url(url: str):
    """``gs://bucket/object`` → (https URL, per-request header fn).

    The token is re-read from the environment on every request, so a
    long-running job can rotate ``SPARK_BAM_GS_TOKEN`` (OAuth access
    tokens expire hourly) without reopening channels."""
    bucket, key = _split_bucket_key(url, "gs")
    endpoint = os.environ.get(
        "SPARK_BAM_GS_ENDPOINT", "https://storage.googleapis.com"
    ).rstrip("/")
    https = f"{endpoint}/{bucket}/{urllib.parse.quote(key)}"

    def headers(method: str) -> dict:
        token = os.environ.get("SPARK_BAM_GS_TOKEN") or os.environ.get(
            "GOOGLE_OAUTH_ACCESS_TOKEN"
        )
        return {"Authorization": f"Bearer {token}"} if token else {}

    return https, headers


def open_gs(url: str, prefetch: bool = True) -> ByteChannel:
    https, headers = gs_https_url(url)
    ch: ByteChannel = HttpRangeChannel(https, headers=headers)
    return wrap_remote(ch) if prefetch else ch


# ------------------------------------------------------------------- s3://

def _sigv4_headers(
    method: str, host: str, path: str, region: str,
    access_key: str, secret_key: str, session_token: str | None,
    amz_date: str | None = None,
) -> dict:
    """AWS Signature Version 4 for a bodyless request (GET/HEAD), stdlib
    only. Range headers deliberately stay OUT of the signature (SigV4 only
    signs the headers listed in SignedHeaders; signing host+date suffices
    and keeps one signature valid for every ranged read of the object)."""
    now = amz_date or datetime.datetime.now(datetime.timezone.utc).strftime(
        "%Y%m%dT%H%M%SZ"
    )
    datestamp = now[:8]
    payload_hash = hashlib.sha256(b"").hexdigest()
    headers = {
        "host": host,
        "x-amz-content-sha256": payload_hash,
        "x-amz-date": now,
    }
    if session_token:
        headers["x-amz-security-token"] = session_token
    signed = ";".join(sorted(headers))
    canonical = "\n".join([
        method,
        urllib.parse.quote(path),
        "",  # query string
        "".join(f"{k}:{headers[k]}\n" for k in sorted(headers)),
        signed,
        payload_hash,
    ])
    scope = f"{datestamp}/{region}/s3/aws4_request"
    to_sign = "\n".join([
        "AWS4-HMAC-SHA256", now, scope,
        hashlib.sha256(canonical.encode()).hexdigest(),
    ])

    def _hmac(key: bytes, msg: str) -> bytes:
        return hmac.new(key, msg.encode(), hashlib.sha256).digest()

    k = _hmac(("AWS4" + secret_key).encode(), datestamp)
    k = _hmac(k, region)
    k = _hmac(k, "s3")
    k = _hmac(k, "aws4_request")
    signature = hmac.new(k, to_sign.encode(), hashlib.sha256).hexdigest()
    out = {k2: v for k2, v in headers.items() if k2 != "host"}
    out["Authorization"] = (
        f"AWS4-HMAC-SHA256 Credential={access_key}/{scope}, "
        f"SignedHeaders={signed}, Signature={signature}"
    )
    return out


def s3_https_url(url: str):
    """``s3://bucket/key`` → (https URL, per-request header fn). SigV4
    signs the actual method and a fresh timestamp on every request
    (signatures are valid ±15 min; HEAD and GET sign differently)."""
    bucket, key = _split_bucket_key(url, "s3")
    region = os.environ.get(
        "AWS_REGION", os.environ.get("AWS_DEFAULT_REGION", "us-east-1")
    )
    endpoint = os.environ.get("SPARK_BAM_S3_ENDPOINT")
    if endpoint:
        endpoint = endpoint.rstrip("/")
        https = f"{endpoint}/{bucket}/{urllib.parse.quote(key)}"
        path = f"/{bucket}/{key}"
        host = urllib.parse.urlsplit(endpoint).netloc
    else:
        host = f"{bucket}.s3.{region}.amazonaws.com"
        https = f"https://{host}/{urllib.parse.quote(key)}"
        path = f"/{key}"

    def headers(method: str) -> dict:
        access = os.environ.get("AWS_ACCESS_KEY_ID")
        secret = os.environ.get("AWS_SECRET_ACCESS_KEY")
        if not (access and secret):
            return {}
        return _sigv4_headers(
            method, host, path, region, access, secret,
            os.environ.get("AWS_SESSION_TOKEN"),
        )

    return https, headers


def open_s3(url: str, prefetch: bool = True) -> ByteChannel:
    https, headers = s3_https_url(url)
    ch: ByteChannel = HttpRangeChannel(https, headers=headers)
    return wrap_remote(ch) if prefetch else ch


register_scheme("gs", open_gs)
register_scheme("s3", open_s3)
