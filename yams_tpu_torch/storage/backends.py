"""Pluggable object-storage backends + URL factory + AWS SigV4 signer.

Parity: src/storage/storage_backend_factory.cpp (URL-scheme factory),
url_backend.cpp (file://), s3_signer.cpp (SigV4), object_storage_adapter.cpp.
The S3 backend signs requests with a from-scratch SigV4 implementation and
uses urllib — it degrades to clear errors in zero-egress environments, while
the signer itself is fully unit-testable offline.

Copied from yams_tpu/storage/backends.py (the port imports nothing of yams_tpu):
past this docstring the code is the original's, line for line
(tests/test_torch_host_copies.py); its relative imports resolve to
the port's own modules.
"""

from __future__ import annotations

import datetime
import hashlib
import hmac
import pathlib
import urllib.parse
import urllib.request
from typing import Iterator, Protocol

from ..core.errors import NotFoundError, UnsupportedError


class ObjectBackend(Protocol):
    def put(self, key: str, data: bytes) -> None: ...
    def get(self, key: str) -> bytes: ...
    def exists(self, key: str) -> bool: ...
    def delete(self, key: str) -> bool: ...
    def list(self, prefix: str = "") -> Iterator[str]: ...


class FilesystemBackend:
    """file:// backend — also the spill/mirror target for CAS shards."""

    def __init__(self, root: str | pathlib.Path):
        self.root = pathlib.Path(root)
        self.root.mkdir(parents=True, exist_ok=True)

    def _path(self, key: str) -> pathlib.Path:
        p = (self.root / key.lstrip("/")).resolve()
        if not str(p).startswith(str(self.root.resolve())):
            raise UnsupportedError(f"key escapes root: {key}")
        return p

    def put(self, key: str, data: bytes) -> None:
        p = self._path(key)
        p.parent.mkdir(parents=True, exist_ok=True)
        tmp = p.with_suffix(p.suffix + ".tmp")
        tmp.write_bytes(data)
        tmp.replace(p)

    def get(self, key: str) -> bytes:
        try:
            return self._path(key).read_bytes()
        except FileNotFoundError:
            raise NotFoundError(f"object not found: {key}")

    def exists(self, key: str) -> bool:
        return self._path(key).is_file()

    def delete(self, key: str) -> bool:
        try:
            self._path(key).unlink()
            return True
        except FileNotFoundError:
            return False

    def list(self, prefix: str = "") -> Iterator[str]:
        base = self.root
        for p in sorted(base.rglob("*")):
            if p.is_file() and not p.name.endswith(".tmp"):
                key = str(p.relative_to(base))
                if key.startswith(prefix):
                    yield key


# -- minimal S3 XML helpers --------------------------------------------------

def _xml_root(body: bytes):
    import xml.etree.ElementTree as ET

    return ET.fromstring(body)


def _xml_ns(root) -> str:
    """'{namespace}' prefix of an element tag, or '' when unnamespaced."""
    t = root.tag
    return t[: t.index("}") + 1] if t.startswith("{") else ""


def _xml_text(body: bytes, tag: str) -> str | None:
    """First <tag> text anywhere in the document, namespace-agnostic."""
    root = _xml_root(body)
    ns = _xml_ns(root)
    if root.tag == f"{ns}{tag}":
        return root.text
    el = root.find(f".//{ns}{tag}")
    return el.text if el is not None else None


# -- AWS Signature V4 ------------------------------------------------------------

def _sha256_hex(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def _hmac(key: bytes, msg: str) -> bytes:
    return hmac.new(key, msg.encode(), hashlib.sha256).digest()


def sigv4_headers(
    method: str,
    url: str,
    region: str,
    service: str,
    access_key: str,
    secret_key: str,
    payload: bytes = b"",
    now: datetime.datetime | None = None,
    extra_headers: dict[str, str] | None = None,
) -> dict[str, str]:
    """Produce Authorization + x-amz-* headers for one request (SigV4)."""
    now = now or datetime.datetime.now(datetime.timezone.utc)
    amz_date = now.strftime("%Y%m%dT%H%M%SZ")
    date_stamp = now.strftime("%Y%m%d")
    parsed = urllib.parse.urlparse(url)
    host = parsed.netloc
    canonical_uri = urllib.parse.quote(parsed.path or "/", safe="/-_.~")
    # canonical query: sorted, url-encoded
    query_pairs = urllib.parse.parse_qsl(parsed.query, keep_blank_values=True)
    canonical_query = "&".join(
        f"{urllib.parse.quote(k, safe='-_.~')}={urllib.parse.quote(v, safe='-_.~')}"
        for k, v in sorted(query_pairs)
    )
    payload_hash = _sha256_hex(payload)
    headers = {
        "host": host,
        "x-amz-content-sha256": payload_hash,
        "x-amz-date": amz_date,
    }
    for k, v in (extra_headers or {}).items():
        headers[k.lower()] = v.strip()
    signed_headers = ";".join(sorted(headers))
    canonical_headers = "".join(f"{k}:{headers[k]}\n" for k in sorted(headers))
    canonical_request = "\n".join([
        method.upper(), canonical_uri, canonical_query,
        canonical_headers, signed_headers, payload_hash,
    ])
    scope = f"{date_stamp}/{region}/{service}/aws4_request"
    string_to_sign = "\n".join([
        "AWS4-HMAC-SHA256", amz_date, scope, _sha256_hex(canonical_request.encode()),
    ])
    k = _hmac(("AWS4" + secret_key).encode(), date_stamp)
    k = _hmac(k, region)
    k = _hmac(k, service)
    k = _hmac(k, "aws4_request")
    signature = hmac.new(k, string_to_sign.encode(), hashlib.sha256).hexdigest()
    out = {k: v for k, v in headers.items() if k != "host"}
    out["Authorization"] = (
        f"AWS4-HMAC-SHA256 Credential={access_key}/{scope}, "
        f"SignedHeaders={signed_headers}, Signature={signature}"
    )
    return out


class S3Backend:
    """s3://bucket/prefix backend over signed HTTP (endpoint overridable for
    S3-compatible stores). Covers the object_storage_v1 contract
    (docs/spec/wit/object_storage_v1.wit): put/get/head/delete,
    ListObjectsV2 with continuation paging, and multipart upload
    (reference contract: docs/spec/wit/object_storage_v1.wit:15-31)."""

    # puts above this size go through multipart automatically (S3's single
    # PUT ceiling is 5 GiB; parts stream in bounded memory)
    MULTIPART_THRESHOLD = 64 * 1024 * 1024
    PART_SIZE = 16 * 1024 * 1024

    def __init__(
        self, bucket: str, prefix: str = "", region: str = "us-east-1",
        access_key: str = "", secret_key: str = "", endpoint: str = "",
    ):
        self.bucket = bucket
        self.prefix = prefix.strip("/")
        self.region = region
        self.access_key = access_key
        self.secret_key = secret_key
        self.endpoint = endpoint or f"https://{bucket}.s3.{region}.amazonaws.com"

    def _full_key(self, key: str) -> str:
        return f"{self.prefix}/{key}" if self.prefix else key

    def _url(self, key: str, query: str = "") -> str:
        u = f"{self.endpoint}/{urllib.parse.quote(self._full_key(key))}"
        return f"{u}?{query}" if query else u

    def _request(self, method: str, key: str, payload: bytes = b"",
                 query: str = ""):
        url = self._url(key, query)
        headers = sigv4_headers(
            method, url, self.region, "s3",
            self.access_key, self.secret_key, payload,
        )
        req = urllib.request.Request(url, data=payload or None, method=method,
                                     headers=headers)
        return urllib.request.urlopen(req, timeout=60)

    def put(self, key: str, data: bytes) -> None:
        if len(data) > self.MULTIPART_THRESHOLD:
            self.put_multipart(key, data)
            return
        self._request("PUT", key, data).read()

    # -- multipart upload (object_storage_v1 multipart-* ops) ----------------

    def multipart_start(self, key: str) -> str:
        body = self._request("POST", key, query="uploads").read()
        upload_id = _xml_text(body, "UploadId")
        if not upload_id:
            raise UnsupportedError("multipart: no UploadId in response")
        return upload_id

    def multipart_upload_part(self, key: str, upload_id: str,
                              part_number: int, data: bytes) -> str:
        resp = self._request(
            "PUT", key, data,
            query=f"partNumber={part_number}&uploadId="
                  f"{urllib.parse.quote(upload_id, safe='')}")
        resp.read()
        return (resp.headers.get("ETag") or "").strip('"')

    def multipart_complete(self, key: str, upload_id: str,
                           etags: list[str]) -> None:
        parts = "".join(
            f"<Part><PartNumber>{i + 1}</PartNumber><ETag>{e}</ETag></Part>"
            for i, e in enumerate(etags)
        )
        body = (f"<CompleteMultipartUpload>{parts}"
                f"</CompleteMultipartUpload>").encode()
        self._request(
            "POST", key, body,
            query=f"uploadId={urllib.parse.quote(upload_id, safe='')}").read()

    def multipart_abort(self, key: str, upload_id: str) -> None:
        self._request(
            "DELETE", key,
            query=f"uploadId={urllib.parse.quote(upload_id, safe='')}").read()

    def put_multipart(self, key: str, data: bytes,
                      part_size: int | None = None) -> None:
        part_size = part_size or self.PART_SIZE
        upload_id = self.multipart_start(key)
        try:
            etags = [
                self.multipart_upload_part(
                    key, upload_id, i + 1, data[off:off + part_size])
                for i, off in enumerate(range(0, len(data), part_size))
            ]
            self.multipart_complete(key, upload_id, etags)
        except Exception:
            try:
                self.multipart_abort(key, upload_id)
            finally:
                pass
            raise

    def get(self, key: str) -> bytes:
        try:
            return self._request("GET", key).read()
        except urllib.error.HTTPError as e:  # type: ignore[attr-defined]
            if e.code == 404:
                raise NotFoundError(f"object not found: {key}")
            raise

    def exists(self, key: str) -> bool:
        try:
            self._request("HEAD", key).read()
            return True
        except Exception:
            return False

    def delete(self, key: str) -> bool:
        try:
            self._request("DELETE", key).read()
            return True
        except Exception:
            return False

    def list(self, prefix: str = "") -> Iterator[str]:
        """ListObjectsV2 with continuation-token pagination. Yields keys
        relative to the backend prefix (mirroring FilesystemBackend.list)."""
        base = self._full_key(prefix) if prefix else self.prefix
        token = None
        strip = len(self.prefix) + 1 if self.prefix else 0
        while True:
            q = "list-type=2"
            if base:
                q += f"&prefix={urllib.parse.quote(base, safe='')}"
            if token:
                q += f"&continuation-token={urllib.parse.quote(token, safe='')}"
            url = f"{self.endpoint}/?{q}"
            headers = sigv4_headers("GET", url, self.region, "s3",
                                    self.access_key, self.secret_key)
            req = urllib.request.Request(url, method="GET", headers=headers)
            body = urllib.request.urlopen(req, timeout=60).read()
            root = _xml_root(body)
            ns = _xml_ns(root)
            for c in root.iter(f"{ns}Contents"):
                k = c.find(f"{ns}Key")
                if k is not None and k.text:
                    yield k.text[strip:] if strip else k.text
            if _xml_text(body, "IsTruncated") != "true":
                return
            token = _xml_text(body, "NextContinuationToken")
            if not token:
                return


def backend_from_url(url: str, **kw) -> ObjectBackend:
    """URL-scheme factory (reference: storage_backend_factory.cpp:418)."""
    parsed = urllib.parse.urlparse(url)
    if parsed.scheme in ("file", ""):
        return FilesystemBackend(parsed.path or url)
    if parsed.scheme == "s3":
        return S3Backend(bucket=parsed.netloc, prefix=parsed.path.lstrip("/"), **kw)
    raise UnsupportedError(f"unknown object-storage scheme: {parsed.scheme}")
