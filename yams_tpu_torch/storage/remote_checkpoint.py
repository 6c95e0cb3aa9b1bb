"""Checkpoint spill/restore over object storage + the DR-provider gate.

Parity: the reference's DR seam is a plugin contract over manifests —
replication readiness, verification sampling, and a pointer-advance gate
(the upstream docs/spec/wit/dr_provider_v1.wit:1; object side
object_storage_v1.wit:15-31). This module is the TPU-native wiring of that
contract to the orbax sharded checkpoints (index/checkpoint.py): each spill
uploads the checkpoint's files to an ObjectBackend under a manifest id,
writes a manifest (relpath, size, sha256 per file), and the `latest` pointer
only advances after the DR gate verifies the replica. Restore downloads via
the manifest and re-verifies every digest — a half-replicated or bit-rotted
spill can never become the restore source.

Layout under the backend:
  checkpoints/<manifest_id>/files/<relpath>   file bodies
  checkpoints/<manifest_id>/manifest.json     the manifest
  checkpoints/latest                          pointer {manifest_id, epoch}

Copied from yams_tpu/storage/remote_checkpoint.py (the port imports nothing of yams_tpu):
past this docstring the code is the original's, line for line
(tests/test_torch_host_copies.py); its relative imports resolve to
the port's own modules.
"""

from __future__ import annotations

import hashlib
import json
import pathlib
import time
from dataclasses import dataclass, field

from ..core.errors import NotFoundError

_ROOT = "checkpoints"


def _manifest_key(manifest_id: str) -> str:
    return f"{_ROOT}/{manifest_id}/manifest.json"


def _file_key(manifest_id: str, relpath: str) -> str:
    return f"{_ROOT}/{manifest_id}/files/{_safe_relpath(relpath)}"


def _safe_relpath(relpath: str) -> str:
    """Reject manifest paths that could escape the restore root.

    Manifests come from the remote replica — untrusted. Digests only prove
    transport integrity (they are computed from the same untrusted manifest),
    so the path itself must be constrained: no absolute paths, no drive
    prefixes, no '..' components, no NUL/backslash tricks.
    """
    p = pathlib.PurePosixPath(relpath)
    if (
        not relpath
        or relpath != str(p)
        or p.is_absolute()
        or "\\" in relpath
        or "\x00" in relpath
        or any(part in ("..", ".", "") for part in p.parts)
    ):
        raise ValueError(f"unsafe manifest path: {relpath!r}")
    return relpath


def _safe_dest(dest_dir: pathlib.Path, relpath: str) -> pathlib.Path:
    """Resolve dest_dir/relpath and require it to stay under dest_dir."""
    _safe_relpath(relpath)
    out = (dest_dir / relpath).resolve()
    if not out.is_relative_to(dest_dir.resolve()):
        raise ValueError(f"manifest path escapes restore root: {relpath!r}")
    return out


@dataclass(slots=True)
class ReplicationStatus:
    """is-replication-ready result (dr_provider_v1.wit:12-14)."""

    ready: bool
    reason: str | None = None
    lag_seconds: float | None = None


@dataclass(slots=True)
class VerifySample:
    """verify-sample result (dr_provider_v1.wit:17-18)."""

    passed: bool
    failures: list[str] = field(default_factory=list)


@dataclass(slots=True)
class PointerGate:
    """pointer-gate result (dr_provider_v1.wit:21-22)."""

    allow_advance: bool
    reason: str | None = None


class DRProvider:
    """dr_provider_v1 analog over an ObjectBackend.

    The reference gates DR pointer advancement on (a) every manifest-
    referenced object existing in the replica and (b) a verification sample
    passing; the same two checks run here, with sha256 re-reads as the
    sample (the manifests carry content digests, so verification needs no
    side channel).
    """

    def __init__(self, backend):
        self.backend = backend

    def _manifest(self, manifest_id: str) -> dict:
        try:
            return json.loads(self.backend.get(_manifest_key(manifest_id)))
        except NotFoundError:
            raise NotFoundError(f"no manifest: {manifest_id}")

    def is_replication_ready(self, manifest_id: str) -> ReplicationStatus:
        try:
            m = self._manifest(manifest_id)
        except NotFoundError:
            return ReplicationStatus(False, reason="manifest missing")
        missing = [
            f["path"] for f in m["files"]
            if not self.backend.exists(_file_key(manifest_id, f["path"]))
        ]
        if missing:
            return ReplicationStatus(
                False, reason=f"{len(missing)} objects missing: "
                              f"{missing[:3]}")
        lag = max(0.0, time.time() - float(m.get("created_at", time.time())))
        return ReplicationStatus(True, lag_seconds=lag)

    def verify_sample(self, manifest_id: str,
                      sample_spec: str = "all") -> VerifySample:
        """sample_spec: 'all' | 'first:N' — which manifest entries to
        re-read and digest-check."""
        m = self._manifest(manifest_id)
        files = m["files"]
        if sample_spec.startswith("first:"):
            files = files[: int(sample_spec.split(":", 1)[1])]
        failures = []
        for f in files:
            try:
                data = self.backend.get(_file_key(manifest_id, f["path"]))
            except NotFoundError:
                failures.append(f"{f['path']}: missing")
                continue
            if hashlib.sha256(data).hexdigest() != f["sha256"]:
                failures.append(f"{f['path']}: digest mismatch")
            elif len(data) != f["size"]:
                failures.append(f"{f['path']}: size mismatch")
        return VerifySample(passed=not failures, failures=failures)

    def pointer_gate(self, manifest_id: str,
                     sample_spec: str = "all") -> PointerGate:
        rep = self.is_replication_ready(manifest_id)
        if not rep.ready:
            return PointerGate(False, reason=rep.reason)
        sample = self.verify_sample(manifest_id, sample_spec)
        if not sample.passed:
            return PointerGate(
                False, reason="; ".join(sample.failures[:3]))
        return PointerGate(True)


def spill_checkpoint(
    local_dir: str | pathlib.Path, backend, manifest_id: str,
    *, epoch: int = 0, sample_spec: str = "all", advance_pointer: bool = True,
) -> dict:
    """Upload a checkpoint directory and (gated) advance the latest pointer.

    Returns the manifest. Raises RuntimeError when the DR gate refuses the
    pointer advance — the upload stays (diagnosable) but `latest` still
    names the previous good checkpoint.
    """
    d = pathlib.Path(local_dir)
    files = []
    for p in sorted(d.rglob("*")):
        if not p.is_file():
            continue
        rel = str(p.relative_to(d))
        data = p.read_bytes()
        backend.put(_file_key(manifest_id, rel), data)
        files.append({
            "path": rel, "size": len(data),
            "sha256": hashlib.sha256(data).hexdigest(),
        })
    manifest = {
        "manifest_id": manifest_id, "epoch": epoch,
        "created_at": time.time(), "files": files,
    }
    backend.put(_manifest_key(manifest_id),
                json.dumps(manifest, indent=1).encode())
    if advance_pointer:
        gate = DRProvider(backend).pointer_gate(manifest_id, sample_spec)
        if not gate.allow_advance:
            raise RuntimeError(f"DR gate refused pointer advance: "
                               f"{gate.reason}")
        backend.put(f"{_ROOT}/latest", json.dumps(
            {"manifest_id": manifest_id, "epoch": epoch}).encode())
    return manifest


def latest_pointer(backend) -> dict | None:
    try:
        return json.loads(backend.get(f"{_ROOT}/latest"))
    except NotFoundError:
        return None


def restore_checkpoint(
    backend, dest_dir: str | pathlib.Path,
    manifest_id: str | None = None,
) -> dict:
    """Download a spilled checkpoint (default: the `latest` pointer's) into
    dest_dir, verifying every file digest. Returns the manifest."""
    if manifest_id is None:
        ptr = latest_pointer(backend)
        if ptr is None:
            raise NotFoundError("no latest checkpoint pointer")
        manifest_id = ptr["manifest_id"]
    m = json.loads(backend.get(_manifest_key(manifest_id)))
    d = pathlib.Path(dest_dir)
    # Validate every path BEFORE writing anything — a poisoned manifest must
    # not get a partial restore either.
    outs = [_safe_dest(d, f["path"]) for f in m["files"]]
    d.mkdir(parents=True, exist_ok=True)
    for f, out in zip(m["files"], outs):
        data = backend.get(_file_key(manifest_id, f["path"]))
        if hashlib.sha256(data).hexdigest() != f["sha256"]:
            raise ValueError(f"digest mismatch restoring {f['path']}")
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_bytes(data)
    return m
