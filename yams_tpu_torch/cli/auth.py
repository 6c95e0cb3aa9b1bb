"""`yams auth` — key generation, API keys, and JWT tokens.

Parity-plus: the reference registers `yams auth` with keygen / list-keys /
revoke / token / api-key subcommands but every one of them prints
"Phase 2 - Not yet implemented" (src/cli/commands/auth_command.cpp:95-139).
This module implements the surface the reference only sketches:

  keygen    — ed25519 (via `cryptography`) or HMAC secret, stored under
              <data_dir>/keys/ with 0600 perms
  list-keys — key id, type, created, revoked flag
  revoke    — mark a key revoked (kept for audit; token verify refuses it)
  token     — JWT: EdDSA when the key is ed25519, HS256 for HMAC secrets;
              custom claims + validity window
  api-key   — secure random key shown ONCE; only its SHA-256 is stored,
              with name/permissions/expiry metadata
  verify    — check a token or api key against the stored state

Keys and API-key hashes live in <data_dir>/keys/ next to the CAS, so `yams
auth` honors --storage and the daemon's unix-socket trust model
(docs/SECURITY.md) is unchanged: these credentials are for callers that
front yams with their own network layer.

Port of yams_tpu/cli/auth.py. It departs from the reference in one way
only: `keygen` accepts a key name only of the form ^[A-Za-z0-9._-]+$ that
is neither "." nor "..", and refuses any other (a path separator, "..")
with ValueError before it touches any path. The reference builds the key
file's path from the unchecked name, so `--name ../../x` writes the private
key outside the keys directory.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import os
import pathlib
import re
import secrets
import time

_KEY_NAME = re.compile(r"[A-Za-z0-9._-]+")


def check_key_name(name: str) -> str:
    """A key name that names a file inside the keys directory, or
    ValueError."""
    if not _KEY_NAME.fullmatch(name) or name in (".", ".."):
        raise ValueError(f"invalid key name {name!r}: use letters, digits, "
                         "'.', '_' and '-' (not '.' or '..')")
    return name


def _b64url(data: bytes) -> str:
    return base64.urlsafe_b64encode(data).rstrip(b"=").decode()


def _b64url_dec(s: str) -> bytes:
    return base64.urlsafe_b64decode(s + "=" * (-len(s) % 4))


class AuthStore:
    def __init__(self, data_dir: str | pathlib.Path):
        self.dir = pathlib.Path(data_dir) / "keys"
        self.meta_path = self.dir / "keys.json"

    def _load(self) -> dict:
        if self.meta_path.exists():
            return json.loads(self.meta_path.read_text())
        return {"keys": {}, "api_keys": {}}

    def _save(self, meta: dict) -> None:
        self.dir.mkdir(parents=True, exist_ok=True)
        tmp = self.meta_path.with_suffix(".tmp")
        tmp.write_text(json.dumps(meta, indent=1))
        os.chmod(tmp, 0o600)
        tmp.replace(self.meta_path)

    # -- signing keys -------------------------------------------------------
    def keygen(self, key_type: str = "ed25519", name: str = "") -> dict:
        kid = check_key_name(name or f"{key_type}-{secrets.token_hex(4)}")
        self.dir.mkdir(parents=True, exist_ok=True)
        meta = self._load()
        if kid in meta["keys"]:
            raise ValueError(f"key exists: {kid}")
        path = self.dir / f"{kid}.pem"
        if key_type == "ed25519":
            from cryptography.hazmat.primitives import serialization
            from cryptography.hazmat.primitives.asymmetric import ed25519

            priv = ed25519.Ed25519PrivateKey.generate()
            pem = priv.private_bytes(
                serialization.Encoding.PEM,
                serialization.PrivateFormat.PKCS8,
                serialization.NoEncryption())
            pub = priv.public_key().public_bytes(
                serialization.Encoding.PEM,
                serialization.PublicFormat.SubjectPublicKeyInfo)
            (self.dir / f"{kid}.pub").write_bytes(pub)
        elif key_type == "hmac":
            pem = secrets.token_bytes(32)
            path = self.dir / f"{kid}.secret"
        else:
            raise ValueError(f"unsupported key type: {key_type}")
        path.write_bytes(pem)
        os.chmod(path, 0o600)
        meta["keys"][kid] = {
            "type": key_type, "path": str(path),
            "created": time.time(), "revoked": False,
        }
        self._save(meta)
        return {"key_id": kid, "type": key_type, "path": str(path)}

    def list_keys(self) -> list[dict]:
        meta = self._load()
        out = [
            {"key_id": k, **{f: v[f] for f in
                             ("type", "created", "revoked")}}
            for k, v in meta["keys"].items()
        ]
        out += [
            {"key_id": k, "type": "api-key", "created": v["created"],
             "revoked": v["revoked"], "name": v["name"],
             "permissions": v["permissions"], "expires": v["expires"]}
            for k, v in meta["api_keys"].items()
        ]
        return out

    def revoke(self, key_id: str) -> bool:
        meta = self._load()
        for table in ("keys", "api_keys"):
            if key_id in meta[table]:
                meta[table][key_id]["revoked"] = True
                self._save(meta)
                return True
        return False

    # -- JWT ----------------------------------------------------------------
    def token(self, key_id: str, claims: dict | None = None,
              validity_s: int = 3600) -> str:
        meta = self._load()
        info = meta["keys"].get(key_id)
        if info is None:
            raise ValueError(f"no such key: {key_id}")
        if info["revoked"]:
            raise ValueError(f"key revoked: {key_id}")
        now = int(time.time())
        payload = {"iss": "yams", "iat": now, "exp": now + int(validity_s),
                   "kid": key_id, **(claims or {})}
        if info["type"] == "ed25519":
            header = {"alg": "EdDSA", "typ": "JWT"}
        else:
            header = {"alg": "HS256", "typ": "JWT"}
        signing = (_b64url(json.dumps(header, separators=(",", ":")).encode())
                   + "." +
                   _b64url(json.dumps(payload, separators=(",", ":")).encode()))
        key_bytes = pathlib.Path(info["path"]).read_bytes()
        if info["type"] == "ed25519":
            from cryptography.hazmat.primitives import serialization

            priv = serialization.load_pem_private_key(key_bytes, None)
            sig = priv.sign(signing.encode())
        else:
            sig = hmac.new(key_bytes, signing.encode(), hashlib.sha256).digest()
        return signing + "." + _b64url(sig)

    def verify_token(self, token: str) -> dict:
        """Returns the payload if the signature, expiry, and revocation all
        check out; raises ValueError otherwise."""
        try:
            h64, p64, s64 = token.split(".")
        except ValueError:
            raise ValueError("malformed token")
        payload = json.loads(_b64url_dec(p64))
        kid = payload.get("kid", "")
        meta = self._load()
        info = meta["keys"].get(kid)
        if info is None:
            raise ValueError(f"unknown key: {kid}")
        if info["revoked"]:
            raise ValueError(f"key revoked: {kid}")
        if payload.get("exp", 0) < time.time():
            raise ValueError("token expired")
        signing = (h64 + "." + p64).encode()
        sig = _b64url_dec(s64)
        key_bytes = pathlib.Path(info["path"]).read_bytes()
        if info["type"] == "ed25519":
            from cryptography.exceptions import InvalidSignature
            from cryptography.hazmat.primitives import serialization

            pub = serialization.load_pem_public_key(
                (self.dir / f"{kid}.pub").read_bytes())
            try:
                pub.verify(sig, signing)
            except InvalidSignature:
                raise ValueError("bad signature")
        else:
            want = hmac.new(key_bytes, signing, hashlib.sha256).digest()
            if not hmac.compare_digest(want, sig):
                raise ValueError("bad signature")
        return payload

    # -- API keys -----------------------------------------------------------
    def api_key(self, name: str, permissions: str = "read,write",
                expires: str = "never") -> dict:
        meta = self._load()
        raw = "yams_" + secrets.token_urlsafe(32)
        kid = "ak-" + secrets.token_hex(4)
        meta["api_keys"][kid] = {
            "name": name, "permissions": permissions, "expires": expires,
            "sha256": hashlib.sha256(raw.encode()).hexdigest(),
            "created": time.time(), "revoked": False,
        }
        self._save(meta)
        # the raw key is returned ONCE and never stored
        return {"key_id": kid, "api_key": raw, "permissions": permissions,
                "expires": expires}

    def verify_api_key(self, raw: str) -> dict:
        h = hashlib.sha256(raw.encode()).hexdigest()
        meta = self._load()
        for kid, v in meta["api_keys"].items():
            if hmac.compare_digest(v["sha256"], h):
                if v["revoked"]:
                    raise ValueError(f"api key revoked: {kid}")
                if v["expires"] != "never":
                    import datetime as _dt

                    exp = _dt.datetime.fromisoformat(v["expires"])
                    if exp.timestamp() < time.time():
                        raise ValueError("api key expired")
                return {"key_id": kid, "name": v["name"],
                        "permissions": v["permissions"]}
        raise ValueError("unknown api key")


def cmd_auth(cli) -> int:
    a = cli.args
    store = AuthStore(cli.config.data_dir)
    op = a.auth_op
    try:
        if op == "keygen":
            out = store.keygen(a.type, name=a.name or "")
        elif op == "list-keys":
            out = {"keys": store.list_keys()}
        elif op == "revoke":
            out = {"revoked": store.revoke(a.key_id)}
        elif op == "token":
            claims = json.loads(a.claims) if a.claims else {}
            out = {"token": store.token(a.key_id, claims,
                                        validity_s=a.validity)}
        elif op == "api-key":
            out = store.api_key(a.name, a.permissions, a.expires)
        elif op == "verify":
            if a.token.startswith("yams_"):
                out = store.verify_api_key(a.token)
            else:
                out = {"payload": store.verify_token(a.token)}
        else:
            print(f"unknown auth op: {op}")
            return 2
    except ValueError as e:
        print(f"error: {e}")
        return 1
    if getattr(a, "json", False):
        print(json.dumps(out))
    else:
        for k, v in out.items():
            print(f"{k}: {v}")
    return 0
