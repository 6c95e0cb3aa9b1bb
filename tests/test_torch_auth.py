"""The port's `yams auth` on the CPU.

- The reference's AuthStore tests (ed25519 and HMAC keys, list, revoke,
  JWT round trips, tampering, expiry, revocation, API keys) rerun on the
  port's AuthStore; the reference's store reads the port's keys and
  verifies its tokens, and the other way round.
- A key name with a path separator, "." or ".." (or any character outside
  [A-Za-z0-9._-]) is refused before any path is touched: no file appears
  outside the keys directory, and none inside it. The reference writes the
  private key wherever `../` points.
- The CLI: `auth keygen`, `list-keys`, `token`, `verify` and `revoke`
  through `python -m yams_tpu_torch.cli`, and `--name ../x` exits 1.
"""

import json

import pytest

import test_auth as ref_auth_tests
from yams_tpu.cli.auth import AuthStore as RefStore
from yams_tpu_torch.cli import auth
from yams_tpu_torch.cli.auth import AuthStore
from yams_tpu_torch.cli.main import main as port_main


@pytest.fixture()
def port_store(monkeypatch):
    """The reference's tests build their store from their module's name."""
    monkeypatch.setattr(ref_auth_tests, "AuthStore", AuthStore)


class TestPortKeys(ref_auth_tests.TestKeys):
    @pytest.fixture(autouse=True)
    def _port(self, port_store):
        pass


class TestPortJwt(ref_auth_tests.TestJwt):
    @pytest.fixture(autouse=True)
    def _port(self, port_store):
        pass


class TestPortApiKeys(ref_auth_tests.TestApiKeys):
    @pytest.fixture(autouse=True)
    def _port(self, port_store):
        pass


@pytest.mark.parametrize("ktype", ["ed25519", "hmac"])
@pytest.mark.parametrize("writer", ["port", "reference"])
def test_each_package_reads_the_others_keys(tmp_path, ktype, writer):
    w, r = (AuthStore(tmp_path), RefStore(tmp_path))[::1 if writer == "port" else -1]
    w.keygen(ktype, name="shared")
    assert r.list_keys() == w.list_keys()
    tok = w.token("shared", {"sub": "bob"}, validity_s=60)
    assert r.verify_token(tok)["sub"] == "bob"
    assert r.revoke("shared")
    with pytest.raises(ValueError, match="revoked"):
        w.verify_token(tok)


BAD_NAMES = ["../x", "../../x", "a/b", "/abs", ".", "..", "", "a b", "a\\b", "é", "a\0b"]


@pytest.mark.parametrize("name", BAD_NAMES[:6] + BAD_NAMES[7:], ids=repr)
@pytest.mark.parametrize("ktype", ["ed25519", "hmac"])
def test_a_key_name_outside_the_keys_directory_is_refused(tmp_path, name, ktype):
    root = tmp_path / "data"
    root.mkdir()
    with pytest.raises(ValueError, match="invalid key name"):
        AuthStore(root).keygen(ktype, name=name)
    assert sorted(p.name for p in tmp_path.rglob("*")) == ["data"]   # nothing written


def test_the_reference_writes_outside_on_traversal(tmp_path):
    """The fault the port's check refuses (ADVICE.md)."""
    root = tmp_path / "data"
    RefStore(root).keygen("hmac", name="../../escaped")
    assert (tmp_path / "escaped.secret").exists()


@pytest.mark.parametrize("name", ["k1", "key.v2", "a-b_c.D9", "...x"])
def test_file_name_keys_are_accepted(tmp_path, name):
    out = AuthStore(tmp_path).keygen("hmac", name=name)
    assert out["key_id"] == name and (tmp_path / "keys" / f"{name}.secret").exists()
    assert auth.check_key_name(name) == name


def test_the_cli_auth_flow(tmp_path, capsys):
    def run(*argv):
        rc = port_main(["--storage", str(tmp_path / "data"), "--device", "cpu", "--no-daemon",
                        *argv])
        return rc, capsys.readouterr()

    rc, out = run("auth", "keygen", "--type", "hmac", "--name", "k")
    assert rc == 0 and "key_id: k" in out.out
    rc, out = run("auth", "token", "k", "--claims", '{"sub":"x"}')
    tok = out.out.split("token:", 1)[1].strip()
    rc2, out = run("auth", "verify", tok)
    assert rc == rc2 == 0 and "'sub': 'x'" in out.out
    rc, out = run("--json", "auth", "list-keys")
    assert rc == 0 and [k["key_id"] for k in json.loads(out.out)["keys"]] == ["k"]
    rc, out = run("auth", "keygen", "--type", "hmac", "--name", "../x")
    assert rc == 1 and "invalid key name" in out.out
    assert not (tmp_path / "x.secret").exists()
    rc, out = run("auth", "revoke", "k")
    assert rc == 0 and "revoked: True" in out.out
