"""Port parity: sharded checkpoints (yams_tpu_torch.index.checkpoint).

The five tests of tests/test_checkpoint_sharded.py rerun on the port, over a
virtual mesh of 8 CPU shards; then the same arrays through the reference's
orbax round trip and the port's, with bit-equal values (bf16 included),
restored onto other shard counts and onto one device; and `checkpoint_epoch`
on a directory the reference wrote. The port's layout is its own (orbax
needs JAX), so a port restore of a reference checkpoint is refused.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as RefMesh
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from yams_tpu.index import checkpoint as ref
from yams_tpu_torch.index.checkpoint import (checkpoint_epoch, restore_sharded,
                                             save_sharded, sharded_template)
from yams_tpu_torch.parallel.mesh import shard_rows, virtual_mesh

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def mesh():
    return virtual_mesh(8, "d", CPU)


def _whole(parts):
    return torch.cat(parts).numpy() if isinstance(parts, list) else parts.numpy()


class TestShardedCheckpoint:
    def test_roundtrip_preserves_values_and_sharding(self, mesh, tmp_path):
        rng = np.random.default_rng(0)
        E = rng.standard_normal((8 * 64, 32)).astype(np.float32)
        valid = np.ones(8 * 64, np.float32)
        e_sh = shard_rows(mesh, torch.from_numpy(E))
        v_sh = shard_rows(mesh, torch.from_numpy(valid))
        save_sharded(tmp_path / "ck", {"E": e_sh, "valid": v_sh}, epoch=7)

        assert checkpoint_epoch(tmp_path / "ck") == 7
        tpl = {"E": sharded_template(E, mesh, ("d", None)),
               "valid": sharded_template(valid, mesh, ("d",))}
        restored, epoch = restore_sharded(tmp_path / "ck", tpl)
        assert epoch == 7
        np.testing.assert_array_equal(_whole(restored["E"]), E)
        assert len(restored["E"]) == 8 and restored["E"][0].shape == (64, 32)

    def test_restore_to_different_layout(self, mesh, tmp_path):
        """Save row-sharded, restore replicated (the mesh-migration story)."""
        E = np.arange(8 * 16 * 4, dtype=np.float32).reshape(8 * 16, 4)
        save_sharded(tmp_path / "ck2", {"E": shard_rows(mesh, torch.from_numpy(E))},
                     epoch=1)
        tpl = {"E": sharded_template(E, mesh, (None, None))}
        restored, _ = restore_sharded(tmp_path / "ck2", tpl)
        assert isinstance(restored["E"], torch.Tensor)
        np.testing.assert_array_equal(restored["E"].numpy(), E)

    def test_staleness_stamp_rejected(self, mesh, tmp_path):
        E = np.zeros((8, 4), np.float32)
        save_sharded(tmp_path / "ck3", {"E": torch.from_numpy(E)}, epoch=3)
        tpl = {"E": sharded_template(E, mesh, (None, None))}
        with pytest.raises(ValueError, match="stale"):
            restore_sharded(tmp_path / "ck3", tpl, min_epoch=5)
        restored, epoch = restore_sharded(tmp_path / "ck3", tpl, min_epoch=3)
        assert epoch == 3

    def test_missing_checkpoint(self, tmp_path):
        with pytest.raises(FileNotFoundError):
            restore_sharded(tmp_path / "nope", {})

    def test_overwrite_same_path(self, mesh, tmp_path):
        a = torch.ones(8, 4)
        save_sharded(tmp_path / "ck4", {"a": a}, epoch=1)
        save_sharded(tmp_path / "ck4", {"a": a * 2}, epoch=2)
        tpl = {"a": sharded_template(np.ones((8, 4), np.float32), mesh, (None, None))}
        restored, epoch = restore_sharded(tmp_path / "ck4", tpl)
        assert epoch == 2
        assert float(restored["a"][0, 0]) == 2.0
        # nothing of the first save or of a temporary directory is left
        assert sorted(p.name for p in (tmp_path / "ck4").iterdir()) == ["arrays", "meta.json"]


def _arrays(seed=1):
    rng = np.random.default_rng(seed)
    return {"E": rng.standard_normal((8 * 32, 16)).astype(np.float32),
            "q8": rng.integers(-127, 128, (8 * 32, 16)).astype(np.int8),
            "slots": rng.integers(-1, 500, 8 * 32).astype(np.int32),
            "bf": rng.standard_normal((8 * 32, 8)).astype(np.float32)}


def test_values_equal_the_reference_orbax_round_trip(mesh, tmp_path):
    """The same arrays through both packages, saved over 8 shards and
    restored onto 2 and 8 shards and one device: bit-equal to what the
    reference's orbax round trip restores."""
    x = _arrays()
    rm = RefMesh(np.array(jax.devices()[:8]), ("d",))
    rows, whole = NamedSharding(rm, P("d", None)), NamedSharding(rm, P("d"))
    ref_tree = {k: jax.device_put(jnp.asarray(v, jnp.bfloat16 if k == "bf" else None),
                                  rows if v.ndim == 2 else whole) for k, v in x.items()}
    ref.save_sharded(tmp_path / "ref", ref_tree, epoch=4)
    ref_tpl = {k: ref.sharded_template(np.asarray(v), rm, P("d", None) if v.ndim == 2
                                       else P("d")) for k, v in ref_tree.items()}
    want, _ = ref.restore_sharded(tmp_path / "ref", ref_tpl)

    port_tree = {k: shard_rows(mesh, torch.from_numpy(v).to(
        torch.bfloat16 if k == "bf" else torch.from_numpy(v).dtype)) for k, v in x.items()}
    save_sharded(tmp_path / "port", port_tree, epoch=4)
    assert checkpoint_epoch(tmp_path / "ref") == checkpoint_epoch(tmp_path / "port") == 4
    for target in (virtual_mesh(2, "d", CPU), mesh, virtual_mesh(1, "d", CPU)):
        tpl = {k: sharded_template(v, target, ("d",) + (None,) * (v.dim() - 1))
               for k, v in ((k, torch.cat(p)) for k, p in port_tree.items())}
        got, epoch = restore_sharded(tmp_path / "port", tpl, min_epoch=4)
        assert epoch == 4
        for k in x:
            assert len(got[k]) == target.size
            g = torch.cat(got[k])
            w = np.asarray(want[k])
            if k == "bf":
                assert g.dtype == torch.bfloat16
                assert np.array_equal(g.view(torch.int16).numpy(), w.view(np.int16))
            else:
                assert np.array_equal(g.numpy(), w)


def test_reads_the_reference_epoch_and_refuses_its_layout(tmp_path):
    ref.save_sharded(tmp_path / "ref", {"a": jnp.ones((8, 4))}, epoch=11)
    assert checkpoint_epoch(tmp_path / "ref") == 11
    with pytest.raises(ValueError, match="no port checkpoint"):
        restore_sharded(tmp_path / "ref", {"a": sharded_template(
            np.ones((8, 4), np.float32), virtual_mesh(1, "d", CPU), (None, None))})
    with pytest.raises(ValueError, match="stale"):
        restore_sharded(tmp_path / "ref", {}, min_epoch=12)


def test_template_mismatch_and_uneven_shards_raise(mesh, tmp_path):
    save_sharded(tmp_path / "ck", {"E": torch.zeros(24, 4)}, epoch=0)
    with pytest.raises(ValueError, match="template"):
        restore_sharded(tmp_path / "ck", {"E": sharded_template(
            np.zeros((24, 5), np.float32), mesh, (None, None))})
    with pytest.raises(ValueError, match="do not split"):
        restore_sharded(tmp_path / "ck", {"E": sharded_template(
            np.zeros((24, 4), np.float32), virtual_mesh(5, "d", CPU), ("d", None))})
    with pytest.raises(ValueError, match="plain name"):
        save_sharded(tmp_path / "ck", {"../x": torch.zeros(2)}, epoch=1)
    assert checkpoint_epoch(tmp_path / "ck") == 0
