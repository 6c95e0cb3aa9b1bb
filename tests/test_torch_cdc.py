"""Port parity: gear-hash CDC (yams_tpu_torch.ops.cdc) vs yams_tpu.ops.cdc.

Seeded NumPy inputs go through the JAX function (XLA on the CPU, the Pallas
kernel in interpret mode as tests/test_cdc_device.py drives it) and through
the port's plain twin. Integer hashing: every comparison is bit-exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from yams_tpu.ingest import chunker as ref_chunker
from yams_tpu.ops import cdc as ref_cdc
from yams_tpu_torch.ingest import chunker as port_chunker
from yams_tpu_torch.ingest.device_pipeline import payload_tensor
from yams_tpu_torch.ops import cdc as port_cdc

CPU = torch.device("cpu")


def _bytes(n, seed):
    return np.random.default_rng(seed).bytes(n)


def _gear_values(n, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(-2**31, 2**31, n, dtype=np.int64).astype(np.int32)


def test_copied_host_chunker_matches_reference():
    assert port_chunker.GEAR_SEED == ref_chunker.GEAR_SEED
    for x in (0, 1, 12345, 2**63):
        assert port_chunker._splitmix64(x) == ref_chunker._splitmix64(x)
    assert np.array_equal(port_chunker.gear_table(), ref_chunker.gear_table())
    for avg in (1024, 4096, 65536, 1 << 20):
        assert port_chunker._masks(avg) == ref_chunker._masks(avg)
    data = _bytes(200_000, 5)
    for sizes in ((1024, 4096, 16384), (256, 1024, 4096)):
        assert port_chunker._boundaries_numpy(data, *sizes) == \
            ref_chunker._boundaries_numpy(data, *sizes)


@pytest.mark.parametrize("n", [1, 31, 32, 33, 2047, 2048, 2049, 70_000])
def test_gear_hash_matches_xla(n):
    g = _gear_values(n, seed=n)
    want = np.asarray(ref_cdc.gear_hash_xla(jnp.asarray(g)))
    got = port_cdc.gear_hash(torch.from_numpy(g)).numpy()
    assert np.array_equal(got, want)


def test_gear_hash_matches_pallas_interpret():
    """Several 65,536-byte Pallas blocks, halos included (the reference's
    host-side halo construction, candidates_device use_pallas=True)."""
    block = 65536
    data = _bytes(3 * block + 1000, 7)
    gear = ref_chunker.gear_table()
    g = gear[np.frombuffer(data, np.uint8)].astype(np.uint32).view(np.int32)
    pad = (-len(g)) % block
    g_dev = np.concatenate([g, np.zeros(pad, np.int32)])
    nb = len(g_dev) // block
    halos = np.zeros((nb, ref_cdc.HALO_ROWS, ref_cdc.LANES), np.int32)
    for i in range(1, nb):
        halos[i, -1, -ref_cdc.WINDOW:] = g_dev[i * block - ref_cdc.WINDOW:i * block]
    want = np.asarray(ref_cdc.gear_hash_pallas(
        jnp.asarray(g_dev.reshape(-1, ref_cdc.LANES)), jnp.asarray(halos),
        block=block)).reshape(-1)[:len(g)]
    got = port_cdc.gear_hash(
        port_cdc.gear_values(payload_tensor(data, CPU))).numpy()
    assert np.array_equal(got, want)


def test_candidates_and_boundaries_match_reference():
    data = _bytes(300_000, 1)
    sizes = (1024, 4096, 16384)
    buf = payload_tensor(data, CPU)
    cs, cl = port_cdc.candidates_device(buf, 4096)
    ws, wl = ref_cdc.candidates_device(data, 4096, use_pallas=False)
    assert np.array_equal(cs, ws) and np.array_equal(cl, wl)
    got = port_cdc.boundaries_device(buf, *sizes)
    assert got == ref_cdc.boundaries_device(data, *sizes, use_pallas=False)
    assert got == port_chunker._boundaries_numpy(data, *sizes)
    assert port_cdc.boundaries_device(payload_tensor(b"", CPU), *sizes) == []
    assert port_cdc.boundaries_device(payload_tensor(b"tiny", CPU), *sizes) == [4]


def test_gear_hash_routes_cpu_to_twin_and_cuda_kernel_refuses_cpu():
    g = torch.from_numpy(_gear_values(100, 3))
    before = port_cdc.gear_hash_cuda.launches
    assert torch.equal(port_cdc.gear_hash(g), port_cdc.gear_hash_reference(g))
    assert port_cdc.gear_hash_cuda.launches == before
    with pytest.raises(ValueError):
        port_cdc.gear_hash_cuda(g)
