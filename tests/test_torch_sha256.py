"""Port parity: batched SHA-256 and the device ingest tier.

yams_tpu_torch.ops.sha256 against yams_tpu.ops.sha256 (XLA on the CPU) and
hashlib, and yams_tpu_torch.ingest.device_pipeline against the reference's
device_chunk_hash. Hashes: every comparison is bit-exact.
"""

import hashlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from yams_tpu.ingest import device_pipeline as ref_pipeline
from yams_tpu.ops import sha256 as ref_sha
from yams_tpu_torch.ingest import device_pipeline as port_pipeline
from yams_tpu_torch.ops import sha256 as port_sha

CPU = torch.device("cpu")
EDGE_LENGTHS = [0, 1, 3, 55, 56, 63, 64, 119, 120, 128, 1000, 2049]


def _chunks(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.bytes(n) for n in EDGE_LENGTHS]


def _padded(chunks):
    lengths = np.array([len(c) for c in chunks], np.int32)
    lp = int(((lengths.max() + 9 + 63) // 64) * 64)
    mat = np.zeros((len(chunks), lp), np.uint8)
    for i, c in enumerate(chunks):
        mat[i, :len(c)] = np.frombuffer(c, np.uint8)
    return mat, lengths


def test_sha256_batch_matches_reference_and_hashlib():
    chunks = _chunks()
    mat, lengths = _padded(chunks)
    want = np.asarray(ref_sha.sha256_batch(jnp.asarray(mat), jnp.asarray(lengths)))
    got = port_sha.sha256_batch(torch.from_numpy(mat),
                                torch.from_numpy(lengths)).numpy()
    assert np.array_equal(got, want)
    for c, d in zip(chunks, got):
        assert d.tobytes().hex() == hashlib.sha256(c).hexdigest(), len(c)


def test_sha256_pad_bytes_matches_reference():
    mat, lengths = _padded(_chunks(1))
    w_ref, n_ref = ref_sha.sha256_pad_bytes(jnp.asarray(mat), jnp.asarray(lengths))
    w, n = port_sha.sha256_pad_bytes(torch.from_numpy(mat), torch.from_numpy(lengths))
    assert np.array_equal(w.numpy(), np.asarray(w_ref).astype(np.int64))
    assert np.array_equal(n.numpy(), np.asarray(n_ref))


def test_sha256_rows_reads_ranges_of_a_flat_buffer():
    chunks = _chunks(2)
    flat = b"".join(chunks)
    starts = np.cumsum([0] + [len(c) for c in chunks[:-1]]).astype(np.int64)
    lengths = np.array([len(c) for c in chunks], np.int32)
    got = port_sha.sha256_rows(
        port_pipeline.payload_tensor(flat, CPU), torch.from_numpy(starts),
        torch.from_numpy(lengths)).numpy()
    assert [d.tobytes().hex() for d in got] == \
        [hashlib.sha256(c).hexdigest() for c in chunks]


def test_sha256_cuda_refuses_cpu_tensors():
    buf = torch.zeros(64, dtype=torch.uint8)
    with pytest.raises(ValueError):
        port_sha.sha256_cuda(buf, torch.zeros(1, dtype=torch.int64),
                             torch.ones(1, dtype=torch.int32))


def test_device_chunk_hash_matches_reference():
    data = np.random.default_rng(3).bytes(100_000)
    sizes = (256, 1024, 4096)
    want = ref_pipeline.device_chunk_hash(data, *sizes, use_pallas=False)
    got = port_pipeline.device_chunk_hash(data, *sizes, device=CPU)
    assert got == want
    assert got[0][1] == 0 and got[-1][2] == len(data)
    assert port_pipeline.device_chunk_hash(b"", *sizes, device=CPU) == []


def test_available_routes_on_size_and_device(monkeypatch):
    monkeypatch.delenv("YAMS_DEVICE_INGEST", raising=False)
    big = port_pipeline.DEVICE_MIN_BYTES
    assert not port_pipeline.available(big, CPU)
    assert port_pipeline.available(big, torch.device("cuda"))
    assert not port_pipeline.available(big - 1, torch.device("cuda"))
    monkeypatch.setenv("YAMS_DEVICE_INGEST", "1")
    assert port_pipeline.available(10, CPU)
    monkeypatch.setenv("YAMS_DEVICE_INGEST", "0")
    assert not port_pipeline.available(big, torch.device("cuda"))
