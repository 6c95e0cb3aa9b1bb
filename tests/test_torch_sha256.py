"""Port parity: batched SHA-256 and the device ingest tier.

yams_tpu_torch.ops.sha256 against yams_tpu.ops.sha256 (XLA on the CPU) and
hashlib, and yams_tpu_torch.ingest.device_pipeline against the reference's
device_chunk_hash. Hashes: every comparison is bit-exact. The edge rows are
the ones smoke phase 1 holds the CUDA kernel to on the card
(`chip_smoke.sha256_edge_rows`); here they go through the plain twin.
"""

import hashlib
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke as smoke
from yams_tpu.ingest import device_pipeline as ref_pipeline
from yams_tpu.ops import sha256 as ref_sha
from yams_tpu_torch import _build
from yams_tpu_torch.ingest import device_pipeline as port_pipeline
from yams_tpu_torch.ops import sha256 as port_sha
from yams_tpu_torch.scripts import sha256_split

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


@pytest.mark.parametrize("lead", [0, 1, 7, 13])
def test_edge_rows_match_hashlib(lead):
    """The kernel's edge rows through the twin, in a buffer that begins
    `lead` bytes into a larger one (as the card check views it)."""
    blob, starts, lengths = smoke.sha256_edge_rows(16)
    whole = port_pipeline.payload_tensor(b"\xa5" * lead + blob + b"\x5a" * 31, CPU)
    got = port_sha.sha256_rows(whole[lead:lead + len(blob)], torch.from_numpy(starts),
                               torch.from_numpy(lengths)).numpy()
    for d, s, n in zip(got, starts, lengths):
        assert d.tobytes() == hashlib.sha256(blob[s:s + n]).digest(), (s, n)


def test_edge_lengths_match_reference_padded_batch():
    """The padded (N, Lp) contract at the edge lengths: the port's
    sha256_batch equals the reference's and hashlib."""
    _, _, lengths = smoke.sha256_edge_rows(16)
    rng = np.random.default_rng(4)
    chunks = [rng.bytes(int(n)) for n in lengths]
    mat, lens = _padded(chunks)
    want = np.asarray(ref_sha.sha256_batch(jnp.asarray(mat), jnp.asarray(lens)))
    got = port_sha.sha256_batch(torch.from_numpy(mat), torch.from_numpy(lens)).numpy()
    assert np.array_equal(got, want)
    assert [d.tobytes() for d in got] == [hashlib.sha256(c).digest() for c in chunks]


def test_edge_rows_reach_the_kernels_edges():
    blob, starts, lengths = smoke.sha256_edge_rows(16)
    assert starts.dtype == np.int64 and lengths.dtype == np.int32
    src = (_build._SRC_DIR / "sha256.cu").read_text()
    span = int(re.search(r"kSpanBlocks = (\d+);", src).group(1))
    helpers = int(re.search(r"kHelpers = (\d+);", src).group(1))
    assert smoke.SHA_SPAN == 64 * span and smoke.SHA_RING == 64 * span * helpers
    have = set(lengths.tolist())
    assert set(range(201)) <= have
    for edge in (55, 56, 63, 64, 119, 120, smoke.SHA_SPAN, 2 * smoke.SHA_SPAN,
                 smoke.SHA_RING, 2 * smoke.SHA_RING):
        assert {edge - 1, edge, edge + 1} <= have
    live = lengths > 0
    assert set((starts[live] % 16).tolist()) == set(range(16))
    inner = np.flatnonzero(lengths == 0)
    assert any(0 < i < len(lengths) - 1 and lengths[i - 1] and lengths[i + 1] for i in inner)
    assert starts[0] == 0 and lengths[0] > 0
    assert starts[-1] + lengths[-1] == len(blob) and lengths[-1] > 0
    assert int((starts + lengths).max()) == len(blob)


def test_block_order_is_a_stable_permutation_longest_first():
    lengths = np.random.default_rng(5).integers(0, 700, 500).astype(np.int32)
    lengths[[3, 40, 41]] = [54, 55, 56]        # 55 fills one block, 56 needs two
    order = port_sha.block_order(torch.from_numpy(lengths)).numpy()
    assert sorted(order.tolist()) == list(range(len(lengths)))
    blocks = (lengths.astype(np.int64) + 9 + 63) // 64
    want = sorted(range(len(lengths)), key=lambda i: (-blocks[i], i))
    assert order.tolist() == want
    assert blocks[40] == 1 and blocks[41] == 2


@pytest.mark.parametrize("start,length", [(-1, 4), (0, -1), (60, 5), (64, 1)])
def test_rows_outside_the_buffer_are_refused(start, length):
    buf = torch.zeros(64, dtype=torch.uint8)
    st = torch.tensor([0, start], dtype=torch.int64)
    ln = torch.tensor([3, length], dtype=torch.int32)
    with pytest.raises(ValueError, match="outside the buffer"):
        port_sha.check_rows(buf, st, ln)
    with pytest.raises(ValueError, match="outside the buffer"):
        port_sha.sha256_rows(buf, st, ln)
    with pytest.raises(ValueError, match="CUDA"):
        port_sha.sha256_cuda(buf, st, ln)


def test_rows_up_to_the_buffers_last_byte_are_accepted():
    buf = torch.arange(64, dtype=torch.uint8)
    st = torch.tensor([0, 60, 64], dtype=torch.int64)
    ln = torch.tensor([64, 4, 0], dtype=torch.int32)
    port_sha.check_rows(buf, st, ln)
    got = port_sha.sha256_rows(buf, st, ln).numpy()
    raw = bytes(range(64))
    assert [d.tobytes() for d in got] == [hashlib.sha256(raw[s:s + n]).digest()
                                          for s, n in ((0, 64), (60, 4), (64, 0))]


def test_sha256_split_cuts_one_line_of_the_kernel(tmp_path):
    """The split script's copies of csrc/ differ from it only in sha256.cu,
    by the one cut each variant names."""
    assert set(sha256_split.VARIANTS) == {"rounds_skipped", "copies_skipped"}
    for variant, (mark, cut) in sha256_split.VARIANTS.items():
        dest = sha256_split.variant_sources(tmp_path / variant, variant)
        for src in _build._SRC_DIR.iterdir():
            got = (dest / src.name).read_text()
            if src.name == "sha256.cu":
                assert src.read_text().count(mark) == 1
                assert got == src.read_text().replace(mark, cut, 1)
            else:
                assert got == src.read_text()


def test_sha256_split_needs_a_card():
    with pytest.raises(ValueError, match="CUDA"):
        sha256_split.run(device="cpu")


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
