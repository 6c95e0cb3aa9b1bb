"""The port's BERT encoder (yams_tpu_torch/embed/hf_encoder.py) against the
reference's (yams_tpu/embed/hf_encoder.py), JAX on the CPU.

On both in-repo checkpoints (realtext_bert_d192: 3 layers, D 192;
synthetic_bert_d128: 2 layers, D 128) the same seeded ids and attention
masks go through the reference's `bert_forward` and the port's, pooled and
per token. Tolerances:

- f32 compute: max abs error <= 1e-5 (measured ~1e-7);
- bf16 compute: max abs error <= 1e-3 and every cosine >= 0.9999 (measured
  ~1.4e-4 and 0.9999999: both packages round the same products to bf16,
  and only the f32 summation orders inside the products differ).

`HFBertEncoder` (tokenizer, buckets, encode, encode_ids, encode_tokens,
space_id) is held to the reference's on seeded text at f32, within 1e-5.
The port's copy of scripts/convert_hf_encoder.py converts a tiny random
transformers BertModel to the reference's arrays, and the port's encoder
reproduces that model's torch forward within 1e-4 (the reference test's
bound); `yams model download` converts a local checkpoint directory
offline.
"""

import contextlib
import io
import json
# before transformers: the TensorFlow it may load carries an SQLite without
# FTS5, which the metadata store needs, and the first SQLite loaded wins
import sqlite3  # noqa: F401

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yams_tpu.embed import hf_encoder as ref
from yams_tpu_torch.convert import hf_state_from_npz
from yams_tpu_torch.embed import hf_encoder as port
from yams_tpu_torch.embed.provider import DEFAULT_HF_CHECKPOINT

CKPT_DIR = DEFAULT_HF_CHECKPOINT.parent
CHECKPOINTS = ["realtext_bert_d192.npz", "synthetic_bert_d128.npz"]
F32_ATOL = 1e-5
BF16_ATOL = 1e-3
BF16_MIN_COS = 0.9999

WORDS = ["storage", "engines", "merkle", "tree", "diff", "detects", "renamed", "files",
         "raft", "consensus", "leader", "election", "page", "cache", "zstd", "gradient",
         "descent", "optimizer", "snapshot", "compaction", "unicodé", "x-y_z", "42"]


def seeded_texts(n: int, seed: int) -> list[str]:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        words = [WORDS[z % len(WORDS)] for z in rng.zipf(1.3, int(rng.integers(1, 40)))]
        out.append(" ".join(words) + rng.choice([".", "!", "?", ", and more."]))
    return out + ["", "UPPER lower MiXeD 123 4.5", "a\n\nb"]


@pytest.fixture(scope="module", params=CHECKPOINTS)
def ckpt(request):
    return str(CKPT_DIR / request.param)


def _seeded_batch(vocab_size: int, seed: int, B: int = 4, T: int = 32):
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, vocab_size, (B, T)).astype(np.int32)
    lens = rng.integers(3, T, B)
    lens[0] = T                                      # one full row
    attn = (np.arange(T)[None] < lens[:, None]).astype(np.float32)
    return ids, attn


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("per_token", [False, True], ids=["pooled", "per_token"])
def test_bert_forward_matches_reference(ckpt, compute_dtype, per_token):
    r = ref.HFBertEncoder(ckpt, compute_dtype="float32")
    ids, attn = _seeded_batch(len(r.tokenizer.vocab), seed=3)
    want = np.asarray(ref.bert_forward(
        {k: jnp.asarray(v) for k, v in r.params.items()}, jnp.asarray(ids),
        jnp.asarray(attn), num_layers=r.num_layers, num_heads=r.num_heads,
        compute_dtype=compute_dtype, per_token=per_token), np.float32)
    got = port.bert_forward(
        hf_state_from_npz(ckpt), torch.from_numpy(ids).long(), torch.from_numpy(attn),
        num_layers=r.num_layers, num_heads=r.num_heads, compute_dtype=compute_dtype,
        per_token=per_token).float().numpy()
    assert got.shape == want.shape
    live = attn > 0 if per_token else np.ones(len(ids), bool)
    err = np.abs(got - want)[live].max()
    if compute_dtype == "float32":
        assert err <= F32_ATOL, err
    else:
        assert err <= BF16_ATOL, err
        assert (got * want).sum(-1)[live].min() >= BF16_MIN_COS


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_bert_encoder_module_is_the_functional_form(ckpt, compute_dtype):
    """The module holds the dense layers in the compute dtype (the cast the
    forward makes anyway) and the LayerNorms and embeddings in f32."""
    state = hf_state_from_npz(ckpt)
    r = ref.HFBertEncoder(ckpt)
    model = port.BertEncoder(state, r.num_layers, r.num_heads, compute_dtype)
    held = model.state_dict()
    assert set(held) == set(state)
    assert held["layer0.attn.q.kernel"].dtype == port.compute_dtype_of(compute_dtype)
    assert held["layer0.attn_ln.bias"].dtype == held["embeddings.word"].dtype == torch.float32
    ids, attn = _seeded_batch(len(r.tokenizer.vocab), seed=5)
    i, a = torch.from_numpy(ids).long(), torch.from_numpy(attn)
    for per_token in (False, True):
        want = port.bert_forward(state, i, a, num_layers=r.num_layers, num_heads=r.num_heads,
                                 compute_dtype=compute_dtype, per_token=per_token)
        assert torch.equal(model(i, a, per_token=per_token), want)


def test_hf_encoder_matches_reference(ckpt):
    """Tokenizer, bucketing and both encode paths, f32 compute."""
    r = ref.HFBertEncoder(ckpt, compute_dtype="float32")
    p = port.HFBertEncoder(ckpt, compute_dtype="float32", device="cpu")
    assert (p.dim, p.num_layers, p.num_heads, p.max_len, p.intermediate) == \
        (r.dim, r.num_layers, r.num_heads, r.max_len, r.intermediate)
    assert p.space_id == r.space_id
    texts = seeded_texts(12, seed=7)
    np.testing.assert_allclose(p.encode(texts), r.encode(texts), atol=F32_ATOL, rtol=0)
    assert p.encode([]).shape == r.encode([]).shape == (0, r.dim)
    ids = [r.tokenizer.encode(t, 20) for t in texts[:4]]
    np.testing.assert_allclose(p.encode_ids(ids), r.encode_ids(ids), atol=F32_ATOL, rtol=0)
    for text in texts[:3] + ["the merkle tree diff detects renamed files"]:
        for max_tokens in (8, 32):
            got, want = p.encode_tokens(text, max_tokens), r.encode_tokens(text, max_tokens)
            assert got.shape == want.shape
            np.testing.assert_allclose(got, want, atol=F32_ATOL, rtol=0)


def test_encode_slices_rows_without_changing_them(monkeypatch):
    """encode_ids runs the forward in slices of ROWS_TOKENS padded tokens:
    a batch cut into many slices gives the one-slice vectors."""
    ckpt = str(CKPT_DIR / CHECKPOINTS[1])
    p = port.HFBertEncoder(ckpt, compute_dtype="float32", device="cpu")
    texts = seeded_texts(20, seed=11)
    whole = p.encode(texts)
    monkeypatch.setattr(port, "ROWS_TOKENS", 40)     # one row a slice
    np.testing.assert_allclose(p.encode(texts), whole, atol=1e-6, rtol=0)


# -- the converter and `yams model download` -----------------------------------

VOCAB = (["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
         + "the quick brown fox jumps over lazy dog search engine retrieval".split()
         + ["##ing", "##s", "##ed", "run", "jump", "test", ",", ".", "!"])


@pytest.fixture(scope="module")
def tiny_bert(tmp_path_factory):
    transformers = pytest.importorskip("transformers")
    cfg = transformers.BertConfig(vocab_size=len(VOCAB), hidden_size=32, num_hidden_layers=2,
                                  num_attention_heads=4, intermediate_size=64,
                                  max_position_embeddings=64)
    torch.manual_seed(7)
    model = transformers.BertModel(cfg).eval()
    d = tmp_path_factory.mktemp("tiny_bert")
    model.save_pretrained(d)
    (d / "vocab.txt").write_text("\n".join(VOCAB) + "\n")
    transformers.BertTokenizer(str(d / "vocab.txt")).save_pretrained(d)
    return model, cfg, d


def test_converter_matches_reference_and_the_torch_model(tiny_bert, tmp_path):
    from scripts.convert_hf_encoder import convert_state_dict as ref_convert
    from yams_tpu_torch.scripts.convert_hf_encoder import convert_state_dict

    model, cfg, _ = tiny_bert
    got, want = convert_state_dict(model.state_dict(), cfg, VOCAB), \
        ref_convert(model.state_dict(), cfg, VOCAB)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    np.savez_compressed(tmp_path / "tiny.npz", **got)
    enc = port.HFBertEncoder(str(tmp_path / "tiny.npz"), compute_dtype="float32", device="cpu")
    ids = np.array([[2, 5, 6, 7, 8, 3, 0, 0], [2, 9, 10, 11, 3, 0, 0, 0]], np.int64)
    attn = (ids != 0).astype(np.float32)
    with torch.no_grad():
        out = model(input_ids=torch.tensor(ids),
                    attention_mask=torch.tensor(attn)).last_hidden_state
    w = torch.tensor(attn)[:, :, None]
    expected = torch.nn.functional.normalize((out * w).sum(1) / w.sum(1), dim=-1).numpy()
    assert np.max(np.abs(enc.encode_ids([list(r[r != 0]) for r in ids]) - expected)) < 1e-4


def test_model_download_converts_a_local_directory(tiny_bert, tmp_path, monkeypatch):
    from yams_tpu_torch.cli.main import main

    monkeypatch.setenv("HF_HUB_OFFLINE", "1")        # never reach a hub
    monkeypatch.setenv("TRANSFORMERS_OFFLINE", "1")
    _, _, d = tiny_bert
    out = tmp_path / "m.npz"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(["--device", "cpu", "--storage", str(tmp_path / "s"), "model", "download",
                   str(d), "--out", str(out)])
    assert rc == 0 and f"converted -> {out}" in buf.getvalue()
    enc = port.HFBertEncoder(str(out), compute_dtype="float32", device="cpu")
    assert enc.dim == 32 and enc.tokenizer.vocab == {t: i for i, t in enumerate(VOCAB)}
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = main(["--device", "cpu", "--storage", str(tmp_path / "s"), "model", "download",
                   str(tmp_path / "missing")])
    assert rc == 1 and "model download failed" in err.getvalue()
    assert "air-gapped hosts can pass a local checkpoint directory" in err.getvalue()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(["--device", "cpu", "--storage", str(tmp_path / "s"), "--json",
                     "model", "list"]) == 0
    assert [m["model_id"] for m in json.loads(buf.getvalue())] == ["fixed_hash_384"]
