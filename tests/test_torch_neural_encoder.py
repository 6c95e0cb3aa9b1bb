"""The port's pre-LN NeuralEncoder (yams_tpu_torch/embed/encoder.py) against
the reference's flax module (yams_tpu/embed/encoder.py), JAX on the CPU.

The reference draws its weights from jax.random.PRNGKey(seed); those flax
parameters, as NumPy arrays, are carried into the port by
`convert.neural_state_from_flax`, and both encoders embed the same texts.
Both run in bf16 throughout (flax's Embed, attention and Dense layers), so
each rounds at every layer; the tolerance is max abs <= 1e-2 and every
cosine >= 0.999 (measured 3.1e-3 and 0.99998 at D 64, 1.6e-3 and 0.99995
at the defaults, D 384 x 6 layers).

The reference's flat npz (`load_npz`) loads into the port with the
reference's space id; the port's own seeded weights report the
`neural-torch` space.
"""

import jax
import numpy as np
import pytest
import torch

from yams_tpu.embed.encoder import NeuralEncoder as RefEncoder
from yams_tpu_torch.convert import neural_state_from_flax
from yams_tpu_torch.embed.encoder import NeuralEncoder, seeded_state

ATOL = 1e-2
MIN_COS = 0.999
TEXTS = ["a small test sentence about storage engines", "another one",
         "word " * 40, "x", "Raft elects a leader; the log replicates entries.", ""]

SHAPES = {"small": dict(dim=64, num_layers=2, num_heads=4, max_len=64),
          "defaults": dict(dim=384, num_layers=6, num_heads=12, max_len=256)}


@pytest.fixture(scope="module", params=sorted(SHAPES))
def ref_encoder(request):
    enc = RefEncoder(**SHAPES[request.param])
    enc._build()
    return request.param, enc


def _flax_numpy(enc):
    return jax.tree_util.tree_map(np.asarray, enc._params)


def _close(got, want):
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= ATOL, np.abs(got - want).max()
    assert (got * want).sum(-1).min() >= MIN_COS


def test_flax_weights_carried_give_the_reference_vectors(ref_encoder):
    name, ref = ref_encoder
    port = NeuralEncoder(**SHAPES[name], device="cpu")
    state = neural_state_from_flax(_flax_numpy(ref))
    model = port._build()
    assert set(dict(model.named_parameters())) == set(state)
    model.load_state_dict(state)
    _close(port.encode(TEXTS), ref.encode(TEXTS))


def test_token_ids_match_reference(ref_encoder):
    name, ref = ref_encoder
    port = NeuralEncoder(**SHAPES[name], device="cpu")
    for text in TEXTS + ["ünïcödé rôuting naïve " * 30]:
        assert port._token_ids(text) == ref._token_ids(text)


def test_load_npz_reads_the_reference_file(tmp_path):
    """The reference's flat 'params/Block_0/...' npz: the port loads it
    over its seeded weights and reports the reference's space id."""
    shape = SHAPES["small"]
    src = RefEncoder(**shape, seed=3)
    src._build()
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(src._params)[0]}
    np.savez(tmp_path / "w.npz", **flat)
    ref = RefEncoder(**shape, weights_path=str(tmp_path / "w.npz"))
    port = NeuralEncoder(**shape, weights_path=str(tmp_path / "w.npz"), device="cpu")
    _close(port.encode(TEXTS), ref.encode(TEXTS))
    assert port.space_id == ref.space_id == "neural/d64/L2/seed0/v1"


def test_seeded_weights_have_their_own_space():
    shape = SHAPES["small"]
    a, b = NeuralEncoder(**shape, device="cpu"), NeuralEncoder(**shape, device="cpu")
    assert a.space_id == "neural-torch/d64/L2/seed0/v1" != RefEncoder(**shape).space_id
    np.testing.assert_array_equal(a.encode(TEXTS), b.encode(TEXTS))
    other = NeuralEncoder(**shape, seed=1, device="cpu")
    assert not np.allclose(other.encode(TEXTS[:2]), a.encode(TEXTS[:2]))
    # flax's initializers' scales: truncated normals of variance 1/fan_in
    st = seeded_state(384, 1, 4, 256, seed=0)
    assert abs(float(st["blocks.0.attn.q.kernel"].std()) - 384 ** -0.5) < 2e-3
    assert abs(float(st["tok"].std()) - 32768 ** -0.5) < 1e-4
    assert torch.equal(st["blocks.0.ln1.scale"], torch.ones(384))


def test_attributes_read_at_first_use_and_buckets():
    """As the reference's: attributes set after construction take effect at
    the first encode, and a text embeds the same beside a longer one."""
    enc = NeuralEncoder(dim=64, device="cpu")
    enc.num_layers, enc.num_heads = 2, 4
    alone = enc.encode(["short text"])[0]
    with_long = enc.encode(["short text", "word " * 100])[0]
    assert enc.model.num_layers == 2
    np.testing.assert_allclose(alone, with_long, atol=2e-2)
    assert enc.encode([]).shape == (0, 64)
