"""The port's NER tagger against the reference's flax model, on the CPU.

- The host helpers (tokenizer, hashed n-grams, case features, featurize,
  the shape rules) are the reference's code and give its outputs.
- `Tagger` on the bundled checkpoint and on the reference's seeded random
  weights (carried by `convert.ner_state_from_flax`): f32 logits within
  1e-5 of the flax module's on seeded windows (full, partly padded, empty),
  and the label windows' encoder output too.
- `NerModel.tag`, `extract` (long texts over many windows) and the
  `neural_ner` plugin's entities equal the reference's.
- `save` writes the reference's format (each package loads the other's
  file); `load` admits no global but NumPy's array builders, and loads in
  an interpreter where flax, jax and yams_tpu are refused. `fit` is held
  to the reference's in tests/test_torch_train_ner.py.
"""

import functools
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from yams_tpu.embed import ner as ref_ner
from yams_tpu_torch import convert
from yams_tpu_torch.embed import ner
from yams_tpu_torch.plugins import neural_ner as port_plugin

BUNDLED = port_plugin._BUNDLED

TEXTS = [
    "When the CacheManager runs after the ingest_queue_worker updates the index",
    "the quick brown fox jumps over the lazy dog",
    "ParseTree and lexer_state meet New York City with IBM and the Widget Factory",
    "call os.path.join then read_config; HTTPServer serves GET requests",
    "",
    " ".join(["The Scheduler thread preempts the TokenStream reader"] * 9),
]


def test_host_helpers_are_the_references():
    words = ["CacheManager", "ingest_queue_worker", "os.path", "IBM", "The", "x1", "é"]
    for text in TEXTS:
        assert ner.word_tokenize(text) == ref_ner.word_tokenize(text)
    for w in words:
        assert np.array_equal(ner._ngram_ids(w), ref_ner._ngram_ids(w))
        assert np.array_equal(ner._case_feats(w), ref_ner._case_feats(w))
        assert ner.identifier_shape(w) == ref_ner.identifier_shape(w)
        assert ner.ambiguous_shape(w) == ref_ner.ambiguous_shape(w)
    got, want = ner.featurize(words, 16), ref_ner.featurize(words, 16)
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    assert ner.NerConfig() == ner.NerConfig(**vars(ref_ner.NerConfig()))


def _windows(cfg, seed=0, n=24):
    """Seeded windows of the reference's featurizer: every length from 0 to
    the full window."""
    rng = np.random.default_rng(seed)
    vocab = [t for text in TEXTS for t, _ in ref_ner.word_tokenize(text)]
    rows = [ref_ner.featurize([vocab[i] for i in rng.integers(0, len(vocab), n_tok)],
                              cfg.window)
            for n_tok in np.linspace(0, cfg.window + 5, n).astype(int)]
    return [np.stack(a) for a in zip(*rows)]


@functools.cache
def _pair(kind):
    """(reference model, port model) on the same weights, built once."""
    if kind == "bundled":
        return ref_ner.NerModel.load(BUNDLED), ner.NerModel.load(BUNDLED, device="cpu")
    cfg = ref_ner.NerConfig(dm=32, heads=2, layers=3, window=16,
                            labels=("entity", "code identifier", "Person"))
    ref = ref_ner.NerModel(cfg, seed=7)
    port = ner.NerModel(ner.NerConfig(**vars(cfg)), device="cpu")
    port.load_params(ref.params)
    return ref, port


@pytest.mark.parametrize("kind", ["bundled", "random"])
def test_logits_match_flax(kind):
    ref, port = _pair(kind)
    ng, cf, mask = _windows(port.cfg)
    want = np.asarray(ref._predict(ref.params, ng, cf, mask))
    got = port.logits(ng, cf, mask).numpy()
    assert got.shape == want.shape == (len(ng), port.cfg.window, port.num_tags)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    # the module's own forward, labels encoded in it, as the flax Tagger runs
    with torch.no_grad():
        full = port.model(*(torch.from_numpy(a) for a in (ng, cf, mask)),
                          port._lab_ng, port._lab_cf).numpy()
    np.testing.assert_allclose(full, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("kind", ["bundled", "random"])
def test_the_label_windows_encode_as_in_flax(kind):
    """The label names go through the encoder at their own length (4), all
    positions unmasked: the port's encoder output there is the flax
    encoder's second call's (captured as an intermediate)."""
    ref, port = _pair(kind)
    ng, cf, mask = _windows(ref.cfg, n=2)
    _, state = ref.model.apply(ref.params, ng, cf, mask, ref._lab_ng, ref._lab_cf,
                               capture_intermediates=True, mutable=["intermediates"])
    text_enc, label_enc = state["intermediates"]["encoder"]["__call__"]
    lab_mask = torch.ones(port._lab_ng.shape[:-1])
    with torch.no_grad():
        got = port.model.encoder(port._lab_ng, port._lab_cf, lab_mask).numpy()
        got_text = port.model.encoder(*(torch.from_numpy(a) for a in (ng, cf, mask))).numpy()
    assert got.shape == (len(port.cfg.labels), 4, port.cfg.dm)
    np.testing.assert_allclose(got, np.asarray(label_enc), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got_text, np.asarray(text_enc), atol=1e-5, rtol=0)


@pytest.mark.parametrize("kind", ["bundled", "random"])
def test_tag_and_extract_match_the_reference(kind):
    ref, port = _pair(kind)
    for text in TEXTS:
        toks = [t for t, _ in ref_ner.word_tokenize(text)]
        for w0 in range(0, max(len(toks), 1), port.cfg.window):
            got_ids, got_conf = port.tag(toks[w0:w0 + port.cfg.window])
            want_ids, want_conf = ref.tag(toks[w0:w0 + port.cfg.window])
            assert np.array_equal(got_ids, want_ids)
            np.testing.assert_allclose(got_conf, want_conf, atol=1e-5, rtol=0)
        got, want = port.extract(text), ref.extract(text)
        assert [(e, lab) for e, lab, _ in got] == [(e, lab) for e, lab, _ in want]
        np.testing.assert_allclose([c for *_, c in got], [c for *_, c in want], atol=1e-5)
        assert ner.NeuralEntityExtractor(port).extract_entities(text) == port.extract(text)
    if kind == "bundled":
        names = {e for e, *_ in port.extract(TEXTS[0])}
        assert {"CacheManager", "ingest_queue_worker"} <= names and "When" not in names


def test_the_plugin_extracts_the_references_entities():
    from yams_tpu.plugins.neural_ner import yams_plugin as ref_plugin
    from yams_tpu_torch.plugins.spec import IFACE_ENTITY_EXTRACTOR

    port, ref = port_plugin.yams_plugin(), ref_plugin()
    port.init({"device": "cpu"})
    ref.init({})
    assert port.health() == ref.health() == {"status": "ok", "labels": ["entity"]}
    pe, re_ = (m.get_interface(IFACE_ENTITY_EXTRACTOR) for m in (port, ref))
    for text in TEXTS:
        got, want = pe.extract_entities(text), re_.extract_entities(text)
        assert [g[:2] for g in got] == [w[:2] for w in want]
    dormant = port_plugin.yams_plugin()
    dormant.init({"use_bundled": False, "device": "cpu"})
    assert dormant.health()["status"] == "degraded"
    assert dormant.get_interface(IFACE_ENTITY_EXTRACTOR).extract_entities("Foo Bar") == []


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_each_package_loads_the_others_checkpoint(tmp_path, writer):
    ref, port = _pair("random")
    path = tmp_path / "ner.pkl"
    (port if writer == "port" else ref).save(path)
    loaded_ref = ref_ner.NerModel.load(path)
    loaded_port = ner.NerModel.load(path, device="cpu")
    assert loaded_port.cfg == port.cfg
    ng, cf, mask = _windows(port.cfg, seed=1, n=6)
    np.testing.assert_allclose(loaded_port.logits(ng, cf, mask).numpy(),
                               np.asarray(loaded_ref._predict(loaded_ref.params, ng, cf, mask)),
                               atol=1e-5, rtol=0)
    state = port.model.state_dict()
    assert all(torch.equal(v, loaded_port.model.state_dict()[k]) for k, v in state.items())


def test_the_state_dict_keeps_the_flax_names_and_shapes():
    ref, _ = _pair("bundled")
    state = convert.ner_state_from_flax(ref.params)
    assert state["encoder.attn0.query.kernel"].shape == (64, 4, 16)
    assert state["encoder.attn1.out.kernel"].shape == (4, 16, 64)
    assert state["encoder.subword.embedding"].shape == (4096, 64)
    assert state["encoder.pos.embedding"].shape == (32, 64)
    port = ner.NerModel(ner.NerConfig(window=32), device="cpu")
    assert set(state) == set(port.model.state_dict())
    back = convert.ner_flax_from_state(state)
    for k, v in state.items():
        node = back["params"]
        for part in k.split("."):
            node = node[part]
        assert np.array_equal(node, v.numpy())


def test_load_refuses_other_globals(tmp_path):
    class Evil:
        def __reduce__(self):
            return (print, ("ran",))

    path = tmp_path / "evil.pkl"
    path.write_bytes(pickle.dumps({"cfg": {"labels": ["x"]}, "params": Evil()}))
    with pytest.raises(pickle.UnpicklingError, match="builtins.print"):
        ner.NerModel.load(path, device="cpu")


def test_load_needs_no_flax():
    code = textwrap.dedent(f"""
        import sys

        class _Refuse:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("yams_tpu", "jax", "jaxlib", "flax", "optax"):
                    raise ModuleNotFoundError(name)

        sys.meta_path.insert(0, _Refuse())
        from yams_tpu_torch.embed.ner import NerModel
        m = NerModel.load({str(BUNDLED)!r}, device="cpu")
        print(sorted(e for e, *_ in m.extract({TEXTS[0]!r})))
    """)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=240)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "['CacheManager', 'ingest_queue_worker']"


def test_seeded_weights_are_the_ports_own():
    a = ner.NerModel(ner.NerConfig(window=16), seed=3, device="cpu")
    b = ner.NerModel(ner.NerConfig(window=16), seed=3, device="cpu")
    c = ner.NerModel(ner.NerConfig(window=16), seed=4, device="cpu")
    sa, sb, sc = (m.model.state_dict() for m in (a, b, c))
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["encoder.case.kernel"], sc["encoder.case.kernel"])
    assert torch.all(sa["encoder.ln_out.scale"] == 1) and torch.all(sa["to_begin.bias"] == 0)
