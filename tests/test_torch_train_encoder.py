"""The port's encoder training against the reference scripts', on the CPU.

- `utils.optim.warmup_cosine_decay_schedule` gives optax's value at every
  count of a run (f32: the warmup bit-equal, the cosine within one ulp of
  the peak, where XLA's and NumPy's f32 cosines round otherwise), and
  `AdamW` takes optax.adamw's steps on the same leaves and gradients
  (leaves within 2e-6 relative after each of 30 steps);
  `softmax_cross_entropy` is optax's.
- `embed.hf_encoder.init_params` draws the reference scripts' weights bit
  for bit; `build_vocab`, `pseudo_queries` and the batches are the scripts'.
- The contrastive step at a small width (D 32, 1 layer): the first step's
  gradients against the reference's step, rebuilt here from
  `yams_tpu.embed.hf_encoder.bert_forward` and optax exactly as
  scripts/train_encoder.py builds it (every leaf within 1e-5 of the largest
  gradient, and within 1e-4 of its own largest but the key biases, whose
  gradient is zero in exact arithmetic: the softmax cannot see a shift of
  every key score), and 10 steps' losses (relative 1e-5).
- A port-written `.npz` loads in the reference's `hf` provider, vectors
  within 1e-5 of the port's provider on it.
- `synthetic_beir` and the metrics equal the reference's, case by case.
"""

import importlib.util
import math
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from yams_tpu.embed import hf_encoder as ref_hf
from yams_tpu.utils import beir as ref_beir
from yams_tpu.utils import metrics as ref_metrics
from yams_tpu_torch.embed import hf_encoder
from yams_tpu_torch.scripts import train_encoder, train_encoder_realtext
from yams_tpu_torch.utils import beir, metrics, optim

REPO = pathlib.Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


def _ref_script(name):
    spec = importlib.util.spec_from_file_location(f"ref_{name}", REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF_TRAIN = _ref_script("train_encoder")
REF_REALTEXT = _ref_script("train_encoder_realtext")


# -- schedule, optimizer, loss ---------------------------------------------------
@pytest.mark.parametrize("init,peak,warmup,decay", [
    (0.0, 3e-4, 50, 600), (0.0, 3e-4, 100, 1500), (0.0, 3e-4, 1, 10), (1e-5, 1e-3, 7, 40),
    (0.0, 3e-4, 0, 20)])
def test_schedule_matches_optax(init, peak, warmup, decay):
    want_fn = optax.warmup_cosine_decay_schedule(init, peak, warmup, decay)
    got_fn = optim.warmup_cosine_decay_schedule(init, peak, warmup, decay)
    counts = range(decay + 6)
    want = np.array([float(want_fn(c)) for c in counts], np.float32)
    got = np.array([got_fn(c) for c in counts], np.float32)
    assert got[0] == want[0] and (init or warmup == 0 or got[0] == 0.0)  # lr 0 from init 0
    assert np.array_equal(got[:warmup + 1], want[:warmup + 1]) or warmup == 0   # the warmup
    # the cosine: 1 + cos(pi t / T) cancels near the end, where the last bit
    # of the two f32 cosines shows; each value within one ulp of the peak
    err = np.abs(got.astype(np.float64) - want) / np.spacing(np.float32(peak))
    assert err.max() <= 1.0, (int(err.argmax()), got[err.argmax()], want[err.argmax()])


@pytest.mark.parametrize("lr,wd", [(3e-3, 1e-4), ("schedule", 0.01), (1e-2, 0.0)])
def test_adamw_matches_optax(lr, wd):
    """Seeded leaves and 30 steps of seeded gradients (some exactly zero)."""
    rng = np.random.default_rng(4)
    shapes = [(5, 7), (7,), (3, 4, 2), (1,)]
    leaves = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    sched = optax.warmup_cosine_decay_schedule(0.0, 3e-4, 5, 30)
    tx = optax.adamw(sched if lr == "schedule" else lr, weight_decay=wd)
    ref_params = [jnp.asarray(a) for a in leaves]
    state = tx.init(ref_params)
    port = [torch.tensor(a) for a in leaves]
    opt = optim.AdamW(port, optim.warmup_cosine_decay_schedule(0.0, 3e-4, 5, 30)
                      if lr == "schedule" else lr, weight_decay=wd)
    for step in range(30):
        grads = [(rng.standard_normal(s) * (rng.random(s) > 0.2)).astype(np.float32)
                 for s in shapes]
        upd, state = tx.update([jnp.asarray(g) for g in grads], state, ref_params)
        ref_params = optax.apply_updates(ref_params, upd)
        opt.step([torch.tensor(g) for g in grads])
        for got, want in zip(port, ref_params):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-6, atol=1e-9,
                                       err_msg=f"step {step}")
    assert opt.count == 30


@pytest.mark.parametrize("shape", [(4, 9), (3, 5, 7)])
def test_softmax_cross_entropy_matches_optax(shape):
    rng = np.random.default_rng(1)
    logits = (rng.standard_normal(shape) * 6).astype(np.float32)
    labels = rng.integers(0, shape[-1], shape[:-1])
    want = optax.softmax_cross_entropy_with_integer_labels(jnp.asarray(logits),
                                                           jnp.asarray(labels))
    got = optim.softmax_cross_entropy(torch.tensor(logits), torch.tensor(labels))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


# -- init, vocabulary, batches --------------------------------------------------
@pytest.mark.parametrize("script", ["train_encoder", "train_encoder_realtext"])
def test_init_params_are_the_scripts(script, monkeypatch):
    ref = REF_TRAIN if script == "train_encoder" else REF_REALTEXT
    shape = {"dim": 32, "layers": 2, "intermediate": 48, "max_len": ref.MAX_LEN}
    monkeypatch.setattr(ref, "DIM", 32)
    monkeypatch.setattr(ref, "LAYERS", 2)
    monkeypatch.setattr(ref, "INTERMEDIATE", 48)
    want = ref.init_params(np.random.default_rng(0), 101)
    got = hf_encoder.init_params(np.random.default_rng(0), 101, **shape)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


def test_synthetic_vocab_and_batches_are_the_scripts():
    data = train_encoder.SyntheticData()
    full = ref_beir.synthetic_beir(n_queries=550)
    assert data.vocab == REF_TRAIN.build_vocab(full.corpus)
    # the reference loop's draws, for 3 batches
    rng = np.random.default_rng(1)
    tok = ref_hf.WordPieceTokenizer(data.vocab)
    qids = [q for q in full.queries if int(q[1:]) >= 50]
    gen = data.batches(np.random.default_rng(1))
    for _ in range(3):
        batch_q = rng.choice(qids, 32, replace=False)
        d_texts = []
        for q in batch_q:
            rel = sorted(full.relevant(q))
            d_texts.append(full.corpus[rel[rng.integers(len(rel))]]["text"])
        got = next(gen)
        want_q = [tok.encode(full.queries[q], 16) for q in batch_q]
        want_d = [tok.encode(t, 96) for t in d_texts]
        for ids, attn, rows in ((got[0], got[1], want_q), (got[2], got[3], want_d)):
            for i, row in enumerate(rows):
                assert ids[i, :len(row)].tolist() == row and attn[i].sum() == len(row)


def test_realtext_vocab_and_pseudo_queries_are_the_scripts():
    ds = ref_beir.synthetic_beir(n_queries=10)
    corpus = {d: {"title": "", "text": v["text"] + " CacheManager TopologyRoutingSession"}
              for d, v in list(ds.corpus.items())[:120]}
    assert train_encoder_realtext.build_vocab(corpus) == REF_REALTEXT.build_vocab(corpus)
    from yams_tpu.embed.simeon import tokenize

    toks = {d: list(tokenize(v["text"])) for d, v in corpus.items()}
    df = {}
    for t in toks.values():
        for w in set(t):
            df[w] = df.get(w, 0) + 1
    a, b = np.random.default_rng(3), np.random.default_rng(3)
    for d, v in corpus.items():
        assert train_encoder_realtext.pseudo_queries(toks[d], df, len(corpus), a, v["text"]) \
            == REF_REALTEXT.pseudo_queries(toks[d], df, len(corpus), b, v["text"])


@pytest.mark.parametrize("steps,want", [(1, 1), (10, 1), (11, 1), (999, 99), (1500, 100)])
def test_realtext_warmup_is_the_scripts(steps, want):
    assert train_encoder_realtext.warmup_steps(steps) == want == min(100, max(1, steps // 10))


# -- the contrastive step against the reference's --------------------------------
SMALL = {"dim": 32, "layers": 1, "heads": 2, "intermediate": 64, "max_len": 96}


def _ref_step_fn(steps, warmup):
    """scripts/train_encoder.py's step (its lines building opt, fwd, step)."""
    opt = optax.adamw(optax.warmup_cosine_decay_schedule(0.0, 3e-4, warmup, steps),
                      weight_decay=0.01)

    def fwd(p, ids, attn):
        return ref_hf.bert_forward(p, ids, attn, num_layers=SMALL["layers"],
                                   num_heads=SMALL["heads"], compute_dtype="float32")

    @jax.jit
    def step(params, opt_state, q_ids, q_attn, d_ids, d_attn):
        def loss_fn(p):
            qv = fwd(p, q_ids, q_attn)
            dv = fwd(p, d_ids, d_attn)
            logits = qv @ dv.T * 20.0
            labels = jnp.arange(logits.shape[0])
            return (optax.softmax_cross_entropy_with_integer_labels(logits, labels).mean()
                    + optax.softmax_cross_entropy_with_integer_labels(
                        logits.T, labels).mean()) * 0.5

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = opt.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss, grads

    return opt, step


@pytest.fixture(scope="module")
def synthetic():
    return train_encoder.SyntheticData()


def test_contrastive_step_matches_the_reference_script(synthetic):
    steps, warmup = 10, 3
    init = hf_encoder.init_params(np.random.default_rng(0), len(synthetic.vocab),
                                  **{k: v for k, v in SMALL.items() if k != "heads"})
    trainer = train_encoder.ContrastiveTrainer(init, heads=SMALL["heads"], steps=steps,
                                               warmup=warmup, device="cpu")
    opt, step = _ref_step_fn(steps, warmup)
    params = {k: jnp.asarray(v) for k, v in init.items()}
    opt_state = opt.init(params)
    gen = synthetic.batches(np.random.default_rng(1))
    got, want = [], []
    for s in range(steps):
        batch = next(gen)
        if s == 0:
            loss = trainer.loss(*trainer.to_device(batch))
            grads = dict(zip(trainer.state, torch.autograd.grad(loss, trainer.leaves)))
        params, opt_state, ref_loss, ref_grads = step(params, opt_state,
                                                      *(np.asarray(a) for a in batch))
        if s == 0:
            top = max(float(np.abs(np.asarray(g)).max()) for g in ref_grads.values())
            for k, g in ref_grads.items():
                g, mine = np.asarray(g), grads[k.replace("/", ".")].numpy()
                err = float(np.abs(mine - g).max())
                assert err <= 1e-5 * top, (k, err / top)
                if k.endswith("attn/k/bias"):
                    # a shift of every key score, which the softmax cannot see:
                    # zero in exact arithmetic, rounding noise in each package
                    assert max(float(np.abs(g).max()), float(np.abs(mine).max())) <= 1e-9 * top
                else:
                    assert err <= 1e-4 * float(np.abs(g).max()), (k, err)
        got.append(float(trainer.step(batch)))
        want.append(float(ref_loss))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert got[-1] < got[0]


def test_port_npz_loads_in_the_reference_hf_provider(tmp_path, synthetic):
    from yams_tpu.embed.provider import HFProvider as RefHF
    from yams_tpu_torch.embed.provider import HFProvider

    init = hf_encoder.init_params(np.random.default_rng(0), len(synthetic.vocab),
                                  **{k: v for k, v in SMALL.items() if k != "heads"})
    trainer = train_encoder.ContrastiveTrainer(init, heads=SMALL["heads"], steps=4,
                                               warmup=1, device="cpu")
    gen = synthetic.batches(np.random.default_rng(1))
    for _ in range(3):
        trainer.step(next(gen))
    path = tmp_path / "enc.npz"
    trainer.save(path, synthetic.vocab)
    z = np.load(path)
    assert {k: int(z[k]) for k in z.files if k.startswith("cfg/")} == {
        "cfg/dim": 32, "cfg/layers": 1, "cfg/heads": 2, "cfg/max_len": 96,
        "cfg/vocab_size": len(synthetic.vocab), "cfg/intermediate": 64}
    assert [str(v) for v in z["vocab"]] == synthetic.vocab
    texts = [synthetic.full.queries[f"q{i}"] for i in range(8)] + ["", "unknownword zz"]
    want = RefHF(str(path), compute_dtype="float32").encode(texts)
    got = HFProvider(str(path), compute_dtype="float32", device="cpu").encode(texts)
    assert got.shape == (10, 32)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


# -- data and metrics copies -------------------------------------------------------
@pytest.mark.parametrize("kw", [{}, {"seed": 3}, {"n_queries": 550}, {
    "seed": 9, "n_concepts": 8, "n_pairs": 6, "docs_per_pair": 3, "n_queries": 12}])
def test_synthetic_beir_matches_reference(kw):
    got, want = beir.synthetic_beir(**kw), ref_beir.synthetic_beir(**kw)
    assert (got.name, got.corpus, got.queries, got.qrels) == \
        (want.name, want.corpus, want.queries, want.qrels)
    for q in list(want.queries)[:5]:
        assert got.relevant(q) == want.relevant(q)


def test_load_beir_matches_reference(tmp_path):
    import json

    (tmp_path / "qrels").mkdir()
    ds = ref_beir.synthetic_beir(n_queries=6)
    with open(tmp_path / "corpus.jsonl", "w") as f:
        for d, v in ds.corpus.items():
            f.write(json.dumps({"_id": d, **v}) + "\n")
    with open(tmp_path / "queries.jsonl", "w") as f:
        for q, t in ds.queries.items():
            f.write(json.dumps({"_id": q, "text": t}) + "\n")
        f.write(json.dumps({"_id": "unjudged", "text": "x"}) + "\n")
    with open(tmp_path / "qrels" / "test.tsv", "w") as f:
        f.write("query-id\tcorpus-id\tscore\n")
        for q, rel in ds.qrels.items():
            for d, g in rel.items():
                f.write(f"{q}\t{d}\t{g}\n")
    got, want = beir.load_beir(tmp_path), ref_beir.load_beir(tmp_path)
    assert (got.corpus, got.queries, got.qrels) == (want.corpus, want.queries, want.qrels)
    assert "unjudged" not in got.queries


RUNS = [
    (["a", "b", "c"], {"b"}), (["a", "b", "c"], set()), ([], {"a"}),
    (["x"] * 3 + ["a"], {"a", "b"}), (list("abcdefghijkl"), set("lkj")),
    (list("abcdefghij"), set("abcdefghijklmno")), (["a"], {"a"}),
]


@pytest.mark.parametrize("i", range(len(RUNS)))
@pytest.mark.parametrize("k", [1, 3, 10])
def test_metrics_match_reference(i, k):
    ranked, rel = RUNS[i]
    for name in ("recall_at_k", "precision_at_k", "ndcg_at_k"):
        assert getattr(metrics, name)(ranked, rel, k) == getattr(ref_metrics, name)(ranked, rel, k)
    assert metrics.reciprocal_rank(ranked, rel) == ref_metrics.reciprocal_rank(ranked, rel)
    assert metrics.evaluate(RUNS[: i + 1], k=k) == ref_metrics.evaluate(RUNS[: i + 1], k=k)
    assert metrics.evaluate([], k=k) == ref_metrics.evaluate([], k=k)
    assert not math.isnan(metrics.evaluate(RUNS, k=k)["ndcg"])
