"""The port's `NerModel.fit` against the reference's, on the CPU.

Both packages start from the same flax init (the reference's seeded
weights, carried by `convert.ner_state_from_flax`), take the same examples
(the default-checkpoint script's generator) and the same seed:

- the per-step losses (20 steps) match the reference's step for step,
  relative 1e-4: the reference's `fit` is rebuilt here step for step (its
  featurization, loss and `optax.adamw(lr)`) to read each step's loss, and
  its own `fit` gives the rebuilt loop's last loss;
- after the fit the logits on held-out windows are within 1e-4 and the
  tags equal, but for named near-ties (top-2 margin < 1e-5); every leaf is
  within 1e-4 of the reference's, but the attention key biases (a shift
  of every key score, which the softmax cannot see: their gradient is
  rounding noise, and Adam turns it into steps of about lr, so they are
  held to a few lr);
- fine-tuning the bundled checkpoint is held looser, and by design: near
  its optimum many gradients are at rounding level, where Adam's first
  steps are about lr x sign(g) in each package with signs of their own
  (losses relative 1e-3, logits 5e-3, every leaf within STEPS x lr; on
  this data the tags stay equal, the smallest top-2 margin ~0.25);
- the label names' vectors take a gradient: the subword rows that only a
  label name's n-grams reach move as the reference's do;
- `fit` leaves the module in eval mode with the label cache cleared, and
  returns the last step's loss.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from yams_tpu.embed import ner as ref_ner
from yams_tpu_torch import convert
from yams_tpu_torch.embed import ner
from yams_tpu_torch.plugins import neural_ner as port_plugin
from yams_tpu_torch.scripts import train_ner_default

STEPS, LR, BATCH = 20, 3e-3, 16
CONFIGS = {
    "small": dict(dm=32, heads=2, layers=2, window=16, labels=("entity",)),
    "labels": dict(dm=32, heads=4, layers=1, window=16, labels=("entity", "zqxj wvk", "Person")),
}


def _examples(window, n, seed):
    rng = np.random.default_rng(seed)
    return [train_ner_default.synth_example(rng, window) for _ in range(n)]


def _ref_fit_losses(model, examples, steps, lr, batch, seed=0):
    """The reference's NerModel.fit, step for step, returning every loss."""
    L = model.cfg.window
    NG, CF, MK, TG = [], [], [], []
    for toks, tags in examples:
        ng, cf, mask = ref_ner.featurize(toks, L)
        t = np.zeros(L, np.int32)
        t[: min(len(tags), L)] = tags[:L]
        NG.append(ng); CF.append(cf); MK.append(mask); TG.append(t)
    NG, CF, MK, TG = (jnp.asarray(np.stack(a)) for a in (NG, CF, MK, TG))
    tx = optax.adamw(lr)
    opt_state = tx.init(model.params)

    def loss_fn(params, ng, cf, mk, tg):
        logits = model.model.apply(params, ng, cf, mk, model._lab_ng, model._lab_cf)
        ls = optax.softmax_cross_entropy_with_integer_labels(logits, tg)
        return (ls * mk).sum() / jnp.maximum(mk.sum(), 1.0)

    @jax.jit
    def step(params, opt_state, ng, cf, mk, tg):
        loss, grads = jax.value_and_grad(loss_fn)(params, ng, cf, mk, tg)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    rng = np.random.default_rng(seed)
    n = len(examples)
    out = []
    for _ in range(steps):
        idx = rng.integers(0, n, size=min(batch, n))
        model.params, opt_state, loss = step(model.params, opt_state,
                                             NG[idx], CF[idx], MK[idx], TG[idx])
        out.append(float(loss))
    return out


def _tagged_windows(cfg, examples):
    return [np.stack(a) for a in zip(*[ref_ner.featurize(t, cfg.window) for t, _ in examples])]


@functools.cache
def _fitted(kind):
    """(reference model, port model, init params, reference losses, port
    losses, port's return value, examples) after STEPS steps from one init."""
    if kind == "bundled":
        ref = ref_ner.NerModel.load(port_plugin._BUNDLED)
        port = ner.NerModel.load(port_plugin._BUNDLED, device="cpu")
    else:
        cfg = ref_ner.NerConfig(**CONFIGS[kind])
        ref = ref_ner.NerModel(cfg, seed=7)
        port = ner.NerModel(ner.NerConfig(**CONFIGS[kind]), device="cpu")
        port.load_params(ref.params)
    init = jax.tree_util.tree_map(np.asarray, ref.params)
    examples = _examples(ref.cfg.window, 96, seed=1)
    want = _ref_fit_losses(ref, examples, STEPS, LR, BATCH)
    got = []
    last = port.fit(examples, steps=STEPS, lr=LR, batch=BATCH, losses=got)
    return ref, port, init, want, [float(x) for x in got], last, examples


KINDS = ["small", "labels", "bundled"]
# (loss rtol, logits atol, leaf atol) of each kind; see the module docstring
TOL = {"small": (1e-4, 1e-4, 1e-4), "labels": (1e-4, 1e-4, 1e-4),
       "bundled": (1e-3, 5e-3, STEPS * LR)}


@pytest.mark.parametrize("kind", KINDS)
def test_fit_losses_match_the_reference_step_for_step(kind):
    _ref, _port, _init, want, got, last, _ex = _fitted(kind)
    assert len(got) == STEPS and last == got[-1]
    np.testing.assert_allclose(got, want, rtol=TOL[kind][0])
    assert got[-1] < got[0] or kind == "bundled"     # the bundled model starts trained


def test_rebuilt_loop_is_the_reference_fit():
    """The reference's own fit, from the same init, ends at the rebuilt
    loop's last loss."""
    ref, _port, init, want, _got, _last, examples = _fitted("small")
    fresh = ref_ner.NerModel(ref.cfg, seed=7)
    fresh.params = jax.tree_util.tree_map(jnp.asarray, init)
    assert fresh.fit(examples, steps=STEPS, lr=LR, batch=BATCH) == pytest.approx(want[-1], rel=1e-6)


@pytest.mark.parametrize("kind", KINDS)
def test_fitted_logits_and_tags_match_on_held_out_windows(kind):
    ref, port, *_ = _fitted(kind)
    held = _examples(ref.cfg.window, 48, seed=99)
    feats = _tagged_windows(ref.cfg, held)
    want = np.asarray(ref._predict(ref.params, *feats))
    got = port.logits(*feats).numpy()
    assert np.abs(got - want).max() <= TOL[kind][1]
    live = feats[2] > 0
    probs = np.asarray(jax.nn.softmax(want, -1))
    top2 = np.sort(probs, -1)[..., -2:]
    ties = (top2[..., 1] - top2[..., 0] < 1e-5) & live
    differ = (got.argmax(-1) != want.argmax(-1)) & live
    assert not (differ & ~ties).any(), [tuple(x) for x in np.argwhere(differ & ~ties)]
    for i, (toks, _) in enumerate(held[:12]):
        if not ties[i].any():
            assert [e[:2] for e in port.extract(" ".join(toks))] == \
                [e[:2] for e in ref.extract(" ".join(toks))]


@pytest.mark.parametrize("kind", KINDS)
def test_fitted_leaves_match_the_reference(kind):
    ref, port, init, *_ = _fitted(kind)
    want = convert.ner_state_from_flax(jax.tree_util.tree_map(np.asarray, ref.params))
    start = convert.ner_state_from_flax(init)
    got = port.model.state_dict()
    assert set(got) == set(want)
    for k, w in want.items():
        err = float((got[k] - w).abs().max())
        if k.endswith("key.bias"):
            assert err <= STEPS * LR, (k, err)
        else:
            assert err <= TOL[kind][2], (k, err)
        assert not torch.equal(got[k], start[k]), f"{k} did not move"


def test_label_vectors_take_a_gradient():
    """The subword rows that only the label names' n-grams reach (no example
    window holds them) move by Adam steps, as the reference's do: the label
    vectors are in each step's graph."""
    ref, port, init, *_, examples = _fitted("labels")
    window_rows = set()
    for toks, _ in examples:
        ng, _cf, _m = ref_ner.featurize(toks, ref.cfg.window)
        window_rows |= set(ng.ravel().tolist())
    label_rows = sorted(set(np.asarray(ref._lab_ng).ravel().tolist()) - window_rows - {0})
    assert len(label_rows) >= 4
    start = init["params"]["encoder"]["subword"]["embedding"][label_rows]
    got = port.model.encoder.subword.embedding.detach().numpy()[label_rows]
    want = np.asarray(ref.params["params"]["encoder"]["subword"]["embedding"])[label_rows]
    assert np.abs(got - start).max() >= 10 * LR      # far beyond the weight decay's reach
    assert np.abs(got - want).max() <= 1e-4


def test_fit_leaves_eval_mode_and_clears_the_label_cache():
    m = ner.NerModel(ner.NerConfig(dm=16, heads=2, layers=1, window=8), device="cpu")
    m.tag(["the", "CacheManager"])
    assert m._labels is not None
    seen = []
    orig = m.model.forward

    def spy(*a):
        seen.append(m.model.training)
        return orig(*a)

    m.model.forward = spy
    loss = m.fit([(["the", "CacheManager", "runs"], [0, 1, 0])], steps=3, lr=1e-2, batch=4)
    assert seen == [True] * 3 and not m.model.training and m._labels is None
    assert isinstance(loss, float) and np.isfinite(loss)
    ng, cf, mask = ner.featurize(["the", "CacheManager"], 8)
    with torch.inference_mode():
        fresh = m.model(*(torch.from_numpy(a[None]) for a in (ng, cf, mask)),
                        m._lab_ng, m._lab_cf)
    assert torch.equal(m.logits(ng[None], cf[None], mask[None]), fresh)
