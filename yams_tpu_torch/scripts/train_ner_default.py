"""Train a default NER checkpoint on the card.

Port of scripts/train_ner_default.py: a synthetic supervision corpus for
software-knowledge-base text (entities are code identifiers, CamelCase and
snake_case, and multiword capitalized names; hard negatives include
sentence-initial capitalized ordinary words), plus rule-labeled windows of
real in-repo text, trained with `NerModel.fit` (dm 64, 4 heads, 2 layers,
window 32, lr 3e-3, batch 32, 1,200 steps by default). The generator,
the real-text miner and the token F1 are the reference script's code.

It departs from the reference script in these ways:

- it writes the checkpoint to the path it is given (the reference always
  overwrites the bundled `plugins/data/ner_default.pkl`);
- the real-text windows come from this repository's docs, README and
  CHANGELOG; the reference also mines the source comments of its own
  upstream checkout, read from a fixed path that no host of the port has;
- the model trains on `--device` (the card unless the caller asks for the
  CPU), starting from the port's seeded weights (`NerModel(cfg, seed=0)`:
  torch cannot draw JAX's PRNG stream).

    python -m yams_tpu_torch.scripts.train_ner_default out.pkl [steps] [--device cuda]
"""

from __future__ import annotations

import argparse
import pathlib

import numpy as np

from ..embed.ner import NerConfig, NerModel, identifier_shape, word_tokenize

REPO = pathlib.Path(__file__).resolve().parents[2]
CONFIG = NerConfig(dm=64, heads=4, layers=2, window=32, labels=("entity",))
STEPS, LR, BATCH = 1200, 3e-3, 32

CTX = (
    "the a this that runs calls reads writes updates handles owns drives "
    "feeds uses builds loads stores sends gets checks after before during "
    "with into over under between against through result value state data "
    "request response error config slowly quickly carefully finally often"
).split()

# sentence-initial ordinary words that LOOK like entities when capitalized
HARD_STARTS = "When Then While After Before Finally However Usually".split()

CAMEL_PARTS = (
    "Post Ingest Queue Embed Service Vector Data Base Search Engine Chunk "
    "Store Meta Repo Graph Node Edge Token Stream Cache Manager Index Shard "
    "Worker Pool Config Loader Parser Writer Reader Socket Frame Codec"
).split()
SNAKE_PARTS = (
    "post ingest queue embed service vector data base search engine chunk "
    "store meta repo graph node edge token stream cache manager index shard"
).split()
PROPER_PARTS = (
    "Alpha Beta Gamma Delta Omega North South River Stone Iron Silver "
    "Falcon Raven Harbor Summit Cedar Maple"
).split()


def _entity(rng) -> list[str]:
    kind = rng.integers(0, 3)
    if kind == 0:      # CamelCase compound identifier (one token)
        n = int(rng.integers(2, 4))
        return ["".join(rng.choice(CAMEL_PARTS) for _ in range(n))]
    if kind == 1:      # snake_case identifier (one token)
        n = int(rng.integers(2, 4))
        return ["_".join(rng.choice(SNAKE_PARTS) for _ in range(n))]
    n = int(rng.integers(2, 4))   # multiword proper name
    return [str(rng.choice(PROPER_PARTS)) for _ in range(n)]


def synth_example(rng, window: int):
    toks: list[str] = []
    tags: list[int] = []
    # optionally open with a hard-negative capitalized ordinary word
    if rng.random() < 0.5:
        toks.append(str(rng.choice(HARD_STARTS)))
        tags.append(0)
    n_pre = int(rng.integers(1, 5))
    toks += [str(rng.choice(CTX)) for _ in range(n_pre)]
    tags += [0] * n_pre
    for _ in range(int(rng.integers(1, 3))):   # 1-2 entities per window
        ent = _entity(rng)
        toks += ent
        tags += [1] + [2] * (len(ent) - 1)
        n_mid = int(rng.integers(1, 5))
        toks += [str(rng.choice(CTX)) for _ in range(n_mid)]
        tags += [0] * n_mid
    return toks[:window], tags[:window]


TEXT_ROOTS = [REPO / "docs", REPO / "README.md", REPO / "CHANGELOG.md"]


def real_text_examples(window: int, limit: int = 800) -> list:
    """Rule-labeled windows from real text (markdown prose, and the comment
    lines of source files). Gold: identifier_shape -> B; everything else
    (incl. ambiguous capitalized words) -> O."""
    import re as _re

    fence = _re.compile(r"```.*?```", _re.S)
    comment = _re.compile(r"^\s*(?://+|\*+|#)\s?(.*)$")
    lines: list[str] = []
    for root in TEXT_ROOTS:
        if not root.exists():
            continue
        files = ([root] if root.is_file() else
                 sorted(list(root.rglob("*.md")) + list(root.rglob("*.h"))
                        + list(root.rglob("*.cpp"))))
        for f in files[:400]:
            try:
                text = f.read_text(errors="ignore")
            except OSError:
                continue
            if f.suffix == ".md":
                text = fence.sub(" ", text).replace("`", "")
                lines += [ln.strip("#>|-* \t") for ln in text.splitlines()]
            else:  # source files: comment prose only
                lines += [m.group(1) for ln in text.splitlines()
                          if (m := comment.match(ln))]
    out = []
    seen = set()
    for ln in lines:
        ln = ln.strip()
        if len(ln) < 30 or ln in seen:
            continue
        seen.add(ln)
        toks = [t for t, _ in word_tokenize(ln)][:window]
        if len(toks) < 4:
            continue
        tags = [1 if identifier_shape(t) else 0 for t in toks]
        out.append((toks, tags))
        if len(out) >= limit:
            break
    return out


def f1(model: NerModel, examples) -> float:
    tp = fp = fn = 0
    for toks, tags in examples:
        ids, _ = model.tag(toks)
        for got, want in zip(ids, tags):
            if want > 0 and got > 0:
                tp += 1
            elif want == 0 and got > 0:
                fp += 1
            elif want > 0 and got == 0:
                fn += 1
    p = tp / max(tp + fp, 1)
    r = tp / max(tp + fn, 1)
    return 2 * p * r / max(p + r, 1e-9)


def training_set(cfg: NerConfig = CONFIG):
    """The reference script's data, in its order: 512 synthetic windows and
    the real-text windows shuffled together, then 64 held-out synthetic
    windows, all from np.random.default_rng(0) -> (train, held, n_real)."""
    rng = np.random.default_rng(0)
    real = real_text_examples(cfg.window)
    synth = [synth_example(rng, cfg.window) for _ in range(512)]
    train = synth + real
    rng.shuffle(train)
    held = [synth_example(rng, cfg.window) for _ in range(64)]
    return train, held, len(real)


def train(out: str | pathlib.Path, steps: int = STEPS, device="cuda") -> dict:
    train_set, held, n_real = training_set(CONFIG)
    model = NerModel(CONFIG, seed=0, device=device)
    loss = model.fit(train_set, steps=steps, lr=LR, batch=BATCH)
    score = f1(model, held)
    model.save(out)
    return {"model": model, "loss": loss, "heldout_synth_token_f1": score,
            "synthetic": len(train_set) - n_real, "real": n_real}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out")
    ap.add_argument("steps", nargs="?", type=int, default=STEPS)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    r = train(a.out, a.steps, a.device)
    print(f"train: {r['synthetic']} synthetic + {r['real']} real-text windows")
    print(f"loss={r['loss']:.4f} heldout_synth_token_f1={r['heldout_synth_token_f1']:.3f} "
          f"-> {a.out}")
    print("real-text span-F1: python -m yams_tpu_torch.scripts.eval_ner_realtext")


if __name__ == "__main__":
    main()
