"""Span-F1 of an NER checkpoint on real text.

Port of scripts/eval_ner_realtext.py: prose sentences mined from a
real-text root's markdown (code fences stripped, inline code kept as
words) are tagged with `NerModel.extract`, and the "entity" label is scored
by exact character span against rule-exact gold: a token that is a code
identifier by shape (`identifier_shape`: "_", an interior capital with
lowercase present, or a dotted path of such parts) is an entity;
capitalized ordinary words and ALLCAPS acronyms (`ambiguous_shape`) are
removed from gold and predictions alike. The miner, the gold and the
scoring are the reference script's code.

It departs from the reference script in these ways:

- it reads the root it is given (`--root`, else YAMS_REALTEXT_DIR): its
  `docs/` markdown and its `README.md`; the reference reads its upstream
  checkout from a fixed path;
- `--checkpoint` picks the model (the bundled `ner_default.pkl` by
  default), `--device` the device (the card unless the caller asks for the
  CPU), and `--retrain` also trains a fresh model with
  `train_ner_default`'s corpus and configuration (`--steps`) and scores it
  beside the checkpoint (the reference documents the flag but ignores it).

    python -m yams_tpu_torch.scripts.eval_ner_realtext [--root DIR] [--retrain]
        [--steps 1200] [--device cuda]
"""

from __future__ import annotations

import argparse
import pathlib
import re
import tempfile

from ..embed.ner import ambiguous_shape, identifier_shape

MAX_SENTENCES = 260
SEED = 11

_FENCE_RE = re.compile(r"```.*?```", re.S)
_INLINE_CODE_RE = re.compile(r"`([^`]*)`")
_MD_NOISE_RE = re.compile(r"^[#>|\-\*\s]*")
_SENT_SPLIT_RE = re.compile(r"(?<=[.!?])\s+")
_TOKEN_RE = re.compile(r"[A-Za-z_][A-Za-z0-9_]*(?:\.[A-Za-z_][A-Za-z0-9_]*)*")


def doc_roots(root) -> list[pathlib.Path]:
    root = pathlib.Path(root)
    return [root / "docs", root / "README.md"]


def mine_sentences(roots) -> list[str]:
    import numpy as np

    texts = []
    for root in roots:
        files = sorted(root.rglob("*.md")) if root.is_dir() else [root]
        for f in files:
            try:
                texts.append(f.read_text(errors="ignore"))
            except OSError:
                pass
    out = []
    for t in texts:
        t = _FENCE_RE.sub(" ", t)
        t = _INLINE_CODE_RE.sub(r"\1", t)  # keep inline-code words as words
        for line in t.splitlines():
            line = _MD_NOISE_RE.sub("", line).strip()
            if len(line) < 30:
                continue
            for s in _SENT_SPLIT_RE.split(line):
                s = s.strip()
                if 30 <= len(s) <= 400:
                    out.append(s)
    # dedupe, stable shuffle, cap
    out = sorted(set(out))
    rng = np.random.default_rng(SEED)
    rng.shuffle(out)
    return out[:MAX_SENTENCES]


def gold_spans(sentence: str) -> tuple[set[tuple[int, int]], set[tuple[int, int]]]:
    """-> (gold identifier spans, excluded ambiguous spans), char offsets."""
    gold, excluded = set(), set()
    for m in _TOKEN_RE.finditer(sentence):
        tok = m.group(0)
        span = (m.start(), m.end())
        if identifier_shape(tok):
            gold.add(span)
        elif ambiguous_shape(tok):
            excluded.add(span)
    return gold, excluded


def evaluate(model, sentences: list[str], min_conf: float = 0.5) -> dict:
    tp = fp = fn = 0
    n_gold = 0
    for s in sentences:
        gold, excluded = gold_spans(s)
        n_gold += len(gold)
        pred = set()
        for text, _label, conf in model.extract(s, min_conf=min_conf):
            for m in re.finditer(re.escape(text), s):
                pred.add((m.start(), m.end()))
                break
        pred -= excluded
        tp += len(pred & gold)
        fp += len(pred - gold)
        fn += len(gold - pred)
    prec = tp / (tp + fp) if tp + fp else 0.0
    rec = tp / (tp + fn) if tp + fn else 0.0
    f1 = 2 * prec * rec / (prec + rec) if prec + rec else 0.0
    return {"sentences": len(sentences), "gold_spans": n_gold,
            "precision": round(prec, 3), "recall": round(rec, 3),
            "span_f1": round(f1, 3)}


def main(argv=None) -> None:
    from ..embed.ner import NerModel
    from ..plugins.neural_ner import _BUNDLED
    from .realtext import resolve_root

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=None, help="real-text root (else YAMS_REALTEXT_DIR)")
    ap.add_argument("--checkpoint", default=str(_BUNDLED))
    ap.add_argument("--retrain", action="store_true")
    ap.add_argument("--steps", type=int, default=1200)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    sentences = mine_sentences(doc_roots(resolve_root(a.root)))
    print(f"mined {len(sentences)} real sentences")
    model = NerModel.load(a.checkpoint, device=a.device)
    print({"metric": "ner_realtext", "model": a.checkpoint, **evaluate(model, sentences)})
    if a.retrain:
        from .train_ner_default import train

        with tempfile.TemporaryDirectory() as tmp:
            fitted = train(pathlib.Path(tmp) / "ner.pkl", a.steps, a.device)["model"]
        print({"metric": "ner_realtext", "model": f"retrained ({a.steps} steps)",
               **evaluate(fitted, sentences)})


if __name__ == "__main__":
    main()
