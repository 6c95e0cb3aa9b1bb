"""Train the sentence encoder on a real-text corpus (ICT-style), on the card.

Port of scripts/train_encoder_realtext.py: the BERT-architecture encoder
of train_encoder.py (its `ContrastiveTrainer`) trained on the
realtext-BEIR chunks of a real-text root (`scripts/realtext.py`
`realtext_beir`) with Inverse-Cloze-Task pseudo-queries drawn from the
chunk bodies (`pseudo_queries`: a 4-10 token span, 3-6 low-df keywords, a
camel-split identifier of the chunk); the eval's heading and symbol
queries are never trained on. The vocabulary (`build_vocab`: specials,
suffix pieces and the 24,000 most frequent tokens with their stems), the
pseudo-queries and the batches draw the reference's streams
(`np.random.default_rng(3)`, B 32, QT 16, DT 128); the schedule warms up
over min(100, max(1, steps // 10)) steps to 3e-4, weight decay 0.01. Width
and depth come from the reference's variables: ENC_DIM (128), ENC_LAYERS
(2), ENC_HEADS (4), ENC_FFN (2 x ENC_DIM); the in-repo
realtext_bert_d192.npz is ENC_DIM=192 ENC_LAYERS=3 ENC_HEADS=6.

It departs from the reference script in these ways: it reads the root it
is given (`--root`, else YAMS_REALTEXT_DIR) and runs on `--device` (the
card unless the caller asks for the CPU; the reference picks JAX's CPU
unless given --tpu); the env variables are read when the script runs, not
when the module is imported.

    ENC_DIM=192 ENC_LAYERS=3 ENC_HEADS=6 python -m yams_tpu_torch.scripts.train_encoder_realtext
        out.npz [steps] [--root DIR] [--device cuda]
"""

from __future__ import annotations

import argparse
import os
import re
import time

import numpy as np

from ..embed.hf_encoder import WordPieceTokenizer, init_params
from ..embed.simeon import tokenize
from .train_encoder import ContrastiveTrainer, encode_batch

MAX_LEN = 128
SUFFIX_PIECES = ["##s", "##ed", "##ing", "##ion", "##er", "##es", "##ly"]
VOCAB_CAP = 24_000
B, QT, DT = 32, 16, 128
_IDENT_RE = re.compile(r"\b[A-Z][a-z0-9]+(?:[A-Z][a-z0-9]+)+\b")
_CAMEL_RE = re.compile(r"[A-Z]+(?=[A-Z][a-z])|[A-Z]?[a-z]+|[A-Z]+|[0-9]+")


def shape_from_env() -> dict:
    """The encoder's width and depth from ENC_DIM, ENC_LAYERS, ENC_HEADS and
    ENC_FFN, with the reference's defaults."""
    dim = int(os.environ.get("ENC_DIM", 128))
    return {"dim": dim, "layers": int(os.environ.get("ENC_LAYERS", 2)),
            "heads": int(os.environ.get("ENC_HEADS", 4)),
            "intermediate": int(os.environ.get("ENC_FFN", 2 * dim))}


def warmup_steps(steps: int) -> int:
    return min(100, max(1, steps // 10))


def build_vocab(corpus: dict) -> list[str]:
    """Specials + suffixes + the VOCAB_CAP most frequent corpus tokens
    (stems included so greedy longest-match decomposes morphology)."""
    freq: dict[str, int] = {}
    for doc in corpus.values():
        for w in tokenize(doc["text"]):
            freq[w] = freq.get(w, 0) + 1
    stems: set[str] = set()
    for w in list(freq):
        for suf in ("ing", "ion", "ed", "er", "es", "ly", "s"):
            if w.endswith(suf) and len(w) > len(suf) + 2:
                stems.add(w[: -len(suf)])
    keep = sorted(freq, key=freq.get, reverse=True)[:VOCAB_CAP]
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + SUFFIX_PIECES
    vocab += sorted(set(keep) | (stems & set(freq)))
    return vocab


def pseudo_queries(chunk_toks: list[str], df: dict[str, int], n_docs: int,
                   rng: np.random.Generator, raw_text: str) -> list[str]:
    """ICT pseudo-query candidates for one chunk."""
    out = []
    n = len(chunk_toks)
    if n >= 12:
        # span
        ln = int(rng.integers(4, 11))
        st = int(rng.integers(0, n - ln))
        out.append(" ".join(chunk_toks[st:st + ln]))
        # keywords: low-df tokens
        informative = [t for t in set(chunk_toks)
                       if len(t) >= 4 and df.get(t, 0) <= n_docs // 50]
        if len(informative) >= 3:
            kws = rng.choice(informative, size=min(6, len(informative)),
                             replace=False)
            out.append(" ".join(kws[: int(rng.integers(3, 7))]))
    # identifier: camel-split a CamelCase word from the raw text
    idents = _IDENT_RE.findall(raw_text)
    if idents:
        ident = idents[int(rng.integers(len(idents)))]
        out.append(" ".join(m.group(0).lower() for m in _CAMEL_RE.finditer(ident)))
    return out


class RealtextData:
    """A root's realtext-BEIR chunks, their tokens and document frequencies,
    and the vocabulary built on them."""

    def __init__(self, root=None, ds=None):
        from .realtext import realtext_beir

        self.ds = ds if ds is not None else realtext_beir(root=root)
        self.corpus = self.ds.corpus
        self.vocab = build_vocab(self.corpus)
        self.tok = WordPieceTokenizer(self.vocab)
        self.dids = list(self.corpus)
        self.chunk_toks = {d: list(tokenize(self.corpus[d]["text"])) for d in self.dids}
        self.df: dict[str, int] = {}
        for toks in self.chunk_toks.values():
            for t in set(toks):
                self.df[t] = self.df.get(t, 0) + 1

    def batches(self, rng: np.random.Generator):
        """Endless host batches, drawn from rng as the reference's loop draws them."""
        while True:
            q_texts, d_texts = [], []
            for bi in rng.choice(len(self.dids), B, replace=False):
                did = self.dids[bi]
                cands = pseudo_queries(self.chunk_toks[did], self.df, len(self.dids), rng,
                                       self.corpus[did]["text"])
                if not cands:
                    cands = [" ".join(self.chunk_toks[did][:6]) or did]
                q_texts.append(cands[int(rng.integers(len(cands)))])
                d_texts.append(self.corpus[did]["text"])
            yield (*encode_batch(self.tok, q_texts, QT), *encode_batch(self.tok, d_texts, DT))


def make_trainer(data: RealtextData, steps: int, shape: dict, device="cuda"):
    """The reference's init (seed 0) at `shape`, its schedule for `steps`."""
    params = init_params(np.random.default_rng(0), len(data.vocab), dim=shape["dim"],
                         layers=shape["layers"], intermediate=shape["intermediate"],
                         max_len=MAX_LEN)
    return ContrastiveTrainer(params, heads=shape["heads"], steps=steps,
                              warmup=warmup_steps(steps), device=device)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out", nargs="?", default="encoder_realtext.npz")
    ap.add_argument("steps", nargs="?", type=int, default=1500)
    ap.add_argument("--root", default=None, help="real-text root (else YAMS_REALTEXT_DIR)")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    data = RealtextData(root=a.root)
    print(f"corpus={len(data.corpus)} chunks, vocab={len(data.vocab)}")
    trainer = make_trainer(data, a.steps, shape_from_env(), a.device)
    batches = data.batches(np.random.default_rng(3))
    t0 = time.time()
    for s in range(a.steps):
        loss = trainer.step(next(batches))
        if s % 50 == 0 or s == a.steps - 1:
            print(f"step {s}: loss={float(loss):.4f} ({time.time() - t0:.0f}s)", flush=True)
    trainer.save(a.out, data.vocab)
    print(f"saved {a.out} ({os.path.getsize(a.out) / 1e6:.1f} MB)")


if __name__ == "__main__":
    main()
