"""Train a small BERT-architecture sentence encoder contrastively, on the card.

Port of scripts/train_encoder.py: the synthetic-hard BEIR corpus
(`utils.beir.synthetic_beir(n_queries=550)`, whose first 50 queries are the
gating eval's and are never trained on), a WordPiece vocabulary of the
corpus's stems and words with suffix pieces, the scripts' NumPy init
(`embed.hf_encoder.init_params`, seed 0) and the reference's step: B 32
queries (QT 16 tokens) against one relevant document each (DT 96),
in-batch negatives with logits x 20 and the symmetric cross entropy
(`utils.optim.in_batch_ce`), `optax.adamw` over a warmup-cosine schedule
(0 -> 3e-4 over 50 steps, decay to the last step; weight decay 0.01) as
`utils.optim.AdamW`. The batches draw the reference's
`np.random.default_rng(1)` stream. The checkpoint is the converted-HF
`.npz` (`embed.hf_encoder.save_npz`) that both packages' `hf` providers
load.

`ContrastiveTrainer` is the step shared with train_encoder_realtext.py:
`bert_forward` at f32 on leaves that require grad, `torch.autograd.grad`,
then the AdamW update, all on the trainer's device (the card unless the
caller asks for the CPU). The batch is built on the host and copied.

    python -m yams_tpu_torch.scripts.train_encoder out.npz [steps] [--device cuda]
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from ..device import resolve_device
from ..embed.hf_encoder import (WordPieceTokenizer, bert_forward, init_params, pad_batch,
                                save_npz, trainable_state)
from ..utils.optim import AdamW, in_batch_ce, warmup_cosine_decay_schedule

DIM, LAYERS, HEADS, INTERMEDIATE, MAX_LEN = 128, 2, 4, 256, 96
SUFFIX_PIECES = ["##s", "##ed", "##ing", "##ion", "##er"]
B, QT, DT = 32, 16, 96
WARMUP, PEAK_LR, WEIGHT_DECAY = 50, 3e-4, 0.01   # the schedule and decay of both scripts


def build_vocab(corpus: dict) -> list[str]:
    """Specials + suffix pieces + corpus stems (suffix-stripped surfaces)."""
    words: set[str] = set()
    stems: set[str] = set()
    for doc in corpus.values():
        for w in doc["text"].split():
            words.add(w)
            for suf in ("ing", "ion", "ed", "er", "s"):
                if w.endswith(suf) and len(w) > len(suf) + 2:
                    stems.add(w[: -len(suf)])
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + SUFFIX_PIECES
    # stems FIRST so greedy longest-match decomposes variants into
    # stem + ##suffix; whole words that ARE stems come along automatically
    vocab += sorted(stems | words)
    return vocab


def encode_batch(tok: WordPieceTokenizer, texts: list[str], T: int):
    """Texts -> (ids (n, T) int64, attn (n, T) f32), as the scripts pad them."""
    return pad_batch([tok.encode(t, T) for t in texts], T, tok.pad_id)


class ContrastiveTrainer:
    """The in-batch contrastive step on one device (see the module docstring)."""

    def __init__(self, params: dict[str, np.ndarray], *, heads: int, steps: int,
                 warmup: int, device="cuda"):
        self.device = resolve_device(device)
        self.state = trainable_state(params, self.device)
        self.leaves = list(self.state.values())
        self.layers = len({k.split(".")[0] for k in self.state if k.startswith("layer")})
        self.heads = heads
        self.opt = AdamW(self.leaves, warmup_cosine_decay_schedule(0.0, PEAK_LR, warmup, steps),
                         weight_decay=WEIGHT_DECAY)

    def loss(self, q_ids, q_attn, d_ids, d_attn) -> torch.Tensor:
        def fwd(ids, attn):
            return bert_forward(self.state, ids, attn, num_layers=self.layers,
                                num_heads=self.heads, compute_dtype="float32")
        return in_batch_ce(fwd(q_ids, q_attn), fwd(d_ids, d_attn))

    def to_device(self, batch) -> list[torch.Tensor]:
        return [torch.from_numpy(a).to(self.device) for a in batch]

    def step(self, batch) -> torch.Tensor:
        """One update on a host batch (q_ids, q_attn, d_ids, d_attn); returns
        the loss before it (0-dim, on the device)."""
        loss = self.loss(*self.to_device(batch))
        self.opt.step(torch.autograd.grad(loss, self.leaves))
        return loss.detach()

    def save(self, path, vocab: list[str]) -> None:
        save_npz(path, self.state, vocab, heads=self.heads)


class SyntheticData:
    """The reference script's data: the corpus with 550 queries, training on
    q50 and up, its vocabulary and tokenizer."""

    def __init__(self):
        from ..utils.beir import synthetic_beir

        self.full = synthetic_beir(n_queries=550)
        self.corpus = self.full.corpus
        self.train_q = {q: t for q, t in self.full.queries.items() if int(q[1:]) >= 50}
        self.vocab = build_vocab(self.corpus)
        self.tok = WordPieceTokenizer(self.vocab)

    def batches(self, rng: np.random.Generator):
        """Endless host batches, drawn from rng as the reference's loop draws them."""
        qids = list(self.train_q)
        while True:
            batch_q = rng.choice(qids, B, replace=False)
            q_texts = [self.train_q[q] for q in batch_q]
            d_texts = []
            for q in batch_q:
                rel = sorted(self.full.relevant(q))
                d_texts.append(self.corpus[rel[rng.integers(len(rel))]]["text"])
            yield (*encode_batch(self.tok, q_texts, QT), *encode_batch(self.tok, d_texts, DT))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out", nargs="?", default="encoder_synthetic.npz")
    ap.add_argument("steps", nargs="?", type=int, default=600)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    data = SyntheticData()
    print(f"corpus={len(data.corpus)} docs, train queries={len(data.train_q)}, "
          f"vocab={len(data.vocab)}")
    params = init_params(np.random.default_rng(0), len(data.vocab), dim=DIM, layers=LAYERS,
                         intermediate=INTERMEDIATE, max_len=MAX_LEN)
    trainer = ContrastiveTrainer(params, heads=HEADS, steps=a.steps, warmup=WARMUP,
                                 device=a.device)
    batches = data.batches(np.random.default_rng(1))
    t0 = time.time()
    for s in range(a.steps):
        loss = trainer.step(next(batches))
        if s % 50 == 0 or s == a.steps - 1:
            print(f"step {s}: loss={float(loss):.4f} ({time.time() - t0:.0f}s)", flush=True)
    trainer.save(a.out, data.vocab)
    print(f"saved {a.out} ({os.path.getsize(a.out) / 1e6:.1f} MB)")


if __name__ == "__main__":
    main()
