"""Convert a HuggingFace BERT-family sentence encoder to the yams
checkpoint format (one flat .npz read by embed/hf_encoder.py).

Usage:
    python -m yams_tpu_torch.scripts.convert_hf_encoder sentence-transformers/all-MiniLM-L6-v2 out.npz
    python -m yams_tpu_torch.scripts.convert_hf_encoder /path/to/local/checkpoint out.npz

Works with any transformers BertModel checkpoint (MiniLM, bert-base,
bge-small, ...). The hub id form needs network egress; in air-gapped
environments pass a local directory (config.json + pytorch_model.bin /
model.safetensors + vocab.txt). `transformers` is imported only by
`convert`. The port's copy of the repository's scripts/convert_hf_encoder.py:
the same names, layout and transposes.
"""

from __future__ import annotations

import sys

import numpy as np


def convert_state_dict(sd: dict, config, vocab: list[str]) -> dict:
    """torch BertModel state_dict -> flat npz dict (kernels transposed to
    (in, out))."""
    t = {k: v.detach().cpu().numpy() for k, v in sd.items()}
    p = "bert." if any(k.startswith("bert.") for k in t) else ""
    out: dict[str, np.ndarray] = {
        "cfg/dim": np.int64(config.hidden_size),
        "cfg/layers": np.int64(config.num_hidden_layers),
        "cfg/heads": np.int64(config.num_attention_heads),
        "cfg/max_len": np.int64(config.max_position_embeddings),
        "cfg/vocab_size": np.int64(config.vocab_size),
        "cfg/intermediate": np.int64(config.intermediate_size),
        "vocab": np.array(vocab),
        "embeddings/word": t[f"{p}embeddings.word_embeddings.weight"],
        "embeddings/position": t[f"{p}embeddings.position_embeddings.weight"],
        "embeddings/token_type":
            t[f"{p}embeddings.token_type_embeddings.weight"],
        "embeddings/ln/scale": t[f"{p}embeddings.LayerNorm.weight"],
        "embeddings/ln/bias": t[f"{p}embeddings.LayerNorm.bias"],
    }
    for i in range(config.num_hidden_layers):
        b = f"{p}encoder.layer.{i}."
        o = f"layer{i}/"
        for ours, theirs in (("attn/q", "attention.self.query"),
                             ("attn/k", "attention.self.key"),
                             ("attn/v", "attention.self.value"),
                             ("attn/o", "attention.output.dense"),
                             ("mlp/fc1", "intermediate.dense"),
                             ("mlp/fc2", "output.dense")):
            out[f"{o}{ours}/kernel"] = t[f"{b}{theirs}.weight"].T
            out[f"{o}{ours}/bias"] = t[f"{b}{theirs}.bias"]
        out[f"{o}attn_ln/scale"] = t[f"{b}attention.output.LayerNorm.weight"]
        out[f"{o}attn_ln/bias"] = t[f"{b}attention.output.LayerNorm.bias"]
        out[f"{o}mlp_ln/scale"] = t[f"{b}output.LayerNorm.weight"]
        out[f"{o}mlp_ln/bias"] = t[f"{b}output.LayerNorm.bias"]
    return out


def convert(model_id_or_path: str, out_path: str) -> str:
    from transformers import AutoModel, AutoTokenizer

    model = AutoModel.from_pretrained(model_id_or_path)
    tok = AutoTokenizer.from_pretrained(model_id_or_path)
    vocab_map = tok.get_vocab()
    vocab = [""] * len(vocab_map)
    for token, idx in vocab_map.items():
        vocab[idx] = token
    flat = convert_state_dict(model.state_dict(), model.config, vocab)
    np.savez_compressed(out_path, **flat)
    return out_path


if __name__ == "__main__":
    if len(sys.argv) != 3:
        print(__doc__)
        sys.exit(2)
    path = convert(sys.argv[1], sys.argv[2])
    print(f"converted -> {path}")
