"""Reference-scale BEIR-style retrieval eval on real text, through the port.

Port of scripts/eval_beir_scale.py: the realtext-BEIR dataset
(`scripts/realtext.py` `realtext_beir`: passage chunks with known-item
heading and symbol queries) is added to the port's `AppContext` with a
chosen embedding provider, one `add_bytes` a chunk, and each query is
searched with `SearchService.search` (limit 20, no snippets, the hotzone
cleared before each mode). It reports MRR / nDCG@10 / recall@10 per mode:
chunk-level ("all"), file-level (the ranked chunks folded to their files
in rank order, relevance any chunk's file; the granularity of the
reference's scifact table) and per query family.

It departs from the reference script in these ways:

- `run_eval` takes the root (`root=`, else YAMS_REALTEXT_DIR) or a built
  dataset (`ds=`), the device (the card unless the caller asks for the
  CPU), and `compute_dtype` for the `hf` provider (its default bf16;
  "float32" registers the provider at f32 under `hf-float32` for the run);
- `packed_max_entries` sets the lexical index's packed-postings budget (0
  runs the CSR leg, whose BM25 sums are bit-equal across packages);
- a mode "hybrid+colbert" runs hybrid with the ColBERT tier (contextual
  per-token vectors through MaxSim, as tests/test_beir_scale.py's ColBERT
  test runs it): the tier is enabled before the adds, and the other modes
  search with the token index detached;
- each mode's result also holds "ranked", the top-10 chunk ids of each
  query, for comparisons;
- `hf` without a checkpoint sizes the index to the default checkpoint's
  width (the reference sizes it 384 there), and without `data_dir` the data
  dir is a temporary directory removed at the end.

    python -m yams_tpu_torch.scripts.eval_beir_scale [simeon | hf ckpt.npz]
        [--root DIR] [--modes hybrid,semantic,keyword] [--device cuda]
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import pathlib
import tempfile

import numpy as np

COLBERT = "hybrid+colbert"


def file_of(did: str) -> str:
    return did.rsplit("#", 1)[0]


def fold_to_files(ranked: list[str]) -> list[str]:
    """Chunk ids in rank order -> their files in rank order, each once."""
    seen, out = set(), []
    for did in ranked:
        f = file_of(did)
        if f not in seen:
            seen.add(f)
            out.append(f)
    return out


@contextlib.contextmanager
def provider_name(provider: str, compute_dtype: str | None):
    """The registry name to build `provider` under: `hf` at another compute
    dtype than its default is registered as `hf-<dtype>` for the block."""
    if provider != "hf" or compute_dtype in (None, "bfloat16"):
        yield provider
        return
    from ..embed.provider import HFProvider, register_provider, unregister_provider

    name = f"hf-{compute_dtype}"
    factory = functools.partial(HFProvider, compute_dtype=compute_dtype)
    register_provider(name, factory)
    try:
        yield name
    finally:
        unregister_provider(name, factory)


def run_eval(provider: str = "simeon", checkpoint: str = "",
             modes=("hybrid", "semantic", "keyword"), quiet: bool = False, *,
             root=None, ds=None, device="cuda", compute_dtype: str | None = None,
             packed_max_entries: int | None = None, data_dir=None) -> dict:
    from .realtext import realtext_beir

    if ds is None:
        ds = realtext_beir(root=root)
    with contextlib.ExitStack() as stack:
        if data_dir is None:
            data_dir = stack.enter_context(tempfile.TemporaryDirectory())
        return _run(ds, provider, checkpoint, modes, quiet, device, compute_dtype,
                    packed_max_entries, pathlib.Path(data_dir) / "data")


def _run(ds, provider, checkpoint, modes, quiet, device, compute_dtype,
         packed_max_entries, data_dir) -> dict:
    from ..core.config import Config, VectorIndexConfig
    from ..services.app import AppContext
    from ..utils.metrics import evaluate

    cfg = Config(data_dir=data_dir)
    dim = 384
    with provider_name(provider, compute_dtype) as name:
        if provider and provider != "simeon":
            cfg.embedding.provider = name
            cfg.embedding.checkpoint = checkpoint
            if checkpoint:
                dim = int(np.load(checkpoint)["cfg/dim"])
            elif provider == "hf":
                from ..embed.provider import DEFAULT_HF_CHECKPOINT

                dim = int(np.load(DEFAULT_HF_CHECKPOINT)["cfg/dim"])
        cfg.vector = VectorIndexConfig(dim=dim, capacity=2 * len(ds.corpus), block_rows=512)
        if packed_max_entries is not None:
            cfg.lexical.packed_max_entries = packed_max_entries
        app = AppContext(cfg, device=device)
    try:
        eng = app.search_engine
        if COLBERT in modes:
            eng.enable_late_interaction()
        for did, doc in ds.corpus.items():
            app.documents.add_bytes(doc["text"].encode(), did)
        token_index = eng.token_index
        out = {}
        for st in modes:
            eng.token_index = token_index if st == COLBERT else None
            eng.clear_hot()
            runs, fruns, fam = [], [], {"heading": [], "symbol": []}
            ranked_by_q = {}
            for qid, qtext in ds.queries.items():
                resp = app.search.search(qtext, limit=20,
                                         search_type="hybrid" if st == COLBERT else st,
                                         with_snippets=False)
                ranked = [h.path.lstrip("/") for h in resp.hits]
                rels = ds.relevant(qid)
                runs.append((ranked[:10], rels))
                fam[ds.kinds[qid]].append((ranked[:10], rels))
                fruns.append((fold_to_files(ranked)[:10], {file_of(d) for d in rels}))
                ranked_by_q[qid] = ranked[:10]
            out[st] = {
                "all": evaluate(runs, k=10),
                "file_level": evaluate(fruns, k=10),
                **{k: evaluate(v, k=10) for k, v in fam.items() if v},
                "ranked": ranked_by_q,
            }
            if not quiet:
                m, fm = out[st]["all"], out[st]["file_level"]
                print(f"{provider:7s} {st:14s} chunk: mrr={m['mrr']:.3f} "
                      f"ndcg={m['ndcg']:.3f} rec={m['recall']:.3f} | file: "
                      f"mrr={fm['mrr']:.3f} ndcg={fm['ndcg']:.3f} "
                      f"rec={fm['recall']:.3f} (n={len(runs)})", flush=True)
        eng.token_index = token_index
        return out
    finally:
        app.close()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("provider", nargs="?", default="simeon")
    ap.add_argument("checkpoint", nargs="?", default="")
    ap.add_argument("--root", default=None, help="real-text root (else YAMS_REALTEXT_DIR)")
    ap.add_argument("--modes", default="hybrid,semantic,keyword")
    ap.add_argument("--compute-dtype", default=None)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    out = run_eval(a.provider, a.checkpoint, tuple(a.modes.split(",")), root=a.root,
                   device=a.device, compute_dtype=a.compute_dtype)
    for res in out.values():
        res.pop("ranked")
    print(json.dumps({"provider": a.provider, "results": out}))


if __name__ == "__main__":
    main()
