"""Live relevance A/B over a judged query set against a running daemon.

Port of scripts/relevance_ab.py (parity: tests/benchmarks/relevance/
live_relevance_ab.py in the reference) on the port's DaemonClient and
AppContext: run a judged query set through the real search path, tag the
run with --label, re-run under a candidate configuration, and --diff the
two result files (per-query deltas, aggregate deltas, paired sign test).
Past the imports, `run_queries`, `aggregate`, `sign_test` and `diff` are the
reference's code. It departs only here: a daemon on the data dir's socket is
used when its ping says "backend": "torch" (a daemon of the JAX package is
an error, as in the port's CLI); else an in-process AppContext opens on
`--device` (default cuda; `cpu` runs on the host).

Queries file format (JSON):
    [{"query": "...", "relevant": ["substr-of-path", ...]}, ...]
A ranked path counts as relevant when any substring matches (the reference
uses the same substring-judgment scheme for corpus-local query sets).

Usage:
    python -m yams_tpu_torch.scripts.relevance_ab --storage DIR --queries q.json \
        --label baseline --out /tmp/rel_base.json [--type hybrid] [--k 10]
    # ... restart the daemon under the candidate config ...
    python -m yams_tpu_torch.scripts.relevance_ab --storage DIR --queries q.json \
        --label candidate --out /tmp/rel_cand.json
    python -m yams_tpu_torch.scripts.relevance_ab --diff /tmp/rel_base.json /tmp/rel_cand.json
"""

from __future__ import annotations

import argparse
import json
import math
import pathlib
import sys


def run_queries(storage: str, queries: list[dict], k: int,
                search_type: str, device: str = "cuda") -> list[dict]:
    from ..cli.main import torch_daemon
    from ..core.config import load_config
    from ..daemon.client import DaemonClient
    from ..utils.metrics import reciprocal_rank

    cfg = load_config(data_dir=storage)
    client = DaemonClient(cfg.socket_path)
    use_daemon = torch_daemon(client, timeout=2.0)
    app = None
    if not use_daemon:
        from ..services.app import AppContext

        app = AppContext(cfg, device=device)
    rows = []
    try:
        for q in queries:
            if use_daemon:
                resp = client.search(q["query"], limit=k,
                                     search_type=search_type)
                ranked = [h["path"] for h in resp["hits"]]
            else:
                resp = app.search.search(q["query"], limit=k,
                                         search_type=search_type)
                ranked = [h.path for h in resp.hits]
            subs = q["relevant"]
            judged = ["REL" if any(s in p for s in subs) else p
                      for p in ranked]
            relevant = {"REL"}
            # substring judgments: every matching rank counts, ideal = all
            hits01 = [1 if j == "REL" else 0 for j in judged[:k]]
            dcg = sum(h / math.log2(i + 2) for i, h in enumerate(hits01))
            ideal = min(len(subs), k)
            idcg = sum(1 / math.log2(i + 2) for i in range(ideal)) or 1.0
            rows.append({
                "query": q["query"],
                "ndcg": dcg / idcg,
                "recall": (sum(hits01) / len(subs)) if subs else 0.0,
                "rr": reciprocal_rank(judged, relevant),
                "first_rank": next((i + 1 for i, h in enumerate(hits01) if h),
                                   None),
                "ranked": ranked,
            })
    finally:
        if app is not None:
            app.close()
    return rows


def aggregate(rows: list[dict]) -> dict:
    n = max(1, len(rows))
    return {
        "ndcg": sum(r["ndcg"] for r in rows) / n,
        "recall": sum(r["recall"] for r in rows) / n,
        "mrr": sum(r["rr"] for r in rows) / n,
        "n": len(rows),
    }


def sign_test(deltas: list[float]) -> float:
    """Two-sided paired sign-test p-value over nonzero deltas."""
    pos = sum(1 for d in deltas if d > 1e-12)
    neg = sum(1 for d in deltas if d < -1e-12)
    n = pos + neg
    if n == 0:
        return 1.0
    k = min(pos, neg)
    p = sum(math.comb(n, i) for i in range(k + 1)) / 2 ** n
    return min(1.0, 2 * p)


def diff(a_path: str, b_path: str) -> int:
    a = json.loads(pathlib.Path(a_path).read_text())
    b = json.loads(pathlib.Path(b_path).read_text())
    by_query = {r["query"]: r for r in a["rows"]}
    deltas = []
    print(f"{'query':48s} {'d_ndcg':>8s} {'d_rr':>8s}")
    for rb in b["rows"]:
        ra = by_query.get(rb["query"])
        if ra is None:
            continue
        dn = rb["ndcg"] - ra["ndcg"]
        dr = rb["rr"] - ra["rr"]
        deltas.append(dn)
        mark = "+" if dn > 0 else ("-" if dn < 0 else " ")
        print(f"{rb['query'][:48]:48s} {dn:+8.3f} {dr:+8.3f} {mark}")
    agg_a, agg_b = a["aggregate"], b["aggregate"]
    print(f"\n{a['label']:>12s}: ndcg={agg_a['ndcg']:.3f} "
          f"recall={agg_a['recall']:.3f} mrr={agg_a['mrr']:.3f}")
    print(f"{b['label']:>12s}: ndcg={agg_b['ndcg']:.3f} "
          f"recall={agg_b['recall']:.3f} mrr={agg_b['mrr']:.3f}")
    p = sign_test(deltas)
    print(f"paired sign test (ndcg deltas): p={p:.4f} "
          f"({'significant' if p < 0.05 else 'not significant'} at 0.05)")
    return 0


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--storage", help="data dir of the corpus/daemon")
    ap.add_argument("--queries", help="judged query set JSON")
    ap.add_argument("--label", default="run")
    ap.add_argument("--out", help="write run results JSON here")
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--type", default="hybrid",
                    choices=["hybrid", "keyword", "vector"])
    ap.add_argument("--diff", nargs=2, metavar=("A", "B"),
                    help="compare two result files")
    ap.add_argument("--device", default="cuda",
                    help="device of the in-process app when no daemon runs")
    args = ap.parse_args(argv)

    if args.diff:
        return diff(*args.diff)
    if not (args.storage and args.queries):
        ap.error("--storage and --queries required (or use --diff)")
    queries = json.loads(pathlib.Path(args.queries).read_text())
    rows = run_queries(args.storage, queries, args.k, args.type, args.device)
    result = {"label": args.label, "k": args.k, "type": args.type,
              "aggregate": aggregate(rows), "rows": rows}
    text = json.dumps(result, indent=2)
    if args.out:
        pathlib.Path(args.out).write_text(text)
    agg = result["aggregate"]
    print(f"[{args.label}] n={agg['n']} ndcg={agg['ndcg']:.3f} "
          f"recall={agg['recall']:.3f} mrr={agg['mrr']:.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
