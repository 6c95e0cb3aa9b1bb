"""One step of the sharded pipeline over an n-device mesh, checked.

Port of `dryrun_multichip` in the repo's __graft_entry__.py. It runs, on a
mesh of n devices (every shard on its own card when n cards are visible,
else a virtual mesh of n shards on the one device, which it says):

  1. the dp x mp step: corpus-sharded hybrid scoring (mp shards the rows,
     a pmax merges the doc maxima), query batches split over dp, and the
     index-training analog, one k-means centroid update with a psum over mp;
  2. sharded_hybrid_query on the 1-D mesh against the single-device
     hybrid_query on the same arrays (packed postings, prefilter 32): fused
     values within 2e-3 at every rank and top-10 id overlap >= 0.9, the
     reference's own gate;
  3. the same program on a 2 x n/2 ("dcn", "ici") mesh, its top-1 within
     1e-3 of the 1-D mesh's;
  4. sharded_pq_topk over PQ4 codes of the corpus (self-recall@1 of corpus
     rows queried as themselves);
  5. the engine route: the port's AppContext with the mesh armed ("on"
     when exactly n cards are visible, else the virtual mesh armed on its
     engine), two documents added, a search whose trace names the n shards.

It prints one `dryrun_multichip ok: ...` line.

    python -m yams_tpu_torch.scripts.dryrun_multichip [n] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os
import pathlib
import tempfile

import numpy as np
import torch

from ..device import resolve_device
from ..ops.scan import dot_f32
from ..ops.select import top_k
from ..parallel.mesh import Mesh, psum, pmax, visible_devices


def _problem(rows: int, num_slots: int, dim: int = 384, sketch: int = 4096,
             vocab: int = 512, window: int = 64, B: int = 8, T: int = 16, seed: int = 0):
    """The reference dryrun's synthetic problem, made from the same NumPy
    seed: unit rows, a +-1/sqrt(dim) projection, CSR postings of window/2
    docs a term, B sketches and term ids."""
    rng = np.random.default_rng(seed)
    E = rng.standard_normal((rows, dim)).astype(np.float32)
    E /= np.linalg.norm(E, axis=1, keepdims=True)
    proj = (rng.integers(0, 2, (sketch, dim)).astype(np.float32) * 2 - 1) / np.sqrt(dim)
    P = vocab * (window // 2)
    pd = rng.integers(0, num_slots, P).astype(np.int32)
    pi = rng.random(P).astype(np.float32) * 5 + 1
    to = (np.arange(vocab) * (window // 2)).astype(np.int32)
    tl = np.full(vocab, window // 2, np.int32)
    pd = np.concatenate([pd, np.full(window, num_slots, np.int32)])
    pi = np.concatenate([pi, np.zeros(window, np.float32)])
    sk = rng.standard_normal((B, sketch)).astype(np.float32)
    tid = rng.integers(0, vocab, (B, T)).astype(np.int32)
    return dict(E=E, proj=proj, pd=pd, pi=pi, to=to, tl=tl, sk=sk, tid=tid,
                tm=np.ones((B, T), np.float32), window=window)


def dp_mp_step(mesh: Mesh, q, E, row2slot, bm, cent, num_slots: int):
    """The reference's shard_map step on a ("dp", "mp") mesh: device (i, j)
    scores query shard i against row shard j; a pmax over mp merges the
    doc maxima of each query shard; each device's k-means partial sums of
    its rows are psum-ed over mp. -> (vals (B, 10), slots (B, 10), the new
    centroids of each dp row)."""
    dp, mp = mesh.devices.shape
    K = cent.shape[0]
    q_parts, bm_parts = q.chunk(dp), bm.chunk(dp)
    e_parts, s_parts = E.chunk(mp), row2slot.chunk(mp)
    vals, slots, cents = [], [], []
    for i in range(dp):
        sdoc, sums, counts = [], [], []
        for j in range(mp):
            dev = mesh.devices[i, j]
            e, r2s = e_parts[j].to(dev), s_parts[j].to(dev)
            v = torch.ones(e.shape[0], device=dev)
            s = dot_f32(q_parts[i].to(dev), e)
            s += ((v - 1.0) * 1e30)[None, :]
            seg = torch.where(r2s < 0, num_slots, r2s).long()
            part = torch.full((s.shape[0], num_slots + 1), -torch.inf, device=dev)
            part.scatter_reduce_(1, seg[None, :].expand_as(s), s, reduce="amax")
            sdoc.append(part[:, :num_slots])
            assign = dot_f32(e, cent.to(dev)).argmax(dim=1)
            sums.append(torch.zeros(K, e.shape[1], device=dev).index_add_(
                0, assign, e * v[:, None]))
            counts.append(torch.zeros(K, device=dev).index_add_(0, assign, v))
        lead = mesh.devices[i, 0]
        sd = pmax(sdoc, device=lead)
        b = bm_parts[i].to(lead)
        fused = (0.7 * (b / 25.0).clamp(0, 1)
                 + 0.3 * ((sd + 1) / 2).clamp(0, 1))
        v_i, s_i = top_k(fused, 10)
        vals.append(v_i)
        slots.append(s_i)
        tot, cnt = psum(sums, device=lead), psum(counts, device=lead)
        c0 = cent.to(lead)
        new = torch.where(cnt[:, None] > 0, tot / cnt.clamp_min(1)[:, None], c0)
        cents.append(new / new.norm(dim=1, keepdim=True).clamp_min(1e-9))
    lead = mesh.lead
    return (torch.cat([v.to(lead) for v in vals]), torch.cat([s.to(lead) for s in slots]),
            [c.to(lead) for c in cents])


def dryrun_multichip(n_devices: int = 8, device: str | torch.device = "cuda") -> dict:
    from ..core.config import Config, VectorIndexConfig
    from ..ops.bm25 import pack_postings_2d
    from ..ops.pq import pq4_pack, pq_encode, pq_train
    from ..parallel.sharded_hybrid import sharded_hybrid_query
    from ..parallel.sharded_scan import sharded_pq_topk
    from ..search.config import SearchEngineConfig
    from ..search.fusion import hybrid_query, pack_weights
    from ..services.app import AppContext

    dev = resolve_device(device)
    cards = visible_devices(dev)
    virtual = len(cards) < n_devices
    devices = [cards[0]] * n_devices if virtual else cards[:n_devices]
    where = (f"virtual mesh of {n_devices} shards on {dev} ({len(cards)} visible)"
             if virtual else f"{n_devices} devices")
    n = n_devices
    dp = 2 if n % 2 == 0 and n >= 4 else 1
    mp = n // dp
    grid = np.empty((dp, mp), dtype=object)
    for i, d in enumerate(devices):
        grid.flat[i] = d
    mesh = Mesh(grid, ("dp", "mp"))

    # 1. the dp x mp step
    dim, K, rows, B, num_slots = 128, 16, mp * 256, dp * 8, 128
    rng = np.random.default_rng(0)
    E = rng.standard_normal((rows, dim)).astype(np.float32)
    E /= np.linalg.norm(E, axis=1, keepdims=True)
    q = rng.standard_normal((B, dim)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    row2slot = (np.arange(rows) % num_slots).astype(np.int32)
    bm = (rng.random((B, num_slots)) * 10).astype(np.float32)
    vals, slots, cents = dp_mp_step(
        mesh, torch.from_numpy(q), torch.from_numpy(E), torch.from_numpy(row2slot),
        torch.from_numpy(bm), torch.from_numpy(E[:K].copy()), num_slots)
    if vals.shape != (B, 10) or not bool(torch.isfinite(vals).all()):
        raise RuntimeError(f"dp x mp step: vals {tuple(vals.shape)} not finite (B, 10)")
    # each dp row sums the same rows (float atomics on a card: equal to
    # within rounding, not bit for bit)
    if any(c.shape != (K, dim) or not torch.allclose(c, cents[0], rtol=0, atol=1e-5)
           for c in cents):
        raise RuntimeError("dp x mp step: the dp rows' centroids differ after the psum")

    # 2. sharded_hybrid_query on the 1-D mesh against hybrid_query
    mesh1d = Mesh(np.array(devices, dtype=object), ("d",))
    lead = mesh1d.lead
    p = _problem(rows=n * 256, num_slots=n * 256)
    N = p["E"].shape[0]
    pk, pk_scale = pack_postings_2d(p["pd"], p["pi"], p["to"], p["tl"],
                                    window=p["window"], num_docs=N)
    t = {k: torch.from_numpy(np.asarray(v)).to(lead) for k, v in dict(
        sk=p["sk"], tid=p["tid"], tm=p["tm"], pk=pk,
        w=pack_weights(SearchEngineConfig())).items()}
    proj = torch.from_numpy(p["proj"]).to(lead, torch.bfloat16)
    Et = torch.from_numpy(p["E"]).to(lead, torch.bfloat16)
    ones = torch.ones(N, device=lead)
    r2s = torch.arange(N, dtype=torch.int32, device=lead)
    scale = torch.tensor(float(pk_scale), device=lead)
    dummy = torch.zeros(1, dtype=torch.int32, device=lead)
    zeros = torch.zeros(N, device=lead)
    args = (t["sk"], t["tid"], t["tm"], proj, Et, ones, r2s, ones, t["pk"], scale,
            dummy, dummy, ones, zeros, t["w"])
    kw = dict(k=10, rrf_cand=32, window=p["window"], num_slots=N, packed_lexical=True,
              bm25_prefilter=32)
    hv, hs, _, _ = sharded_hybrid_query(mesh1d, *args, **kw)
    sv, ss, _, _ = hybrid_query(*args, rows_are_docs=True, **kw)
    err = float((hv - sv).abs().max())
    if err > 2e-3:
        raise RuntimeError(f"sharded vs single-device fused values differ by {err:.3g}")
    hs_np, ss_np = hs.cpu().numpy(), ss.cpu().numpy()
    overlap = float(np.mean([len(set(a) & set(b)) / 10 for a, b in zip(ss_np, hs_np)]))
    if overlap < 0.9:
        raise RuntimeError(f"sharded/single top-10 id overlap {overlap:.3f} < 0.9")

    # 3. the ("dcn", "ici") mesh with the hierarchical merge
    msg_dcn = ""
    if n % 2 == 0 and n >= 4:
        mesh2 = Mesh(np.array(devices, dtype=object).reshape(2, n // 2), ("dcn", "ici"))
        dv, _, _, _ = sharded_hybrid_query(mesh2, *args, axis=("dcn", "ici"), **kw)
        top1 = float((dv[:, 0] - hv[:, 0]).abs().max())
        if top1 > 1e-3:
            raise RuntimeError(f"2x{n // 2} mesh top-1 differs by {top1:.3g}")
        msg_dcn = f"; multislice 2x{n // 2} dcn-merge ok"

    # 4. the PQ4 capacity tier over the 1-D mesh
    cb = pq_train(p["E"], m=16, ksub=16, iters=4, device=lead)
    packed = torch.from_numpy(pq4_pack(pq_encode(cb, p["E"]).cpu().numpy())).to(lead)
    nq = p["sk"].shape[0]
    pv, pi_idx = sharded_pq_topk(mesh1d, torch.from_numpy(p["E"][:nq]).to(lead), packed,
                                 cb.centroids, ones, k=10, block_rows=128, packed4=True)
    if not bool(torch.isfinite(pv).all()):
        raise RuntimeError("sharded_pq_topk: values not finite")
    pq_self = float((pi_idx[:, 0].cpu() == torch.arange(nq)).float().mean())

    # 5. the engine route through the port's AppContext
    mode = "on" if not virtual and len(cards) == n else "off"
    old = os.environ.get("YAMS_VECTOR_SHARDED")
    os.environ["YAMS_VECTOR_SHARDED"] = mode
    try:
        with tempfile.TemporaryDirectory() as td:
            cfg = Config(data_dir=pathlib.Path(td) / "data")
            cfg.vector = VectorIndexConfig(dim=384, capacity=1024, block_rows=128)
            app = AppContext(cfg, device=dev)
            try:
                if mode == "off":
                    app.search_engine.enable_sharding(mesh1d)
                app.documents.add_bytes(b"the kernel scheduler preempts threads", "a.md")
                app.documents.add_bytes(b"boil pasta add tomato basil and olive oil", "b.md")
                resp = app.search.search("tomato basil", limit=2, with_snippets=False)
                if not resp.hits or resp.hits[0].name != "b.md":
                    raise RuntimeError(f"engine route: hits {resp.hits}")
                n_sh = app.search_engine.last_trace.get("sharded_devices")
                if n_sh != n:
                    raise RuntimeError(f"engine route ran on {n_sh} shards, not {n}")
            finally:
                app.close()
    finally:
        if old is None:
            os.environ.pop("YAMS_VECTOR_SHARDED", None)
        else:
            os.environ["YAMS_VECTOR_SHARDED"] = old

    line = (f"dryrun_multichip ok: {where}; mesh dp={dp} x mp={mp}, rows={rows}, B={B}, "
            f"top1 mean={float(vals[:, 0].mean()):.3f}; sharded_hybrid_query over {n} "
            f"shards top1 mean={float(hv[:, 0].mean()):.3f}; sharded_pq4 "
            f"self-recall@1={pq_self:.2f}{msg_dcn}; ENGINE sharded serving over {n_sh} "
            f"shards ok (vector.sharded={mode!r}); PARITY sharded==single-device: values "
            f"allclose(atol=2e-3) at all 10 ranks (max error {err:.3g}), id overlap "
            f"{overlap:.3f}")
    print(line, flush=True)
    return {"line": line, "virtual": virtual, "max_err": err, "id_overlap": overlap,
            "pq_self_recall1": pq_self, "engine_shards": n_sh}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("n", nargs="?", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    dryrun_multichip(a.n, a.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
