"""StatsService: aggregated status snapshot (DaemonMetrics analog).

Parity: src/app/services/stats_service.cpp + DaemonMetrics::getSnapshot
(include/yams/daemon/components/DaemonMetrics.h:421-441).

Port of yams_tpu/services/stats_service.py. It departs in the detailed
snapshot only: `devices` lists the app's torch device (each CUDA card's
index and name, or "cpu"), `vector_index` adds the tier's device dtype,
`sharded` says whether the app serves over a mesh, and `mesh` gives its
shape and devices when it does. `version` is the
port's.
"""

from __future__ import annotations

import time

import torch

from .. import __version__


def device_names(device: torch.device) -> list[str]:
    if device.type != "cuda":
        return ["cpu"]
    return [f"cuda:{i} {torch.cuda.get_device_name(i)}"
            for i in range(torch.cuda.device_count())]


class StatsService:
    def __init__(self, app):
        self.app = app
        self._started = time.time()

    def snapshot(self, detailed: bool = False) -> dict:
        app = self.app
        out = {
            "version": __version__,
            "uptime_s": round(time.time() - self._started, 1),
            "data_dir": str(app.config.data_dir),
            "documents": app.metadata.stats(),
            "storage": app.content_store.stats(),
            "search": {
                "searches": app.search_engine._stats["searches"],
            },
            "graph": {"nodes": app.kg.node_count(), "edges": app.kg.edge_count()},
        }
        if detailed:
            out["vector_index"] = app.search_engine.vector_index.stats()
            out["lexical_index"] = app.search_engine.lexical_index.stats()
            out["embedding"] = {
                "profile": app.config.embedding.profile,
                "space_id": app.config.embedding.space_id,
                "dim": app.config.embedding.dim,
            }
            out["devices"] = device_names(app.device)
            out["vector_index"]["device_dtype"] = \
                app.search_engine.vector_index.device_dtype
            out["sharded"] = app.sharded
            mesh = app.search_engine._shard_mesh
            if mesh is not None:
                out["mesh"] = {"shape": mesh.shape,
                               "devices": [str(d) for d in mesh.devices.flat]}
            s = app.search_engine.stats()
            if "avg_latency_ms" in s:
                out["search"]["avg_latency_ms"] = round(s["avg_latency_ms"], 2)
        return out
