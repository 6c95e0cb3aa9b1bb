"""Corpus-sharded retrieval over a mesh of devices driven from one process
(port of yams_tpu/parallel)."""

from .mesh import corpus_mesh, pad_to_shards
from .sharded_scan import sharded_hybrid_scores, sharded_topk

__all__ = ["corpus_mesh", "pad_to_shards", "sharded_topk", "sharded_hybrid_scores"]
