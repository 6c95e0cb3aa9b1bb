"""yams_tpu_torch: the PyTorch/CUDA port of yams_tpu.

The JAX package `yams_tpu` stays the reference. This package mirrors its
module paths (`ops/cdc.py` ports `yams_tpu/ops/cdc.py`, ...) and runs the
same computations in PyTorch, with hand-written CUDA kernels for Hopper
(`csrc/`) where the reference ran a Pallas kernel or a long sequential XLA
loop:

- ingest: gear-hash CDC candidates (`ops.cdc`, CUDA kernel `gear_hash_cuda`)
  and batched SHA-256 (`ops.sha256`, CUDA kernel `sha256_cuda`), driven by
  `ingest.device_pipeline.device_chunk_hash` and `storage.ContentStore`;
- search: the dense hybrid tier and the PQ tier of `search.engine
  .SearchEngine` on torch tensors;
- the vector store: exact KNN (`exact_topk_cuda`) and the PQ4 scan
  (`pq4_adc_cuda`) of `index.vector_index.VectorIndex`;
- the fused top-C scans `ops.scan.grouped_topk_pallas` (`grouped_max_cuda`)
  and `ops.flash_topk.flash_topc` (`windowed_scan_cuda`), run by the
  experiments in `scripts/`.

It imports nothing of yams_tpu: the host modules it runs (`core`, `embed`,
`native`, `ingest`, `storage`, the indexes' host state) are its own copies.
The entry points run on the card unless the caller passes device="cpu". A
kernel wrapper given a CPU tensor runs the kernel's plain PyTorch twin;
given a CUDA tensor it launches the kernel or raises.
"""

__version__ = "0.1.0"
