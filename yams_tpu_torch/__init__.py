"""yams_tpu_torch: the PyTorch/CUDA port of yams_tpu's add -> search slice.

The JAX package `yams_tpu` stays the reference. This package mirrors its
module paths (`ops/cdc.py` ports `yams_tpu/ops/cdc.py`, ...) and runs the
same computations in PyTorch, with hand-written CUDA kernels for Hopper
(`csrc/`) where the reference ran a Pallas kernel or a long sequential XLA
loop:

- ingest: gear-hash CDC candidates (`ops.cdc`, CUDA kernel `gear_hash_cuda`)
  and batched SHA-256 (`ops.sha256`, CUDA kernel `sha256_cuda`), driven by
  `ingest.device_pipeline.device_chunk_hash`;
- search: the dense hybrid tier of `search.engine.SearchEngine` (Simeon
  embeddings, packed BM25 candidates, RRF fusion) on torch tensors.

Every function takes an explicit device. A kernel wrapper given a CPU tensor
runs the kernel's plain PyTorch twin; given a CUDA tensor it launches the
kernel or raises. Nothing here imports jax.
"""

__version__ = "0.1.0"
