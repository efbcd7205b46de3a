"""Hand-written Hopper kernels for the serving hot path.

  flash_chunk_paged  ragged causal attention through per-slot block tables
  flash_chunk        the same on a dense cache (flash_decode: one row)
  topk_gate          fused softmax + top-k router gate
  grouped_gemm       dropless segment GEMM over expert-sorted rows
  moe_gemm           capacity-mode batched expert GEMM over (E, C, H) buffers
  permute_tokens     row gather into expert order (and its ragged form for
                     the EP exchange's segmented buffers), unpermute_tokens
                     the weighted k-way combine
  policy             KernelPolicy switches (rides on core.partitioner plans)
  ops                checked wrappers with launch counters
  ref                plain PyTorch versions (the CPU path and the oracles)
  build              nvcc build of csrc/ and the ctypes binding

Only ``policy`` is imported eagerly; nothing is compiled at import.
"""

from repro_torch.kernels.policy import NULL_POLICY, KernelPolicy

__all__ = ["KernelPolicy", "NULL_POLICY"]
