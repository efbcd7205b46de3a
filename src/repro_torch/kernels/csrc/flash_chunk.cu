// Ragged causal flash attention on a dense (B, S, nkv, d) cache.
//
// Replaces: src/repro/kernels/flash_chunk.py :: flash_chunk (the Pallas body
// _flash_chunk_kernel with the _kv_tile_index map).  flash_decode
// (src/repro/kernels/flash_decode.py) is this kernel at sq == 1 and has no
// kernel of its own: ops.flash_decode calls it with q_offset = len - 1,
// q_len = min(len, 1).
//
// The body, its bound and its design are flash_attn.cuh's; this entry point
// addresses key t of slot b at row b * S + t.  MLA runs here: the expanded
// regime (g = 1, hd = 192, hdv = 128 at deepseek-v2 widths, 64-row tiles)
// and the absorbed regime (nkv = 1, g = 128, hd = 576, hdv = 512: 64-row
// tiles of 32 keys, the head group split across 2 CTAs and the value
// columns across 4).
#include "flash_attn.cuh"

// rows / n_split: ops.flash_plan; part_o / part_ml: f32 scratch when
// n_split > 1 (null otherwise)
extern "C" int rt_flash_chunk(const void* q, const void* k, const void* v,
                              const void* q_offset, const void* q_len,
                              const void* kv_len, void* out, void* part_o,
                              void* part_ml, int B, int sq, int nq, int nkv,
                              int hd, int hdv, int S, int rows, int n_split,
                              float scale, int dtype, void* stream) {
  if (S < 0) return cudaErrorInvalidValue;
  const FlashArgs a{q, k, v, (const int*)q_offset, (const int*)q_len,
                    (const int*)kv_len, out, (float*)part_o, (float*)part_ml,
                    B, sq, nq, nkv, hd, hdv, rows, n_split, scale};
  return flash_run(dtype, a, DenseKV{S}, (cudaStream_t)stream);
}
