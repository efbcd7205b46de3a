// Ragged causal flash attention through per-slot block tables.
//
// Replaces: src/repro/kernels/flash_chunk.py :: flash_chunk_paged (the
// Pallas body _flash_chunk_kernel with the _paged_kv_tile_index map).
//
// The body, its bound and its design are flash_attn.cuh's; this entry point
// resolves each logical key t of slot b to its page,
// bt[b, t / page] (-1 clamped to page 0; such keys lie past kv_len and are
// never loaded), at row (page * page_size + t % page_size), once per key row
// and tile.
#include "flash_attn.cuh"

// rows / n_split: ops.flash_plan; part_o / part_ml: f32 scratch when
// n_split > 1 (null otherwise)
extern "C" int rt_flash_chunk_paged(const void* q, const void* k_pages,
                                    const void* v_pages, const void* block_tables,
                                    const void* q_offset, const void* q_len,
                                    const void* kv_len, void* out, void* part_o,
                                    void* part_ml, int B, int sq, int nq,
                                    int nkv, int hd, int hdv, int page, int nb,
                                    int n_pages, int rows, int n_split,
                                    float scale, int dtype, void* stream) {
  if (n_pages <= 0 || page <= 0) return cudaErrorInvalidValue;
  const FlashArgs a{q, k_pages, v_pages, (const int*)q_offset,
                    (const int*)q_len, (const int*)kv_len, out,
                    (float*)part_o, (float*)part_ml, B, sq, nq, nkv, hd, hdv,
                    rows, n_split, scale};
  const PagedKV kv{(const int*)block_tables, page, nb, n_pages};
  return flash_run(dtype, a, kv, (cudaStream_t)stream);
}
