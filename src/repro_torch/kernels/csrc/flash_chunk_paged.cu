// Ragged causal flash attention through per-slot block tables.
//
// Replaces: src/repro/kernels/flash_chunk.py :: flash_chunk_paged (the
// Pallas body _flash_chunk_kernel with the _paged_kv_tile_index map).
//
// What bounds it on an H100: on the serving path it is bytes.  A decode row
// reads its slot's whole KV prefix for 4 * hd flops per key and query head
// group (phi3.5: g = 4), far below the ~295 flop/byte ridge; only long
// prefill chunks approach the compute side.  The design therefore makes sure
// no byte is read that the answer does not need:
//   * one CTA per (q tile, kv head, slot) holds the tile's bq * g query rows
//     (query head n belongs to kv head n / g), so each K/V tile fetched from
//     HBM serves every query head of its group;
//   * KV tiles are walked in a loop only up to the causal frontier
//     min(kv_len, q_off + tile_lo + rows); keys past kv_len are never loaded
//     (an unallocated -1 page is clamped to page 0 and never read);
//   * q tiles past q_len, and slots with q_len == 0, write exact zeros and
//     return before touching K/V.
// The online softmax (m, l, acc) runs in float32 registers; masked
// probabilities are re-zeroed so an all-masked row keeps l = 0 and flushes to
// exact zeros.  Products are plain FMA on CUDA cores: tensor cores (wgmma,
// TMA-fed tiles) are later work.
#include <atomic>

#include "common.cuh"

namespace {

constexpr int ROWS = 64;      // query rows (position x head-in-group) per CTA
constexpr int BS = 32;        // keys per KV tile
constexpr int THREADS = 128;  // 16 row groups x 8 key groups
constexpr float NEG_INF = -1e30f;

template <typename T, int DPT>
__global__ void __launch_bounds__(THREADS) flash_chunk_paged_kernel(
    const T* __restrict__ q, const T* __restrict__ kp, const T* __restrict__ vp,
    const int* __restrict__ bt, const int* __restrict__ q_off_p,
    const int* __restrict__ q_len_p, const int* __restrict__ kv_len_p,
    T* __restrict__ out, int sq, int nq, int nkv, int hd, int hdv, int page,
    int nb, int n_pages, float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;                    // [hd][ROWS]
  float* Ks = Qs + hd * ROWS;          // [hd][BS]
  float* Vs = Ks + hd * BS;            // [BS][hdv]
  float* Ps = Vs + BS * hdv;           // [ROWS][BS + 1]

  const int g = nq / nkv;
  const int bq = ROWS / g;             // query positions per tile
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int kg = tid & 7;              // key group: keys kg + 8 * j
  const int rg = tid >> 3;             // row group: rows rg + 16 * i
  const int q_off = q_off_p[b], q_len = q_len_p[b];
  const int kv_len = min(kv_len_p[b], nb * page);   // keys the table maps
  const int row_hi = min(q_len - qt * bq, bq);   // real query positions

  // output row r of this tile -> (position, head); -1 when it maps nowhere
  auto out_index = [&](int r) -> long long {
    const int pl = r / g, gi = r % g, pos = qt * bq + pl;
    if (pl >= bq || pos >= sq) return -1;
    return ((long long)(b * sq + pos) * nq + h * g + gi) * hdv;
  };

  float acc[4][DPT];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int d = 0; d < DPT; ++d) acc[i][d] = 0.f;
  }

  if (row_hi > 0) {
    // query tile, pre-scaled, transposed to [d][row]
    for (int idx = tid; idx < ROWS * hd; idx += THREADS) {
      const int r = idx / hd, d = idx % hd;
      const int pl = r / g, gi = r % g, pos = qt * bq + pl;
      float val = 0.f;
      if (pl < bq && pl < row_hi && pos < sq)
        val = to_f(q[((long long)(b * sq + pos) * nq + h * g + gi) * hd + d]) * scale;
      Qs[d * ROWS + r] = val;
    }
    const int kv_limit = min(kv_len, q_off + qt * bq + row_hi);
    const int n_tiles = kv_limit > 0 ? (kv_limit + BS - 1) / BS : 0;

    // absolute position and reality of this thread's rows
    int qpos[4];
    bool real[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = rg + 16 * i, pl = r / g;
      real[i] = pl < bq && pl < row_hi;
      qpos[i] = q_off + qt * bq + pl;
    }

    for (int j = 0; j < n_tiles; ++j) {
      __syncthreads();   // previous tile's Ks/Vs/Ps are consumed
      for (int idx = tid; idx < BS * hd; idx += THREADS) {
        const int key = idx / hd, d = idx % hd, t = j * BS + key;
        float val = 0.f;
        if (t < kv_len) {
          const int pg = min(max(bt[b * nb + t / page], 0), n_pages - 1);
          val = to_f(kp[(((long long)pg * page + t % page) * nkv + h) * hd + d]);
        }
        Ks[d * BS + key] = val;
      }
      for (int idx = tid; idx < BS * hdv; idx += THREADS) {
        const int key = idx / hdv, d = idx % hdv, t = j * BS + key;
        float val = 0.f;
        if (t < kv_len) {
          const int pg = min(max(bt[b * nb + t / page], 0), n_pages - 1);
          val = to_f(vp[(((long long)pg * page + t % page) * nkv + h) * hdv + d]);
        }
        Vs[key * hdv + d] = val;
      }
      __syncthreads();

      float s[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) s[i][jj] = 0.f;
      for (int d = 0; d < hd; ++d) {
        float a[4], kk[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = Qs[d * ROWS + rg + 16 * i];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) kk[jj] = Ks[d * BS + kg + 8 * jj];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) s[i][jj] = fmaf(a[i], kk[jj], s[i][jj]);
      }

#pragma unroll
      for (int i = 0; i < 4; ++i) {
        bool ok[4];
        float mx = NEG_INF;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int t = j * BS + kg + 8 * jj;
          ok[jj] = real[i] && t < kv_len && t <= qpos[i];
          if (!ok[jj]) s[i][jj] = NEG_INF;
          mx = fmaxf(mx, s[i][jj]);
        }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
        const float m_new = fmaxf(m[i], mx);
        float sum = 0.f;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const float p = ok[jj] ? expf(s[i][jj] - m_new) : 0.f;
          Ps[(rg + 16 * i) * (BS + 1) + kg + 8 * jj] = p;
          sum += p;
        }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        sum += __shfl_xor_sync(0xffffffffu, sum, 4);
        const float corr = expf(m[i] - m_new);
        l[i] = l[i] * corr + sum;
        m[i] = m_new;
#pragma unroll
        for (int d = 0; d < DPT; ++d) acc[i][d] *= corr;
      }
      __syncthreads();   // Ps complete

      for (int key = 0; key < BS; ++key) {
        float p[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) p[i] = Ps[(rg + 16 * i) * (BS + 1) + key];
#pragma unroll
        for (int d = 0; d < DPT; ++d) {
          const int dc = kg + 8 * d;
          if (dc < hdv) {
            const float v = Vs[key * hdv + dc];
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[i][d] = fmaf(p[i], v, acc[i][d]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long o = out_index(rg + 16 * i);
    if (o < 0) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-20f);
#pragma unroll
    for (int d = 0; d < DPT; ++d) {
      const int dc = kg + 8 * d;
      if (dc < hdv) out[o + dc] = from_f<T>(acc[i][d] * inv);
    }
  }
}

constexpr size_t smem_bytes(int hd, int hdv) {
  return sizeof(float) * ((size_t)hd * ROWS + (size_t)hd * BS +
                          (size_t)BS * hdv + (size_t)ROWS * (BS + 1));
}

// The dynamic shared-memory opt-in belongs to the function on a device.  It
// is set once per device and instantiation, for the largest tile this
// instantiation can be launched with (hd = 256, hdv = 8 * DPT up to 256),
// so launches after the first do no host work for it.
template <typename T, int DPT>
cudaError_t allow_smem() {
  static std::atomic<unsigned long long> done{0};   // one bit per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  constexpr int HDV_MAX = 8 * DPT < 256 ? 8 * DPT : 256;
  err = cudaFuncSetAttribute(flash_chunk_paged_kernel<T, DPT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_bytes(256, HDV_MAX));
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

template <typename T, int DPT>
cudaError_t launch(const void* q, const void* kp, const void* vp, const int* bt,
                   const int* q_off, const int* q_len, const int* kv_len,
                   void* out, int B, int sq, int nq, int nkv, int hd, int hdv,
                   int page, int nb, int n_pages, float scale,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(hd, hdv);
  cudaError_t err = allow_smem<T, DPT>();
  if (err != cudaSuccess) return err;
  const int g = nq / nkv, bq = ROWS / g;
  dim3 grid((sq + bq - 1) / bq, nkv, B);
  flash_chunk_paged_kernel<T, DPT><<<grid, THREADS, smem, stream>>>(
      (const T*)q, (const T*)kp, (const T*)vp, bt, q_off, q_len, kv_len,
      (T*)out, sq, nq, nkv, hd, hdv, page, nb, n_pages, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dpt(int hdv, const void* q, const void* kp, const void* vp,
                         const int* bt, const int* q_off, const int* q_len,
                         const int* kv_len, void* out, int B, int sq, int nq,
                         int nkv, int hd, int page, int nb, int n_pages,
                         float scale, cudaStream_t s) {
  const int need = (hdv + 7) / 8;   // value dims per thread
#define RT_FC(D)                                                              \
  if (need <= D)                                                              \
    return launch<T, D>(q, kp, vp, bt, q_off, q_len, kv_len, out, B, sq, nq, \
                        nkv, hd, hdv, page, nb, n_pages, scale, s);
  RT_FC(1) RT_FC(2) RT_FC(4) RT_FC(8) RT_FC(16) RT_FC(32)
#undef RT_FC
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int rt_flash_chunk_paged(const void* q, const void* k_pages,
                                    const void* v_pages, const void* block_tables,
                                    const void* q_offset, const void* q_len,
                                    const void* kv_len, void* out, int B, int sq,
                                    int nq, int nkv, int hd, int hdv, int page,
                                    int nb, int n_pages, float scale, int dtype,
                                    void* stream) {
  if (B == 0 || sq == 0) return cudaSuccess;
  if (nkv <= 0 || nq % nkv || nq / nkv > ROWS || hd > 256 || hdv > 256 ||
      n_pages <= 0)
    return cudaErrorInvalidValue;
  const int* bt = (const int*)block_tables;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == RT_F32)
    return dispatch_dpt<float>(hdv, q, k_pages, v_pages, bt, (const int*)q_offset,
                               (const int*)q_len, (const int*)kv_len, out, B, sq,
                               nq, nkv, hd, page, nb, n_pages, scale, s);
  if (dtype == RT_BF16)
    return dispatch_dpt<__nv_bfloat16>(hdv, q, k_pages, v_pages, bt,
                                       (const int*)q_offset, (const int*)q_len,
                                       (const int*)kv_len, out, B, sq, nq, nkv,
                                       hd, page, nb, n_pages, scale, s);
  return cudaErrorInvalidValue;
}
