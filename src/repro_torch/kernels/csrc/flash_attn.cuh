// Ragged causal flash attention: the one device body behind flash_chunk
// (dense cache, flash_chunk.cu) and flash_chunk_paged (block tables,
// flash_chunk_paged.cu).
//
// Replaces: src/repro/kernels/flash_chunk.py :: _flash_chunk_kernel, the
// Pallas body that both flash_chunk and flash_chunk_paged run.  As there,
// the two entry points differ only in how a key's row is addressed (the KV
// template argument: DenseKV or PagedKV); the arithmetic and its order are
// the same, so the paged output is bitwise equal to the dense output on the
// gathered cache.
//
// What bounds it on an H100: on the serving path it is bytes.  A decode row
// reads its slot's whole KV prefix for about 2 * (hd + hdv) flops per key and
// query head, far below the ~295 flop/byte ridge; only long prefill chunks
// approach the compute side.  The design makes sure no byte is read that the
// answer does not need:
//   * one CTA holds ROWS = 16 * RPT query rows (position x head-in-group) of
//     one kv head, so each K/V tile fetched from HBM serves every query head
//     of the group it holds.  A group wider than ROWS (MLA absorbed decode:
//     nkv = 1, g = 128) is split across n_hs CTAs of gs = ceil(g / n_hs)
//     heads each;
//   * KV tiles are walked in a loop only up to the causal frontier
//     min(kv_len, q_off + tile_lo + rows); keys past kv_len are never loaded
//     (an unallocated -1 page is clamped to page 0 and never read);
//   * q tiles past q_len, and slots with q_len == 0, write exact zeros and
//     return before touching K/V.
// Head dims up to 768 (keys) and 512 (values) fit because nothing holds a
// whole K/V row: the scaled query tile sits in shared memory as [hd][ROWS];
// K tiles stream through shared memory in DC-column chunks, each adding its
// part of the dot products to the score registers in column order; V tiles
// stream the same way, each chunk updating only its own columns of the
// accumulator.  A thread's accumulator is RPT rows x DPT value columns of
// f32 registers (at most 4 x 32 or 1 x 64).
// The online softmax (m, l, acc) runs in float32; masked probabilities are
// re-zeroed so an all-masked row keeps l = 0 and flushes to exact zeros.
// Products are plain FMA on CUDA cores: tensor cores (wgmma, TMA-fed tiles)
// are later work.
#pragma once

#include <atomic>

#include "common.cuh"

namespace {

constexpr int THREADS = 128;    // RG row groups x KG key groups
constexpr int KG = 8;           // key groups: keys kg + KG * j
constexpr int RG = 16;          // row groups: rows rg + RG * i
constexpr int KPT = 4;          // keys per thread per tile
constexpr int BS = KG * KPT;    // keys per KV tile
constexpr int DC = 64;          // K columns per shared-memory chunk
constexpr int HD_MAX = 768;     // key (and query) head dim
constexpr int HDV_MAX = 512;    // value head dim
constexpr float NEG_INF = -1e30f;

// A key's row in a dense (B, S, nkv, d) cache.
struct DenseKV {
  int S;
  __device__ int keys() const { return S; }
  __device__ long long row(int b, int t) const { return (long long)b * S + t; }
};

// A key's row in a (P, page, nkv, d) pool through the slot's block table.
struct PagedKV {
  const int* bt;
  int page, nb, n_pages;
  __device__ int keys() const { return nb * page; }
  __device__ long long row(int b, int t) const {
    const int pg = min(max(bt[b * nb + t / page], 0), n_pages - 1);
    return (long long)pg * page + t % page;
  }
};

struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  const int* q_off;
  const int* q_len;
  const int* kv_len;
  void* out;
  int B, sq, nq, nkv, hd, hdv;
  float scale;
};

template <int RPT, int DPT>
struct Tile {
  static constexpr int ROWS = RG * RPT;
  static constexpr int DPCH = DPT < 8 ? DPT : 8;   // value cols per thread per chunk
  static constexpr int DCV = KG * DPCH;            // value cols per chunk
  static constexpr int NCH = DPT / DPCH;           // value chunks
  static constexpr size_t smem(int hd) {
    return sizeof(float) * ((size_t)hd * ROWS + (size_t)DC * BS +
                            (size_t)BS * DCV + (size_t)ROWS * (BS + 1));
  }
};

template <typename T, class KV, int RPT, int DPT>
__global__ void __launch_bounds__(THREADS) flash_attn_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    KV kv, const int* __restrict__ q_off_p, const int* __restrict__ q_len_p,
    const int* __restrict__ kv_len_p, T* __restrict__ out, int sq, int nq,
    int nkv, int hd, int hdv, int n_hs, float scale) {
  using TL = Tile<RPT, DPT>;
  constexpr int ROWS = TL::ROWS, DCV = TL::DCV, DPCH = TL::DPCH;
  extern __shared__ float smem[];
  float* Qs = smem;                    // [hd][ROWS]
  float* Ks = Qs + hd * ROWS;          // [DC][BS]
  float* Vs = Ks + DC * BS;            // [BS][DCV]
  float* Ps = Vs + BS * DCV;           // [ROWS][BS + 1]

  const int g = nq / nkv;
  const int gs = (g + n_hs - 1) / n_hs;   // query heads of the group here
  const int bq = ROWS / gs;               // query positions per tile
  const int qt = blockIdx.x / n_hs, hs = blockIdx.x % n_hs;
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int kg = tid % KG, rg = tid / KG;
  const int q_off = q_off_p[b], q_len = q_len_p[b];
  const int kv_len = min(kv_len_p[b], kv.keys());   // keys that exist
  const int row_hi = min(q_len - qt * bq, bq);      // real query positions

  // tile row r -> (position, query head); -1 when it maps nowhere
  auto q_index = [&](int r) -> long long {
    const int pl = r / gs, gi = hs * gs + r % gs, pos = qt * bq + pl;
    if (pl >= bq || gi >= g || pos >= sq) return -1;
    return (long long)(b * sq + pos) * nq + h * g + gi;
  };

  float acc[RPT][DPT];
  float m[RPT], l[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int d = 0; d < DPT; ++d) acc[i][d] = 0.f;
  }

  if (row_hi > 0) {
    // query tile, pre-scaled, transposed to [d][row]
    for (int idx = tid; idx < ROWS * hd; idx += THREADS) {
      const int r = idx / hd, d = idx % hd;
      const long long qi = q_index(r);
      float val = 0.f;
      if (qi >= 0 && r / gs < row_hi) val = to_f(q[qi * hd + d]) * scale;
      Qs[d * ROWS + r] = val;
    }
    const int kv_limit = min(kv_len, q_off + qt * bq + row_hi);
    const int n_tiles = kv_limit > 0 ? (kv_limit + BS - 1) / BS : 0;

    // absolute position and reality of this thread's rows
    int qpos[RPT];
    bool real[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = rg + RG * i;
      real[i] = q_index(r) >= 0 && r / gs < row_hi;
      qpos[i] = q_off + qt * bq + r / gs;
    }

    for (int j = 0; j < n_tiles; ++j) {
      // scores: K streams through Ks in DC-column chunks, in column order
      float s[RPT][KPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int jj = 0; jj < KPT; ++jj) s[i][jj] = 0.f;
      for (int c0 = 0; c0 < hd; c0 += DC) {
        const int dc = min(DC, hd - c0);
        __syncthreads();   // Ks (and, at c0 == 0, last tile's Vs/Ps) free
        for (int idx = tid; idx < BS * dc; idx += THREADS) {
          const int key = idx / dc, d = idx % dc, t = j * BS + key;
          float val = 0.f;
          if (t < kv_len)
            val = to_f(k[(kv.row(b, t) * nkv + h) * hd + c0 + d]);
          Ks[d * BS + key] = val;
        }
        __syncthreads();
        for (int d = 0; d < dc; ++d) {
          float a[RPT], kk[KPT];
#pragma unroll
          for (int i = 0; i < RPT; ++i) a[i] = Qs[(c0 + d) * ROWS + rg + RG * i];
#pragma unroll
          for (int jj = 0; jj < KPT; ++jj) kk[jj] = Ks[d * BS + kg + KG * jj];
#pragma unroll
          for (int i = 0; i < RPT; ++i)
#pragma unroll
            for (int jj = 0; jj < KPT; ++jj) s[i][jj] = fmaf(a[i], kk[jj], s[i][jj]);
        }
      }

      // online softmax over the tile; the KG lanes of a row sit in one warp
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        bool ok[KPT];
        float mx = NEG_INF;
#pragma unroll
        for (int jj = 0; jj < KPT; ++jj) {
          const int t = j * BS + kg + KG * jj;
          ok[jj] = real[i] && t < kv_len && t <= qpos[i];
          if (!ok[jj]) s[i][jj] = NEG_INF;
          mx = fmaxf(mx, s[i][jj]);
        }
#pragma unroll
        for (int o = 1; o < KG; o <<= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const float m_new = fmaxf(m[i], mx);
        float sum = 0.f;
#pragma unroll
        for (int jj = 0; jj < KPT; ++jj) {
          const float p = ok[jj] ? expf(s[i][jj] - m_new) : 0.f;
          Ps[(rg + RG * i) * (BS + 1) + kg + KG * jj] = p;
          sum += p;
        }
#pragma unroll
        for (int o = 1; o < KG; o <<= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, o);
        const float corr = expf(m[i] - m_new);
        l[i] = l[i] * corr + sum;
        m[i] = m_new;
#pragma unroll
        for (int d = 0; d < DPT; ++d) acc[i][d] *= corr;
      }

      // values: V streams through Vs in DCV-column chunks; the thread's
      // columns are kg + KG * d, chunk cc holding d in [cc*DPCH, +DPCH)
#pragma unroll
      for (int cc = 0; cc < TL::NCH; ++cc) {
        const int c0 = cc * DCV;
        if (c0 >= hdv) break;
        __syncthreads();   // Ps complete; the previous chunk's Vs consumed
        for (int idx = tid; idx < BS * DCV; idx += THREADS) {
          const int key = idx / DCV, d = idx % DCV, t = j * BS + key;
          float val = 0.f;
          if (t < kv_len && c0 + d < hdv)
            val = to_f(v[(kv.row(b, t) * nkv + h) * hdv + c0 + d]);
          Vs[key * DCV + d] = val;
        }
        __syncthreads();
        for (int key = 0; key < BS; ++key) {
          float p[RPT];
#pragma unroll
          for (int i = 0; i < RPT; ++i) p[i] = Ps[(rg + RG * i) * (BS + 1) + key];
#pragma unroll
          for (int d = 0; d < DPCH; ++d) {
            const float vv = Vs[key * DCV + kg + KG * d];
#pragma unroll
            for (int i = 0; i < RPT; ++i)
              acc[i][cc * DPCH + d] = fmaf(p[i], vv, acc[i][cc * DPCH + d]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const long long o = q_index(rg + RG * i);
    if (o < 0) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-20f);
#pragma unroll
    for (int d = 0; d < DPT; ++d) {
      const int dc = kg + KG * d;
      if (dc < hdv) out[o * hdv + dc] = from_f<T>(acc[i][d] * inv);
    }
  }
}

// The dynamic shared-memory opt-in belongs to the function on a device.  It
// is set once per device and instantiation, for the largest tile the
// instantiation can be launched with (hd = HD_MAX), so launches after the
// first do no host work for it.
template <typename T, class KV, int RPT, int DPT>
cudaError_t allow_smem() {
  static std::atomic<unsigned long long> done{0};   // one bit per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(flash_attn_kernel<T, KV, RPT, DPT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)Tile<RPT, DPT>::smem(HD_MAX));
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

template <typename T, class KV, int RPT, int DPT>
cudaError_t flash_launch(const FlashArgs& a, KV kv, cudaStream_t stream) {
  constexpr int ROWS = Tile<RPT, DPT>::ROWS;
  cudaError_t err = allow_smem<T, KV, RPT, DPT>();
  if (err != cudaSuccess) return err;
  const int g = a.nq / a.nkv;
  const int n_hs = (g + ROWS - 1) / ROWS;        // CTAs per query-head group
  const int gs = (g + n_hs - 1) / n_hs, bq = ROWS / gs;
  dim3 grid(((a.sq + bq - 1) / bq) * n_hs, a.nkv, a.B);
  flash_attn_kernel<T, KV, RPT, DPT>
      <<<grid, THREADS, Tile<RPT, DPT>::smem(a.hd), stream>>>(
          (const T*)a.q, (const T*)a.k, (const T*)a.v, kv, a.q_off, a.q_len,
          a.kv_len, (T*)a.out, a.sq, a.nq, a.nkv, a.hd, a.hdv, n_hs, a.scale);
  return cudaGetLastError();
}

// Value columns per thread: the smallest instantiation that covers hdv.
// Up to 256 a thread holds 4 rows (64-row tiles); above, 1 row (16-row
// tiles), which keeps the accumulator at 64 registers.
template <typename T, class KV>
cudaError_t flash_dispatch(const FlashArgs& a, KV kv, cudaStream_t s) {
  const int need = (a.hdv + KG - 1) / KG;
#define RT_FA(R, D) \
  if (need <= D) return flash_launch<T, KV, R, D>(a, kv, s);
  RT_FA(4, 1) RT_FA(4, 2) RT_FA(4, 4) RT_FA(4, 8) RT_FA(4, 16) RT_FA(4, 32)
  RT_FA(1, 64)
#undef RT_FA
  return cudaErrorInvalidValue;
}

template <class KV>
cudaError_t flash_run(int dtype, const FlashArgs& a, KV kv, cudaStream_t s) {
  if (a.B == 0 || a.sq == 0) return cudaSuccess;
  if (a.nkv <= 0 || a.nq % a.nkv || a.hd <= 0 || a.hd > HD_MAX ||
      a.hdv <= 0 || a.hdv > HDV_MAX)
    return cudaErrorInvalidValue;
  if (dtype == RT_F32) return flash_dispatch<float>(a, kv, s);
  if (dtype == RT_BF16) return flash_dispatch<__nv_bfloat16>(a, kv, s);
  return cudaErrorInvalidValue;
}

}  // namespace
