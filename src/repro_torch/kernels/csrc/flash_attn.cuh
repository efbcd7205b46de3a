// Ragged causal flash attention: the one device body behind flash_chunk
// (dense cache, flash_chunk.cu) and flash_chunk_paged (block tables,
// flash_chunk_paged.cu).
//
// Replaces: src/repro/kernels/flash_chunk.py :: _flash_chunk_kernel, the
// Pallas body that both flash_chunk and flash_chunk_paged run.  As there,
// the two entry points differ only in how a key's row is addressed (the KV
// template argument: DenseKV or PagedKV); the arithmetic, its order and the
// launch geometry are the same, so the paged output is bitwise equal to the
// dense output on the gathered cache.
//
// What bounds it on an H100: bytes.  A key's K and V rows are 2 * (hd +
// hdv) bytes and cost 2 * (hd + hdv) flops for each query row that sees
// them, so the kernel does one flop per K/V byte per such row: g for a
// decode position (4 at phi3.5), at most 64 * g for a 64-position chunk
// (256 at phi3.5, 64 for MLA expanded, 128 for the absorbed decode), all
// under the ~295 flop/byte ridge of the bf16 tensor cores.  So the design
// reads each K/V byte as few times as it can and keeps enough of the card
// busy to stream them:
//   * bf16 runs on tensor cores (mma.sync m16n8k16, FlashAttention-2
//     layout).  A CTA holds ROWS = 16 * NW query rows (position x
//     head-in-group) of one kv head, one warp per 16 rows, so each K/V tile
//     serves every query head of the group the CTA holds.  ROWS is 128 for
//     GQA (a 64-position chunk at g = 4 reads its prefix twice) and 64 for
//     g = 1 or head dims above 256; a group wider than ROWS (MLA absorbed:
//     nkv = 1, g = 128) is split across n_hs CTAs;
//   * S = Q K^T goes to f32 fragments and is scaled in f32; the online
//     softmax (m, l) stays in f32 registers, masked probabilities are exact
//     zeros (an all-masked row flushes to exact zeros).  P is split into a
//     bf16 high part and a bf16 residual, and PV runs on both (V through
//     ldmatrix.trans), so P keeps f32-level error: the doubled PV products
//     cost no time on a byte-bound kernel;
//   * K/V tiles of BKV = 64 keys (32 for head dims above 256) stream
//     through a 2-stage ring of 16-byte cp.async copies in padded shared
//     memory.  Each thread loads chunks of one key row, so a row's address
//     (the block-table lookup for PagedKV) is computed once per row and
//     tile.  Keys past kv_len are zero-filled, never read; tiles past the
//     causal frontier are not walked; an unallocated -1 page is clamped and
//     never read.  Head dims are zero-padded to a multiple of 16 in shared
//     memory;
//   * value columns: a CTA computes TC_DV = 128 of them (its accumulator is
//     64 f32 registers); wider values (hdv 512) split across n_vc CTAs,
//     each recomputing S from the same L2-resident K tile;
//   * split-KV: the host picks n_split from the launch geometry alone
//     (ops.flash_plan: B, query tiles, nkv, n_hs, n_vc against 132 SMs;
//     never a length), so dense and paged launches split alike.  Split s
//     walks a contiguous range of the CTA's KV tiles, computed on device
//     from kv_len, and writes (m, l, unnormalised O) of its real rows to
//     f32 scratch; flash_combine_kernel merges the splits in a fixed order.
//     A split with no keys contributes l = 0 and adds nothing;
//   * q tiles past q_len and slots with q_len == 0 load nothing and write
//     exact zeros.
// float32 keeps the FMA body on CUDA cores (flash_attn_kernel_fma, the
// parity path, no TF32): one CTA of ROWS = 16 * RPT rows, K and V staged
// through shared memory in column chunks, so head dims up to 768 (keys)
// and 512 (values) fit with a register accumulator of at most 4 x 32 or
// 1 x 64 values per thread.
#pragma once

#include "common.cuh"

namespace {

constexpr int THREADS = 128;    // f32 body: RG row groups x KG key groups
constexpr int KG = 8;           // key groups: keys kg + KG * j
constexpr int RG = 16;          // row groups: rows rg + RG * i
constexpr int KPT = 4;          // keys per thread per tile
constexpr int BS = KG * KPT;    // keys per KV tile
constexpr int DC = 64;          // K columns per shared-memory chunk
constexpr int HD_MAX = 768;     // key (and query) head dim
constexpr int HDV_MAX = 512;    // value head dim
constexpr int TC_DV = 128;      // bf16 body: value columns per CTA
constexpr int MAX_SPLIT = 16;   // bf16 body: KV splits per query tile
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

// rows / n_split: the bf16 body's launch plan (ops.flash_plan); part_o
// (n_split, B * sq * nq, hdv) and part_ml (n_split, B * sq * nq, 2) f32
// scratch when n_split > 1
struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  const int* q_off;
  const int* q_len;
  const int* kv_len;
  void* out;
  float* part_o;
  float* part_ml;
  int B, sq, nq, nkv, hd, hdv, rows, n_split;
  float scale;
};

// ---------------------------------------------------------------------------
// float32: FMA on CUDA cores
// ---------------------------------------------------------------------------

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
__global__ void __launch_bounds__(THREADS) flash_attn_kernel_fma(
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

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

template <int NW, int BKV>
struct TcTile {
  static constexpr int THREADS = 32 * NW;
  static constexpr int ROWS = 16 * NW;
  static constexpr int TPR = THREADS / BKV;        // loader threads per key
  static constexpr int VS = TC_DV + 8;             // padded V row stride
  static constexpr int HD_CAP = BKV == 64 ? 256 : HD_MAX;
  // padded K/Q row stride: an odd number of 16-byte units, so the 8 rows of
  // each ldmatrix hit distinct banks
  __host__ __device__ static constexpr int hdp(int hd) {
    return (hd + 15) / 16 * 16 + 8;
  }
  static constexpr size_t smem(int hd) {
    return 2 * ((size_t)ROWS * hdp(hd) + 2 * (size_t)BKV * hdp(hd) +
                2 * (size_t)BKV * VS);
  }
};

// (x0, x1) as a bf16 pair `hi` and the bf16 pair of what it rounded away
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x0 - hf.x, x1 - hf.y);
}

// grid (n_qt * n_hs * n_vc, nkv, B * n_split); dynamic shared memory
// TcTile::smem(hd)
template <class KV, int NW, int BKV>
__global__ void __launch_bounds__(32 * NW, 1) flash_attn_kernel_mma(
    const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
    const uint16_t* __restrict__ v, KV kv, const int* __restrict__ q_off_p,
    const int* __restrict__ q_len_p, const int* __restrict__ kv_len_p,
    __nv_bfloat16* __restrict__ out, float* __restrict__ part_o,
    float* __restrict__ part_ml, int sq, int nq, int nkv, int hd, int hdv,
    int n_hs, int n_vc, int n_split, float scale) {
  using TT = TcTile<NW, BKV>;
  constexpr int ROWS = TT::ROWS, THREADS_ = TT::THREADS, TPR = TT::TPR;
  constexpr int VS = TT::VS;
  constexpr int NS = BKV / 8;      // score n-subtiles per warp
  constexpr int NO = TC_DV / 8;    // output n-subtiles per warp
  extern __shared__ __align__(16) uint16_t smem_tc[];
  const int hd16 = (hd + 15) & ~15, HDP = TT::hdp(hd);
  uint16_t* Qs = smem_tc;                  // [ROWS][HDP]
  uint16_t* Ks = Qs + ROWS * HDP;          // [2][BKV][HDP]
  uint16_t* Vs = Ks + 2 * BKV * HDP;       // [2][BKV][VS]

  const int g = nq / nkv;
  const int gs = (g + n_hs - 1) / n_hs;    // query heads of the group here
  const int bq = ROWS / gs;                // query positions per tile
  const int vc = blockIdx.x % n_vc, hs = (blockIdx.x / n_vc) % n_hs;
  const int qt = blockIdx.x / (n_vc * n_hs);
  const int h = blockIdx.y, b = blockIdx.z / n_split, sp = blockIdx.z % n_split;
  const long long R = (long long)(gridDim.z / n_split) * sq * nq;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g8 = lane >> 2, t4 = lane & 3;         // mma fragment coords
  const int q_off = q_off_p[b], q_len = q_len_p[b];
  const int kv_len = min(kv_len_p[b], kv.keys());  // keys that exist
  const int row_hi = min(q_len - qt * bq, bq);     // real query positions
  const int c0v = vc * TC_DV;

  // tile row r -> (position, query head); -1 when it maps nowhere
  auto q_index = [&](int r) -> long long {
    const int pl = r / gs, gi = hs * gs + r % gs, pos = qt * bq + pl;
    if (pl >= bq || gi >= g || pos >= sq) return -1;
    return (long long)(b * sq + pos) * nq + h * g + gi;
  };

  // this thread's two rows: warp * 16 + g8 and + 8
  long long qi[2];
  bool real[2];
  int qpos[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = warp * 16 + g8 + 8 * i;
    qi[i] = q_index(r);
    real[i] = qi[i] >= 0 && r / gs < row_hi;
    qpos[i] = q_off + qt * bq + r / gs;
  }
  const bool warp_live = __any_sync(0xffffffffu, real[0] || real[1]);

  // this split's KV tiles, up to the causal frontier of the tile's rows
  const int kv_limit = row_hi > 0 ? min(kv_len, q_off + qt * bq + row_hi) : 0;
  const int n_tiles = kv_limit > 0 ? (kv_limit + BKV - 1) / BKV : 0;
  const int per = (n_tiles + n_split - 1) / n_split;
  const int jt0 = sp * per, jt1 = min(jt0 + per, n_tiles);

  float o[NO][4];
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[n][i] = 0.f;

  if (jt0 < jt1) {
    // the query tile, zero past hd and in rows that are not real
    const int ck = hd16 / 8;
    for (int li = tid; li < ROWS * ck; li += THREADS_) {
      const int r = li / ck, c = (li % ck) * 8;
      const long long qr = q_index(r);
      const bool ok = qr >= 0 && r / gs < row_hi && c < hd;
      cp_async16(Qs + r * HDP + c, ok ? q + qr * hd + c : q, ok);
    }
    // K/V tile j into ring slot buf: this thread copies chunks sub + TPR*i
    // of key row lk, whose address it computes once
    const int lk = tid / TPR, sub = tid % TPR;
    auto load_kv = [&](int j, int buf) {
      const int t = j * BKV + lk;
      const bool ok = t < kv_len;
      const long long base = ok ? kv.row(b, t) * nkv + h : 0;
      uint16_t* ks = Ks + (buf * BKV + lk) * HDP;
      const uint16_t* kr = k + base * hd;
      for (int c = sub * 8; c < hd16; c += TPR * 8) {
        const bool okc = ok && c < hd;
        cp_async16(ks + c, okc ? kr + c : k, okc);
      }
      uint16_t* vs = Vs + (buf * BKV + lk) * VS;
      const uint16_t* vr = v + base * hdv + c0v;
      for (int c = sub * 8; c < TC_DV; c += TPR * 8) {
        const bool okc = ok && c0v + c < hdv;
        cp_async16(vs + c, okc ? vr + c : v, okc);
      }
    };
    load_kv(jt0, 0);
    cp_async_commit();
    // fragment addresses (ldmatrix lane roles)
    const uint16_t* qrow = Qs + (warp * 16 + (lane & 15)) * HDP + (lane >> 4) * 8;
    const int krow = ((lane & 7) + (lane >> 4) * 8) * HDP + ((lane >> 3) & 1) * 8;
    const int vrow = ((lane & 7) + ((lane >> 3) & 1) * 8) * VS + (lane >> 4) * 8;

    for (int j = jt0; j < jt1; ++j) {
      const int buf = (j - jt0) & 1;
      if (j + 1 < jt1) {
        load_kv(j + 1, buf ^ 1);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      if (warp_live) {
        const uint16_t* ks = Ks + buf * BKV * HDP;
        const uint16_t* vs = Vs + buf * BKV * VS;
        float s[NS][4];
#pragma unroll
        for (int n = 0; n < NS; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) s[n][i] = 0.f;
        for (int kk = 0; kk < hd16; kk += 16) {
          uint32_t a[4];
          ldsm_x4(a, qrow + kk);
#pragma unroll
          for (int np = 0; np < NS / 2; ++np) {
            uint32_t r[4];
            ldsm_x4(r, ks + krow + np * 16 * HDP + kk);
            mma_bf16(s[2 * np], a, r[0], r[1]);
            mma_bf16(s[2 * np + 1], a, r[2], r[3]);
          }
        }
        // online softmax; a row's 4 fragment lanes (t4) reduce by shuffles
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          unsigned okm = 0;
          float mx = NEG_INF;
#pragma unroll
          for (int n = 0; n < NS; ++n)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int t = j * BKV + n * 8 + 2 * t4 + e;
              const bool ok = real[i] && t < kv_len && t <= qpos[i];
              okm |= (unsigned)ok << (2 * n + e);
              s[n][2 * i + e] = ok ? s[n][2 * i + e] * scale : NEG_INF;
              mx = fmaxf(mx, s[n][2 * i + e]);
            }
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          const float m_new = fmaxf(m[i], mx);
          float sum = 0.f;
#pragma unroll
          for (int n = 0; n < NS; ++n)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float p = (okm >> (2 * n + e)) & 1u
                                  ? expf(s[n][2 * i + e] - m_new) : 0.f;
              s[n][2 * i + e] = p;
              sum += p;
            }
          sum += __shfl_xor_sync(0xffffffffu, sum, 1);
          sum += __shfl_xor_sync(0xffffffffu, sum, 2);
          const float corr = expf(m[i] - m_new);
          l[i] = l[i] * corr + sum;
          m[i] = m_new;
#pragma unroll
          for (int n = 0; n < NO; ++n) {
            o[n][2 * i] *= corr;
            o[n][2 * i + 1] *= corr;
          }
        }
        // O += P V, P as bf16 high part + bf16 residual
#pragma unroll
        for (int kc = 0; kc < BKV / 16; ++kc) {
          uint32_t hi[4], lo[4];
          split_bf16(s[2 * kc][0], s[2 * kc][1], hi[0], lo[0]);
          split_bf16(s[2 * kc][2], s[2 * kc][3], hi[1], lo[1]);
          split_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1], hi[2], lo[2]);
          split_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3], hi[3], lo[3]);
#pragma unroll
          for (int dp = 0; dp < NO / 2; ++dp) {
            if (c0v + dp * 16 < hdv) {
              uint32_t r[4];
              ldsm_x4_trans(r, vs + vrow + kc * 16 * VS + dp * 16);
              mma_bf16(o[2 * dp], hi, r[0], r[1]);
              mma_bf16(o[2 * dp], lo, r[0], r[1]);
              mma_bf16(o[2 * dp + 1], hi, r[2], r[3]);
              mma_bf16(o[2 * dp + 1], lo, r[2], r[3]);
            }
          }
        }
      }
      __syncthreads();   // slot buf is reloaded next iteration
    }
  }

  // one split: normalise and write every mapped row (zeros where not real);
  // several: the real rows' partial state goes to scratch
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (qi[i] < 0) continue;
    if (n_split == 1) {
      const float inv = 1.f / fmaxf(l[i], 1e-20f);
      __nv_bfloat16* orow = out + qi[i] * hdv;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        const int c = c0v + n * 8 + 2 * t4;
        if (c < hdv)
          *reinterpret_cast<__nv_bfloat162*>(orow + c) = __floats2bfloat162_rn(
              o[n][2 * i] * inv, o[n][2 * i + 1] * inv);
      }
    } else if (real[i]) {
      const long long pr = sp * R + qi[i];
      float* prow = part_o + pr * hdv;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        const int c = c0v + n * 8 + 2 * t4;
        if (c < hdv)
          *reinterpret_cast<float2*>(prow + c) =
              make_float2(o[n][2 * i], o[n][2 * i + 1]);
      }
      if (vc == 0 && t4 == 0) {
        part_ml[2 * pr] = m[i];
        part_ml[2 * pr + 1] = l[i];
      }
    }
  }
}

// Merges the n_split partial states of each output row in split order; one
// warp per row of the (B * sq * nq, hdv) output, lane s reading split s's
// (m, l) and each lane 4 value columns at a time.  Rows past q_len and rows
// whose splits saw no key are exact zeros.  Templated on KV only so that a
// profile attributes it to its entry point.
template <class KV>
__global__ void __launch_bounds__(256) flash_combine_kernel(
    const float* __restrict__ part_o, const float* __restrict__ part_ml,
    const int* __restrict__ q_len_p, __nv_bfloat16* __restrict__ out, int B,
    int sq, int nq, int hdv, int n_split) {
  const long long R = (long long)B * sq * nq;
  const long long row = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= R) return;                      // uniform in the warp
  const int b = (int)(row / ((long long)sq * nq));
  const int pos = (int)((row / nq) % sq);
  float ms = NEG_INF, ls = 0.f;
  if (pos < q_len_p[b] && lane < n_split) {
    const float2 ml =
        *reinterpret_cast<const float2*>(part_ml + 2 * (lane * R + row));
    ms = ml.x;
    ls = ml.y;
  }
  float M = ls > 0.f ? ms : NEG_INF;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, o));
  const float wl = ls > 0.f ? expf(ms - M) : 0.f;
  float L = wl * ls;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) L += __shfl_xor_sync(0xffffffffu, L, o);
  const float inv = L > 0.f ? 1.f / L : 0.f;
  float wgt[MAX_SPLIT];
#pragma unroll
  for (int s = 0; s < MAX_SPLIT; ++s)
    wgt[s] = __shfl_sync(0xffffffffu, wl, s);
  __nv_bfloat16* o = out + row * hdv;
  for (int c = 4 * lane; c < hdv; c += 128) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int s = 0; s < MAX_SPLIT; ++s) {
      if (wgt[s] > 0.f) {
        const float4 p =
            *reinterpret_cast<const float4*>(part_o + (s * R + row) * hdv + c);
        acc.x += wgt[s] * p.x;
        acc.y += wgt[s] * p.y;
        acc.z += wgt[s] * p.z;
        acc.w += wgt[s] * p.w;
      }
    }
    *reinterpret_cast<__nv_bfloat162*>(o + c) =
        __floats2bfloat162_rn(acc.x * inv, acc.y * inv);
    *reinterpret_cast<__nv_bfloat162*>(o + c + 2) =
        __floats2bfloat162_rn(acc.z * inv, acc.w * inv);
  }
}

template <class KV, int NW, int BKV>
cudaError_t launch_mma(const FlashArgs& a, KV kv, cudaStream_t stream) {
  using TT = TcTile<NW, BKV>;
  static std::atomic<unsigned long long> done{0};
  cudaError_t err = allow_smem((const void*)flash_attn_kernel_mma<KV, NW, BKV>,
                               (int)TT::smem(TT::HD_CAP), done);
  if (err != cudaSuccess) return err;
  const int g = a.nq / a.nkv;
  const int n_hs = (g + TT::ROWS - 1) / TT::ROWS;
  const int gs = (g + n_hs - 1) / n_hs, bq = TT::ROWS / gs;
  const int n_vc = (a.hdv + TC_DV - 1) / TC_DV;
  dim3 grid(((a.sq + bq - 1) / bq) * n_hs * n_vc, a.nkv, a.B * a.n_split);
  flash_attn_kernel_mma<KV, NW, BKV>
      <<<grid, TT::THREADS, TT::smem(a.hd), stream>>>(
          (const uint16_t*)a.q, (const uint16_t*)a.k, (const uint16_t*)a.v,
          kv, a.q_off, a.q_len, a.kv_len, (__nv_bfloat16*)a.out, a.part_o,
          a.part_ml, a.sq, a.nq, a.nkv, a.hd, a.hdv, n_hs, n_vc, a.n_split,
          a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.n_split == 1) return err;
  const long long rows = (long long)a.B * a.sq * a.nq;
  flash_combine_kernel<KV><<<(unsigned)((rows + 7) / 8), 256, 0, stream>>>(
      a.part_o, a.part_ml, a.q_len, (__nv_bfloat16*)a.out, a.B, a.sq, a.nq,
      a.hdv, a.n_split);
  return cudaGetLastError();
}

template <class KV, int RPT, int DPT>
cudaError_t launch_fma(const FlashArgs& a, KV kv, cudaStream_t stream) {
  using TL = Tile<RPT, DPT>;
  static std::atomic<unsigned long long> done{0};
  // the opt-in is set for the largest tile (hd = HD_MAX)
  cudaError_t err = allow_smem((const void*)flash_attn_kernel_fma<float, KV,
                                                                  RPT, DPT>,
                               (int)TL::smem(HD_MAX), done);
  if (err != cudaSuccess) return err;
  const int g = a.nq / a.nkv;
  const int n_hs = (g + TL::ROWS - 1) / TL::ROWS;   // CTAs per head group
  const int gs = (g + n_hs - 1) / n_hs, bq = TL::ROWS / gs;
  dim3 grid(((a.sq + bq - 1) / bq) * n_hs, a.nkv, a.B);
  flash_attn_kernel_fma<float, KV, RPT, DPT>
      <<<grid, THREADS, TL::smem(a.hd), stream>>>(
          (const float*)a.q, (const float*)a.k, (const float*)a.v, kv, a.q_off,
          a.q_len, a.kv_len, (float*)a.out, a.sq, a.nq, a.nkv, a.hd, a.hdv,
          n_hs, a.scale);
  return cudaGetLastError();
}

// f32 value columns per thread: the smallest instantiation that covers
// hdv.  Up to 256 a thread holds 4 rows (64-row tiles); above, 1 row
// (16-row tiles), which keeps the accumulator at 64 registers.
template <class KV>
cudaError_t dispatch_fma(const FlashArgs& a, KV kv, cudaStream_t s) {
  const int need = (a.hdv + KG - 1) / KG;
#define RT_FA(R, D) \
  if (need <= D) return launch_fma<KV, R, D>(a, kv, s);
  RT_FA(4, 1) RT_FA(4, 2) RT_FA(4, 4) RT_FA(4, 8) RT_FA(4, 16) RT_FA(4, 32)
  RT_FA(1, 64)
#undef RT_FA
  return cudaErrorInvalidValue;
}

template <class KV>
cudaError_t flash_run(int dtype, const FlashArgs& a, KV kv, cudaStream_t s) {
  if (a.B == 0 || a.sq == 0) return cudaSuccess;
  if (a.nkv <= 0 || a.nq % a.nkv || a.hd <= 0 || a.hd > HD_MAX ||
      a.hdv <= 0 || a.hdv > HDV_MAX || a.nkv > 65535)
    return cudaErrorInvalidValue;
  if (dtype == RT_F32)
    return a.n_split == 1 ? dispatch_fma(a, kv, s) : cudaErrorInvalidValue;
  if (dtype != RT_BF16) return cudaErrorInvalidValue;
  const bool aligned = a.hd % 8 == 0 && a.hdv % 8 == 0 &&
                       (((uintptr_t)a.q | (uintptr_t)a.k | (uintptr_t)a.v |
                         (uintptr_t)a.out) & 15) == 0;
  if (!aligned || a.n_split < 1 || a.n_split > MAX_SPLIT ||
      (a.n_split > 1 && (a.part_o == nullptr || a.part_ml == nullptr)) ||
      (long long)a.B * a.n_split > 65535)
    return cudaErrorInvalidValue;
  if (a.rows == 128 && a.hd <= 256) return launch_mma<KV, 8, 64>(a, kv, s);
  if (a.rows == 64 && a.hd <= 256) return launch_mma<KV, 4, 64>(a, kv, s);
  if (a.rows == 64) return launch_mma<KV, 4, 32>(a, kv, s);
  return cudaErrorInvalidValue;
}

}  // namespace
