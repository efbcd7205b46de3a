// Capacity-mode batched expert GEMM: out[e] = x[e] @ w[e] for every expert
// e; x (E, C, H), w (E, H, D) -> out (E, C, D) in x's dtype, float32
// accumulation.
//
// Replaces: src/repro/kernels/moe_gemm.py :: moe_gemm (Pallas body
// _moe_gemm_kernel).
//
// What bounds it on an H100: bytes.  Every expert's (H, D) weight slab is
// read whole on every call, however few of its C capacity rows are live;
// at the serve shapes (C = 1-40) the weights are ~99% of the bytes moved
// and the product does 2C flops per weight element (4C/2 bytes), far under
// the ~295 flop/byte at which the bf16 tensor cores become the limit.  So
// the kernel's time is how steadily every SM keeps weight bytes in flight,
// from the first byte to the last.
//
// bf16 schedule (ops.moe_gemm_plan, ops.moe_gemm_split).  A tile is one
// expert's BM rows (all C rows up to 64; 64-row tiles past that) by BN
// output columns (256 at C <= 16, else 128; Geo below); a unit is one BK
// = 64-deep slice of H of one tile (16-32 KB of weights).  One CTA per
// SM.  The tiles go whole in rounds, CTA c taking each round's c-th tile,
// so the SMs read the same H rows of neighbouring column tiles at the
// same time (faster on the H100 than each SM streaming its own contiguous
// range).  One round plus what is left over the last whole round is cut
// stream-K: those tiles' units, H fastest, are laid end to end and split
// into one contiguous range per CTA, the ranges differing by at most one
// unit (and so each at least a tile long).  So every SM streams the same
// weight bytes to within one unit, whatever E, C and D are: no SM idles
// through a tail while others stream.
//
// Load engine: TMA.  3-D tensor maps over x (H, C, E) and w (D, H, E) cut
// each unit into one 64 x BM box of x and four 64 x 64 boxes of w, swizzled
// 128B in shared memory; thread 0 issues the five (five instructions a
// unit) into a 4-stage ring whose mbarriers count their bytes, and the TMA
// unit zero-fills the rows past C, the columns past D and the H tail.  No
// load waits for a consumer's registers, and 3 units (96 KB of weights) are
// in flight on each SM from the first unit to the last, across tile
// boundaries too.  (On the H100 a ring of per-thread 16-byte cp.async
// copies, 4-12 stages deep, stayed behind torch.bmm, its time following
// the loop's instruction count, not its depth; one cp.async.bulk per
// weight row was several times slower, 32 copies a unit issued by one
// thread.)  ldmatrix (.trans for the [k][n] weight slice), its
// addresses XOR-swizzled as the TMA wrote them and so conflict-free, feeds
// mma.sync m16n8k16 (bf16 in, f32 accumulate); at C <= 64 the tensor cores
// idle either way.
//
// A tile's last unit writes it.  A stream-K tile split between CTA c and
// c + 1 is not summed from parts: CTA c does the head of the tile its
// range ends in first and hands its f32 running sums to CTA c + 1 (a
// scratch slot and a release flag), which carries on from them in the
// tail at the very end of its own range, a share later.  So every output
// is accumulated in one pass in H order, k16 step after k16 step, the
// same bits as an unsplit tile and from run to run, with no float atomics
// and, at shares of a tile or more, no wait but the SMs' jitter.  Each
// weight element is read from device memory exactly once per call (C <=
// 64).  Rows past C, columns past D and the H tail are masked, never
// padded in memory; an all-zero row of x gives an exact-zero row of out.
// H or D off a multiple of 8, H = 0 or unaligned bases fill the same
// swizzled ring through registers with element-wise loads.
//
// float32: FMA on CUDA cores (the parity path; no TF32), one CTA per
// (column tile, row tile, expert).
#include <cuda.h>

#include "common.cuh"

namespace {

constexpr int BK = 64;          // H per unit (ring stage)
constexpr int STAGES = 4;       // ring depth
constexpr int BOX = 64;         // weight columns per TMA box (128 bytes)
constexpr int BOX_BYTES = BK * BOX * 2;

// bf16 tile width by the row tile: 256 columns (8 warps of 32) for one
// m-tile, 128 (4 warps) for more, where a split tile's carried sums (rows
// x columns of f32) would otherwise double the carry traffic and the
// stream-K share (on the H100, 128 was the faster at C 40 and 256 at C
// 1-16)
template <int MT>
struct Geo {
  static constexpr int BN = MT == 1 ? 256 : 128;   // output columns a tile
  static constexpr int THREADS = BN;               // 32 columns a warp
  static constexpr int W_BYTES = BK * BN * 2;      // one unit's weights
};
constexpr int FBK = 32;         // f32: H per shared-memory stage
constexpr int FBN = 64;         // f32: output columns per CTA
constexpr int FTHREADS = 256;   // f32: 16 x 16 threads, MT x 4 outputs each

// dynamic shared memory: the weight ring, then the x ring (each stage
// 1024-byte aligned for the 128B swizzle, hence the slack)
template <int MT>
constexpr int smem_bytes() {
  return STAGES * (Geo<MT>::W_BYTES + 16 * MT * 128) + 1024;
}

// The TMA's 128B swizzle: in a box of 128-byte rows, the 16-byte chunk j of
// row r sits at chunk j ^ (r % 8), so the 8 rows an ldmatrix reads at one
// column hit 8 distinct bank groups.  Byte offset of the 8 elements
// (r, c..c+7), c % 8 == 0, of a box of 64 columns:
__device__ __forceinline__ int swz(int r, int c) {
  return r * 128 + (((c >> 3) ^ (r & 7)) << 4);
}
// ... and of the 8 weights (k, c..c+7) of a unit's slice (box c / 64)
__device__ __forceinline__ int w_off(int k, int c) {
  return (c >> 6) * BOX_BYTES + swz(k, c & 63);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count));
}
// one arrival that also expects `bytes` of copies to complete on bar
__device__ __forceinline__ void mbar_expect(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile("{\n .reg .pred p;\n"
                 " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 " selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(smem_addr(bar)), "r"(parity)
                 : "memory");
}
// the box at (column c0, row c1, expert c2) of map -> dst, completing on bar
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int c0, int c1, int c2,
                                         uint64_t* bar) {
  asm volatile("cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier"
               "::complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n"
               :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
                  "r"(c0), "r"(c1), "r"(c2), "r"(smem_addr(bar))
               : "memory");
}

// The schedule: tiles (expert, row tile, column tile) with the column
// tile fastest, nk units each; the first tsk tiles are stream-K (CTA c
// owns their units [begin(c), begin(c + 1)), q each and one more for the
// first r CTAs), then every CTA takes `rounds` whole tiles, G apart.
struct Work {
  int C, H, D, n_rt, n_ct, nk, tsk, rounds, r;
  long long q;
  __device__ long long begin(int c) const {
    return c * q + min(c, r);
  }
};

// A split tile's running sums pass from CTA c - 1 to CTA c through
// carry[c - 1] and flag[c - 1]: a release by the writer, an acquire by the
// reader, who sets the flag back to 0 for the next call.  The spin is
// bounded: past ~10 s it traps, a launch error rather than a hang.
__device__ __forceinline__ void flag_release(int* f) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;\n"
               :: "l"(f), "r"(1) : "memory");
}
__device__ __forceinline__ void flag_acquire(int* f) {
  for (long long spin = 0;; ++spin) {
    int v;
    asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n"
                 : "=r"(v) : "l"(f) : "memory");
    if (v != 0) break;
    if (spin > (1ll << 27)) __trap();
    __nanosleep(64);
  }
  *f = 0;
}

// VEC: x and w by TMA through xmap and wmap; else element-wise loads
template <int MT, bool VEC>
__global__ void __launch_bounds__(Geo<MT>::THREADS, 1) moe_gemm_kernel_mma(
    const uint16_t* __restrict__ x, const uint16_t* __restrict__ w,
    __nv_bfloat16* __restrict__ out, float* __restrict__ carry,
    int* __restrict__ flag, const __grid_constant__ CUtensorMap xmap,
    const __grid_constant__ CUtensorMap wmap, Work wk) {
  constexpr int BM = 16 * MT, BN = Geo<MT>::BN, THREADS = Geo<MT>::THREADS;
  constexpr int W_BYTES = Geo<MT>::W_BYTES;
  constexpr int X_BYTES = BM * 128;           // one unit's x slice
  constexpr int SUMS = MT * 16 * THREADS;     // f32 sums of one tile
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* Wr = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* Xr = Wr + STAGES * W_BYTES;
  __shared__ __align__(8) uint64_t full[STAGES];   // a unit's slices landed

  const int cta = blockIdx.x, G = gridDim.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;     // mma fragment coords
  const long long u0 = wk.begin(cta);
  const int n_sk = (int)(wk.begin(cta + 1) - u0);
  const int n = n_sk + wk.rounds * wk.nk;
  const int per_e = wk.n_rt * wk.n_ct;

  // The stream-K range [u0, u1) is walked in three segments: the head of
  // the tile it ends in [hb, u1), its whole tiles [p0, hb), the tail of
  // the tile it starts in [u0, p0).  The head's sums go out to CTA c + 1
  // first thing, and the tail, which continues CTA c - 1's head, comes
  // last: with shares of at least one tile, that head was done a share
  // earlier, so the carry is waiting.  Then the whole tiles, G apart.  A
  // cursor moves one unit at a time: no division but at a segment change.
  const long long u1 = u0 + n_sk, nk = wk.nk;
  const long long hb = u1 > u0 ? max(u0, (u1 - 1) / nk * nk) : u0;
  const long long p0 = min((u0 + nk - 1) / nk * nk, hb);
  struct Cursor {
    int i, tile, kt;
    long long u, end;       // the unit, and its segment's end
  };
  auto place = [&](Cursor& c, long long u, long long end) {
    c.u = u;
    c.end = end;
    c.tile = (int)(u / nk);
    c.kt = (int)(u - c.tile * nk);
  };
  auto enter = [&](Cursor& c) {        // the first unit at or after c.i
    if (c.i >= n_sk) {
      c.tile = wk.tsk + cta + (c.i - n_sk) / wk.nk * G;
      c.kt = (c.i - n_sk) % wk.nk;
    } else if (c.i < u1 - hb) {
      place(c, hb + c.i, u1);
    } else if (c.i < u1 - p0) {
      place(c, p0 + (c.i - (u1 - hb)), hb);
    } else {
      place(c, u0 + (c.i - (u1 - p0)), p0);
    }
  };
  auto start = [&]() {
    Cursor c{0, 0, 0, 0, 0};
    enter(c);
    return c;
  };
  auto advance = [&](Cursor& c) {
    ++c.i;
    if (c.i <= n_sk && ++c.u == c.end) {
      enter(c);                        // next segment, or the whole tiles
    } else if (++c.kt == wk.nk) {
      c.kt = 0;
      c.tile += c.i < n_sk ? 1 : G;
    }
  };

  // the loader's tile: its expert, first row and first column
  int ld_tile = -1, ld_e = 0, ld_row0 = 0, ld_col0 = 0;
  auto load = [&](int stage, const Cursor& c) {
    if (c.tile != ld_tile) {
      ld_tile = c.tile;
      ld_e = c.tile / per_e;
      const int rem = c.tile - ld_e * per_e;
      ld_row0 = (rem / wk.n_ct) * BM;
      ld_col0 = (rem % wk.n_ct) * BN;
    }
    const int k0 = c.kt * BK;
    uint8_t* xs = Xr + stage * X_BYTES;
    uint8_t* ws = Wr + stage * W_BYTES;
    if (VEC) {            // thread 0: five TMA boxes, one barrier
      if (tid == 0) {
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_expect(&full[stage], W_BYTES + X_BYTES);
        tma_load(xs, &xmap, k0, ld_row0, ld_e, &full[stage]);
#pragma unroll
        for (int b = 0; b < BN / BOX; ++b)
          tma_load(ws + b * BOX_BYTES, &wmap, ld_col0 + b * BOX, k0, ld_e,
                   &full[stage]);
      }
    } else {
      const uint16_t* xe = x + ((long long)ld_e * wk.C + ld_row0) * wk.H;
      for (int li = tid; li < BM * (BK / 8); li += THREADS) {
        const int r = li / (BK / 8), cc = (li % (BK / 8)) * 8;
        *reinterpret_cast<uint4*>(xs + swz(r, cc)) = load8<false>(
            xe + (long long)r * wk.H, ld_row0 + r < wk.C, k0 + cc, wk.H);
      }
      const uint16_t* we = w + (long long)ld_e * wk.H * wk.D;
#pragma unroll
      for (int j = 0; j < BK * (BN / 8) / THREADS; ++j) {
        const int li = tid + j * THREADS;
        const int k = li / (BN / 8), cc = (li % (BN / 8)) * 8;
        *reinterpret_cast<uint4*>(ws + w_off(k, cc)) = load8<false>(
            we + (long long)(k0 + k) * wk.D, k0 + k < wk.H, ld_col0 + cc,
            wk.D);
      }
    }
  };

  float acc[MT][4][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][j][i] = 0.f;

  // the tile's rows [row0, C) x columns [col0, D) of expert e, from acc
  auto store_tile = [&](int tile) {
    const int e = tile / per_e, rem = tile - e * per_e;
    const int row0 = (rem / wk.n_ct) * BM, col0 = (rem % wk.n_ct) * BN;
    __nv_bfloat16* oe = out + (long long)e * wk.C * wk.D;
#pragma unroll
    for (int m = 0; m < MT; ++m) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = col0 + warp * 32 + j * 8 + 2 * t4;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = row0 + m * 16 + g + 8 * half;
          if (r >= wk.C) continue;
          __nv_bfloat16* o = oe + (long long)r * wk.D;
          const float v0 = acc[m][j][2 * half], v1 = acc[m][j][2 * half + 1];
          if (VEC) {        // D % 8 == 0: c < D implies c + 1 < D
            if (c < wk.D)
              *reinterpret_cast<__nv_bfloat162*>(o + c) =
                  __floats2bfloat162_rn(v0, v1);
          } else {
            if (c < wk.D) o[c] = __float2bfloat16(v0);
            if (c + 1 < wk.D) o[c + 1] = __float2bfloat16(v1);
          }
        }
      }
    }
  };

  // the running sums to or from a carry slot, in fragment order
  auto carry_out = [&]() {
    float* dst = carry + (long long)cta * SUMS;
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          dst[((m * 4 + j) * 4 + i) * THREADS + tid] = acc[m][j][i];
    __threadfence();
    __syncthreads();
    if (tid == 0) flag_release(flag + cta);
  };
  auto carry_in = [&]() {
    if (tid == 0) flag_acquire(flag + cta - 1);
    __syncthreads();
    const float* src = carry + (long long)(cta - 1) * SUMS;
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          acc[m][j][i] = __ldcg(src + ((m * 4 + j) * 4 + i) * THREADS + tid);
  };

  if (VEC && tid == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  Cursor ld = start(), cs = ld;
#pragma unroll 1
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n) {
      load(s, ld);
      advance(ld);
    }
  }
#pragma unroll 1
  for (int it = 0; it < n; ++it) {
    const int stage = it % STAGES;
    if (VEC) mbar_wait(&full[stage], (it / STAGES) & 1);   // unit `it`
    __syncthreads();               // landed for all; slot it-1 is free
    if (ld.i < n) {
      load((it + STAGES - 1) % STAGES, ld);
      advance(ld);
    }
    // the range's first unit continues CTA c - 1's sums
    if (it < n_sk && cs.u == u0 && cs.kt != 0) carry_in();
    const uint8_t* xs = Xr + stage * X_BYTES;
    const uint8_t* ws = Wr + stage * W_BYTES;
#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      uint32_t b[4][2];
#pragma unroll
      for (int np = 0; np < 2; ++np) {   // n-subtiles (2np, 2np + 1)
        uint32_t r[4];
        const int k = ks + (lane & 7) + ((lane >> 3) & 1) * 8;
        const int c = warp * 32 + np * 16 + (lane >> 4) * 8;
        ldsm_x4_trans(r, ws + w_off(k, c));
        b[2 * np][0] = r[0];
        b[2 * np][1] = r[1];
        b[2 * np + 1][0] = r[2];
        b[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        uint32_t a[4];
        ldsm_x4(a, xs + swz(m * 16 + (lane & 15), ks + (lane >> 4) * 8));
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(acc[m][j], a, b[j][0], b[j][1]);
      }
    }
    // a tile's last unit writes it; the range's last unit, mid-tile,
    // hands its sums to CTA c + 1
    const bool carries = it < n_sk && cs.u == u1 - 1 && cs.kt != wk.nk - 1;
    if (cs.kt == wk.nk - 1 || carries) {
      if (carries)
        carry_out();
      else
        store_tile(cs.tile);
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[m][j][i] = 0.f;
    }
    advance(cs);
  }
}

// grid (ceil(D / FBN), ceil(C / 16MT), E)
template <int MT>
__global__ void __launch_bounds__(FTHREADS) moe_gemm_kernel_fma(
    const float* __restrict__ x, const float* __restrict__ w,
    float* __restrict__ out, int C, int H, int D) {
  constexpr int BM = 16 * MT;
  __shared__ float Xs[FBK][BM];
  __shared__ float Ws[FBK][FBN];
  const int e = blockIdx.z, row0 = blockIdx.y * BM, col0 = blockIdx.x * FBN;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const float* xe = x + (long long)e * C * H;
  const float* we = w + (long long)e * H * D;

  float acc[MT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < H; k0 += FBK) {
    for (int li = tid; li < BM * FBK; li += FTHREADS) {
      const int r = li / FBK, kk = li % FBK, gr = row0 + r, gk = k0 + kk;
      Xs[kk][r] = (gr < C && gk < H) ? xe[(long long)gr * H + gk] : 0.f;
    }
    for (int li = tid; li < FBK * FBN; li += FTHREADS) {
      const int kk = li / FBN, c = li % FBN, gk = k0 + kk, gc = col0 + c;
      Ws[kk][c] = (gk < H && gc < D) ? we[(long long)gk * D + gc] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < FBK; ++kk) {
      float a[MT], b[4];
#pragma unroll
      for (int i = 0; i < MT; ++i) a[i] = Xs[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Ws[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* oe = out + (long long)e * C * D;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= C) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + tx + 16 * j;
      if (c < D) oe[(long long)r * D + c] = acc[i][j];
    }
  }
}

template <int MT, bool VEC>
cudaError_t launch_mma(const void* x, const void* w, void* out, float* carry,
                       int* flag, const CUtensorMap& xmap,
                       const CUtensorMap& wmap, const Work& wk, int ctas,
                       cudaStream_t s) {
  static std::atomic<unsigned long long> done{0};
  cudaError_t err = allow_smem((const void*)moe_gemm_kernel_mma<MT, VEC>,
                               smem_bytes<MT>(), done);
  if (err != cudaSuccess) return err;
  moe_gemm_kernel_mma<MT, VEC><<<ctas, Geo<MT>::THREADS, smem_bytes<MT>(),
                                 s>>>(
      (const uint16_t*)x, (const uint16_t*)w, (__nv_bfloat16*)out, carry,
      flag, xmap, wmap, wk);
  return cudaGetLastError();
}

// cuTensorMapEncodeTiled, a libcuda entry point, looked up through the
// runtime so that nothing links against libcuda; null where it is missing
using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static std::atomic<EncodeTiled> fn{nullptr};
  EncodeTiled f = fn.load(std::memory_order_acquire);
  if (f != nullptr) return f;
  void* p = nullptr;
  cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
  const cudaError_t err = cudaGetDriverEntryPointByVersion(
      "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
  const cudaError_t err = cudaGetDriverEntryPoint(
      "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
  if (err != cudaSuccess || q != cudaDriverEntryPointSuccess) return nullptr;
  f = reinterpret_cast<EncodeTiled>(p);
  fn.store(f, std::memory_order_release);
  return f;
}

// a (E, rows, cols) bf16 array as a 3-D map (cols, rows, E) of box_cols x
// box_rows x 1 boxes, 128B swizzle, zeros out of bounds: x (E, C, H) in
// 64 x BM boxes, w (E, H, D) in BOX x BK boxes
cudaError_t tensor_map(CUtensorMap* map, const void* a, int E, int rows,
                       int cols, int box_cols, int box_rows) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows,
                              (cuuint64_t)E};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * 2,
                                 (cuuint64_t)rows * cols * 2};
  const cuuint32_t box[3] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                         const_cast<void*>(a), dims, strides, box, step,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int MT>
cudaError_t launch(const void* x, const void* w, void* out, float* carry,
                   int* flag, int E, int C, int H, int D, int ctas,
                   int dtype, cudaStream_t s) {
  if (dtype == RT_F32) {
    const int row_tiles = (C + 16 * MT - 1) / (16 * MT);
    if (row_tiles > 65535) return cudaErrorInvalidValue;
    dim3 grid((D + FBN - 1) / FBN, row_tiles, E);
    moe_gemm_kernel_fma<MT><<<grid, FTHREADS, 0, s>>>(
        (const float*)x, (const float*)w, (float*)out, C, H, D);
    return cudaGetLastError();
  }
  if (dtype != RT_BF16) return cudaErrorInvalidValue;
  Work wk;
  wk.C = C;
  wk.H = H;
  wk.D = D;
  wk.n_rt = (C + 16 * MT - 1) / (16 * MT);
  wk.n_ct = (D + Geo<MT>::BN - 1) / Geo<MT>::BN;
  wk.nk = H > 0 ? (H + BK - 1) / BK : 1;    // H = 0: one all-masked unit
  // whole tiles in full rounds of ctas, keeping one round plus the
  // remainder for stream-K, so every share is at least a tile
  // (ops.moe_gemm_split)
  const int tiles = E * wk.n_rt * wk.n_ct;
  const int whole = tiles % ctas == 0 ? tiles
                    : tiles / ctas >= 2 ? (tiles / ctas - 1) * ctas : 0;
  wk.tsk = tiles - whole;
  wk.rounds = whole / ctas;
  const long long sk_units = (long long)wk.tsk * wk.nk;
  wk.q = sk_units / ctas;
  wk.r = (int)(sk_units % ctas);
  const bool vec = H > 0 && H % 8 == 0 && D % 8 == 0
                   && ((uintptr_t)x & 15) == 0 && ((uintptr_t)w & 15) == 0
                   && ((uintptr_t)out & 3) == 0;
  CUtensorMap xmap{}, wmap{};
  if (!vec)
    return launch_mma<MT, false>(x, w, out, carry, flag, xmap, wmap, wk,
                                 ctas, s);
  cudaError_t err = tensor_map(&xmap, x, E, C, H, 64, 16 * MT);
  if (err == cudaSuccess) err = tensor_map(&wmap, w, E, H, D, BOX, BK);
  if (err != cudaSuccess) return err;
  return launch_mma<MT, true>(x, w, out, carry, flag, xmap, wmap, wk,
                              ctas, s);
}

}  // namespace

// ctas / units: ops.moe_gemm_plan's grid and unit count.  Refused
// (invalid configuration) when the units are not this tiling's (the plan
// would not cover the work) or the grid leaves a CTA without a unit.
// bf16 needs carry (ctas * 16MT * BN floats of scratch) and flag (ctas
// ints, all zero; the kernel leaves them zero).
extern "C" int rt_moe_gemm(const void* x, const void* w, void* out,
                           void* carry, void* flag, int E, int C, int H,
                           int D, int ctas, int units, int dtype,
                           void* stream) {
  if (E < 0 || C < 0 || H < 0 || D < 0 || E > 65535)
    return cudaErrorInvalidValue;
  if (E == 0 || C == 0 || D == 0) return cudaSuccess;
  // the row tile from C: all C rows in one tile up to 64, 64-row tiles past
  const int mt = C <= 16 ? 1 : C <= 32 ? 2 : C <= 48 ? 3 : 4;
  const int bn = mt == 1 ? Geo<1>::BN : Geo<2>::BN;
  const long long tiles = (long long)E * ((C + 16 * mt - 1) / (16 * mt))
                          * ((D + bn - 1) / bn);
  const long long want = tiles * (H > 0 ? (H + BK - 1) / BK : 1);
  if (want != units || ctas < 1 || ctas > units)
    return cudaErrorInvalidConfiguration;
  if (dtype == RT_BF16 && (carry == nullptr || flag == nullptr))
    return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  float* p = (float*)carry;
  int* a = (int*)flag;
  switch (mt) {
    case 1: return launch<1>(x, w, out, p, a, E, C, H, D, ctas, dtype, s);
    case 2: return launch<2>(x, w, out, p, a, E, C, H, D, ctas, dtype, s);
    case 3: return launch<3>(x, w, out, p, a, E, C, H, D, ctas, dtype, s);
    default: return launch<4>(x, w, out, p, a, E, C, H, D, ctas, dtype, s);
  }
}
