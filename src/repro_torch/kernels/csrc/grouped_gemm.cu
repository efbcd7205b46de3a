// Dropless segment GEMM: out[i] = x[i] @ w[e] for the expert e whose row
// segment [offsets[e], offsets[e+1]) holds row i; rows >= offsets[-1] are
// exact zeros.  offsets is an ascending prefix sum from 0, as the
// reference's.
//
// Replaces: src/repro/kernels/moe_gemm.py :: grouped_gemm (Pallas body
// _grouped_gemm_kernel with the _group_metadata visit schedule).
//
// What bounds it on an H100: bytes.  Each used expert's (H, D) weight slab
// is nearly all the bytes moved, and a serve step routes only ~10-60 rows to
// an expert, so the product does 2 * rows flops per 2-byte weight element:
// ~10-60 flop/byte, far under the ~295 flop/byte at which the bf16 tensor
// cores become the limit.  The design streams each weight slab once per
// column tile and computes only the rows that use it:
//   * the schedule is by segment, as the reference's _group_metadata: a
//     visit is one (expert e, BM-row tile of e's own segment), so a row is
//     computed only for its own expert.  CTA (blockIdx.x, blockIdx.y) owns
//     visit blockIdx.x and one column tile; warp 0 finds its visit from the
//     offsets with a warp-wide prefix sum of the per-expert tile counts
//     (E / 32 steps, no scratch).  A segment's last tile is partial; its
//     dead 16-row m-subtiles are skipped, so a 10-row segment computes 16
//     rows, not 64;
//   * the visits past the segments' tiles cover [offsets[-1], N) and write
//     exact zeros without reading x or w; visits past those exit at once.
//     The host passes the static bound ceil(N / BM) + min(E, N) on the
//     visit count (ops.grouped_gemm_visits, the reference's n_visits).
//     Every output element is written by exactly one CTA: no atomics;
//   * visits run fastest in the grid, so the row tiles of one long
//     (prefill) segment at one column tile run side by side and share the
//     weight slab through L2;
//   * bf16: tensor cores through mma.sync m16n8k16 (bf16 in, f32
//     accumulate), fragments by ldmatrix (.trans for the [k][n] weight
//     tile).  x and w tiles stream through a 4-stage cp.async ring of
//     16-byte copies, so three weight tiles are in flight while one is
//     multiplied.  H or D off a multiple of 8 (or unaligned bases) stage
//     through registers with element-wise loads into the same ring;
//   * float32: FMA on CUDA cores (the parity path, no TF32) on the same
//     per-segment schedule.
#include "common.cuh"

namespace {

constexpr int BM = 64;          // rows per visit (4 m-subtiles of 16)
constexpr int BN = 128;         // bf16: output columns per CTA
constexpr int BK = 32;          // H per ring stage
constexpr int STAGES = 4;       // cp.async ring depth
constexpr int THREADS = 128;    // bf16: 4 warps, 32 output columns each
constexpr int XS = BK + 8;      // padded row strides: the 8 rows of each
constexpr int WS = BN + 8;      // ldmatrix hit distinct banks
constexpr int X_STAGE = BM * XS;
constexpr int W_STAGE = BK * WS;
constexpr int SMEM = 2 * STAGES * (X_STAGE + W_STAGE);   // bytes
constexpr int FBN = 64;         // f32: output columns per CTA
constexpr int FTHREADS = 256;   // f32: 16 x 16 threads, 4 x 4 outputs each

// One CTA's rows: [r0, r1) of expert e, or (e < 0) rows past offsets[E]
// that are written as zeros.  r0 >= r1: nothing to do.
struct Visit {
  int e, r0, r1;
};

// Visit v of the schedule: the segments' BM-row tiles in expert order, then
// the zero tiles of [offsets[E], N).  Warp 0 walks the experts 32 at a time
// with an inclusive scan of their tile counts; the block reads the result.
__device__ Visit find_visit(const int* __restrict__ off, int N, int E,
                            int v) {
  __shared__ int sv[3];
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int base = 0;
    bool found = false;
    for (int c = 0; c < E && !found; c += 32) {
      const int e = c + lane;
      int lo = 0, n = 0;
      if (e < E) {
        lo = min(max(off[e], 0), N);
        n = max(min(max(off[e + 1], 0), N) - lo, 0);
      }
      const int tiles = (n + BM - 1) / BM;
      int inc = tiles;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, inc, o);
        if (lane >= o) inc += y;
      }
      const int sum = __shfl_sync(0xffffffffu, inc, 31);
      if (v < base + sum) {          // uniform: the visit is in this chunk
        const unsigned hit = __ballot_sync(0xffffffffu, v < base + inc);
        if (lane == __ffs(hit) - 1) {
          const int t = v - (base + inc - tiles);
          sv[0] = e;
          sv[1] = lo + t * BM;
          sv[2] = min(lo + (t + 1) * BM, lo + n);
        }
        found = true;
      }
      base += sum;
    }
    if (!found && lane == 0) {
      const int r0 = min(max(off[E], 0), N) + (v - base) * BM;
      sv[0] = -1;
      sv[1] = r0;
      sv[2] = min(r0 + BM, N);
    }
  }
  __syncthreads();
  return Visit{sv[0], sv[1], sv[2]};
}

// grid (V_max, ceil(D / BN)); dynamic shared memory SMEM
template <bool VEC>
__global__ void __launch_bounds__(THREADS) grouped_gemm_kernel_mma(
    const uint16_t* __restrict__ x, const uint16_t* __restrict__ w,
    const int* __restrict__ off, __nv_bfloat16* __restrict__ out, int N,
    int H, int D, int E) {
  const Visit vis = find_visit(off, N, E, blockIdx.x);
  if (vis.r0 >= vis.r1) return;
  const int col0 = blockIdx.y * BN, rows = vis.r1 - vis.r0;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;          // mma fragment coords
  if (vis.e < 0) {
    for (int i = tid; i < rows * BN; i += THREADS) {
      const int r = i / BN, c = col0 + i % BN;
      if (c < D) out[(long long)(vis.r0 + r) * D + c] = __float2bfloat16(0.f);
    }
    return;
  }

  extern __shared__ __align__(16) uint16_t smem[];
  uint16_t* Xs = smem;                       // [STAGES][BM][XS]
  uint16_t* Ws = smem + STAGES * X_STAGE;    // [STAGES][BK][WS]
  const int mt = (rows + 15) >> 4;           // live 16-row m-subtiles
  const uint16_t* xv = x + (long long)vis.r0 * H;
  const uint16_t* we = w + (long long)vis.e * H * D;

  auto load = [&](int stage, int k0) {
    uint16_t* xs = Xs + stage * X_STAGE;
    uint16_t* ws = Ws + stage * W_STAGE;
    for (int li = tid; li < mt * 16 * (BK / 8); li += THREADS) {
      const int r = li / (BK / 8), c = (li % (BK / 8)) * 8;
      uint16_t* dst = xs + r * XS + c;
      const uint16_t* row = xv + (long long)r * H;
      if (VEC) {
        const bool ok = r < rows && k0 + c < H;
        cp_async16(dst, ok ? row + k0 + c : x, ok);
      } else {
        *reinterpret_cast<uint4*>(dst) = load8<false>(row, r < rows, k0 + c,
                                                      H);
      }
    }
#pragma unroll
    for (int i = 0; i < BK * (BN / 8) / THREADS; ++i) {
      const int li = tid + i * THREADS;
      const int k = li / (BN / 8), c = (li % (BN / 8)) * 8;
      uint16_t* dst = ws + k * WS + c;
      const uint16_t* row = we + (long long)(k0 + k) * D;
      if (VEC) {
        const bool ok = k0 + k < H && col0 + c < D;
        cp_async16(dst, ok ? row + col0 + c : w, ok);
      } else {
        *reinterpret_cast<uint4*>(dst) = load8<false>(row, k0 + k < H,
                                                      col0 + c, D);
      }
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][n][i] = 0.f;

  const int nk = (H + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load(s, s * BK);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();   // tile kt has landed (this thread's part)
    __syncthreads();               // ... everyone's; slot kt-1 is free
    const int nt = kt + STAGES - 1;
    if (nt < nk) load(nt % STAGES, nt * BK);
    cp_async_commit();
    const uint16_t* xs = Xs + (kt % STAGES) * X_STAGE;
    const uint16_t* ws = Ws + (kt % STAGES) * W_STAGE;
#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      uint32_t b[4][2];
#pragma unroll
      for (int np = 0; np < 2; ++np) {   // n-subtiles (2np, 2np + 1)
        uint32_t r[4];
        const int k = ks + (lane & 7) + ((lane >> 3) & 1) * 8;
        const int c = warp * 32 + np * 16 + (lane >> 4) * 8;
        ldsm_x4_trans(r, ws + k * WS + c);
        b[2 * np][0] = r[0];
        b[2 * np][1] = r[1];
        b[2 * np + 1][0] = r[2];
        b[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        if (m < mt) {
          uint32_t a[4];
          ldsm_x4(a, xs + (m * 16 + (lane & 15)) * XS + ks + (lane >> 4) * 8);
#pragma unroll
          for (int n = 0; n < 4; ++n) mma_bf16(acc[m][n], a, b[n][0], b[n][1]);
        }
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int m = 0; m < 4; ++m) {
    if (m >= mt) continue;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int c = col0 + warp * 32 + n * 8 + 2 * t4;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = m * 16 + g + 8 * half;
        if (r >= rows) continue;
        __nv_bfloat16* o = out + (long long)(vis.r0 + r) * D;
        const float v0 = acc[m][n][2 * half], v1 = acc[m][n][2 * half + 1];
        if (VEC) {          // D % 8 == 0: c < D implies c + 1 < D
          if (c < D)
            *reinterpret_cast<__nv_bfloat162*>(o + c) =
                __floats2bfloat162_rn(v0, v1);
        } else {
          if (c < D) o[c] = __float2bfloat16(v0);
          if (c + 1 < D) o[c + 1] = __float2bfloat16(v1);
        }
      }
    }
  }
}

// grid (V_max, ceil(D / FBN))
__global__ void __launch_bounds__(FTHREADS) grouped_gemm_kernel_fma(
    const float* __restrict__ x, const float* __restrict__ w,
    const int* __restrict__ off, float* __restrict__ out, int N, int H,
    int D, int E) {
  __shared__ float Xs[BK][BM];
  __shared__ float Ws[BK][FBN];
  const Visit vis = find_visit(off, N, E, blockIdx.x);
  if (vis.r0 >= vis.r1) return;
  const int col0 = blockIdx.y * FBN, rows = vis.r1 - vis.r0;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  if (vis.e >= 0) {
    const float* xv = x + (long long)vis.r0 * H;
    const float* we = w + (long long)vis.e * H * D;
    for (int k0 = 0; k0 < H; k0 += BK) {
      for (int li = tid; li < BM * BK; li += FTHREADS) {
        const int r = li / BK, kk = li % BK, gk = k0 + kk;
        Xs[kk][r] = (r < rows && gk < H) ? xv[(long long)r * H + gk] : 0.f;
      }
      for (int li = tid; li < BK * FBN; li += FTHREADS) {
        const int kk = li / FBN, c = li % FBN, gk = k0 + kk, gc = col0 + c;
        Ws[kk][c] = (gk < H && gc < D) ? we[(long long)gk * D + gc] : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < BK; ++kk) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = Xs[kk][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = Ws[kk][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + tx + 16 * j;
      if (c < D) out[(long long)(vis.r0 + r) * D + c] = acc[i][j];
    }
  }
}

template <bool VEC>
cudaError_t launch_mma(const void* x, const void* w, const int* off,
                       void* out, int N, int H, int D, int E, int V,
                       cudaStream_t s) {
  static std::atomic<unsigned long long> done{0};
  cudaError_t err = allow_smem((const void*)grouped_gemm_kernel_mma<VEC>,
                               SMEM, done);
  if (err != cudaSuccess) return err;
  dim3 grid(V, (D + BN - 1) / BN);
  grouped_gemm_kernel_mma<VEC><<<grid, THREADS, SMEM, s>>>(
      (const uint16_t*)x, (const uint16_t*)w, off, (__nv_bfloat16*)out, N, H,
      D, E);
  return cudaGetLastError();
}

}  // namespace

// V: the visit bound, at least ceil(N / BM) + min(E, N)
extern "C" int rt_grouped_gemm(const void* x, const void* w, const void* offsets,
                               void* out, int N, int H, int D, int E, int V,
                               int dtype, void* stream) {
  if (N < 0 || H < 0 || D < 0 || E < 1) return cudaErrorInvalidValue;
  if (N == 0 || D == 0) return cudaSuccess;
  if (V < (N + BM - 1) / BM + (E < N ? E : N) || (D + FBN - 1) / FBN > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int* off = (const int*)offsets;
  if (dtype == RT_F32) {
    dim3 grid(V, (D + FBN - 1) / FBN);
    grouped_gemm_kernel_fma<<<grid, FTHREADS, 0, s>>>(
        (const float*)x, (const float*)w, off, (float*)out, N, H, D, E);
    return cudaGetLastError();
  }
  if (dtype != RT_BF16) return cudaErrorInvalidValue;
  const bool vec = H % 8 == 0 && D % 8 == 0 && ((uintptr_t)x & 15) == 0
                   && ((uintptr_t)w & 15) == 0 && ((uintptr_t)out & 3) == 0;
  if (vec) return launch_mma<true>(x, w, off, out, N, H, D, E, V, s);
  return launch_mma<false>(x, w, off, out, N, H, D, E, V, s);
}
