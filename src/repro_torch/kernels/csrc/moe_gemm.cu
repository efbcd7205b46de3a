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
// the ~295 flop/byte at which the bf16 tensor cores become the limit.
// The TPU kernel walks H as its last, sequential grid axis with a VMEM
// accumulator.  Here one CTA owns all the rows of one expert (up to 64;
// 64-row tiles past that) and one column tile of the output, loops over H
// inside the block with a float32 register accumulator, and writes its tile
// once, so each weight tile is read from device memory by exactly one CTA.
// The row tile is 16, 32, 48 or 64 rows, picked from C: C = 40 computes 8
// dead rows, not 24; C = 16 none.
//
// bf16: tensor cores through mma.sync m16n8k16 (bf16 in, f32 accumulate).
// Each H slab of x and w is loaded into registers while the previous slab
// is multiplied out of double-buffered shared memory, so the weight stream
// keeps loads in flight.  float32: FMA on CUDA cores (the parity path; no
// TF32).  Rows past C, columns past D and the H tail are masked, never
// padded in memory: the output is exactly (E, C, D), and an all-zero row
// of x gives an exact-zero row of out.  TMA and wgmma are later work.
#include "common.cuh"

namespace {

constexpr int BK = 32;          // H per shared-memory stage (both paths)
constexpr int BN = 128;         // bf16: output columns per CTA
constexpr int THREADS = 128;    // bf16: 4 warps, 32 output columns each
constexpr int XS = BK + 8;      // padded bf16 row strides: the fragment
constexpr int WS = BN + 8;      // reads below hit 32 distinct banks
constexpr int FBN = 64;         // f32: output columns per CTA
constexpr int FTHREADS = 256;   // f32: 16 x 16 threads, MT x 4 outputs each

// grid (ceil(D / BN), ceil(C / 16MT), E); MT 16-row m-tiles per CTA
template <int MT, bool VEC>
__global__ void __launch_bounds__(THREADS) moe_gemm_kernel_mma(
    const uint16_t* __restrict__ x, const uint16_t* __restrict__ w,
    __nv_bfloat16* __restrict__ out, int C, int H, int D) {
  constexpr int BM = 16 * MT;
  constexpr int XCH = BM * BK / 8;                 // 16-byte chunks / stage
  constexpr int WCH = BK * BN / 8;
  constexpr int XPT = (XCH + THREADS - 1) / THREADS;
  constexpr int WPT = WCH / THREADS;
  __shared__ __align__(16) uint16_t Xs[2][BM][XS];
  __shared__ __align__(16) uint16_t Ws[2][BK][WS];

  const int e = blockIdx.z, row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;          // mma fragment coords
  const uint16_t* xe = x + (long long)e * C * H;
  const uint16_t* we = w + (long long)e * H * D;

  uint4 xr[XPT], wr[WPT];
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < XPT; ++i) {
      const int li = tid + i * THREADS;
      if (li < XCH) {
        const int r = row0 + li / (BK / 8), c = (li % (BK / 8)) * 8;
        xr[i] = load8<VEC>(xe + (long long)r * H, r < C, k0 + c, H);
      }
    }
#pragma unroll
    for (int i = 0; i < WPT; ++i) {
      const int li = tid + i * THREADS;
      const int k = k0 + li / (BN / 8), c = (li % (BN / 8)) * 8;
      wr[i] = load8<VEC>(we + (long long)k * D, k < H, col0 + c, D);
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int i = 0; i < XPT; ++i) {
      const int li = tid + i * THREADS;
      if (li < XCH)
        *reinterpret_cast<uint4*>(
            &Xs[buf][li / (BK / 8)][(li % (BK / 8)) * 8]) = xr[i];
    }
#pragma unroll
    for (int i = 0; i < WPT; ++i) {
      const int li = tid + i * THREADS;
      *reinterpret_cast<uint4*>(
          &Ws[buf][li / (BN / 8)][(li % (BN / 8)) * 8]) = wr[i];
    }
  };

  float acc[MT][4][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][n][i] = 0.f;

  const int nk = (H + BK - 1) / BK;
  if (nk > 0) {
    load(0);
    store(0);
  }
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < nk) load((kt + 1) * BK);   // in flight during the mmas
#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      const int k = ks + 2 * t4;
      uint32_t a[MT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const int r = m * 16 + g;
        a[m][0] = *reinterpret_cast<const uint32_t*>(&Xs[buf][r][k]);
        a[m][1] = *reinterpret_cast<const uint32_t*>(&Xs[buf][r + 8][k]);
        a[m][2] = *reinterpret_cast<const uint32_t*>(&Xs[buf][r][k + 8]);
        a[m][3] = *reinterpret_cast<const uint32_t*>(&Xs[buf][r + 8][k + 8]);
      }
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int c = warp * 32 + n * 8 + g;
        const uint32_t b0 = (uint32_t)Ws[buf][k][c]
                            | ((uint32_t)Ws[buf][k + 1][c] << 16);
        const uint32_t b1 = (uint32_t)Ws[buf][k + 8][c]
                            | ((uint32_t)Ws[buf][k + 9][c] << 16);
#pragma unroll
        for (int m = 0; m < MT; ++m) mma_bf16(acc[m][n], a[m], b0, b1);
      }
    }
    if (kt + 1 < nk) store(buf ^ 1);
    __syncthreads();
  }

  __nv_bfloat16* oe = out + (long long)e * C * D;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int c = col0 + warp * 32 + n * 8 + 2 * t4;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = row0 + m * 16 + g + 8 * half;
        if (r >= C) continue;
        __nv_bfloat16* o = oe + (long long)r * D;
        if (c < D) o[c] = __float2bfloat16(acc[m][n][2 * half]);
        if (c + 1 < D) o[c + 1] = __float2bfloat16(acc[m][n][2 * half + 1]);
      }
    }
  }
}

// grid (ceil(D / FBN), ceil(C / 16MT), E)
template <int MT>
__global__ void __launch_bounds__(FTHREADS) moe_gemm_kernel_fma(
    const float* __restrict__ x, const float* __restrict__ w,
    float* __restrict__ out, int C, int H, int D) {
  constexpr int BM = 16 * MT;
  __shared__ float Xs[BK][BM];
  __shared__ float Ws[BK][FBN];
  const int e = blockIdx.z, row0 = blockIdx.y * BM, col0 = blockIdx.x * FBN;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const float* xe = x + (long long)e * C * H;
  const float* we = w + (long long)e * H * D;

  float acc[MT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < H; k0 += BK) {
    for (int li = tid; li < BM * BK; li += FTHREADS) {
      const int r = li / BK, kk = li % BK, gr = row0 + r, gk = k0 + kk;
      Xs[kk][r] = (gr < C && gk < H) ? xe[(long long)gr * H + gk] : 0.f;
    }
    for (int li = tid; li < BK * FBN; li += FTHREADS) {
      const int kk = li / FBN, c = li % FBN, gk = k0 + kk, gc = col0 + c;
      Ws[kk][c] = (gk < H && gc < D) ? we[(long long)gk * D + gc] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
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

template <int MT>
cudaError_t launch(const void* x, const void* w, void* out, int E, int C,
                   int H, int D, int dtype, cudaStream_t s) {
  const int row_tiles = (C + 16 * MT - 1) / (16 * MT);
  if (row_tiles > 65535) return cudaErrorInvalidValue;
  if (dtype == RT_F32) {
    dim3 grid((D + FBN - 1) / FBN, row_tiles, E);
    moe_gemm_kernel_fma<MT><<<grid, FTHREADS, 0, s>>>(
        (const float*)x, (const float*)w, (float*)out, C, H, D);
    return cudaGetLastError();
  }
  if (dtype != RT_BF16) return cudaErrorInvalidValue;
  const bool vec = H % 8 == 0 && D % 8 == 0
                   && ((uintptr_t)x & 15) == 0 && ((uintptr_t)w & 15) == 0;
  dim3 grid((D + BN - 1) / BN, row_tiles, E);
  const uint16_t *xp = (const uint16_t*)x, *wp = (const uint16_t*)w;
  __nv_bfloat16* op = (__nv_bfloat16*)out;
  if (vec)
    moe_gemm_kernel_mma<MT, true><<<grid, THREADS, 0, s>>>(xp, wp, op, C, H, D);
  else
    moe_gemm_kernel_mma<MT, false><<<grid, THREADS, 0, s>>>(xp, wp, op, C, H,
                                                            D);
  return cudaGetLastError();
}

}  // namespace

extern "C" int rt_moe_gemm(const void* x, const void* w, void* out, int E,
                           int C, int H, int D, int dtype, void* stream) {
  if (E < 0 || C < 0 || H < 0 || D < 0 || E > 65535)
    return cudaErrorInvalidValue;
  if (E == 0 || C == 0 || D == 0) return cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  // the row tile from C: all C rows in one CTA up to 64, 64-row tiles past
  switch (C <= 16 ? 1 : C <= 32 ? 2 : C <= 48 ? 3 : 4) {
    case 1: return launch<1>(x, w, out, E, C, H, D, dtype, s);
    case 2: return launch<2>(x, w, out, E, C, H, D, dtype, s);
    case 3: return launch<3>(x, w, out, E, C, H, D, dtype, s);
    default: return launch<4>(x, w, out, E, C, H, D, dtype, s);
  }
}
