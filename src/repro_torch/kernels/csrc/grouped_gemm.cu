// Dropless segment GEMM: out[i] = x[i] @ w[e] for the expert e whose row
// segment [offsets[e], offsets[e+1]) holds row i; rows >= offsets[-1] are
// exact zeros.
//
// Replaces: src/repro/kernels/moe_gemm.py :: grouped_gemm (Pallas body
// _grouped_gemm_kernel with the _group_metadata visit schedule).
//
// What bounds it on an H100: at decode and short-chunk sizes, bytes — every
// touched expert's (H, D) weight slab is streamed once per row tile while
// only T * k rows use it; long prefill chunks move it towards the flop side.
// The TPU kernel walks a sequential list of (row tile, expert) visits and
// overwrites its output block on the first visit, because a TPU grid runs in
// order.  Here CTAs run in parallel in no order, so each CTA owns one
// (row tile, D tile) of the output outright: it loops over every expert
// segment that overlaps its rows, masks the rows outside the segment to zero
// while staging x, accumulates all segments into one float32 register tile
// (rows of different experts are disjoint, so nothing mixes) and writes the
// tile once.  Empty experts are skipped; a tile past offsets[-1] writes
// zeros without loading anything.  Products are FMA on CUDA cores through
// shared-memory tiles; tensor cores (wgmma with TMA-fed, double-buffered
// tiles) are later work.
#include "common.cuh"

namespace {

constexpr int BM = 64;         // rows per CTA
constexpr int BN = 64;         // output columns per CTA
constexpr int BK = 32;         // H per shared-memory stage
constexpr int THREADS = 256;   // 16 x 16 threads, 4 x 4 outputs each

template <typename T>
__global__ void __launch_bounds__(THREADS) grouped_gemm_kernel(
    const T* __restrict__ x, const T* __restrict__ w,
    const int* __restrict__ offsets, T* __restrict__ out, int N, int H, int D,
    int E) {
  __shared__ float Xs[BK][BM];
  __shared__ float Ws[BK][BN];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int total = min(offsets[E], N);   // never read past x
  const int hi_row = min(row0 + BM, total);

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int e = 0; e < E && row0 < hi_row; ++e) {
    const int lo = max(offsets[e], row0), hi = min(offsets[e + 1], hi_row);
    if (lo >= hi) continue;
    const T* we = w + (long long)e * H * D;
    for (int k0 = 0; k0 < H; k0 += BK) {
      for (int li = tid; li < BM * BK; li += THREADS) {
        const int r = li / BK, kk = li % BK, gr = row0 + r, gk = k0 + kk;
        Xs[kk][r] = (gr >= lo && gr < hi && gk < H)
                        ? to_f(x[(long long)gr * H + gk]) : 0.f;
      }
      for (int li = tid; li < BK * BN; li += THREADS) {
        const int kk = li / BN, c = li % BN, gk = k0 + kk, gc = col0 + c;
        Ws[kk][c] = (gk < H && gc < D) ? to_f(we[(long long)gk * D + gc]) : 0.f;
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
    const int gr = row0 + ty + 16 * i;
    if (gr >= N) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gc = col0 + tx + 16 * j;
      if (gc < D) out[(long long)gr * D + gc] = from_f<T>(acc[i][j]);
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const int* offsets, void* out,
                   int N, int H, int D, int E, cudaStream_t s) {
  dim3 grid((D + BN - 1) / BN, (N + BM - 1) / BM);
  grouped_gemm_kernel<T><<<grid, THREADS, 0, s>>>((const T*)x, (const T*)w,
                                                 offsets, (T*)out, N, H, D, E);
  return cudaGetLastError();
}

}  // namespace

extern "C" int rt_grouped_gemm(const void* x, const void* w, const void* offsets,
                               void* out, int N, int H, int D, int E, int dtype,
                               void* stream) {
  if (N == 0 || D == 0) return cudaSuccess;
  if (E < 1) return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int* off = (const int*)offsets;
  if (dtype == RT_F32) return launch<float>(x, w, off, out, N, H, D, E, s);
  if (dtype == RT_BF16) return launch<__nv_bfloat16>(x, w, off, out, N, H, D, E, s);
  return cudaErrorInvalidValue;
}
