// Fused MoE token permute (dispatch gather) and unpermute (weighted combine).
//
// Replaces: src/repro/kernels/permute.py :: permute_tokens,
// permute_tokens_ragged and unpermute_tokens.
//
//   permute_tokens    out[i] = x[src[i]]                (src < 0 -> 0 row)
//   permute_tokens_ragged
//                     the same gather on a buffer cut into segments of
//                     seg_stride rows, each populated only in a leading
//                     prefix of total[seg] rows (the EP exchange's send
//                     buffer, one segment per destination rank; a scalar
//                     total is one segment over the whole buffer).  A tile
//                     of rows that all lie at or past their segment's
//                     prefix writes zeros and reads neither src nor x;
//                     every other tile gathers, and validity still rides in
//                     src (-1 outside the prefixes)
//   unpermute_tokens  out[t] = sum_j buf[slot[t,j]] * w[t,j]
//                     f32 accumulation in slot order j = 0..k-1, written in
//                     buf's dtype; slot < 0 adds row 0 times 0, as the
//                     Pallas kernel does (0 for finite rows)
//
// What bounds them on an H100: bytes.  Both move whole rows and do at most
// 2 flops per element read, so the floor is each input row read once and
// each output row written once at HBM rate.  The design is one warp per
// output row, each lane moving 16 bytes per load with neighbouring lanes on
// neighbouring addresses, so a row is read in fully coalesced 512-byte
// sweeps; the index (and weight) of the row is read once per lane from L1.
// permute copies raw bits (it never converts), so one kernel serves both
// float types.  Rows whose byte width is not a multiple of 16, or whose
// pointers are not 16-byte aligned, take the element-wise instantiation.
// The ragged gather gives each block a tile of 32 rows (4 per warp), so the
// buffers sized for the worst-case skew, mostly empty at low load, cost
// one zero-store sweep per empty tile and no index or row reads.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;   // 8 warps = 8 output rows per block
constexpr int RAGGED_TILE = 32;   // rows per block of the ragged gather

template <typename V>   // uint4 (16 B), uint32_t or uint16_t: raw bits
__global__ void __launch_bounds__(THREADS) permute_kernel(
    const V* __restrict__ x, const int* __restrict__ src, V* __restrict__ out,
    int n, int t, int w) {
  const int row = (blockIdx.x * THREADS + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= n) return;
  const int s = src[row];
  V* o = out + (long long)row * w;
  if (s < 0 || s >= t) {            // dropped slot: a zero row
    for (int c = lane; c < w; c += 32) o[c] = V{};
    return;
  }
  const V* xr = x + (long long)s * w;
  for (int c = lane; c < w; c += 32) o[c] = xr[c];
}

// Tile [base, last] is empty when each segment it touches starts its part
// of the tile at or past that segment's prefix.  The wrapper guarantees
// n_seg * seg_stride >= n, so every row has a segment.
template <typename V>
__global__ void __launch_bounds__(THREADS) permute_ragged_kernel(
    const V* __restrict__ x, const int* __restrict__ src,
    const int* __restrict__ total, V* __restrict__ out, int n, int t, int w,
    int seg_stride) {
  const int base = blockIdx.x * RAGGED_TILE;
  const int last = min(base + RAGGED_TILE, n) - 1;
  bool empty = true;
  for (int r = base / seg_stride; r <= last / seg_stride && empty; ++r) {
    const int seg0 = r * seg_stride;
    empty = max(base, seg0) - seg0 >= total[r];
  }
  if (empty) {
    V* o = out + (long long)base * w;
    const long long cnt = (long long)(last - base + 1) * w;
    for (long long c = threadIdx.x; c < cnt; c += THREADS) o[c] = V{};
    return;
  }
  const int lane = threadIdx.x & 31;
  for (int row = base + (threadIdx.x >> 5); row <= last; row += THREADS / 32) {
    const int s = src[row];
    V* o = out + (long long)row * w;
    if (s < 0 || s >= t) {
      for (int c = lane; c < w; c += 32) o[c] = V{};
      continue;
    }
    const V* xr = x + (long long)s * w;
    for (int c = lane; c < w; c += 32) o[c] = xr[c];
  }
}

// 8 consecutive elements <-> f32; the vector forms need 16-byte alignment
template <typename T, bool VEC> struct Pack8;
template <> struct Pack8<float, true> {
  static __device__ void load(const float* p, float* f) {
    const float4 a = ((const float4*)p)[0], b = ((const float4*)p)[1];
    f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
    f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
  }
  static __device__ void store(float* p, const float* f) {
    ((float4*)p)[0] = make_float4(f[0], f[1], f[2], f[3]);
    ((float4*)p)[1] = make_float4(f[4], f[5], f[6], f[7]);
  }
};
template <> struct Pack8<__nv_bfloat16, true> {
  static __device__ void load(const __nv_bfloat16* p, float* f) {
    const uint4 u = *(const uint4*)p;
    const __nv_bfloat162* h = (const __nv_bfloat162*)&u;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 v = __bfloat1622float2(h[i]);
      f[2 * i] = v.x;
      f[2 * i + 1] = v.y;
    }
  }
  static __device__ void store(__nv_bfloat16* p, const float* f) {
    uint4 u;
    __nv_bfloat162* h = (__nv_bfloat162*)&u;
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    *(uint4*)p = u;
  }
};

template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS) unpermute_kernel(
    const T* __restrict__ buf, const int* __restrict__ slot,
    const float* __restrict__ w, T* __restrict__ out, int t, int k, int h,
    int m) {
  const int row = (blockIdx.x * THREADS + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= t) return;
  const int* sl = slot + (long long)row * k;
  const float* wr = w + (long long)row * k;
  T* o = out + (long long)row * h;
  if (VEC) {   // h % 8 == 0: each lane owns 8 consecutive columns per sweep
    for (int c = lane * 8; c < h; c += 32 * 8) {
      float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      for (int j = 0; j < k; ++j) {
        const int s = sl[j];
        const float wj = s >= 0 ? wr[j] : 0.f;
        float xv[8];
        Pack8<T, true>::load(buf + (long long)min(max(s, 0), m - 1) * h + c, xv);
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[e] += xv[e] * wj;
      }
      Pack8<T, true>::store(o + c, acc);
    }
  } else {
    for (int c = lane; c < h; c += 32) {
      float acc = 0.f;
      for (int j = 0; j < k; ++j) {
        const int s = sl[j];
        const float wj = s >= 0 ? wr[j] : 0.f;
        acc += to_f(buf[(long long)min(max(s, 0), m - 1) * h + c]) * wj;
      }
      o[c] = from_f<T>(acc);
    }
  }
}

inline bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

inline dim3 row_grid(int rows) { return dim3((rows + THREADS / 32 - 1) / (THREADS / 32)); }

template <typename T>
cudaError_t unpermute_launch(const void* buf, const int* slot, const float* w,
                             void* out, int t, int k, int h, int m,
                             cudaStream_t s) {
  if (h % 8 == 0 && aligned16(buf) && aligned16(out))
    unpermute_kernel<T, true><<<row_grid(t), THREADS, 0, s>>>(
        (const T*)buf, slot, w, (T*)out, t, k, h, m);
  else
    unpermute_kernel<T, false><<<row_grid(t), THREADS, 0, s>>>(
        (const T*)buf, slot, w, (T*)out, t, k, h, m);
  return cudaGetLastError();
}

}  // namespace

extern "C" int rt_permute_tokens(const void* x, const void* src, void* out,
                                 int n, int t, int h, int elem_bytes,
                                 void* stream) {
  if (n == 0 || h == 0) return cudaSuccess;
  if (elem_bytes != 2 && elem_bytes != 4) return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const long long row_bytes = (long long)h * elem_bytes;
  const int* si = (const int*)src;
  if (row_bytes % 16 == 0 && aligned16(x) && aligned16(out))
    permute_kernel<uint4><<<row_grid(n), THREADS, 0, s>>>(
        (const uint4*)x, si, (uint4*)out, n, t, (int)(row_bytes / 16));
  else if (elem_bytes == 4)
    permute_kernel<uint32_t><<<row_grid(n), THREADS, 0, s>>>(
        (const uint32_t*)x, si, (uint32_t*)out, n, t, h);
  else
    permute_kernel<uint16_t><<<row_grid(n), THREADS, 0, s>>>(
        (const uint16_t*)x, si, (uint16_t*)out, n, t, h);
  return cudaGetLastError();
}

extern "C" int rt_permute_tokens_ragged(const void* x, const void* src,
                                        const void* total, void* out, int n,
                                        int t, int h, int elem_bytes,
                                        int seg_stride, void* stream) {
  if (n == 0 || h == 0) return cudaSuccess;
  if ((elem_bytes != 2 && elem_bytes != 4) || seg_stride <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const long long row_bytes = (long long)h * elem_bytes;
  const int* si = (const int*)src;
  const int* tot = (const int*)total;
  const dim3 grid((n + RAGGED_TILE - 1) / RAGGED_TILE);
  if (row_bytes % 16 == 0 && aligned16(x) && aligned16(out))
    permute_ragged_kernel<uint4><<<grid, THREADS, 0, s>>>(
        (const uint4*)x, si, tot, (uint4*)out, n, t, (int)(row_bytes / 16),
        seg_stride);
  else if (elem_bytes == 4)
    permute_ragged_kernel<uint32_t><<<grid, THREADS, 0, s>>>(
        (const uint32_t*)x, si, tot, (uint32_t*)out, n, t, h, seg_stride);
  else
    permute_ragged_kernel<uint16_t><<<grid, THREADS, 0, s>>>(
        (const uint16_t*)x, si, tot, (uint16_t*)out, n, t, h, seg_stride);
  return cudaGetLastError();
}

extern "C" int rt_unpermute_tokens(const void* buf, const void* slot,
                                   const void* weights, void* out, int t,
                                   int k, int h, int m, int dtype,
                                   void* stream) {
  if (t == 0 || h == 0) return cudaSuccess;
  if (k <= 0 || m <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int* si = (const int*)slot;
  const float* w = (const float*)weights;
  if (dtype == RT_F32)
    return unpermute_launch<float>(buf, si, w, out, t, k, h, m, s);
  if (dtype == RT_BF16)
    return unpermute_launch<__nv_bfloat16>(buf, si, w, out, t, k, h, m, s);
  return cudaErrorInvalidValue;
}
