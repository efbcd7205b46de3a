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
// each output row written once at HBM rate.  permute copies raw bits (it
// never converts), so one kernel serves both float types.
//
// The two gathers.  A served gather moves 0.5-26 MB: no more than the
// card's bandwidth-delay product (3.35 TB/s x ~1 us), so its time is set
// by how many loads are in flight at once, not by how they stream.  The
// grid is rows x column chunks (ops.permute_plan): a CTA of 64 threads
// moves a tile of 32 rows x 8 units of one column chunk (a unit is 16
// bytes; one element on the element-wise path), row tiles on gridDim.x,
// which has no 65535 cap, chunks on gridDim.y.  So a 320-row gather of
// 4 KB rows is 320 CTAs, more than two per SM.  Each thread
// owns one unit column of the chunk and 4 rows 8 apart: it reads its 4
// src entries, then issues its 4 independent 16-byte loads, then its 4
// stores, so a CTA has 4 KB in flight from its first instruction (8 lanes
// per row sweep a full 128-byte line).  Registers rather than TMA bulk
// copies: a chunk is one 128-byte line per row, and staging it through
// shared memory would add an mbarrier wait and a second pass for nothing
// the registers do not already do.  Rows whose byte width is not a
// multiple of 16 take the element-wise instantiations, one element per
// unit, with the same geometry.  The ragged gather decides per 32-row
// tile, from total[] (each entry read once per CTA), whether the tile lies
// wholly in the empty tails; such a tile writes zeros and reads neither
// src nor x, so the buffers sized for the worst-case skew, mostly empty at
// low load, cost one zero-store sweep per empty tile.
//
// The combine keeps one warp per output row, each lane moving 16 bytes per
// load with neighbouring lanes on neighbouring addresses, so a row is read
// in fully coalesced 512-byte sweeps; the index and weight of each slot are
// read once per lane from L1.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;   // combine: 8 warps = 8 output rows per block

// the gathers' CTA (ops.PERMUTE_ROWS, ops.PERMUTE_CHUNK mirror these)
constexpr int G_THREADS = 64;
constexpr int G_ROWS = 32;     // rows per CTA: the ragged gather's skip tile
constexpr int G_CHUNK = 8;     // units of each row per CTA, one per thread
constexpr int G_STEP = G_THREADS / G_CHUNK;   // 8: a thread's rows apart
constexpr int G_PASSES = G_ROWS / G_STEP;     // 4 loads in flight a thread
static_assert(G_ROWS <= G_THREADS, "a thread per segment a tile touches");

// out[base + r] = x[src[base + r]] for the CTA's tile, at unit column
// `col` of each row; rows of src < 0 or >= t, and every row of an `empty`
// tile, are zeros.  An empty tile reads neither src nor x.
template <typename V>
__device__ __forceinline__ void gather_tile(
    const V* __restrict__ x, const int* __restrict__ src, V* __restrict__ out,
    int n, int t, int w, int base, bool empty) {
  const int col = blockIdx.y * G_CHUNK + threadIdx.x % G_CHUNK;
  if (col >= w) return;
  const int row0 = base + threadIdx.x / G_CHUNK;
  int s[G_PASSES];
#pragma unroll
  for (int p = 0; p < G_PASSES; ++p) {
    const int row = row0 + p * G_STEP;
    s[p] = !empty && row < n ? src[row] : -1;
  }
  V v[G_PASSES];
#pragma unroll
  for (int p = 0; p < G_PASSES; ++p)
    v[p] = s[p] >= 0 && s[p] < t ? x[(long long)s[p] * w + col] : V{};
#pragma unroll
  for (int p = 0; p < G_PASSES; ++p) {
    const int row = row0 + p * G_STEP;
    if (row < n) out[(long long)row * w + col] = v[p];
  }
}

template <typename V>   // uint4 (16 B), uint32_t or uint16_t: raw bits
__global__ void __launch_bounds__(G_THREADS) permute_kernel(
    const V* __restrict__ x, const int* __restrict__ src, V* __restrict__ out,
    int n, int t, int w) {
  gather_tile(x, src, out, n, t, w, blockIdx.x * G_ROWS, false);
}

// Tile [base, last] is empty when each segment it touches starts its part
// of the tile at or past that segment's prefix.  A tile touches at most
// G_ROWS segments, so thread i judges the tile's i-th segment and the
// block ORs the verdicts.  The wrapper guarantees n_seg * seg_stride >= n,
// so every row has a segment.
template <typename V>
__global__ void __launch_bounds__(G_THREADS) permute_ragged_kernel(
    const V* __restrict__ x, const int* __restrict__ src,
    const int* __restrict__ total, V* __restrict__ out, int n, int t, int w,
    int seg_stride) {
  const int base = blockIdx.x * G_ROWS;
  const int last = min(base + G_ROWS, n) - 1;
  const int r = base / seg_stride + threadIdx.x;
  const long long seg0 = (long long)r * seg_stride;
  const bool live = seg0 <= last
                    && max((long long)base, seg0) - seg0 < total[r];
  const bool empty = !__syncthreads_or(live);
  gather_tile(x, src, out, n, t, w, base, empty);
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

template <bool RAGGED, typename V>
void gather_grid(dim3 grid, cudaStream_t s, const void* x, const int* src,
                 const int* total, void* out, int n, int t, int w,
                 int seg_stride) {
  if constexpr (RAGGED)
    permute_ragged_kernel<V><<<grid, G_THREADS, 0, s>>>(
        (const V*)x, src, total, (V*)out, n, t, w, seg_stride);
  else
    permute_kernel<V><<<grid, G_THREADS, 0, s>>>((const V*)x, src, (V*)out,
                                                 n, t, w);
}

// Launch a gather on the grid ops.permute_plan gave: refused (invalid
// configuration) when it does not cover the n rows and the row's units, or
// exceeds gridDim.y's 65535.  16-byte units where the row is a multiple of
// 16 bytes and both pointers are 16-byte aligned, else one element.
template <bool RAGGED>
int gather_launch(const void* x, const int* src, const int* total, void* out,
                  int n, int t, int h, int elem_bytes, int seg_stride,
                  int grid_x, int grid_y, cudaStream_t s) {
  if (n == 0 || h == 0) return cudaSuccess;
  if ((elem_bytes != 2 && elem_bytes != 4) || seg_stride <= 0)
    return cudaErrorInvalidValue;
  const long long row_bytes = (long long)h * elem_bytes;
  const bool vec = row_bytes % 16 == 0 && aligned16(x) && aligned16(out);
  const int w = vec ? (int)(row_bytes / 16) : h;
  if (grid_x <= 0 || grid_y <= 0 || grid_y > 65535
      || (long long)grid_x * G_ROWS < n || (long long)grid_y * G_CHUNK < w)
    return cudaErrorInvalidConfiguration;
  const dim3 grid(grid_x, grid_y);
  if (vec)
    gather_grid<RAGGED, uint4>(grid, s, x, src, total, out, n, t, w,
                               seg_stride);
  else if (elem_bytes == 4)
    gather_grid<RAGGED, uint32_t>(grid, s, x, src, total, out, n, t, w,
                                  seg_stride);
  else
    gather_grid<RAGGED, uint16_t>(grid, s, x, src, total, out, n, t, w,
                                  seg_stride);
  return cudaGetLastError();
}

}  // namespace

extern "C" int rt_permute_tokens(const void* x, const void* src, void* out,
                                 int n, int t, int h, int elem_bytes,
                                 int grid_x, int grid_y, void* stream) {
  return gather_launch<false>(x, (const int*)src, nullptr, out, n, t, h,
                              elem_bytes, 1, grid_x, grid_y,
                              (cudaStream_t)stream);
}

extern "C" int rt_permute_tokens_ragged(const void* x, const void* src,
                                        const void* total, void* out, int n,
                                        int t, int h, int elem_bytes,
                                        int seg_stride, int grid_x,
                                        int grid_y, void* stream) {
  return gather_launch<true>(x, (const int*)src, (const int*)total, out, n,
                             t, h, elem_bytes, seg_stride, grid_x, grid_y,
                             (cudaStream_t)stream);
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
