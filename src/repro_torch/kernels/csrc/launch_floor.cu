// An empty kernel: one CTA of one warp that does nothing.  It replaces no
// TPU kernel and no path runs it.  Timed beside the kernels, it gives the
// card's per-launch floor, the least time any launch takes, which is the
// bound a kernel of a few microseconds is held to (its byte bound is
// nanoseconds).
#include "common.cuh"

namespace {

__global__ void launch_floor_kernel() {}

}  // namespace

extern "C" int rt_launch_floor(void* stream) {
  launch_floor_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return cudaGetLastError();
}
