// An empty kernel, launched as every kernel of this library is (one
// block, on the stream it is given): its device time is the floor under
// which no launch on the card can go, the yardstick for the kernels
// whose own work takes microseconds (chip_smoke.py, "kernel alone").

#include <cuda_runtime.h>

namespace {

__global__ void empty_kernel() {}

}  // namespace

extern "C" int thunder_empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
