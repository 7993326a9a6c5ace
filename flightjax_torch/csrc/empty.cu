// empty: a kernel that does nothing, launched with a given grid, block and
// dynamic shared memory. Its time is the floor no kernel launched the same
// way can beat; chip_smoke.py prints it beside the role kernels' times.
#include <cuda_runtime.h>

__global__ void empty_kernel() {}

extern "C" int empty_launch(int grid, int block, int shared, void* stream) {
  // the attribute belongs to the device in use, so every launch sets it
  const cudaError_t err = cudaFuncSetAttribute(
      empty_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shared);
  if (err != cudaSuccess) return (int)err;
  empty_kernel<<<grid, block, shared, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
