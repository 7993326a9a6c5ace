// geoid: the EGM96 undulation under each aircraft, from its WA position
// quaternion q_ew: n-vector, latitude and longitude, bilinear on the
// 721 x 1441 15-arcmin grid (device function geoid_height of
// flight_math.cuh).
//
// Replaces the geoid refresh that the TPU paths run outside their kernels
// (flightjax/ops/geodesy.py::geoid_height over the row-gather bilinear
// interp.py:330-359, called at megakernel.py:144-154, clusterstep.py:142-159
// and core/sim.py:401-409); it is no Pallas kernel there, since Mosaic
// cannot gather. Plain PyTorch version:
// flightjax_torch/parallel/kernels.py::geoid_plain.
//
// What bounds it on the H100: 4 input rows and 1 output row per lane plus
// four grid values per lane gathered from the 4.2 MB float32 grid (which
// stays in the 50 MB L2): 0.1 MB of lane traffic at B = 4096, a launch of a
// few microseconds, bound by latency.
#include "flight_math.cuh"

using namespace fj;

template <typename T>
__global__ void __launch_bounds__(128)
    geoid_kernel(const T* __restrict__ in, const T* __restrict__ G,
                 T* __restrict__ out, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const Col<T> c{in, B, b};
  Out<T>{out, B, b}.s(0, geoid_height(G, nvector_from_qew(c.q4(0))));
}

template <typename T>
static int launch(const void* in, const void* grid_, void* out, int B,
                  int block, void* stream) {
  if (B <= 0) return 0;
  if (block <= 0 || block > 128) return (int)cudaErrorInvalidValue;
  const int grid = (B + block - 1) / block;
  geoid_kernel<T><<<grid, block, 0, (cudaStream_t)stream>>>(
      (const T*)in, (const T*)grid_, (T*)out, B);
  return (int)cudaGetLastError();
}

extern "C" {
int geoid_f32(const void* in, const void* grid, void* out, int B, int block,
              void* stream) {
  return launch<SF>(in, grid, out, B, block, stream);
}
int geoid_f64(const void* in, const void* grid, void* out, int B, int block,
              void* stream) {
  return launch<SD>(in, grid, out, B, block, stream);
}
void geoid_layout(int* n_in, int* n_out) {
  *n_in = GEOID_N_IN;
  *n_out = GEOID_N_OUT;
}
}
