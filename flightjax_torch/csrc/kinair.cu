// kinair: RK4 stage FMA on the kinematics and dynamics states, the
// wander-azimuth kinematics (derivative + KinData), the ISA atmosphere with
// wind, air data, and the derivative zeroed on terminated lanes.
//
// Replaces the TPU kernel `k_kinair` of flightjax/parallel/clusterstep.py,
// built from the lane function `k1_lane` (clusterstep.py:250-262) through
// pallas_block / pallas_block_minor. Plain PyTorch version:
// flightjax_torch/parallel/kernels.py::kinair_plain.
//
// What bounds it on the H100: one thread per aircraft, ~400 flops and a
// dozen transcendentals per lane, 37 inputs and 77 outputs per lane. At
// B = 4096 a call moves 1.8 MB in float32 (3.7 MB in float64), a
// microsecond of HBM time, so it is bound by launch latency and by
// occupancy, not by bandwidth or FLOPs. 4096 threads in 128-thread blocks
// occupy only 32 of the 132 SMs; the block size is a launch argument and
// PERF.md records 32/64/128/256 measured on the card.
#include "flight_math.cuh"

using namespace fj;

template <typename T>
__global__ void kinair_kernel(const T* __restrict__ in, T* __restrict__ out,
                              int B, T adt) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const Col<T> c{in, B, b};
  const Out<T> o{out, B, b};

  // stage state x + adt * k
  const XKin<T> xi = axpy(load_xkin(c, 0), adt, load_xkin(c, 15));
  const XDyn<T> xi_dyn = axpy(load_xdyn(c, 9), adt, load_xdyn(c, 24));
  XKin<T> kin_dot;
  Kin<T> k;
  Air<T> air;
  kinair_lane(xi, xi_dyn, c(30), load_atm(c, 31), T(1.0) - c(36), kin_dot, k,
              air);
  store_xkin(o, 0, kin_dot);
  store_kin(o, N_XKIN, k);
  store_air(o, N_XKIN + N_KIN, air);
  store_xdyn(o, N_XKIN + N_KIN + N_AIR, xi_dyn);
}

template <typename T>
static int launch(const void* in, void* out, int B, double adt, int block,
                  void* stream) {
  if (B <= 0) return 0;
  if (block <= 0 || block > 1024) return (int)cudaErrorInvalidValue;
  const int grid = (B + block - 1) / block;
  kinair_kernel<T><<<grid, block, 0, (cudaStream_t)stream>>>(
      (const T*)in, (T*)out, B, T(adt));
  return (int)cudaGetLastError();
}

extern "C" {
int kinair_f32(const void* in, void* out, int B, double adt, int block,
               void* stream) {
  return launch<SF>(in, out, B, adt, block, stream);
}
int kinair_f64(const void* in, void* out, int B, double adt, int block,
               void* stream) {
  return launch<SD>(in, out, B, adt, block, stream);
}
void kinair_layout(int* n_in, int* n_out) {
  *n_in = KINAIR_N_IN;
  *n_out = KINAIR_N_OUT;
}
}
