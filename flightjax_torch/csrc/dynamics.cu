// dynamics: Newton-Euler at the centre of mass from the summed mass
// properties, external wrench and rotor angular momentum: mass-property and
// wrench translation to the CoM, Fukushima's Cartesian -> geodetic inverse
// for the CoM, Somigliana gravity, Earth-rate Coriolis terms, the
// closed-form adjugate 3x3 solve, and the derivative zeroed on terminated
// lanes.
//
// Replaces the TPU kernel `k_dynamics` of flightjax/parallel/clusterstep.py,
// built from the lane function `k3_lane` (clusterstep.py:403-414) over
// VehicleDynamics.f_ode (flightjax/physics/dynamics.py:211-290). Plain
// PyTorch version: flightjax_torch/parallel/kernels.py::dynamics_plain.
//
// What bounds it on the H100: one thread per aircraft, ~500 flops, 36
// inputs and 6 outputs per lane: at B = 4096 a call moves 0.7 MB in
// float32, so it is bound by launch latency and occupancy, not by
// bandwidth or FLOPs. 4096 threads in 128-thread blocks occupy only 32 of
// the 132 SMs; PERF.md records the block sizes measured on the card. Two
// warps per 32 aircraft (the geodetic inverse and gravity beside the solve,
// omega_dot crossing at one barrier) measured no faster on the H100
// (PERF.md, tools/ablate_torch_roles.py `dynamics_roles`).
#include "flight_math.cuh"

using namespace fj;

template <typename T>
__global__ void dynamics_kernel(const T* __restrict__ in, T* __restrict__ out,
                                int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const Col<T> c{in, B, b};
  const Out<T> o{out, B, b};

  MP<T> mp;
  mp.m = c(6);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) mp.J.m[i][j] = c(7 + 3 * i + j);
  mp.r = c.v3(16);
  store_xdyn(o, 0, dynamics_lane(load_xdyn(c, 0), mp, c.v3(19), c.v3(22),
                                 c.v3(25), c.q4(28), c.v3(32),
                                 T(1.0) - c(35)));
}

template <typename T>
static int launch(const void* in, void* out, int B, int block, void* stream) {
  if (B <= 0) return 0;
  if (block <= 0 || block > 1024) return (int)cudaErrorInvalidValue;
  const int grid = (B + block - 1) / block;
  dynamics_kernel<T><<<grid, block, 0, (cudaStream_t)stream>>>(
      (const T*)in, (T*)out, B);
  return (int)cudaGetLastError();
}

extern "C" {
int dynamics_f32(const void* in, void* out, int B, int block, void* stream) {
  return launch<SF>(in, out, B, block, stream);
}
int dynamics_f64(const void* in, void* out, int B, int block, void* stream) {
  return launch<SD>(in, out, B, block, stream);
}
void dynamics_layout(int* n_in, int* n_out) {
  *n_in = DYN_N_IN;
  *n_out = DYN_N_OUT;
}
}
