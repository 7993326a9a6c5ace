// finish_sys: the RK4 combine x + dt/6 (k1 + 2k2 + 2k3 + k4) on the C172
// systems state, then the systems' discrete step at the new kinematics:
// the three gear struts (weight on wheels, strut angle and rate), stall
// hysteresis, the friction regulators reset off the ground, the crash latch
// and the engine state machine.
//
// Replaces the TPU kernel `k_finish_sys` of flightjax/parallel/
// clusterstep.py, built from the lane function `k5_lane`
// (clusterstep.py:452-465), and with it the fine split of the same cluster:
// `k_fin_act` (kf_pre_lane, :473-479), `k_fin_ldg0..2` (kfleg_lane,
// :482-490) and `k_fin_rest` (kf_rest_lane, :494-505). The TPU split the
// cluster only because the Mosaic compile helper ran out of memory on it
// (clusterstep.py:467-470); nvcc builds it whole from the __device__
// functions of c172_systems.cuh. Plain PyTorch version:
// flightjax_torch/parallel/kernels.py::finish_sys_plain.
//
// What bounds it on the H100: one thread per aircraft, 115 inputs and 15
// outputs per lane (2.1 MB in float32 at B = 4096), three struts of
// quaternion algebra; bound by launch latency and occupancy at this width.
// 4096 threads in 128-thread blocks occupy 32 of the 132 SMs.
#include "c172_systems.cuh"

using namespace fj;

// input rows
constexpr int FI_X = 0, FI_K = FI_X + N_XSYS, FI_U = FI_K + N_XSYS,
              FI_S = FI_U + N_USYS, FI_TRN = FI_S + N_SSYS,
              FI_KIN = FI_TRN + N_TRN, FI_AIR = FI_KIN + N_KIN;
// output rows
constexpr int FO_X = 0, FO_S = N_XSYS;

template <typename T>
__global__ void finish_sys_kernel(const T* __restrict__ in,
                                  const T* __restrict__ P,
                                  T* __restrict__ out, int B, T c6) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const Col<T> c{in, B, b};
  const Out<T> o{out, B, b};

  T x[N_XSYS];
#pragma unroll
  for (int r = 0; r < N_XSYS; ++r) x[r] = c(FI_X + r) + c6 * c(FI_K + r);
  T u[N_USYS];
#pragma unroll
  for (int r = 0; r < N_USYS; ++r) u[r] = c(FI_U + r);
  SSys s = load_ssys(c, FI_S);
  finish_sys_lane(P, x, u, s, load_trn(c, FI_TRN), load_kin(c, FI_KIN),
                  load_air(c, FI_AIR));

#pragma unroll
  for (int r = 0; r < N_XSYS; ++r) o.s(FO_X + r, x[r]);
  store_ssys(o, FO_S, s);
}

template <typename T>
static int launch(const void* in, const void* params, void* out, int B,
                  double c6, int block, void* stream) {
  if (B <= 0) return 0;
  if (block <= 0 || block > 1024) return (int)cudaErrorInvalidValue;
  const int grid = (B + block - 1) / block;
  finish_sys_kernel<T><<<grid, block, 0, (cudaStream_t)stream>>>(
      (const T*)in, (const T*)params, (T*)out, B, T(c6));
  return (int)cudaGetLastError();
}

extern "C" {
int finish_sys_f32(const void* in, const void* params, void* out, int B,
                   double c6, int block, void* stream) {
  return launch<SF>(in, params, out, B, c6, block, stream);
}
int finish_sys_f64(const void* in, const void* params, void* out, int B,
                   double c6, int block, void* stream) {
  return launch<SD>(in, params, out, B, c6, block, stream);
}
void finish_sys_layout(int* n_in, int* n_out) {
  *n_in = FSYS_N_IN;
  *n_out = FSYS_N_OUT;
}
}
