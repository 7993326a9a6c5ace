// systems: one RK4 stage of the C172 systems -- the stage FMA x + adt k on
// the systems state, mechanical actuation and aerodynamics, the three gear
// legs (strut, contact, friction regulator), engine + propeller + fuel flow,
// and the sum of the mass properties and wrenches the dynamics consume; the
// derivative zeroed on terminated lanes.
//
// Replaces the TPU kernel `k_systems` of flightjax/parallel/clusterstep.py,
// built from the lane function `k2_lane` (clusterstep.py:274-287), and with
// it the fine split of the same cluster: `k_actaero` (k2a_lane, :298-312),
// `k_ldg0..2` (make_leg_lane, :327-341) and `k_pwp` (k2c_lane, :359-374).
// The TPU split the cluster only because the Mosaic compile helper ran out
// of memory on it (clusterstep.py:322-324); nvcc builds it whole, and the
// fine parts are the __device__ functions of c172_systems.cuh, called in
// the fine split's order. Plain PyTorch version:
// flightjax_torch/parallel/kernels.py::systems_plain.
//
// What bounds it on the H100: one thread per aircraft, 116 inputs and 34
// outputs per lane (2.4 MB in float32 at B = 4096), ~20 table lookups and
// three gear legs of quaternion algebra, a few thousand flops per lane. It
// is bound by launch latency and occupancy at this width, not by bandwidth
// or FLOPs; the tables (~25 KB) stay in L1/L2. 4096 threads in 128-thread
// blocks occupy 32 of the 132 SMs; PERF.md records the block sizes measured
// on the card.
#include "c172_systems.cuh"

using namespace fj;

// input rows
constexpr int SI_X = 0, SI_K = SI_X + N_XSYS, SI_U = SI_K + N_XSYS,
              SI_S = SI_U + N_USYS, SI_TRN = SI_S + N_SSYS,
              SI_KIN = SI_TRN + N_TRN, SI_AIR = SI_KIN + N_KIN,
              SI_TERM = SI_AIR + N_AIR;
// output rows
constexpr int SO_DOT = 0, SO_MP = N_XSYS, SO_WR = SO_MP + N_MP,
              SO_HR = SO_WR + N_WR;

template <typename T>
__global__ void systems_kernel(const T* __restrict__ in,
                               const T* __restrict__ P, T* __restrict__ out,
                               int B, T adt) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const Col<T> c{in, B, b};
  const Out<T> o{out, B, b};

  // stage state x + adt k
  T xi[N_XSYS];
#pragma unroll
  for (int r = 0; r < N_XSYS; ++r) xi[r] = c(SI_X + r) + adt * c(SI_K + r);
  T u[N_USYS];
#pragma unroll
  for (int r = 0; r < N_USYS; ++r) u[r] = c(SI_U + r);
  T dot[N_XSYS];
  MP<T> mp;
  V3<T> F_b, tau_b, hr_b;
  systems_lane(P, xi, u, load_ssys(c, SI_S), load_trn(c, SI_TRN),
               load_kin(c, SI_KIN), load_air(c, SI_AIR), T(1.0) - c(SI_TERM),
               dot, mp, F_b, tau_b, hr_b);

#pragma unroll
  for (int r = 0; r < N_XSYS; ++r) o.s(SO_DOT + r, dot[r]);
  o.s(SO_MP, mp.m);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) o.s(SO_MP + 1 + 3 * i + j, mp.J.m[i][j]);
  o.v3(SO_MP + 10, mp.r);
  o.v3(SO_WR, F_b);
  o.v3(SO_WR + 3, tau_b);
  o.v3(SO_HR, hr_b);
}

template <typename T>
static int launch(const void* in, const void* params, void* out, int B,
                  double adt, int block, void* stream) {
  if (B <= 0) return 0;
  if (block <= 0 || block > 1024) return (int)cudaErrorInvalidValue;
  const int grid = (B + block - 1) / block;
  systems_kernel<T><<<grid, block, 0, (cudaStream_t)stream>>>(
      (const T*)in, (const T*)params, (T*)out, B, T(adt));
  return (int)cudaGetLastError();
}

extern "C" {
int systems_f32(const void* in, const void* params, void* out, int B,
                double adt, int block, void* stream) {
  return launch<SF>(in, params, out, B, adt, block, stream);
}
int systems_f64(const void* in, const void* params, void* out, int B,
                double adt, int block, void* stream) {
  return launch<SD>(in, params, out, B, adt, block, stream);
}
void systems_layout(int* n_in, int* n_out) {
  *n_in = SYS_N_IN;
  *n_out = SYS_N_OUT;
}
// the parameter buffer's fixed head: scalars, then one offset per table
void systems_params_layout(int* n_head, int* n_tables) {
  *n_head = P_HEAD;
  *n_tables = TB_N;
}
}
