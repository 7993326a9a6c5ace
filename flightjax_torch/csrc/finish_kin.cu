// finish_kin: the RK4 combine x + dt/6 (k1 + 2k2 + 2k3 + k4) on the
// kinematics and dynamics states -- Kahan/Neumaier-compensated on the
// position states q_ew and h_e when residuals are carried -- the WA
// quaternion renormalisation, and a fresh KinData and AirData at the new
// state.
//
// Replaces the TPU kernel `k_finish_kin` of flightjax/parallel/
// clusterstep.py, built from the lane function `k4_lane`
// (clusterstep.py:433-448), plus the compensated add `comp_add` of
// flightjax/core/sim.py:158-180 that the Pallas paths leave out
// (clusterstep.py:170, :608). Plain PyTorch version:
// flightjax_torch/parallel/kernels.py::finish_kin_plain.
//
// What bounds it on the H100: one thread per aircraft, ~350 flops and a
// dozen transcendentals, 41 inputs and 82 outputs per lane: at B = 4096 a
// call moves 2.0 MB in float32, so it is bound by launch latency and
// occupancy, not by bandwidth or FLOPs. 4096 threads in 128-thread blocks
// occupy only 32 of the 132 SMs; PERF.md records the block sizes measured
// on the card.
#include "flight_math.cuh"

using namespace fj;

template <typename T>
__global__ void finish_kin_kernel(const T* __restrict__ in,
                                  T* __restrict__ out, int B, T c6,
                                  int comp) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const Col<T> c{in, B, b};
  const Out<T> o{out, B, b};

  Q4<T> r_q = {T(0), T(0), T(0), T(0)};
  T r_h = T(0);
  if (comp) {
    r_q = c.q4(36);
    r_h = c(40);
  }
  XKin<T> x;
  XDyn<T> x_dyn;
  Kin<T> k;
  Air<T> air;
  finish_kin_lane(load_xkin(c, 0), load_xdyn(c, 9), load_xkin(c, 15),
                  load_xdyn(c, 24), c6, comp != 0, r_q, r_h, c(30),
                  load_atm(c, 31), x, x_dyn, k, air);
  store_xkin(o, 0, x);
  store_xdyn(o, N_XKIN, x_dyn);
  store_kin(o, N_XKIN + N_XDYN, k);
  store_air(o, N_XKIN + N_XDYN + N_KIN, air);
  o.q4(N_XKIN + N_XDYN + N_KIN + N_AIR, r_q);
  o.s(N_XKIN + N_XDYN + N_KIN + N_AIR + 4, r_h);
}

template <typename T>
static int launch(const void* in, void* out, int B, double c6, int comp,
                  int block, void* stream) {
  if (B <= 0) return 0;
  if (block <= 0 || block > 1024) return (int)cudaErrorInvalidValue;
  const int grid = (B + block - 1) / block;
  finish_kin_kernel<T><<<grid, block, 0, (cudaStream_t)stream>>>(
      (const T*)in, (T*)out, B, T(c6), comp);
  return (int)cudaGetLastError();
}

extern "C" {
int finish_kin_f32(const void* in, void* out, int B, double c6, int comp,
                   int block, void* stream) {
  return launch<SF>(in, out, B, c6, comp, block, stream);
}
int finish_kin_f64(const void* in, void* out, int B, double c6, int comp,
                   int block, void* stream) {
  return launch<SD>(in, out, B, c6, comp, block, stream);
}
void finish_kin_layout(int* n_in, int* n_out) {
  *n_in = FIN_N_IN;
  *n_out = FIN_N_OUT;
}
}
