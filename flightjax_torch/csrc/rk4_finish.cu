// rk4_finish: the RK4 combine x + dt/6 (k1 + 2k2 + 2k3 + k4) on the whole
// vehicle -- Kahan/Neumaier-compensated on q_ew and h_e when residuals are
// carried -- then World.f_step: the quaternion renormalisation, the C172
// systems' discrete step at the new kinematics (struts, stall hysteresis,
// friction regulator resets, crash latch, engine state machine) and the
// terminated latch.
//
// Replaces the TPU kernel `rk4_finish` of flightjax/parallel/clusterstep.py
// (lane function `finish_lane`, clusterstep.py:97-108, built through
// pallas_block). One launch does what finish_kin -> finish_sys do in two,
// with the new KinData and AirData in registers. Plain PyTorch version:
// flightjax_torch/parallel/kernels.py::rk4_finish_plain.
//
// What bounds it on the H100: one thread per aircraft; 68 input rows, 27
// k-sum rows and 36 output rows per lane (2.1 MB in float32 at B = 4096,
// ~0.6 us of HBM), three struts of quaternion algebra: bound by latency and
// occupancy (32 of 132 SMs at 4096 lanes), not by bandwidth or FLOPs.
#include "c172_systems.cuh"

using namespace fj;

// output rows
constexpr int RO_X = 0, RO_S = N_X, RO_TERM = RO_S + N_SSYS,
              RO_C = RO_TERM + 1;

template <typename T>
__global__ void __launch_bounds__(128)
    rk4_finish_kernel(const T* __restrict__ in, const T* __restrict__ ksum,
                      const T* __restrict__ P, T* __restrict__ out, int B,
                      T c6, int comp) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const Col<T> c{in, B, b};
  const Out<T> o{out, B, b};
  Ctx<T> ctx = load_ctx(c, N_X);
  Q4<T> r_q = {T(0), T(0), T(0), T(0)};
  T r_h = T(0);
  if (comp) {
    r_q = c.q4(N_X + N_CTX);
    r_h = c(N_X + N_CTX + 4);
  }
  Kin<T> kin;
  const XVeh<T> x = vehicle_finish(P, load_x(c, 0), load_x(Col<T>{ksum, B, b}, 0),
                                   c6, comp != 0, r_q, r_h, ctx, kin);
  store_x(o, RO_X, x);
  store_ssys(o, RO_S, ctx.s);
  o.s(RO_TERM, ctx.term);
  o.q4(RO_C, r_q);
  o.s(RO_C + 4, r_h);
}

template <typename T>
static int launch(const void* in, const void* ksum, const void* params,
                  void* out, int B, double c6, int comp, int block,
                  void* stream) {
  if (B <= 0) return 0;
  if (block <= 0 || block > 128) return (int)cudaErrorInvalidValue;
  const int grid = (B + block - 1) / block;
  rk4_finish_kernel<T><<<grid, block, 0, (cudaStream_t)stream>>>(
      (const T*)in, (const T*)ksum, (const T*)params, (T*)out, B, T(c6),
      comp);
  return (int)cudaGetLastError();
}

extern "C" {
int rk4_finish_f32(const void* in, const void* ksum, const void* params,
                   void* out, int B, double c6, int comp, int block,
                   void* stream) {
  return launch<SF>(in, ksum, params, out, B, c6, comp, block, stream);
}
int rk4_finish_f64(const void* in, const void* ksum, const void* params,
                   void* out, int B, double c6, int comp, int block,
                   void* stream) {
  return launch<SD>(in, ksum, params, out, B, c6, comp, block, stream);
}
void rk4_finish_layout(int* n_in, int* n_out) {
  *n_in = RKFIN_N_IN;
  *n_out = RKFIN_N_OUT;
}
}
