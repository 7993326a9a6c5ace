// megakernel: one whole `Simulation.step` of the flagship per launch -- the
// four RK4 stages of World.f_ode, the k-sum, the RK4 combine (compensated on
// q_ew and h_e when residuals are carried), World.f_step with the
// terminated latch, the t / i bookkeeping and the EGM96 geoid refresh under
// the new position, on every step.
//
// Replaces the TPU kernel of flightjax/parallel/megakernel.py::
// make_megakernel_step (:43, pallas_call :120), which traces
// jax.vmap(Simulation.step) into one Pallas call, and the geoid refresh that
// path runs after it on every step (:144-154); its `geoid_every` is ignored
// there as here. Plain PyTorch version:
// flightjax_torch/parallel/megakernel.py::megakernel_step_plain.
//
// The state stays resident on the card in one [MEGA_N_ROWS, B] buffer of the
// state's dtype (t, X, CTX, C; layout in c172_systems.cuh) and an int32
// [1, B] step counter: the host does one launch per step and no packing.
// Each lane reads its column into registers and writes its column of the
// output buffers. The stage loop is kept rolled (`#pragma unroll 1`) so the
// systems body is emitted once, as the JAX kernel swaps in
// rk4_step_loop for the same reason (megakernel.py:56-67).
//
// What bounds it on the H100: one thread per aircraft, 69 + 1 rows read and
// written per lane (2.3 MB in float32 at B = 4096, ~0.7 us of HBM) against
// four systems bodies and the finish; x, k_prev and the k-sum (81 values)
// live beside the systems body's registers, so it spills to local memory,
// and 4096 threads in 128-thread blocks fill 32 of the 132 SMs. It is bound
// by latency and occupancy; PERF.md records ptxas's registers and spills.
#include "c172_systems.cuh"

using namespace fj;

template <typename T>
__global__ void __launch_bounds__(128)
    megakernel_kernel(const T* __restrict__ in, const int* __restrict__ i_in,
                      const T* __restrict__ P, const T* __restrict__ G,
                      T* __restrict__ out, int* __restrict__ i_out, int B,
                      double dt, double t_start, int comp) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const Col<T> c{in, B, b};
  const Out<T> o{out, B, b};
  const XVeh<T> x = load_x(c, MG_X);
  Ctx<T> ctx = load_ctx(c, MG_CTX);
  Q4<T> r_q = c.q4(MG_C);
  T r_h = c(MG_C + 4);

  // the four stages; stage offsets and weights as in clusterstep.py:124-125,
  // the k-sum ((((0 + k1) + 2 k2) + 2 k3) + k4) as the plain step forms it
  XVeh<T> kprev, acc;
  kprev.kin = {{T(0), T(0), T(0), T(0)}, {T(0), T(0), T(0), T(0)}, T(0)};
  kprev.dyn = {{T(0), T(0), T(0)}, {T(0), T(0), T(0)}};
#pragma unroll
  for (int r = 0; r < N_XSYS; ++r) kprev.sys[r] = T(0);
  acc = kprev;
#pragma unroll 1
  for (int s = 0; s < 4; ++s) {
    const T cs = T(s == 0 ? 0.0 : (s == 3 ? dt : 0.5 * dt));
    const T w = T(s == 0 || s == 3 ? 1.0 : 2.0);
    kprev = vehicle_f_ode(P, axpy(x, cs, kprev), ctx);
    acc = axpy(acc, w, kprev);
  }

  Kin<T> kin;
  const XVeh<T> xn =
      vehicle_finish(P, x, acc, T(dt / 6.0), comp != 0, r_q, r_h, ctx, kin);

  const int i_new = i_in[b] + 1;
  o.s(MG_T, T(t_start) + T(double(i_new)) * T(dt));
  store_x(o, MG_X, xn);
#pragma unroll
  for (int r = 0; r < MG_C - MG_CTX; ++r) o.s(MG_CTX + r, c(MG_CTX + r));
  store_ssys(o, MG_CTX + CX_SSYS, ctx.s);
  o.s(MG_CTX + CX_GEOID, geoid_height(G, kin.n_e));
  o.s(MG_CTX + CX_TERM, ctx.term);
  o.q4(MG_C, r_q);
  o.s(MG_C + 4, r_h);
  i_out[b] = i_new;
}

template <typename T>
static int launch(const void* in, const void* i_in, const void* params,
                  const void* grid_, void* out, void* i_out, int B, double dt,
                  double t_start, int comp, int block, void* stream) {
  if (B <= 0) return 0;
  if (block <= 0 || block > 128) return (int)cudaErrorInvalidValue;
  const int grid = (B + block - 1) / block;
  megakernel_kernel<T><<<grid, block, 0, (cudaStream_t)stream>>>(
      (const T*)in, (const int*)i_in, (const T*)params, (const T*)grid_,
      (T*)out, (int*)i_out, B, dt, t_start, comp);
  return (int)cudaGetLastError();
}

extern "C" {
int megakernel_f32(const void* in, const void* i_in, const void* params,
                   const void* grid, void* out, void* i_out, int B, double dt,
                   double t_start, int comp, int block, void* stream) {
  return launch<SF>(in, i_in, params, grid, out, i_out, B, dt, t_start, comp,
                    block, stream);
}
int megakernel_f64(const void* in, const void* i_in, const void* params,
                   const void* grid, void* out, void* i_out, int B, double dt,
                   double t_start, int comp, int block, void* stream) {
  return launch<SD>(in, i_in, params, grid, out, i_out, B, dt, t_start, comp,
                    block, stream);
}
void megakernel_layout(int* n_in, int* n_out) {
  *n_in = MEGA_N_ROWS;
  *n_out = MEGA_N_ROWS;
}
}
