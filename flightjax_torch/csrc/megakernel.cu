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
//
// What bounds it on the H100: neither bytes (69 + 1 rows read and written
// per lane, 2.3 MB in float32 at B = 4096, ~0.7 us of HBM) nor operations
// (~22k per lane and step), but one thread's dependent chain through four
// derivatives and the finish. With one thread per aircraft that thread also
// held x, k_prev and the k-sum of all 27 states (81 values) beside the
// systems body, and spilled.
//
// What the design does about it: several threads carry one aircraft, one
// warp per subsystem (the roles of c172_systems.cuh; see rk4_stage.cu). Each
// role carries k_prev of its own rows in registers through the four stages
// and keeps x and the k-sum of those rows in shared memory, where they are
// touched once per stage, so the systems' derivatives never leave their
// role; the finish splits the same way, with the crash flags meeting in
// shared memory for the terminated latch and role KIN looking up the
// undulation while the struts run. Two barriers per stage and two for the
// finish. The stage loop stays rolled (`#pragma unroll 1`), so the role
// bodies are emitted once, as the JAX kernel swaps in rk4_step_loop for the
// same reason (megakernel.py:56-67). Stage offsets, the k-sum
// ((((0 + k1) + 2 k2) + 2 k3) + k4), t = t_start + T(i + 1) dt and the
// compensated add are those of the plain step, and the result is
// bit-identical to the one-thread form. The parameters and tables are read
// from shared memory. PERF.md records ptxas's registers and spills and the
// times on the card.
#include "c172_systems.cuh"

using namespace fj;

template <typename T>
__global__ void __launch_bounds__(N_ROLES * MAX_LANES)
    megakernel_kernel(const T* __restrict__ in, const int* __restrict__ i_in,
                      const T* __restrict__ P, const T* __restrict__ G,
                      T* __restrict__ out, int* __restrict__ i_out, int B,
                      int n_params, double dt, double t_start, int comp) {
  T* sP = block_shared<T>();
  T* sh = sP + n_params;
  share_params(P, n_params, sP);  // published by the first stage's barrier
  const RoleThread t = role_thread(B);
  const Col<T> c{in, B, t.b};
  const Out<T> o{out, B, t.b};
  // x and the k-sum live in the scratch, each thread its role's rows of its
  // lane (no other thread touches them); k_prev stays in registers
  const Col<T> sx{sh + SH_X * t.L, t.L, t.lane};
  const Col<T> ss{sh + SH_KSUM * t.L, t.L, t.lane};
  const Out<T> sxo{sh + SH_X * t.L, t.L, t.lane};
  const Out<T> sso{sh + SH_KSUM * t.L, t.L, t.lane};
  T x[N_SLOTS], kprev[N_SLOTS], acc[N_SLOTS];
  load_slots(c, MG_X, t.role, x);
  store_slots(sxo, 0, t.role, x);
#pragma unroll
  for (int k = 0; k < N_SLOTS; ++k) kprev[k] = acc[k] = T(0);
  store_slots(sso, 0, t.role, acc);

  // the four stages; stage offsets and weights as in clusterstep.py:124-125,
  // the k-sum ((((0 + k1) + 2 k2) + 2 k3) + k4) as the plain step forms it
#pragma unroll 1
  for (int s = 0; s < 4; ++s) {
    const T cs = T(s == 0 ? 0.0 : (s == 3 ? dt : 0.5 * dt));
    const T w = T(s == 0 || s == 3 ? 1.0 : 2.0);
    T xi[N_SLOTS];
    load_slots(sx, 0, t.role, x);
#pragma unroll
    for (int k = 0; k < N_SLOTS; ++k) xi[k] = x[k] + cs * kprev[k];
    f_ode_roles(sP, sh, t, xi, c, MG_CTX, kprev);
    load_slots(ss, 0, t.role, acc);
#pragma unroll
    for (int k = 0; k < N_SLOTS; ++k) acc[k] = acc[k] + w * kprev[k];
    store_slots(sso, 0, t.role, acc);
  }

  T xn[N_SLOTS];
  FinishOut<T> f;
  load_slots(sx, 0, t.role, x);
  load_slots(ss, 0, t.role, acc);
  finish_roles<true>(sP, G, sh, t, x, acc, T(dt / 6.0), comp != 0, c, MG_CTX,
                     MG_C, xn, f);
  if (!t.valid) return;  // past the last barrier

  store_slots(o, MG_X, t.role, xn);
  // inputs and terrain pass through, a few rows per role; the discrete
  // state, the undulation and the latch come from the roles that made them
  for (int r = t.role; r < CX_SSYS; r += N_ROLES)
    o.s(MG_CTX + r, c(MG_CTX + r));
  if (t.role == ROLE_AERO) {
    o.s(MG_CTX + CX_SSYS + SS_STALL, T(f.s.stall ? 1.0 : 0.0));
  } else if (t.role == ROLE_ENG) {
    o.s(MG_CTX + CX_SSYS + SS_STATE, T(double(f.s.state)));
  } else if (t.role == ROLE_KIN) {
    const int i_new = i_in[t.b] + 1;
    o.s(MG_T, T(t_start) + T(double(i_new)) * T(dt));
    o.s(MG_CTX + CX_SSYS + SS_CRASHED, T(f.s.crashed ? 1.0 : 0.0));
    o.s(MG_CTX + CX_GEOID, f.geoid_N);
    o.s(MG_CTX + CX_TERM, f.term);
    o.q4(MG_C, f.r_q);
    o.s(MG_C + 4, f.r_h);
    i_out[t.b] = i_new;
  }
}

template <typename T>
static int launch(const void* in, const void* i_in, const void* params,
                  const void* grid_, void* out, void* i_out, int B,
                  int n_params, double dt, double t_start, int comp,
                  int lanes, void* stream) {
  if (B <= 0) return 0;
  if (lanes <= 0 || lanes > MAX_LANES || lanes % 32 != 0)
    return (int)cudaErrorInvalidValue;
  const RoleLaunch l = role_launch(B, lanes, n_params, (int)sizeof(T),
                                   SH_MEGA_N);
  // the attribute belongs to the device in use, so every launch sets it
  const cudaError_t err = cudaFuncSetAttribute(
      megakernel_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      l.shared);
  if (err != cudaSuccess) return (int)err;
  megakernel_kernel<T><<<l.grid, l.block, l.shared, (cudaStream_t)stream>>>(
      (const T*)in, (const int*)i_in, (const T*)params, (const T*)grid_,
      (T*)out, (int*)i_out, B, n_params, dt, t_start, comp);
  return (int)cudaGetLastError();
}

extern "C" {
int megakernel_f32(const void* in, const void* i_in, const void* params,
                   const void* grid, void* out, void* i_out, int B,
                   int n_params, double dt, double t_start, int comp,
                   int lanes, void* stream) {
  return launch<SF>(in, i_in, params, grid, out, i_out, B, n_params, dt,
                    t_start, comp, lanes, stream);
}
int megakernel_f64(const void* in, const void* i_in, const void* params,
                   const void* grid, void* out, void* i_out, int B,
                   int n_params, double dt, double t_start, int comp,
                   int lanes, void* stream) {
  return launch<SD>(in, i_in, params, grid, out, i_out, B, n_params, dt,
                    t_start, comp, lanes, stream);
}
void megakernel_layout(int* n_in, int* n_out) {
  *n_in = MEGA_N_ROWS;
  *n_out = MEGA_N_ROWS;
}
void megakernel_launch_shape(int B, int lanes, int n_params, int elem_size,
                             int* grid, int* block, int* shared) {
  put_launch(role_launch(B, lanes, n_params, elem_size, SH_MEGA_N), grid,
             block, shared);
}
}
