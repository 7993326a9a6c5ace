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
//
// The fly-by-wire instance (megakernel_fbw, ACT_FBW) is the same TPU
// kernel's instance on the C172Xv1, whose traced Simulation.step ends with
// the masked periodic pass (core/sim.py:327-333): the control laws of
// c172x_ctl.cuh where the lane's new step counter is a multiple of
// steps_per_periodic, elsewhere the avionics and the four commands stand
// still. Its state buffer also holds the servos (X), their commands (CTX)
// and the avionics' inputs and state. After the finish each role puts the
// CTL_Y fields it holds into the scratch; one more barrier; then role PROP
// runs the lon pass and role DRAG the lat pass, each a function of its own
// (two of eight warps work: the pass is each lane's chain of lookups and
// controllers, the same as ctl_laws.cu runs). The pass reads the kinematics
// at the undulation of the step's start, as the JAX kernel does under
// geoid_deferred. The gains are read through the cache. The C172S instance
// keeps its rows (MegaL) and its parameters come first, so its machine code
// is what it was.
#include "c172x_ctl.cuh"

using namespace fj;

// the rows of an instance's state buffer and scratch: t, X, CTX, C (and the
// avionics block, fly-by-wire); the scratch holds the roles' shared rows,
// then each thread's x and k-sum (and the CTL_Y rows of the pass)
template <int ACT>
struct MegaL {
  enum : int {
    X = 1,
    CTX = X + SysL<ACT>::NXV,
    C = CTX + SysL<ACT>::NCTX,
    AV = C + N_C,
    ROWS = AV + (ACT == ACT_FBW ? N_AV : 0),
    SH_X = ACT == ACT_FBW ? SH_N_FBW : SH_N,
    SH_KSUM = SH_X + SysL<ACT>::NXV,
    SH_Y = SH_KSUM + SysL<ACT>::NXV,
    SH_ROWS = SH_Y + (ACT == ACT_FBW ? N_CTLY : 0)
  };
};

// the fly-by-wire instance: each role puts the CTL_Y fields it holds after
// the finish into the scratch, role KIN the kinematics, air data and new
// h_e, role AERO the gated airflow angles and the filters, role ENG the
// speed ratio, role DRAG the commands (clipped, from CTX) and the servo
// positions, each leg its weight on wheels
template <typename T>
__device__ __forceinline__ void share_ctl_y(const T* P, const Out<T>& so,
                                            const Col<T>& c, int r_usys,
                                            const RoleThread& t,
                                            const T (&xn)[N_SLOTS],
                                            const FinishOut<T>& f) {
  if (t.role == ROLE_KIN) {
    so.v3(CY_OM_WB, f.om_wb);
    so.v3(CY_OM_EB, V3<T>{xn[9], xn[10], xn[11]});
    so.v3(CY_E_NB, f.e_nb);
    so.v3(CY_V_EB_N, f.v_eb_n);
    so.s(CY_CHI, f.chi);
    so.s(CY_EAS, f.EAS);
    so.s(CY_H_E, xn[8]);
  } else if (t.role == ROLE_AERO) {
    so.s(CY_ALPHA, f.alpha);
    so.s(CY_BETA, f.beta);
    so.s(CY_ALPHA_F, xn[0]);
    so.s(CY_BETA_F, xn[1]);
  } else if (t.role == ROLE_ENG) {
    so.s(CY_N, xn[PW_OMEGA] / P[P_EN + EN_omega_rated]);
  } else if (t.role == ROLE_DRAG) {
    const int ch[N_CMD] = {CH_AIL, CH_ELV, CH_RUD, CH_THR};
#pragma unroll
    for (int k = 0; k < N_CMD; ++k) {
      const T* A = P + P_ACT + ch[k] * AC_N;
      so.s(CY_CMD + k, clamp(c(r_usys + fbw_cmd_row(ch[k])), A[AC_lo],
                             A[AC_hi]));
      so.s(CY_POS + k, servo_pos(P, ch[k], xn[ch[k]]));
    }
  } else if (t.role >= ROLE_LEG0) {
    so.s(CY_WOW + t.role - ROLE_LEG0, T(f.wow ? 1.0 : 0.0));
  }
}

// the roles that run the fly-by-wire instance's periodic pass
constexpr int ROLE_LON = ROLE_PROP, ROLE_LAT = ROLE_DRAG;

// the pass of one side (lon or lat) where it fires: the new state and the
// side's two commands (in place of those of CTX); elsewhere both pass
// through. The side's inputs pass through.
template <typename T>
__device__ __forceinline__ void periodic_side(bool lon, bool fires,
                                              const T* G, const Col<T>& y,
                                              const Col<T>& c, const Out<T>& o,
                                              int r_av, int r_usys, T pdt) {
  const int r_u = r_av + (lon ? AV_ULON : AV_ULAT);
  const int r_s = r_av + (lon ? AV_SLON : AV_SLAT);
  const int n_u = lon ? N_ULON : N_ULAT, n_s = lon ? N_SLON : N_SLAT;
  const int row_a = r_usys + fbw_cmd_row(lon ? CH_THR : CH_AIL);
  const int row_b = r_usys + fbw_cmd_row(lon ? CH_ELV : CH_RUD);
  pass_rows(c, o, r_u, n_u);
  if (!fires) {
    pass_rows(c, o, r_s, n_s);
    o.s(row_a, c(row_a));
    o.s(row_b, c(row_b));
    return;
  }
  const Col<T> u{c.buf + r_u * c.B, c.B, c.b};
  const Col<T> s{c.buf + r_s * c.B, c.B, c.b};
  const Out<T> so{o.buf + r_s * o.B, o.B, o.b};
  const Cmd2<T> cmd = lon ? lon_step(G, y, u, s, so, pdt)
                          : lat_step(G, y, u, s, so, pdt);
  o.s(row_a, cmd.a);
  o.s(row_b, cmd.b);
}

template <int ACT, typename T>
__global__ void __launch_bounds__(N_ROLES * MAX_LANES)
    megakernel_kernel(const T* __restrict__ in, const int* __restrict__ i_in,
                      const T* __restrict__ P, const T* __restrict__ G,
                      T* __restrict__ out, int* __restrict__ i_out, int B,
                      int n_params, double dt, double t_start, int comp,
                      const T* __restrict__ gains, int spp, double pdt) {
  using M = MegaL<ACT>;
  using L = SysL<ACT>;
  T* sP = block_shared<T>();
  T* sh = sP + n_params;
  share_params(P, n_params, sP);  // published by the first stage's barrier
  const RoleThread t = role_thread(B);
  const Col<T> c{in, B, t.b};
  const Out<T> o{out, B, t.b};
  // x and the k-sum live in the scratch, each thread its role's rows of its
  // lane (no other thread touches them); k_prev stays in registers
  const Col<T> sx{sh + M::SH_X * t.L, t.L, t.lane};
  const Col<T> ss{sh + M::SH_KSUM * t.L, t.L, t.lane};
  const Out<T> sxo{sh + M::SH_X * t.L, t.L, t.lane};
  const Out<T> sso{sh + M::SH_KSUM * t.L, t.L, t.lane};
  T x[N_SLOTS], kprev[N_SLOTS], acc[N_SLOTS];
  load_slots<ACT>(c, M::X, t.role, x);
  store_slots<ACT>(sxo, 0, t.role, x);
#pragma unroll
  for (int k = 0; k < N_SLOTS; ++k) kprev[k] = acc[k] = T(0);
  store_slots<ACT>(sso, 0, t.role, acc);

  // the four stages; stage offsets and weights as in clusterstep.py:124-125,
  // the k-sum ((((0 + k1) + 2 k2) + 2 k3) + k4) as the plain step forms it
#pragma unroll 1
  for (int s = 0; s < 4; ++s) {
    const T cs = T(s == 0 ? 0.0 : (s == 3 ? dt : 0.5 * dt));
    const T w = T(s == 0 || s == 3 ? 1.0 : 2.0);
    T xi[N_SLOTS];
    load_slots<ACT>(sx, 0, t.role, x);
#pragma unroll
    for (int k = 0; k < N_SLOTS; ++k) xi[k] = x[k] + cs * kprev[k];
    f_ode_roles<ACT>(sP, sh, t, xi, c, M::CTX, kprev);
    load_slots<ACT>(ss, 0, t.role, acc);
#pragma unroll
    for (int k = 0; k < N_SLOTS; ++k) acc[k] = acc[k] + w * kprev[k];
    store_slots<ACT>(sso, 0, t.role, acc);
  }

  T xn[N_SLOTS];
  FinishOut<T> f;
  load_slots<ACT>(sx, 0, t.role, x);
  load_slots<ACT>(ss, 0, t.role, acc);
  finish_roles<true, ACT>(sP, G, sh, t, x, acc, T(dt / 6.0), comp != 0, c,
                          M::CTX, M::C, xn, f);
  if constexpr (ACT == ACT_FBW) {
    // what the control laws read of the new state, into the scratch
    share_ctl_y(sP, Out<T>{sh + M::SH_Y * t.L, t.L, t.lane}, c,
                M::CTX + CX_USYS, t, xn, f);
    __syncthreads();
  }
  if (!t.valid) return;  // past the last barrier

  store_slots<ACT>(o, M::X, t.role, xn);
  // inputs and terrain pass through, a few rows per role (the fly-by-wire
  // instance's four commands come from the pass); the discrete state, the
  // undulation and the latch come from the roles that made them
  for (int r = t.role; r < L::CX_SSYS; r += N_ROLES) {
    if constexpr (ACT == ACT_FBW) {
      if (r == fbw_cmd_row(CH_AIL) || r == fbw_cmd_row(CH_ELV) ||
          r == fbw_cmd_row(CH_RUD) || r == fbw_cmd_row(CH_THR))
        continue;
    }
    o.s(M::CTX + r, c(M::CTX + r));
  }
  if (t.role == ROLE_AERO) {
    o.s(M::CTX + L::CX_SSYS + SS_STALL, T(f.s.stall ? 1.0 : 0.0));
  } else if (t.role == ROLE_ENG) {
    o.s(M::CTX + L::CX_SSYS + SS_STATE, T(double(f.s.state)));
  } else if (t.role == ROLE_KIN) {
    const int i_new = i_in[t.b] + 1;
    o.s(MG_T, T(t_start) + T(double(i_new)) * T(dt));
    o.s(M::CTX + L::CX_SSYS + SS_CRASHED, T(f.s.crashed ? 1.0 : 0.0));
    o.s(M::CTX + L::CX_GEOID, f.geoid_N);
    o.s(M::CTX + L::CX_TERM, f.term);
    o.q4(M::C, f.r_q);
    o.s(M::C + 4, f.r_h);
    i_out[t.b] = i_new;
  }
  if constexpr (ACT == ACT_FBW) {
    // the periodic pass where the counter the step makes is a multiple of
    // steps_per_periodic (core/sim.py::Simulation.step): lon in one warp,
    // lat in another
    if (t.role == ROLE_LON || t.role == ROLE_LAT) {
      const bool fires = (i_in[t.b] + 1) % spp == 0;
      const Col<T> y{sh + M::SH_Y * t.L, t.L, t.lane};
      periodic_side(t.role == ROLE_LON, fires, gains, y, c, o, M::AV,
                    M::CTX + CX_USYS, T(pdt));
    }
  }
}

template <int ACT, typename T>
static int launch(const void* in, const void* i_in, const void* params,
                  const void* grid_, const void* gains, void* out,
                  void* i_out, int B, int n_params, double dt,
                  double t_start, int comp, int spp, double pdt, int lanes,
                  void* stream) {
  if (B <= 0) return 0;
  if (lanes <= 0 || lanes > MAX_LANES || lanes % 32 != 0 || spp < 1)
    return (int)cudaErrorInvalidValue;
  const RoleLaunch l = role_launch(B, lanes, n_params, (int)sizeof(T),
                                   MegaL<ACT>::SH_ROWS);
  // the attribute belongs to the device in use, so every launch sets it
  const cudaError_t err = cudaFuncSetAttribute(
      megakernel_kernel<ACT, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      l.shared);
  if (err != cudaSuccess) return (int)err;
  megakernel_kernel<ACT, T><<<l.grid, l.block, l.shared,
                              (cudaStream_t)stream>>>(
      (const T*)in, (const int*)i_in, (const T*)params, (const T*)grid_,
      (T*)out, (int*)i_out, B, n_params, dt, t_start, comp, (const T*)gains,
      spp, pdt);
  return (int)cudaGetLastError();
}

extern "C" {
int megakernel_f32(const void* in, const void* i_in, const void* params,
                   const void* grid, void* out, void* i_out, int B,
                   int n_params, double dt, double t_start, int comp,
                   int lanes, void* stream) {
  return launch<ACT_MECH, SF>(in, i_in, params, grid, nullptr, out, i_out, B,
                              n_params, dt, t_start, comp, 1, 0.0, lanes,
                              stream);
}
int megakernel_f64(const void* in, const void* i_in, const void* params,
                   const void* grid, void* out, void* i_out, int B,
                   int n_params, double dt, double t_start, int comp,
                   int lanes, void* stream) {
  return launch<ACT_MECH, SD>(in, i_in, params, grid, nullptr, out, i_out, B,
                              n_params, dt, t_start, comp, 1, 0.0, lanes,
                              stream);
}
// the fly-by-wire instance also takes the control laws' gains, their
// steps per periodic pass and their interval
int megakernel_fbw_f32(const void* in, const void* i_in, const void* params,
                       const void* grid, const void* gains, void* out,
                       void* i_out, int B, int n_params, double dt,
                       double t_start, int comp, int spp, double pdt,
                       int lanes, void* stream) {
  return launch<ACT_FBW, SF>(in, i_in, params, grid, gains, out, i_out, B,
                             n_params, dt, t_start, comp, spp, pdt, lanes,
                             stream);
}
int megakernel_fbw_f64(const void* in, const void* i_in, const void* params,
                       const void* grid, const void* gains, void* out,
                       void* i_out, int B, int n_params, double dt,
                       double t_start, int comp, int spp, double pdt,
                       int lanes, void* stream) {
  return launch<ACT_FBW, SD>(in, i_in, params, grid, gains, out, i_out, B,
                             n_params, dt, t_start, comp, spp, pdt, lanes,
                             stream);
}
void megakernel_layout(int* n_in, int* n_out) {
  *n_in = MEGA_N_ROWS;
  *n_out = MEGA_N_ROWS;
}
void megakernel_fbw_layout(int* n_in, int* n_out) {
  *n_in = MEGA_N_ROWS_FBW;
  *n_out = MEGA_N_ROWS_FBW;
}
void megakernel_launch_shape(int B, int lanes, int n_params, int elem_size,
                             int* grid, int* block, int* shared) {
  put_launch(role_launch(B, lanes, n_params, elem_size, SH_MEGA_N), grid,
             block, shared);
}
void megakernel_fbw_launch_shape(int B, int lanes, int n_params,
                                 int elem_size, int* grid, int* block,
                                 int* shared) {
  put_launch(role_launch(B, lanes, n_params, elem_size,
                         MegaL<ACT_FBW>::SH_ROWS),
             grid, block, shared);
}
// the whole-vehicle row groups: X, CTX, C and the megakernel's state buffer,
// of the C172S and of the fly-by-wire C172
void vehicle_layout(int* n_x, int* n_ctx, int* n_c, int* n_mega) {
  *n_x = N_X;
  *n_ctx = N_CTX;
  *n_c = N_C;
  *n_mega = MEGA_N_ROWS;
}
void vehicle_fbw_layout(int* n_x, int* n_ctx, int* n_c, int* n_mega) {
  *n_x = N_X_FBW;
  *n_ctx = N_CTX_FBW;
  *n_c = N_C;
  *n_mega = MEGA_N_ROWS_FBW;
}
}
