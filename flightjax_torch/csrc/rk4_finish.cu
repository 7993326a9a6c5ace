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
// with the new KinData and AirData in shared memory. Plain PyTorch version:
// flightjax_torch/parallel/kernels.py::rk4_finish_plain.
//
// What bounds it on the H100: neither bytes (68 input, 27 k-sum and 36
// output rows per lane, 2.2 MB in float32 at B = 4096, ~0.6 us of HBM) nor
// operations, but one aircraft's chain: the combine, the renormalisation,
// KinData and AirData at the new state, then three struts of quaternion
// algebra in a row. With one thread per aircraft that ran in 32 of the 132
// SMs.
//
// What the design does about it: several threads carry one aircraft, one
// warp per subsystem (c172_systems.cuh::finish_roles, as the megakernel
// finishes its step, without the geoid refresh: the vehicle path refreshes
// through geoid.cu every geoid_every steps, so the undulation passes
// through). Role KIN combines the kinematics and shares the new KinData and
// AirData; after the first barrier the three legs run their struts side by
// side with the stall and engine steps; after the second role KIN latches
// crashed and terminated. Each role stores its own rows. Every role loads
// what it reads of its lane's column before the first barrier, and no role
// of the finish reads the atmosphere, so role KIN does not work it out. The finish reads no table,
// only a few scalars of the parameter buffer, through the read-only cache:
// copying the buffer into each block's shared memory measured 0.5 us
// slower. A ragged last block masks its stores; no thread leaves before the
// barriers. PERF.md records the times on the card.
//
// The fly-by-wire instance (rk4_finish_fbw, ACT_FBW) also combines the
// C172X's seven servo states (role DRAG, which shares them for the nose
// leg's steering) and stores what the C172X's avionics read of the new
// state: role KIN the KIN_Y rows (the atmosphere is worked out for EAS),
// role AERO the gated airflow angles, each leg its weight on wheels.
//
// The turbulent instance (rk4_finish_turb, a kernel of its own: it also
// reads the int32 rows i, seed, n and the step's dt and t_start) is the same
// TPU kernel traced over the C172S with DrydenTurbulence: role KIN also
// combines the five filter states and applies their gust at the new time
// t_start + (i + 1) dt to the air data it shares (Vehicle._context), which
// the stall reads; role PROP, which has no rows of its own to finish,
// redraws the held drive for the new counter n + 1 from the lane's seed
// (DrydenTurbulence.f_step: two fold_ins and three normals of the threefry
// stream, turbulence.cuh) while role KIN combines, on every lane, as
// World.f_step does. The new drive follows the C172S's outputs; the host
// advances n.
//
// The turbulent fly-by-wire instance (rk4_finish_fbw_turb, a kernel of its
// own beside rk4_finish_turb, from the same body) is that kernel traced over
// the turbulent C172X: the fly-by-wire instance's servos and the avionics'
// KIN_Y and SYS_Y (EAS from the disturbed air data) after the residuals,
// then the new drive.
//
// The second-order elevator's instance (rk4_finish_fbw_a2, ACT_FBW_A2) is
// the same TPU kernel traced over the C172Xv1 whose elevator is an
// Actuator2: role DRAG combines the elevator's position and rate as every
// servo state, x + c6 k, and shares the positions; its rows move by one
// after the elevator's, and its outputs are the fly-by-wire instance's.
#include "c172_systems.cuh"
#include "turbulence.cuh"

using namespace fj;

// output rows: X, s_sys, term, C (and KIN_Y, SYS_Y, fly-by-wire)
template <int ACT>
struct FinRows {
  enum : int {
    RO_X = 0,
    RO_S = SysL<ACT>::NXV,
    RO_TERM = RO_S + N_SSYS,
    RO_C = RO_TERM + 1,
    RO_KY = RO_C + N_C,
    RO_SY = RO_KY + N_KINY,
    // the turbulent instances: after the residuals, or after KIN_Y and
    // SYS_Y (fly-by-wire)
    RO_ETA = RO_C + N_C + (act_fbw(ACT) ? N_KINY + N_SYSY : 0)
  };
};

template <int ACT, typename T>
__global__ void __launch_bounds__(N_ROLES * MAX_LANES)
    rk4_finish_kernel(const T* __restrict__ in, const T* __restrict__ ksum,
                      const T* __restrict__ P, T* __restrict__ out, int B,
                      T c6, int comp) {
  using R = FinRows<ACT>;
  using L = SysL<ACT>;
  const RoleThread t = role_thread(B);
  const Col<T> c{in, B, t.b};
  T x[N_SLOTS], ks[N_SLOTS], xn[N_SLOTS];
  load_slots<ACT>(c, 0, t.role, x);
  load_slots<ACT>(Col<T>{ksum, B, t.b}, 0, t.role, ks);
  FinishOut<T> f;
  finish_roles<false, ACT>(P, (const T*)nullptr, block_shared<T>(), t, x, ks,
                           c6, comp != 0, c, L::NXV, L::NXV + L::NCTX, xn,
                           f);
  if (!t.valid) return;  // past the last barrier

  const Out<T> o{out, B, t.b};
  store_slots<ACT>(o, R::RO_X, t.role, xn);
  if (t.role == ROLE_AERO) {
    o.s(R::RO_S + SS_STALL, T(f.s.stall ? 1.0 : 0.0));
    if constexpr (act_fbw(ACT)) {
      o.s(R::RO_SY + SY_ALPHA, f.alpha);
      o.s(R::RO_SY + SY_BETA, f.beta);
    }
  } else if (t.role == ROLE_ENG) {
    o.s(R::RO_S + SS_STATE, T(double(f.s.state)));
  } else if (t.role == ROLE_KIN) {
    // the residuals stay 0 uncompensated, as the plain finish leaves them
    const T z = T(0.0);
    o.s(R::RO_S + SS_CRASHED, T(f.s.crashed ? 1.0 : 0.0));
    o.s(R::RO_TERM, f.term);
    o.q4(R::RO_C, comp ? f.r_q : Q4<T>{z, z, z, z});
    o.s(R::RO_C + 4, comp ? f.r_h : z);
    if constexpr (act_fbw(ACT)) {
      o.v3(R::RO_KY + KY_OM_WB, f.om_wb);
      o.v3(R::RO_KY + KY_E_NB, f.e_nb);
      o.v3(R::RO_KY + KY_V_EB_N, f.v_eb_n);
      o.s(R::RO_KY + KY_CHI, f.chi);
      o.s(R::RO_KY + KY_EAS, f.EAS);
    }
  } else if (act_fbw(ACT) && t.role >= ROLE_LEG0) {
    o.s(R::RO_SY + SY_WOW + t.role - ROLE_LEG0, T(f.wow ? 1.0 : 0.0));
  }
}

// the turbulent instances' body (ACT_TURB, ACT_FBW_TURB); all threads of the
// block call it
template <int ACT, typename T>
__device__ __forceinline__ void rk4_finish_turb_body(
    const T* __restrict__ in, const T* __restrict__ ksum,
    const T* __restrict__ P, const int* __restrict__ ints,
    T* __restrict__ out, int B, T c6, int comp, double dt, double t_start) {
  using R = FinRows<ACT>;
  using L = SysL<ACT>;
  const RoleThread t = role_thread(B);
  const Col<T> c{in, B, t.b};
  T x[N_SLOTS], ks[N_SLOTS], xn[N_SLOTS];
  load_slots<ACT>(c, 0, t.role, x);
  load_slots<ACT>(Col<T>{ksum, B, t.b}, 0, t.role, ks);
  TurbLane<T> tl;
  T eta[N_ETA];
  if (t.role == ROLE_KIN) {
    const Col<T> kc{ksum, B, t.b};
#pragma unroll
    for (int j = 0; j < N_XTURB; ++j) {
      tl.x[j] = c(L::X_TURB + j);
      tl.k[j] = kc(L::X_TURB + j);
    }
    tl.t = T(t_start) + T(double(ints[TI_I * B + t.b] + 1)) * T(dt);
  } else if (t.role == ROLE_PROP) {
    turb_redraw(uint32_t(ints[TI_SEED * B + t.b]),
                uint32_t(ints[TI_N * B + t.b] + 1), eta);
  }
  FinishOut<T> f;
  finish_roles<false, ACT>(P, (const T*)nullptr, block_shared<T>(), t, x, ks,
                           c6, comp != 0, c, L::NXV, L::NXV + L::NCTX + 1, xn,
                           f, &tl);
  if (!t.valid) return;  // past the last barrier

  const Out<T> o{out, B, t.b};
  store_slots<ACT>(o, R::RO_X, t.role, xn);
  if (t.role == ROLE_AERO) {
    o.s(R::RO_S + SS_STALL, T(f.s.stall ? 1.0 : 0.0));
    if constexpr (act_fbw(ACT)) {
      o.s(R::RO_SY + SY_ALPHA, f.alpha);
      o.s(R::RO_SY + SY_BETA, f.beta);
    }
  } else if (t.role == ROLE_ENG) {
    o.s(R::RO_S + SS_STATE, T(double(f.s.state)));
  } else if (t.role == ROLE_PROP) {
#pragma unroll
    for (int j = 0; j < N_ETA; ++j) o.s(R::RO_ETA + j, eta[j]);
  } else if (t.role == ROLE_KIN) {
    const T z = T(0.0);
    o.s(R::RO_S + SS_CRASHED, T(f.s.crashed ? 1.0 : 0.0));
    o.s(R::RO_TERM, f.term);
    o.q4(R::RO_C, comp ? f.r_q : Q4<T>{z, z, z, z});
    o.s(R::RO_C + 4, comp ? f.r_h : z);
#pragma unroll
    for (int j = 0; j < N_XTURB; ++j) o.s(R::RO_X + L::X_TURB + j, tl.d[j]);
    if constexpr (act_fbw(ACT)) {
      o.v3(R::RO_KY + KY_OM_WB, f.om_wb);
      o.v3(R::RO_KY + KY_E_NB, f.e_nb);
      o.v3(R::RO_KY + KY_V_EB_N, f.v_eb_n);
      o.s(R::RO_KY + KY_CHI, f.chi);
      o.s(R::RO_KY + KY_EAS, f.EAS);
    }
  } else if (act_fbw(ACT) && t.role >= ROLE_LEG0) {
    o.s(R::RO_SY + SY_WOW + t.role - ROLE_LEG0, T(f.wow ? 1.0 : 0.0));
  }
}

template <typename T>
__global__ void __launch_bounds__(N_ROLES * MAX_LANES)
    rk4_finish_turb_kernel(const T* __restrict__ in,
                           const T* __restrict__ ksum,
                           const T* __restrict__ P,
                           const int* __restrict__ ints, T* __restrict__ out,
                           int B, T c6, int comp, double dt, double t_start) {
  rk4_finish_turb_body<ACT_TURB>(in, ksum, P, ints, out, B, c6, comp, dt,
                                 t_start);
}

template <typename T>
__global__ void __launch_bounds__(N_ROLES * MAX_LANES)
    rk4_finish_fbw_turb_kernel(const T* __restrict__ in,
                               const T* __restrict__ ksum,
                               const T* __restrict__ P,
                               const int* __restrict__ ints,
                               T* __restrict__ out, int B, T c6, int comp,
                               double dt, double t_start) {
  rk4_finish_turb_body<ACT_FBW_TURB>(in, ksum, P, ints, out, B, c6, comp, dt,
                                     t_start);
}

template <int ACT, typename T>
static int launch(const void* in, const void* ksum, const void* params,
                  void* out, int B, double c6, int comp, int lanes,
                  void* stream) {
  if (B <= 0) return 0;
  if (lanes <= 0 || lanes > MAX_LANES || lanes % 32 != 0)
    return (int)cudaErrorInvalidValue;
  const RoleLaunch l =
      role_launch(B, lanes, 0, (int)sizeof(T), sh_rows<ACT>());
  // the attribute belongs to the device in use, so every launch sets it
  const cudaError_t err = cudaFuncSetAttribute(
      rk4_finish_kernel<ACT, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      l.shared);
  if (err != cudaSuccess) return (int)err;
  rk4_finish_kernel<ACT, T><<<l.grid, l.block, l.shared,
                              (cudaStream_t)stream>>>(
      (const T*)in, (const T*)ksum, (const T*)params, (T*)out, B, T(c6),
      comp);
  return (int)cudaGetLastError();
}

template <typename T, bool FBW>
static int launch_turb(const void* in, const void* ksum, const void* params,
                       const void* ints, void* out, int B, double c6,
                       int comp, double dt, double t_start, int lanes,
                       void* stream) {
  if (B <= 0) return 0;
  if (lanes <= 0 || lanes > MAX_LANES || lanes % 32 != 0)
    return (int)cudaErrorInvalidValue;
  const auto kernel =
      FBW ? rk4_finish_fbw_turb_kernel<T> : rk4_finish_turb_kernel<T>;
  const RoleLaunch l =
      role_launch(B, lanes, 0, (int)sizeof(T), FBW ? SH_N_FBW : SH_N);
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, l.shared);
  if (err != cudaSuccess) return (int)err;
  kernel<<<l.grid, l.block, l.shared, (cudaStream_t)stream>>>(
      (const T*)in, (const T*)ksum, (const T*)params, (const int*)ints,
      (T*)out, B, T(c6), comp, dt, t_start);
  return (int)cudaGetLastError();
}

extern "C" {
int rk4_finish_turb_f32(const void* in, const void* ksum, const void* params,
                        const void* ints, void* out, int B, double c6,
                        int comp, double dt, double t_start, int lanes,
                        void* stream) {
  return launch_turb<SF, false>(in, ksum, params, ints, out, B, c6, comp,
                                dt, t_start, lanes, stream);
}
int rk4_finish_turb_f64(const void* in, const void* ksum, const void* params,
                        const void* ints, void* out, int B, double c6,
                        int comp, double dt, double t_start, int lanes,
                        void* stream) {
  return launch_turb<SD, false>(in, ksum, params, ints, out, B, c6, comp,
                                dt, t_start, lanes, stream);
}
int rk4_finish_fbw_turb_f32(const void* in, const void* ksum,
                            const void* params, const void* ints, void* out,
                            int B, double c6, int comp, double dt,
                            double t_start, int lanes, void* stream) {
  return launch_turb<SF, true>(in, ksum, params, ints, out, B, c6, comp, dt,
                               t_start, lanes, stream);
}
int rk4_finish_fbw_turb_f64(const void* in, const void* ksum,
                            const void* params, const void* ints, void* out,
                            int B, double c6, int comp, double dt,
                            double t_start, int lanes, void* stream) {
  return launch_turb<SD, true>(in, ksum, params, ints, out, B, c6, comp, dt,
                               t_start, lanes, stream);
}
void rk4_finish_fbw_turb_layout(int* n_in, int* n_out) {
  *n_in = RKFIN_N_IN_FBW_TURB;
  *n_out = RKFIN_N_OUT_FBW_TURB;
}
void rk4_finish_fbw_turb_launch_shape(int B, int lanes, int n_params,
                                      int elem_size, int* grid, int* block,
                                      int* shared) {
  put_launch(role_launch(B, lanes, 0, elem_size, SH_N_FBW), grid, block,
             shared);
}
void rk4_finish_turb_layout(int* n_in, int* n_out) {
  *n_in = RKFIN_N_IN_TURB;
  *n_out = RKFIN_N_OUT_TURB;
}
void rk4_finish_turb_launch_shape(int B, int lanes, int n_params,
                                  int elem_size, int* grid, int* block,
                                  int* shared) {
  put_launch(role_launch(B, lanes, 0, elem_size, SH_N), grid, block, shared);
}
int rk4_finish_fbw_a2_f32(const void* in, const void* ksum,
                          const void* params, void* out, int B, double c6,
                          int comp, int lanes, void* stream) {
  return launch<ACT_FBW_A2, SF>(in, ksum, params, out, B, c6, comp, lanes,
                                stream);
}
int rk4_finish_fbw_a2_f64(const void* in, const void* ksum,
                          const void* params, void* out, int B, double c6,
                          int comp, int lanes, void* stream) {
  return launch<ACT_FBW_A2, SD>(in, ksum, params, out, B, c6, comp, lanes,
                                stream);
}
void rk4_finish_fbw_a2_layout(int* n_in, int* n_out) {
  using L = SysL<ACT_FBW_A2>;
  *n_in = L::NXV + L::NCTX + N_C;
  *n_out = FinRows<ACT_FBW_A2>::RO_SY + N_SYSY;
}
void rk4_finish_fbw_a2_launch_shape(int B, int lanes, int n_params,
                                    int elem_size, int* grid, int* block,
                                    int* shared) {
  put_launch(role_launch(B, lanes, 0, elem_size, sh_rows<ACT_FBW_A2>()),
             grid, block, shared);
}
int rk4_finish_f32(const void* in, const void* ksum, const void* params,
                   void* out, int B, double c6, int comp, int lanes,
                   void* stream) {
  return launch<ACT_MECH, SF>(in, ksum, params, out, B, c6, comp, lanes,
                              stream);
}
int rk4_finish_f64(const void* in, const void* ksum, const void* params,
                   void* out, int B, double c6, int comp, int lanes,
                   void* stream) {
  return launch<ACT_MECH, SD>(in, ksum, params, out, B, c6, comp, lanes,
                              stream);
}
int rk4_finish_fbw_f32(const void* in, const void* ksum, const void* params,
                       void* out, int B, double c6, int comp, int lanes,
                       void* stream) {
  return launch<ACT_FBW, SF>(in, ksum, params, out, B, c6, comp, lanes,
                             stream);
}
int rk4_finish_fbw_f64(const void* in, const void* ksum, const void* params,
                       void* out, int B, double c6, int comp, int lanes,
                       void* stream) {
  return launch<ACT_FBW, SD>(in, ksum, params, out, B, c6, comp, lanes,
                             stream);
}
void rk4_finish_layout(int* n_in, int* n_out) {
  *n_in = RKFIN_N_IN;
  *n_out = RKFIN_N_OUT;
}
void rk4_finish_fbw_layout(int* n_in, int* n_out) {
  *n_in = RKFIN_N_IN_FBW;
  *n_out = RKFIN_N_OUT_FBW;
}
// its parameters stay in device memory, so n_params is not read
void rk4_finish_launch_shape(int B, int lanes, int n_params, int elem_size,
                             int* grid, int* block, int* shared) {
  put_launch(role_launch(B, lanes, 0, elem_size, SH_N), grid, block, shared);
}
void rk4_finish_fbw_launch_shape(int B, int lanes, int n_params,
                                 int elem_size, int* grid, int* block,
                                 int* shared) {
  put_launch(role_launch(B, lanes, 0, elem_size, SH_N_FBW), grid, block,
             shared);
}
}
