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
// (clusterstep.py:467-470). Plain PyTorch version:
// flightjax_torch/parallel/kernels.py::finish_sys_plain.
//
// What bounds it on the H100: neither bytes (115 input and 15 output rows
// per lane, 2.1 MB in float32 at B = 4096, about 0.6 us of HBM) nor
// operations, but the latency of one aircraft's chain. With one thread per
// aircraft it ran three struts of quaternion algebra in a row (the long
// chain on a lane with a wheel on the ground), then the stall hysteresis and
// the engine state machine, every thread loading all 115 rows; and 4096
// threads in 128-thread blocks filled 32 of the 132 SMs.
//
// What the design does about it: the TPU's fine split, as warps of one
// block. Five threads carry one aircraft, one warp each per 32 aircraft:
// each leg warp combines its own two regulator rows, runs its strut (skipped
// where no wheel of the warp is on the ground, strut_y), resets its
// regulator off the ground and puts its crash flag in shared memory; the
// REST warp combines the airflow filter rows and runs the stall hysteresis,
// the ENG warp the fuel and engine rows and the engine state machine; after
// the one barrier REST latches `crashed` from the input flag and the legs'
// flags (the engine in REST's warp measured 0.3-0.4 us slower airborne).
// The parts are those finish_roles runs (c172_systems.cuh), so each row is
// bit-identical to the one-thread form.
// Every role loads only the rows it reads, before the barrier; the few
// parameters come through the read-only cache (no shared-memory copy); a
// ragged last block masks its stores and no thread leaves before the
// barrier. PERF.md records the times on the card, beside the one-thread
// form's (tools/ablate_torch_roles.py, `finish_sys_thread`).
//
// The fly-by-wire instance (finish_sys_fbw, ACT_FBW) also combines the
// seven servo states (the REST warp) and steers the nose leg by its
// rudder servo's position after the combine, which the nose-leg warp forms
// itself; and it stores what the C172X's avionics read of the new state
// (SYS_Y): REST the gated airflow angles, each leg its weight on wheels.
#include "c172_systems.cuh"

using namespace fj;

// input rows: x_sys, ksum_sys, u_sys, s_sys, terrain, KinData, AirData;
// output rows: x_sys, s_sys (and SYS_Y, fly-by-wire)
template <int ACT>
struct FsRows {
  enum : int {
    FI_X = 0,
    FI_K = FI_X + SysL<ACT>::NX,
    FI_U = FI_K + SysL<ACT>::NX,
    FI_S = FI_U + SysL<ACT>::NU,
    FI_TRN = FI_S + N_SSYS,
    FI_KIN = FI_TRN + N_TRN,
    FI_AIR = FI_KIN + N_KIN,
    FO_X = 0,
    FO_S = SysL<ACT>::NX,
    FO_Y = FO_S + N_SSYS
  };
};
// finish_sys's roles and the warp of each 32 aircraft that runs it:
//   FS_LEG0+j  gear leg j: its two regulator rows and its crash flag
//   FS_REST    alpha_filt, beta_filt, the stall hysteresis, and the crash
//              latch after the barrier
//   FS_ENG     fuel, the engine's regulator, idle and shaft speed rows and
//              the engine state machine
// (FS_ENG = FS_REST, four warps, measured slower: PERF.md)
constexpr int FS_LEG0 = 0, FS_REST = N_LEGS, FS_ENG = FS_REST + 1,
              FS_ROLES = N_LEGS + 2;

template <int ACT, typename T>
__device__ __forceinline__ T combine(const Col<T>& c, int r, T c6) {
  return c(FsRows<ACT>::FI_X + r) + c6 * c(FsRows<ACT>::FI_K + r);
}

template <int ACT, typename T>
__global__ void __launch_bounds__(FS_ROLES * MAX_LANES)
    finish_sys_kernel(const T* __restrict__ in, const T* __restrict__ P,
                      T* __restrict__ out, int B, T c6) {
  using R = FsRows<ACT>;
  const RoleThread t = role_thread(B, FS_ROLES);
  const Col<T> c{in, B, t.b};
  const Out<T> o{out, B, t.b};
  T* sh = block_shared<T>();  // the legs' crash flags, [N_LEGS, L]
  T u[SysL<ACT>::NU];
#pragma unroll
  for (int r = 0; r < SysL<ACT>::NU; ++r) u[r] = c(R::FI_U + r);
  bool crashed = false;
  if (t.role < FS_LEG0 + N_LEGS) {
    const int leg = t.role - FS_LEG0, r = XS_FRC + 2 * leg;
    T frc_x = combine<ACT>(c, r, c6), frc_y = combine<ACT>(c, r + 1, c6);
    T steer_fbw = T(0.0);
    if constexpr (ACT == ACT_FBW)
      if (leg == 2)
        steer_fbw =
            servo_pos(P, CH_RUD, combine<ACT>(c, XS_ACT + CH_RUD, c6));
    bool wow;
    const bool crash = finish_leg<ACT>(P, leg, u, steer_fbw,
                                       load_kin(c, R::FI_KIN),
                                       load_trn(c, R::FI_TRN), frc_x, frc_y,
                                       wow);
    Out<T>{sh, t.L, t.lane}.s(leg, T(crash ? 1.0 : 0.0));
    if (t.valid) {
      o.s(R::FO_X + r, frc_x);
      o.s(R::FO_X + r + 1, frc_y);
      if constexpr (ACT == ACT_FBW)
        o.s(R::FO_Y + SY_WOW + leg, T(wow ? 1.0 : 0.0));
    }
  }
  if (t.role == FS_REST) {
    const T alpha = combine<ACT>(c, XS_ALPHA, c6),
            beta = combine<ACT>(c, XS_BETA, c6);
    const Air<T> air = load_air(c, R::FI_AIR);
    const bool stall = finish_stall(P, air, c(R::FI_S + SS_STALL).v != 0);
    crashed = c(R::FI_S + SS_CRASHED).v != 0;
    if (t.valid) {
      o.s(R::FO_X + XS_ALPHA, alpha);
      o.s(R::FO_X + XS_BETA, beta);
      o.s(R::FO_S + SS_STALL, T(stall ? 1.0 : 0.0));
    }
    if constexpr (ACT == ACT_FBW) {  // the servos, the airflow angles
      T a, b;
      V3<T> v_safe;
      alpha_gated(air, a, b, v_safe);
      if (t.valid) {
#pragma unroll
        for (int k = 0; k < N_ACT; ++k)
          o.s(R::FO_X + XS_ACT + k, combine<ACT>(c, XS_ACT + k, c6));
        o.s(R::FO_Y + SY_ALPHA, a);
        o.s(R::FO_Y + SY_BETA, b);
      }
    }
  }
  if (t.role == FS_ENG) {
    const T fuel = combine<ACT>(c, XS_FUEL, c6),
            efrc = combine<ACT>(c, XS_EFRC, c6),
            idle = combine<ACT>(c, XS_IDLE, c6),
            omega = combine<ACT>(c, XS_OMEGA, c6);
    const int state =
        finish_engine<ACT>(P, int(c(R::FI_S + SS_STATE).v), fuel, omega, u);
    if (t.valid) {
      o.s(R::FO_X + XS_FUEL, fuel);
      o.s(R::FO_X + XS_EFRC, efrc);
      o.s(R::FO_X + XS_IDLE, idle);
      o.s(R::FO_X + XS_OMEGA, omega);
      o.s(R::FO_S + SS_STATE, T(double(state)));
    }
  }
  __syncthreads();
  if (t.role == FS_REST && t.valid) {
    // in the one-thread order: the input flag, then legs 0, 1, 2
    const Col<T> si{sh, t.L, t.lane};
    crashed = crashed || si(0).v != 0 || si(1).v != 0 || si(2).v != 0;
    o.s(R::FO_S + SS_CRASHED, T(crashed ? 1.0 : 0.0));
  }
}

template <int ACT, typename T>
static int launch(const void* in, const void* params, void* out, int B,
                  double c6, int lanes, void* stream) {
  if (B <= 0) return 0;
  if (lanes <= 0 || lanes > MAX_LANES || lanes % 32 != 0)
    return (int)cudaErrorInvalidValue;
  const RoleLaunch l =
      role_launch(B, lanes, FS_ROLES, N_LEGS * lanes * (int)sizeof(T));
  finish_sys_kernel<ACT, T><<<l.grid, l.block, l.shared,
                              (cudaStream_t)stream>>>(
      (const T*)in, (const T*)params, (T*)out, B, T(c6));
  return (int)cudaGetLastError();
}

extern "C" {
int finish_sys_f32(const void* in, const void* params, void* out, int B,
                   double c6, int lanes, void* stream) {
  return launch<ACT_MECH, SF>(in, params, out, B, c6, lanes, stream);
}
int finish_sys_f64(const void* in, const void* params, void* out, int B,
                   double c6, int lanes, void* stream) {
  return launch<ACT_MECH, SD>(in, params, out, B, c6, lanes, stream);
}
int finish_sys_fbw_f32(const void* in, const void* params, void* out, int B,
                       double c6, int lanes, void* stream) {
  return launch<ACT_FBW, SF>(in, params, out, B, c6, lanes, stream);
}
int finish_sys_fbw_f64(const void* in, const void* params, void* out, int B,
                       double c6, int lanes, void* stream) {
  return launch<ACT_FBW, SD>(in, params, out, B, c6, lanes, stream);
}
void finish_sys_layout(int* n_in, int* n_out) {
  *n_in = FSYS_N_IN;
  *n_out = FSYS_N_OUT;
}
void finish_sys_fbw_layout(int* n_in, int* n_out) {
  *n_in = FSYS_N_IN_FBW;
  *n_out = FSYS_N_OUT_FBW;
}
// its parameters stay in device memory, so n_params is not read
void finish_sys_launch_shape(int B, int lanes, int, int elem_size, int* grid,
                             int* block, int* shared) {
  put_launch(role_launch(B, lanes, FS_ROLES, N_LEGS * lanes * elem_size),
             grid, block, shared);
}
void finish_sys_fbw_launch_shape(int B, int lanes, int, int elem_size,
                                 int* grid, int* block, int* shared) {
  put_launch(role_launch(B, lanes, FS_ROLES, N_LEGS * lanes * elem_size),
             grid, block, shared);
}
}
