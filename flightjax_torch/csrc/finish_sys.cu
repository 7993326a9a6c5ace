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
#include "c172_systems.cuh"

using namespace fj;

// input rows
constexpr int FI_X = 0, FI_K = FI_X + N_XSYS, FI_U = FI_K + N_XSYS,
              FI_S = FI_U + N_USYS, FI_TRN = FI_S + N_SSYS,
              FI_KIN = FI_TRN + N_TRN, FI_AIR = FI_KIN + N_KIN;
// output rows
constexpr int FO_X = 0, FO_S = N_XSYS;
// finish_sys's roles and the warp of each 32 aircraft that runs it:
//   FS_LEG0+j  gear leg j: its two regulator rows and its crash flag
//   FS_REST    alpha_filt, beta_filt, the stall hysteresis, and the crash
//              latch after the barrier
//   FS_ENG     fuel, the engine's regulator, idle and shaft speed rows and
//              the engine state machine
// (FS_ENG = FS_REST, four warps, measured slower: PERF.md)
constexpr int FS_LEG0 = 0, FS_REST = N_LEGS, FS_ENG = FS_REST + 1,
              FS_ROLES = N_LEGS + 2;

template <typename T>
__device__ __forceinline__ T combine(const Col<T>& c, int r, T c6) {
  return c(FI_X + r) + c6 * c(FI_K + r);
}

template <typename T>
__global__ void __launch_bounds__(FS_ROLES * MAX_LANES)
    finish_sys_kernel(const T* __restrict__ in, const T* __restrict__ P,
                      T* __restrict__ out, int B, T c6) {
  const RoleThread t = role_thread(B, FS_ROLES);
  const Col<T> c{in, B, t.b};
  const Out<T> o{out, B, t.b};
  T* sh = block_shared<T>();  // the legs' crash flags, [N_LEGS, L]
  T u[N_USYS];
#pragma unroll
  for (int r = 0; r < N_USYS; ++r) u[r] = c(FI_U + r);
  bool crashed = false;
  if (t.role < FS_LEG0 + N_LEGS) {
    const int leg = t.role - FS_LEG0, r = XS_FRC + 2 * leg;
    T frc_x = combine(c, r, c6), frc_y = combine(c, r + 1, c6);
    const bool crash = finish_leg(P, leg, u, load_kin(c, FI_KIN),
                                  load_trn(c, FI_TRN), frc_x, frc_y);
    Out<T>{sh, t.L, t.lane}.s(leg, T(crash ? 1.0 : 0.0));
    if (t.valid) {
      o.s(FO_X + r, frc_x);
      o.s(FO_X + r + 1, frc_y);
    }
  }
  if (t.role == FS_REST) {
    const T alpha = combine(c, XS_ALPHA, c6), beta = combine(c, XS_BETA, c6);
    const bool stall = finish_stall(P, load_air(c, FI_AIR),
                                    c(FI_S + SS_STALL).v != 0);
    crashed = c(FI_S + SS_CRASHED).v != 0;
    if (t.valid) {
      o.s(FO_X + XS_ALPHA, alpha);
      o.s(FO_X + XS_BETA, beta);
      o.s(FO_S + SS_STALL, T(stall ? 1.0 : 0.0));
    }
  }
  if (t.role == FS_ENG) {
    const T fuel = combine(c, XS_FUEL, c6), efrc = combine(c, XS_EFRC, c6),
            idle = combine(c, XS_IDLE, c6), omega = combine(c, XS_OMEGA, c6);
    const int state =
        finish_engine(P, int(c(FI_S + SS_STATE).v), fuel, omega, u);
    if (t.valid) {
      o.s(FO_X + XS_FUEL, fuel);
      o.s(FO_X + XS_EFRC, efrc);
      o.s(FO_X + XS_IDLE, idle);
      o.s(FO_X + XS_OMEGA, omega);
      o.s(FO_S + SS_STATE, T(double(state)));
    }
  }
  __syncthreads();
  if (t.role == FS_REST && t.valid) {
    // in the one-thread order: the input flag, then legs 0, 1, 2
    const Col<T> si{sh, t.L, t.lane};
    crashed = crashed || si(0).v != 0 || si(1).v != 0 || si(2).v != 0;
    o.s(FO_S + SS_CRASHED, T(crashed ? 1.0 : 0.0));
  }
}

template <typename T>
static int launch(const void* in, const void* params, void* out, int B,
                  double c6, int lanes, void* stream) {
  if (B <= 0) return 0;
  if (lanes <= 0 || lanes > MAX_LANES || lanes % 32 != 0)
    return (int)cudaErrorInvalidValue;
  const RoleLaunch l =
      role_launch(B, lanes, FS_ROLES, N_LEGS * lanes * (int)sizeof(T));
  finish_sys_kernel<T><<<l.grid, l.block, l.shared, (cudaStream_t)stream>>>(
      (const T*)in, (const T*)params, (T*)out, B, T(c6));
  return (int)cudaGetLastError();
}

extern "C" {
int finish_sys_f32(const void* in, const void* params, void* out, int B,
                   double c6, int lanes, void* stream) {
  return launch<SF>(in, params, out, B, c6, lanes, stream);
}
int finish_sys_f64(const void* in, const void* params, void* out, int B,
                   double c6, int lanes, void* stream) {
  return launch<SD>(in, params, out, B, c6, lanes, stream);
}
void finish_sys_layout(int* n_in, int* n_out) {
  *n_in = FSYS_N_IN;
  *n_out = FSYS_N_OUT;
}
// its parameters stay in device memory, so n_params is not read
void finish_sys_launch_shape(int B, int lanes, int, int elem_size, int* grid,
                             int* block, int* shared) {
  put_launch(role_launch(B, lanes, FS_ROLES, N_LEGS * lanes * elem_size),
             grid, block, shared);
}
}
