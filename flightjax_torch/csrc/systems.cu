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
// fine parts run side by side as roles of one block (below). Plain PyTorch
// version:
// flightjax_torch/parallel/kernels.py::systems_plain.
//
// What bounds it on the H100: neither bytes (116 input and 34 output rows
// per lane, 2.4 MB in float32 at B = 4096, ~0.7 us of HBM) nor operations
// (a few thousand per lane), but the chain of one aircraft's systems:
// actuation, aero with about twenty table lookups, three gear legs of
// quaternion algebra, the engine, the propeller and the mass sum. With one
// thread per aircraft that chain ran in a row, in 32 of the 132 SMs.
//
// What the design does about it: several threads carry one aircraft, one
// warp per subsystem (the roles of c172_systems.cuh, the same source
// rk4_stage and the megakernel run: subsystem_roles). A block of `lanes`
// aircraft runs N_ROLES x lanes threads; the chain is the longest
// subsystem instead of all of them, and eight times as many warps are
// resident. Each role forms the stage state x + adt k of its own rows and
// stores its own rows of the derivative. Role KIN, which owns no rows here,
// shares the KinData and AirData rows the systems read and, after the
// second barrier, sums the wrench in the one-thread order, so the result is
// bit-identical to it; role PROP stores the mass properties and the rotor
// momentum. The parameter buffer with its tables is copied into shared
// memory once per block. A ragged last block masks its stores; no thread
// leaves before the barriers. PERF.md records ptxas's registers and the
// times on the card.
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
__global__ void __launch_bounds__(N_ROLES * MAX_LANES)
    systems_kernel(const T* __restrict__ in, const T* __restrict__ P,
                   T* __restrict__ out, int B, int n_params, T adt) {
  T* sP = block_shared<T>();
  T* sh = sP + n_params;
  share_params(P, n_params, sP);  // published by the first barrier
  const RoleThread t = role_thread(B);
  const Col<T> c{in, B, t.b};
  const T alive = T(1.0) - c(SI_TERM);
  // the stage state of the role's rows; a role's slots hold rows of X, the
  // systems' rows from X_SYS on (role KIN owns none of them)
  T xi[N_SLOTS], d[N_SLOTS];
#pragma unroll
  for (int k = 0; k < N_SLOTS; ++k) xi[k] = d[k] = T(0);
  T tau_shaft;
  if (t.role == ROLE_KIN) {
    share_kin_air(Out<T>{sh, t.L, t.lane}, load_kin(c, SI_KIN),
                  load_air(c, SI_AIR));
  } else {
    T x[N_SLOTS], kp[N_SLOTS];
    load_slots(c, SI_X - X_SYS, t.role, x);
    load_slots(c, SI_K - X_SYS, t.role, kp);
#pragma unroll
    for (int k = 0; k < N_SLOTS; ++k) xi[k] = x[k] + adt * kp[k];
    subsystem_roles_share(sh, t, xi);
  }
  __syncthreads();
  if (t.role != ROLE_KIN)
    subsystem_roles(sP, sh, t, xi, c, SI_U, SI_S, SI_TRN, alive, tau_shaft,
                    d);
  __syncthreads();
  subsystem_roles_shaft(sP, sh, t, alive, tau_shaft, d);
  if (!t.valid) return;  // past the last barrier

  const Col<T> si{sh, t.L, t.lane};
  const Out<T> o{out, B, t.b};
  if (t.role == ROLE_KIN) {
    V3<T> F_b, tau_b;
    role_wrench(si, F_b, tau_b);
    o.v3(SO_WR, F_b);
    o.v3(SO_WR + 3, tau_b);
    return;
  }
  store_slots(o, SO_DOT - X_SYS, t.role, d);
  if (t.role == ROLE_PROP) {
    const MP<T> mp = role_mp(si);
    o.s(SO_MP, mp.m);
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) o.s(SO_MP + 1 + 3 * i + j, mp.J.m[i][j]);
    o.v3(SO_MP + 10, mp.r);
    o.v3(SO_HR, si.v3(SH_HR));
  }
}

template <typename T>
static int launch(const void* in, const void* params, void* out, int B,
                  int n_params, double adt, int lanes, void* stream) {
  if (B <= 0) return 0;
  if (lanes <= 0 || lanes > MAX_LANES || lanes % 32 != 0)
    return (int)cudaErrorInvalidValue;
  const RoleLaunch l = role_launch(B, lanes, n_params, (int)sizeof(T), SH_N);
  // the attribute belongs to the device in use, so every launch sets it
  const cudaError_t err = cudaFuncSetAttribute(
      systems_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      l.shared);
  if (err != cudaSuccess) return (int)err;
  systems_kernel<T><<<l.grid, l.block, l.shared, (cudaStream_t)stream>>>(
      (const T*)in, (const T*)params, (T*)out, B, n_params, T(adt));
  return (int)cudaGetLastError();
}

extern "C" {
int systems_f32(const void* in, const void* params, void* out, int B,
                int n_params, double adt, int lanes, void* stream) {
  return launch<SF>(in, params, out, B, n_params, adt, lanes, stream);
}
int systems_f64(const void* in, const void* params, void* out, int B,
                int n_params, double adt, int lanes, void* stream) {
  return launch<SD>(in, params, out, B, n_params, adt, lanes, stream);
}
void systems_layout(int* n_in, int* n_out) {
  *n_in = SYS_N_IN;
  *n_out = SYS_N_OUT;
}
void systems_launch_shape(int B, int lanes, int n_params, int elem_size,
                          int* grid, int* block, int* shared) {
  put_launch(role_launch(B, lanes, n_params, elem_size, SH_N), grid,
             block, shared);
}
// the parameter buffer's fixed head: scalars, then one offset per table
void systems_params_layout(int* n_head, int* n_tables) {
  *n_head = P_HEAD;
  *n_tables = TB_N;
}
}
