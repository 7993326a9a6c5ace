// rk4_stage: one RK4 stage of the whole vehicle -- the stage state
// x + adt k_prev on all 27 states, then kinematics, atmosphere and air data,
// the C172 systems and Newton-Euler dynamics (World.f_ode), with every
// derivative zeroed on terminated lanes.
//
// Replaces the TPU kernel `rk4_stage` of flightjax/parallel/clusterstep.py
// (lane function `stage_lane`, clusterstep.py:81-93, built through
// pallas_block), the stage kernel of the split="vehicle" path. One launch
// does what kinair -> systems -> dynamics do in three. Plain PyTorch
// version: flightjax_torch/parallel/kernels.py::rk4_stage_plain.
//
// What bounds it on the H100: neither bytes (63 input, 27 k_prev and 27
// output rows per lane, 1.9 MB in float32 at B = 4096, ~0.6 us of HBM) nor
// operations (~4,800 per lane). With one thread per aircraft the time was
// that of one warp walking the whole chain kinematics -> air data -> aero ->
// three legs -> propeller -> engine -> mass -> dynamics, whatever the block
// size: IEEE divisions, square roots, library calls and about twenty table
// lookups that indexed their per-axis arrays through local memory.
//
// What the design does about it: several threads carry one aircraft, one
// warp per subsystem (the roles of c172_systems.cuh). A block of `lanes`
// aircraft runs N_ROLES x lanes threads; the chain is kinematics + air data
// -> the longest subsystem -> dynamics instead of all of them in a row, and
// eight times as many warps are resident. KinData, AirData, the wrenches and
// the mass properties cross roles through shared memory, two barriers per
// launch; the sums are formed in the one-thread order, so the result is
// bit-identical to it. The parameter buffer with its tables is copied into
// shared memory once per block; the table lookup knows its rank at compile
// time and is one function, not twenty inlined copies: the warps of a block
// run different code here, and code size showed in the time
// (flight_math.cuh::lookup). A gear leg skips its strut where no lane of its
// warp has a wheel on the ground (c172_systems.cuh::strut_y). A ragged last
// block masks its stores; no thread leaves before the barriers. PERF.md records ptxas's registers and the
// times on the card.
//
// The fly-by-wire instance (rk4_stage_fbw, ACT_FBW) carries the C172X's
// seven servo states in role DRAG's slots: it forms their stage point,
// shares it before the first barrier for the roles that read a servo's
// position, and stores their derivatives.
//
// The turbulent instance (rk4_stage_turb, ACT_TURB) is the same TPU kernel
// traced over the C172S with DrydenTurbulence (stage_lane over
// Vehicle.f_ode with the disturbance chain, aircraftbase.py:167-241). Its X
// holds the five filter states after the systems rows, its CTX the
// turbulence's inputs and held drive after the latch, and the step's start
// time follows CTX, for the discrete gust at the stage time t + adt. Role
// KIN forms the filters' stage state, works out the height above the
// terrain, the sheared mean wind, the airspeed relative to it, the Dryden
// derivative (x alive) and the gust, and shares the disturbed air data
// (turbulence.cuh::turb_air); the other roles are the C172S's.
//
// The turbulent fly-by-wire instance (rk4_stage_fbw_turb, ACT_FBW_TURB) is
// the same TPU kernel traced over the turbulent C172X
// (c172x.build_vehicle(turbulence=)): the fly-by-wire instance's rows and
// role DRAG's servos, with role KIN's filters and disturbed air data as in
// the turbulent one. Its drive's scale follows the servos in the
// parameters; its scratch is the fly-by-wire one.
#include "c172_systems.cuh"
#include "turbulence.cuh"

using namespace fj;

template <int ACT, typename T>
__global__ void __launch_bounds__(N_ROLES * MAX_LANES)
    rk4_stage_kernel(const T* __restrict__ in, const T* __restrict__ k,
                     const T* __restrict__ P, T* __restrict__ out, int B,
                     int n_params, T adt) {
  T* sP = block_shared<T>();
  share_params(P, n_params, sP);  // published by the stage's first barrier
  const RoleThread t = role_thread(B);
  const Col<T> c{in, B, t.b};
  T x[N_SLOTS], kp[N_SLOTS], xi[N_SLOTS], d[N_SLOTS];
  load_slots<ACT>(c, 0, t.role, x);
  load_slots<ACT>(Col<T>{k, B, t.b}, 0, t.role, kp);
#pragma unroll
  for (int s = 0; s < N_SLOTS; ++s) {
    xi[s] = x[s] + adt * kp[s];
    d[s] = T(0);
  }
  using L = SysL<ACT>;
  if constexpr (act_turb(ACT)) {
    // role KIN's filter states at the stage point and the stage time
    TurbLane<T> tl;
    if (t.role == ROLE_KIN) {
      const Col<T> kc{k, B, t.b};
#pragma unroll
      for (int j = 0; j < N_XTURB; ++j)
        tl.x[j] = c(L::X_TURB + j) + adt * kc(L::X_TURB + j);
      tl.t = c(L::NXV + L::NCTX) + adt;
    }
    f_ode_roles<ACT>(sP, sP + n_params, t, xi, c, L::NXV, d, &tl);
    if (t.valid && t.role == ROLE_KIN) {
      const Out<T> o{out, B, t.b};
#pragma unroll
      for (int j = 0; j < N_XTURB; ++j) o.s(L::X_TURB + j, tl.d[j]);
    }
  } else {
    f_ode_roles<ACT>(sP, sP + n_params, t, xi, c, L::NXV, d);
  }
  if (t.valid) store_slots<ACT>(Out<T>{out, B, t.b}, 0, t.role, d);
}

template <int ACT, typename T>
static int launch(const void* in, const void* k, const void* params,
                  void* out, int B, int n_params, double adt, int lanes,
                  void* stream) {
  if (B <= 0) return 0;
  if (lanes <= 0 || lanes > MAX_LANES || lanes % 32 != 0)
    return (int)cudaErrorInvalidValue;
  const RoleLaunch l =
      role_launch(B, lanes, n_params, (int)sizeof(T), sh_rows<ACT>());
  // the attribute belongs to the device in use, so every launch sets it
  const cudaError_t err = cudaFuncSetAttribute(
      rk4_stage_kernel<ACT, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      l.shared);
  if (err != cudaSuccess) return (int)err;
  rk4_stage_kernel<ACT, T><<<l.grid, l.block, l.shared,
                             (cudaStream_t)stream>>>(
      (const T*)in, (const T*)k, (const T*)params, (T*)out, B, n_params,
      T(adt));
  return (int)cudaGetLastError();
}

extern "C" {
int rk4_stage_f32(const void* in, const void* k, const void* params,
                  void* out, int B, int n_params, double adt, int lanes,
                  void* stream) {
  return launch<ACT_MECH, SF>(in, k, params, out, B, n_params, adt, lanes,
                              stream);
}
int rk4_stage_f64(const void* in, const void* k, const void* params,
                  void* out, int B, int n_params, double adt, int lanes,
                  void* stream) {
  return launch<ACT_MECH, SD>(in, k, params, out, B, n_params, adt, lanes,
                              stream);
}
int rk4_stage_fbw_f32(const void* in, const void* k, const void* params,
                      void* out, int B, int n_params, double adt, int lanes,
                      void* stream) {
  return launch<ACT_FBW, SF>(in, k, params, out, B, n_params, adt, lanes,
                             stream);
}
int rk4_stage_fbw_f64(const void* in, const void* k, const void* params,
                      void* out, int B, int n_params, double adt, int lanes,
                      void* stream) {
  return launch<ACT_FBW, SD>(in, k, params, out, B, n_params, adt, lanes,
                             stream);
}
int rk4_stage_turb_f32(const void* in, const void* k, const void* params,
                       void* out, int B, int n_params, double adt, int lanes,
                       void* stream) {
  return launch<ACT_TURB, SF>(in, k, params, out, B, n_params, adt, lanes,
                              stream);
}
int rk4_stage_turb_f64(const void* in, const void* k, const void* params,
                       void* out, int B, int n_params, double adt, int lanes,
                       void* stream) {
  return launch<ACT_TURB, SD>(in, k, params, out, B, n_params, adt, lanes,
                              stream);
}
int rk4_stage_fbw_turb_f32(const void* in, const void* k, const void* params,
                           void* out, int B, int n_params, double adt,
                           int lanes, void* stream) {
  return launch<ACT_FBW_TURB, SF>(in, k, params, out, B, n_params, adt,
                                  lanes, stream);
}
int rk4_stage_fbw_turb_f64(const void* in, const void* k, const void* params,
                           void* out, int B, int n_params, double adt,
                           int lanes, void* stream) {
  return launch<ACT_FBW_TURB, SD>(in, k, params, out, B, n_params, adt,
                                  lanes, stream);
}
void rk4_stage_fbw_turb_layout(int* n_in, int* n_out) {
  *n_in = STAGE_N_IN_FBW_TURB;
  *n_out = STAGE_N_OUT_FBW_TURB;
}
void rk4_stage_fbw_turb_launch_shape(int B, int lanes, int n_params,
                                     int elem_size, int* grid, int* block,
                                     int* shared) {
  put_launch(role_launch(B, lanes, n_params, elem_size, SH_N_FBW), grid,
             block, shared);
}
// the head of the turbulent C172X's parameter buffer: the fly-by-wire
// C172X's, then the drive's scale
void systems_fbw_turb_params_layout(int* n_head, int* n_tables) {
  *n_head = P_HEAD_FBW_TURB;
  *n_tables = TB_N;
}
void rk4_stage_turb_layout(int* n_in, int* n_out) {
  *n_in = STAGE_N_IN_TURB;
  *n_out = STAGE_N_OUT_TURB;
}
void rk4_stage_turb_launch_shape(int B, int lanes, int n_params,
                                 int elem_size, int* grid, int* block,
                                 int* shared) {
  put_launch(role_launch(B, lanes, n_params, elem_size, SH_N), grid, block,
             shared);
}
// the head of the turbulent C172S's parameter buffer: the C172S's, then the
// drive's scale
void systems_turb_params_layout(int* n_head, int* n_tables) {
  *n_head = P_HEAD_TURB;
  *n_tables = TB_N;
}
void rk4_stage_layout(int* n_in, int* n_out) {
  *n_in = STAGE_N_IN;
  *n_out = STAGE_N_OUT;
}
void rk4_stage_fbw_layout(int* n_in, int* n_out) {
  *n_in = STAGE_N_IN_FBW;
  *n_out = STAGE_N_OUT_FBW;
}
void rk4_stage_launch_shape(int B, int lanes, int n_params, int elem_size,
                            int* grid, int* block, int* shared) {
  put_launch(role_launch(B, lanes, n_params, elem_size, SH_N), grid,
             block, shared);
}
void rk4_stage_fbw_launch_shape(int B, int lanes, int n_params,
                                int elem_size, int* grid, int* block,
                                int* shared) {
  put_launch(role_launch(B, lanes, n_params, elem_size, SH_N_FBW), grid,
             block, shared);
}
}
