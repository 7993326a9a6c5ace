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
#include "c172_systems.cuh"

using namespace fj;

// output rows
constexpr int RO_X = 0, RO_S = N_X, RO_TERM = RO_S + N_SSYS,
              RO_C = RO_TERM + 1;

template <typename T>
__global__ void __launch_bounds__(N_ROLES * MAX_LANES)
    rk4_finish_kernel(const T* __restrict__ in, const T* __restrict__ ksum,
                      const T* __restrict__ P, T* __restrict__ out, int B,
                      T c6, int comp) {
  const RoleThread t = role_thread(B);
  const Col<T> c{in, B, t.b};
  T x[N_SLOTS], ks[N_SLOTS], xn[N_SLOTS];
  load_slots(c, 0, t.role, x);
  load_slots(Col<T>{ksum, B, t.b}, 0, t.role, ks);
  FinishOut<T> f;
  finish_roles<false>(P, (const T*)nullptr, block_shared<T>(), t, x, ks, c6,
                      comp != 0, c, N_X, N_X + N_CTX, xn, f);
  if (!t.valid) return;  // past the last barrier

  const Out<T> o{out, B, t.b};
  store_slots(o, RO_X, t.role, xn);
  if (t.role == ROLE_AERO) {
    o.s(RO_S + SS_STALL, T(f.s.stall ? 1.0 : 0.0));
  } else if (t.role == ROLE_ENG) {
    o.s(RO_S + SS_STATE, T(double(f.s.state)));
  } else if (t.role == ROLE_KIN) {
    // the residuals stay 0 uncompensated, as the plain finish leaves them
    const T z = T(0.0);
    o.s(RO_S + SS_CRASHED, T(f.s.crashed ? 1.0 : 0.0));
    o.s(RO_TERM, f.term);
    o.q4(RO_C, comp ? f.r_q : Q4<T>{z, z, z, z});
    o.s(RO_C + 4, comp ? f.r_h : z);
  }
}

template <typename T>
static int launch(const void* in, const void* ksum, const void* params,
                  void* out, int B, double c6, int comp, int lanes,
                  void* stream) {
  if (B <= 0) return 0;
  if (lanes <= 0 || lanes > MAX_LANES || lanes % 32 != 0)
    return (int)cudaErrorInvalidValue;
  const RoleLaunch l = role_launch(B, lanes, 0, (int)sizeof(T), SH_N);
  // the attribute belongs to the device in use, so every launch sets it
  const cudaError_t err = cudaFuncSetAttribute(
      rk4_finish_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      l.shared);
  if (err != cudaSuccess) return (int)err;
  rk4_finish_kernel<T><<<l.grid, l.block, l.shared, (cudaStream_t)stream>>>(
      (const T*)in, (const T*)ksum, (const T*)params, (T*)out, B, T(c6),
      comp);
  return (int)cudaGetLastError();
}

extern "C" {
int rk4_finish_f32(const void* in, const void* ksum, const void* params,
                   void* out, int B, double c6, int comp, int lanes,
                   void* stream) {
  return launch<SF>(in, ksum, params, out, B, c6, comp, lanes, stream);
}
int rk4_finish_f64(const void* in, const void* ksum, const void* params,
                   void* out, int B, double c6, int comp, int lanes,
                   void* stream) {
  return launch<SD>(in, ksum, params, out, B, c6, comp, lanes, stream);
}
void rk4_finish_layout(int* n_in, int* n_out) {
  *n_in = RKFIN_N_IN;
  *n_out = RKFIN_N_OUT;
}
// its parameters stay in device memory, so n_params is not read
void rk4_finish_launch_shape(int B, int lanes, int n_params, int elem_size,
                             int* grid, int* block, int* shared) {
  put_launch(role_launch(B, lanes, 0, elem_size, SH_N), grid, block, shared);
}
}
