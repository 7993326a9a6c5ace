// finish_kin: the RK4 combine x + dt/6 (k1 + 2k2 + 2k3 + k4) on the
// kinematics and dynamics states -- Kahan/Neumaier-compensated on the
// position states q_ew and h_e when residuals are carried -- the WA
// quaternion renormalisation, and a fresh KinData and AirData at the new
// state.
//
// Replaces the TPU kernel `k_finish_kin` of flightjax/parallel/
// clusterstep.py, built from the lane function `k4_lane`
// (clusterstep.py:433-448), plus the compensated add `comp_add` of
// flightjax/core/sim.py:158-180 that the Pallas paths leave out
// (clusterstep.py:170, :608). Plain PyTorch version:
// flightjax_torch/parallel/kernels.py::finish_kin_plain.
//
// What bounds it on the H100: neither bytes (41 input and 82 output rows per
// lane, 2.0 MB in float32 at B = 4096, about 0.6 us of HBM) nor operations
// (~350 per lane), but the latency of one aircraft's chain. With one thread
// per aircraft it ran the combine (five Neumaier adds when compensated), two
// renormalisations (a square root and a divide each) and then kinair's
// chain at the new state: 17 math-library calls in a row (the wrappers are
// real functions), four atan2 in the kinematics, two atan2 and an asin for
// the Euler angles, a power or an exponential for each of the seven ISA
// layers and three more powers in the air data; and 4096 threads in
// 128-thread blocks filled 32 of the 132 SMs.
//
// What the design does about it: kinair's cut (flight_math.cuh, "finish_kin
// roles"): three threads carry one aircraft, one warp each, KD (with EUL)
// the new state, the KinData rows that take no library call, the residuals
// and the Euler angles, ANG the four atan2, AIR the atmosphere and air data.
// Every role runs the combine and the renormalisation itself and stores only
// its own rows, so the roles need no barrier and each row is bit-identical to
// the one-thread form; the renormalisation's square roots and divisions are
// one called function, not a copy in every role, which measured 0.4-0.5 us
// faster. AIR skips the ISA layers above the aircraft, whose calls change
// nothing (atm_air<true>). A warp makes at most four library calls, and
// 4096 aircraft at 32 per block are 128 blocks of three warps.
// PERF.md records the times on the card, beside the one-thread form's
// (tools/ablate_torch_roles.py, `finish_kin_thread`).
#include "flight_math.cuh"

using namespace fj;

template <typename T>
__global__ void __launch_bounds__(KA_ROLES * MAX_LANES)
    finish_kin_kernel(const T* __restrict__ in, T* __restrict__ out, int B,
                      T c6, int comp) {
  const RoleThread t = role_thread(B, KA_ROLES);
  if (!t.valid) return;  // no barrier
  finish_kin_role(t.role, Col<T>{in, B, t.b}, c6, comp != 0,
                  Out<T>{out, B, t.b});
}

template <typename T>
static int launch(const void* in, void* out, int B, double c6, int comp,
                  int lanes, void* stream) {
  if (B <= 0) return 0;
  if (lanes <= 0 || lanes > MAX_LANES || lanes % 32 != 0)
    return (int)cudaErrorInvalidValue;
  const RoleLaunch l = role_launch(B, lanes, KA_ROLES, 0);
  finish_kin_kernel<T><<<l.grid, l.block, l.shared, (cudaStream_t)stream>>>(
      (const T*)in, (T*)out, B, T(c6), comp);
  return (int)cudaGetLastError();
}

extern "C" {
int finish_kin_f32(const void* in, void* out, int B, double c6, int comp,
                   int lanes, void* stream) {
  return launch<SF>(in, out, B, c6, comp, lanes, stream);
}
int finish_kin_f64(const void* in, void* out, int B, double c6, int comp,
                   int lanes, void* stream) {
  return launch<SD>(in, out, B, c6, comp, lanes, stream);
}
void finish_kin_layout(int* n_in, int* n_out) {
  *n_in = FIN_N_IN;
  *n_out = FIN_N_OUT;
}
void finish_kin_launch_shape(int B, int lanes, int, int, int* grid,
                             int* block, int* shared) {
  put_launch(role_launch(B, lanes, KA_ROLES, 0), grid, block, shared);
}
}
