// kinair: RK4 stage FMA on the kinematics and dynamics states, the
// wander-azimuth kinematics (derivative + KinData), the ISA atmosphere with
// wind, air data, and the derivative zeroed on terminated lanes.
//
// Replaces the TPU kernel `k_kinair` of flightjax/parallel/clusterstep.py,
// built from the lane function `k1_lane` (clusterstep.py:250-262) through
// pallas_block / pallas_block_minor. Plain PyTorch version:
// flightjax_torch/parallel/kernels.py::kinair_plain.
//
// What bounds it on the H100: neither bytes (37 input and 77 output rows per
// lane, 1.8 MB in float32 at B = 4096, about half a microsecond of HBM) nor
// operations (~400 per lane), but the latency of one aircraft's chain. With
// one thread per aircraft it made 17 math-library calls in a row (the
// wrappers are real functions for the role kernels' sake): four atan2 in the
// kinematics, two atan2 and an asin for the Euler angles, a power or an
// exponential for each of the seven ISA layers, and three more powers in the
// air data; and 4096 threads in 128-thread blocks filled 32 of the 132 SMs.
//
// What the design does about it: three threads carry one aircraft, one warp
// each (flight_math.cuh, "kinair roles"): KD the derivative, the KinData
// rows that take no library call and the Euler angles, ANG the four atan2
// of lat, lon, chi and gamma, AIR the atmosphere and air data. Each role
// owns its output rows and works out, from the inputs, only the chain those
// rows need, so the roles need no barrier and each row is bit-identical to
// the one-thread form. AIR skips the ISA layers above the aircraft, whose
// calls change nothing (isa_data<true>): 6 of 7 calls below 11 km. A warp
// makes at most four library calls, and 4096 aircraft at 32 per block are
// 128 blocks of three warps, one on each of 128 SMs. PERF.md records the
// times on the card, and the layouts measured against this one.
#include "flight_math.cuh"

using namespace fj;

template <typename T>
__global__ void __launch_bounds__(KA_ROLES * MAX_LANES)
    kinair_kernel(const T* __restrict__ in, T* __restrict__ out, int B,
                  T adt) {
  const RoleThread t = role_thread(B, KA_ROLES);
  if (!t.valid) return;  // no barrier
  kinair_role(t.role, Col<T>{in, B, t.b}, adt, Out<T>{out, B, t.b});
}

template <typename T>
static int launch(const void* in, void* out, int B, double adt, int lanes,
                  void* stream) {
  if (B <= 0) return 0;
  if (lanes <= 0 || lanes > MAX_LANES || lanes % 32 != 0)
    return (int)cudaErrorInvalidValue;
  const RoleLaunch l = role_launch(B, lanes, KA_ROLES, 0);
  kinair_kernel<T><<<l.grid, l.block, l.shared, (cudaStream_t)stream>>>(
      (const T*)in, (T*)out, B, T(adt));
  return (int)cudaGetLastError();
}

extern "C" {
int kinair_f32(const void* in, void* out, int B, double adt, int lanes,
               void* stream) {
  return launch<SF>(in, out, B, adt, lanes, stream);
}
int kinair_f64(const void* in, void* out, int B, double adt, int lanes,
               void* stream) {
  return launch<SD>(in, out, B, adt, lanes, stream);
}
void kinair_layout(int* n_in, int* n_out) {
  *n_in = KINAIR_N_IN;
  *n_out = KINAIR_N_OUT;
}
void kinair_launch_shape(int B, int lanes, int, int, int* grid, int* block,
                         int* shared) {
  put_launch(role_launch(B, lanes, KA_ROLES, 0), grid, block, shared);
}
}
