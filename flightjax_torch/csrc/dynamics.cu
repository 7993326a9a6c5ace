// dynamics: Newton-Euler at the centre of mass from the summed mass
// properties, external wrench and rotor angular momentum: mass-property and
// wrench translation to the CoM, Fukushima's Cartesian -> geodetic inverse
// for the CoM, Somigliana gravity, Earth-rate Coriolis terms, the
// closed-form adjugate 3x3 solve, and the derivative zeroed on terminated
// lanes.
//
// Replaces the TPU kernel `k_dynamics` of flightjax/parallel/clusterstep.py,
// built from the lane function `k3_lane` (clusterstep.py:403-414) over
// VehicleDynamics.f_ode (flightjax/physics/dynamics.py:211-290). Plain
// PyTorch version: flightjax_torch/parallel/kernels.py::dynamics_plain.
//
// What bounds it on the H100: one thread per aircraft, ~500 flops, 36
// inputs and 6 outputs per lane: at B = 4096 a call moves 0.7 MB in
// float32, so it is bound by launch latency and occupancy, not by
// bandwidth or FLOPs. 4096 threads in 128-thread blocks occupy only 32 of
// the 132 SMs; PERF.md records the block sizes measured on the card.
#include "flight_math.cuh"

using namespace fj;

// closed-form adjugate solve (flightjax/physics/dynamics.py:148-169)
template <typename T>
__device__ __forceinline__ V3<T> solve3(const M33<T>& M, V3<T> b) {
  const T a00 = M.m[0][0], a01 = M.m[0][1], a02 = M.m[0][2];
  const T a10 = M.m[1][0], a11 = M.m[1][1], a12 = M.m[1][2];
  const T a20 = M.m[2][0], a21 = M.m[2][1], a22 = M.m[2][2];
  const T c00 = a11 * a22 - a12 * a21;
  const T c01 = a12 * a20 - a10 * a22;
  const T c02 = a10 * a21 - a11 * a20;
  const T det = a00 * c00 + a01 * c01 + a02 * c02;
  const T c10 = a02 * a21 - a01 * a22;
  const T c11 = a00 * a22 - a02 * a20;
  const T c12 = a01 * a20 - a00 * a21;
  const T c20 = a01 * a12 - a02 * a11;
  const T c21 = a02 * a10 - a00 * a12;
  const T c22 = a00 * a11 - a01 * a10;
  return {(c00 * b.x + c10 * b.y + c20 * b.z) / det,
          (c01 * b.x + c11 * b.y + c21 * b.z) / det,
          (c02 * b.x + c12 * b.y + c22 * b.z) / det};
}

template <typename T>
__global__ void dynamics_kernel(const T* __restrict__ in, T* __restrict__ out,
                                int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const Col<T> c{in, B, b};
  const Out<T> o{out, B, b};

  const V3<T> omega_eb_b = c.v3(0), v_eb_b = c.v3(3);
  const T m = c(6);
  M33<T> J;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) J.m[i][j] = c(7 + 3 * i + j);
  const V3<T> r_OG = c.v3(16), F_b = c.v3(19), tau_b = c.v3(22),
              ho = c.v3(25);
  const Q4<T> q_eb = c.q4(28);
  const V3<T> r_eb_e = c.v3(32);
  const T term = c(35);

  const V3<T> omega_ie_b = qrot_inv(q_eb, V3<T>{T(0), T(0), T(OMEGA_IE)});

  // mass properties and wrench at the CoM: t_cb = (-r_OG, identity)
  const V3<T> r_bc_b = r_OG;
  const M33<T> SSc = mm(skew(r_OG), skew(r_OG));
  const V3<T> r_bG_b = add(neg(r_bc_b), r_OG);
  const M33<T> SSb = mm(skew(r_bG_b), skew(r_bG_b));
  M33<T> J_c;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      J_c.m[i][j] = (J.m[i][j] + m * SSc.m[i][j]) - m * SSb.m[i][j];
  const V3<T> F_c = F_b;
  const V3<T> tau_c = add(tau_b, cross(neg(r_bc_b), F_c));

  const V3<T> omega_ec_c = omega_eb_b;
  const V3<T> v_ec_c = add(v_eb_b, cross(omega_ec_c, r_bc_b));
  const V3<T> omega_ie_c = omega_ie_b;
  const V3<T> omega_ic_c = add(omega_ie_c, omega_ec_c);

  // geodetic position of the CoM and gravity there
  const V3<T> r_ec_e = add(r_eb_e, qrot(q_eb, r_bc_b));
  V3<T> n_c;
  T h_c;
  geographic_from_cartesian(r_ec_e, n_c, h_c);
  const T g_mag = gravity(n_c, h_c);
  const V3<T> g_c_c = scale(g_mag, qrot_inv(q_eb, neg(n_c)));

  const V3<T> hc = add(mv(J_c, omega_ic_c), ho);
  const V3<T> rhs = sub(sub(tau_c, mv(J_c, cross(omega_ie_c, omega_ec_c))),
                        cross(omega_ic_c, hc));
  const V3<T> omega_dot = solve3(J_c, rhs);
  const V3<T> F_m = {F_c.x / m, F_c.y / m, F_c.z / m};
  const V3<T> v_dot_ec_c =
      sub(add(F_m, g_c_c),
          cross(add(omega_ec_c, scale(T(2), omega_ie_c)), v_ec_c));
  const V3<T> v_dot_eb_b = sub(v_dot_ec_c, cross(omega_dot, r_bc_b));

  const T alive = T(1.0) - term;
  o.v3(0, scale(alive, omega_dot));
  o.v3(3, scale(alive, v_dot_eb_b));
}

template <typename T>
static int launch(const void* in, void* out, int B, int block, void* stream) {
  if (B <= 0) return 0;
  if (block <= 0 || block > 1024) return (int)cudaErrorInvalidValue;
  const int grid = (B + block - 1) / block;
  dynamics_kernel<T><<<grid, block, 0, (cudaStream_t)stream>>>(
      (const T*)in, (T*)out, B);
  return (int)cudaGetLastError();
}

extern "C" {
int dynamics_f32(const void* in, void* out, int B, int block, void* stream) {
  return launch<SF>(in, out, B, block, stream);
}
int dynamics_f64(const void* in, void* out, int B, int block, void* stream) {
  return launch<SD>(in, out, B, block, stream);
}
void dynamics_layout(int* n_in, int* n_out) {
  *n_in = DYN_N_IN;
  *n_out = DYN_N_OUT;
}
}
