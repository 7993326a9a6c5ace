#!/usr/bin/env python3
"""Which roles of flightjax_torch's role kernels is their time made of, and
which of two layouts is faster? Time the role kernels (kinair, dynamics,
finish_kin, systems, finish_sys, rk4_stage, rk4_finish, megakernel) built
from patched copies of their sources, on one CUDA card.

    python3 tools/ablate_torch_roles.py [--batch 4096]
                                        [--variants none,aero,aero+engine]

For each variant the kernel sources are copied into a directory of their own
under `flightjax_torch/_build/`, the named patches are applied to the copy,
and the copy is built and bound as the package builds its own sources. Two
kinds of patch:
- a role's body compiled out: its call (`aero_parts`, `gear_leg`, `engine`,
  `propeller`) in `subsystem_roles` of `c172_systems.cuh`, which systems,
  rk4_stage and the megakernel all run, is replaced by zeros. The results of
  such a build are wrong and are not looked at; only its time is;
- a layout the kernels could have had: `sys7` runs systems in seven warps
  per block, with no KIN warp (role DRAG shares the KinData and AirData and
  sums the wrench); `finish_whole` has rk4_finish copy the whole parameter
  buffer into shared memory and `finish_head` only its scalar head, where
  the tree reads them through the read-only cache; `finish_atm` has the
  finish share the atmosphere (Tk, p, rho, a, q) as the stage does;
  `kinair_thread` is kinair's one-thread form, one aircraft per thread as
  before it became a role kernel (timed at 128 threads per block too, as
  dynamics, which carries one aircraft per thread), `dynamics_roles` runs
  dynamics in two warps per 32 aircraft, `thread_skip` gives the
  one-thread kinair the ISA layer skip and `inline` makes the math-library
  wrappers of flight_math.cuh inline functions and `inline_pow` only the
  power (only kinair's time is read off such builds); `noskip` takes the ISA layer skip out of the
  role AIR of kinair and finish_kin, and `kinair_abcd` (four digits) runs
  kinair's roles KD, ANG, EUL and AIR in warps a, b, c and d of each 32
  aircraft, and finish_kin's with them: `kinair_0123` is one warp each,
  `kinair_0112` three with EUL in ANG's warp (the tree is `kinair_0102`);
  `finish_kin_thread` and `finish_sys_thread` are the one-thread forms of
  finish_kin and finish_sys (timed at 128 threads per block too),
  `finish_kin_kdeul` has finish_kin's role KD store e_nb off its own
  prefix instead of running EUL's after it in the same warp,
  `finish_sys4` runs finish_sys's engine state machine in the REST warp
  beside the stall instead of in a fifth warp of its own, and
  `finish_kin_inline_renorm` inlines finish_kin's renormalisations in
  every role instead of calling one copy, and `finish_kin_norenorm` and
  `finish_kin_nocomp` compile them or its compensated add out (only
  finish_kin's time is read off such builds); `ctl_laws_thread` runs
  ctl_laws' lon and lat passes one after the other in one thread per
  aircraft instead of in two warps per 32 aircraft.

Times are warm medians of 20 launches replayed from a captured CUDA graph,
float32, at 32 and 64 aircraft per block (threads per block for a
one-thread form): on the perturbed airborne
flagship fleet (as `chip_smoke.py` times them) and on the kernel-check
operands with lanes on the runway; ctl_laws on the pass of the airborne
C172Xv1 fleet on the turning climb and on the mode-rich operands with
lanes on the ground. The sources of the package are not
touched. `--variants` names the patches, `+` between patches of one variant
and `none` for the kernels as they are; the default is each role alone, aero
and engine, all four, and each layout. A variant may come more than once,
so that parent and tree forms can take turns (parent, tree, tree, parent)
and their spread shows. Prints one line per variant, then the
card's name and power limit, and as the last line all of it as one JSON
object. Fails without a card, and if a patch no longer finds its text.
"""

import argparse
import json
import os
import re
import shutil
import sys

import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir)
sys.path.insert(0, ROOT)

Z3 = "{T(0.0), T(0.0), T(0.0)}"
N_PARAMS = "@N_PARAMS@"  # the parameter buffer's length, filled in at run time


def finish_copies(n):
    """The patch that has rk4_finish copy the first n values of the
    parameter buffer into shared memory and read them there."""
    return [("rk4_finish.cu", "  const RoleThread t = role_thread(B);\n",
             f"  T* sP = block_shared<T>();\n  share_params(P, {n}, sP);\n"
             "  const RoleThread t = role_thread(B);\n"),
            ("rk4_finish.cu",
             "finish_roles<false>(P, (const T*)nullptr, block_shared<T>(), t,",
             f"finish_roles<false>(sP, (const T*)nullptr, sP + {n}, t,"),
            ("rk4_finish.cu", "role_launch(B, lanes, 0, (int)sizeof(T)",
             f"role_launch(B, lanes, {n}, (int)sizeof(T)")]


# the one-thread form of kinair (one aircraft per thread, `block` threads per
# block) with the interface of its role form, and the two-warp form of
# dynamics (`block` aircraft per block): the geodetic inverse and gravity
# (DY_GEO) beside the mass properties and the solve (DY_ROT), omega_dot
# crossing in shared memory at one barrier
KINAIR_THREAD = """\
#include "flight_math.cuh"

using namespace fj;

template <typename T>
__global__ void kinair_kernel(const T* __restrict__ in, T* __restrict__ out,
                              int B, T adt) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const Col<T> c{in, B, b};
  const Out<T> o{out, B, b};
  const XKin<T> xi = axpy(load_xkin(c, 0), adt, load_xkin(c, 15));
  const XDyn<T> xi_dyn = axpy(load_xdyn(c, 9), adt, load_xdyn(c, 24));
  XKin<T> kin_dot;
  Kin<T> k;
  Air<T> air;
  kinair_lane(xi, xi_dyn, c(30), load_atm(c, 31), T(1.0) - c(36), kin_dot, k,
              air);
  store_xkin(o, 0, kin_dot);
  store_kin(o, N_XKIN, k);
  store_air(o, N_XKIN + N_KIN, air);
  store_xdyn(o, N_XKIN + N_KIN + N_AIR, xi_dyn);
}

template <typename T>
static int launch(const void* in, void* out, int B, double adt, int block,
                  void* stream) {
  if (B <= 0) return 0;
  if (block <= 0 || block > 1024) return (int)cudaErrorInvalidValue;
  kinair_kernel<T><<<(B + block - 1) / block, block, 0,
                     (cudaStream_t)stream>>>((const T*)in, (T*)out, B,
                                             T(adt));
  return (int)cudaGetLastError();
}

extern "C" {
int kinair_f32(const void* in, void* out, int B, double adt, int block,
               void* stream) {
  return launch<SF>(in, out, B, adt, block, stream);
}
int kinair_f64(const void* in, void* out, int B, double adt, int block,
               void* stream) {
  return launch<SD>(in, out, B, adt, block, stream);
}
void kinair_layout(int* n_in, int* n_out) {
  *n_in = KINAIR_N_IN;
  *n_out = KINAIR_N_OUT;
}
void kinair_launch_shape(int B, int block, int, int, int* grid, int* threads,
                         int* shared) {
  put_launch(role_launch(B, block, 1, 0), grid, threads, shared);
}
}
"""
DYNAMICS_ROLES = """\
#include "c172_systems.cuh"

using namespace fj;

// dynamics' roles, one warp each per 32 aircraft:
//   DY_ROT  the mass properties and the wrench at the CoM, hc, the
//           right-hand side and the adjugate solve: the omega_dot rows
//   DY_GEO  the CoM's geodetic position, gravity and the translational
//           terms; after the barrier, with omega_dot, the v_dot_eb_b rows
// omega_dot crosses in the block's shared memory, [3, L] values
constexpr int DY_ROT = 0, DY_GEO = 1, DY_ROLES = 2;

// DY_ROT: omega_dot, before the x alive (dynamics_lane's operations)
template <typename T>
__device__ __forceinline__ V3<T> dynamics_rot(const XDyn<T>& xi,
                                              const MP<T>& mp, V3<T> F_b,
                                              V3<T> tau_b, V3<T> ho,
                                              Q4<T> q_eb) {
  const V3<T> omega_eb_b = xi.omega_eb_b;
  const T m = mp.m;
  const M33<T>& J = mp.J;
  const V3<T> r_OG = mp.r;
  const V3<T> omega_ie_b = qrot_inv(q_eb, V3<T>{T(0), T(0), T(OMEGA_IE)});
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
  const V3<T> omega_ie_c = omega_ie_b;
  const V3<T> omega_ic_c = add(omega_ie_c, omega_ec_c);
  const V3<T> hc = add(mv(J_c, omega_ic_c), ho);
  const V3<T> rhs = sub(sub(tau_c, mv(J_c, cross(omega_ie_c, omega_ec_c))),
                        cross(omega_ic_c, hc));
  return solve3(J_c, rhs);
}

// DY_GEO: v_dot_ec_c, the CoM's acceleration but the omega_dot term
// (dynamics_lane's operations)
template <typename T>
__device__ __forceinline__ V3<T> dynamics_geo(const XDyn<T>& xi, T m,
                                              V3<T> r_OG, V3<T> F_b,
                                              Q4<T> q_eb, V3<T> r_eb_e) {
  const V3<T> omega_eb_b = xi.omega_eb_b, v_eb_b = xi.v_eb_b;
  const V3<T> omega_ie_b = qrot_inv(q_eb, V3<T>{T(0), T(0), T(OMEGA_IE)});
  const V3<T> r_bc_b = r_OG;
  const V3<T> F_c = F_b;
  const V3<T> omega_ec_c = omega_eb_b;
  const V3<T> v_ec_c = add(v_eb_b, cross(omega_ec_c, r_bc_b));
  const V3<T> omega_ie_c = omega_ie_b;
  const V3<T> r_ec_e = add(r_eb_e, qrot(q_eb, r_bc_b));
  V3<T> n_c;
  T h_c;
  geographic_from_cartesian(r_ec_e, n_c, h_c);
  const T g_mag = gravity(n_c, h_c);
  const V3<T> g_c_c = scale(g_mag, qrot_inv(q_eb, neg(n_c)));
  const V3<T> F_m = {F_c.x / m, F_c.y / m, F_c.z / m};
  return sub(add(F_m, g_c_c),
             cross(add(omega_ec_c, scale(T(2), omega_ie_c)), v_ec_c));
}

template <typename T>
__global__ void __launch_bounds__(DY_ROLES * MAX_LANES)
    dynamics_kernel(const T* __restrict__ in, T* __restrict__ out, int B) {
  const RoleThread t = role_thread(B, DY_ROLES);
  const Col<T> c{in, B, t.b};
  const Out<T> o{out, B, t.b};
  T* sh = block_shared<T>();  // omega_dot, [3, L]
  const XDyn<T> xi = load_xdyn(c, 0);
  const T alive = T(1.0) - c(35);
  const V3<T> r_OG = c.v3(16);
  V3<T> v_dot_ec_c;
  if (t.role == DY_ROT) {
    MP<T> mp;
    mp.m = c(6);
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) mp.J.m[i][j] = c(7 + 3 * i + j);
    mp.r = r_OG;
    const V3<T> omega_dot = dynamics_rot(xi, mp, c.v3(19), c.v3(22),
                                         c.v3(25), c.q4(28));
    Out<T>{sh, t.L, t.lane}.v3(0, omega_dot);
    if (t.valid) o.v3(0, scale(alive, omega_dot));
  } else {
    v_dot_ec_c = dynamics_geo(xi, c(6), r_OG, c.v3(19), c.q4(28), c.v3(32));
  }
  __syncthreads();
  if (t.role == DY_GEO && t.valid) {
    const V3<T> omega_dot = Col<T>{sh, t.L, t.lane}.v3(0);
    o.v3(3, scale(alive, sub(v_dot_ec_c, cross(omega_dot, r_OG))));
  }
}

template <typename T>
static int launch(const void* in, void* out, int B, int lanes, void* stream) {
  if (B <= 0) return 0;
  if (lanes <= 0 || lanes > MAX_LANES || lanes % 32 != 0)
    return (int)cudaErrorInvalidValue;
  const RoleLaunch l = role_launch(B, lanes, DY_ROLES,
                                   3 * lanes * (int)sizeof(T));
  dynamics_kernel<T><<<l.grid, l.block, l.shared, (cudaStream_t)stream>>>(
      (const T*)in, (T*)out, B);
  return (int)cudaGetLastError();
}

extern "C" {
int dynamics_f32(const void* in, void* out, int B, int lanes, void* stream) {
  return launch<SF>(in, out, B, lanes, stream);
}
int dynamics_f64(const void* in, void* out, int B, int lanes, void* stream) {
  return launch<SD>(in, out, B, lanes, stream);
}
void dynamics_layout(int* n_in, int* n_out) {
  *n_in = DYN_N_IN;
  *n_out = DYN_N_OUT;
}
}
"""


# the one-thread forms of finish_kin and finish_sys (one aircraft per
# thread, `block` threads per block) with the interface of their role forms:
# finish_kin as it was before it became a role kernel, finish_sys with the
# finish parts of c172_systems.cuh in the order of k5_lane
FINISH_KIN_THREAD = """\
#include "flight_math.cuh"

using namespace fj;

template <typename T>
__global__ void finish_kin_kernel(const T* __restrict__ in,
                                  T* __restrict__ out, int B, T c6,
                                  int comp) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const Col<T> c{in, B, b};
  const Out<T> o{out, B, b};
  Q4<T> r_q = {T(0), T(0), T(0), T(0)};
  T r_h = T(0);
  if (comp) {
    r_q = c.q4(36);
    r_h = c(40);
  }
  XKin<T> x;
  XDyn<T> x_dyn;
  Kin<T> k;
  Air<T> air;
  finish_kin_lane(load_xkin(c, 0), load_xdyn(c, 9), load_xkin(c, 15),
                  load_xdyn(c, 24), c6, comp != 0, r_q, r_h, c(30),
                  load_atm(c, 31), x, x_dyn, k, air);
  store_xkin(o, FK_XKIN, x);
  store_xdyn(o, FK_XDYN, x_dyn);
  store_kin(o, FK_KIN, k);
  store_air(o, FK_AIR, air);
  o.q4(FK_C, r_q);
  o.s(FK_C + 4, r_h);
}

template <typename T>
static int launch(const void* in, void* out, int B, double c6, int comp,
                  int block, void* stream) {
  if (B <= 0) return 0;
  if (block <= 0 || block > 1024) return (int)cudaErrorInvalidValue;
  finish_kin_kernel<T><<<(B + block - 1) / block, block, 0,
                         (cudaStream_t)stream>>>((const T*)in, (T*)out, B,
                                                 T(c6), comp);
  return (int)cudaGetLastError();
}

extern "C" {
int finish_kin_f32(const void* in, void* out, int B, double c6, int comp,
                   int block, void* stream) {
  return launch<SF>(in, out, B, c6, comp, block, stream);
}
int finish_kin_f64(const void* in, void* out, int B, double c6, int comp,
                   int block, void* stream) {
  return launch<SD>(in, out, B, c6, comp, block, stream);
}
void finish_kin_layout(int* n_in, int* n_out) {
  *n_in = FIN_N_IN;
  *n_out = FIN_N_OUT;
}
void finish_kin_launch_shape(int B, int block, int, int, int* grid,
                             int* threads, int* shared) {
  put_launch(role_launch(B, block, 1, 0), grid, threads, shared);
}
}
"""
FINISH_SYS_THREAD = """\
#include "c172_systems.cuh"

using namespace fj;

constexpr int FI_X = 0, FI_K = FI_X + N_XSYS, FI_U = FI_K + N_XSYS,
              FI_S = FI_U + N_USYS, FI_TRN = FI_S + N_SSYS,
              FI_KIN = FI_TRN + N_TRN, FI_AIR = FI_KIN + N_KIN;
constexpr int FO_X = 0, FO_S = N_XSYS;

template <typename T>
__global__ void finish_sys_kernel(const T* __restrict__ in,
                                  const T* __restrict__ P,
                                  T* __restrict__ out, int B, T c6) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const Col<T> c{in, B, b};
  const Out<T> o{out, B, b};
  T x[N_XSYS];
#pragma unroll
  for (int r = 0; r < N_XSYS; ++r) x[r] = c(FI_X + r) + c6 * c(FI_K + r);
  T u[N_USYS];
#pragma unroll
  for (int r = 0; r < N_USYS; ++r) u[r] = c(FI_U + r);
  SSys s = load_ssys(c, FI_S);
  const Kin<T> kin = load_kin(c, FI_KIN);
  const Trn<T> trn = load_trn(c, FI_TRN);
#pragma unroll
  for (int leg = 0; leg < N_LEGS; ++leg) {
    const bool crash = finish_leg(P, leg, u, kin, trn, x[XS_FRC + 2 * leg],
                                  x[XS_FRC + 2 * leg + 1]);
    s.crashed = s.crashed || crash;
  }
  s.stall = finish_stall(P, load_air(c, FI_AIR), s.stall);
  s.state = finish_engine(P, s.state, x[XS_FUEL], x[XS_OMEGA], u);
#pragma unroll
  for (int r = 0; r < N_XSYS; ++r) o.s(FO_X + r, x[r]);
  store_ssys(o, FO_S, s);
}

template <typename T>
static int launch(const void* in, const void* params, void* out, int B,
                  double c6, int block, void* stream) {
  if (B <= 0) return 0;
  if (block <= 0 || block > 1024) return (int)cudaErrorInvalidValue;
  finish_sys_kernel<T><<<(B + block - 1) / block, block, 0,
                         (cudaStream_t)stream>>>(
      (const T*)in, (const T*)params, (T*)out, B, T(c6));
  return (int)cudaGetLastError();
}

extern "C" {
int finish_sys_f32(const void* in, const void* params, void* out, int B,
                   double c6, int block, void* stream) {
  return launch<SF>(in, params, out, B, c6, block, stream);
}
int finish_sys_f64(const void* in, const void* params, void* out, int B,
                   double c6, int block, void* stream) {
  return launch<SD>(in, params, out, B, c6, block, stream);
}
void finish_sys_layout(int* n_in, int* n_out) {
  *n_in = FSYS_N_IN;
  *n_out = FSYS_N_OUT;
}
void finish_sys_launch_shape(int B, int block, int, int, int* grid,
                             int* threads, int* shared) {
  put_launch(role_launch(B, block, 1, 0), grid, threads, shared);
}
}
"""


def one_thread(name, patches):
    """Whether kernel `name` carries one aircraft per thread in a build
    with these patches (and so is timed at 128 threads per block too)."""
    return {"kinair": "kinair_thread" in patches,
            "dynamics": "dynamics_roles" not in patches,
            "finish_kin": "finish_kin_thread" in patches,
            "finish_sys": "finish_sys_thread" in patches}.get(name, False)


AERO_ZERO = f"    a = {{T(0.0), T(0.0), {Z3}, T(0.0), T(0.0), {Z3}}};\n"
# patch: [(source file, text the copy must hold once, what replaces it)];
# None for the text replaces the whole file, and a fourth element True
# replaces every occurrence (at least one) of the text
PATCHES = {
    "aero": [
        ("c172_systems.cuh", """\
    aero_parts<AERO_LIFT_MOMENTS>(P, xi[0], xi[1], act, in.s.stall, kin, air,
                                  in.trn.elevation, a);
""", AERO_ZERO),
        ("c172_systems.cuh", """\
    aero_parts<AERO_DRAG_SIDE>(P, T(0.0), T(0.0), act, false, kin, air,
                               in.trn.elevation, a);
""", AERO_ZERO)],
    "legs": [
        ("c172_systems.cuh", """\
    gear_leg(P, leg, xi[0], xi[1], steering, braking, kin, in.trn.elevation,
             in.trn.normal, in.trn.surface, d[0], d[1], F, tau);
""", f"    d[0] = d[1] = T(0.0);\n    F = tau = {Z3};\n")],
    "engine": [
        ("c172_systems.cuh", """\
    engine(P, xi[PW_OMEGA], xi[PW_IDLE], xi[PW_EFRC], act.throttle,
           act.mixture, in.u[US_E_MIXCTL], in.s.state, air, tau_shaft,
           d[PW_IDLE], d[PW_EFRC], mdot);
""", "    tau_shaft = d[PW_IDLE] = d[PW_EFRC] = mdot = T(0.0);\n")],
    "propeller": [
        ("c172_systems.cuh",
         "    const PropOut<T> prop = propeller(P, kin, air, "
         "gr * si(SH_XOMEGA));\n",
         f"    const PropOut<T> prop = {{{Z3}, {Z3}, {Z3}, T(0.0)}};\n")],
    "sys7": [
        ("systems.cu", "  const RoleThread t = role_thread(B);\n", """\
  RoleThread t = role_thread(B);  // seven warps: roles AERO.. only
  t.L = blockDim.x / (N_ROLES - 1);
  t.lane = threadIdx.x % t.L;
  t.role = 1 + threadIdx.x / t.L;
  t.valid = blockIdx.x * t.L + t.lane < B;
  t.b = t.valid ? blockIdx.x * t.L + t.lane : B - 1;
"""),
        ("systems.cu", """\
  if (t.role == ROLE_KIN) {
    share_kin_air(Out<T>{sh, t.L, t.lane}, load_kin(c, SI_KIN),
                  load_air(c, SI_AIR));
  } else {
""", """\
  if (t.role == ROLE_DRAG)
    share_kin_air(Out<T>{sh, t.L, t.lane}, load_kin(c, SI_KIN),
                  load_air(c, SI_AIR));
  {
"""),
        ("systems.cu", "  if (t.role == ROLE_KIN) {\n    V3<T> F_b, tau_b;",
         "  if (t.role == ROLE_DRAG) {\n    V3<T> F_b, tau_b;"),
        ("systems.cu", """\
  const RoleLaunch l = role_launch(B, lanes, n_params, (int)sizeof(T), SH_N);
""", """\
  RoleLaunch l = role_launch(B, lanes, n_params, (int)sizeof(T), SH_N);
  l.block -= lanes;
""")],
    "finish_head": finish_copies("P_HEAD"),
    "finish_whole": finish_copies(N_PARAMS),
    "finish_atm": [
        ("c172_systems.cuh", "    share_kin_air<false>(so, kin, air);\n",
         "    share_kin_air(so, kin, air);\n")],
    "kinair_thread": [("kinair.cu", None, KINAIR_THREAD)],
    "dynamics_roles": [("dynamics.cu", None, DYNAMICS_ROLES)],
    "thread_skip": [
        ("kinair.cu", """\
  kinair_lane(xi, xi_dyn, c(30), load_atm(c, 31), T(1.0) - c(36), kin_dot, k,
              air);
""", """\
  XKin<T> d;
  wa_f_ode(xi.q_wb, xi.q_ew, xi.h_e, xi_dyn.omega_eb_b, xi_dyn.v_eb_b, c(30),
           d, k);
  const AtmU<T> u = load_atm(c, 31);
  air = atm_air<true>(k, u.T_sl, u.p_sl, u.wind);
  kin_dot = scale(T(1.0) - c(36), d);
""")],
    "inline": [("flight_math.cuh", "static __device__ __noinline__ ",
                "static __device__ __forceinline__ ", True)],
    "inline_pow": [("flight_math.cuh", f"static __device__ __noinline__ {t} "
                    f"Pow", f"static __device__ __forceinline__ {t} Pow")
                   for t in ("SF", "SD")],
    "noskip": [("flight_math.cuh", "atm_air<true>(k, u.T_sl",
                "atm_air<false>(k, u.T_sl", True)],
    "finish_kin_thread": [("finish_kin.cu", None, FINISH_KIN_THREAD)],
    "finish_sys_thread": [("finish_sys.cu", None, FINISH_SYS_THREAD)],
    "finish_kin_kdeul": [
        ("flight_math.cuh", """\
    o.q4(FK_C, r_q);
    o.s(FK_C + 4, r_h);
  }""", """\
    o.q4(FK_C, r_q);
    o.s(FK_C + 4, r_h);
    o.v3(FK_KIN + KR_E_NB, k.e_nb);
  }"""),
        ("flight_math.cuh", """\
  if (role == KA_EUL) {
    finish_kin_state(c, c6, comp, x, x_dyn, r_q, r_h, k);
    o.v3(FK_KIN + KR_E_NB, k.e_nb);
  }""", "")],
    "finish_sys4": [("finish_sys.cu", """\
constexpr int FS_LEG0 = 0, FS_REST = N_LEGS, FS_ENG = FS_REST + 1,
              FS_ROLES = N_LEGS + 2;""", """\
constexpr int FS_LEG0 = 0, FS_REST = N_LEGS, FS_ENG = FS_REST,
              FS_ROLES = N_LEGS + 1;""")],
    "finish_kin_norenorm": [
        ("flight_math.cuh", """\
  if (RENORM_CALL)
    xo = {normalize_block_call(nq_wb), normalize_block_call(nq_ew), nh_e};
  else
    xo = {normalize_block(nq_wb), normalize_block(nq_ew), nh_e};""",
         "  xo = {nq_wb, nq_ew, nh_e};")],
    "finish_kin_inline_renorm": [
        ("flight_math.cuh", "finish_kin_combine<true>(",
         "finish_kin_combine<false>(")],
    "finish_kin_nocomp": [
        ("finish_kin.cu", "finish_kin_role(t.role, Col<T>{in, B, t.b}, c6, comp != 0,",
         "finish_kin_role(t.role, Col<T>{in, B, t.b}, c6, false,")],
    "ctl_laws_thread": [
        ("ctl_laws.cu", "constexpr int CTL_SIDES = 2;",
         "constexpr int CTL_SIDES = 1;"),
        ("ctl_laws.cu", "  if (t.role == 0) {", "  {"),
        ("ctl_laws.cu", "  if (t.role == 1) {", "  {")],
}
KINAIR_ROLES = "KA_KD = 0, KA_ANG = 1, KA_EUL = 0, KA_AIR = 2, KA_ROLES = 3;"


def patch(name):
    """The edits of patch `name`: PATCHES[name], or a layout of kinair's
    roles `kinair_abcd`; None for an unknown name."""
    if name in PATCHES:
        return PATCHES[name]
    m = re.fullmatch(r"kinair_(\d)(\d)(\d)(\d)", name)
    if m is None:
        return None
    w = [int(g) for g in m.groups()]
    if sorted(set(w)) != list(range(max(w) + 1)):
        return None
    return [("flight_math.cuh", KINAIR_ROLES,
             "KA_KD = {}, KA_ANG = {}, KA_EUL = {}, KA_AIR = {}, "
             "KA_ROLES = {};".format(*w, max(w) + 1))]
VARIANTS = ((), ("aero",), ("legs",), ("engine",), ("propeller",),
            ("aero", "engine"), ("aero", "legs", "engine", "propeller"),
            ("sys7",), ("finish_head",), ("finish_whole",), ("finish_atm",),
            ("kinair_thread",), ("kinair_thread", "thread_skip"),
            ("kinair_thread", "inline"), ("noskip",), ("kinair_0123",),
            ("kinair_0112",), ("dynamics_roles",), ("finish_kin_thread",),
            ("finish_sys_thread",), ("finish_kin_kdeul",), ("finish_sys4",),
            ("finish_kin_inline_renorm",), ("finish_kin_norenorm",),
            ("finish_kin_nocomp",), ("ctl_laws_thread",))
TIMED = ("kinair", "dynamics", "finish_kin", "systems", "finish_sys",
         "rk4_stage", "rk4_finish", "ctl_laws", "megakernel")


def patched_sources(csrc, build_dir, patches, n_params):
    """A copy of the sources with the patches applied, for a parameter
    buffer of n_params values; returns its path."""
    dst = os.path.join(build_dir, "ablate_" + ("_".join(patches) or "none"))
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(csrc, dst)
    for name in patches:
        for fname, old, new, *every in patch(name):
            path = os.path.join(dst, fname)
            with open(path) as fh:
                text = fh.read()
            new = new.replace(N_PARAMS, str(n_params))
            if old is None:
                text = new
            elif (text.count(old) >= 1) if every else (text.count(old) == 1):
                text = text.replace(old, new)
            else:
                raise SystemExit(f"ablate: patch {name!r} does not find its "
                                 f"text {'' if every else 'once '}in "
                                 f"{fname}:\n{old}")
            with open(path, "w") as fh:
                fh.write(text)
    return dst


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--variants", default=",".join(
        "+".join(v) or "none" for v in VARIANTS))
    args = ap.parse_args()
    variants = [() if v == "none" else tuple(v.split("+"))
                for v in args.variants.split(",")]
    for v in variants:
        if any(patch(p) is None for p in v):
            ap.error(f"unknown patch in {v}; the patches are {list(PATCHES)}"
                     " and kinair_abcd")
    if not torch.cuda.is_available():
        print("ablate_torch_roles: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as S
    from flightjax_torch.parallel import kernels as K
    from flightjax_torch.parallel import launch as L
    from flightjax_torch.parallel.megakernel import make_megakernel_step
    from flightjax_torch.testing import (ctl_laws_args, perturbed_fleet_sim,
                                         xv1_fleet_sim)

    card = S.card_line()
    csrc = L.CSRC
    sim, st = perturbed_fleet_sim(args.batch, S.SEED, S.DEVICE, torch.float32)
    vehicle = sim.system.aircraft.vehicle
    params, grid = K.system_params(vehicle), K.geoid_grid(vehicle.geoid)
    # operands: the airborne flight fleet, and the kernel-check operands
    # with lanes on the runway (at B = 4096, as chip_smoke.py draws them)
    ops = {"airborne": S.flight_operands(sim, st)}
    check = S.kernel_inputs(torch.float32)
    ops["runway"] = {n: K.PACK[n](*check[n]) for n in TIMED[:-2]}
    # ctl_laws: the pass of the C172Xv1 fleet, and the mode-rich operands
    xsim, xst = xv1_fleet_sim(args.batch, S.SEED, S.DEVICE, torch.float32)
    ops["airborne"]["ctl_laws"] = K.PACK["ctl_laws"](
        *S.ctl_flight_args(xsim, xst))
    ops["runway"]["ctl_laws"] = K.PACK["ctl_laws"](*ctl_laws_args(
        args.batch, S.SEED, S.DEVICE, torch.float32, S.GROUND_LANES))
    msim, mst = S.mega_inputs(torch.float32, True)
    mega = {"airborne": make_megakernel_step(sim, st)[0],
            "runway": make_megakernel_step(msim, mst)[0]}

    def launcher(name, where, lanes):
        if name == "megakernel":
            b = mega[where]
            return lambda: L.launch_megakernel(b[0], b[1], params, grid,
                                               sim.dt, sim.t_start, True,
                                               lanes)
        buf, n_out, scal, kops = ops[where][name]
        return lambda: L.launch(name, buf, n_out, scal, block=lanes, **kops)

    results = []
    for patches in variants:
        L.CSRC = patched_sources(csrc, L.BUILD_DIR, patches, params.numel())
        L._LIB = None
        L._LAYOUTS.clear()
        row = {"patches": list(patches)}
        for name in TIMED:
            for where in ("airborne", "runway"):
                for lanes in ((32, 64, 128) if one_thread(name, patches)
                              else (32, 64)):
                    row[f"{name}_{where}_{lanes}_ms"] = S.graph_ms(
                        launcher(name, where, lanes))
        results.append(row)
        print("patched " + ("+".join(patches) or "nothing") + ": " + ", ".join(
            f"{k[:-3]} {v:.4f} ms" for k, v in row.items()
            if k != "patches") + f" (B = {args.batch}, f32) [{card}]",
            flush=True)
    print(card)
    print(json.dumps({"batch": args.batch, "card": card,
                      "variants": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
