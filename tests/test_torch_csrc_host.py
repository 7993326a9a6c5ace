"""The CUDA kernels of flightjax_torch compiled as host C++ and run on the
CPU, against their plain PyTorch versions in float64 (tolerance 1e-12
relative to max(1, |plain|)).

A stand-in `cuda_runtime.h` maps the CUDA qualifiers, the thread indices
and the `_rn` intrinsics onto plain C++ (no FMA contraction); each kernel
source is cut before its launch code, which only nvcc reads. The kernels
that carry one aircraft per thread run lane by lane, as blocks of one
thread. The role kernels (kinair, finish_kin, systems, finish_sys,
rk4_stage, rk4_finish, megakernel), which carry one aircraft in several
threads that may meet at barriers, and dynamics run block by block with one
host thread per CUDA thread: `__syncthreads()` is a barrier (one that
waits a minute, because a thread left before it, ends the process with a
message instead of hanging the run) and the block's shared memory one
static buffer. A warp vote sees a warp of one lane, so a gear
leg skips its strut exactly on the airborne lanes; whole warps vote in
`tests/test_torch_cuda.py`. So the
kernels' arithmetic, row maps, parameter buffer, role layout and barriers
are checked here, where there is no card; `tests/test_torch_cuda.py` checks
the compiled kernels on one. Skips without a host C++ compiler."""

import ctypes
import math
import functools
import os
import shutil
import subprocess

import pytest
import torch

from flightjax_torch.core.modeling import tree_leaves_with_path
from flightjax_torch.models.c172.c172s import build_vehicle
from flightjax_torch.parallel import kernels as K
from flightjax_torch.testing import (ISA_NAN_LANES, cluster_operands,
                                     isa_layer_operands)

B = 24
TOL = 1e-12
CSRC = os.path.join(os.path.dirname(K.__file__), os.pardir, "csrc")
NAMES = ("kinair", "systems", "dynamics", "finish_kin", "finish_sys")
# the kernels run block by block with their own number of threads per
# aircraft (kinair's roles, which finish_kin runs too, finish_sys's legs and
# rest, dynamics' one thread)
OWN_ROLES = ("kinair", "dynamics", "finish_kin", "finish_sys")
# the lane that crashes during the step (`testing.cluster_operands`)
CRASH_LANE = 11
VEHICLE_NAMES = ("rk4_stage", "rk4_finish", "geoid")
# each source is cut at the template of its launch code
LAUNCH_CODE = "static int launch"

CUDA_RUNTIME_STANDIN = r"""
#pragma once
#include <math.h>
#include <algorithm>
#define __device__
#define __host__
#define __global__
#define __forceinline__ inline
#define __noinline__
#define __restrict__ __restrict
#define __launch_bounds__(...)
#define __shared__
#define __align__(n) __attribute__((aligned(n)))
#include <chrono>
#include <condition_variable>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>
struct Dim { int x; };
static Dim blockIdx, blockDim;
static thread_local Dim threadIdx;
// the barrier of the block's threads; a thread that waits at it for a
// minute (one of the block left before a barrier) ends the process with a
// message rather than hang the test run
struct BlockBarrier {
  std::mutex m;
  std::condition_variable cv;
  int n = 0, count = 0;
  long gen = 0;
  void wait() {
    std::unique_lock<std::mutex> lock(m);
    const long g = gen;
    if (++count == n) {
      count = 0;
      ++gen;
      cv.notify_all();
    } else if (!cv.wait_for(lock, std::chrono::seconds(60),
                            [&] { return gen != g; })) {
      std::fprintf(stderr, "__syncthreads: %d of %d threads came\n", count,
                   n);
      std::abort();
    }
  }
};
static BlockBarrier block_barrier;
static inline void __syncthreads() { block_barrier.wait(); }
// a vote among the threads of a warp sees a warp of one lane
static inline unsigned __activemask() { return 1u; }
static inline int __any_sync(unsigned, bool p) { return p; }
// the dynamic shared memory of the block that is running
namespace fj { alignas(16) unsigned char fj_shared[1 << 18]; }
typedef void* cudaStream_t;
enum { cudaErrorInvalidValue = 1 };
static inline int cudaGetLastError() { return 0; }
static inline float __fadd_rn(float a, float b) { return a + b; }
static inline float __fsub_rn(float a, float b) { return a - b; }
static inline float __fmul_rn(float a, float b) { return a * b; }
static inline float __fdiv_rn(float a, float b) { return a / b; }
static inline double __dadd_rn(double a, double b) { return a + b; }
static inline double __dsub_rn(double a, double b) { return a - b; }
static inline double __dmul_rn(double a, double b) { return a * b; }
static inline double __ddiv_rn(double a, double b) { return a / b; }
static inline float rsqrtf(float x) { return 1.0f / sqrtf(x); }
static inline double rsqrt(double x) { return 1.0 / sqrt(x); }
static inline float __uint_as_float(unsigned u) {
  float f;
  std::memcpy(&f, &u, sizeof f);
  return f;
}
static inline double __longlong_as_double(long long u) {
  double f;
  std::memcpy(&f, &u, sizeof f);
  return f;
}
// erfinv, which the C library lacks: a first guess (Winitzki), then
// Newton's method on erf, on erfc in the tails (where 1 - |x| is exact)
static inline double erfinv(double x) {
  if (!(x > -1.0 && x < 1.0)) return x == 1.0 ? INFINITY
                                     : x == -1.0 ? -INFINITY : NAN;
  const double a = 0.147, l = log(1.0 - x * x);
  const double b = 2.0 / (M_PI * a) + 0.5 * l;
  double y = copysign(sqrt(sqrt(b * b - l / a) - b), x);
  const double c = 2.0 / sqrt(M_PI), ax = fabs(x);
  for (int k = 0; k < 8; ++k) {
    const double d = c * exp(-y * y);
    if (ax <= 0.5) y -= (erf(y) - x) / d;
    else y -= (x > 0.0 ? 1.0 : -1.0) * ((1.0 - ax) - erfc(fabs(y))) / d;
  }
  return y;
}
static inline float erfinvf(float x) { return (float)erfinv((double)x); }
static inline int __popc(unsigned x) { return __builtin_popcount(x); }
using std::min;
using std::max;
"""

# one lane per call: block b of one thread
LANE_LOOPS = r"""
#define LANES(name, ...)                                             \
  for (int b = 0; b < B; ++b) {                                      \
    blockIdx.x = b; blockDim.x = 1; threadIdx.x = 0;                 \
    k_##name::name##_kernel<SD>(__VA_ARGS__);                        \
  }
// one block after the other, a host thread i for each of its threads
#define BLOCKS(roles, lanes, ...)                                    \
  blockDim.x = (roles) * (lanes);                                    \
  block_barrier.n = blockDim.x;                                      \
  for (int g = 0; g < (B + (lanes) - 1) / (lanes); ++g) {            \
    blockIdx.x = g;                                                  \
    std::vector<std::thread> threads;                                \
    for (int i = 0; i < blockDim.x; ++i)                             \
      threads.emplace_back([=] { threadIdx.x = i; __VA_ARGS__; });   \
    for (auto& th : threads) th.join();                              \
  }
using fj::SD;
extern "C" {
// kinair, finish_kin, finish_sys (lanes aircraft per block) and dynamics
// (lanes threads per block) on one signature: the parameter buffer
// (finish_sys), the scalar and the flag (comp of finish_kin); role r
// writing into outs[r]
void host_kinair(const double* in, const double*, double* const* outs, int B,
                 double adt, int, int lanes) {
  BLOCKS(fj::KA_ROLES, lanes, k_kinair::kinair_kernel<SD>(
      (const SD*)in, (SD*)outs[i / (lanes)], B, SD(adt)))
}
void host_dynamics(const double* in, const double*, double* const* outs,
                   int B, double, int, int lanes) {
  BLOCKS(1, lanes, k_dynamics::dynamics_kernel<SD>(
      (const SD*)in, (SD*)outs[0], B))
}
void host_finish_kin(const double* in, const double*, double* const* outs,
                     int B, double c6, int comp, int lanes) {
  BLOCKS(fj::KA_ROLES, lanes, k_finish_kin::finish_kin_kernel<SD>(
      (const SD*)in, (SD*)outs[i / (lanes)], B, SD(c6), comp))
}
void host_finish_sys(const double* in, const double* p, double* const* outs,
                     int B, double c6, int, int lanes) {
  BLOCKS(k_finish_sys::FS_ROLES, lanes,
         k_finish_sys::finish_sys_kernel<fj::ACT_MECH, SD>(
             (const SD*)in, (const SD*)p, (SD*)outs[i / (lanes)], B, SD(c6)))
}
int host_roles_kinair() { return fj::KA_ROLES; }
int host_roles_dynamics() { return 1; }
int host_roles_finish_kin() { return fj::KA_ROLES; }
int host_roles_finish_sys() { return k_finish_sys::FS_ROLES; }
int host_role_row(int role, int k) { return fj::role_row(role, k); }
int host_n_roles() { return fj::N_ROLES; }
int host_n_slots() { return fj::N_SLOTS; }
// the role kernels but the megakernel, on one signature: k_prev or the
// k-sum (none for systems), the step's scalar and flag (comp of rk4_finish)
void host_systems(const double* in, const double*, const double* p,
                  double* out, int B, int n_params, double adt, int,
                  int lanes) {
  BLOCKS(fj::N_ROLES, lanes, k_systems::systems_kernel<fj::ACT_MECH, SD>(
      (const SD*)in, (const SD*)p, (SD*)out, B, n_params, SD(adt)))
}
void host_rk4_stage(const double* in, const double* k, const double* p,
                    double* out, int B, int n_params, double adt, int,
                    int lanes) {
  BLOCKS(fj::N_ROLES, lanes, k_rk4_stage::rk4_stage_kernel<fj::ACT_MECH, SD>(
      (const SD*)in, (const SD*)k, (const SD*)p, (SD*)out, B, n_params,
      SD(adt)))
}
void host_rk4_finish(const double* in, const double* k, const double* p,
                     double* out, int B, int, double c6, int comp,
                     int lanes) {
  BLOCKS(fj::N_ROLES, lanes,
         k_rk4_finish::rk4_finish_kernel<fj::ACT_MECH, SD>(
             (const SD*)in, (const SD*)k, (const SD*)p, (SD*)out, B, SD(c6),
             comp))
}
// the fly-by-wire instances on one signature: k_prev or the k-sum (the RK4
// kernels), the parameter buffer and its length, the step's scalar and flag
// (comp of rk4_finish); role r writing into outs[r]
void host_systems_fbw(const double* in, const double*, const double* p,
                      double* const* outs, int B, int n_params, double adt,
                      int, int lanes) {
  BLOCKS(fj::N_ROLES, lanes, k_systems::systems_kernel<fj::ACT_FBW, SD>(
      (const SD*)in, (const SD*)p, (SD*)outs[i / (lanes)], B, n_params,
      SD(adt)))
}
void host_finish_sys_fbw(const double* in, const double*, const double* p,
                         double* const* outs, int B, int, double c6, int,
                         int lanes) {
  BLOCKS(k_finish_sys::FS_ROLES, lanes,
         k_finish_sys::finish_sys_kernel<fj::ACT_FBW, SD>(
             (const SD*)in, (const SD*)p, (SD*)outs[i / (lanes)], B, SD(c6)))
}
void host_rk4_stage_fbw(const double* in, const double* k, const double* p,
                        double* const* outs, int B, int n_params, double adt,
                        int, int lanes) {
  BLOCKS(fj::N_ROLES, lanes, k_rk4_stage::rk4_stage_kernel<fj::ACT_FBW, SD>(
      (const SD*)in, (const SD*)k, (const SD*)p, (SD*)outs[i / (lanes)], B,
      n_params, SD(adt)))
}
void host_rk4_finish_fbw(const double* in, const double* k, const double* p,
                         double* const* outs, int B, int, double c6, int comp,
                         int lanes) {
  BLOCKS(fj::N_ROLES, lanes,
         k_rk4_finish::rk4_finish_kernel<fj::ACT_FBW, SD>(
             (const SD*)in, (const SD*)k, (const SD*)p,
             (SD*)outs[i / (lanes)], B, SD(c6), comp))
}
int host_roles_systems_fbw() { return fj::N_ROLES; }
int host_roles_finish_sys_fbw() { return k_finish_sys::FS_ROLES; }
int host_roles_rk4_stage_fbw() { return fj::N_ROLES; }
int host_roles_rk4_finish_fbw() { return fj::N_ROLES; }
int host_role_row_fbw(int role, int k) {
  return fj::role_row<fj::ACT_FBW>(role, k);
}
void host_geoid(const double* in, const double*, const double* grid,
                double* out, int B, double, int) {
  LANES(geoid, (const SD*)in, (const SD*)grid, (SD*)out, B)
}
void host_megakernel(const double* in, const int* i_in, const double* p,
                     const double* grid, double* out, int* i_out, int B,
                     int n_params, double dt, double t_start, int comp,
                     int lanes) {
  BLOCKS(fj::N_ROLES, lanes,
         k_megakernel::megakernel_kernel<fj::ACT_MECH, SD>(
             (const SD*)in, i_in, (const SD*)p, (const SD*)grid, (SD*)out,
             i_out, B, n_params, dt, t_start, comp, nullptr, 1, 0.0))
}
// the fly-by-wire megakernel (role r writing into outs[r]) and ctl_laws
// (its side r writing into outs[r])
void host_megakernel_fbw(const double* in, const int* i_in, const double* p,
                         const double* grid, const double* gains,
                         double* const* outs, int* i_out, int B,
                         int n_params, double dt, double t_start, int comp,
                         int spp, double pdt, int lanes) {
  BLOCKS(fj::N_ROLES, lanes,
         k_megakernel::megakernel_kernel<fj::ACT_FBW, SD>(
             (const SD*)in, i_in, (const SD*)p, (const SD*)grid,
             (SD*)outs[i / (lanes)], i_out, B, n_params, dt, t_start, comp,
             (const SD*)gains, spp, pdt))
}
void host_ctl_laws(const double* in, const double* gains, double* const* outs,
                   int B, double dt, int lanes) {
  BLOCKS(2, lanes, k_ctl_laws::ctl_laws_kernel<SD>(
      (const SD*)in, (const SD*)gains, (SD*)outs[i / (lanes)], B, SD(dt)))
}
// the C172Xv2's instances: the megakernel with the guidance and control
// laws' pass, and that pass as gdc_ctl_laws, on the signatures above
void host_megakernel_gdc(const double* in, const int* i_in, const double* p,
                         const double* grid, const double* gains,
                         double* const* outs, int* i_out, int B,
                         int n_params, double dt, double t_start, int comp,
                         int spp, double pdt, int lanes) {
  BLOCKS(fj::N_ROLES, lanes,
         k_megakernel::megakernel_kernel<fj::ACT_FBW, SD,
                                         k_megakernel::AV_GDC>(
             (const SD*)in, i_in, (const SD*)p, (const SD*)grid,
             (SD*)outs[i / (lanes)], i_out, B, n_params, dt, t_start, comp,
             (const SD*)gains, spp, pdt))
}
void host_gdc_ctl_laws(const double* in, const double* gains,
                       double* const* outs, int B, double dt, int lanes) {
  BLOCKS(2, lanes, k_ctl_laws::gdc_ctl_laws_kernel<SD>(
      (const SD*)in, (const SD*)gains, (SD*)outs[i / (lanes)], B, SD(dt)))
}
// the mission's instances: the megakernel with the phase machine, the
// guidance and the control laws' pass, and that pass as msn_ctl_laws, on
// the signatures above (the gains hold the mission table)
void host_megakernel_msn(const double* in, const int* i_in, const double* p,
                         const double* grid, const double* gains,
                         double* const* outs, int* i_out, int B,
                         int n_params, double dt, double t_start, int comp,
                         int spp, double pdt, int lanes) {
  BLOCKS(fj::N_ROLES, lanes,
         k_megakernel::megakernel_kernel<fj::ACT_FBW, SD,
                                         k_megakernel::AV_MSN>(
             (const SD*)in, i_in, (const SD*)p, (const SD*)grid,
             (SD*)outs[i / (lanes)], i_out, B, n_params, dt, t_start, comp,
             (const SD*)gains, spp, pdt))
}
void host_msn_ctl_laws(const double* in, const double* gains,
                       double* const* outs, int B, double dt, int lanes) {
  BLOCKS(2, lanes, k_ctl_laws::msn_ctl_laws_kernel<SD>(
      (const SD*)in, (const SD*)gains, (SD*)outs[i / (lanes)], B, SD(dt)))
}
// the turbulent C172S's instances (role r writing into outs[r]): the stage
// on the role kernels' signature, the finish with the int32 rows (i, seed,
// n), dt and t_start, the megakernel on the C172S's
void host_rk4_stage_turb(const double* in, const double* k, const double* p,
                         double* const* outs, int B, int n_params,
                         double adt, int, int lanes) {
  BLOCKS(fj::N_ROLES, lanes,
         k_rk4_stage::rk4_stage_kernel<fj::ACT_TURB, SD>(
             (const SD*)in, (const SD*)k, (const SD*)p,
             (SD*)outs[i / (lanes)], B, n_params, SD(adt)))
}
void host_rk4_finish_turb(const double* in, const double* k, const double* p,
                          const int* ints, double* const* outs, int B,
                          double c6, int comp, double dt, double t_start,
                          int lanes) {
  BLOCKS(fj::N_ROLES, lanes,
         k_rk4_finish::rk4_finish_turb_kernel<SD>(
             (const SD*)in, (const SD*)k, (const SD*)p, ints,
             (SD*)outs[i / (lanes)], B, SD(c6), comp, dt, t_start))
}
// the turbulent C172Xv1's instances, on the turbulent C172S's signatures
// (the megakernel on the fly-by-wire one)
void host_rk4_stage_fbw_turb(const double* in, const double* k,
                             const double* p, double* const* outs, int B,
                             int n_params, double adt, int, int lanes) {
  BLOCKS(fj::N_ROLES, lanes,
         k_rk4_stage::rk4_stage_kernel<fj::ACT_FBW_TURB, SD>(
             (const SD*)in, (const SD*)k, (const SD*)p,
             (SD*)outs[i / (lanes)], B, n_params, SD(adt)))
}
void host_rk4_finish_fbw_turb(const double* in, const double* k,
                              const double* p, const int* ints,
                              double* const* outs, int B, double c6,
                              int comp, double dt, double t_start,
                              int lanes) {
  BLOCKS(fj::N_ROLES, lanes,
         k_rk4_finish::rk4_finish_fbw_turb_kernel<SD>(
             (const SD*)in, (const SD*)k, (const SD*)p, ints,
             (SD*)outs[i / (lanes)], B, SD(c6), comp, dt, t_start))
}
void host_megakernel_fbw_turb(const double* in, const int* i_in,
                              const double* p, const double* grid,
                              const double* gains, double* const* outs,
                              int* i_out, int B, int n_params, double dt,
                              double t_start, int comp, int spp, double pdt,
                              int lanes) {
  BLOCKS(fj::N_ROLES, lanes,
         k_megakernel::megakernel_kernel<fj::ACT_FBW_TURB, SD,
                                         k_megakernel::AV_CTL>(
             (const SD*)in, i_in, (const SD*)p, (const SD*)grid,
             (SD*)outs[i / (lanes)], i_out, B, n_params, dt, t_start, comp,
             (const SD*)gains, spp, pdt))
}
// the turbulent C172Xv2's instances, with the guidance and with a mission's
// phase machine, on megakernel_fbw_turb's signature
void host_megakernel_gdc_turb(const double* in, const int* i_in,
                              const double* p, const double* grid,
                              const double* gains, double* const* outs,
                              int* i_out, int B, int n_params, double dt,
                              double t_start, int comp, int spp, double pdt,
                              int lanes) {
  BLOCKS(fj::N_ROLES, lanes,
         k_megakernel::megakernel_kernel<fj::ACT_FBW_TURB, SD,
                                         k_megakernel::AV_GDC>(
             (const SD*)in, i_in, (const SD*)p, (const SD*)grid,
             (SD*)outs[i / (lanes)], i_out, B, n_params, dt, t_start, comp,
             (const SD*)gains, spp, pdt))
}
void host_megakernel_msn_turb(const double* in, const int* i_in,
                              const double* p, const double* grid,
                              const double* gains, double* const* outs,
                              int* i_out, int B, int n_params, double dt,
                              double t_start, int comp, int spp, double pdt,
                              int lanes) {
  BLOCKS(fj::N_ROLES, lanes,
         k_megakernel::megakernel_kernel<fj::ACT_FBW_TURB, SD,
                                         k_megakernel::AV_MSN>(
             (const SD*)in, i_in, (const SD*)p, (const SD*)grid,
             (SD*)outs[i / (lanes)], i_out, B, n_params, dt, t_start, comp,
             (const SD*)gains, spp, pdt))
}
// the ActKind bits: what each instance's row map, scratch and parameter
// head hold (field f of SysL<act>, the scratch rows, the role rows)
int host_act_fbw(int act) { return fj::act_fbw(act); }
int host_act_turb(int act) { return fj::act_turb(act); }
#define SYSL_ROW(A)                                                      \
  {fj::SysL<A>::NX, fj::SysL<A>::NU, fj::SysL<A>::U_E, fj::SysL<A>::NXV, \
   fj::SysL<A>::CX_UATM, fj::SysL<A>::CX_TERM, fj::SysL<A>::X_TURB,      \
   fj::SysL<A>::CX_UTURB, fj::SysL<A>::CX_ETA, fj::SysL<A>::NCTX,        \
   fj::SysL<A>::P_TURB, fj::sh_rows<A>()}
int host_sysl(int act, int f) {
  const int v[4][12] = {SYSL_ROW(fj::ACT_MECH), SYSL_ROW(fj::ACT_FBW),
                        SYSL_ROW(fj::ACT_TURB), SYSL_ROW(fj::ACT_FBW_TURB)};
  return v[act][f];
}
int host_role_row_act(int act, int role, int k) {
  switch (act) {
    case fj::ACT_MECH: return fj::role_row<fj::ACT_MECH>(role, k);
    case fj::ACT_FBW: return fj::role_row<fj::ACT_FBW>(role, k);
    case fj::ACT_TURB: return fj::role_row<fj::ACT_TURB>(role, k);
    default: return fj::role_row<fj::ACT_FBW_TURB>(role, k);
  }
}
// the sensor-fed C172Xv1's instances (role r writing into outs[r]): the
// megakernel with the navigation pass on the fly-by-wire signature with
// the normal table and the work buffer (turb: megakernel_nav_turb), and
// the pass as nav_pass
void host_megakernel_nav(const double* in, const int* i_in, const double* p,
                         const double* grid, const double* gains,
                         const float* table, double* work,
                         double* const* outs, int* i_out, int B,
                         int n_params, double dt, double t_start, int comp,
                         int spp, double pdt, int turb, int lanes) {
  if (turb) {
    BLOCKS(fj::N_ROLES, lanes,
           k_megakernel::megakernel_kernel<fj::ACT_FBW_TURB, SD,
                                           k_megakernel::AV_NAV>(
               (const SD*)in, i_in, (const SD*)p, (const SD*)grid,
               (SD*)outs[i / (lanes)], i_out, B, n_params, dt, t_start, comp,
               (const SD*)gains, spp, pdt, table, (SD*)work))
  } else {
    BLOCKS(fj::N_ROLES, lanes,
           k_megakernel::megakernel_kernel<fj::ACT_FBW, SD,
                                           k_megakernel::AV_NAV>(
               (const SD*)in, i_in, (const SD*)p, (const SD*)grid,
               (SD*)outs[i / (lanes)], i_out, B, n_params, dt, t_start, comp,
               (const SD*)gains, spp, pdt, table, (SD*)work))
  }
}
// the calm sensor-fed C172Xv2's instance: megakernel_nav's signature but
// the turbulence flag
void host_megakernel_gdc_nav(const double* in, const int* i_in,
                             const double* p, const double* grid,
                             const double* gains, const float* table,
                             double* work, double* const* outs, int* i_out,
                             int B, int n_params, double dt, double t_start,
                             int comp, int spp, double pdt, int lanes) {
  BLOCKS(fj::N_ROLES, lanes,
         k_megakernel::megakernel_kernel<fj::ACT_FBW, SD,
                                         k_megakernel::AV_GDC_NAV>(
             (const SD*)in, i_in, (const SD*)p, (const SD*)grid,
             (SD*)outs[i / (lanes)], i_out, B, n_params, dt, t_start, comp,
             (const SD*)gains, spp, pdt, table, (SD*)work))
}
void host_nav_pass(const double* in, const int* i_in, const double* gains,
                   const float* table, double* work, double* const* outs,
                   int* i_out, int B, int lanes) {
  BLOCKS(fj::N_ROLES, lanes, k_nav_pass::nav_pass_kernel<SD>(
      (const SD*)in, i_in, (const SD*)gains, table, (SD*)work,
      (SD*)outs[i / (lanes)], i_out, B))
}
// the sensor-fed missions' instances: the megakernel on megakernel_gdc_nav's
// signature, the mission's pass on the estimates as msn_nav_ctl_laws, and
// nav_pass's instance that also writes the estimated h_o
void host_megakernel_msn_nav(const double* in, const int* i_in,
                             const double* p, const double* grid,
                             const double* gains, const float* table,
                             double* work, double* const* outs, int* i_out,
                             int B, int n_params, double dt, double t_start,
                             int comp, int spp, double pdt, int lanes) {
  BLOCKS(fj::N_ROLES, lanes,
         k_megakernel::megakernel_kernel<fj::ACT_FBW, SD,
                                         k_megakernel::AV_MSN_NAV>(
             (const SD*)in, i_in, (const SD*)p, (const SD*)grid,
             (SD*)outs[i / (lanes)], i_out, B, n_params, dt, t_start, comp,
             (const SD*)gains, spp, pdt, table, (SD*)work))
}
// the sensor-fed C172Xv2's and missions' turbulent instances, on
// megakernel_gdc_nav's signature (their i the rows i, seed, n, NAV_INT)
void host_megakernel_gdc_nav_turb(const double* in, const int* i_in,
                                  const double* p, const double* grid,
                                  const double* gains, const float* table,
                                  double* work, double* const* outs,
                                  int* i_out, int B, int n_params, double dt,
                                  double t_start, int comp, int spp,
                                  double pdt, int lanes) {
  BLOCKS(fj::N_ROLES, lanes,
         k_megakernel::megakernel_kernel<fj::ACT_FBW_TURB, SD,
                                         k_megakernel::AV_GDC_NAV>(
             (const SD*)in, i_in, (const SD*)p, (const SD*)grid,
             (SD*)outs[i / (lanes)], i_out, B, n_params, dt, t_start, comp,
             (const SD*)gains, spp, pdt, table, (SD*)work))
}
void host_megakernel_msn_nav_turb(const double* in, const int* i_in,
                                  const double* p, const double* grid,
                                  const double* gains, const float* table,
                                  double* work, double* const* outs,
                                  int* i_out, int B, int n_params, double dt,
                                  double t_start, int comp, int spp,
                                  double pdt, int lanes) {
  BLOCKS(fj::N_ROLES, lanes,
         k_megakernel::megakernel_kernel<fj::ACT_FBW_TURB, SD,
                                         k_megakernel::AV_MSN_NAV>(
             (const SD*)in, i_in, (const SD*)p, (const SD*)grid,
             (SD*)outs[i / (lanes)], i_out, B, n_params, dt, t_start, comp,
             (const SD*)gains, spp, pdt, table, (SD*)work))
}
void host_msn_nav_ctl_laws(const double* in, const double* gains,
                           double* const* outs, int B, double dt, int lanes) {
  BLOCKS(2, lanes, k_ctl_laws::msn_ctl_laws_kernel<SD, fj::MSN_NAV_KIND>(
      (const SD*)in, (const SD*)gains, (SD*)outs[i / (lanes)], B, SD(dt)))
}
void host_nav_pass_msn_nav(const double* in, const int* i_in,
                           const double* gains, const float* table,
                           double* work, double* const* outs, int* i_out,
                           int B, int lanes) {
  BLOCKS(fj::N_ROLES, lanes,
         k_nav_pass::nav_pass_kernel<SD, fj::MSN_NAV_KIND>(
             (const SD*)in, i_in, (const SD*)gains, table, (SD*)work,
             (SD*)outs[i / (lanes)], i_out, B))
}
int host_nav_rows(int k) {
  const int v[6] = {fj::N_NAVU, fj::N_NAVS, fj::N_NAVI, fj::N_NAVT,
                    fj::N_WORK, fj::N_NAVP};
  return v[k];
}
// the second-order elevator's instances (ACT_FBW_A2) on the fly-by-wire
// signatures (role r writing into outs[r]), its role rows and row counts
void host_rk4_stage_fbw_a2(const double* in, const double* k,
                           const double* p, double* const* outs, int B,
                           int n_params, double adt, int, int lanes) {
  BLOCKS(fj::N_ROLES, lanes,
         k_rk4_stage::rk4_stage_kernel<fj::ACT_FBW_A2, SD>(
             (const SD*)in, (const SD*)k, (const SD*)p,
             (SD*)outs[i / (lanes)], B, n_params, SD(adt)))
}
void host_rk4_finish_fbw_a2(const double* in, const double* k,
                            const double* p, double* const* outs, int B, int,
                            double c6, int comp, int lanes) {
  BLOCKS(fj::N_ROLES, lanes,
         k_rk4_finish::rk4_finish_kernel<fj::ACT_FBW_A2, SD>(
             (const SD*)in, (const SD*)k, (const SD*)p,
             (SD*)outs[i / (lanes)], B, SD(c6), comp))
}
int host_roles_rk4_stage_fbw_a2() { return fj::N_ROLES; }
int host_roles_rk4_finish_fbw_a2() { return fj::N_ROLES; }
void host_megakernel_fbw_a2(const double* in, const int* i_in,
                            const double* p, const double* grid,
                            const double* gains, double* const* outs,
                            int* i_out, int B, int n_params, double dt,
                            double t_start, int comp, int spp, double pdt,
                            int lanes) {
  BLOCKS(fj::N_ROLES, lanes,
         k_megakernel::megakernel_kernel<fj::ACT_FBW_A2, SD,
                                         k_megakernel::AV_CTL>(
             (const SD*)in, i_in, (const SD*)p, (const SD*)grid,
             (SD*)outs[i / (lanes)], i_out, B, n_params, dt, t_start, comp,
             (const SD*)gains, spp, pdt))
}
int host_role_row_a2(int role, int k) {
  return fj::role_row<fj::ACT_FBW_A2>(role, k);
}
int host_a2_rows(int f) {
  using L = fj::SysL<fj::ACT_FBW_A2>;
  const int v[10] = {fj::ACT_FBW_A2, L::NX, L::NXV, L::NCTX, L::NACT,
                     k_megakernel::MegaL<fj::ACT_FBW_A2>::ROWS,
                     fj::sh_rows<fj::ACT_FBW_A2>(),
                     fj::P_A2 + fj::A2_N * fj::n_a2(fj::ACT_FBW_A2),
                     fj::act_slot(fj::ACT_FBW_A2, fj::CH_ELV),
                     fj::act_slot(fj::ACT_FBW_A2, fj::CH_FLAPS)};
  return v[f];
}
void host_megakernel_turb(const double* in, const int* i_in, const double* p,
                          const double* grid, double* const* outs,
                          int* i_out, int B, int n_params, double dt,
                          double t_start, int comp, int lanes) {
  BLOCKS(fj::N_ROLES, lanes,
         k_megakernel::megakernel_kernel<fj::ACT_TURB, SD>(
             (const SD*)in, i_in, (const SD*)p, (const SD*)grid,
             (SD*)outs[i / (lanes)], i_out, B, n_params, dt, t_start, comp,
             nullptr, 1, 0.0))
}
}
"""


def _compiler():
    return shutil.which("g++") or shutil.which("c++") or shutil.which(
        "clang++")


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    cxx = _compiler()
    if cxx is None:
        pytest.skip("needs a host C++ compiler")
    d = tmp_path_factory.mktemp("csrc_host")
    (d / "cuda_runtime.h").write_text(CUDA_RUNTIME_STANDIN)
    parts = ['#include "c172_systems.cuh"', '#include "c172x_ctl.cuh"',
             '#include "c172x_gdc.cuh"', '#include "c172x_msn.cuh"',
             '#include "nav.cuh"']
    for name in NAMES + VEHICLE_NAMES + ("megakernel", "ctl_laws",
                                         "nav_pass"):
        with open(os.path.join(CSRC, f"{name}.cu")) as fh:
            src = fh.read()
        assert LAUNCH_CODE in src, name
        src = src[:src.rindex("template", 0, src.index(LAUNCH_CODE))]
        src = src.replace("using namespace fj;", "")
        parts.append(f"namespace k_{name} {{\nusing namespace fj;\n{src}\n}}")
    (d / "kernels.cpp").write_text("\n".join(parts) + LANE_LOOPS)
    so = d / "kernels.so"
    proc = subprocess.run(
        [cxx, "-std=c++17", "-O1", "-ffp-contract=off", "-fPIC", "-shared",
         "-pthread",
         "-I", str(d), "-I", CSRC, str(d / "kernels.cpp"), "-o", str(so)],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return ctypes.CDLL(str(so))


def _cluster(batch):
    """The cluster operands of these tests: lanes 3 and 17 on the runway,
    lane 5 terminated, CRASH_LANE crashing during the step."""
    return cluster_operands(batch, 1016, (3, 17), (5,), (CRASH_LANE,))


def _operands(batch):
    veh = build_vehicle(device="cpu", dtype=torch.float64)
    return K.operand_args(_cluster(batch), veh, "cpu", torch.float64)


@pytest.fixture(scope="module")
def operands():
    return _operands(B)


def _ptr(t):
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _assert_trees_close(got, ref, equal_nan=False):
    """Within TOL everywhere; with `equal_nan`, NaN where the reference is
    NaN and only there."""
    g, r = tree_leaves_with_path(got), tree_leaves_with_path(ref)
    assert [p for p, _ in g] == [p for p, _ in r]
    for (p, a), (_, b) in zip(g, r):
        assert a.dtype == b.dtype and a.shape == b.shape, p
        if equal_nan and a.dtype.is_floating_point:
            assert torch.equal(a.isnan(), b.isnan()), p
            a, b = a[~b.isnan()], b[~b.isnan()]
        err = ((a.double() - b.double()).abs()
               / b.double().abs().clamp_min(1.0)).max()
        assert float(err) <= TOL, (p, float(err))


def _run_role(host_lib, name, args, lanes):
    """The source of role kernel `name` (systems, rk4_stage, rk4_finish) on
    the wrapper's arguments, block by block at `lanes` aircraft per block;
    returns its packed output."""
    buf, n_out, scalars, ops = K.PACK[name](*args)
    batch, params = buf.shape[1], ops["params"]
    out = torch.full((n_out, batch), float("nan"), dtype=torch.float64)
    getattr(host_lib, f"host_{name}")(
        _ptr(buf), _ptr(ops.get("k")), _ptr(params), _ptr(out),
        ctypes.c_int(batch), ctypes.c_int(params.numel()),
        ctypes.c_double(scalars[0]),
        ctypes.c_int(scalars[1] if len(scalars) > 1 else 0),
        ctypes.c_int(lanes))
    return out


def _run_own_roles(host_lib, name, args, lanes, split=False):
    """The source of kinair, finish_kin, finish_sys (`lanes` aircraft per
    block) or dynamics (`lanes` threads per block) on the wrapper's
    arguments, block by block; returns its packed output, or with `split`
    one output per role that holds the rows the role wrote and NaN
    elsewhere."""
    buf, n_out, scalars, ops = K.PACK[name](*args)
    scalars = tuple(scalars) + (0.0, 0)[len(scalars):]
    batch = buf.shape[1]
    n_roles = getattr(host_lib, f"host_roles_{name}")()
    outs = [torch.full((n_out, batch), float("nan"), dtype=torch.float64)
            for _ in range(n_roles if split else 1)]
    ptrs = (ctypes.c_void_p * n_roles)(
        *(outs[r if split else 0].data_ptr() for r in range(n_roles)))
    getattr(host_lib, f"host_{name}")(
        _ptr(buf), _ptr(ops.get("params")), ptrs, ctypes.c_int(batch),
        ctypes.c_double(scalars[0]), ctypes.c_int(scalars[1]),
        ctypes.c_int(lanes))
    return outs if split else outs[0]


def _run_rk4_stage(host_lib, args, lanes):
    return K._x_tree(K.unpack(K.STAGE_OUT,
                              _run_role(host_lib, "rk4_stage", args, lanes)))


# batches that are no multiple of the aircraft per block: a ragged only
# block, a full block and a ragged one, and the same at 64 per block
RAGGED = [(37, 32), (24, 64), (70, 64)]
RAGGED_IDS = [f"B{b}-L{n}" for b, n in RAGGED]


# the kernels at B (the role kernels at 32 aircraft per block), and all of
# them also on the ragged batches
RAGGED_NAMES = ("kinair", "systems", "dynamics", "finish_kin", "finish_sys")


@pytest.mark.parametrize(
    "name,batch,lanes",
    [(n, B, 32) for n in NAMES]
    + [(n, b, lanes) for n in RAGGED_NAMES for b, lanes in RAGGED],
    ids=[*NAMES, *(f"{n}-{i}" for n in RAGGED_NAMES for i in RAGGED_IDS)])
def test_kernel_source_matches_plain(host_lib, operands, name, batch,
                                     lanes):
    args = (operands if batch == B else _operands(batch))[name]
    if name == "systems":
        out = _run_role(host_lib, name, args, lanes)
    else:
        out = _run_own_roles(host_lib, name, args, lanes)
    got = K.unpack_out(name, out,
                       name == "finish_kin" and args[-1] is not None)
    if name in ("kinair", "systems", "dynamics"):
        args = args[:-1] + (args[-1].to(torch.float64),)
    ref = getattr(K, name + "_plain")(*args)
    if name == "finish_sys":  # the crash lane latches during the step
        assert not bool(args[4]["crashed"][CRASH_LANE])
        assert bool(got[1]["crashed"][CRASH_LANE])
    _assert_trees_close(got, ref)


# the whole-vehicle kernels at B, rk4_finish also on the ragged batches
# with and without residuals
@pytest.mark.parametrize(
    "name,comp,batch,lanes",
    [("rk4_stage", False, B, 32), ("rk4_finish", False, B, 32),
     ("rk4_finish", True, B, 32), ("geoid", False, B, 32)]
    + [("rk4_finish", comp, b, n) for b, n in RAGGED
       for comp in (False, True)],
    ids=["rk4_stage", "rk4_finish", "rk4_finish-comp", "geoid"]
    + [f"rk4_finish{'-comp' if comp else ''}-{i}" for i in RAGGED_IDS
       for comp in (False, True)])
def test_vehicle_kernel_source_matches_plain(host_lib, operands, name,
                                             comp, batch, lanes):
    args = (operands if batch == B else _operands(batch))[name]
    if name == "rk4_finish" and not comp:
        args = args[:-1] + (None,)
    if name == "rk4_stage":
        got = _run_rk4_stage(host_lib, args, lanes)
    elif name == "rk4_finish":
        got = K.unpack_out(name, _run_role(host_lib, name, args, lanes),
                           comp)
    else:
        buf, n_out, _, ops = K.PACK[name](*args)
        out = torch.full((n_out, B), float("nan"), dtype=torch.float64)
        host_lib.host_geoid(_ptr(buf), _ptr(None), _ptr(ops["grid"]),
                            _ptr(out), ctypes.c_int(B), ctypes.c_double(0.0),
                            ctypes.c_int(0))
        got = out[0]
    _assert_trees_close(got, getattr(K, name + "_plain")(*args))


@pytest.mark.parametrize(
    "name,comp", [("kinair", None), ("dynamics", None), ("finish_kin", True),
                  ("finish_kin", False)],
    ids=["kinair", "dynamics", "finish_kin-comp", "finish_kin"])
def test_kinair_dynamics_source_on_isa_layers(host_lib, name, comp):
    """kinair, dynamics and finish_kin (with and without residuals) on the
    ISA-layer operands (`testing.isa_layer_operands`): heights in every ISA
    layer and on either side of the first layer's ceiling, where kinair and
    finish_kin skip the layers above the aircraft, and NaN sea-level
    temperatures, which stay NaN through the atmosphere as in the plain
    version."""
    vehicle = build_vehicle(device="cpu", dtype=torch.float64)
    args = K.operand_args(isa_layer_operands(B, 1016), vehicle, "cpu",
                          torch.float64)[name]
    if name == "finish_kin":
        args = args[:-1] + (args[-1] if comp else None,)
    else:
        args = args[:-1] + (args[-1].to(torch.float64),)
    got = K.unpack_out(name, _run_own_roles(host_lib, name, args, 32),
                       name == "finish_kin" and comp)
    ref = getattr(K, name + "_plain")(*args)
    if name != "dynamics":
        assert bool(ref[-2 if name == "finish_kin" else 2].p[
            list(ISA_NAN_LANES)].isnan().all())
    _assert_trees_close(got, ref, equal_nan=True)


@pytest.mark.parametrize("name", OWN_ROLES)
def test_kinair_dynamics_roles_partition_the_output(host_lib, operands,
                                                   name):
    """Every output row of kinair, dynamics, finish_kin and finish_sys is
    written by exactly one of its roles (dynamics has one), for every
    aircraft, and by no other role anywhere."""
    outs = _run_own_roles(host_lib, name, operands[name], 32, split=True)
    n_rows = outs[0].shape[0]
    full = sum((~o.isnan()).all(dim=1).int() for o in outs)
    touched = sum((~o.isnan()).any(dim=1).int() for o in outs)
    assert full.tolist() == [1] * n_rows
    assert touched.tolist() == [1] * n_rows


def test_roles_partition_the_state(host_lib):
    """Every row of X is integrated by exactly one role of the role
    kernels (`role_row` of csrc/c172_systems.cuh)."""
    rows = [host_lib.host_role_row(role, k)
            for role in range(host_lib.host_n_roles())
            for k in range(host_lib.host_n_slots())]
    owned = sorted(r for r in rows if r >= 0)
    assert owned == list(range(K.rows(K.X_GROUPS)))


@pytest.mark.parametrize("batch,lanes", RAGGED, ids=RAGGED_IDS)
def test_rk4_stage_source_ragged_batch(host_lib, batch, lanes):
    args = _operands(batch)["rk4_stage"]
    _assert_trees_close(_run_rk4_stage(host_lib, args, lanes),
                        K.rk4_stage_plain(*args))


def _check_megakernel(host_lib, batch, lanes, comp):
    from flightjax_torch.core.sim import comp_residuals
    from flightjax_torch.models.c172.c172s import flagship_sim
    from flightjax_torch.parallel.megakernel import (make_megakernel_step,
                                                     megakernel_step_plain)
    from flightjax_torch.testing import operand_state
    sim, _, _ = flagship_sim("cpu", torch.float64)
    st = operand_state(_cluster(batch), "cpu", torch.float64, i0=126)
    if comp:
        st = st._replace(c=comp_residuals(st.x, force=True))
    bufs, _, unpack = make_megakernel_step(sim, st)
    vehicle = sim.system.aircraft.vehicle
    params = K.system_params(vehicle)
    out = torch.full_like(bufs[0], float("nan"))
    i_out = torch.full_like(bufs[1], -1)
    host_lib.host_megakernel(
        _ptr(bufs[0]), _ptr(bufs[1]), _ptr(params),
        _ptr(K.geoid_grid(vehicle.geoid)), _ptr(out), _ptr(i_out),
        ctypes.c_int(batch), ctypes.c_int(params.numel()),
        ctypes.c_double(sim.dt), ctypes.c_double(sim.t_start),
        ctypes.c_int(int(comp)), ctypes.c_int(lanes))
    got, ref = unpack((out, i_out)), megakernel_step_plain(sim, st)
    for name in ("t", "i", "x", "u", "s", "c"):
        _assert_trees_close({name: getattr(got, name)},
                            {name: getattr(ref, name)})


@pytest.mark.parametrize("comp", [False, True],
                         ids=["uncompensated", "compensated"])
def test_megakernel_source_matches_plain(host_lib, comp):
    _check_megakernel(host_lib, B, 32, comp)


@pytest.mark.parametrize("comp", [False, True],
                         ids=["uncompensated", "compensated"])
@pytest.mark.parametrize("batch,lanes", RAGGED, ids=RAGGED_IDS)
def test_megakernel_source_ragged_batch(host_lib, batch, lanes, comp):
    _check_megakernel(host_lib, batch, lanes, comp)


# ------------------------------------------------------------ fly-by-wire

FBW_NAMES = ("systems_fbw", "finish_sys_fbw", "rk4_stage_fbw",
             "rk4_finish_fbw")


def _fbw_operands(batch):
    """The wrapper arguments on the fly-by-wire C172 at the cluster operands
    of these tests (`testing.fbw_cluster_operands`: lanes 3 and 17 on the
    runway, lane 5 terminated, CRASH_LANE crashing in the step)."""
    from flightjax_torch.models.c172.c172x import build_vehicle as fbw_vehicle
    from flightjax_torch.testing import fbw_cluster_operands
    veh = fbw_vehicle(device="cpu", dtype=torch.float64)
    d = fbw_cluster_operands(batch, 1016, (3, 17), (5,), (CRASH_LANE,))
    args = K.operand_args(d, veh, "cpu", torch.float64)
    return {K.FBW.names[k]: args[k] for k in K.FBW.names}


@pytest.fixture(scope="module")
def fbw_operands():
    return _fbw_operands(B)


def _run_fbw(host_lib, name, args, lanes, split=False):
    """The fly-by-wire instance `name` on the wrapper's arguments, block by
    block at `lanes` aircraft per block; its packed output, or with `split`
    one per role holding the rows the role wrote and NaN elsewhere."""
    buf, n_out, scalars, ops = K.PACK[name](*args)
    batch, params = buf.shape[1], ops["params"]
    n_roles = getattr(host_lib, f"host_roles_{name}")()
    outs = [torch.full((n_out, batch), float("nan"), dtype=torch.float64)
            for _ in range(n_roles if split else 1)]
    ptrs = (ctypes.c_void_p * n_roles)(
        *(outs[r if split else 0].data_ptr() for r in range(n_roles)))
    getattr(host_lib, f"host_{name}")(
        _ptr(buf), _ptr(ops.get("k")), _ptr(params), ptrs,
        ctypes.c_int(batch), ctypes.c_int(params.numel()),
        ctypes.c_double(scalars[0]),
        ctypes.c_int(scalars[1] if len(scalars) > 1 else 0),
        ctypes.c_int(lanes))
    return outs if split else outs[0]


_PLAIN_FBW = {"systems_fbw": K.systems_plain,
              "finish_sys_fbw": K.finish_sys_plain,
              "rk4_stage_fbw": K.rk4_stage_plain,
              "rk4_finish_fbw": K.rk4_finish_plain}


def _fbw_plain_args(name, args, comp):
    if name in ("systems_fbw", "rk4_stage_fbw"):
        return args[:-2] + (args[-2].to(torch.float64), args[-1]) \
            if name == "rk4_stage_fbw" else \
            args[:-1] + (args[-1].to(torch.float64),)
    if name == "rk4_finish_fbw" and not comp:
        return args[:-1] + (None,)
    return args


FBW_CASES = ([(n, False, B, 32) for n in FBW_NAMES]
             + [("rk4_finish_fbw", True, B, 32)]
             + [(n, c, b, lanes) for n, c in
                (("systems_fbw", False), ("finish_sys_fbw", False),
                 ("rk4_stage_fbw", False), ("rk4_finish_fbw", True))
                for b, lanes in RAGGED])
FBW_IDS = ([*FBW_NAMES, "rk4_finish_fbw-comp"]
           + [f"{n}-{i}" for n in ("systems_fbw", "finish_sys_fbw",
                                   "rk4_stage_fbw", "rk4_finish_fbw-comp")
              for i in RAGGED_IDS])


@pytest.mark.parametrize("name,comp,batch,lanes", FBW_CASES, ids=FBW_IDS)
def test_fbw_kernel_source_matches_plain(host_lib, fbw_operands, name, comp,
                                         batch, lanes):
    """The fly-by-wire instances against their plain versions: the servo
    states (stage point, derivative, combine), the rudder servo steering
    the nose leg, and what the finishes store for the avionics."""
    args = (fbw_operands if batch == B else _fbw_operands(batch))[name]
    args = _fbw_plain_args(name, args, comp)
    if name == "systems_fbw":
        kargs = args[:-1] + (args[-1] > 0.5,)
    elif name == "rk4_stage_fbw":
        kargs = args[:-2] + (args[-2] > 0.5, args[-1])
    else:
        kargs = args
    got = K.unpack_out(name, _run_fbw(host_lib, name, kargs, lanes), comp)
    ref = _PLAIN_FBW[name](*args)
    _assert_trees_close(got, ref)
    if name in ("finish_sys_fbw", "rk4_finish_fbw"):
        s_in = args[4]["systems"] if name == "rk4_finish_fbw" else args[4]
        s_out = got[1]
        assert not bool(s_in["crashed"][CRASH_LANE])
        assert bool(s_out["crashed"][CRASH_LANE])


@pytest.mark.parametrize("name", FBW_NAMES)
def test_fbw_roles_partition_the_output(host_lib, fbw_operands, name):
    """Every output row of each fly-by-wire instance, the servo rows and
    the avionics' rows among them, is written by exactly one of its roles,
    for every aircraft, and by no other role anywhere."""
    args = fbw_operands[name]
    outs = _run_fbw(host_lib, name, args, 32, split=True)
    n_rows = outs[0].shape[0]
    full = sum((~o.isnan()).all(dim=1).int() for o in outs)
    touched = sum((~o.isnan()).any(dim=1).int() for o in outs)
    assert full.tolist() == [1] * n_rows
    assert touched.tolist() == [1] * n_rows


def test_fbw_roles_partition_the_state(host_lib):
    """Every row of the fly-by-wire X is integrated by exactly one role
    (`role_row<ACT_FBW>`): role DRAG the seven servo states."""
    rows = [host_lib.host_role_row_fbw(role, k)
            for role in range(host_lib.host_n_roles())
            for k in range(host_lib.host_n_slots())]
    owned = sorted(r for r in rows if r >= 0)
    assert owned == list(range(K.rows(K.FBW.x_groups)))


# ------------------------------------------------------------ Actuator2

A2_NAMES = ("rk4_stage_fbw_a2", "rk4_finish_fbw_a2")
A2_ROWS = ("ACT", "NX", "NXV", "NCTX", "NACT", "MEGA", "SH_ROWS", "P_HEAD",
           "SLOT_ELV", "SLOT_FLAPS")


def _a2_args(operands, batch=B):
    """The wrapper arguments of the second-order elevator's whole-vehicle
    instances: on the runway operands (`testing.fbw_cluster_operands` with
    the elevator second-order: lanes 3 and 17 on the runway, lane 5
    terminated, CRASH_LANE crashing, servo positions past their ranges,
    the elevator's rate and its derivative drawn), or airborne on the
    turning-climb fleet (`testing.xv1_fleet_sim`, `flight_operand_args`)."""
    from flightjax_torch.models.c172.c172x import Actuator2
    from flightjax_torch.models.c172.c172x import build_vehicle as fbw_vehicle
    from flightjax_torch.testing import (fbw_cluster_operands,
                                         flight_operand_args, xv1_fleet_sim)
    if operands == "airborne":
        sim, st = xv1_fleet_sim(batch, 1016, "cpu", torch.float64,
                                a2=K.A2_CARD)
        args = flight_operand_args(sim, st)
    else:
        veh = fbw_vehicle(device="cpu", dtype=torch.float64,
                          actuators={"elevator": Actuator2()})
        d = fbw_cluster_operands(batch, 1016, (3, 17), (5,), (CRASH_LANE,),
                                 a2=K.A2_CARD)
        args = K.operand_args(d, veh, "cpu", torch.float64)
    return {K.FBW_A2.names[k]: args[k] for k in ("rk4_stage", "rk4_finish")}


A2_CASES = [(n, o, False) for o in ("runway", "airborne")
            for n in A2_NAMES] + [("rk4_finish_fbw_a2", "runway", True)]


@pytest.mark.parametrize("name,operands,comp", A2_CASES,
                         ids=[f"{n}-{o}" + "-comp" * c
                              for n, o, c in A2_CASES])
def test_a2_kernel_source_matches_plain(host_lib, name, operands, comp):
    """rk4_stage_fbw_a2 and rk4_finish_fbw_a2 against their plain versions
    on the runway and the airborne operands: the elevator's position and
    rate (stage point, derivative, combine), its position clipped where it
    is past the range, the commands clipped, the nose leg steered by the
    rudder servo, what the finish stores for the avionics."""
    args = _a2_args(operands)[name]
    if name == "rk4_stage_fbw_a2":
        args = args[:-2] + (args[-2].to(torch.float64), args[-1])
        kargs = args[:-2] + (args[-2] > 0.5, args[-1])
    else:
        args = args if comp else args[:7] + (None,)
        kargs = args
    got = K.unpack_out(name, _run_fbw(host_lib, name, kargs, 32), comp)
    ref = (K.rk4_stage_plain if name == "rk4_stage_fbw_a2"
           else K.rk4_finish_plain)(*args)
    _assert_trees_close(got, ref)
    elv = args[1]["systems"]["act"]["elevator"]
    assert set(elv) == {"p", "v"} and bool((elv["v"] != 0).all())
    if operands == "runway":
        assert bool((elv["p"].abs() > 1.0).any())


# ------------------------------------------------------------ control laws

def _run_ctl_laws(host_lib, args, lanes, by_side=False, name="ctl_laws"):
    """The source of ctl_laws (or `name` gdc_ctl_laws) on the wrapper's
    arguments, block by block at `lanes` aircraft per block, the lon and
    lat passes in two sides; its packed output, or with `by_side` one
    output per side holding the rows the side wrote and NaN elsewhere."""
    buf, n_out, scalars, ops = K.PACK[name](*args)
    batch, n_sides = buf.shape[1], 2
    outs = [torch.full((n_out, batch), float("nan"), dtype=torch.float64)
            for _ in range(n_sides if by_side else 1)]
    ptrs = (ctypes.c_void_p * n_sides)(
        *(outs[r if by_side else 0].data_ptr() for r in range(n_sides)))
    getattr(host_lib, f"host_{name}")(
        _ptr(buf), _ptr(ops["gains"]), ptrs, ctypes.c_int(batch),
        ctypes.c_double(scalars[0]), ctypes.c_int(lanes))
    return outs if by_side else outs[0]


def _ctl_args(batch):
    from flightjax_torch.testing import ctl_laws_args
    return ctl_laws_args(batch, 1016, "cpu", torch.float64, (3, 17))


FLEET_LANES = {"sas": 2, "ground": 9}


def _ctl_fleet_args(batch):
    """ctl_laws' arguments on the pass of the C172Xv1 fleet on the turning
    climb (`testing.xv1_fleet_sim`, with a SAS lane and a lane on the
    ground), one megakernel step in, so that the servos and the avionics
    carry what a pass left: the operands `chip_smoke.py` times it on."""
    from flightjax_torch.parallel.megakernel import make_megakernel_step
    from flightjax_torch.testing import xv1_fleet_sim
    sim, st = xv1_fleet_sim(batch, 1016, "cpu", torch.float64,
                            sas_lanes=(FLEET_LANES["sas"],),
                            ground_lanes=(FLEET_LANES["ground"],))
    bufs, step, unpack = make_megakernel_step(sim, st)
    st = unpack(step(bufs))
    aircraft = sim.system.aircraft
    vy = aircraft.vehicle.output(st.x["vehicle"], st.u["vehicle"],
                                 st.s["vehicle"])
    return (aircraft.avionics, K.ctl_y(vy), st.u["avionics"],
            st.s["avionics"], sim.periodic_dt)


CTL_CASES = ([("rich", B, 32)] + [("rich", b, n) for b, n in RAGGED]
             + [("fleet", 37, 32), ("fleet", 37, 64)])


@pytest.mark.parametrize(
    "operands,batch,lanes", CTL_CASES,
    ids=[("" if o == "rich" else o + "-") + f"B{b}-L{n}"
         for o, b, n in CTL_CASES])
def test_ctl_laws_source_matches_plain(host_lib, operands, batch, lanes):
    """ctl_laws against `ctl_laws_plain` on the mode-rich operands: every
    lon mode (the altitude mode acquiring and holding) and every lat mode,
    mode changes, lanes on the ground, altitude errors on both sides of
    the altitude machine's switch points, saturation flags of both signs,
    EAS and heights past the gain schedules' grid; and on the pass of the
    C172Xv1 fleet (`_ctl_fleet_args`)."""
    args = _ctl_args(batch) if operands == "rich" else _ctl_fleet_args(batch)
    got = K.unpack_out("ctl_laws", _run_ctl_laws(host_lib, args, lanes))
    ref = K.ctl_laws_plain(*args)
    _assert_trees_close(got, ref)
    if operands == "fleet":  # the autopilot's climb, SAS, ground override
        lon = ref[0]["lon"]["mode_prev"].tolist()
        assert lon[FLEET_LANES["sas"]] == 1 and lon[FLEET_LANES["ground"]] == 0
        assert lon.count(7) == batch - 2
    elif batch == B:
        lon = ref[0]["lon"]["mode_prev"]
        lat = ref[0]["lat"]["mode_prev"]
        assert set(lon.tolist()) == set(range(9))
        assert set(lat.tolist()) == set(range(5))
        s_in = args[3]
        assert bool((lon != s_in["lon"]["mode_prev"]).any())
        assert bool((lon == s_in["lon"]["mode_prev"]).any())


def test_ctl_laws_sides_partition_the_output(host_lib):
    """Every output row of ctl_laws is written by exactly one of its two
    sides (lon, lat), for every aircraft, and by no other side."""
    outs = _run_ctl_laws(host_lib, _ctl_args(B), 32, by_side=True)
    full = sum((~o.isnan()).all(dim=1).int() for o in outs)
    touched = sum((~o.isnan()).any(dim=1).int() for o in outs)
    assert full.tolist() == [1] * outs[0].shape[0]
    assert touched.tolist() == [1] * outs[0].shape[0]


@functools.lru_cache(maxsize=None)
def _xv1_sim(spp, a2=()):
    """The C172Xv1 Simulation, float64 on the CPU, whose periodic pass
    fires every `spp` steps (one per module), with second-order servos on
    the channels `a2`."""
    from flightjax_torch.core.sim import Simulation
    from flightjax_torch.models.c172.c172x import Actuator2, c172xv1_sim
    sim, _, _ = c172xv1_sim("cpu", torch.float64, actuators={
        ch: Actuator2() for ch in a2} if a2 else None)
    return Simulation(sim.system, dt=sim.dt, periodic_dt=spp * sim.dt,
                      geoid_every=sim.geoid_every)


@functools.lru_cache(maxsize=None)
def _xv1_state(batch):
    """The C172Xv1 cluster state of `batch` lanes with the mode-rich
    avionics at step 126 (`testing.xv1_operand_state`), made once."""
    from flightjax_torch.testing import xv1_operand_state
    return xv1_operand_state(batch, 1016, "cpu", torch.float64, (3, 17),
                             (5,), (CRASH_LANE,), i0=126)


def _run_megakernel_fbw(host_lib, batch, lanes, comp, spp=1, by_role=False,
                        gdc=False, msn=False, a2=None):
    """The fly-by-wire megakernel's source on the C172Xv1 cluster state
    (`_xv1_state`: the fly-by-wire cluster operands with the mode-rich
    avionics; with spp = 2 every other lane's counter fires), block by
    block; (sim, state, the kernel's new state) or with `by_role` (sim,
    state, one state buffer per role, NaN where the role wrote nothing).
    With `gdc` its C172Xv2 instance on the C172Xv2 cluster state
    (`_xv2_state`, the mode-rich guidance too), with `msn` its mission
    instance on the mission's cluster state (`_msn_state`, every phase
    too); with `a2` "runway" or "airborne" its second-order elevator's
    instance on that cluster state or on the turning-climb fleet
    (`_a2_state`)."""
    from flightjax_torch.core.sim import comp_residuals
    from flightjax_torch.parallel.megakernel import make_megakernel_step
    sim, st = ((_msn_sim(spp), _msn_state(batch)) if msn
               else (_xv2_sim(spp), _xv2_state(batch)) if gdc
               else (_xv1_sim(spp, K.A2_CARD), _a2_state(batch, a2)) if a2
               else (_xv1_sim(spp), _xv1_state(batch)))
    st = st._replace(i=st.i + torch.arange(batch, dtype=torch.int32) % spp)
    if comp:
        st = st._replace(c=comp_residuals(st.x, force=True))
    bufs, _, unpack = make_megakernel_step(sim, st)
    aircraft = sim.system.aircraft
    params = K.system_params(aircraft.vehicle)
    n_roles = host_lib.host_n_roles()
    outs = [torch.full_like(bufs[0], float("nan"))
            for _ in range(n_roles if by_role else 1)]
    ptrs = (ctypes.c_void_p * n_roles)(
        *(outs[r if by_role else 0].data_ptr() for r in range(n_roles)))
    i_out = torch.full_like(bufs[1], -1)
    getattr(host_lib, "host_megakernel_" + ("msn" if msn else "gdc" if gdc
                                            else "fbw_a2" if a2 else "fbw"))(
        _ptr(bufs[0]), _ptr(bufs[1]), _ptr(params),
        _ptr(K.geoid_grid(aircraft.vehicle.geoid)),
        _ptr(K.ctl_gains(aircraft.avionics)), ptrs, _ptr(i_out),
        ctypes.c_int(batch), ctypes.c_int(params.numel()),
        ctypes.c_double(sim.dt), ctypes.c_double(sim.t_start),
        ctypes.c_int(int(comp)), ctypes.c_int(sim.steps_per_periodic),
        ctypes.c_double(sim.periodic_dt), ctypes.c_int(lanes))
    if by_role:
        return sim, st, outs
    return sim, st, unpack((outs[0], i_out))


@pytest.mark.parametrize("comp,spp", [(False, 1), (True, 1), (False, 2)],
                         ids=["uncompensated", "compensated", "every-2nd"])
@pytest.mark.parametrize("batch,lanes", [(B, 32)] + RAGGED,
                         ids=[f"B{B}-L32"] + RAGGED_IDS)
def test_megakernel_fbw_source_matches_plain(host_lib, batch, lanes, comp,
                                             spp):
    """The fly-by-wire megakernel against `megakernel_step_plain` on the
    C172Xv1: the whole step with the servos, then the control laws on the
    mode-rich avionics where the lane's new counter fires (every lane, or
    with a periodic interval of two steps every other lane; elsewhere the
    avionics and the commands stand still)."""
    from flightjax_torch.parallel.megakernel import megakernel_step_plain
    sim, st, got = _run_megakernel_fbw(host_lib, batch, lanes, comp, spp)
    ref = megakernel_step_plain(sim, st)
    for name in ("t", "i", "x", "u", "s", "c"):
        _assert_trees_close({name: getattr(got, name)},
                            {name: getattr(ref, name)})
    assert not bool(st.s["vehicle"]["systems"]["crashed"][CRASH_LANE])
    assert bool(got.s["vehicle"]["systems"]["crashed"][CRASH_LANE])
    fired = ref.s["avionics"]["lon"]["mode_prev"] != st.s["avionics"][
        "lon"]["mode_prev"]
    if spp == 2:  # the lanes that do not fire keep their avionics
        still = (st.i + 1) % 2 != 0
        assert bool(still.any()) and not bool(fired[still].any())
        for a, b in zip(_leaves(got.s["avionics"]),
                        _leaves(st.s["avionics"])):
            assert torch.equal(a[still], b[still])
    else:
        assert bool(fired.any())


def _leaves(tree):
    return [v for _, v in tree_leaves_with_path(tree)]


@functools.lru_cache(maxsize=None)
def _a2_state(batch, operands):
    """The second-order elevator's megakernel state: on the "runway" the
    C172Xv1 cluster state with the mode-rich avionics at step 126
    (`testing.xv1_operand_state`, the elevator second-order), "airborne"
    the turning-climb fleet (`testing.xv1_fleet_sim`, a SAS lane), both
    with the elevator's rate drawn per lane."""
    from flightjax_torch.testing import xv1_fleet_sim, xv1_operand_state
    if operands == "airborne":
        return xv1_fleet_sim(batch, 1016, "cpu", torch.float64,
                             sas_lanes=(2,), a2=K.A2_CARD)[1]
    return xv1_operand_state(batch, 1016, "cpu", torch.float64, (3, 17),
                             (5,), (CRASH_LANE,), i0=126, a2=K.A2_CARD)


A2_MEGA_CASES = [("runway", False, 1, B, 32), ("runway", True, 2, B, 32),
                 ("runway", True, 1, 37, 64), ("airborne", False, 1, B, 32)]


@pytest.mark.parametrize(
    "operands,comp,spp,batch,lanes", A2_MEGA_CASES,
    ids=[f"{o}-" + ("compensated" if c else "uncompensated")
         + f"-every-{n}-B{b}-L{l_}" for o, c, n, b, l_ in A2_MEGA_CASES])
def test_megakernel_fbw_a2_source_matches_plain(host_lib, operands, comp,
                                                spp, batch, lanes):
    """megakernel_fbw_a2 against `megakernel_step_plain` on the C172Xv1
    whose elevator is second-order: the whole step with the elevator's
    position and rate, then the control laws where the lane's new counter
    fires, on the runway operands (the crash lane latching, positions past
    their ranges) and the airborne fleet."""
    from flightjax_torch.parallel.megakernel import megakernel_step_plain
    sim, st, got = _run_megakernel_fbw(host_lib, batch, lanes, comp, spp,
                                       a2=operands)
    ref = megakernel_step_plain(sim, st)
    for name in ("t", "i", "x", "u", "s", "c"):
        _assert_trees_close({name: getattr(got, name)},
                            {name: getattr(ref, name)})
    moved = got.x["vehicle"]["systems"]["act"]["elevator"]["v"] != st.x[
        "vehicle"]["systems"]["act"]["elevator"]["v"]
    assert bool(moved[~st.s["terminated"]].all())  # the rate on live lanes
    if operands == "runway":
        assert bool(got.s["vehicle"]["systems"]["crashed"][CRASH_LANE])


@pytest.mark.parametrize("name", A2_NAMES + ("megakernel_fbw_a2",))
def test_a2_roles_partition_the_output(host_lib, name):
    """Every output row of the second-order elevator's instances, its two
    state rows among them, is written by exactly one role, for every
    aircraft, and by no other role anywhere; role DRAG integrates the
    servos' eight states (`role_row<ACT_FBW_A2>`)."""
    if name == "megakernel_fbw_a2":
        _, _, outs = _run_megakernel_fbw(host_lib, B, 32, True,
                                         by_role=True, a2="runway")
    else:
        outs = _run_fbw(host_lib, name, _a2_args("runway")[name], 32,
                        split=True)
    full = sum((~o.isnan()).all(dim=1).int() for o in outs)
    touched = sum((~o.isnan()).any(dim=1).int() for o in outs)
    assert full.tolist() == [1] * outs[0].shape[0]
    assert touched.tolist() == [1] * outs[0].shape[0]
    rows = [host_lib.host_role_row_a2(role, k)
            for role in range(host_lib.host_n_roles())
            for k in range(host_lib.host_n_slots())]
    assert sorted(r for r in rows if r >= 0) == list(range(K.rows(
        K.FBW_A2.x_groups)))


def test_a2_rows_match_the_kernels(host_lib):
    """ACT_FBW_A2's rows, scratch, parameter head and slots as the compiled
    sources declare them, against the Python layout FBW_A2 and the
    parameter buffer: one row more than the fly-by-wire C172X's from the
    elevator's rate on, the fly-by-wire scratch, the coefficients' pair
    after the servos."""
    from flightjax_torch.models.c172.c172x import Actuator2
    from flightjax_torch.models.c172.c172x import build_vehicle as fbw_veh
    got = dict(zip(A2_ROWS, (host_lib.host_a2_rows(f)
                             for f in range(len(A2_ROWS)))))
    lay = K.FBW_A2
    assert got["ACT"] == 1 | (1 << (2 + K.FBW_CHANNELS.index("elevator")))
    assert got["NX"] == K.rows((lay.x_sys,)) == K.rows((K.X_SYS_FBW,)) + 1
    assert got["NXV"] == K.rows(lay.x_groups)
    assert got["NCTX"] == K.rows(lay.ctx_groups)
    assert got["MEGA"] == K.rows(lay.mega) == K.rows(K.FBW.mega) + 1
    assert got["NACT"] == 8
    assert got["SH_ROWS"] == SYSL_BEFORE[1][11]
    x_act = K.rows_of((lay.x_sys,), ("act", "aileron")).start
    assert got["SLOT_ELV"] == K.rows_of(
        (lay.x_sys,), ("act", "elevator", "p")).start - x_act
    assert got["SLOT_FLAPS"] == K.rows_of(
        (lay.x_sys,), ("act", "flaps")).start - x_act
    veh = fbw_veh(device="cpu", dtype=torch.float64,
                  actuators={"elevator": Actuator2(omega_n=20.0, zeta=0.7)})
    buf = K.system_params(veh)
    head = got["P_HEAD"]
    assert buf[head - 2:head].tolist() == [400.0, 2.0 * 0.7 * 20.0]
    act = K.param_act(veh)  # the elevator's time constant is NaN
    assert math.isnan(act[3 * K.FBW_CHANNELS.index("elevator")])
    torch.testing.assert_close(buf[head - len(act):head],
                               torch.tensor(act, dtype=torch.float64),
                               rtol=0.0, atol=0.0, equal_nan=True)


def test_megakernel_fbw_roles_partition_the_output(host_lib):
    """Every row of the fly-by-wire megakernel's new state buffer, the
    avionics' and the commands among them, is written by exactly one
    role, for every aircraft, and by no other role anywhere."""
    _, _, outs = _run_megakernel_fbw(host_lib, B, 32, True, by_role=True)
    full = sum((~o.isnan()).all(dim=1).int() for o in outs)
    touched = sum((~o.isnan()).any(dim=1).int() for o in outs)
    assert full.tolist() == [1] * outs[0].shape[0]
    assert touched.tolist() == [1] * outs[0].shape[0]


# ------------------------------------------------------------ the C172Xv2

def _gdc_args(batch):
    from flightjax_torch.testing import gdc_laws_args
    return gdc_laws_args(batch, 1016, "cpu", torch.float64, (3, 17))


def _gdc_fleet_args(batch):
    """gdc_ctl_laws' arguments on the pass of the C172Xv2 fleet's scenario
    (`testing.xv2_fleet_sim`: segment and circle lanes), one megakernel
    step in."""
    from flightjax_torch.parallel.megakernel import make_megakernel_step
    from flightjax_torch.testing import xv2_fleet_sim
    sim, st, _ = xv2_fleet_sim(batch, 1016, "cpu", torch.float64)
    bufs, step, unpack = make_megakernel_step(sim, st)
    st = unpack(step(bufs))
    aircraft = sim.system.aircraft
    vy = aircraft.vehicle.output(st.x["vehicle"], st.u["vehicle"],
                                 st.s["vehicle"])
    return (aircraft.avionics, K.gdc_y(vy), st.u["avionics"],
            st.s["avionics"], sim.periodic_dt)


GDC_CASES = ([("rich", B, 32), ("rich", 37, 32), ("rich", 70, 64)]
             + [("fleet", 37, 32), ("fleet", 37, 64)])


@pytest.mark.parametrize(
    "operands,batch,lanes", GDC_CASES,
    ids=[("" if o == "rich" else o + "-") + f"B{b}-L{n}"
         for o, b, n in GDC_CASES])
def test_gdc_ctl_laws_source_matches_plain(host_lib, operands, batch,
                                           lanes):
    """gdc_ctl_laws against `gdc_ctl_laws_plain` (the guidance, then the
    control laws on the requests it overrides), to 1e-12 (the host's math
    library rounds atan apart from PyTorch's), modes and flags exactly: on
    the mode-rich
    operands (every guidance mode, the ground override, every pair of
    requests, cross-track errors on both sides of the gate, far off and
    exactly on the track, reversed segments, over every lon and lat mode)
    and on the pass of the C172Xv2 fleet."""
    args = (_gdc_args(batch) if operands == "rich"
            else _gdc_fleet_args(batch))
    got = K.unpack_out("gdc_ctl_laws",
                       _run_ctl_laws(host_lib, args, lanes,
                                     name="gdc_ctl_laws"))
    ref = K.gdc_ctl_laws_plain(*args)
    _assert_trees_close(got, ref)
    mode = ref[2]["mode"]
    if operands == "rich":
        assert set(mode.tolist()) == {0, 1, 2}
        assert bool(ref[2]["hor_gdc"].any()) and bool(ref[2]["vrt_gdc"].any())
    else:  # the fleet flies its segments and circles, all engaged
        assert set(mode.tolist()) == {1, 2}
        assert bool(ref[2]["hor_gdc"].all())


def test_gdc_ctl_laws_sides_partition_the_output(host_lib):
    """Every output row of gdc_ctl_laws, the GdcY rows among them, is
    written by exactly one of its two sides, for every aircraft."""
    outs = _run_ctl_laws(host_lib, _gdc_args(B), 32, by_side=True,
                         name="gdc_ctl_laws")
    full = sum((~o.isnan()).all(dim=1).int() for o in outs)
    touched = sum((~o.isnan()).any(dim=1).int() for o in outs)
    assert full.tolist() == [1] * outs[0].shape[0]
    assert touched.tolist() == [1] * outs[0].shape[0]


@functools.lru_cache(maxsize=None)
def _xv2_sim(spp):
    from flightjax_torch.core.sim import Simulation
    from flightjax_torch.models.c172.c172x import c172xv2_sim
    sim, _, _ = c172xv2_sim("cpu", torch.float64)
    return Simulation(sim.system, dt=sim.dt, periodic_dt=spp * sim.dt,
                      geoid_every=sim.geoid_every)


@functools.lru_cache(maxsize=None)
def _xv2_state(batch):
    from flightjax_torch.testing import xv2_operand_state
    return xv2_operand_state(batch, 1016, "cpu", torch.float64, (3, 17),
                             (5,), (CRASH_LANE,), i0=126)


@pytest.mark.parametrize(
    "comp,spp,batch,lanes",
    [(False, 1, B, 32), (True, 1, B, 32), (False, 2, B, 32),
     (True, 1, 37, 32), (False, 2, 70, 64)],
    ids=["uncompensated", "compensated", "every-2nd", "compensated-B37-L32",
         "every-2nd-B70-L64"])
def test_megakernel_gdc_source_matches_plain(host_lib, comp, spp, batch,
                                             lanes):
    """The C172Xv2 megakernel against `megakernel_step_plain`: the whole
    step with the servos, then the guidance and control laws on the
    mode-rich avionics where the lane's new counter fires."""
    from flightjax_torch.parallel.megakernel import megakernel_step_plain
    sim, st, got = _run_megakernel_fbw(host_lib, batch, lanes, comp, spp,
                                       gdc=True)
    ref = megakernel_step_plain(sim, st)
    for name in ("t", "i", "x", "u", "s", "c"):
        _assert_trees_close({name: getattr(got, name)},
                            {name: getattr(ref, name)})
    assert bool(got.s["vehicle"]["systems"]["crashed"][CRASH_LANE])
    lon = ref.s["avionics"]["ctl"]["lon"]["mode_prev"]
    fired = (st.i + 1) % spp == 0
    # the guidance drove some firing lanes into the altitude mode
    assert bool((fired & (lon == 8)).any())


def test_megakernel_gdc_roles_partition_the_output(host_lib):
    """Every row of the C172Xv2 megakernel's new state buffer, the
    guidance's inputs among them, is written by exactly one role, for every
    aircraft."""
    _, _, outs = _run_megakernel_fbw(host_lib, B, 32, True, by_role=True,
                                     gdc=True)
    full = sum((~o.isnan()).all(dim=1).int() for o in outs)
    touched = sum((~o.isnan()).any(dim=1).int() for o in outs)
    assert full.tolist() == [1] * outs[0].shape[0]
    assert touched.tolist() == [1] * outs[0].shape[0]


# ------------------------------------------------------------ the missions

def _msn_args(batch):
    from flightjax_torch.testing import msn_laws_args
    return msn_laws_args(batch, 1016, "cpu", torch.float64, (21, 22))


def _msn_fleet_args(batch):
    """msn_ctl_laws' arguments on the pass of the mission fleet
    (`testing.msn_fleet_sim`: landing lanes on the final, pattern lanes
    cold on the runway), one megakernel step in."""
    from flightjax_torch.parallel.megakernel import make_megakernel_step
    from flightjax_torch.testing import msn_fleet_sim
    sim, st, _ = msn_fleet_sim(batch, 1016, "cpu", torch.float64)
    bufs, step, unpack = make_megakernel_step(sim, st)
    st = unpack(step(bufs))
    aircraft = sim.system.aircraft
    vy = aircraft.vehicle.output(st.x["vehicle"], st.u["vehicle"],
                                 st.s["vehicle"])
    return (aircraft.avionics, K.msn_y(vy), st.u["avionics"],
            st.s["avionics"], sim.periodic_dt, st.u["vehicle"]["systems"])


MSN_CASES = ([("rich", B, 32), ("rich", 37, 32), ("rich", 70, 64)]
             + [("fleet", 37, 32), ("fleet", 37, 64)])


@pytest.mark.parametrize(
    "operands,batch,lanes", MSN_CASES,
    ids=[("" if o == "rich" else o + "-") + f"B{b}-L{n}"
         for o, b, n in MSN_CASES])
def test_msn_ctl_laws_source_matches_plain(host_lib, operands, batch,
                                           lanes):
    """msn_ctl_laws against `msn_ctl_laws_plain` (the phase machine, the
    guidance and the control laws on the inputs the phase overrides, the
    new phase's systems overrides), to 1e-12, phases, modes and flags
    exactly: on the mode-rich mission operands (every phase, each
    predicate on both sides of its switch, a phase past the end) and on
    the pass of the mission fleet."""
    args = (_msn_args(batch) if operands == "rich"
            else _msn_fleet_args(batch))
    got = K.unpack_out("msn_ctl_laws",
                       _run_ctl_laws(host_lib, args, lanes,
                                     name="msn_ctl_laws"))
    ref = K.msn_ctl_laws_plain(*args)
    _assert_trees_close(got, ref)
    moved = ref[0]["phase"] != args[3]["phase"]
    if operands == "rich":
        assert bool(moved.any()) and bool((~moved).any())
        assert set(ref[2]["mode"].tolist()) == {0, 1, 2}
    else:  # the landing lanes fly their final leg, the rest stand by
        assert not bool(moved.any())
        assert set(ref[2]["mode"].tolist()) == {0, 1}


def test_msn_ctl_laws_sides_partition_the_output(host_lib):
    """Every output row of msn_ctl_laws, the phase machine's among them,
    is written by exactly one of its two sides, for every aircraft."""
    outs = _run_ctl_laws(host_lib, _msn_args(B), 32, by_side=True,
                         name="msn_ctl_laws")
    full = sum((~o.isnan()).all(dim=1).int() for o in outs)
    touched = sum((~o.isnan()).any(dim=1).int() for o in outs)
    assert full.tolist() == [1] * outs[0].shape[0]
    assert touched.tolist() == [1] * outs[0].shape[0]


@functools.lru_cache(maxsize=None)
def _msn_sim(spp):
    from flightjax_torch.testing import msn_sim
    return msn_sim("cpu", torch.float64, spp)


@functools.lru_cache(maxsize=None)
def _msn_state(batch):
    from flightjax_torch.testing import msn_operand_state
    return msn_operand_state(batch, 1016, "cpu", torch.float64, (3, 17),
                             (5,), (CRASH_LANE,), i0=126)


@pytest.mark.parametrize(
    "comp,spp,batch,lanes",
    [(False, 1, B, 32), (True, 1, B, 32), (False, 2, B, 32),
     (True, 1, 37, 32), (False, 2, 70, 64)],
    ids=["uncompensated", "compensated", "every-2nd", "compensated-B37-L32",
         "every-2nd-B70-L64"])
def test_megakernel_msn_source_matches_plain(host_lib, comp, spp, batch,
                                             lanes):
    """The mission megakernel against `megakernel_step_plain`: the whole
    step with the servos, then the phase machine, the guidance and the
    control laws on the mode-rich avionics where the lane's new counter
    fires, and the new phase's systems overrides."""
    from flightjax_torch.parallel.megakernel import megakernel_step_plain
    sim, st, got = _run_megakernel_fbw(host_lib, batch, lanes, comp, spp,
                                       msn=True)
    ref = megakernel_step_plain(sim, st)
    for name in ("t", "i", "x", "u", "s", "c"):
        _assert_trees_close({name: getattr(got, name)},
                            {name: getattr(ref, name)})
    assert bool(got.s["vehicle"]["systems"]["crashed"][CRASH_LANE])
    fired = (st.i + 1) % spp == 0
    moved = ref.s["avionics"]["phase"] != st.s["avionics"]["phase"]
    assert bool(moved.any()) and not bool(moved[~fired].any())
    act, act0 = ref.u["vehicle"]["systems"]["act"], st.u["vehicle"][
        "systems"]["act"]
    assert bool((act["flaps"] != act0["flaps"])[fired].any())


def test_megakernel_msn_roles_partition_the_output(host_lib):
    """Every row of the mission megakernel's new state buffer, the phase
    machine's and the overridden systems inputs among them, is written by
    exactly one role, for every aircraft."""
    _, _, outs = _run_megakernel_fbw(host_lib, B, 32, True, by_role=True,
                                     msn=True)
    full = sum((~o.isnan()).all(dim=1).int() for o in outs)
    touched = sum((~o.isnan()).any(dim=1).int() for o in outs)
    assert full.tolist() == [1] * outs[0].shape[0]
    assert touched.tolist() == [1] * outs[0].shape[0]


# ------------------------------------------------------------ turbulence

def _turb_args(batch):
    """The turbulent instances' wrapper arguments on `testing.
    turb_operands` (lanes 3 and 17 on the runway, lane 5 terminated,
    CRASH_LANE crashing in the step): every severity, height band, shear
    and discrete-gust phase, V below V_MIN, seeds above 2^24."""
    from flightjax_torch.physics.turbulence import DrydenTurbulence
    from flightjax_torch.testing import turb_operand_args, turb_operands
    veh = build_vehicle(device="cpu", dtype=torch.float64,
                        turbulence=DrydenTurbulence(0.02))
    d = turb_operands(batch, 1016, (3, 17), (5,), (CRASH_LANE,))
    return turb_operand_args(d, veh, "cpu", torch.float64)


def _run_turb(host_lib, name, args, lanes, split=False):
    """rk4_stage_turb or rk4_finish_turb on the wrapper's arguments, block
    by block at `lanes` aircraft per block; its packed output (and the
    int32 rows it read), or with `split` one output per role."""
    buf, n_out, scalars, ops = K.PACK[name](*args)
    batch, params = buf.shape[1], ops["params"]
    n_roles = host_lib.host_n_roles()
    outs = [torch.full((n_out, batch), float("nan"), dtype=torch.float64)
            for _ in range(n_roles if split else 1)]
    ptrs = (ctypes.c_void_p * n_roles)(
        *(outs[r if split else 0].data_ptr() for r in range(n_roles)))
    if name == "rk4_stage_turb":
        host_lib.host_rk4_stage_turb(
            _ptr(buf), _ptr(ops["k"]), _ptr(params), ptrs,
            ctypes.c_int(batch), ctypes.c_int(params.numel()),
            ctypes.c_double(scalars[0]), ctypes.c_int(0),
            ctypes.c_int(lanes))
    else:
        host_lib.host_rk4_finish_turb(
            _ptr(buf), _ptr(ops["k"]), _ptr(params), _ptr(ops["ints"]),
            ptrs, ctypes.c_int(batch), ctypes.c_double(scalars[0]),
            ctypes.c_int(scalars[1]), ctypes.c_double(scalars[2]),
            ctypes.c_double(scalars[3]), ctypes.c_int(lanes))
    return (outs if split else outs[0]), ops.get("ints")


TURB_CASES = ([("rk4_stage_turb", False, B, 32),
               ("rk4_finish_turb", False, B, 32),
               ("rk4_finish_turb", True, B, 32)]
              + [(n, c, b, lanes) for n, c in (("rk4_stage_turb", False),
                                               ("rk4_finish_turb", True))
                 for b, lanes in RAGGED])
TURB_IDS = (["rk4_stage_turb", "rk4_finish_turb", "rk4_finish_turb-comp"]
            + [f"{n}-{i}" for n in ("rk4_stage_turb", "rk4_finish_turb-comp")
               for i in RAGGED_IDS])


@pytest.mark.parametrize("name,comp,batch,lanes", TURB_CASES, ids=TURB_IDS)
def test_turb_kernel_source_matches_plain(host_lib, name, comp, batch,
                                          lanes):
    """rk4_stage_turb and rk4_finish_turb (with and without residuals)
    against `rk4_stage_plain` / `rk4_finish_plain` of the turbulent
    vehicle: the filters' stage point, derivative and combine, the
    disturbed air data at the stage and the new time, the redrawn drive;
    the crash lane latches."""
    args = _turb_args(batch)[name[:-len("_turb")]]
    if name == "rk4_finish_turb" and not comp:
        args = args[:7] + (None,) + args[8:]
    out, ints = _run_turb(host_lib, name, args, lanes)
    got = K.unpack_out(name, out, comp, ints)
    if name == "rk4_stage_turb":
        args = args[:5] + (args[5].to(torch.float64),) + args[6:]
    ref = getattr(K, name[:-len("_turb")] + "_plain")(*args)
    _assert_trees_close(got, ref)
    if name == "rk4_finish_turb":
        assert not bool(args[4]["systems"]["crashed"][CRASH_LANE])
        assert bool(got[1]["crashed"][CRASH_LANE])
        # the drive is redrawn on every lane, the terminated one too
        assert got[-1]["n"].tolist() == (args[4]["turb"]["n"] + 1).tolist()


@pytest.mark.parametrize("name", ["rk4_stage_turb", "rk4_finish_turb"])
def test_turb_roles_partition_the_output(host_lib, name):
    """Every output row of the turbulent stage and finish, the filters'
    rows and the drive among them, is written by exactly one role, for
    every aircraft, and by no other role anywhere."""
    args = _turb_args(B)[name[:-len("_turb")]]
    outs, _ = _run_turb(host_lib, name, args, 32, split=True)
    n_rows = outs[0].shape[0]
    full = sum((~o.isnan()).all(dim=1).int() for o in outs)
    touched = sum((~o.isnan()).any(dim=1).int() for o in outs)
    assert full.tolist() == [1] * n_rows
    assert touched.tolist() == [1] * n_rows


def _run_megakernel_turb(host_lib, batch, lanes, comp):
    from flightjax_torch.core.sim import comp_residuals
    from flightjax_torch.models.c172.c172s import turbulent_flagship_sim
    from flightjax_torch.parallel.megakernel import make_megakernel_step
    from flightjax_torch.testing import turb_operand_state, turb_operands
    sim, _, _ = turbulent_flagship_sim("cpu", torch.float64)
    st = turb_operand_state(turb_operands(batch, 1016, (3, 17), (5,),
                                          (CRASH_LANE,)), "cpu",
                            torch.float64)
    if comp:
        st = st._replace(c=comp_residuals(st.x, force=True))
    bufs, step, unpack = make_megakernel_step(sim, st)
    vehicle = sim.system.aircraft.vehicle
    params = K.system_params(vehicle)
    n_roles = host_lib.host_n_roles()
    out = torch.full_like(bufs[0], float("nan"))
    ptrs = (ctypes.c_void_p * n_roles)(*([out.data_ptr()] * n_roles))
    i_out = torch.full_like(bufs[1], -1)
    host_lib.host_megakernel_turb(
        _ptr(bufs[0]), _ptr(bufs[1]), _ptr(params),
        _ptr(K.geoid_grid(vehicle.geoid)), ptrs, _ptr(i_out),
        ctypes.c_int(batch), ctypes.c_int(params.numel()),
        ctypes.c_double(sim.dt), ctypes.c_double(sim.t_start),
        ctypes.c_int(int(comp)), ctypes.c_int(lanes))
    return unpack((out, i_out)), unpack(step(bufs)), st


@pytest.mark.parametrize("comp", [False, True],
                         ids=["uncompensated", "compensated"])
@pytest.mark.parametrize("batch,lanes", [(B, 32)] + RAGGED,
                         ids=[f"B{B}-L32"] + RAGGED_IDS)
def test_megakernel_turb_source_matches_plain(host_lib, batch, lanes, comp):
    """megakernel_turb against its plain step on the turbulent operands:
    every leaf of the new state, the seed passing through and the drive
    counter one on, the crash lane latched."""
    got, ref, st = _run_megakernel_turb(host_lib, batch, lanes, comp)
    for name in ("t", "i", "x", "u", "s", "c"):
        _assert_trees_close({name: getattr(got, name)},
                            {name: getattr(ref, name)})
    seed = st.u["vehicle"]["turb"]["seed"]
    assert got.u["vehicle"]["turb"]["seed"].tolist() == seed.tolist()
    assert (got.s["vehicle"]["turb"]["n"].tolist()
            == (st.s["vehicle"]["turb"]["n"] + 1).tolist())
    assert bool(got.s["terminated"][CRASH_LANE])


# ------------------------------------------------------------ the C172Xv1 in gusts

SYSL_FIELDS = ("NX", "NU", "U_E", "NXV", "CX_UATM", "CX_TERM", "X_TURB",
               "CX_UTURB", "CX_ETA", "NCTX", "P_TURB", "SH_ROWS")
# the row maps of the three earlier instances as they were before the
# turbulence became a bit beside the actuation (`csrc/c172_systems.cuh`
# before the turbulent fly-by-wire instances, compiled on the host): the
# C172S, the fly-by-wire C172X, the turbulent C172S; the drive's scale at
# P_HEAD = 165 (read by the turbulent instance alone), the fly-by-wire
# head 186
SYSL_BEFORE = {
    0: (12, 21, 11, 27, 21, 35, 27, 36, 36, 36, None, 89),
    1: (19, 18, 8, 34, 18, 32, 34, 33, 33, 33, None, 96),
    2: (12, 21, 11, 32, 21, 35, 27, 36, 43, 46, 165, 89),
}


def test_act_kinds_split_actuation_and_turbulence(host_lib):
    """ActKind as two bits: ACT_MECH, ACT_FBW and ACT_TURB keep their
    values, and so their instances' row maps, scratch, parameter offsets
    and role rows are those of before (the record of their machine code,
    `tools/sass_torch_record.json`, holds them on the card); ACT_FBW_TURB
    is both, with the fly-by-wire rows, the turbulence's rows after them
    and the drive's scale after the servos' parameters, as the Python
    layout FBW_TURB packs them."""
    acts = {"ACT_MECH": 0, "ACT_FBW": 1, "ACT_TURB": 2, "ACT_FBW_TURB": 3}
    for name, a in acts.items():
        assert host_lib.host_act_fbw(a) == int("FBW" in name)
        assert host_lib.host_act_turb(a) == int("TURB" in name)
    got = {a: tuple(host_lib.host_sysl(a, f) for f in range(len(
        SYSL_FIELDS))) for a in range(4)}
    for a, before in SYSL_BEFORE.items():
        now = tuple(v if b is not None else None
                    for v, b in zip(got[a], before))
        assert now == before, (a, dict(zip(SYSL_FIELDS, got[a])))
    for role in range(host_lib.host_n_roles()):
        for k in range(15):
            assert (host_lib.host_role_row_act(1, role, k)
                    == host_lib.host_role_row_fbw(role, k))
            assert (host_lib.host_role_row_act(2, role, k)
                    == host_lib.host_role_row_act(0, role, k))
            assert (host_lib.host_role_row_act(3, role, k)
                    == host_lib.host_role_row_act(1, role, k))
    f = dict(zip(SYSL_FIELDS, got[3]))
    lay = K.FBW_TURB
    assert f["NXV"] == K.rows(lay.x_groups)
    assert f["NCTX"] == K.rows(lay.ctx_groups)
    assert f["CX_ETA"] == K.rows(lay.ctx_groups[:-1])
    assert f["X_TURB"] == K.rows(lay.x_groups[:-1])
    from flightjax_torch.models.c172.c172x import build_vehicle as fbw_veh
    from flightjax_torch.physics.turbulence import DrydenTurbulence
    veh = fbw_veh(device="cpu", dtype=torch.float64,
                  turbulence=DrydenTurbulence(0.02))
    buf = K.system_params(veh)
    assert float(buf[f["P_TURB"]]) == (math.pi / 0.02) ** 0.5
    assert f["P_TURB"] == 186 and f["SH_ROWS"] == SYSL_BEFORE[1][11]


def _fbw_turb_args(batch):
    """The turbulent C172Xv1's stage and finish wrapper arguments on
    `testing.fbw_turb_operands` (the turbulent operands with the servos,
    past their ranges on both sides)."""
    from flightjax_torch.models.c172.c172x import build_vehicle as fbw_veh
    from flightjax_torch.physics.turbulence import DrydenTurbulence
    from flightjax_torch.testing import fbw_turb_operands, turb_operand_args
    veh = fbw_veh(device="cpu", dtype=torch.float64,
                  turbulence=DrydenTurbulence(0.02))
    d = fbw_turb_operands(batch, 1016, (3, 17), (5,), (CRASH_LANE,))
    return turb_operand_args(d, veh, "cpu", torch.float64)


def _run_fbw_turb(host_lib, name, args, lanes, split=False):
    """rk4_stage_fbw_turb or rk4_finish_fbw_turb, as `_run_turb`."""
    buf, n_out, scalars, ops = K.PACK[name](*args)
    batch, params = buf.shape[1], ops["params"]
    n_roles = host_lib.host_n_roles()
    outs = [torch.full((n_out, batch), float("nan"), dtype=torch.float64)
            for _ in range(n_roles if split else 1)]
    ptrs = (ctypes.c_void_p * n_roles)(
        *(outs[r if split else 0].data_ptr() for r in range(n_roles)))
    if name == "rk4_stage_fbw_turb":
        host_lib.host_rk4_stage_fbw_turb(
            _ptr(buf), _ptr(ops["k"]), _ptr(params), ptrs,
            ctypes.c_int(batch), ctypes.c_int(params.numel()),
            ctypes.c_double(scalars[0]), ctypes.c_int(0),
            ctypes.c_int(lanes))
    else:
        host_lib.host_rk4_finish_fbw_turb(
            _ptr(buf), _ptr(ops["k"]), _ptr(params), _ptr(ops["ints"]),
            ptrs, ctypes.c_int(batch), ctypes.c_double(scalars[0]),
            ctypes.c_int(scalars[1]), ctypes.c_double(scalars[2]),
            ctypes.c_double(scalars[3]), ctypes.c_int(lanes))
    return (outs if split else outs[0]), ops.get("ints")


FBW_TURB_CASES = [(n.replace("_turb", "_fbw_turb"), c, b, lanes)
                  for n, c, b, lanes in TURB_CASES]
FBW_TURB_IDS = [i.replace("_turb", "_fbw_turb") for i in TURB_IDS]


@pytest.mark.parametrize("name,comp,batch,lanes", FBW_TURB_CASES,
                         ids=FBW_TURB_IDS)
def test_fbw_turb_kernel_source_matches_plain(host_lib, name, comp, batch,
                                              lanes):
    """rk4_stage_fbw_turb and rk4_finish_fbw_turb (with and without
    residuals) against the plain stage and finish of the turbulent
    fly-by-wire vehicle: the servos (saturated both ways) beside the
    filters and the disturbed air data, the avionics' KIN_Y and SYS_Y at
    the new time, the redrawn drive; the crash lane latches."""
    base = name[:-len("_fbw_turb")]
    args = _fbw_turb_args(batch)[base]
    if base == "rk4_finish" and not comp:
        args = args[:7] + (None,) + args[8:]
    out, ints = _run_fbw_turb(host_lib, name, args, lanes)
    got = K.unpack_out(name, out, comp, ints)
    if base == "rk4_stage":
        args = args[:5] + (args[5].to(torch.float64),) + args[6:]
    ref = getattr(K, base + "_plain")(*args)
    _assert_trees_close(got, ref)
    if base == "rk4_finish":
        assert not bool(args[4]["systems"]["crashed"][CRASH_LANE])
        assert bool(got[1]["crashed"][CRASH_LANE])
        assert got[4] is not None and got[5] is not None
        assert got[-1]["n"].tolist() == (args[4]["turb"]["n"] + 1).tolist()


@pytest.mark.parametrize("name", ["rk4_stage_fbw_turb",
                                  "rk4_finish_fbw_turb"])
def test_fbw_turb_roles_partition_the_output(host_lib, name):
    """Every output row of the turbulent C172Xv1's stage and finish (the
    servos, the filters, KIN_Y, SYS_Y and the drive among them) is written
    by exactly one role, for every aircraft, and by no other role."""
    args = _fbw_turb_args(B)[name[:-len("_fbw_turb")]]
    outs, _ = _run_fbw_turb(host_lib, name, args, 32, split=True)
    n_rows = outs[0].shape[0]
    full = sum((~o.isnan()).all(dim=1).int() for o in outs)
    touched = sum((~o.isnan()).any(dim=1).int() for o in outs)
    assert full.tolist() == [1] * n_rows
    assert touched.tolist() == [1] * n_rows


def _run_megakernel_fbw_turb(host_lib, batch, lanes, comp, spp,
                             by_role=False, avk="fbw"):
    """megakernel_fbw_turb's source on the turbulent C172Xv1 operands with
    the mode-rich avionics (`testing.fbw_turb_operand_state`), at a
    periodic interval of `spp` steps; as `_run_megakernel_fbw`. With `avk`
    "gdc" megakernel_gdc_turb's on the turbulent C172Xv2 operands (the
    mode-rich guidance too, `testing.xv2_turb_operand_state`), with "msn"
    megakernel_msn_turb's on a mission's over them (every phase,
    `testing.msn_turb_operand_state`)."""
    from flightjax_torch.core.sim import Simulation, comp_residuals
    from flightjax_torch.parallel.megakernel import make_megakernel_step
    from flightjax_torch.physics.turbulence import DrydenTurbulence
    from flightjax_torch.testing import (fbw_turb_operand_state,
                                         fbw_turb_operands, msn_sim,
                                         msn_turb_operand_state,
                                         xv2_turb_operand_state,
                                         xv2_turb_sim)
    d = fbw_turb_operands(batch, 1016, (3, 17), (5,), (CRASH_LANE,))
    if avk == "gdc":
        sim = xv2_turb_sim("cpu", torch.float64, spp)
        st = xv2_turb_operand_state(d, "cpu", torch.float64)
    elif avk == "msn":
        sim = msn_sim("cpu", torch.float64, spp,
                      turbulence=DrydenTurbulence(0.02))
        st = msn_turb_operand_state(d, "cpu", torch.float64)
    else:
        sim0, _, _ = __import__(
            "flightjax_torch.models.c172.c172x", fromlist=["c172xv1_sim"]
        ).c172xv1_sim("cpu", torch.float64,
                      turbulence=DrydenTurbulence(0.02))
        sim = Simulation(sim0.system, dt=0.02, periodic_dt=0.02 * spp)
        st = fbw_turb_operand_state(d, "cpu", torch.float64)
    if comp:
        st = st._replace(c=comp_residuals(st.x, force=True))
    bufs, _, unpack = make_megakernel_step(sim, st)
    aircraft = sim.system.aircraft
    params = K.system_params(aircraft.vehicle)
    n_roles = host_lib.host_n_roles()
    outs = [torch.full_like(bufs[0], float("nan"))
            for _ in range(n_roles if by_role else 1)]
    ptrs = (ctypes.c_void_p * n_roles)(
        *(outs[r if by_role else 0].data_ptr() for r in range(n_roles)))
    i_out = torch.full_like(bufs[1], -1)
    getattr(host_lib, f"host_megakernel_{avk}_turb")(
        _ptr(bufs[0]), _ptr(bufs[1]), _ptr(params),
        _ptr(K.geoid_grid(aircraft.vehicle.geoid)),
        _ptr(K.ctl_gains(aircraft.avionics)), ptrs, _ptr(i_out),
        ctypes.c_int(batch), ctypes.c_int(params.numel()),
        ctypes.c_double(sim.dt), ctypes.c_double(sim.t_start),
        ctypes.c_int(int(comp)), ctypes.c_int(sim.steps_per_periodic),
        ctypes.c_double(sim.periodic_dt), ctypes.c_int(lanes))
    if by_role:
        return sim, st, outs
    return sim, st, unpack((outs[0], i_out))


@pytest.mark.parametrize("spp", [1, 2], ids=["pass", "pass-every-2"])
@pytest.mark.parametrize("comp", [False, True],
                         ids=["uncompensated", "compensated"])
@pytest.mark.parametrize("batch,lanes", [(B, 32)] + RAGGED,
                         ids=[f"B{B}-L32"] + RAGGED_IDS)
def test_megakernel_fbw_turb_source_matches_plain(host_lib, batch, lanes,
                                                  comp, spp):
    """megakernel_fbw_turb against `megakernel_step_plain` on the
    turbulent C172Xv1: the step with the servos and the turbulence, then
    the control laws on the mode-rich avionics where the lane's counter
    fires; the seed passes through, the drive's counter steps on, the
    crash lane latches."""
    from flightjax_torch.parallel.megakernel import megakernel_step_plain
    sim, st, got = _run_megakernel_fbw_turb(host_lib, batch, lanes, comp,
                                            spp)
    ref = megakernel_step_plain(sim, st)
    for name in ("t", "i", "x", "u", "s", "c"):
        _assert_trees_close({name: getattr(got, name)},
                            {name: getattr(ref, name)})
    assert bool(got.s["terminated"][CRASH_LANE])
    assert (got.s["vehicle"]["turb"]["n"].tolist()
            == (st.s["vehicle"]["turb"]["n"] + 1).tolist())
    fired = ref.s["avionics"]["lon"]["mode_prev"] != st.s["avionics"][
        "lon"]["mode_prev"]
    assert bool(fired.any())


def test_megakernel_fbw_turb_roles_partition_the_output(host_lib):
    """Every row of megakernel_fbw_turb's new state buffer (the filters,
    the turbulence's inputs and drive, the avionics and the commands among
    them) is written by exactly one role, for every aircraft."""
    _, _, outs = _run_megakernel_fbw_turb(host_lib, B, 32, True, 1,
                                          by_role=True)
    full = sum((~o.isnan()).all(dim=1).int() for o in outs)
    touched = sum((~o.isnan()).any(dim=1).int() for o in outs)
    assert full.tolist() == [1] * outs[0].shape[0]
    assert touched.tolist() == [1] * outs[0].shape[0]


# the turbulent C172Xv2's instances: (comp, spp, batch, lanes)
XV2_TURB_CASES = [(False, 1, B, 32), (True, 1, B, 32), (False, 2, 37, 32),
                  (True, 2, 70, 64)]
XV2_TURB_IDS = [f"{'compensated' if c else 'uncompensated'}-spp{p}-B{b}-"
                f"L{n}" for c, p, b, n in XV2_TURB_CASES]


def _check_xv2_turb(host_lib, avk, comp, spp, batch, lanes):
    """The instance's step against `megakernel_step_plain`: every leaf
    within TOL, the seed passing through, the drive's counter stepping on,
    the crash lane latching; returns (state, the plain step's new
    state)."""
    from flightjax_torch.parallel.megakernel import megakernel_step_plain
    sim, st, got = _run_megakernel_fbw_turb(host_lib, batch, lanes, comp,
                                            spp, avk=avk)
    ref = megakernel_step_plain(sim, st)
    for name in ("t", "i", "x", "u", "s", "c"):
        _assert_trees_close({name: getattr(got, name)},
                            {name: getattr(ref, name)})
    assert bool(got.s["terminated"][CRASH_LANE])
    assert torch.equal(got.u["vehicle"]["turb"]["seed"],
                       st.u["vehicle"]["turb"]["seed"])
    assert (got.s["vehicle"]["turb"]["n"].tolist()
            == (st.s["vehicle"]["turb"]["n"] + 1).tolist())
    return st, ref


@pytest.mark.parametrize("comp,spp,batch,lanes", XV2_TURB_CASES,
                         ids=XV2_TURB_IDS)
def test_megakernel_gdc_turb_source_matches_plain(host_lib, comp, spp, batch,
                                                  lanes):
    """megakernel_gdc_turb against `megakernel_step_plain` on the turbulent
    C172Xv2 operands: the step with the servos and every branch of the
    turbulence, then the guidance and control laws on the mode-rich
    avionics where the lane's counter fires."""
    st, ref = _check_xv2_turb(host_lib, "gdc", comp, spp, batch, lanes)
    fired = (st.i + 1) % spp == 0
    lon = ref.s["avionics"]["ctl"]["lon"]["mode_prev"]
    # the guidance drove some firing lanes into the altitude mode
    assert bool((fired & (lon == 8)).any())


@pytest.mark.parametrize("comp,spp,batch,lanes", XV2_TURB_CASES,
                         ids=XV2_TURB_IDS)
def test_megakernel_msn_turb_source_matches_plain(host_lib, comp, spp, batch,
                                                  lanes):
    """megakernel_msn_turb against `megakernel_step_plain` on a mission's
    turbulent operands: the step with the turbulence, then the phase
    machine, the guidance and the control laws where the lane's counter
    fires, and the new phase's systems overrides."""
    st, ref = _check_xv2_turb(host_lib, "msn", comp, spp, batch, lanes)
    fired = (st.i + 1) % spp == 0
    moved = ref.s["avionics"]["phase"] != st.s["avionics"]["phase"]
    assert bool(moved.any()) and not bool(moved[~fired].any())


@pytest.mark.parametrize("avk", ["gdc", "msn"])
def test_megakernel_xv2_turb_roles_partition_the_output(host_lib, avk):
    """Every row of megakernel_gdc_turb's and megakernel_msn_turb's new
    state buffer (the filters, the turbulence's inputs and drive, the
    guidance's inputs, the phase machine's rows and the overridden systems
    inputs among them) is written by exactly one role, for every
    aircraft."""
    _, _, outs = _run_megakernel_fbw_turb(host_lib, B, 32, True, 1,
                                          by_role=True, avk=avk)
    full = sum((~o.isnan()).all(dim=1).int() for o in outs)
    touched = sum((~o.isnan()).any(dim=1).int() for o in outs)
    assert full.tolist() == [1] * outs[0].shape[0]
    assert touched.tolist() == [1] * outs[0].shape[0]


# ------------------------------------------------------------ navigation

def _assert_p_close(got, ref):
    """The filter's P lane by lane within TOL of its own largest entry."""
    err = ((got - ref).abs().amax(dim=(-2, -1))
           / ref.abs().amax(dim=(-2, -1)))
    assert float(err.max()) <= TOL, float(err.max())


def _nav_table(u_av, s_av):
    from flightjax_torch.testing import normal_table_for
    return normal_table_for(u_av["sens"]["seed"], s_av["sens"]["n"] + 1)


def _run_nav_pass(host_lib, args, lanes, split=False):
    """nav_pass's source on the wrapper's arguments, block by block at
    `lanes` aircraft per block: its packed output (one per role with
    `split`, NaN where the role wrote nothing) and int32 rows; around a
    mission its instance that also writes the h_o row."""
    buf, n_out, _, ops = K.pack_nav_pass(*args)
    msn = n_out == K.rows(K.NAV_OUT_MSN)
    batch = buf.shape[1]
    n_roles = host_lib.host_n_roles()
    outs = [torch.full((n_out, batch), float("nan"), dtype=torch.float64)
            for _ in range(n_roles if split else 1)]
    ptrs = (ctypes.c_void_p * n_roles)(
        *(outs[r if split else 0].data_ptr() for r in range(n_roles)))
    work = torch.full((host_lib.host_nav_rows(4), batch), float("nan"),
                      dtype=torch.float64)
    i_out = torch.full_like(ops["ints"], -1)
    table = _nav_table(*args[4:])
    fn = host_lib.host_nav_pass_msn_nav if msn else host_lib.host_nav_pass
    fn(_ptr(buf), _ptr(ops["ints"]), _ptr(ops["gains"]), _ptr(table),
       _ptr(work), ptrs, _ptr(i_out), ctypes.c_int(batch),
       ctypes.c_int(lanes))
    return (outs if split else outs[0]), i_out


NAV_CASES = [("default", B, 32), ("radar", B, 32), ("shadow", B, 32),
             ("synthetic", B, 32), ("perturb", B, 32), ("immediate", B, 32),
             ("default", 37, 32), ("radar", 70, 64)]
NAV_IDS = [f"{s}-B{b}-L{n}" for s, b, n in NAV_CASES]


@pytest.mark.parametrize("setting,batch,lanes", NAV_CASES, ids=NAV_IDS)
def test_nav_pass_source_matches_plain(host_lib, setting, batch, lanes):
    """nav_pass against `kernels.nav_pass_plain` on the mode-rich
    navigation operands (`testing.nav_operand_state`: every combination of
    epochs, each fault channel in each mode around its window, monitors
    one hit from latching and latched, NIS values either side of the
    gates, zero-sigma lanes, the radar either side of its limits): the new
    state, the monitors' bits and the sensor epoch exactly as integers,
    the GDC_Y fields the inner laws read, P per lane against its largest
    entry."""
    from flightjax_torch.testing import nav_operand_state, nav_pass_args
    sim, st = nav_operand_state(batch, 1016, "cpu", torch.float64,
                                setting=setting)
    args = nav_pass_args(sim, st)
    out, ints = _run_nav_pass(host_lib, args, lanes)
    got = K.unpack_out("nav_pass", out, ints=ints)
    ref = K.nav_pass_plain(*args)
    _assert_trees_close(got, ref)
    _assert_p_close(got[0]["nav"].P, ref[0]["nav"].P)
    # the integers exactly: the seed and the fault pass through, the epoch
    # steps on, the monitors' bits
    assert torch.equal(ints, K.pack_nav_int(args[4], ref[0]))
    aided = (st.s["avionics"]["sens"]["n"] + 1) % 5 == 0
    if setting != "radar":
        assert bool((got[0]["nis"]["baro"] != args[5]["nis"]["baro"])[
            aided].all())
    if setting == "shadow":
        _assert_trees_close(got[1], K.gdc_y(args[1]))


def test_nav_pass_roles_partition_the_output(host_lib):
    """Every output row of nav_pass (P's 225 among them) is written by
    exactly one role, for every aircraft, and by no other role."""
    from flightjax_torch.testing import nav_operand_state, nav_pass_args
    sim, st = nav_operand_state(B, 1016, "cpu", torch.float64)
    outs, _ = _run_nav_pass(host_lib, nav_pass_args(sim, st), 32, split=True)
    full = sum((~o.isnan()).all(dim=1).int() for o in outs)
    touched = sum((~o.isnan()).any(dim=1).int() for o in outs)
    assert full.tolist() == [1] * outs[0].shape[0]
    assert touched.tolist() == [1] * outs[0].shape[0]


def _run_megakernel_nav(host_lib, batch, lanes, turb, spp=1, setting="default",
                        by_role=False, gdc=False, msn=False):
    """megakernel_nav (megakernel_nav_turb with `turb`) on the mode-rich
    navigation operands with their pass every `spp` steps; as
    `_run_megakernel_fbw`. With `gdc` megakernel_gdc_nav on the calm
    sensor-fed C172Xv2's (the mode-rich control laws and guidance
    too), with `msn` megakernel_msn_nav on the sensor-fed missions'
    (`testing.msn_nav_operand_state`); with `turb` too their turbulent
    instances megakernel_gdc_nav_turb and megakernel_msn_nav_turb."""
    from flightjax_torch.parallel.megakernel import make_megakernel_step
    from flightjax_torch.testing import (msn_nav_operand_state,
                                         nav_operand_state)
    if msn:
        sim, st = msn_nav_operand_state(batch, 1016, "cpu", torch.float64,
                                        setting=setting, spp=spp,
                                        turbulence=turb)
    else:
        sim, st = nav_operand_state(batch, 1016, "cpu", torch.float64,
                                    turbulence=turb, setting=setting,
                                    spp=spp, gdc=gdc)
    bufs, _, unpack = make_megakernel_step(sim, st)
    aircraft = sim.system.aircraft
    params = K.system_params(aircraft.vehicle)
    n_roles = host_lib.host_n_roles()
    outs = [torch.full_like(bufs[0], float("nan"))
            for _ in range(n_roles if by_role else 1)]
    ptrs = (ctypes.c_void_p * n_roles)(
        *(outs[r if by_role else 0].data_ptr() for r in range(n_roles)))
    i_out = torch.full_like(bufs[1], -1)
    work = torch.full((host_lib.host_nav_rows(4), batch), float("nan"),
                      dtype=torch.float64)
    table = _nav_table(st.u["avionics"], st.s["avionics"])
    turb_arg = () if gdc or msn else (ctypes.c_int(int(turb)),)
    getattr(host_lib, "host_megakernel_" + (
        "msn_nav" if msn else "gdc_nav" if gdc else "nav")
        + ("_turb" if turb and (gdc or msn) else ""))(
        _ptr(bufs[0]), _ptr(bufs[1]), _ptr(params),
        _ptr(K.geoid_grid(aircraft.vehicle.geoid)),
        _ptr(K.ctl_gains(aircraft.avionics)), _ptr(table), _ptr(work),
        ptrs, _ptr(i_out), ctypes.c_int(batch), ctypes.c_int(params.numel()),
        ctypes.c_double(sim.dt), ctypes.c_double(sim.t_start),
        ctypes.c_int(0), ctypes.c_int(sim.steps_per_periodic),
        ctypes.c_double(sim.periodic_dt), *turb_arg, ctypes.c_int(lanes))
    if by_role:
        return sim, st, outs
    return sim, st, unpack((outs[0], i_out))


MEGA_NAV_CASES = [(True, 1, "default", B, 32), (False, 1, "default", B, 32),
                  (True, 2, "default", B, 32), (False, 1, "radar", B, 32),
                  (True, 1, "shadow", B, 32), (True, 1, "synthetic", B, 32),
                  (False, 1, "perturb", B, 32), (True, 2, "immediate", B, 32),
                  (True, 1, "default", 37, 32), (False, 1, "default", 70, 64)]
MEGA_NAV_IDS = [f"{'turb' if t else 'calm'}-spp{p}-{s}-B{b}-L{n}"
                for t, p, s, b, n in MEGA_NAV_CASES]


@pytest.mark.parametrize("turb,spp,setting,batch,lanes", MEGA_NAV_CASES,
                         ids=MEGA_NAV_IDS)
def test_megakernel_nav_source_matches_plain(host_lib, turb, spp, setting,
                                             batch, lanes):
    """megakernel_nav and megakernel_nav_turb against
    `megakernel_step_plain` (each lane's pass on its own sensor epoch) on the
    mode-rich navigation operands: the step, the truth at the new state,
    the navigation pass and the control laws on the estimates (on the
    truth in shadow mode), every leaf within TOL, P per lane against its
    largest entry, the integers exactly; with the pass every other step
    the lanes that do not fire keep their avionics."""
    from flightjax_torch.parallel.megakernel import megakernel_step_plain
    sim, st, got = _run_megakernel_nav(host_lib, batch, lanes, turb, spp,
                                       setting)
    ref = megakernel_step_plain(sim, st)
    for name in ("t", "i", "x", "u", "s"):
        _assert_trees_close({name: getattr(got, name)},
                            {name: getattr(ref, name)})
    _assert_p_close(got.s["avionics"]["nav"].P, ref.s["avionics"]["nav"].P)
    assert torch.equal(got.s["avionics"]["sens"]["n"],
                       ref.s["avionics"]["sens"]["n"])
    fired = (st.i + 1) % spp == 0
    assert bool(fired.any())
    n0 = st.s["avionics"]["sens"]["n"]
    assert torch.equal(got.s["avionics"]["sens"]["n"],
                       torch.where(fired, n0 + 1, n0))


def test_megakernel_nav_roles_partition_the_output(host_lib):
    """Every row of megakernel_nav_turb's new state buffer (the navigation
    avionics' inputs and state, P's 225 rows among them) is written by
    exactly one role, for every aircraft."""
    _, _, outs = _run_megakernel_nav(host_lib, B, 32, True, by_role=True)
    full = sum((~o.isnan()).all(dim=1).int() for o in outs)
    touched = sum((~o.isnan()).any(dim=1).int() for o in outs)
    assert full.tolist() == [1] * outs[0].shape[0]
    assert touched.tolist() == [1] * outs[0].shape[0]


GDC_NAV_CASES = [(1, "default", B, 32), (2, "default", B, 32),
                 (1, "radar", B, 32), (1, "shadow", B, 32),
                 (1, "synthetic", B, 32), (1, "perturb", B, 32),
                 (2, "immediate", B, 32), (1, "default", 37, 32),
                 (1, "default", 70, 64)]
GDC_NAV_IDS = [f"spp{p}-{s}-B{b}-L{n}" for p, s, b, n in GDC_NAV_CASES]


@pytest.mark.parametrize("spp,setting,batch,lanes", GDC_NAV_CASES,
                         ids=GDC_NAV_IDS)
def test_megakernel_gdc_nav_source_matches_plain(host_lib, spp, setting,
                                                 batch, lanes):
    """megakernel_gdc_nav against `megakernel_step_plain` on the calm
    sensor-fed C172Xv2's mode-rich operands (the navigation operands of
    megakernel_nav with the mode-rich control laws and guidance) in every
    setting: the step, the truth at the new state, the navigation pass,
    then the guidance and the control laws on the estimates (on the truth
    in shadow mode), every leaf within TOL, P per lane against its largest
    entry, the integers exactly. The operands' filters lie off the truth
    by up to hundreds of metres, so a guidance reading the truth's
    position would not match."""
    from flightjax_torch.parallel.megakernel import megakernel_step_plain
    sim, st, got = _run_megakernel_nav(host_lib, batch, lanes, False, spp,
                                       setting, gdc=True)
    ref = megakernel_step_plain(sim, st)
    for name in ("t", "i", "x", "u", "s"):
        _assert_trees_close({name: getattr(got, name)},
                            {name: getattr(ref, name)})
    _assert_p_close(got.s["avionics"]["nav"].P, ref.s["avionics"]["nav"].P)
    fired = (st.i + 1) % spp == 0
    n0 = st.s["avionics"]["sens"]["n"]
    assert torch.equal(got.s["avionics"]["sens"]["n"],
                       torch.where(fired, n0 + 1, n0))
    lon = ref.s["avionics"]["inner"]["ctl"]["lon"]["mode_prev"]
    # the guidance drove some firing lanes into the altitude mode
    assert bool((fired & (lon == 8)).any())


def test_megakernel_gdc_nav_roles_partition_the_output(host_lib):
    """Every row of megakernel_gdc_nav's new state buffer (the guidance's
    inputs, the navigation avionics' inputs and state among them) is
    written by exactly one role, for every aircraft."""
    _, _, outs = _run_megakernel_nav(host_lib, B, 32, False, by_role=True,
                                     gdc=True)
    full = sum((~o.isnan()).all(dim=1).int() for o in outs)
    touched = sum((~o.isnan()).any(dim=1).int() for o in outs)
    assert full.tolist() == [1] * outs[0].shape[0]
    assert touched.tolist() == [1] * outs[0].shape[0]


def test_nav_rows_match_the_kernels(host_lib):
    """The row maps of the navigation blocks (kernels.NAV_U, NAV_S,
    NAV_INT, NAV_T), the work buffer and the parameter block agree with
    csrc/nav.cuh."""
    from flightjax_torch.parallel import launch as L
    from flightjax_torch.testing import nav_sim
    sim, _ = nav_sim("cpu", torch.float64)
    want = (K.rows((K.NAV_U,)), K.rows((K.NAV_S,)), len(K.NAV_INT),
            K.rows((K.NAV_T,)), L.N_NAV_WORK,
            len(K.nav_param_values(sim.system.aircraft.avionics)))
    assert tuple(host_lib.host_nav_rows(k) for k in range(6)) == want


# ------------------------------------------------------------ the sensor-fed
# missions

def _msn_nav_fleet_args(batch):
    """msn_nav_ctl_laws' arguments on the estimates of the sensor-fed
    mission operands (`testing.msn_nav_operand_state`, `msn_nav_pass_args`:
    their plain navigation pass's GDC_Y fields and h_o, the truth's engine
    state)."""
    from flightjax_torch.testing import (msn_nav_operand_state,
                                         msn_nav_pass_args)
    return msn_nav_pass_args(*msn_nav_operand_state(batch, 1016, "cpu",
                                                    torch.float64))


MSN_NAV_CASES = [("rich", B, 32), ("rich", 37, 32), ("rich", 70, 64),
                 ("fleet", B, 32), ("fleet", 37, 64)]


@pytest.mark.parametrize(
    "operands,batch,lanes", MSN_NAV_CASES,
    ids=[f"{o}-B{b}-L{n}" for o, b, n in MSN_NAV_CASES])
def test_msn_nav_ctl_laws_source_matches_plain(host_lib, batch, lanes,
                                               operands):
    """msn_nav_ctl_laws against `msn_nav_ctl_laws_plain` to 1e-12, phases,
    modes and flags exactly: on the mode-rich mission operands with the
    final leg ended by the radar gate on h_o (`testing.msn_nav_laws_args`:
    h_o either side of the gate, on the other side from h_e's of the old
    gate) and on the estimates of the sensor-fed mission operands."""
    from flightjax_torch.testing import msn_nav_laws_args
    args = (msn_nav_laws_args(batch, 1016, "cpu", torch.float64, (21, 22))
            if operands == "rich" else _msn_nav_fleet_args(batch))
    got = K.unpack_out("msn_nav_ctl_laws",
                       _run_ctl_laws(host_lib, args, lanes,
                                     name="msn_nav_ctl_laws"))
    ref = K.msn_nav_ctl_laws_plain(*args)
    _assert_trees_close(got, ref)
    moved = ref[0]["phase"] != args[3]["phase"]
    assert bool(moved.any()) and bool((~moved).any())


def test_msn_nav_ctl_laws_sides_partition_the_output(host_lib):
    """Every output row of msn_nav_ctl_laws is written by exactly one of
    its two sides, for every aircraft."""
    from flightjax_torch.testing import msn_nav_laws_args
    outs = _run_ctl_laws(host_lib, msn_nav_laws_args(
        B, 1016, "cpu", torch.float64, (21, 22)), 32, by_side=True,
        name="msn_nav_ctl_laws")
    full = sum((~o.isnan()).all(dim=1).int() for o in outs)
    touched = sum((~o.isnan()).any(dim=1).int() for o in outs)
    assert full.tolist() == [1] * outs[0].shape[0]
    assert touched.tolist() == [1] * outs[0].shape[0]


@pytest.mark.parametrize("setting", ["default", "shadow"])
def test_nav_pass_msn_nav_source_matches_plain(host_lib, setting):
    """nav_pass's mission instance against `nav_pass_plain` on the
    sensor-fed mission operands: the GDC_Y fields, the new state and the
    orthometric height the radar gate reads (the estimate: terrain plus the
    radar return where it is valid, the filter's altitude less the
    undulation where not; the truth's in shadow mode)."""
    from flightjax_torch.testing import msn_nav_operand_state, nav_pass_args
    sim, st = msn_nav_operand_state(B, 1016, "cpu", torch.float64,
                                    setting=setting)
    args = nav_pass_args(sim, st)
    out, ints = _run_nav_pass(host_lib, args, 32)
    assert out.shape[0] == K.rows(K.NAV_OUT_MSN)
    got = K.unpack_out("nav_pass", out, ints=ints)
    ref = K.nav_pass_plain(*args)
    _assert_trees_close(got, ref)
    _assert_p_close(got[0]["nav"].P, ref[0]["nav"].P)
    truth = args[1].kinematics.h_o
    off = (got[1]["h_o"] - truth).abs()
    if setting == "shadow":
        assert float(off.max()) == 0.0
    else:  # the out-of-range lanes read the filter, 2.5 m off the truth
        assert float(off.max()) > 2.0


MSN_NAV_MEGA_CASES = [(1, "default", B, 32), (2, "default", B, 32),
                      (1, "shadow", B, 32), (1, "immediate", B, 32),
                      (1, "default", 37, 32), (1, "default", 70, 64)]


@pytest.mark.parametrize(
    "spp,setting,batch,lanes", MSN_NAV_MEGA_CASES,
    ids=[f"spp{p}-{s}-B{b}-L{n}" for p, s, b, n in MSN_NAV_MEGA_CASES])
def test_megakernel_msn_nav_source_matches_plain(host_lib, spp, setting,
                                                 batch, lanes):
    """megakernel_msn_nav against `megakernel_step_plain` on the sensor-fed
    mission operands: the step, the truth at the new state, the navigation
    pass, then the phase machine (its radar gate on the estimated h_o), the
    guidance and the control laws on the estimates (on the truth in shadow
    mode) and the phases' systems inputs; every leaf within TOL, P per
    lane against its largest entry, the integers and the phases exactly.
    The out-of-range lane flares on its filter's altitude, 2.5 m under a
    truth above the gate: a phase machine reading the truth's h_o would
    not match."""
    from flightjax_torch.parallel.megakernel import megakernel_step_plain
    from flightjax_torch.testing import NAV_FINAL
    sim, st, got = _run_megakernel_nav(host_lib, batch, lanes, False, spp,
                                       setting, msn=True)
    ref = megakernel_step_plain(sim, st)
    for name in ("t", "i", "x", "u", "s"):
        _assert_trees_close({name: getattr(got, name)},
                            {name: getattr(ref, name)})
    _assert_p_close(got.s["avionics"]["nav"].P, ref.s["avionics"]["nav"].P)
    fired = (st.i + 1) % spp == 0
    n0 = st.s["avionics"]["sens"]["n"]
    assert torch.equal(got.s["avionics"]["sens"]["n"],
                       torch.where(fired, n0 + 1, n0))
    ph0 = st.s["avionics"]["inner"]["phase"]
    moved = ref.s["avionics"]["inner"]["phase"] != ph0
    assert bool((moved & (ph0 == NAV_FINAL)).any())
    assert not bool(moved[~fired].any())


def test_megakernel_msn_nav_roles_partition_the_output(host_lib):
    """Every row of megakernel_msn_nav's new state buffer (the phase
    machine's, the overridden systems inputs, the navigation avionics'
    inputs and state among them) is written by exactly one role, for every
    aircraft."""
    _, _, outs = _run_megakernel_nav(host_lib, B, 32, False, by_role=True,
                                     msn=True)
    full = sum((~o.isnan()).all(dim=1).int() for o in outs)
    touched = sum((~o.isnan()).any(dim=1).int() for o in outs)
    assert full.tolist() == [1] * outs[0].shape[0]
    assert touched.tolist() == [1] * outs[0].shape[0]


# ------------------------------------------------------------ the sensor-fed
# C172Xv2 and missions in turbulence

NAV_TURB_CASES = [(1, "default", B, 32), (2, "default", B, 32),
                  (1, "radar", B, 32), (1, "shadow", B, 32),
                  (1, "default", 37, 32), (1, "default", 70, 64)]
NAV_TURB_IDS = [f"spp{p}-{s}-B{b}-L{n}" for p, s, b, n in NAV_TURB_CASES]


@pytest.mark.parametrize("spp,setting,batch,lanes", NAV_TURB_CASES,
                         ids=NAV_TURB_IDS)
def test_megakernel_gdc_nav_turb_source_matches_plain(host_lib, spp, setting,
                                                      batch, lanes):
    """megakernel_gdc_nav_turb against `megakernel_step_plain` on the
    turbulent sensor-fed C172Xv2's mode-rich operands
    (`testing.nav_operand_state(turbulence=True, gdc=True)`: the
    navigation operands with the mode-rich control laws and guidance, W20
    up to 8 m/s and discrete gusts on some lanes): the turbulent step, the
    truth at the new state with the gust at the new time, the navigation
    pass, then the guidance and the control laws on the estimates, every
    leaf within TOL, P per lane against its largest entry, the integers
    (the turbulence's counters among them) exactly."""
    from flightjax_torch.parallel.megakernel import megakernel_step_plain
    sim, st, got = _run_megakernel_nav(host_lib, batch, lanes, True, spp,
                                       setting, gdc=True)
    assert K.avionics_layout(sim.system.aircraft.vehicle,
                             sim.system.aircraft.avionics) is K.GDC_TURB_NAV
    ref = megakernel_step_plain(sim, st)
    for name in ("t", "i", "x", "u", "s"):
        _assert_trees_close({name: getattr(got, name)},
                            {name: getattr(ref, name)})
    _assert_p_close(got.s["avionics"]["nav"].P, ref.s["avionics"]["nav"].P)
    fired = (st.i + 1) % spp == 0
    n0 = st.s["avionics"]["sens"]["n"]
    assert torch.equal(got.s["avionics"]["sens"]["n"],
                       torch.where(fired, n0 + 1, n0))
    assert torch.equal(got.s["vehicle"]["turb"]["n"],
                       st.s["vehicle"]["turb"]["n"] + 1)
    lon = ref.s["avionics"]["inner"]["ctl"]["lon"]["mode_prev"]
    assert bool((fired & (lon == 8)).any())


@pytest.mark.parametrize("spp,setting,batch,lanes", NAV_TURB_CASES,
                         ids=NAV_TURB_IDS)
def test_megakernel_msn_nav_turb_source_matches_plain(host_lib, spp, setting,
                                                      batch, lanes):
    """megakernel_msn_nav_turb against `megakernel_step_plain` on the
    sensor-fed mission operands in turbulence (`testing.
    msn_nav_operand_state(turbulence=True)`: each phase of both missions,
    lanes either side of the radar gate, W20 = 10 m/s, the shear on every
    third lane, a discrete gust on every third lane from lane 1): the
    turbulent step, the truth at the new state, the navigation pass, then
    the phase machine on the estimated h_o, the guidance and the control
    laws and the phases' systems inputs; every leaf within TOL, P per lane
    against its largest entry, the integers and the phases exactly."""
    from flightjax_torch.parallel.megakernel import megakernel_step_plain
    sim, st, got = _run_megakernel_nav(host_lib, batch, lanes, True, spp,
                                       setting, msn=True)
    assert K.avionics_layout(sim.system.aircraft.vehicle,
                             sim.system.aircraft.avionics) is K.MSN_TURB_NAV
    ref = megakernel_step_plain(sim, st)
    for name in ("t", "i", "x", "u", "s"):
        _assert_trees_close({name: getattr(got, name)},
                            {name: getattr(ref, name)})
    _assert_p_close(got.s["avionics"]["nav"].P, ref.s["avionics"]["nav"].P)
    fired = (st.i + 1) % spp == 0
    n0 = st.s["avionics"]["sens"]["n"]
    assert torch.equal(got.s["avionics"]["sens"]["n"],
                       torch.where(fired, n0 + 1, n0))
    assert torch.equal(got.s["vehicle"]["turb"]["n"],
                       st.s["vehicle"]["turb"]["n"] + 1)
    moved = ref.s["avionics"]["inner"]["phase"] != st.s["avionics"][
        "inner"]["phase"]
    assert bool(moved.any()) and not bool(moved[~fired].any())


@pytest.mark.parametrize("avk", ["gdc", "msn"])
def test_megakernel_nav_turb_xv2_roles_partition_the_output(host_lib, avk):
    """Every row of megakernel_gdc_nav_turb's and megakernel_msn_nav_turb's
    new state buffers (the turbulence's filter states, inputs and drive,
    the navigation avionics' inputs and state, around the mission the
    phase machine's and the overridden systems inputs) is written by
    exactly one role, for every aircraft."""
    _, _, outs = _run_megakernel_nav(host_lib, B, 32, True, by_role=True,
                                     gdc=avk == "gdc", msn=avk == "msn")
    full = sum((~o.isnan()).all(dim=1).int() for o in outs)
    touched = sum((~o.isnan()).any(dim=1).int() for o in outs)
    assert full.tolist() == [1] * outs[0].shape[0]
    assert touched.tolist() == [1] * outs[0].shape[0]
