// ctl_laws: the C172X's periodic pass over a fleet -- ControlLaws.f_periodic
// (the lon and lat passes: gain lookups over (EAS, h), PIDs, integrators,
// LQR trackers, mode logic and the altitude machine) and `assign`, the four
// new servo commands.
//
// Replaces the pass that the TPU kernel of flightjax/parallel/megakernel.py::
// make_megakernel_step (:43, pallas_call :120) runs inside the whole step
// on the C172Xv1 (core/sim.py:327-333), exposed as a kernel of its own so
// that it can be held against its plain version, and that the two C172Xv1
// splits launch after each firing step in place of several hundred
// PyTorch ops (parallel/clusterstep.py::_periodic; the JAX package runs the
// pass there as XLA glue, flightjax/parallel/clusterstep.py:591-607). Plain
// PyTorch version: flightjax_torch/parallel/kernels.py::ctl_laws_plain.
//
// In: the CTL_Y rows (c172x_ctl.cuh) and the avionics block (u lon, u lat,
// s lon, s lat). Out: the new s lon and s lat, then the commands of the
// aileron, elevator, rudder and throttle.
//
// What bounds it on the H100: not bytes (152 rows per lane, 2.5 MB in
// float32 at B = 4096, 0.7 us of HBM) nor operations (a few hundred per
// lane), but each lane's chain through its lookups and controllers, and the
// branches: lanes in different modes take different paths. The lon and lat
// passes share nothing but their inputs, so they run in two warps per 32
// aircraft (thread = side * lanes + lane; lon_step and lat_step are one
// function each, each called by one warp). One thread per aircraft running
// both measured slower (PERF.md; `ctl_laws_thread` of
// tools/ablate_torch_roles.py). No barrier.
//
// gdc_ctl_laws is the same pass of the C172Xv2, whose avionics run the
// guidance laws first (c172x_gdc.cuh; c172x_gdc.py::Avionics.f_periodic
// and `assign`): the instance of the same TPU kernel on the C172Xv2 and the
// XLA glue of its splits. Plain PyTorch version: flightjax_torch/parallel/
// kernels.py::gdc_ctl_laws_plain. In: the GDC_Y rows (CTL_Y and the
// n-vector), the avionics block, the guidance's inputs. Out: ctl_laws'
// rows, then the GdcY rows of the pass (mode, intercept angle, course and
// altitude references, the two activity flags). Each warp works out the
// guidance its side needs, in its own lanes, before its pass (the lat warp
// the course, the lon warp the altitude and the cross-track gate): the same
// chain as one warp computing it for both and a barrier, without the
// barrier or the shared memory.
//
// msn_ctl_laws is the same pass over a world whose C172Xv2 flies a scripted
// mission (core/mission.py::MissionAvionics over c172x_gdc.py::Avionics,
// the phases of models/c172/missions.py): the instance of the same TPU
// kernel over that world and the XLA glue of its splits. Plain PyTorch
// version: flightjax_torch/parallel/kernels.py::msn_ctl_laws_plain. In: the
// MSN_Y rows (GDC_Y and the engine's state), the avionics block, the
// guidance's inputs, the phase machine's state (phase, mission clock), the
// flaps, brake and starter inputs (c172x_msn.cuh). Out: gdc_ctl_laws' rows,
// the new phase and clock, those four inputs after `assign`. Each warp
// applies the lane's phase to the inputs its side reads (the guidance's and
// its own control laws', in local memory) before its guidance and its
// pass; the lon warp then works out the phase's predicate, the new phase
// and clock and the new phase's systems overrides. The mission table is
// read through the cache at the end of the gains (kernels.ctl_gains). What
// bounds it is what bounds gdc_ctl_laws, with the phase machine's branches
// and, on the lanes whose phase reads a leg, one more segment geometry.
//
// msn_nav_ctl_laws is the same mission pass over a world whose mission
// flies on the navigation avionics' estimates (physics/navigation.py::
// NavAvionics around the MissionAvionics; the sensor-fed landing and
// takeoff of flightjax/demos/c172_demos.py:413-532): the pass the splits
// launch after nav_pass, on its estimates. Plain PyTorch version:
// flightjax_torch/parallel/kernels.py::msn_nav_ctl_laws_plain. Its input
// rows are msn_ctl_laws' with the orthometric height after MSN_Y (MSN_NAV_Y:
// the estimate, which the radar altimeter's flare gate MD_AGL reads), its
// output msn_ctl_laws'. One template: the truth-fed instance has no h_o row
// and no radar gate, and keeps its code.
#include "c172x_msn.cuh"

using namespace fj;

// the lon and the lat side
constexpr int CTL_SIDES = 2;

template <typename T>
__global__ void __launch_bounds__(2 * MAX_LANES)
    ctl_laws_kernel(const T* __restrict__ in, const T* __restrict__ G,
                    T* __restrict__ out, int B, T dt) {
  const RoleThread t = role_thread(B, CTL_SIDES);
  if (!t.valid) return;
  const Col<T> y{in, B, t.b};
  const Col<T> u_lon{in + (N_CTLY + AV_ULON) * B, B, t.b};
  const Col<T> u_lat{in + (N_CTLY + AV_ULAT) * B, B, t.b};
  const Col<T> s_lon{in + (N_CTLY + AV_SLON) * B, B, t.b};
  const Col<T> s_lat{in + (N_CTLY + AV_SLAT) * B, B, t.b};
  const Out<T> o{out, B, t.b};
  constexpr int O_CMD = N_SLON + N_SLAT;
  if (t.role == 0) {
    const Cmd2<T> c = lon_step(G, y, u_lon, s_lon, o, dt);
    o.s(O_CMD + CC_THR, c.a);
    o.s(O_CMD + CC_ELV, c.b);
  }
  if (t.role == 1) {
    const Cmd2<T> c =
        lat_step(G, y, u_lat, s_lat, Out<T>{out + N_SLON * B, B, t.b}, dt);
    o.s(O_CMD + CC_AIL, c.a);
    o.s(O_CMD + CC_RUD, c.b);
  }
}

template <typename T>
__global__ void __launch_bounds__(2 * MAX_LANES)
    gdc_ctl_laws_kernel(const T* __restrict__ in, const T* __restrict__ G,
                        T* __restrict__ out, int B, T dt) {
  const RoleThread t = role_thread(B, CTL_SIDES);
  if (!t.valid) return;
  const Col<T> y{in, B, t.b};
  const Col<T> u_lon{in + (N_GDCY + AV_ULON) * B, B, t.b};
  const Col<T> u_lat{in + (N_GDCY + AV_ULAT) * B, B, t.b};
  const Col<T> s_lon{in + (N_GDCY + AV_SLON) * B, B, t.b};
  const Col<T> s_lat{in + (N_GDCY + AV_SLAT) * B, B, t.b};
  const Col<T> u_gdc{in + (N_GDCY + AV_UGDC) * B, B, t.b};
  const Out<T> o{out, B, t.b};
  const Out<T> og{out + CTL_N_OUT * B, B, t.b};
  constexpr int O_CMD = N_SLON + N_SLAT;
  if (t.role == 0) {
    const Gdc<T> g = guidance<GDC_ALL>(u_gdc, y);
    const Cmd2<T> c = lon_step<T, true>(G, y, u_lon, s_lon, o, dt,
                                        Ovr<T>{g.vrt, g.h_ref});
    o.s(O_CMD + CC_THR, c.a);
    o.s(O_CMD + CC_ELV, c.b);
    og.s(GO_H_REF, g.h_ref);
    og.s(GO_VRT, T(g.vrt ? 1.0 : 0.0));
  }
  if (t.role == 1) {
    const Gdc<T> g = guidance<GDC_ALL>(u_gdc, y);
    const Cmd2<T> c =
        lat_step<T, true>(G, y, u_lat, s_lat, Out<T>{out + N_SLON * B, B, t.b},
                          dt, Ovr<T>{g.hor, g.chi_ref});
    o.s(O_CMD + CC_AIL, c.a);
    o.s(O_CMD + CC_RUD, c.b);
    og.s(GO_MODE, T(double(g.mode)));
    og.s(GO_DCHI, g.dchi);
    og.s(GO_CHI_REF, g.chi_ref);
    og.s(GO_HOR, T(g.hor ? 1.0 : 0.0));
  }
}

// NAV: MSN_NAV_KIND for the sensor-fed missions' instance, 0 for the
// truth-fed msn_ctl_laws (an int, so that the recorded machine code of the
// other keeps its name)
template <typename T, int NAV = 0>
__global__ void __launch_bounds__(2 * MAX_LANES)
    msn_ctl_laws_kernel(const T* __restrict__ in, const T* __restrict__ G,
                        T* __restrict__ out, int B, T dt) {
  using R = MsnIn<NAV != 0>;
  const RoleThread t = role_thread(B, CTL_SIDES);
  if (!t.valid) return;
  const T* M = mission_table(G);
  const Col<T> y{in, B, t.b};
  const Col<T> c{in, B, t.b};
  const Col<T> s_lon{in + (R::AV + AV_SLON) * B, B, t.b};
  const Col<T> s_lat{in + (R::AV + AV_SLAT) * B, B, t.b};
  const Out<T> o{out, B, t.b};
  const Out<T> og{out + CTL_N_OUT * B, B, t.b};
  const T phase = c(R::SMSN + SM_PHASE);
  constexpr int O_CMD = N_SLON + N_SLAT;
  T ug_v[N_UGDC], uc_v[N_ULON];
  const bool lon = t.role == 0;
  msn_inputs(M, lon, c, R::UGDC, R::AV + (lon ? AV_ULON : AV_ULAT), phase,
             y, ug_v, uc_v);
  const Col<T> ug{ug_v, 1, 0}, uc{uc_v, 1, 0};
  const Gdc<T> g = guidance<GDC_ALL>(ug, y);
  if (lon) {
    const Cmd2<T> cmd = lon_step<T, true>(G, y, uc, s_lon, o, dt,
                                          Ovr<T>{g.vrt, g.h_ref});
    o.s(O_CMD + CC_THR, cmd.a);
    o.s(O_CMD + CC_ELV, cmd.b);
    og.s(GO_H_REF, g.h_ref);
    og.s(GO_VRT, T(g.vrt ? 1.0 : 0.0));
    // the phase machine and the new phase's systems overrides
    T us[N_MUSYS];
#pragma unroll
    for (int k = 0; k < N_MUSYS; ++k) us[k] = c(R::MUSYS + k);
    const MsnState<T> m =
        msn_step<T, NAV != 0>(M, y, phase, c(R::SMSN + SM_T), dt, us);
    const Out<T> om{out + GDC_N_OUT * B, B, t.b};
    om.s(SM_PHASE, m.phase);
    om.s(SM_T, m.t);
#pragma unroll
    for (int k = 0; k < N_MUSYS; ++k) om.s(N_SMSN + k, us[k]);
  } else {
    const Cmd2<T> cmd =
        lat_step<T, true>(G, y, uc, s_lat, Out<T>{out + N_SLON * B, B, t.b},
                          dt, Ovr<T>{g.hor, g.chi_ref});
    o.s(O_CMD + CC_AIL, cmd.a);
    o.s(O_CMD + CC_RUD, cmd.b);
    og.s(GO_MODE, T(double(g.mode)));
    og.s(GO_DCHI, g.dchi);
    og.s(GO_CHI_REF, g.chi_ref);
    og.s(GO_HOR, T(g.hor ? 1.0 : 0.0));
  }
}

template <bool GDC, typename T>
static int launch(const void* in, const void* gains, void* out, int B,
                  double dt, int lanes, void* stream) {
  if (B <= 0) return 0;
  if (lanes <= 0 || lanes > MAX_LANES || lanes % 32 != 0)
    return (int)cudaErrorInvalidValue;
  const RoleLaunch l = role_launch(B, lanes, CTL_SIDES, 0);
  if (GDC)
    gdc_ctl_laws_kernel<T><<<l.grid, l.block, 0, (cudaStream_t)stream>>>(
        (const T*)in, (const T*)gains, (T*)out, B, T(dt));
  else
    ctl_laws_kernel<T><<<l.grid, l.block, 0, (cudaStream_t)stream>>>(
        (const T*)in, (const T*)gains, (T*)out, B, T(dt));
  return (int)cudaGetLastError();
}

// the mission's pass: its gains hold the mission table; NAV MSN_NAV_KIND
// the sensor-fed missions' instance
template <typename T, int NAV = 0>
static int launch_msn(const void* in, const void* gains, void* out, int B,
                      double dt, int lanes, void* stream) {
  if (B <= 0) return 0;
  if (lanes <= 0 || lanes > MAX_LANES || lanes % 32 != 0)
    return (int)cudaErrorInvalidValue;
  const RoleLaunch l = role_launch(B, lanes, CTL_SIDES, 0);
  msn_ctl_laws_kernel<T, NAV><<<l.grid, l.block, 0, (cudaStream_t)stream>>>(
      (const T*)in, (const T*)gains, (T*)out, B, T(dt));
  return (int)cudaGetLastError();
}

extern "C" {
int ctl_laws_f32(const void* in, const void* gains, void* out, int B,
                 double dt, int lanes, void* stream) {
  return launch<false, SF>(in, gains, out, B, dt, lanes, stream);
}
int ctl_laws_f64(const void* in, const void* gains, void* out, int B,
                 double dt, int lanes, void* stream) {
  return launch<false, SD>(in, gains, out, B, dt, lanes, stream);
}
int gdc_ctl_laws_f32(const void* in, const void* gains, void* out, int B,
                     double dt, int lanes, void* stream) {
  return launch<true, SF>(in, gains, out, B, dt, lanes, stream);
}
int gdc_ctl_laws_f64(const void* in, const void* gains, void* out, int B,
                     double dt, int lanes, void* stream) {
  return launch<true, SD>(in, gains, out, B, dt, lanes, stream);
}
int msn_ctl_laws_f32(const void* in, const void* gains, void* out, int B,
                     double dt, int lanes, void* stream) {
  return launch_msn<SF>(in, gains, out, B, dt, lanes, stream);
}
int msn_ctl_laws_f64(const void* in, const void* gains, void* out, int B,
                     double dt, int lanes, void* stream) {
  return launch_msn<SD>(in, gains, out, B, dt, lanes, stream);
}
int msn_nav_ctl_laws_f32(const void* in, const void* gains, void* out,
                         int B, double dt, int lanes, void* stream) {
  return launch_msn<SF, MSN_NAV_KIND>(in, gains, out, B, dt, lanes, stream);
}
int msn_nav_ctl_laws_f64(const void* in, const void* gains, void* out,
                         int B, double dt, int lanes, void* stream) {
  return launch_msn<SD, MSN_NAV_KIND>(in, gains, out, B, dt, lanes, stream);
}
void ctl_laws_layout(int* n_in, int* n_out) {
  *n_in = CTL_N_IN;
  *n_out = CTL_N_OUT;
}
void gdc_ctl_laws_layout(int* n_in, int* n_out) {
  *n_in = GDC_N_IN;
  *n_out = GDC_N_OUT;
}
void msn_ctl_laws_layout(int* n_in, int* n_out) {
  *n_in = MSN_N_IN;
  *n_out = MSN_N_OUT;
}
void msn_nav_ctl_laws_layout(int* n_in, int* n_out) {
  *n_in = MsnIn<true>::N;
  *n_out = MSN_N_OUT;
}
// n_params and elem_size are not read: the kernels take no shared memory
void ctl_laws_launch_shape(int B, int lanes, int, int, int* grid, int* block,
                           int* shared) {
  put_launch(role_launch(B, lanes, CTL_SIDES, 0), grid, block, shared);
}
void gdc_ctl_laws_launch_shape(int B, int lanes, int, int, int* grid,
                               int* block, int* shared) {
  put_launch(role_launch(B, lanes, CTL_SIDES, 0), grid, block, shared);
}
void msn_ctl_laws_launch_shape(int B, int lanes, int, int, int* grid,
                               int* block, int* shared) {
  put_launch(role_launch(B, lanes, CTL_SIDES, 0), grid, block, shared);
}
void msn_nav_ctl_laws_launch_shape(int B, int lanes, int, int, int* grid,
                                   int* block, int* shared) {
  put_launch(role_launch(B, lanes, CTL_SIDES, 0), grid, block, shared);
}
}
