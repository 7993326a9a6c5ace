// The C172Xv2's guidance laws as per-aircraft __device__ functions: the
// segment and circle geometry, the intercept laws, the cross-track gate of
// the vertical guidance and the mode machine direct / segment / circular
// (flightjax_torch/models/c172/c172x_gdc.py::GuidanceLaws), in Strict<F>
// like the rest of flight_math.cuh, operation by operation and in the same
// association order as the plain PyTorch port. The override of the control
// laws' requests (`override_ctl_u`) is the `Ovr` argument of lon_step and
// lat_step (c172x_ctl.cuh). ctl_laws.cu runs the pass over a fleet as the
// `gdc_ctl_laws` kernel; the `megakernel_gdc` instance of megakernel.cu runs
// it inside the whole step, when it fires; a scripted mission's phases
// (c172x_msn.cuh) read the same segment geometry of their legs.
//
// The plain version works out both the segment and the circle branch on
// every lane and selects; a lane here works out the one branch its mode
// selects (the circle where the mode is circular, the segment elsewhere),
// which gives the same rows. The guidance reads the n-vector of the new
// position (nvector_from_qew of the new q_ew, as KinData holds it), the
// new h_e and the weight on wheels; its inputs are the AV_U_GDC rows.
#pragma once

#include "c172x_ctl.cuh"

namespace fj {

// ------------------------------------------------------------- row maps

constexpr int GDC_DIRECT = 0, GDC_SEGMENT = 1, GDC_CIRCULAR = 2;
// the intercept angle at infinite cross-track error, the cross-track
// scaling and the cross-track gate of the vertical guidance (m)
constexpr double DCHI_INF = PI / 2, E_SF = 250.0, E_THR = 1000.0;

// the guidance's inputs: the mode request, the segment (n_e1, h_e1, n_e2,
// h_e2), the circle (n_e, h_e, radius, turn_dir), the two requests
constexpr int UG_MODE = 0, UG_N_E1 = 1, UG_H_E1 = 4, UG_N_E2 = 5,
              UG_H_E2 = 8, UG_N_C = 9, UG_H_C = 12, UG_RADIUS = 13,
              UG_TURN = 14, UG_HOR = 15, UG_VRT = 16, N_UGDC = 17;
// GDC_Y, what the guidance and the control laws read: CTL_Y, then the
// n-vector
constexpr int CY_N_E = N_CTLY, N_GDCY = CY_N_E + 3;                   // 34
// the GdcY rows gdc_ctl_laws writes: the mode, the intercept angle, the
// course and altitude references and the two activity flags
constexpr int GO_MODE = 0, GO_DCHI = 1, GO_CHI_REF = 2, GO_H_REF = 3,
              GO_HOR = 4, GO_VRT = 5, N_GDCO = 6;
// gdc_ctl_laws: in = GDC_Y, the avionics block, the guidance's inputs ;
// out = s lon, s lat, the commands, the GdcY rows
constexpr int AV_UGDC = N_AV;
constexpr int GDC_N_IN = N_GDCY + N_AV + N_UGDC;                     // 119
constexpr int GDC_N_OUT = CTL_N_OUT + N_GDCO;                         // 59
// the megakernel_gdc state buffer: megakernel_fbw's, then the guidance's
// inputs
constexpr int MEGA_N_ROWS_GDC = MEGA_N_ROWS_FBW + N_UGDC;             // 158

// ------------------------------------------------------------- geometry

static __device__ __noinline__ SF Atan(SF x) { return SF::of(atanf(x.v)); }
static __device__ __noinline__ SD Atan(SD x) { return SD::of(atan(x.v)); }

// ECEF -> NED rotation quaternion at the n-vector (ops/geodesy.py::ltf at
// psi_nw = 0): two atan2 for lat and lon, then the two half-angle
// rotations; the third, Rz(0), is the identity, through which the plain
// product passes every value unchanged
template <typename T>
__device__ __forceinline__ Q4<T> ltf(V3<T> n) {
  const T lat = Atan2(n.z, Sqrt(n.x * n.x + n.y * n.y));
  const T lon = Atan2(n.y, n.x);
  const T hz = T(0.5) * lon, hy = T(0.5) * -(lat + T(0.5 * PI));
  const Q4<T> rz = {Cos(hz), T(0.0), T(0.0), Sin(hz)};
  const Q4<T> ry = {Cos(hy), T(0.0), Sin(hy), T(0.0)};
  return qmul(rz, ry);
}

// the north and east components of r (ECEF) in the NED frame q_en
template <typename T>
__device__ __forceinline__ void horizontal(Q4<T> q_en, V3<T> r, T& x,
                                           T& y) {
  const V3<T> r_n = qrot_inv(q_en, r);
  x = r_n.x;
  y = r_n.y;
}

// what one branch gives the mode machine: the intercept angle, the course
// and altitude references, the cross-track error
template <typename T>
struct GdcRef {
  T dchi, chi_ref, h_ref, e_lat;
};

// what the guidance and a mission's phases read of segment_data: the leg
// length, the along-track distance from the first endpoint, the
// cross-track error, the segment's height there and its course
template <typename T>
struct SegData {
  T s_12, s_1b, e_sb, h_s, chi_12;
};

// segment_data (c172x_gdc.py) of the segment held in the rows UG_N_E1 ..
// UG_H_E2 of u (the guidance's inputs, or a leg of a mission's table) at
// the vehicle's r_eb in its NED frame q_en
template <typename T>
__device__ __forceinline__ SegData<T> segment_data(const Col<T>& u,
                                                   Q4<T> q_en, V3<T> r_eb) {
  const V3<T> r_e1 = cartesian_from_geographic(u.v3(UG_N_E1), u(UG_H_E1));
  const V3<T> r_e2 = cartesian_from_geographic(u.v3(UG_N_E2), u(UG_H_E2));
  T b_x, b_y, d_x, d_y;
  horizontal(q_en, sub(r_eb, r_e1), b_x, b_y);
  horizontal(q_en, sub(r_e2, r_e1), d_x, d_y);
  const T s_12 = Sqrt(d_x * d_x + d_y * d_y + T(1e-12));
  const T u_x = d_x / s_12, u_y = d_y / s_12;
  const T s_1b = u_x * b_x + u_y * b_y;
  const T e_sb = u_x * b_y - u_y * b_x;
  const T h_e1 = u(UG_H_E1);
  const T h_s = h_e1 + (u(UG_H_E2) - h_e1) * s_1b / s_12;
  const T chi_12 = Atan2(u_y, u_x);
  return {s_12, s_1b, e_sb, h_s, chi_12};
}

// the segment's intercept law (c172x_gdc.py)
template <typename T>
__device__ __forceinline__ GdcRef<T> segment_law(const Col<T>& u, Q4<T> q_en,
                                                 V3<T> r_eb) {
  const SegData<T> d = segment_data(u, q_en, r_eb);
  const T dchi = T(-DCHI_INF / (PI / 2)) * Atan(d.e_sb / T(E_SF));
  return {dchi, wrap_to_pi(d.chi_12 + dchi), d.h_s, d.e_sb};
}

// circle_data and the loiter law: the tangent course turned toward the
// circle by the atan capture term
template <typename T>
__device__ __forceinline__ GdcRef<T> circle_law(const Col<T>& u, Q4<T> q_en,
                                                V3<T> r_eb) {
  const V3<T> r_ec = cartesian_from_geographic(u.v3(UG_N_C), u(UG_H_C));
  T c_x, c_y;
  horizontal(q_en, sub(r_eb, r_ec), c_x, c_y);
  const T d_cb = Sqrt(c_x * c_x + c_y * c_y + T(1e-12));
  const T sigma = Atan2(c_y, c_x);
  const T turn = u(UG_TURN);
  const T chi_tan = wrap_to_pi(sigma + turn * T(PI / 2));
  const T e_cb = d_cb - u(UG_RADIUS);
  const T dchi = turn * T(DCHI_INF) / T(PI / 2) * Atan(e_cb / T(E_SF));
  return {dchi, wrap_to_pi(chi_tan + dchi), u(UG_H_C), e_cb};
}

// ------------------------------------------------------------- the laws

// what a caller needs of the guidance: every GdcY row gdc_ctl_laws writes,
// or one side's override (the lateral: course hold onto chi_ref; the
// vertical: the altitude mode onto h_ref), where the lane's geometry is
// worked out only if that side's guidance can be on
constexpr int GDC_ALL = 0, GDC_HOR = 1, GDC_VRT = 2;

template <typename T>
struct Gdc {
  int mode;
  T dchi, chi_ref, h_ref;
  bool hor, vrt;
};

// GuidanceLaws.f_periodic on the lane's inputs u (AV_U_GDC rows) and the
// GDC_Y rows y: the mode (direct on the ground), the branch its mode
// selects, the activity flags
template <int NEED, typename T>
__device__ __forceinline__ Gdc<T> guidance(const Col<T>& u, const Col<T>& y) {
  Gdc<T> g;
  g.mode = on_ground(y) ? GDC_DIRECT : int(u(UG_MODE).v);
  const bool crc_on = g.mode == GDC_CIRCULAR;
  const bool law_on = g.mode == GDC_SEGMENT || crc_on;
  const bool vrt_req = law_on && u(UG_VRT).v != 0;
  g.hor = law_on && u(UG_HOR).v != 0;
  g.vrt = false;
  g.dchi = g.chi_ref = g.h_ref = T(0.0);
  if ((NEED == GDC_HOR && !g.hor) || (NEED == GDC_VRT && !vrt_req)) return g;
  const V3<T> n_e = y.v3(CY_N_E);
  const V3<T> r_eb = cartesian_from_geographic(n_e, y(CY_H_E));
  const Q4<T> q_en = ltf(n_e);
  const GdcRef<T> r = crc_on ? circle_law(u, q_en, r_eb)
                             : segment_law(u, q_en, r_eb);
  g.dchi = r.dchi;
  g.chi_ref = r.chi_ref;
  g.h_ref = r.h_ref;
  g.vrt = vrt_req && Abs(r.e_lat) < T(E_THR);
  return g;
}

}  // namespace fj
