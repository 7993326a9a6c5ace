// Per-aircraft flight math as __device__ functions, templated on float /
// double: vector and quaternion helpers, WGS84 geodesy, ISA atmosphere,
// air data, the wander-azimuth kinematics and Newton-Euler dynamics.
//
// Every formula mirrors the plain PyTorch port (flightjax_torch/ops,
// flightjax_torch/physics) and, through it, the JAX reference, operation
// by operation and in the same association order; constants are the same
// double expressions, rounded to T once. The kernels compute in Strict<F>:
// its + - * / are the _rn intrinsics, which the compiler never fuses into
// an FMA, so every operation rounds on its own as the plain PyTorch ops
// round it; the math library calls (sqrt, atan2, pow, ...) are the same
// functions, built with the same default flags, that PyTorch's CUDA ops
// call. Kernel and plain then agree to a few ulp.
//
// Code size is a cost of its own in the kernels whose warps run different
// code (rk4_stage, megakernel: one warp per subsystem): measured on the
// H100, they are slower with the table lookup inlined at its twenty call
// sites than with one copy of it (PERF.md). So what is long and called many
// times is one real function (`__noinline__`): the table lookup and the math
// library wrappers. The short vector and quaternion helpers stay inline, and
// so do the functions that take KinData or AirData, which would travel
// through the stack and measured slower.
//
// The kernels read and write batch-minor buffers: field row r of lane b
// lives at buf[r * B + b]. The row maps below are the C++ half of the
// column maps in flightjax_torch/parallel/kernels.py.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace fj {

// ------------------------------------------------------------- constants

// WGS84 (flightjax/ops/geodesy.py:31-49)
constexpr double GM = 3.986005e14;
constexpr double A = 6378137.0;
constexpr double F = 1.0 / 298.257223563;
constexpr double OMEGA_IE = 7.292115e-05;
constexpr double B_AX = A * (1.0 - F);
constexpr double E2 = 2.0 * F - F * F;
constexpr double A2 = A * A;
constexpr double M_G = OMEGA_IE * OMEGA_IE * A2 * B_AX / GM;
constexpr double G_A = 9.7803253359;
constexpr double G_B = 9.8321849378;
constexpr double K_G = B_AX * G_B / (A * G_A) - 1.0;

// ISA / air (flightjax/physics/atmosphere.py:25-45)
constexpr double R_GAS = 287.05287;
constexpr double GAMMA = 1.40;
constexpr double BETA_S = 1.458e-6;
constexpr double S_SUTH = 110.4;
constexpr double T_STD = 288.15;
constexpr double P_STD = 101325.0;
constexpr double RHO_STD = P_STD / (R_GAS * T_STD);
constexpr double G_STD = 9.80665;
constexpr double T_SL_MIN = T_STD - 50.0, T_SL_MAX = T_STD + 50.0;
constexpr double P_SL_MIN = P_STD - 10000.0, P_SL_MAX = P_STD + 10000.0;
constexpr double V_MIN_CHI_GAMMA = 0.1;
constexpr double PI = 3.141592653589793;

// ------------------------------------------------------------- row maps

// x_kin = q_wb[4] q_ew[4] h_e ; x_dyn = omega_eb_b[3] v_eb_b[3]
constexpr int N_XKIN = 9, N_XDYN = 6;
// u_atm = T_sl p_sl wind[3]
constexpr int N_UATM = 5;
// KinData: e_nb 3, q_nb 4, q_eb 4, q_en 4, lat, lon, n_e 3, h_e, h_o,
// r_eb_e 3, omega_wb_b 3, omega_eb_b 3, v_eb_b 3, v_eb_n 3, v_gnd, chi, gamma
constexpr int N_KIN = 40;
// the first row of each KinData field
enum KinRow : int {
  KR_E_NB = 0, KR_Q_NB = 3, KR_Q_EB = 7, KR_Q_EN = 11, KR_LAT = 15,
  KR_LON = 16, KR_N_E = 17, KR_H_E = 20, KR_H_O = 21, KR_R_EB_E = 22,
  KR_OM_WB = 25, KR_OM_EB = 28, KR_V_EB_B = 31, KR_V_EB_N = 34,
  KR_V_GND = 37, KR_CHI = 38, KR_GAMMA = 39
};
// AirData: v_ew_n 3, v_ew_b 3, v_wb_b 3, T p rho a mu M Tt pt Dp q TAS EAS CAS
constexpr int N_AIR = 22;

// kinair: in  = x_kin, x_dyn, k_kin, k_dyn, geoid_N, u_atm, term
//         out = kin_dot, KinData, AirData, xi_dyn
constexpr int KINAIR_N_IN = 2 * (N_XKIN + N_XDYN) + 1 + N_UATM + 1;   // 37
constexpr int KINAIR_N_OUT = N_XKIN + N_KIN + N_AIR + N_XDYN;         // 77
// dynamics: in = x_dyn, m, J[9], r_OG[3], F[3], tau[3], hr_b[3], q_eb[4],
//                r_eb_e[3], term ; out = x_dyn derivative
constexpr int DYN_N_IN = N_XDYN + 1 + 9 + 3 + 3 + 3 + 3 + 4 + 3 + 1;   // 36
constexpr int DYN_N_OUT = N_XDYN;                                     // 6
// finish_kin: in  = x_kin, x_dyn, ksum_kin, ksum_dyn, geoid_N, u_atm,
//                   c_q_ew[4], c_h_e
//             out = x_kin, x_dyn, KinData, AirData, c_q_ew[4], c_h_e
constexpr int FIN_N_IN = 2 * (N_XKIN + N_XDYN) + 1 + N_UATM + 5;      // 41
constexpr int FIN_N_OUT = N_XKIN + N_XDYN + N_KIN + N_AIR + 5;        // 82
// geoid: in = q_ew[4] ; out = geoid_N. The grid buffer is [n_lat + 1, n_lon]:
// row 0 starts with the GEO_HEAD values n_lat, n_lon, lat0, dlat, lon0,
// dlon, rows 1.. hold the undulations
constexpr int GEOID_N_IN = 4, GEOID_N_OUT = 1, GEO_HEAD = 6;

// ------------------------------------------------------------- math

// F (float or double) whose arithmetic is never contracted into FMA
template <typename F>
struct Strict {
  F v;
  Strict() = default;
  __host__ __device__ explicit constexpr Strict(double d)
      : v(static_cast<F>(d)) {}
  __device__ static __forceinline__ Strict of(F x) {
    Strict r;
    r.v = x;
    return r;
  }
};
using SF = Strict<float>;
using SD = Strict<double>;

#define FJ_STRICT_OPS(S, ADD, SUB, MUL, DIV)                                  \
  __device__ __forceinline__ S operator+(S a, S b) { return S::of(ADD(a.v, b.v)); } \
  __device__ __forceinline__ S operator-(S a, S b) { return S::of(SUB(a.v, b.v)); } \
  __device__ __forceinline__ S operator*(S a, S b) { return S::of(MUL(a.v, b.v)); } \
  __device__ __forceinline__ S operator/(S a, S b) { return S::of(DIV(a.v, b.v)); } \
  __device__ __forceinline__ S operator-(S a) { return S::of(-a.v); }           \
  __device__ __forceinline__ bool operator<(S a, S b) { return a.v < b.v; }     \
  __device__ __forceinline__ bool operator>(S a, S b) { return a.v > b.v; }     \
  __device__ __forceinline__ bool operator<=(S a, S b) { return a.v <= b.v; }   \
  __device__ __forceinline__ bool operator>=(S a, S b) { return a.v >= b.v; }   \
  __device__ __forceinline__ bool operator!=(S a, S b) { return a.v != b.v; }   \
  __device__ __forceinline__ bool operator==(S a, S b) { return a.v == b.v; }
FJ_STRICT_OPS(SF, __fadd_rn, __fsub_rn, __fmul_rn, __fdiv_rn)
FJ_STRICT_OPS(SD, __dadd_rn, __dsub_rn, __dmul_rn, __ddiv_rn)
#undef FJ_STRICT_OPS

__device__ __forceinline__ SF Sqrt(SF x) { return SF::of(sqrtf(x.v)); }
__device__ __forceinline__ SD Sqrt(SD x) { return SD::of(sqrt(x.v)); }
__device__ __forceinline__ SF Rsqrt(SF x) { return SF::of(rsqrtf(x.v)); }
__device__ __forceinline__ SD Rsqrt(SD x) { return SD::of(rsqrt(x.v)); }
static __device__ __noinline__ SF Atan2(SF y, SF x) { return SF::of(atan2f(y.v, x.v)); }
static __device__ __noinline__ SD Atan2(SD y, SD x) { return SD::of(atan2(y.v, x.v)); }
static __device__ __noinline__ SF Asin(SF x) { return SF::of(asinf(x.v)); }
static __device__ __noinline__ SD Asin(SD x) { return SD::of(asin(x.v)); }
static __device__ __noinline__ SF Pow(SF x, SF y) { return SF::of(powf(x.v, y.v)); }
static __device__ __noinline__ SD Pow(SD x, SD y) { return SD::of(pow(x.v, y.v)); }
static __device__ __noinline__ SF Exp(SF x) { return SF::of(expf(x.v)); }
static __device__ __noinline__ SD Exp(SD x) { return SD::of(exp(x.v)); }
__device__ __forceinline__ SF Abs(SF x) { return SF::of(fabsf(x.v)); }
__device__ __forceinline__ SD Abs(SD x) { return SD::of(fabs(x.v)); }
static __device__ __noinline__ SF Acos(SF x) { return SF::of(acosf(x.v)); }
static __device__ __noinline__ SD Acos(SD x) { return SD::of(acos(x.v)); }
static __device__ __noinline__ SF Cos(SF x) { return SF::of(cosf(x.v)); }
static __device__ __noinline__ SD Cos(SD x) { return SD::of(cos(x.v)); }
static __device__ __noinline__ SF Sin(SF x) { return SF::of(sinf(x.v)); }
static __device__ __noinline__ SD Sin(SD x) { return SD::of(sin(x.v)); }
static __device__ __noinline__ SF Tan(SF x) { return SF::of(tanf(x.v)); }
static __device__ __noinline__ SD Tan(SD x) { return SD::of(tan(x.v)); }
__device__ __forceinline__ SF Floor(SF x) { return SF::of(floorf(x.v)); }
__device__ __forceinline__ SD Floor(SD x) { return SD::of(floor(x.v)); }
__device__ __forceinline__ SF Fmod(SF x, SF y) { return SF::of(fmodf(x.v, y.v)); }
__device__ __forceinline__ SD Fmod(SD x, SD y) { return SD::of(fmod(x.v, y.v)); }

// torch.clamp semantics (NaN propagates)
template <typename T>
__device__ __forceinline__ T clamp_min(T x, T lo) { return x < lo ? lo : x; }
template <typename T>
__device__ __forceinline__ T clamp_max(T x, T hi) { return x > hi ? hi : x; }
template <typename T>
__device__ __forceinline__ T clamp(T x, T lo, T hi) {
  return clamp_max(clamp_min(x, lo), hi);
}
template <typename T>
__device__ __forceinline__ T sign(T x) {
  return T(double((x > T(0)) - (x < T(0))));
}

template <typename T> struct V3 { T x, y, z; };
template <typename T> struct Q4 { T w, x, y, z; };

template <typename T>
__device__ __forceinline__ V3<T> add(V3<T> a, V3<T> b) {
  return {a.x + b.x, a.y + b.y, a.z + b.z};
}
template <typename T>
__device__ __forceinline__ V3<T> sub(V3<T> a, V3<T> b) {
  return {a.x - b.x, a.y - b.y, a.z - b.z};
}
template <typename T>
__device__ __forceinline__ V3<T> scale(T s, V3<T> a) {
  return {s * a.x, s * a.y, s * a.z};
}
template <typename T>
__device__ __forceinline__ V3<T> neg(V3<T> a) { return {-a.x, -a.y, -a.z}; }
template <typename T>
__device__ __forceinline__ T dot(V3<T> a, V3<T> b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}
template <typename T>
__device__ __forceinline__ V3<T> cross(V3<T> a, V3<T> b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
template <typename T>
__device__ __forceinline__ T norm3(V3<T> v) {
  return Sqrt(v.x * v.x + v.y * v.y + v.z * v.z);
}

// ------------------------------------------------------------- quaternions
// flightjax/ops/quaternions.py

template <typename T>
__device__ __forceinline__ V3<T> qim(Q4<T> q) { return {q.x, q.y, q.z}; }

template <typename T>
__device__ __forceinline__ Q4<T> qmul(Q4<T> a, Q4<T> b) {
  V3<T> v1 = qim(a), v2 = qim(b), c = cross(v1, v2);
  return {a.w * b.w - dot(v1, v2),
          a.w * v2.x + b.w * v1.x + c.x,
          a.w * v2.y + b.w * v1.y + c.y,
          a.w * v2.z + b.w * v1.z + c.z};
}

template <typename T>
__device__ __forceinline__ Q4<T> qconj(Q4<T> q) { return {q.w, -q.x, -q.y, -q.z}; }

template <typename T>
__device__ __forceinline__ V3<T> qrot(Q4<T> q, V3<T> v) {
  V3<T> qi = qim(q);
  V3<T> t = add(scale(q.w, v), cross(qi, v));
  return add(v, scale(T(2.0), cross(qi, t)));
}

template <typename T>
__device__ __forceinline__ V3<T> qrot_inv(Q4<T> q, V3<T> v) {
  return qrot(qconj(q), v);
}

template <typename T>
__device__ __forceinline__ Q4<T> qdt(Q4<T> q, V3<T> w) {
  V3<T> v = qim(q), c = cross(v, w);
  const T h = T(0.5);
  return {T(-0.5) * dot(v, w), h * (q.w * w.x + c.x), h * (q.w * w.y + c.y),
          h * (q.w * w.z + c.z)};
}

template <typename T>
__device__ __forceinline__ Q4<T> qmul_zpre(T c2, T s2, Q4<T> q) {
  return {c2 * q.w - s2 * q.z, c2 * q.x - s2 * q.y, c2 * q.y + s2 * q.x,
          c2 * q.z + s2 * q.w};
}

template <typename T>
__device__ __forceinline__ Q4<T> qmul_zpost(Q4<T> q, T c2, T s2) {
  return {q.w * c2 - q.z * s2, q.x * c2 + q.y * s2, q.y * c2 - q.x * s2,
          q.z * c2 + q.w * s2};
}

template <typename T>
__device__ __forceinline__ V3<T> rot2_z(T c, T s, V3<T> v) {
  return {v.x * c - v.y * s, v.x * s + v.y * c, v.z};
}

template <typename T>
__device__ __forceinline__ V3<T> rot2_y(T c, T s, V3<T> v) {
  return {v.x * c + v.z * s, v.y, (-v.x) * s + v.z * c};
}

// ------------------------------------------------------------- 3x3 matrices

template <typename T>
struct M33 {
  T m[3][3];
};

template <typename T>
__device__ __forceinline__ M33<T> skew(V3<T> v) {
  return {{{T(0), -v.z, v.y}, {v.z, T(0), -v.x}, {-v.y, v.x, T(0)}}};
}

// (A B)_ij summed over k in order, as the broadcast-reduce `_mm`
template <typename T>
__device__ __forceinline__ M33<T> mm(const M33<T>& A_, const M33<T>& B_) {
  M33<T> r;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      r.m[i][j] = A_.m[i][0] * B_.m[0][j] + A_.m[i][1] * B_.m[1][j] +
                  A_.m[i][2] * B_.m[2][j];
  return r;
}

template <typename T>
__device__ __forceinline__ V3<T> mv(const M33<T>& M, V3<T> v) {
  return {M.m[0][0] * v.x + M.m[0][1] * v.y + M.m[0][2] * v.z,
          M.m[1][0] * v.x + M.m[1][1] * v.y + M.m[1][2] * v.z,
          M.m[2][0] * v.x + M.m[2][1] * v.y + M.m[2][2] * v.z};
}

// ------------------------------------------------------------- attitude
// flightjax/ops/attitude.py

template <typename T>
__device__ __forceinline__ void half_angle_cs(T c, T s, T& c2, T& s2) {
  const T a1 = Sqrt(clamp_min((T(1.0) + c) * T(0.5), T(1e-30)));
  const T a2 = Sqrt(clamp_min((T(1.0) - c) * T(0.5), T(1e-30)));
  if (c >= T(0)) {
    c2 = a1;
    s2 = s / (T(2.0) * a1);
  } else {
    c2 = Abs(s) / (T(2.0) * a2);
    s2 = s < T(0) ? -a2 : a2;
  }
}

template <typename T>
__device__ __forceinline__ V3<T> quat_to_euler(Q4<T> q) {
  const T q1 = q.w, q2 = q.x, q3 = q.y, q4 = q.z;
  const T psi = Atan2(T(2) * (q1 * q4 + q2 * q3),
                      T(1) - T(2) * (q3 * q3 + q4 * q4));
  const T theta = Asin(clamp(T(2) * (q1 * q3 - q2 * q4), T(-1.0), T(1.0)));
  const T phi = Atan2(T(2) * (q1 * q2 + q3 * q4),
                      T(1) - T(2) * (q2 * q2 + q3 * q3));
  return {psi, theta, phi};
}

template <typename T>
__device__ __forceinline__ Q4<T> rot_z(T psi) {
  return {Cos(T(0.5) * psi), T(0), T(0), Sin(T(0.5) * psi)};
}

// Shepperd's method with largest-candidate selection (the first on ties,
// as argmax) for the rotation matrix whose columns are c0, c1, c2
template <typename T>
__device__ __forceinline__ Q4<T> matrix_to_quat(V3<T> c0_, V3<T> c1_,
                                                V3<T> c2_) {
  const T R00 = c0_.x, R10 = c0_.y, R20 = c0_.z;
  const T R01 = c1_.x, R11 = c1_.y, R21 = c1_.z;
  const T R02 = c2_.x, R12 = c2_.y, R22 = c2_.z;
  const T tr = R00 + R11 + R22;
  const T c[4] = {T(1) + tr, T(1) + T(2) * R00 - tr, T(1) + T(2) * R11 - tr,
                  T(1) + T(2) * R22 - tr};
  int im = 0;
  T cm = c[0];  // the largest so far, so that no index is a run-time one
#pragma unroll
  for (int k = 1; k < 4; ++k)
    if (c[k] > cm) {
      cm = c[k];
      im = k;
    }
  Q4<T> v;
  if (im == 0)
    v = {c[0], R21 - R12, R02 - R20, R10 - R01};
  else if (im == 1)
    v = {R21 - R12, c[1], R01 + R10, R20 + R02};
  else if (im == 2)
    v = {R02 - R20, R01 + R10, c[2], R12 + R21};
  else
    v = {R10 - R01, R20 + R02, R12 + R21, c[3]};
  const T n = Sqrt(v.w * v.w + v.x * v.x + v.y * v.y + v.z * v.z);
  return {v.w / n, v.x / n, v.y / n, v.z / n};
}

// (alpha, beta) of an airflow velocity, gated to 0 below 0.1 m/s
// (physics/atmosphere.py::get_airflow_angles)
template <typename T>
__device__ __forceinline__ void airflow_angles(V3<T> v, T& alpha, T& beta) {
  const bool valid = norm3(v) >= T(0.1);
  alpha = valid ? Atan2(v.z, v.x) : T(0);
  beta = valid ? Atan2(v.y, Sqrt(v.x * v.x + v.z * v.z)) : T(0);
}

// ------------------------------------------------------------- tables

// Multilinear lookup on a rectilinear grid (the corner-gather path of
// ops/interp.py::Lookup) over a table encoded by parallel/kernels.py::
// encode_table: t[0] = number of axes, t[1] = outputs per knot, then per
// axis (n, line extrapolation?, uniform?, x0, dx), then each axis's knots,
// then the values in C order (axis 0 slowest, outputs fastest). Axes of one
// knot are ignored; 'flat' axes clamp the cell weight to [0, 1], 'line'
// axes let it run past the edge cells.
//
// The number of axes D is known at compile time (it must equal t[0];
// kernels.py::TABLE_RANKS states it per table; the query is x0..x2, of which
// the first D count),
// so every loop over axes and corners unrolls, the per-axis sizes, cell
// indices, strides and weights stay in registers, and the header reads do
// not depend on the query. The axis kind (uniform or searched, flat or
// line) is data and is read from the header. Cell, weights and the order
// of the corner sum (corner c takes the upper knot of axis a where bit a
// of c is set; c ascending) are those of the plain Lookup. One function per
// rank, not inlined: a stage calls it about twenty times. Query and result
// travel by value, in registers and not through the stack.
template <typename T, int NOUT>
struct LookupOut {
  T v[NOUT];
};

template <typename T, int D, int NOUT>
__device__ __noinline__ LookupOut<T, NOUT> lookup(const T* t, T x0, T x1,
                                                  T x2) {
  const T x[3] = {x0, x1, x2};
  LookupOut<T, NOUT> out;
  int n[D], idx[D], stride[D], first_knot[D];
  T w[D];
  int s = NOUT, n_knots = 0;
#pragma unroll
  for (int a = 0; a < D; ++a) {
    n[a] = int(t[2 + 5 * a].v);
    first_knot[a] = n_knots;
    n_knots += n[a];
  }
#pragma unroll
  for (int a = D - 1; a >= 0; --a) {
    stride[a] = s;
    s *= n[a];
  }
  const T* knots = t + 2 + 5 * D;
  const T* vals = knots + n_knots;
#pragma unroll
  for (int a = 0; a < D; ++a) {
    const T* h = t + 2 + 5 * a;
    const T* kn = knots + first_knot[a];
    const int na = n[a];
    idx[a] = 0;
    w[a] = T(0);
    if (na > 1) {
      int i;
      T wa;
      if (h[2].v != 0) {  // uniform: index by arithmetic
        const T f = Floor((x[a] - h[3]) / h[4]);
        i = f >= T(double(na - 2)) ? na - 2 : (f >= T(0) ? int(f.v) : 0);
        wa = (x[a] - h[3]) / h[4] - T(double(i));
      } else {  // searchsorted(right=True) - 1: the knots ascend, bisect
        int cnt = 0, hi = na;  // cnt: how many knots are <= x
        while (cnt < hi) {
          const int mid = (cnt + hi) >> 1;
          if (kn[mid] <= x[a])
            cnt = mid + 1;
          else
            hi = mid;
        }
        i = min(max(cnt - 1, 0), na - 2);
        wa = (x[a] - kn[i]) / (kn[i + 1] - kn[i]);
      }
      if (h[1].v == 0) wa = clamp(wa, T(0.0), T(1.0));
      idx[a] = i;
      w[a] = wa;
    }
  }
#pragma unroll
  for (int c = 0; c < (1 << D); ++c) {
    T wt = T(1.0);
    int off = 0;
    bool skip = false;
#pragma unroll
    for (int a = 0; a < D; ++a) {
      const int hi = (c >> a) & 1;
      if (n[a] == 1) {
        skip = skip || hi;
      } else {
        off += (idx[a] + hi) * stride[a];
        wt = wt * (hi ? w[a] : T(1.0) - w[a]);
      }
    }
    if (skip) continue;  // never corner 0, which so starts every sum
#pragma unroll
    for (int j = 0; j < NOUT; ++j) {
      const T v = vals[off + j] * wt;
      out.v[j] = c == 0 ? v : out.v[j] + v;
    }
  }
  return out;
}

// ------------------------------------------------------------- geodesy
// flightjax/ops/geodesy.py

template <typename T>
__device__ __forceinline__ V3<T> nvector_from_qew(Q4<T> q) {
  const T dq12 = T(2) * q.w * q.x, dq13 = T(2) * q.w * q.y;
  const T dq24 = T(2) * q.x * q.z, dq34 = T(2) * q.y * q.z;
  return {-(dq24 + dq13), -(dq34 - dq12),
          -(T(1) - T(2) * (q.x * q.x + q.y * q.y))};
}

template <typename T>
__device__ __forceinline__ void get_psi_nw_ab(Q4<T> q, T& A_, T& B_) {
  const T dq12 = T(2) * q.w * q.x, dq13 = T(2) * q.w * q.y;
  const T dq24 = T(2) * q.x * q.z, dq34 = T(2) * q.y * q.z;
  A_ = -(dq34 + dq12);
  B_ = dq24 - dq13;
}

template <typename T>
__device__ __forceinline__ void radii(V3<T> n_e, T& M, T& N) {
  const T den = Sqrt(T(1) - T(E2) * (n_e.z * n_e.z));
  M = T(A * (1.0 - E2)) / (den * den * den);
  N = T(A) / den;
}

template <typename T>
__device__ __forceinline__ V3<T> cartesian_from_geographic(V3<T> n_e, T h) {
  T M, N;
  radii(n_e, M, N);
  return {(N + h) * n_e.x, (N + h) * n_e.y, (N * T(1.0 - E2) + h) * n_e.z};
}

template <typename T>
__device__ __forceinline__ void geographic_from_cartesian(V3<T> r, V3<T>& n_e,
                                                          T& h) {
  const T inv_a = T(1.0 / A);
  const T x = r.x * inv_a, y = r.y * inv_a, z = r.z * inv_a;
  const T p = Sqrt(x * x + y * y);
  const T c = T(E2);
  const T ec2 = T(1.0 - E2);
  const T ec = T(sqrt(1.0 - E2));
  const T zc = ec * Abs(z);
  const T s0 = Abs(z);
  const T c0 = ec * p;
  const T a0 = Sqrt(s0 * s0 + c0 * c0);
  const T a03 = a0 * (a0 * a0);
  const T b0 = T(1.5 * E2) * s0 * c0 * ((p * s0 - zc * c0) * a0 - c * s0 * c0);
  const T s1 = (zc * a03 + c * (s0 * (s0 * s0))) * a03 - b0 * s0;
  const T c1 = (p * a03 - c * (c0 * (c0 * c0))) * a03 - b0 * c0;
  const T cc = ec * c1;
  const T s1sq = s1 * s1;
  const T ccsq = cc * cc;
  h = T(A) * (p * cc + s0 * s1 - Sqrt(ec2 * s1sq + ccsq)) / Sqrt(s1sq + ccsq);

  const T safe_cc = cc != T(0) ? cc : T(1);
  const T abs_tan = s1 / safe_cc;
  const T cos_lo = T(1.0) / Sqrt(T(1) + abs_tan * abs_tan);
  const T sin_lo = abs_tan * cos_lo * sign(z);
  const T safe_s1 = s1 != T(0) ? s1 : T(1);
  const T abs_cot = cc / safe_s1;
  const T abs_sin_hi = T(1.0) / Sqrt(T(1) + abs_cot * abs_cot);
  const T cos_hi = abs_cot * abs_sin_hi;
  const T sin_hi = abs_sin_hi * sign(z);
  const bool lo = s1 < cc;
  const T cos_lat = lo ? cos_lo : cos_hi;
  const T sin_lat = lo ? sin_lo : sin_hi;
  const bool pos = p > T(0);
  const T p_safe = pos ? p : T(1);
  const T cos_lon = pos ? x / p_safe : T(1);
  const T sin_lon = pos ? y / p_safe : T(0);
  n_e = {cos_lat * cos_lon, cos_lat * sin_lon, sin_lat};
}

template <typename T>
__device__ __forceinline__ T gravity(V3<T> n_e, T h) {
  const T sin2 = n_e.z * n_e.z;
  const T g0 = T(G_A) * (T(1) + T(K_G) * sin2) / Sqrt(T(1) - T(E2) * sin2);
  return g0 * (T(1) - T(2.0 / A) * (T(1.0 + F + M_G) - T(2.0 * F) * sin2) * h +
               T(3.0 / A2) * h * h);
}

// ------------------------------------------------------------- atmosphere
// flightjax/physics/atmosphere.py

// With SKIP_ABOVE, a layer above the first is skipped where its dh is 0,
// that is in every layer above the aircraft: its library call then changes
// nothing, bit for bit. Tk there is finite and positive or NaN (T_sl is
// clamped to 238.15-338.15 K, so the layers keep it above 160 K), and if it
// is NaN the first layer has already made p NaN. So beta / Tk * 0 is +-0,
// 1 + (+-0) = 1, pow(1, y) = 1 and exp(+-0) = 1 exactly, p * 1 = p and
// Tk + beta * 0 = Tk. A NaN height gives a NaN dh, which is not 0, so the
// layer runs. The first layer always runs: at dh = 0 it is what carries a
// NaN T_sl into p.
template <bool SKIP_ABOVE = false, typename T>
__device__ __forceinline__ void isa_data(T h, T T_sl, T p_sl, T& Tk, T& p) {
  // (lapse rate [K/m], ceiling geopotential altitude [m]) per layer
  constexpr double isa_beta[7] = {-6.5e-3, 0.0, 1e-3, 2.8e-3, 0.0, -2.8e-3,
                                  -2e-3};
  constexpr double isa_ceil[7] = {11000.0, 20000.0, 32000.0, 47000.0,
                                  51000.0, 71000.0, 84852.0};
  Tk = T_sl;
  p = p_sl;
  double h_base = 0.0;
#pragma unroll
  for (int i = 0; i < 7; ++i) {
    const double beta = isa_beta[i], h_ceil = isa_ceil[i];
    const T dh = (i == 0) ? clamp_max(h, T(h_ceil)) - T(h_base)
                          : clamp(h, T(h_base), T(h_ceil)) - T(h_base);
    if (!(SKIP_ABOVE && i > 0 && dh == T(0))) {
      if (beta != 0.0) {
        const T T_new = Tk + T(beta) * dh;
        p = p * Pow(T(1) + T(beta) / Tk * dh, T(-G_STD / (beta * R_GAS)));
        Tk = T_new;
      } else {
        p = p * Exp(T(-G_STD) / (T(R_GAS) * Tk) * dh);
      }
    }
    h_base = h_ceil;
  }
}

// ------------------------------------------------------------- kinematics
// flightjax/physics/kinematics.py (WA, _kin_data_common, _normalize_block)

template <typename T>
struct Kin {
  V3<T> e_nb;
  Q4<T> q_nb, q_eb, q_en;
  T lat, lon;
  V3<T> n_e;
  T h_e, h_o;
  V3<T> r_eb_e, omega_wb_b, omega_eb_b, v_eb_b, v_eb_n;
  T v_gnd, chi, gamma;
};

// the kinematic state (and its derivative) of the WA mechanization
template <typename T>
struct XKin {
  Q4<T> q_wb, q_ew;
  T h_e;
};

// WA f_ode: derivative and KinData at (q_wb, q_ew, h_e, omega, v, geoid_N)
template <typename T>
__device__ __forceinline__ void wa_f_ode(Q4<T> q_wb, Q4<T> q_ew, T h_e,
                                         V3<T> omega_eb_b, V3<T> v_eb_b,
                                         T geoid_N, XKin<T>& xd, Kin<T>& k) {
  T A_, B_;
  get_psi_nw_ab(q_ew, A_, B_);
  const T n2 = A_ * A_ + B_ * B_;
  const bool ok = n2 > T(0);
  const T hinv = Rsqrt(clamp_min(n2, T(1e-30)));
  const T cpsi = ok ? B_ * hinv : T(1);
  const T spsi = ok ? A_ * hinv : T(0);
  T c2, s2;
  half_angle_cs(cpsi, spsi, c2, s2);

  const Q4<T> q_nb = qmul_zpre(c2, s2, q_wb);
  const Q4<T> q_eb = qmul(q_ew, q_wb);
  const Q4<T> q_en = qmul_zpost(q_ew, c2, -s2);
  const V3<T> n_e = nvector_from_qew(q_ew);
  const V3<T> v_eb_n = qrot(q_nb, v_eb_b);
  T R_N, R_E;
  radii(n_e, R_N, R_E);
  const V3<T> omega_ew_n = {v_eb_n.y / (R_E + h_e), -v_eb_n.x / (R_N + h_e),
                            T(0)};
  const V3<T> omega_ew_w = rot2_z(cpsi, -spsi, omega_ew_n);
  const V3<T> omega_ew_b = qrot_inv(q_wb, omega_ew_w);
  const V3<T> omega_wb_b = sub(omega_eb_b, omega_ew_b);

  xd.q_wb = qdt(q_wb, omega_wb_b);
  xd.q_ew = qdt(q_ew, omega_ew_w);
  xd.h_e = -v_eb_n.z;

  k.lat = Atan2(n_e.z, Sqrt(n_e.x * n_e.x + n_e.y * n_e.y));
  k.lon = Atan2(n_e.y, n_e.x);
  k.h_o = h_e - geoid_N;
  k.r_eb_e = cartesian_from_geographic(n_e, h_e);
  k.v_gnd = norm3(v_eb_n);
  const bool valid = k.v_gnd > T(V_MIN_CHI_GAMMA);
  k.chi = valid ? Atan2(v_eb_n.y, v_eb_n.x) : T(0);
  k.gamma = valid ? Atan2(-v_eb_n.z, Sqrt(v_eb_n.x * v_eb_n.x +
                                          v_eb_n.y * v_eb_n.y))
                  : T(0);
  k.e_nb = quat_to_euler(q_nb);
  k.q_nb = q_nb;
  k.q_eb = q_eb;
  k.q_en = q_en;
  k.n_e = n_e;
  k.h_e = h_e;
  k.omega_wb_b = omega_wb_b;
  k.omega_eb_b = omega_eb_b;
  k.v_eb_b = v_eb_b;
  k.v_eb_n = v_eb_n;
}

// renormalise only when drifted beyond the dtype's gate: 32 ulp in float,
// the reference's 1e-8 in double (kinematics.py:148-161)
template <typename T>
__device__ __forceinline__ Q4<T> normalize_block(Q4<T> q) {
  const T eps = sizeof(T) == 4 ? T(32.0 * 1.1920928955078125e-07) : T(1e-8);
  const T n = Sqrt(q.w * q.w + q.x * q.x + q.y * q.y + q.z * q.z);
  if (Abs(n - T(1.0)) > eps) return {q.w / n, q.x / n, q.y / n, q.z / n};
  return q;
}

// ------------------------------------------------------------- air data

template <typename T>
struct Air {
  V3<T> v_ew_n, v_ew_b, v_wb_b;
  T Tk, p, rho, a, mu, M, Tt, pt, Dp, q, TAS, EAS, CAS;
};

// SimpleAtmosphere.atmospheric_data + air_data (no gust field); it reads
// h_o, q_nb and v_eb_b of k. SKIP_ABOVE: that of isa_data
template <bool SKIP_ABOVE = false, typename T>
__device__ __forceinline__ Air<T> atm_air(const Kin<T>& k, T T_sl, T p_sl,
                                          V3<T> wind) {
  Air<T> o;
  T_sl = clamp(T_sl, T(T_SL_MIN), T(T_SL_MAX));
  p_sl = clamp(p_sl, T(P_SL_MIN), T(P_SL_MAX));
  const T h_geop = k.h_o * T(A) / (T(A) + k.h_o);
  isa_data<SKIP_ABOVE>(h_geop, T_sl, p_sl, o.Tk, o.p);
  o.rho = o.p / (T(R_GAS) * o.Tk);
  o.a = Sqrt(T(GAMMA * R_GAS) * o.Tk);
  o.mu = (T(BETA_S) * Pow(o.Tk, T(1.5))) / (o.Tk + T(S_SUTH));
  o.v_ew_n = wind;
  o.v_ew_b = qrot_inv(k.q_nb, wind);
  o.v_wb_b = sub(k.v_eb_b, o.v_ew_b);
  o.TAS = norm3(o.v_wb_b);
  o.M = o.TAS / o.a;
  o.Tt = o.Tk * (T(1) + T((GAMMA - 1.0) / 2.0) * (o.M * o.M));
  o.pt = o.p * Pow(o.Tt / o.Tk, T(GAMMA / (GAMMA - 1.0)));
  o.Dp = o.pt - o.p;
  o.q = T(0.5) * o.rho * (o.TAS * o.TAS);
  o.EAS = o.TAS * Sqrt(o.rho / T(RHO_STD));
  o.CAS = Sqrt(T(2.0 * GAMMA / (GAMMA - 1.0) * P_STD / RHO_STD) *
               (Pow(T(1) + o.Dp / T(P_STD), T((GAMMA - 1.0) / GAMMA)) - T(1)));
  return o;
}

// ------------------------------------------------------------- lanes
// The per-aircraft bodies of the cluster kernels, on register structs. The
// cluster kernels load a lane's rows, call one of these and store; the
// whole-step kernels (rk4_stage, rk4_finish, megakernel) chain them with
// the KinData and AirData kept in registers.

template <typename T>
struct XDyn {
  V3<T> omega_eb_b, v_eb_b;
};

template <typename T>
struct AtmU {
  T T_sl, p_sl;
  V3<T> wind;
};

// mass properties: m, J about the body origin, CoM position r
template <typename T>
struct MP {
  T m;
  M33<T> J;
  V3<T> r;
};

// x + a k, leaf by leaf, as the plain stage FMA and RK4 combine form it
template <typename T>
__device__ __forceinline__ Q4<T> axpy(Q4<T> x, T a, Q4<T> k) {
  return {x.w + a * k.w, x.x + a * k.x, x.y + a * k.y, x.z + a * k.z};
}
template <typename T>
__device__ __forceinline__ XKin<T> axpy(const XKin<T>& x, T a,
                                        const XKin<T>& k) {
  return {axpy(x.q_wb, a, k.q_wb), axpy(x.q_ew, a, k.q_ew), x.h_e + a * k.h_e};
}
template <typename T>
__device__ __forceinline__ XDyn<T> axpy(const XDyn<T>& x, T a,
                                        const XDyn<T>& k) {
  return {add(x.omega_eb_b, scale(a, k.omega_eb_b)),
          add(x.v_eb_b, scale(a, k.v_eb_b))};
}
template <typename T>
__device__ __forceinline__ Q4<T> scale(T a, Q4<T> q) {
  return {a * q.w, a * q.x, a * q.y, a * q.z};
}
template <typename T>
__device__ __forceinline__ XKin<T> scale(T a, const XKin<T>& x) {
  return {scale(a, x.q_wb), scale(a, x.q_ew), a * x.h_e};
}
template <typename T>
__device__ __forceinline__ XDyn<T> scale(T a, const XDyn<T>& x) {
  return {scale(a, x.omega_eb_b), scale(a, x.v_eb_b)};
}

// k1_lane at the stage state: WA f_ode (derivative x alive, KinData), the
// ISA atmosphere with wind and the air data
template <typename T>
__device__ __forceinline__ void kinair_lane(const XKin<T>& xi,
                                            const XDyn<T>& xi_dyn, T geoid_N,
                                            const AtmU<T>& u, T alive,
                                            XKin<T>& kin_dot, Kin<T>& k,
                                            Air<T>& air) {
  XKin<T> d;
  wa_f_ode(xi.q_wb, xi.q_ew, xi.h_e, xi_dyn.omega_eb_b, xi_dyn.v_eb_b, geoid_N,
           d, k);
  air = atm_air(k, u.T_sl, u.p_sl, u.wind);
  kin_dot = scale(alive, d);
}

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

// k3_lane: Newton-Euler at the CoM from the summed mass properties, wrench
// and rotor momentum ho; derivative x alive
template <typename T>
__device__ __forceinline__ XDyn<T> dynamics_lane(const XDyn<T>& xi,
                                                 const MP<T>& mp, V3<T> F_b,
                                                 V3<T> tau_b, V3<T> ho,
                                                 Q4<T> q_eb, V3<T> r_eb_e,
                                                 T alive) {
  const V3<T> omega_eb_b = xi.omega_eb_b, v_eb_b = xi.v_eb_b;
  const T m = mp.m;
  const M33<T>& J = mp.J;
  const V3<T> r_OG = mp.r;

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
  return {scale(alive, omega_dot), scale(alive, v_dot_eb_b)};
}

// Neumaier two-sum: x + incr with the residual c carried across steps
// (flightjax/core/sim.py:158-180)
template <typename T>
__device__ __forceinline__ T comp_add(T x, T incr, T& c) {
  const T y = incr + c;
  const T s = x + y;
  c = Abs(x) >= Abs(y) ? (x - s) + y : (y - s) + x;
  return s;
}

// normalize_block as one real function, for a kernel whose warps each
// renormalise (finish_kin): inlined in every warp's code (49,792 code bytes
// against 41,472), the square roots and divisions made it 0.4-0.5 us slower
// (PERF.md)
template <typename T>
static __device__ __noinline__ Q4<T> normalize_block_call(Q4<T> q) {
  return normalize_block(q);
}

// the RK4 combine x + c6 ksum of k4_lane (compensated on q_ew and h_e with
// the residuals r_q, r_h when `comp`) and the WA renormalisation, with
// RENORM_CALL through normalize_block_call
template <bool RENORM_CALL = false, typename T>
__device__ __forceinline__ void finish_kin_combine(
    const XKin<T>& x, const XDyn<T>& x_dyn, const XKin<T>& ks,
    const XDyn<T>& ks_dyn, T c6, bool comp, Q4<T>& r_q, T& r_h, XKin<T>& xo,
    XDyn<T>& xo_dyn) {
  const Q4<T> nq_wb = axpy(x.q_wb, c6, ks.q_wb);
  Q4<T> nq_ew;
  T nh_e;
  if (comp) {
    nq_ew = {comp_add(x.q_ew.w, c6 * ks.q_ew.w, r_q.w),
             comp_add(x.q_ew.x, c6 * ks.q_ew.x, r_q.x),
             comp_add(x.q_ew.y, c6 * ks.q_ew.y, r_q.y),
             comp_add(x.q_ew.z, c6 * ks.q_ew.z, r_q.z)};
    nh_e = comp_add(x.h_e, c6 * ks.h_e, r_h);
  } else {
    nq_ew = axpy(x.q_ew, c6, ks.q_ew);
    nh_e = x.h_e + c6 * ks.h_e;
  }
  xo_dyn = axpy(x_dyn, c6, ks_dyn);
  if (RENORM_CALL)
    xo = {normalize_block_call(nq_wb), normalize_block_call(nq_ew), nh_e};
  else
    xo = {normalize_block(nq_wb), normalize_block(nq_ew), nh_e};
}

// k4_lane + comp_add: finish_kin_combine, then KinData and AirData at the
// new state
template <typename T>
__device__ __forceinline__ void finish_kin_lane(
    const XKin<T>& x, const XDyn<T>& x_dyn, const XKin<T>& ks,
    const XDyn<T>& ks_dyn, T c6, bool comp, Q4<T>& r_q, T& r_h, T geoid_N,
    const AtmU<T>& u, XKin<T>& xo, XDyn<T>& xo_dyn, Kin<T>& k, Air<T>& air) {
  finish_kin_combine(x, x_dyn, ks, ks_dyn, c6, comp, r_q, r_h, xo, xo_dyn);
  XKin<T> d;
  wa_f_ode(xo.q_wb, xo.q_ew, xo.h_e, xo_dyn.omega_eb_b, xo_dyn.v_eb_b,
           geoid_N, d, k);
  air = atm_air(k, u.T_sl, u.p_sl, u.wind);
}

// EGM96 undulation at the n-vector n_e (ops/geodesy.py::Geoid.height over
// ops/interp.py::RowLookup): lat/lon of n_e, lon wrapped into [0, 2 pi) as
// torch.remainder wraps it, then bilinear on the uniform grid G (the
// [n_lat + 1, n_lon] buffer above) with the cell index and weights formed as
// RowLookup forms them, flat at the edges
template <typename T>
__device__ __forceinline__ T geoid_height(const T* G, V3<T> n_e) {
  const T lat = Atan2(n_e.z, Sqrt(n_e.x * n_e.x + n_e.y * n_e.y));
  const T two_pi = T(2.0 * PI);
  T lon = Fmod(Atan2(n_e.y, n_e.x) + two_pi, two_pi);
  if (lon < T(0)) lon = lon + two_pi;
  const int n0 = int(G[0].v), n1 = int(G[1].v);
  const T x0 = G[2], d0 = G[3], y0 = G[4], d1 = G[5];
  const T* V = G + n1;
  const T f0 = (lat - x0) / d0;
  const int i0 = min(max(int(Floor(f0).v), 0), n0 - 2);
  const T w0 = clamp(f0 - T(double(i0)), T(0.0), T(1.0));
  const T t1 = clamp((lon - y0) / d1, T(0.0), T(n1 - 1.0));
  const int i1 = min(max(int(Floor(t1).v), 0), n1 - 2);
  const T w1 = t1 - T(double(i1));
  const T* ra = V + i0 * n1 + i1;
  const T* rb = ra + n1;
  const T row_a = ra[0] * (T(1.0) - w0) + rb[0] * w0;
  const T row_b = ra[1] * (T(1.0) - w0) + rb[1] * w0;
  return row_a * (T(1.0) - w1) + row_b * w1;
}

// ------------------------------------------------------------- buffers

template <typename T>
struct Col {
  const T* buf;
  int B, b;
  __device__ __forceinline__ T operator()(int r) const { return buf[r * B + b]; }
  __device__ __forceinline__ V3<T> v3(int r) const {
    return {(*this)(r), (*this)(r + 1), (*this)(r + 2)};
  }
  __device__ __forceinline__ Q4<T> q4(int r) const {
    return {(*this)(r), (*this)(r + 1), (*this)(r + 2), (*this)(r + 3)};
  }
};

template <typename T>
struct Out {
  T* buf;
  int B, b;
  __device__ __forceinline__ void s(int r, T v) const { buf[r * B + b] = v; }
  __device__ __forceinline__ void v3(int r, V3<T> v) const {
    s(r, v.x); s(r + 1, v.y); s(r + 2, v.z);
  }
  __device__ __forceinline__ void q4(int r, Q4<T> q) const {
    s(r, q.w); s(r + 1, q.x); s(r + 2, q.y); s(r + 3, q.z);
  }
};

// KinData rows starting at r (N_KIN rows)
template <typename T>
__device__ __forceinline__ void store_kin(const Out<T>& o, int r, const Kin<T>& k) {
  o.v3(r + KR_E_NB, k.e_nb);
  o.q4(r + KR_Q_NB, k.q_nb);
  o.q4(r + KR_Q_EB, k.q_eb);
  o.q4(r + KR_Q_EN, k.q_en);
  o.s(r + KR_LAT, k.lat);
  o.s(r + KR_LON, k.lon);
  o.v3(r + KR_N_E, k.n_e);
  o.s(r + KR_H_E, k.h_e);
  o.s(r + KR_H_O, k.h_o);
  o.v3(r + KR_R_EB_E, k.r_eb_e);
  o.v3(r + KR_OM_WB, k.omega_wb_b);
  o.v3(r + KR_OM_EB, k.omega_eb_b);
  o.v3(r + KR_V_EB_B, k.v_eb_b);
  o.v3(r + KR_V_EB_N, k.v_eb_n);
  o.s(r + KR_V_GND, k.v_gnd);
  o.s(r + KR_CHI, k.chi);
  o.s(r + KR_GAMMA, k.gamma);
}

// the KinData rows that take no library call, starting at r (role KD of
// kinair and finish_kin)
template <typename T>
__device__ __forceinline__ void store_kin_direct(const Out<T>& o, int r,
                                                 const Kin<T>& k) {
  o.q4(r + KR_Q_NB, k.q_nb);
  o.q4(r + KR_Q_EB, k.q_eb);
  o.q4(r + KR_Q_EN, k.q_en);
  o.v3(r + KR_N_E, k.n_e);
  o.s(r + KR_H_E, k.h_e);
  o.s(r + KR_H_O, k.h_o);
  o.v3(r + KR_R_EB_E, k.r_eb_e);
  o.v3(r + KR_OM_WB, k.omega_wb_b);
  o.v3(r + KR_OM_EB, k.omega_eb_b);
  o.v3(r + KR_V_EB_B, k.v_eb_b);
  o.v3(r + KR_V_EB_N, k.v_eb_n);
  o.s(r + KR_V_GND, k.v_gnd);
}

// the KinData angles lat, lon, chi and gamma (four atan2), KinData rows
// starting at r (role ANG)
template <typename T>
__device__ __forceinline__ void store_kin_angles(const Out<T>& o, int r,
                                                 const Kin<T>& k) {
  o.s(r + KR_LAT, k.lat);
  o.s(r + KR_LON, k.lon);
  o.s(r + KR_CHI, k.chi);
  o.s(r + KR_GAMMA, k.gamma);
}

// AirData rows starting at r (N_AIR rows)
template <typename T>
__device__ __forceinline__ void store_air(const Out<T>& o, int r, const Air<T>& a) {
  o.v3(r + 0, a.v_ew_n);
  o.v3(r + 3, a.v_ew_b);
  o.v3(r + 6, a.v_wb_b);
  o.s(r + 9, a.Tk);
  o.s(r + 10, a.p);
  o.s(r + 11, a.rho);
  o.s(r + 12, a.a);
  o.s(r + 13, a.mu);
  o.s(r + 14, a.M);
  o.s(r + 15, a.Tt);
  o.s(r + 16, a.pt);
  o.s(r + 17, a.Dp);
  o.s(r + 18, a.q);
  o.s(r + 19, a.TAS);
  o.s(r + 20, a.EAS);
  o.s(r + 21, a.CAS);
}

// KinData / AirData read back from rows starting at r (the layouts above)
template <typename T>
__device__ __forceinline__ Kin<T> load_kin(const Col<T>& c, int r) {
  Kin<T> k;
  k.e_nb = c.v3(r + KR_E_NB);
  k.q_nb = c.q4(r + KR_Q_NB);
  k.q_eb = c.q4(r + KR_Q_EB);
  k.q_en = c.q4(r + KR_Q_EN);
  k.lat = c(r + KR_LAT);
  k.lon = c(r + KR_LON);
  k.n_e = c.v3(r + KR_N_E);
  k.h_e = c(r + KR_H_E);
  k.h_o = c(r + KR_H_O);
  k.r_eb_e = c.v3(r + KR_R_EB_E);
  k.omega_wb_b = c.v3(r + KR_OM_WB);
  k.omega_eb_b = c.v3(r + KR_OM_EB);
  k.v_eb_b = c.v3(r + KR_V_EB_B);
  k.v_eb_n = c.v3(r + KR_V_EB_N);
  k.v_gnd = c(r + KR_V_GND);
  k.chi = c(r + KR_CHI);
  k.gamma = c(r + KR_GAMMA);
  return k;
}

template <typename T>
__device__ __forceinline__ Air<T> load_air(const Col<T>& c, int r) {
  Air<T> a;
  a.v_ew_n = c.v3(r + 0);
  a.v_ew_b = c.v3(r + 3);
  a.v_wb_b = c.v3(r + 6);
  a.Tk = c(r + 9);
  a.p = c(r + 10);
  a.rho = c(r + 11);
  a.a = c(r + 12);
  a.mu = c(r + 13);
  a.M = c(r + 14);
  a.Tt = c(r + 15);
  a.pt = c(r + 16);
  a.Dp = c(r + 17);
  a.q = c(r + 18);
  a.TAS = c(r + 19);
  a.EAS = c(r + 20);
  a.CAS = c(r + 21);
  return a;
}

// x_kin (N_XKIN rows), x_dyn (N_XDYN rows), u_atm (N_UATM rows) at row r
template <typename T>
__device__ __forceinline__ XKin<T> load_xkin(const Col<T>& c, int r) {
  return {c.q4(r), c.q4(r + 4), c(r + 8)};
}
template <typename T>
__device__ __forceinline__ XDyn<T> load_xdyn(const Col<T>& c, int r) {
  return {c.v3(r), c.v3(r + 3)};
}
template <typename T>
__device__ __forceinline__ AtmU<T> load_atm(const Col<T>& c, int r) {
  return {c(r), c(r + 1), c.v3(r + 2)};
}
template <typename T>
__device__ __forceinline__ void store_xkin(const Out<T>& o, int r,
                                           const XKin<T>& x) {
  o.q4(r, x.q_wb);
  o.q4(r + 4, x.q_ew);
  o.s(r + 8, x.h_e);
}
template <typename T>
__device__ __forceinline__ void store_xdyn(const Out<T>& o, int r,
                                           const XDyn<T>& x) {
  o.v3(r, x.omega_eb_b);
  o.v3(r + 3, x.v_eb_b);
}

// ------------------------------------------------------------- roles
// A kernel may carry one aircraft in several threads: a block of L
// neighbouring aircraft (lanes) runs n_roles groups of L threads, L a
// multiple of the warp, so that every warp runs one role for 32
// neighbouring aircraft: thread = role * L + lane. kinair does so with the
// roles below, the C172 kernels with the subsystem roles of
// c172_systems.cuh.

constexpr int MAX_LANES = 64;  // aircraft per block, at most

// a thread of the role layout: its lane and role, the aircraft it carries
// (the last one again past a ragged edge, so every thread reaches every
// barrier; `valid` masks the stores)
struct RoleThread {
  int L, lane, role, b;
  bool valid;
};

__device__ __forceinline__ RoleThread role_thread(int B, int n_roles) {
  RoleThread t;
  t.L = blockDim.x / n_roles;
  t.lane = threadIdx.x % t.L;
  t.role = threadIdx.x / t.L;
  const int b = blockIdx.x * t.L + t.lane;
  t.valid = b < B;
  t.b = t.valid ? b : B - 1;
  return t;
}

// grid, threads per block and dynamic shared bytes of a launch of B
// aircraft at `lanes` per block
struct RoleLaunch {
  int grid, block, shared;
};
inline RoleLaunch role_launch(int B, int lanes, int n_roles, int shared) {
  return {(B + lanes - 1) / lanes, n_roles * lanes, shared};
}
inline void put_launch(const RoleLaunch& l, int* grid, int* block,
                       int* shared) {
  *grid = l.grid;
  *block = l.block;
  *shared = l.shared;
}

// ------------------------------------------------------------- kinair roles
// kinair carries each aircraft in several threads. Every role owns a fixed
// set of the kernel's output rows and computes only the chain those rows
// need, from the kernel's inputs, with the operations of kinair_lane in
// their order: so each row is bit-identical to what the one-thread form
// stores, and no role waits for another. The roles call wa_f_ode and
// atm_air whole and store their own rows; the compiler drops what a role
// does not store, the math-library calls included (they read and write no
// memory). The one-thread form made 17 library calls in a row; now a warp
// makes at most four (AIR below 11 km, ANG).

// rows of kinair's output (kin_dot, KinData, AirData, xi_dyn)
constexpr int KO_DOT = 0, KO_KIN = N_XKIN, KO_AIR = KO_KIN + N_KIN,
              KO_XDYN = KO_AIR + N_AIR;
// kinair's roles and the warp of each 32 aircraft that runs it:
//   KA_KD   the stage state, the WA derivative (x alive), xi_dyn and the
//           KinData rows that take no library call
//   KA_ANG  lat, lon, chi and gamma: four atan2
//   KA_EUL  e_nb: two atan2 and an asin
//   KA_AIR  the ISA atmosphere (the layers above the aircraft skipped) and
//           every AirData row
// EUL runs in KD's warp: three warps measured faster than four, and EUL in
// ANG's warp no faster and in AIR's slower (PERF.md, measured with
// tools/ablate_torch_roles.py)
constexpr int KA_KD = 0, KA_ANG = 1, KA_EUL = 0, KA_AIR = 2, KA_ROLES = 3;

// the stage state of kinair's column c and wa_f_ode there (`k1_lane`)
template <typename T>
__device__ __forceinline__ void kinair_stage(const Col<T>& c, T adt,
                                             XDyn<T>& xi_dyn, XKin<T>& d,
                                             Kin<T>& k) {
  const XKin<T> xi = axpy(load_xkin(c, 0), adt, load_xkin(c, 15));
  xi_dyn = axpy(load_xdyn(c, 9), adt, load_xdyn(c, 24));
  wa_f_ode(xi.q_wb, xi.q_ew, xi.h_e, xi_dyn.omega_eb_b, xi_dyn.v_eb_b, c(30),
           d, k);
}

// role `role` of kinair for the aircraft of column c: each branch works out
// the stage for itself, so that what it does not store is dead in it; the
// roles that share a warp (KD, EUL) run their branches one after the other
template <typename T>
__device__ __forceinline__ void kinair_role(int role, const Col<T>& c, T adt,
                                            const Out<T>& o) {
  XDyn<T> xi_dyn;
  XKin<T> d;
  Kin<T> k;
  if (role == KA_KD) {
    kinair_stage(c, adt, xi_dyn, d, k);
    store_xkin(o, KO_DOT, scale(T(1.0) - c(36), d));
    store_kin_direct(o, KO_KIN, k);
    store_xdyn(o, KO_XDYN, xi_dyn);
  }
  if (role == KA_ANG) {
    kinair_stage(c, adt, xi_dyn, d, k);
    store_kin_angles(o, KO_KIN, k);
  }
  if (role == KA_EUL) {
    kinair_stage(c, adt, xi_dyn, d, k);
    o.v3(KO_KIN + KR_E_NB, k.e_nb);
  }
  if (role == KA_AIR) {
    kinair_stage(c, adt, xi_dyn, d, k);
    const AtmU<T> u = load_atm(c, 31);
    store_air(o, KO_AIR, atm_air<true>(k, u.T_sl, u.p_sl, u.wind));
  }
}

// ------------------------------------------------------------- finish_kin roles
// finish_kin carries each aircraft in kinair's warps, with kinair's roles
// (KA_KD and KA_EUL in one warp, KA_ANG, KA_AIR) and the same rule: each
// role owns a fixed set of output rows and works out, from the inputs, the
// chain those rows need. The prefix every role runs is the finish's: the
// RK4 combine (with the compensated add when the residuals are carried) and
// the renormalisation (one called copy, normalize_block_call), then
// wa_f_ode at the new state. Role KD stores the
// new x_kin and x_dyn, the KinData rows that take no library call and the
// residuals; ANG the four angles, EUL e_nb, AIR the AirData (the ISA layers
// above the aircraft skipped, as in kinair). No barrier.

// rows of finish_kin's output (x_kin, x_dyn, KinData, AirData, residuals)
constexpr int FK_XKIN = 0, FK_XDYN = N_XKIN, FK_KIN = FK_XDYN + N_XDYN,
              FK_AIR = FK_KIN + N_KIN, FK_C = FK_AIR + N_AIR;

// the new state of finish_kin's column c (`k4_lane` + `comp_add`, the
// residuals 0 unless `comp`) and wa_f_ode there
template <typename T>
__device__ __forceinline__ void finish_kin_state(const Col<T>& c, T c6,
                                                 bool comp, XKin<T>& x,
                                                 XDyn<T>& x_dyn, Q4<T>& r_q,
                                                 T& r_h, Kin<T>& k) {
  r_q = {T(0), T(0), T(0), T(0)};
  r_h = T(0);
  if (comp) {
    r_q = c.q4(36);
    r_h = c(40);
  }
  finish_kin_combine<true>(load_xkin(c, 0), load_xdyn(c, 9),
                           load_xkin(c, 15), load_xdyn(c, 24), c6, comp, r_q,
                           r_h, x, x_dyn);
  XKin<T> d;
  wa_f_ode(x.q_wb, x.q_ew, x.h_e, x_dyn.omega_eb_b, x_dyn.v_eb_b, c(30), d,
           k);
}

// role `role` of finish_kin for the aircraft of column c, as kinair_role
template <typename T>
__device__ __forceinline__ void finish_kin_role(int role, const Col<T>& c,
                                                T c6, bool comp,
                                                const Out<T>& o) {
  XKin<T> x;
  XDyn<T> x_dyn;
  Q4<T> r_q;
  T r_h;
  Kin<T> k;
  if (role == KA_KD) {
    finish_kin_state(c, c6, comp, x, x_dyn, r_q, r_h, k);
    store_xkin(o, FK_XKIN, x);
    store_xdyn(o, FK_XDYN, x_dyn);
    store_kin_direct(o, FK_KIN, k);
    o.q4(FK_C, r_q);
    o.s(FK_C + 4, r_h);
  }
  if (role == KA_ANG) {
    finish_kin_state(c, c6, comp, x, x_dyn, r_q, r_h, k);
    store_kin_angles(o, FK_KIN, k);
  }
  if (role == KA_EUL) {
    finish_kin_state(c, c6, comp, x, x_dyn, r_q, r_h, k);
    o.v3(FK_KIN + KR_E_NB, k.e_nb);
  }
  if (role == KA_AIR) {
    finish_kin_state(c, c6, comp, x, x_dyn, r_q, r_h, k);
    const AtmU<T> u = load_atm(c, 31);
    store_air(o, FK_AIR, atm_air<true>(k, u.T_sl, u.p_sl, u.wind));
  }
}

}  // namespace fj
