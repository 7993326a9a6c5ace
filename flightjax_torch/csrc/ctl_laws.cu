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
#include "c172x_ctl.cuh"

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
static int launch(const void* in, const void* gains, void* out, int B,
                  double dt, int lanes, void* stream) {
  if (B <= 0) return 0;
  if (lanes <= 0 || lanes > MAX_LANES || lanes % 32 != 0)
    return (int)cudaErrorInvalidValue;
  const RoleLaunch l = role_launch(B, lanes, CTL_SIDES, 0);
  ctl_laws_kernel<T><<<l.grid, l.block, 0, (cudaStream_t)stream>>>(
      (const T*)in, (const T*)gains, (T*)out, B, T(dt));
  return (int)cudaGetLastError();
}

extern "C" {
int ctl_laws_f32(const void* in, const void* gains, void* out, int B,
                 double dt, int lanes, void* stream) {
  return launch<SF>(in, gains, out, B, dt, lanes, stream);
}
int ctl_laws_f64(const void* in, const void* gains, void* out, int B,
                 double dt, int lanes, void* stream) {
  return launch<SD>(in, gains, out, B, dt, lanes, stream);
}
void ctl_laws_layout(int* n_in, int* n_out) {
  *n_in = CTL_N_IN;
  *n_out = CTL_N_OUT;
}
// n_params and elem_size are not read: the kernel takes no shared memory
void ctl_laws_launch_shape(int B, int lanes, int, int, int* grid, int* block,
                           int* shared) {
  put_launch(role_launch(B, lanes, CTL_SIDES, 0), grid, block, shared);
}
}
