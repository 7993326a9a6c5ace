// nav_pass: the navigation avionics' pass over a fleet, the part before the
// inner avionics -- NavAvionics.nav_pass: the sensors' epoch draws, the
// sensor suite's error processes and measurements, the fault stage, the
// 15-state INS/GPS filter (the mean mechanisation, the deferred covariance
// on the p_every cadence, the stacked monitored aiding block with its
// masked Joseph update) and the estimated VehicleY rows the inner control
// laws read.
//
// Replaces the pass that the TPU kernel of flightjax/parallel/megakernel.py::
// make_megakernel_step (:43, pallas_call :120) runs inside the whole step of
// a navigation world (core/sim.py:327-333, Aircraft.f_periodic with
// NavAvionics), exposed as a kernel of its own, as ctl_laws is the control
// laws' pass: it can be held against its plain version apart from the step,
// and the two splits launch it in place of ~2,500 PyTorch ops a firing
// (parallel/clusterstep.py::_nav_periodic; the JAX package runs the pass
// there as XLA glue, flightjax/parallel/clusterstep.py:591-607), followed by
// ctl_laws or gdc_ctl_laws on its output. Plain PyTorch version:
// flightjax_torch/parallel/kernels.py::nav_pass_plain.
//
// In: the truth's GDC_Y rows (CTL_Y and the n-vector, c172x_gdc.cuh), the
// truth the sensors read (NAV_T, nav.cuh), the navigation avionics' inputs
// (NAV_U) and floating state (NAV_S); an int32 operand of the NAV_INT rows
// (seed, epoch, the fault's integers, the monitors' bits). Out: the GDC_Y
// rows with the estimates in place of the truth's (the truth's in shadow
// mode), then the new NAV_S rows; the new NAV_INT rows. The gains hold the
// filter's constants (kernels.nav_params) after the control laws' tables;
// the normal table (ops/random.py::normal_table) is an operand of its own,
// and so is the work buffer of the 15 x 15 algebra.
//
// What bounds it on the H100: not bytes (~700 rows per lane in and out, 11
// MB in float32 at B = 4096, ~3 us of HBM) nor operations (~25k a lane on
// an aiding epoch), but each lane's chain: the draws, the sensors and the
// filter's elementwise parts in one thread, the products in eight. The role
// layout of the megakernel (8 threads per aircraft, 32 or 64 aircraft per
// block; nav.cuh::nav_pass_roles): the lead thread of each lane does the
// elementwise parts, the 15 x 15 products split by rows between barriers,
// the matrices in the work buffer (L2).
//
// Around a mission (the sensor-fed landing and takeoff) its instance for
// the avionics kind MSN_NAV_KIND also writes the orthometric height the
// mission's radar gate reads, one row after NAV_S (kernels.NAV_OUT_MSN);
// the splits then launch msn_nav_ctl_laws on its output. The other
// instance keeps its code.
#include "c172x_msn.cuh"
#include "nav.cuh"

using namespace fj;

// the rows of the input and the output
constexpr int NAV_IN_T = N_GDCY, NAV_IN_U = NAV_IN_T + N_NAVT,
              NAV_IN_S = NAV_IN_U + N_NAVU,
              NAV_N_IN = NAV_IN_S + N_NAVS,                          // 405
              NAV_OUT_S = N_GDCY, NAV_N_OUT = NAV_OUT_S + N_NAVS;     // 331

// AVK: MSN_NAV_KIND for the mission's instance (its h_o in row NAV_N_OUT),
// 0 for the other
template <typename T, int AVK = 0>
__global__ void __launch_bounds__(N_ROLES * MAX_LANES)
    nav_pass_kernel(const T* __restrict__ in, const int* __restrict__ i_in,
                    const T* __restrict__ G, const float* __restrict__ table,
                    T* __restrict__ work, T* __restrict__ out,
                    int* __restrict__ i_out, int B) {
  const RoleThread t = role_thread(B);
  const Col<T> c{in, B, t.b};
  const Out<T> o{out, B, t.b};
  NavTruth<T> tr;
  if (t.role == 0) {
    tr = load_truth(Col<T>{in + NAV_IN_T * B, B, t.b});
    // the truth's rows; the pass overwrites the estimated ones
    if (t.valid)
      for (int k = 0; k < N_GDCY; ++k) o.s(k, c(k));
  }
  nav_pass_roles<T, AVK == MSN_NAV_KIND ? NAV_N_OUT : 0>(
                    t.role, t.valid, true, nav_params(G), table, tr,
                    c(NAV_IN_T + NT_H_TRN), Col<T>{in + NAV_IN_U * B, B, t.b},
                    Col<T>{in + NAV_IN_S * B, B, t.b},
                    Out<T>{out + NAV_OUT_S * B, B, t.b}, i_in + t.b,
                    i_out + t.b, work + t.b, B, o, true);
}

// ho: the mission's instance, whose output has one more row
template <typename T>
static int launch(const void* in, const void* i_in, const void* gains,
                  const void* table, void* work, void* out, void* i_out,
                  int B, int ho, int lanes, void* stream) {
  if (B <= 0) return 0;
  if (lanes <= 0 || lanes > MAX_LANES || lanes % 32 != 0)
    return (int)cudaErrorInvalidValue;
  const RoleLaunch l = role_launch(B, lanes, N_ROLES, 0);
  if (ho)
    nav_pass_kernel<T, MSN_NAV_KIND>
        <<<l.grid, l.block, 0, (cudaStream_t)stream>>>(
            (const T*)in, (const int*)i_in, (const T*)gains,
            (const float*)table, (T*)work, (T*)out, (int*)i_out, B);
  else
    nav_pass_kernel<T><<<l.grid, l.block, 0, (cudaStream_t)stream>>>(
        (const T*)in, (const int*)i_in, (const T*)gains, (const float*)table,
        (T*)work, (T*)out, (int*)i_out, B);
  return (int)cudaGetLastError();
}

extern "C" {
int nav_pass_f32(const void* in, const void* i_in, const void* gains,
                 const void* table, void* work, void* out, void* i_out, int B,
                 int ho, int lanes, void* stream) {
  return launch<SF>(in, i_in, gains, table, work, out, i_out, B, ho, lanes,
                    stream);
}
int nav_pass_f64(const void* in, const void* i_in, const void* gains,
                 const void* table, void* work, void* out, void* i_out, int B,
                 int ho, int lanes, void* stream) {
  return launch<SD>(in, i_in, gains, table, work, out, i_out, B, ho, lanes,
                    stream);
}
void nav_pass_layout(int* n_in, int* n_out) {
  *n_in = NAV_N_IN;
  *n_out = NAV_N_OUT;
}
// the rows of the navigation blocks, the work buffer and the parameter
// block, for the host's row maps
void nav_rows(int* n_u, int* n_s, int* n_i, int* n_t, int* n_work,
              int* n_params) {
  *n_u = N_NAVU;
  *n_s = N_NAVS;
  *n_i = N_NAVI;
  *n_t = N_NAVT;
  *n_work = N_WORK;
  *n_params = N_NAVP;
}
void nav_pass_launch_shape(int B, int lanes, int, int, int* grid, int* block,
                           int* shared) {
  put_launch(role_launch(B, lanes, N_ROLES, 0), grid, block, shared);
}
}
