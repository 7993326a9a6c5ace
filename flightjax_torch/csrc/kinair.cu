// kinair: RK4 stage FMA on the kinematics and dynamics states, the
// wander-azimuth kinematics (derivative + KinData), the ISA atmosphere with
// wind, air data, and the derivative zeroed on terminated lanes.
//
// Replaces the TPU kernel `k_kinair` of flightjax/parallel/clusterstep.py,
// built from the lane function `k1_lane` (clusterstep.py:250-262) through
// pallas_block / pallas_block_minor. Plain PyTorch version:
// flightjax_torch/parallel/kernels.py::kinair_plain.
//
// What bounds it on the H100: one thread per aircraft, ~400 flops and a
// dozen transcendentals per lane, 37 inputs and 77 outputs per lane. At
// B = 4096 a call moves 1.8 MB in float32 (3.7 MB in float64), a
// microsecond of HBM time, so it is bound by launch latency and by
// occupancy, not by bandwidth or FLOPs. 4096 threads in 128-thread blocks
// occupy only 32 of the 132 SMs; the block size is a launch argument and
// PERF.md records 32/64/128/256 measured on the card.
#include "flight_math.cuh"

using namespace fj;

template <typename T>
__global__ void kinair_kernel(const T* __restrict__ in, T* __restrict__ out,
                              int B, T adt) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const Col<T> c{in, B, b};
  const Out<T> o{out, B, b};

  // stage state x + adt * k
  const Q4<T> q_wb = c.q4(0), q_ew = c.q4(4), kq_wb = c.q4(15),
              kq_ew = c.q4(19);
  const V3<T> w = c.v3(9), v = c.v3(12), kw = c.v3(24), kv = c.v3(27);
  const Q4<T> xq_wb = {q_wb.w + adt * kq_wb.w, q_wb.x + adt * kq_wb.x,
                       q_wb.y + adt * kq_wb.y, q_wb.z + adt * kq_wb.z};
  const Q4<T> xq_ew = {q_ew.w + adt * kq_ew.w, q_ew.x + adt * kq_ew.x,
                       q_ew.y + adt * kq_ew.y, q_ew.z + adt * kq_ew.z};
  const T xh_e = c(8) + adt * c(23);
  const V3<T> xw = add(w, scale(adt, kw));
  const V3<T> xv = add(v, scale(adt, kv));

  KinDot<T> xd;
  Kin<T> k;
  wa_f_ode(xq_wb, xq_ew, xh_e, xw, xv, c(30), xd, k);
  const Air<T> air = atm_air(k, c(31), c(32), c.v3(33));

  const T alive = T(1.0) - c(36);
  o.q4(0, {alive * xd.q_wb.w, alive * xd.q_wb.x, alive * xd.q_wb.y,
           alive * xd.q_wb.z});
  o.q4(4, {alive * xd.q_ew.w, alive * xd.q_ew.x, alive * xd.q_ew.y,
           alive * xd.q_ew.z});
  o.s(8, alive * xd.h_e);
  store_kin(o, N_XKIN, k);
  store_air(o, N_XKIN + N_KIN, air);
  o.v3(N_XKIN + N_KIN + N_AIR, xw);
  o.v3(N_XKIN + N_KIN + N_AIR + 3, xv);
}

template <typename T>
static int launch(const void* in, void* out, int B, double adt, int block,
                  void* stream) {
  if (B <= 0) return 0;
  if (block <= 0 || block > 1024) return (int)cudaErrorInvalidValue;
  const int grid = (B + block - 1) / block;
  kinair_kernel<T><<<grid, block, 0, (cudaStream_t)stream>>>(
      (const T*)in, (T*)out, B, T(adt));
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
}
