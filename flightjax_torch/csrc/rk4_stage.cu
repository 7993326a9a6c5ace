// rk4_stage: one RK4 stage of the whole vehicle -- the stage state
// x + adt k_prev on all 27 states, then kinematics, atmosphere and air data,
// the C172 systems and Newton-Euler dynamics (World.f_ode), with every
// derivative zeroed on terminated lanes.
//
// Replaces the TPU kernel `rk4_stage` of flightjax/parallel/clusterstep.py
// (lane function `stage_lane`, clusterstep.py:81-93, built through
// pallas_block), the stage kernel of the split="vehicle" path. One launch
// does what kinair -> systems -> dynamics do in three, with the KinData,
// AirData, mass properties and wrench kept in registers instead of
// round-tripping through global memory. Plain PyTorch version:
// flightjax_torch/parallel/kernels.py::rk4_stage_plain.
//
// What bounds it on the H100: one thread per aircraft; 63 input rows, 27
// k_prev rows and 27 output rows per lane (1.9 MB in float32 at B = 4096),
// so HBM takes ~0.6 us. The systems body (~20 table lookups, three gear
// legs) holds 100+ registers, and 4096 threads in 128-thread blocks fill 32
// of the 132 SMs: it is bound by latency and occupancy, not by bandwidth or
// FLOPs. PERF.md records ptxas's registers and the times on the card.
#include "c172_systems.cuh"

using namespace fj;

template <typename T>
__global__ void __launch_bounds__(128)
    rk4_stage_kernel(const T* __restrict__ in, const T* __restrict__ k,
                     const T* __restrict__ P, T* __restrict__ out, int B,
                     T adt) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const Col<T> c{in, B, b};
  const Ctx<T> ctx = load_ctx(c, N_X);
  const XVeh<T> xi = axpy(load_x(c, 0), adt, load_x(Col<T>{k, B, b}, 0));
  store_x(Out<T>{out, B, b}, 0, vehicle_f_ode(P, xi, ctx));
}

template <typename T>
static int launch(const void* in, const void* k, const void* params,
                  void* out, int B, double adt, int block, void* stream) {
  if (B <= 0) return 0;
  if (block <= 0 || block > 128) return (int)cudaErrorInvalidValue;
  const int grid = (B + block - 1) / block;
  rk4_stage_kernel<T><<<grid, block, 0, (cudaStream_t)stream>>>(
      (const T*)in, (const T*)k, (const T*)params, (T*)out, B, T(adt));
  return (int)cudaGetLastError();
}

extern "C" {
int rk4_stage_f32(const void* in, const void* k, const void* params,
                  void* out, int B, double adt, int block, void* stream) {
  return launch<SF>(in, k, params, out, B, adt, block, stream);
}
int rk4_stage_f64(const void* in, const void* k, const void* params,
                  void* out, int B, double adt, int block, void* stream) {
  return launch<SD>(in, k, params, out, B, adt, block, stream);
}
void rk4_stage_layout(int* n_in, int* n_out) {
  *n_in = STAGE_N_IN;
  *n_out = STAGE_N_OUT;
}
// the whole-vehicle row groups: X, CTX, C and the megakernel's state buffer
void vehicle_layout(int* n_x, int* n_ctx, int* n_c, int* n_mega) {
  *n_x = N_X;
  *n_ctx = N_CTX;
  *n_c = N_C;
  *n_mega = MEGA_N_ROWS;
}
}
