// megakernel_fbw_a2: the megakernel's instance over the C172Xv1 whose
// elevator is a second-order servo (`c172x.c172xv1_sim(actuators=
// {"elevator": Actuator2()})`: its control laws over an Actuator2 on the
// elevator), built in a translation unit of its own so that nvcc compiles
// it beside megakernel.cu. The kernel, its design and the TPU kernel it
// replaces (flightjax/parallel/megakernel.py::make_megakernel_step, :43,
// pallas_call :120) are megakernel.cu's: megakernel_fbw's step and pass on
// the rows of ActKind ACT_FBW_A2, whose elevator holds its position and
// rate in two rows of X and two of role DRAG's slots (c172_systems.cuh::
// servo2_dot), so the state buffer has one row more. Plain PyTorch
// version: flightjax_torch/parallel/megakernel.py::megakernel_step_plain.
#define FJ_FBW_ACT fj::ACT_FBW_A2
#define FJ_FBW_AVK AV_CTL
#define FJ_FBW_NAME megakernel_fbw_a2
#include "megakernel.cu"

extern "C" {
// the whole-vehicle row groups of the second-order elevator's instances
void vehicle_fbw_a2_layout(int* n_x, int* n_ctx, int* n_c, int* n_mega) {
  *n_x = SysL<ACT_FBW_A2>::NXV;
  *n_ctx = SysL<ACT_FBW_A2>::NCTX;
  *n_c = N_C;
  *n_mega = MegaL<ACT_FBW_A2, AV_CTL>::ROWS;
}
}
