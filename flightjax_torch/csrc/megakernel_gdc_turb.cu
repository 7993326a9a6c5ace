// megakernel_gdc_turb: the megakernel's instance over the C172Xv2 in
// Dryden turbulence (`c172x.build_xv2(turbulence=)`: its guidance and
// control laws on the turbulent fly-by-wire vehicle), built in a
// translation unit of its own so that nvcc compiles it beside
// megakernel.cu. The kernel, its design and the TPU kernel it replaces
// (flightjax/parallel/megakernel.py::make_megakernel_step, :43,
// pallas_call :120) are megakernel.cu's: megakernel_fbw_turb's rows and
// turbulence, megakernel_gdc's guidance. Plain PyTorch version:
// flightjax_torch/parallel/megakernel.py::megakernel_step_plain.
#define FJ_FBW_ACT fj::ACT_FBW_TURB
#define FJ_FBW_AVK AV_GDC
#define FJ_FBW_NAME megakernel_gdc_turb
#include "megakernel.cu"
