// megakernel_gdc_nav_turb: the megakernel's instance over the sensor-fed
// C172Xv2 in Dryden turbulence (`c172x.build_xv2_nav(turbulence=)`:
// NavAvionics around its guidance and control laws, which read the filter's
// estimates, on the turbulent fly-by-wire vehicle; the loiter on estimates
// in gusts), built in a translation unit of its own so that nvcc compiles
// it beside megakernel.cu. The kernel, its design and the TPU kernel it
// replaces (flightjax/parallel/megakernel.py::make_megakernel_step, :43,
// pallas_call :120) are megakernel.cu's: megakernel_gdc_turb's rows and
// turbulence, then the navigation avionics' rows and pass of
// megakernel_gdc_nav (csrc/nav.cuh); its int32 operand the turbulence's
// rows (i, seed, n), then NAV_INT. Plain PyTorch version:
// flightjax_torch/parallel/megakernel.py::megakernel_step_plain.
#define FJ_NAV_ACT fj::ACT_FBW_TURB
#define FJ_NAV_AVK AV_GDC_NAV
#define FJ_NAV_NAME megakernel_gdc_nav_turb
#include "megakernel.cu"
