// megakernel_msn_nav_turb: the megakernel's instance over the sensor-fed
// missions in Dryden turbulence (missions.mission_nav_sim(turbulence=):
// NavAvionics, the radar aiding, around a scripted mission over the
// C172Xv2's guidance and control laws, on the turbulent fly-by-wire
// vehicle), built in a translation unit of its own so that nvcc compiles
// it beside megakernel.cu. The kernel, its design and the TPU kernel it
// replaces (flightjax/parallel/megakernel.py::make_megakernel_step, :43,
// pallas_call :120) are megakernel.cu's: megakernel_msn_turb's rows,
// turbulence and phase machine, then the navigation avionics' rows and pass
// of megakernel_msn_nav (csrc/nav.cuh), which also writes the estimated
// orthometric height that the radar gate reads; its int32 operand the
// turbulence's rows (i, seed, n), then NAV_INT. Plain PyTorch version:
// flightjax_torch/parallel/megakernel.py::megakernel_step_plain.
#define FJ_NAV_ACT fj::ACT_FBW_TURB
#define FJ_NAV_AVK AV_MSN_NAV
#define FJ_NAV_NAME megakernel_msn_nav_turb
#include "megakernel.cu"
