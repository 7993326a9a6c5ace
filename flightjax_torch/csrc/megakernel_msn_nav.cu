// megakernel_msn_nav: the megakernel's instance over the sensor-fed
// missions (missions.mission_nav_sim: NavAvionics, the radar aiding,
// around a scripted mission over the C172Xv2's guidance and control laws;
// the radar-gated crosswind landing and the cold-start takeoff of
// flightjax/demos/c172_demos.py:413-532), built in a translation unit of
// its own so that nvcc compiles it beside megakernel.cu. The kernel, its
// design and the TPU kernel it replaces (flightjax/parallel/megakernel.py::
// make_megakernel_step, :43, pallas_call :120) are megakernel.cu's:
// megakernel_msn's rows and phase machine, then the navigation avionics'
// rows and pass of megakernel_gdc_nav (csrc/nav.cuh), which also writes
// the estimated orthometric height that the radar gate reads. Plain
// PyTorch version: flightjax_torch/parallel/megakernel.py::
// megakernel_step_plain.
#define FJ_NAV_ACT fj::ACT_FBW
#define FJ_NAV_AVK AV_MSN_NAV
#define FJ_NAV_NAME megakernel_msn_nav
#include "megakernel.cu"
