// megakernel_gdc_nav: the megakernel's instance over the calm sensor-fed
// C172Xv2 (`c172x.build_xv2_nav`: NavAvionics around its guidance and
// control laws, which read the filter's estimates), built in a translation
// unit of its own so that nvcc compiles it beside megakernel.cu. The
// kernel, its design and the TPU kernel it replaces (flightjax/parallel/
// megakernel.py::make_megakernel_step, :43, pallas_call :120) are
// megakernel.cu's: megakernel_gdc's rows and guidance, then the navigation
// avionics' rows and pass of megakernel_nav (csrc/nav.cuh), which writes
// every GDC_Y field the guidance reads, the n-vector of the estimated
// position among them. Plain PyTorch version:
// flightjax_torch/parallel/megakernel.py::megakernel_step_plain.
#define FJ_NAV_ACT fj::ACT_FBW
#define FJ_NAV_AVK AV_GDC_NAV
#define FJ_NAV_NAME megakernel_gdc_nav
#include "megakernel.cu"
