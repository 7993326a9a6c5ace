// megakernel_nav: the megakernel's instance over the calm sensor-fed
// C172Xv1 (`c172x.build_xv1_nav`: NavAvionics around its ControlLaws),
// built in a translation unit of its own so that nvcc compiles it beside
// megakernel.cu. The kernel, its design and the TPU kernel it replaces
// (flightjax/parallel/megakernel.py::make_megakernel_step, :43,
// pallas_call :120) are megakernel.cu's; the navigation pass is
// csrc/nav.cuh. Plain PyTorch version:
// flightjax_torch/parallel/megakernel.py::megakernel_step_plain.
#define FJ_NAV_ACT fj::ACT_FBW
#define FJ_NAV_NAME megakernel_nav
#include "megakernel.cu"
