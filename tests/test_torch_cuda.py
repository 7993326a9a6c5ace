"""The five CUDA kernels of flightjax_torch against their plain PyTorch
versions on the same card tensors, at the fleet width B = 4096: float64 to
1e-12 and float32 to 1e-5 (relative to max(1, |plain|); a few ulp of the
long transcendental chains). Needs a CUDA device and nvcc; skips without a
device. This file imports no JAX, so on a machine without it run

    python -m pytest --noconftest tests/test_torch_cuda.py
"""

import pytest
import torch

from flightjax_torch.core.modeling import tree_leaves_with_path
from flightjax_torch.models.c172.c172s import build_vehicle
from flightjax_torch.parallel import kernels as K
from flightjax_torch.testing import cluster_operands

B = 4096


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["kinair", "systems", "dynamics",
                                  "finish_kin", "finish_sys"])
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)],
                         ids=["f64", "f32"])
def test_kernel_matches_plain_on_card(name, dtype, tol):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    vehicle = build_vehicle(device="cuda", dtype=dtype)
    args = K.operand_args(cluster_operands(B, 1016, (3, 77), (5,)), vehicle,
                          "cuda", dtype)[name]
    before = K.LAUNCHES[name]
    got = getattr(K, name)(*args)
    ref = getattr(K, name + "_plain")(*args)
    torch.cuda.synchronize()
    assert K.LAUNCHES[name] == before + 1
    for (p, a), (_, b) in zip(tree_leaves_with_path(got),
                              tree_leaves_with_path(ref)):
        err = ((a.double() - b.double()).abs()
               / b.double().abs().clamp_min(1.0)).max()
        assert float(err) <= tol, (p, float(err))
