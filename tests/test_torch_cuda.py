"""The CUDA kernels of flightjax_torch against their plain PyTorch versions
on the same card tensors, at the fleet width B = 4096: float64 to 1e-12 and
float32 to 1e-5 (relative to max(1, |plain|); a few ulp of the long
transcendental chains), on the cluster operands with a lane that crashes
during the step; the role kernels (kinair, finish_kin, systems, finish_sys,
rk4_stage, rk4_finish, megakernel) at 32 and 64 aircraft per block and on
batches that are no multiple of either, dynamics alike at 32 and 64 threads
per block, kinair, dynamics and finish_kin also on the ISA-layer operands,
the stage and finish kernels also on the airborne flight fleet;
and the two whole-step entry points, a few steps against their plain paths.
Needs a CUDA device and nvcc; skips without a device. This file imports no JAX, so on a machine without it run

    python -m pytest --noconftest tests/test_torch_cuda.py
"""

import functools

import pytest
import torch

from flightjax_torch.core.modeling import tree_leaves_with_path
from flightjax_torch.models.c172.c172s import build_vehicle
from flightjax_torch.parallel import kernels as K
from flightjax_torch.physics.atmosphere import AirData
from flightjax_torch.physics.dynamics import MassProps, Wrench
from flightjax_torch.physics.kinematics import KinData
from flightjax_torch.testing import (cluster_operands, flight_operand_args,
                                     isa_layer_operands, perturbed_fleet_sim)

B = 4096
TOLS = [(torch.float64, 1e-12), (torch.float32, 1e-5)]
# the lane that crashes during the step, at B and in the smaller batches
CRASH_LANE, SMALL_CRASH_LANE = 78, 11


def _worst(got, ref, equal_nan=False):
    """max |got - ref| / max(1, |ref|) over the floating leaves; with
    `equal_nan`, NaN where the reference is NaN counts as equal, NaN
    anywhere else as infinitely far."""
    worst = 0.0
    for (_, a), (_, b) in zip(tree_leaves_with_path(got),
                              tree_leaves_with_path(ref)):
        if not a.dtype.is_floating_point:
            continue
        if equal_nan:
            if not torch.equal(a.isnan(), b.isnan()):
                return float("inf")
            a, b = a[~b.isnan()], b[~b.isnan()]
        worst = max(worst, float(((a.double() - b.double()).abs()
                                  / b.double().abs().clamp_min(1.0)).max()))
    return worst


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["kinair", "systems", "dynamics",
                                  "finish_kin", "finish_sys", "rk4_stage",
                                  "rk4_finish", "geoid"])
@pytest.mark.parametrize("dtype,tol", TOLS, ids=["f64", "f32"])
def test_kernel_matches_plain_on_card(name, dtype, tol):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    vehicle = build_vehicle(device="cuda", dtype=dtype)
    args = K.operand_args(cluster_operands(B, 1016, (3, 77), (5,),
                                           (CRASH_LANE,)), vehicle, "cuda",
                          dtype)[name]
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


@pytest.mark.cuda
@pytest.mark.parametrize("comp", [False, True],
                         ids=["uncompensated", "compensated"])
@pytest.mark.parametrize("dtype,tol", TOLS, ids=["f64", "f32"])
def test_megakernel_matches_plain_on_card(comp, dtype, tol):
    from flightjax_torch.core.sim import comp_residuals
    from flightjax_torch.parallel.megakernel import (make_megakernel_step,
                                                     megakernel_step_plain)
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    sim, st = perturbed_fleet_sim(B, 1016, "cuda", dtype)
    st = st._replace(c=comp_residuals(st.x, force=True) if comp else None)
    bufs, step_packed, unpack = make_megakernel_step(sim, st)
    before = K.LAUNCHES["megakernel"]
    ref = st
    for _ in range(3):
        bufs = step_packed(bufs)
        ref = megakernel_step_plain(sim, ref)
    got = unpack(bufs)
    torch.cuda.synchronize()
    assert K.LAUNCHES["megakernel"] == before + 3
    assert torch.equal(got.i, ref.i)
    assert _worst((got.t, got.x, got.s, got.c), (ref.t, ref.x, ref.s,
                                                 ref.c)) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", TOLS, ids=["f64", "f32"])
def test_vehicle_step_matches_plain_on_card(dtype, tol):
    from flightjax_torch.parallel.clusterstep import (cluster_step,
                                                      make_cluster_step)
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    sim, st = perturbed_fleet_sim(B, 1016, "cuda", dtype)
    st = st._replace(c=None)
    step = make_cluster_step(sim, st, split="vehicle")
    K.reset_launches()
    got = ref = st
    for i in range(126, 129):  # the geoid refresh fires at step 128
        got = step(got, i=i)
        ref = cluster_step(sim, ref, i, plain=True)
    torch.cuda.synchronize()
    assert K.LAUNCHES == dict.fromkeys(K.LAUNCHES, 0) | {
        "rk4_stage": 12, "rk4_finish": 3, "geoid": 1}
    assert _worst((got.t, got.x, got.s), (ref.t, ref.x, ref.s)) <= tol


# (batch, aircraft per block): the fleet width at both block sizes, and
# batches that end in a ragged block
ROLE_SHAPES = [(B, 32), (B, 64), (37, 32), (70, 64)]
ROLE_IDS = [f"B{b}-L{n}" for b, n in ROLE_SHAPES]


# the role kernels the wrappers launch, finish_kin and rk4_finish with and
# without residuals
ROLE_NAMES = [("systems", False), ("rk4_stage", False), ("rk4_finish", False),
              ("rk4_finish", True), ("finish_kin", False),
              ("finish_kin", True), ("finish_sys", False)]
ROLE_NAME_IDS = ["systems", "rk4_stage", "rk4_finish", "rk4_finish-comp",
                 "finish_kin", "finish_kin-comp", "finish_sys"]


def _small_cluster(batch):
    """The cluster operands of the role tests: lanes 3 and 17 on the
    runway, lane 5 terminated, SMALL_CRASH_LANE crashing in the step."""
    return cluster_operands(batch, 1016, (3, 17), (5,), (SMALL_CRASH_LANE,))


def _with_comp(name, args, comp):
    """The arguments of finish_kin and rk4_finish without their residuals
    unless `comp`."""
    if name in ("finish_kin", "rk4_finish") and not comp:
        return args[:-1] + (None,)
    return args


def _launch_role(name, args, lanes, comp=False):
    """Kernel `name` on the wrapper's arguments at `lanes` aircraft per
    block (threads per block for dynamics), its output as the wrapper
    returns it."""
    buf, n_out, scalars, ops = K.PACK[name](*args)
    out = K.launch_kernel(name, buf, n_out, scalars, ops, block=lanes)
    if name == "kinair":
        kin_dot, kin, air, xi_dyn = K.unpack(K.KINAIR_OUT, out)
        return kin_dot, KinData(**kin), AirData(**air), xi_dyn
    if name == "dynamics":
        return K.unpack(K.DYN_OUT, out)[0]
    if name == "systems":
        dot, mp, wr, hr = K.unpack(K.SYS_OUT, out)
        return dot, MassProps(**mp), Wrench(**wr), hr["hr_b"]
    if name == "rk4_stage":
        return K._x_tree(K.unpack(K.STAGE_OUT, out))
    if name == "finish_kin":
        x_kin, x_dyn, kin, air, c = K.unpack(K.FIN_OUT, out)
        return x_kin, x_dyn, KinData(**kin), AirData(**air), \
            (c if comp else None)
    if name == "finish_sys":
        return K.unpack(K.FSYS_OUT, out, typed=True)
    return K.unpack_finish(out, comp)


@pytest.mark.cuda
@pytest.mark.parametrize("name,comp", ROLE_NAMES, ids=ROLE_NAME_IDS)
@pytest.mark.parametrize("batch,lanes", ROLE_SHAPES, ids=ROLE_IDS)
@pytest.mark.parametrize("dtype,tol", TOLS, ids=["f64", "f32"])
def test_role_kernel_lanes_per_block_on_card(name, comp, batch, lanes, dtype,
                                             tol):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    vehicle = build_vehicle(device="cuda", dtype=dtype)
    args = _with_comp(name, K.operand_args(_small_cluster(batch), vehicle,
                                           "cuda", dtype)[name], comp)
    got = _launch_role(name, args, lanes, comp)
    ref = getattr(K, name + "_plain")(*args)
    torch.cuda.synchronize()
    assert _worst(got, ref) <= tol
    if name == "finish_sys":  # the crash lane latches during the step
        assert not bool(args[4]["crashed"][SMALL_CRASH_LANE])
        assert bool(got[1]["crashed"][SMALL_CRASH_LANE])


# the stage and finish kernels on the airborne flight fleet (B aircraft, the
# state the paths step), at both block sizes
FLIGHT_NAMES = ["kinair", "systems", "dynamics", "finish_kin", "finish_sys",
                "rk4_stage", "rk4_finish"]


@functools.lru_cache(maxsize=None)
def _flight_args(dtype):
    sim, st = perturbed_fleet_sim(B, 1016, "cuda", dtype)
    return flight_operand_args(sim, st)


@pytest.mark.cuda
@pytest.mark.parametrize("name", FLIGHT_NAMES)
@pytest.mark.parametrize("lanes", [32, 64])
@pytest.mark.parametrize("dtype,tol", TOLS, ids=["f64", "f32"])
def test_kernel_on_flight_fleet_on_card(name, lanes, dtype, tol):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    args = _flight_args(dtype)[name]
    comp = name == "finish_kin" and args[-1] is not None
    got = _launch_role(name, args, lanes, comp)
    ref = getattr(K, name + "_plain")(*args)
    torch.cuda.synchronize()
    assert _worst(got, ref) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("comp", [False, True],
                         ids=["uncompensated", "compensated"])
@pytest.mark.parametrize("lanes", [32, 64])
@pytest.mark.parametrize("dtype,tol", TOLS, ids=["f64", "f32"])
def test_finish_kin_on_isa_layers_on_card(comp, lanes, dtype, tol):
    """finish_kin on the ISA-layer operands: the finish's new heights in
    every ISA layer, NaN sea-level temperatures (NaN where plain is NaN)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    vehicle = build_vehicle(device="cuda", dtype=dtype)
    args = _with_comp("finish_kin", K.operand_args(
        isa_layer_operands(B, 1016), vehicle, "cuda", dtype)["finish_kin"],
        comp)
    got = _launch_role("finish_kin", args, lanes, comp)
    ref = K.finish_kin_plain(*args)
    torch.cuda.synchronize()
    assert _worst(got, ref, equal_nan=True) <= tol


# kinair and dynamics: the cluster operands at each shape of ROLE_SHAPES,
# and the ISA-layer operands (every ISA layer, the first layer's ceiling,
# NaN sea-level temperatures: NaN where plain is NaN) at 32 and 64 per block
KD_CASES = [("cluster", b, n) for b, n in ROLE_SHAPES] + [
    ("isa", B, 32), ("isa", B, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["kinair", "dynamics"])
@pytest.mark.parametrize("ops,batch,lanes", KD_CASES,
                         ids=ROLE_IDS + ["isa-L32", "isa-L64"])
@pytest.mark.parametrize("dtype,tol", TOLS, ids=["f64", "f32"])
def test_kinair_dynamics_on_card(name, ops, batch, lanes, dtype, tol):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    vehicle = build_vehicle(device="cuda", dtype=dtype)
    d = (isa_layer_operands(batch, 1016) if ops == "isa"
         else _small_cluster(batch))
    args = K.operand_args(d, vehicle, "cuda", dtype)[name]
    got = _launch_role(name, args, lanes)
    ref = getattr(K, name + "_plain")(*args)
    torch.cuda.synchronize()
    assert _worst(got, ref, equal_nan=ops == "isa") <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("batch,lanes", ROLE_SHAPES, ids=ROLE_IDS)
@pytest.mark.parametrize("dtype,tol", TOLS, ids=["f64", "f32"])
def test_megakernel_lanes_per_block_on_card(batch, lanes, dtype, tol):
    from flightjax_torch.core.sim import comp_residuals
    from flightjax_torch.models.c172.c172s import flagship_sim
    from flightjax_torch.parallel.megakernel import (make_megakernel_step,
                                                     megakernel_step_plain)
    from flightjax_torch.testing import operand_state
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    sim, _, _ = flagship_sim("cuda", dtype)
    st = operand_state(_small_cluster(batch), "cuda", dtype, i0=126)
    st = st._replace(c=comp_residuals(st.x, force=True))
    bufs, step_packed, unpack = make_megakernel_step(sim, st, block=lanes)
    got, ref = unpack(step_packed(bufs)), megakernel_step_plain(sim, st)
    torch.cuda.synchronize()
    assert torch.equal(got.i, ref.i)
    assert _worst((got.t, got.x, got.s, got.c), (ref.t, ref.x, ref.s,
                                                 ref.c)) <= tol
