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
The fly-by-wire instances (systems_fbw, finish_sys_fbw, rk4_stage_fbw,
rk4_finish_fbw, megakernel_fbw) and the control laws' pass (ctl_laws, both
layouts) are held to their plain versions exactly at both block sizes and on
ragged batches, on operands that carry every lon and lat mode, and the
C172Xv1's three paths, with the control laws' periodic pass, a few steps
(the megakernel 500 in float32) against the plain step.
Needs a CUDA device and nvcc; skips without a device. This file imports no JAX, so on a machine without it run

    python -m pytest --noconftest tests/test_torch_cuda.py
"""

import functools

import pytest
import torch

from flightjax_torch.core.modeling import tree_leaves_with_path
from flightjax_torch.models.c172.c172s import build_vehicle
from flightjax_torch.parallel import kernels as K
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
    return K.unpack_out(name, out, comp)


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


# ------------------------------------------------------------ fly-by-wire

FBW_CASES = [("systems_fbw", False), ("finish_sys_fbw", False),
             ("rk4_stage_fbw", False), ("rk4_finish_fbw", False),
             ("rk4_finish_fbw", True)]
FBW_CASE_IDS = ["systems_fbw", "finish_sys_fbw", "rk4_stage_fbw",
                "rk4_finish_fbw", "rk4_finish_fbw-comp"]


def _fbw_args(name, batch, dtype, comp):
    """The wrapper arguments of a fly-by-wire instance on the fly-by-wire
    cluster operands (lanes 3 and 17 on the runway, lane 5 terminated,
    SMALL_CRASH_LANE crashing), on the card."""
    from flightjax_torch.models.c172.c172x import build_vehicle as fbw
    from flightjax_torch.testing import fbw_cluster_operands
    d = fbw_cluster_operands(batch, 1016, (3, 17), (5,), (SMALL_CRASH_LANE,))
    base = name[:-len("_fbw")]
    args = K.operand_args(d, fbw(device="cuda", dtype=dtype), "cuda",
                          dtype)[base]
    return base, _with_comp(base, args, comp)


@pytest.mark.cuda
@pytest.mark.parametrize("name,comp", FBW_CASES, ids=FBW_CASE_IDS)
@pytest.mark.parametrize("batch,lanes", ROLE_SHAPES, ids=ROLE_IDS)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_fbw_instance_matches_plain_on_card(name, comp, batch, lanes, dtype):
    """The fly-by-wire instances against their plain versions, exactly, at
    both block sizes and on ragged batches; the wrapper launches the
    instance."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    base, args = _fbw_args(name, batch, dtype, comp)
    ref = getattr(K, base + "_plain")(*args)
    buf, n_out, scalars, ops = K.PACK[name](*args)
    got = K.unpack_out(name, K.launch_kernel(name, buf, n_out, scalars, ops,
                                             block=lanes), comp)
    before = K.LAUNCHES[name]
    via = getattr(K, base)(*args)
    torch.cuda.synchronize()
    assert K.LAUNCHES[name] == before + 1
    assert _worst(got, ref) == 0.0
    assert _worst(via, ref) == 0.0
    if base in ("finish_sys", "rk4_finish"):
        s_in = args[4]["systems"] if base == "rk4_finish" else args[4]
        assert not bool(s_in["crashed"][SMALL_CRASH_LANE])
        assert bool(got[1]["crashed"][SMALL_CRASH_LANE])


@pytest.mark.cuda
@pytest.mark.parametrize("split", ["subsystems", "vehicle"])
@pytest.mark.parametrize("dtype,tol", TOLS, ids=["f64", "f32"])
def test_xv1_paths_match_plain_on_card(split, dtype, tol):
    """The C172Xv1 on the turning climb, 3 steps from step 126 (the geoid
    refresh fires) through each split against the plain cluster step, with
    the periodic pass after every step; the launch counts of the split."""
    from flightjax_torch.parallel.clusterstep import (cluster_step,
                                                      make_cluster_step)
    from flightjax_torch.testing import xv1_fleet_sim
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    sim, st = xv1_fleet_sim(B, 1016, "cuda", dtype)
    if split == "vehicle":
        st = st._replace(c=None)
    step = make_cluster_step(sim, st, split=split)
    K.reset_launches()
    got = ref = st
    for i in range(126, 129):
        got = step(got, i=i)
        ref = cluster_step(sim, ref, i, plain=True)
    torch.cuda.synchronize()
    want = ({"rk4_stage_fbw": 12, "rk4_finish_fbw": 3, "geoid": 1}
            if split == "vehicle" else
            {"kinair": 12, "systems_fbw": 12, "dynamics": 12,
             "finish_kin": 3, "finish_sys_fbw": 3, "geoid": 1})
    want["ctl_laws"] = 3  # the periodic pass after every step
    assert K.LAUNCHES == dict.fromkeys(K.LAUNCHES, 0) | want
    assert _worst((got.t, got.x, got.u, got.s),
                  (ref.t, ref.x, ref.u, ref.s)) <= tol


# ------------------------------------------------------------ control laws

def _assert_same(got, ref):
    """Every leaf equal, the modes, flags and the step counter too."""
    g, r = tree_leaves_with_path(got), tree_leaves_with_path(ref)
    assert [p for p, _ in g] == [p for p, _ in r]
    for (p, a), (_, b) in zip(g, r):
        assert a.dtype == b.dtype and torch.equal(a, b), p


@pytest.mark.cuda
@pytest.mark.parametrize("batch,lanes", ROLE_SHAPES, ids=ROLE_IDS)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_ctl_laws_matches_plain_on_card(batch, lanes, dtype):
    """ctl_laws against `ctl_laws_plain` exactly, on the mode-rich
    operands (every lon and lat mode, mode changes, lanes on the ground,
    both sides of the altitude machine's switch points, saturation flags
    of both signs); the wrapper launches it."""
    from flightjax_torch.parallel import launch as L
    from flightjax_torch.testing import ctl_laws_args
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    args = ctl_laws_args(batch, 1016, "cuda", dtype, (3, 17))
    ref = K.ctl_laws_plain(*args)
    buf, n_out, scalars, ops = K.PACK["ctl_laws"](*args)
    got = K.unpack_out("ctl_laws", L.launch(
        "ctl_laws", buf, n_out, scalars, block=lanes, **ops))
    before = K.LAUNCHES["ctl_laws"]
    via = K.ctl_laws(*args)
    torch.cuda.synchronize()
    assert K.LAUNCHES["ctl_laws"] == before + 1
    _assert_same(got, ref)
    _assert_same(via, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("comp,spp", [(False, 1), (True, 1), (True, 2)],
                         ids=["uncompensated", "compensated", "every-2nd"])
@pytest.mark.parametrize("batch,lanes", ROLE_SHAPES, ids=ROLE_IDS)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_megakernel_fbw_matches_plain_on_card(comp, spp, batch, lanes,
                                              dtype):
    """One step of the fly-by-wire megakernel against its plain version,
    exactly, on the C172Xv1 cluster state with the mode-rich avionics
    (`testing.xv1_operand_state`; the crash lane latches), the pass firing
    on every lane or, at twice the step, on every other lane."""
    from flightjax_torch.core.sim import Simulation, comp_residuals
    from flightjax_torch.models.c172.c172x import c172xv1_sim
    from flightjax_torch.parallel.megakernel import (make_megakernel_step,
                                                     megakernel_step_plain)
    from flightjax_torch.testing import xv1_operand_state
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    sim, _, _ = c172xv1_sim("cuda", dtype)
    if spp != 1:
        sim = Simulation(sim.system, dt=sim.dt, periodic_dt=spp * sim.dt,
                         geoid_every=sim.geoid_every)
    st = xv1_operand_state(batch, 1016, "cuda", dtype, (3, 17), (5,),
                           (SMALL_CRASH_LANE,), i0=126)
    st = st._replace(i=st.i + torch.arange(
        batch, dtype=torch.int32, device="cuda") % spp)
    if comp:
        st = st._replace(c=comp_residuals(st.x, force=True))
    bufs, step_packed, unpack = make_megakernel_step(sim, st, block=lanes)
    K.reset_launches()
    got = unpack(step_packed(bufs))
    ref = megakernel_step_plain(sim, st)
    torch.cuda.synchronize()
    assert K.LAUNCHES == dict.fromkeys(K.LAUNCHES, 0) | {
        "megakernel_fbw": 1}
    _assert_same(tuple(got), tuple(ref))
    assert bool(got.s["vehicle"]["systems"]["crashed"][SMALL_CRASH_LANE])


@pytest.mark.cuda
def test_xv1_megakernel_500_steps_on_card():
    """The C172Xv1 on the turning climb, 500 float32 steps (10 s) through
    the fly-by-wire megakernel against its plain step: every leaf equal,
    one launch per step, every lane in the autopilot's modes."""
    from flightjax_torch.models.c172 import c172x_ctl as CTL
    from flightjax_torch.parallel.megakernel import (make_megakernel_step,
                                                     megakernel_step_plain)
    from flightjax_torch.testing import xv1_fleet_sim
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    sim, st = xv1_fleet_sim(B, 1016, "cuda", torch.float32)
    bufs, step_packed, unpack = make_megakernel_step(sim, st)
    K.reset_launches()
    ref = st
    for _ in range(500):
        bufs = step_packed(bufs)
        ref = megakernel_step_plain(sim, ref)
    got = unpack(bufs)
    torch.cuda.synchronize()
    assert K.LAUNCHES["megakernel_fbw"] == 500
    _assert_same(tuple(got), tuple(ref))
    assert bool((got.s["avionics"]["lon"]["mode_prev"]
                 == CTL.LON_EAS_CLM).all())
    assert bool((got.s["avionics"]["lat"]["mode_prev"]
                 == CTL.LAT_CHI_BETA).all())
