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
(the megakernel 500 in float32) against the plain step. The C172Xv2's
instances (gdc_ctl_laws, megakernel_gdc) are held exactly alike, on
operands that carry every guidance mode as well, and its two splits a few
steps. The mission's instances (msn_ctl_laws, megakernel_msn) are held
exactly alike, on operands in every phase of the traffic pattern with each
phase's predicate on both sides of its switch, and on the mission fleet,
and its two splits a few steps. The navigation kernels (nav_pass,
megakernel_nav, megakernel_nav_turb) are held to their plain versions as
`testing.nav_hold` says, on the mode-rich navigation operands, and the
navigation fleet's three paths a few steps. The C172Xv2's last instances:
megakernel_gdc_turb and megakernel_msn_turb a few steps on the turbulent
operands with the mode-rich guidance (and every phase), megakernel_gdc_nav
one step on the sensor-fed C172Xv2's mode-rich operands in every
navigation setting, as `testing.nav_hold` says. The sensor-fed missions:
msn_nav_ctl_laws exactly on the mode-rich mission operands and the fleet's
estimates, megakernel_msn_nav and nav_pass's mission instance one step on
the sensor-fed mission operands in every setting, as `testing.nav_hold`
says. The sensor-fed C172Xv2 and missions in turbulence:
megakernel_gdc_nav_turb and megakernel_msn_nav_turb one step on their
mode-rich operands in four settings, as `testing.nav_hold` says, and their
three paths each 12 float64 steps against the plain step.
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


# ------------------------------------------------------------ the C172Xv2

@pytest.mark.cuda
@pytest.mark.parametrize("batch,lanes", ROLE_SHAPES, ids=ROLE_IDS)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_gdc_ctl_laws_matches_plain_on_card(batch, lanes, dtype):
    """gdc_ctl_laws against `gdc_ctl_laws_plain` exactly, the GdcY rows
    too, on the mode-rich guidance over the mode-rich control laws
    (`testing.gdc_laws_args`); the wrapper launches it."""
    from flightjax_torch.parallel import launch as L
    from flightjax_torch.testing import gdc_laws_args
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    args = gdc_laws_args(batch, 1016, "cuda", dtype, (3, 17))
    ref = K.gdc_ctl_laws_plain(*args)
    buf, n_out, scalars, ops = K.PACK["gdc_ctl_laws"](*args)
    got = K.unpack_out("gdc_ctl_laws", L.launch(
        "gdc_ctl_laws", buf, n_out, scalars, block=lanes, **ops))
    before = K.LAUNCHES["gdc_ctl_laws"]
    via = K.gdc_ctl_laws(*args)
    torch.cuda.synchronize()
    assert K.LAUNCHES["gdc_ctl_laws"] == before + 1
    _assert_same(got, ref)
    _assert_same(via, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("comp,spp", [(False, 1), (True, 1), (True, 2)],
                         ids=["uncompensated", "compensated", "every-2nd"])
@pytest.mark.parametrize("batch,lanes", ROLE_SHAPES, ids=ROLE_IDS)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_megakernel_gdc_matches_plain_on_card(comp, spp, batch, lanes,
                                              dtype):
    """One step of the C172Xv2 megakernel against its plain version,
    exactly, on the C172Xv2 cluster state with the mode-rich guidance and
    control laws (`testing.xv2_operand_state`), the pass firing on every
    lane or, at twice the step, on every other lane."""
    from flightjax_torch.core.sim import Simulation, comp_residuals
    from flightjax_torch.models.c172.c172x import c172xv2_sim
    from flightjax_torch.parallel.megakernel import (make_megakernel_step,
                                                     megakernel_step_plain)
    from flightjax_torch.testing import xv2_operand_state
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    sim, _, _ = c172xv2_sim("cuda", dtype)
    if spp != 1:
        sim = Simulation(sim.system, dt=sim.dt, periodic_dt=spp * sim.dt,
                         geoid_every=sim.geoid_every)
    st = xv2_operand_state(batch, 1016, "cuda", dtype, (3, 17), (5,),
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
        "megakernel_gdc": 1}
    _assert_same(tuple(got), tuple(ref))
    assert bool(got.s["vehicle"]["systems"]["crashed"][SMALL_CRASH_LANE])


@pytest.mark.cuda
@pytest.mark.parametrize("split", ["subsystems", "vehicle"])
@pytest.mark.parametrize("dtype,tol", TOLS, ids=["f64", "f32"])
def test_xv2_paths_match_plain_on_card(split, dtype, tol):
    """The C172Xv2 scenario (segment and circle lanes), 3 steps from step
    126 through each split against the plain cluster step, with the
    guidance and control laws' pass after every step; the launch counts."""
    from flightjax_torch.parallel.clusterstep import (cluster_step,
                                                      make_cluster_step)
    from flightjax_torch.testing import xv2_fleet_sim
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    sim, st, _ = xv2_fleet_sim(B, 1016, "cuda", dtype)
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
    want["gdc_ctl_laws"] = 3
    assert K.LAUNCHES == dict.fromkeys(K.LAUNCHES, 0) | want
    assert _worst((got.t, got.x, got.u, got.s),
                  (ref.t, ref.x, ref.u, ref.s)) <= tol


# ------------------------------------------------------------ the missions

@pytest.mark.cuda
@pytest.mark.parametrize("operands", ["rich", "fleet"])
@pytest.mark.parametrize("batch,lanes", ROLE_SHAPES, ids=ROLE_IDS)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_msn_ctl_laws_matches_plain_on_card(operands, batch, lanes, dtype):
    """msn_ctl_laws against `msn_ctl_laws_plain` exactly, the phase
    machine's rows too, on the mode-rich mission operands
    (`testing.msn_laws_args`: every phase, each predicate on both sides of
    its switch, a phase past the end) and on the mission fleet's pass
    (`testing.msn_fleet_sim`); the wrapper launches it."""
    from flightjax_torch.parallel import launch as L
    from flightjax_torch.testing import msn_fleet_sim, msn_laws_args
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if operands == "rich":
        args = msn_laws_args(batch, 1016, "cuda", dtype, (21, 22))
    else:
        sim, st, _ = msn_fleet_sim(batch, 1016, "cuda", dtype)
        aircraft = sim.system.aircraft
        vy = aircraft.vehicle.output(st.x["vehicle"], st.u["vehicle"],
                                     st.s["vehicle"])
        args = (aircraft.avionics, K.msn_y(vy), st.u["avionics"],
                st.s["avionics"], sim.periodic_dt,
                st.u["vehicle"]["systems"])
    ref = K.msn_ctl_laws_plain(*args)
    buf, n_out, scalars, ops = K.PACK["msn_ctl_laws"](*args)
    got = K.unpack_out("msn_ctl_laws", L.launch(
        "msn_ctl_laws", buf, n_out, scalars, block=lanes, **ops))
    before = K.LAUNCHES["msn_ctl_laws"]
    via = K.msn_ctl_laws(*args)
    torch.cuda.synchronize()
    assert K.LAUNCHES["msn_ctl_laws"] == before + 1
    _assert_same(got, ref)
    _assert_same(via, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("comp,spp", [(False, 1), (True, 1), (True, 2)],
                         ids=["uncompensated", "compensated", "every-2nd"])
@pytest.mark.parametrize("batch,lanes", ROLE_SHAPES, ids=ROLE_IDS)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_megakernel_msn_matches_plain_on_card(comp, spp, batch, lanes,
                                              dtype):
    """One step of the mission megakernel against its plain version,
    exactly, on the mission's cluster state (`testing.msn_operand_state`:
    the C172Xv2 cluster state with the mode-rich guidance and control laws,
    lanes in every phase and past the end), the pass firing on every lane
    or, at twice the step, on every other lane."""
    from flightjax_torch.core.sim import comp_residuals
    from flightjax_torch.parallel.megakernel import (make_megakernel_step,
                                                     megakernel_step_plain)
    from flightjax_torch.testing import msn_operand_state, msn_sim
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    sim = msn_sim("cuda", dtype, spp)
    st = msn_operand_state(batch, 1016, "cuda", dtype, (3, 17), (5,),
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
        "megakernel_msn": 1}
    _assert_same(tuple(got), tuple(ref))
    assert bool(got.s["vehicle"]["systems"]["crashed"][SMALL_CRASH_LANE])


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [32, 64])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_megakernel_msn_on_fleet_on_card(lanes, dtype):
    """20 steps of the mission megakernel on the mission fleet against its
    plain version, exactly."""
    from flightjax_torch.parallel.megakernel import (make_megakernel_step,
                                                     megakernel_step_plain)
    from flightjax_torch.testing import msn_fleet_sim
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    sim, st, _ = msn_fleet_sim(B, 1016, "cuda", dtype)
    bufs, step_packed, unpack = make_megakernel_step(sim, st, block=lanes)
    ref = st
    for _ in range(20):
        bufs = step_packed(bufs)
        ref = megakernel_step_plain(sim, ref)
    torch.cuda.synchronize()
    _assert_same(tuple(unpack(bufs)), tuple(ref))


@pytest.mark.cuda
@pytest.mark.parametrize("split", ["subsystems", "vehicle"])
@pytest.mark.parametrize("dtype,tol", TOLS, ids=["f64", "f32"])
def test_msn_paths_match_plain_on_card(split, dtype, tol):
    """The mission fleet, 3 steps from step 126 through each split against
    the plain cluster step, with the mission's pass after every step; the
    launch counts."""
    from flightjax_torch.parallel.clusterstep import (cluster_step,
                                                      make_cluster_step)
    from flightjax_torch.testing import msn_fleet_sim
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    sim, st, _ = msn_fleet_sim(B, 1016, "cuda", dtype)
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
    want["msn_ctl_laws"] = 3
    assert K.LAUNCHES == dict.fromkeys(K.LAUNCHES, 0) | want
    assert _worst((got.t, got.x, got.u, got.s),
                  (ref.t, ref.x, ref.u, ref.s)) <= tol


# ------------------------------------------------------------ turbulence

TURB_CASES = [("rk4_stage_turb", False), ("rk4_finish_turb", False),
              ("rk4_finish_turb", True)]
TURB_CASE_IDS = ["rk4_stage_turb", "rk4_finish_turb", "rk4_finish_turb-comp"]


def _turb_args(name, batch, dtype, comp):
    """The turbulent instance's wrapper arguments on `testing.turb_operands`
    (lanes 3 and 17 on the runway, lane 5 terminated, SMALL_CRASH_LANE
    crashing in the step): every severity, height band, shear and
    discrete-gust phase, V below V_MIN, seeds above 2^24."""
    from flightjax_torch.physics.turbulence import DrydenTurbulence
    from flightjax_torch.testing import turb_operand_args, turb_operands
    vehicle = build_vehicle(device="cuda", dtype=dtype,
                            turbulence=DrydenTurbulence(0.02))
    d = turb_operands(batch, 1016, (3, 17), (5,), (SMALL_CRASH_LANE,))
    args = turb_operand_args(d, vehicle, "cuda", dtype)[
        name[:-len("_turb")]]
    if name == "rk4_finish_turb" and not comp:
        args = args[:7] + (None,) + args[8:]
    return args


@pytest.mark.cuda
@pytest.mark.parametrize("name,comp", TURB_CASES, ids=TURB_CASE_IDS)
@pytest.mark.parametrize("batch,lanes", ROLE_SHAPES, ids=ROLE_IDS)
@pytest.mark.parametrize("dtype,tol", TOLS, ids=["f64", "f32"])
def test_turb_instance_matches_plain_on_card(name, comp, batch, lanes, dtype,
                                             tol):
    """rk4_stage_turb and rk4_finish_turb against their plain versions at
    both block sizes and on ragged batches; the crash lane latches and the
    drive's counter steps on every lane."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    args = _turb_args(name, batch, dtype, comp)
    buf, n_out, scalars, ops = K.PACK[name](*args)
    out = K.launch_kernel(name, buf, n_out, scalars, ops, block=lanes)
    got = K.unpack_out(name, out, comp, ops.get("ints"))
    ref = getattr(K, name[:-len("_turb")] + "_plain")(*args)
    torch.cuda.synchronize()
    assert _worst(got, ref) <= tol
    if name == "rk4_finish_turb":
        assert bool(got[1]["crashed"][SMALL_CRASH_LANE])
        assert torch.equal(got[-1]["n"], ref[-1]["n"])


@pytest.mark.cuda
@pytest.mark.parametrize("comp", [False, True],
                         ids=["uncompensated", "compensated"])
@pytest.mark.parametrize("batch,lanes", ROLE_SHAPES, ids=ROLE_IDS)
@pytest.mark.parametrize("dtype,tol", TOLS, ids=["f64", "f32"])
def test_megakernel_turb_matches_plain_on_card(comp, batch, lanes, dtype,
                                               tol):
    """megakernel_turb, 3 steps on the turbulent operands against the
    plain step; the int32 rows (i, seed, n) exactly."""
    from flightjax_torch.core.sim import comp_residuals
    from flightjax_torch.models.c172.c172s import turbulent_flagship_sim
    from flightjax_torch.parallel.megakernel import (make_megakernel_step,
                                                     megakernel_step_plain)
    from flightjax_torch.testing import turb_operand_state, turb_operands
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    sim, _, _ = turbulent_flagship_sim("cuda", dtype)
    st = turb_operand_state(turb_operands(batch, 1016, (3, 17), (5,),
                                          (SMALL_CRASH_LANE,)), "cuda", dtype)
    st = st._replace(c=comp_residuals(st.x, force=True) if comp else None)
    bufs, step_packed, unpack = make_megakernel_step(sim, st, block=lanes)
    before = K.LAUNCHES["megakernel_turb"]
    ref = st
    for _ in range(3):
        bufs = step_packed(bufs)
        ref = megakernel_step_plain(sim, ref)
    got = unpack(bufs)
    torch.cuda.synchronize()
    assert K.LAUNCHES["megakernel_turb"] == before + 3
    assert torch.equal(got.i, ref.i)
    for k in ("seed",):
        assert torch.equal(got.u["vehicle"]["turb"][k],
                           ref.u["vehicle"]["turb"][k].to(torch.int32))
    assert torch.equal(got.s["vehicle"]["turb"]["n"],
                       ref.s["vehicle"]["turb"]["n"])
    assert _worst((got.t, got.x, got.u, got.s, got.c),
                  (ref.t, ref.x, ref.u, ref.s, ref.c)) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["fleet", "vehicle"])
@pytest.mark.parametrize("dtype,tol", TOLS, ids=["f64", "f32"])
def test_turb_paths_match_plain_on_card(path, dtype, tol):
    """The turbulent fleet (W20 = 10, the shear on some lanes, a discrete
    gust on others), 3 steps from step 126 through `Simulation.fleet_step`
    (compensated) and the vehicle split against the plain step; the launch
    counts."""
    from flightjax_torch.parallel.clusterstep import (make_cluster_step,
                                                      vehicle_step)
    from flightjax_torch.testing import turb_fleet_sim
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    sim, st = turb_fleet_sim(B, 1016, "cuda", dtype, i0=126,
                             shear_lanes=range(0, B, 3),
                             gust_lanes=range(1, B, 3))
    comp = path == "fleet"
    if not comp:
        st = st._replace(c=None)
    step = (sim.fleet_step if comp
            else make_cluster_step(sim, st, split="vehicle"))
    K.reset_launches()
    got = ref = st
    for i in range(126, 129):
        got = step(got, i=i)
        ref = vehicle_step(sim, ref, i, comp=comp, plain=True)
    torch.cuda.synchronize()
    want = {"rk4_stage_turb": 12, "rk4_finish_turb": 3, "geoid": 1}
    assert K.LAUNCHES == dict.fromkeys(K.LAUNCHES, 0) | want
    assert _worst((got.t, got.x, got.u, got.s, got.c),
                  (ref.t, ref.x, ref.u, ref.s, ref.c)) <= tol


# ------------------------------------------------------------ navigation

FBW_TURB_CASES = [("rk4_stage_fbw_turb", False),
                  ("rk4_finish_fbw_turb", False),
                  ("rk4_finish_fbw_turb", True)]
FBW_TURB_CASE_IDS = ["rk4_stage_fbw_turb", "rk4_finish_fbw_turb",
                     "rk4_finish_fbw_turb-comp"]


def _fbw_turb_args(name, batch, dtype, comp):
    """The turbulent C172Xv1 instance's wrapper arguments on `testing.
    fbw_turb_operands` (the turbulent operands with the servos, saturating
    both ways)."""
    from flightjax_torch.models.c172.c172x import build_vehicle as fbw_veh
    from flightjax_torch.physics.turbulence import DrydenTurbulence
    from flightjax_torch.testing import fbw_turb_operands, turb_operand_args
    vehicle = fbw_veh(device="cuda", dtype=dtype,
                      turbulence=DrydenTurbulence(0.02))
    d = fbw_turb_operands(batch, 1016, (3, 17), (5,), (SMALL_CRASH_LANE,))
    args = turb_operand_args(d, vehicle, "cuda", dtype)[
        name[:-len("_fbw_turb")]]
    if name == "rk4_finish_fbw_turb" and not comp:
        args = args[:7] + (None,) + args[8:]
    return args


@pytest.mark.cuda
@pytest.mark.parametrize("name,comp", FBW_TURB_CASES, ids=FBW_TURB_CASE_IDS)
@pytest.mark.parametrize("batch,lanes", ROLE_SHAPES, ids=ROLE_IDS)
@pytest.mark.parametrize("dtype,tol", TOLS, ids=["f64", "f32"])
def test_fbw_turb_instance_matches_plain_on_card(name, comp, batch, lanes,
                                                 dtype, tol):
    """rk4_stage_fbw_turb and rk4_finish_fbw_turb against their plain
    versions at both block sizes and on ragged batches; the crash lane
    latches, the drive's counter steps on every lane, and the finish
    stores what the avionics read."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    args = _fbw_turb_args(name, batch, dtype, comp)
    buf, n_out, scalars, ops = K.PACK[name](*args)
    out = K.launch_kernel(name, buf, n_out, scalars, ops, block=lanes)
    got = K.unpack_out(name, out, comp, ops.get("ints"))
    ref = getattr(K, name[:-len("_fbw_turb")] + "_plain")(*args)
    torch.cuda.synchronize()
    assert _worst(got, ref) <= tol
    if name == "rk4_finish_fbw_turb":
        assert bool(got[1]["crashed"][SMALL_CRASH_LANE])
        assert torch.equal(got[-1]["n"], ref[-1]["n"])
        assert torch.equal(got[5]["wow"], ref[5]["wow"])


@pytest.mark.cuda
@pytest.mark.parametrize("spp", [1, 2], ids=["pass", "pass-every-2"])
@pytest.mark.parametrize("comp", [False, True],
                         ids=["uncompensated", "compensated"])
@pytest.mark.parametrize("batch,lanes", ROLE_SHAPES, ids=ROLE_IDS)
@pytest.mark.parametrize("dtype,tol", TOLS, ids=["f64", "f32"])
def test_megakernel_fbw_turb_matches_plain_on_card(spp, comp, batch, lanes,
                                                   dtype, tol):
    """megakernel_fbw_turb, 3 steps on the turbulent C172Xv1 operands with
    the mode-rich control laws (the pass every step, or every other step
    on alternate lanes) against the plain step; the int32 rows exactly."""
    from flightjax_torch.core.sim import Simulation, comp_residuals
    from flightjax_torch.models.c172.c172x import c172xv1_sim
    from flightjax_torch.parallel.megakernel import (make_megakernel_step,
                                                     megakernel_step_plain)
    from flightjax_torch.physics.turbulence import DrydenTurbulence
    from flightjax_torch.testing import (fbw_turb_operand_state,
                                         fbw_turb_operands)
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    sim0, _, _ = c172xv1_sim("cuda", dtype, turbulence=DrydenTurbulence(0.02))
    sim = Simulation(sim0.system, dt=0.02, periodic_dt=0.02 * spp)
    st = fbw_turb_operand_state(fbw_turb_operands(
        batch, 1016, (3, 17), (5,), (SMALL_CRASH_LANE,)), "cuda", dtype)
    st = st._replace(c=comp_residuals(st.x, force=True) if comp else None)
    bufs, step_packed, unpack = make_megakernel_step(sim, st, block=lanes)
    before = K.LAUNCHES["megakernel_fbw_turb"]
    ref = st
    for _ in range(3):
        bufs = step_packed(bufs)
        ref = megakernel_step_plain(sim, ref)
    got = unpack(bufs)
    torch.cuda.synchronize()
    assert K.LAUNCHES["megakernel_fbw_turb"] == before + 3
    assert torch.equal(got.i, ref.i)
    assert torch.equal(got.s["vehicle"]["turb"]["n"],
                       ref.s["vehicle"]["turb"]["n"])
    assert _worst((got.t, got.x, got.u, got.s, got.c),
                  (ref.t, ref.x, ref.u, ref.s, ref.c)) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["fleet", "vehicle", "megakernel"])
@pytest.mark.parametrize("dtype,tol", TOLS, ids=["f64", "f32"])
def test_nav_paths_match_plain_on_card(path, dtype, tol):
    """The joint navigation study's fleet, 12 steps (a GPS, baro and mag
    epoch among them) through `Simulation.fleet_step`, the vehicle split
    (the navigation pass the `nav_pass` kernel) and `make_megakernel_step`
    (`megakernel_nav_turb`) against the plain step, the whole state and
    inputs (t, x, u, s) as `testing.nav_hold` holds them: in float64
    within `tol` of the plain step run on the CPU over the first lanes, or
    within four times the card's plain run's own distance from that where
    it is the larger (the truth's ulps move the GPS fix by ulps of
    latitude), and every lane within 1e-9 of the card's plain run (the
    paths' tolerance); in float32 against the plain step in float64,
    within the float32 plain run's own distance from it; the launch
    counts (the
    truth's systems, the pass and the control laws once a step; the
    megakernel once a step)."""
    from flightjax_torch.parallel.clusterstep import (make_cluster_step,
                                                      vehicle_step)
    from flightjax_torch.parallel.megakernel import (make_megakernel_step,
                                                     megakernel_step_plain)
    from flightjax_torch.testing import (NAV_FLOOR, nav_fleet_sim,
                                         nav_hold, nav_reference)
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    sim, st = nav_fleet_sim(B, 1016, "cuda", dtype)
    K.reset_launches()
    if path == "megakernel":
        bufs, step_packed, unpack = make_megakernel_step(sim, st)
        for _ in range(12):
            bufs = step_packed(bufs)
        got = unpack(bufs)
    else:
        step = (sim.fleet_step if path == "fleet"
                else make_cluster_step(sim, st, split="vehicle"))
        got = st
        for i in range(12):
            got = step(got, i=i)
    torch.cuda.synchronize()
    want = ({"megakernel_nav_turb": 12} if path == "megakernel" else
            {"rk4_stage_fbw_turb": 48, "rk4_finish_fbw_turb": 12,
             "systems_fbw": 12, "ctl_laws": 12, "geoid": 12,
             "nav_pass": 12})
    assert K.LAUNCHES == dict.fromkeys(K.LAUNCHES, 0) | want

    def plain(sim, st):
        for i in range(12):
            st = (megakernel_step_plain(sim, st) if path == "megakernel"
                  else vehicle_step(sim, st, i, plain=True))
        return st
    ref = plain(sim, st)
    tr = lambda x: (x.t, x.x, x.u, x.s)
    if dtype == torch.float64:
        assert _worst(tr(got), tr(ref)) <= 1e-9
    ref_c = nav_reference(sim, dtype, plain, st)
    assert NAV_FLOOR[dtype] == tol
    nav_hold(dtype, tr(got), tr(ref), tr(ref_c), got.s["avionics"],
             ref.s["avionics"], sim.system.aircraft.avionics, path)
    assert bool((got.s["avionics"]["nis"]["gps"] > 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [32, 64])
@pytest.mark.parametrize("setting", ["default", "radar", "shadow",
                                     "synthetic", "perturb", "immediate"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_nav_pass_matches_plain_on_card(setting, lanes, dtype):
    """nav_pass against `kernels.nav_pass_plain` on the mode-rich
    navigation operands at B (`testing.nav_operand_state`) under each
    setting of `testing.NAV_SETTINGS`, held as `testing.nav_hold` says: P
    per lane against its largest entry, every other leaf within 1e-12 of
    the CPU's plain run in float64 (or four times the card's plain run's
    distance from it) and within the float32 plain run's own distance
    from the float64 one in float32, the integers and flags exactly but
    near a gate in float32."""
    from flightjax_torch.testing import (nav_hold, nav_operand_state,
                                         nav_pass_args, nav_reference)
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    sim, st = nav_operand_state(B, 1016, "cuda", dtype, setting=setting)
    args = nav_pass_args(sim, st)
    ref = K.nav_pass_plain(*args)
    ref_c = nav_reference(sim, dtype, lambda s_, a: K.nav_pass_plain(
        s_.system.aircraft.avionics, *a), args[1:])
    before = K.LAUNCHES["nav_pass"]
    got = K.nav_pass(*args, block=lanes)
    torch.cuda.synchronize()
    assert K.LAUNCHES["nav_pass"] == before + 1
    nav_hold(dtype, got, ref, ref_c, got[0], ref[0], args[0], setting)


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [32, 64])
@pytest.mark.parametrize("turb", [True, False], ids=["turb", "calm"])
@pytest.mark.parametrize("setting", ["default", "synthetic", "immediate"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_megakernel_nav_matches_plain_on_card(turb, setting, lanes, dtype):
    """megakernel_nav_turb and megakernel_nav, one step on the mode-rich
    navigation operands at B (the default, synthetic airflow angles, the
    covariance stepped every firing), against `megakernel_step_plain` (the
    pass each lane on its own sensor epoch), held as `testing.nav_hold`
    says."""
    from flightjax_torch.parallel.megakernel import (make_megakernel_step,
                                                     megakernel_step_plain)
    from flightjax_torch.testing import (nav_hold, nav_operand_state,
                                         nav_reference)
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    sim, st = nav_operand_state(B, 1016, "cuda", dtype, turbulence=turb,
                                setting=setting)
    name = "megakernel_nav_turb" if turb else "megakernel_nav"
    bufs, step_packed, unpack = make_megakernel_step(sim, st, block=lanes)
    before = K.LAUNCHES[name]
    got = unpack(step_packed(bufs))
    torch.cuda.synchronize()
    assert K.LAUNCHES[name] == before + 1
    ref = megakernel_step_plain(sim, st)
    ref_c = nav_reference(sim, dtype, megakernel_step_plain, st)
    tr = lambda x: (x.t, x.x, x.u, x.s)
    nav_hold(dtype, tr(got), tr(ref), tr(ref_c), got.s["avionics"],
             ref.s["avionics"], sim.system.aircraft.avionics, name)


@pytest.mark.cuda
@pytest.mark.parametrize("avk", ["gdc", "msn"])
@pytest.mark.parametrize("comp,spp", [(False, 1), (True, 2)],
                         ids=["uncompensated", "compensated-every-2nd"])
@pytest.mark.parametrize("batch,lanes", ROLE_SHAPES, ids=ROLE_IDS)
@pytest.mark.parametrize("dtype,tol", TOLS, ids=["f64", "f32"])
def test_megakernel_xv2_turb_matches_plain_on_card(avk, comp, spp, batch,
                                                   lanes, dtype, tol):
    """megakernel_gdc_turb and megakernel_msn_turb, 3 steps on the
    turbulent C172Xv2 operands with the mode-rich control laws and
    guidance (a mission's in every phase too; the pass every step, or
    every other step), against the plain step: (t, x, u, s, c) within
    `tol`, in float32 every leaf exactly; the int32 rows and the crash
    latch exactly."""
    from flightjax_torch.core.sim import comp_residuals
    from flightjax_torch.parallel.megakernel import (make_megakernel_step,
                                                     megakernel_step_plain)
    from flightjax_torch.physics.turbulence import DrydenTurbulence
    from flightjax_torch.testing import (fbw_turb_operands, msn_sim,
                                         msn_turb_operand_state,
                                         xv2_turb_operand_state,
                                         xv2_turb_sim)
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    d = fbw_turb_operands(batch, 1016, (3, 17), (5,), (SMALL_CRASH_LANE,))
    if avk == "gdc":
        sim = xv2_turb_sim("cuda", dtype, spp)
        st = xv2_turb_operand_state(d, "cuda", dtype)
    else:
        sim = msn_sim("cuda", dtype, spp, turbulence=DrydenTurbulence(0.02))
        st = msn_turb_operand_state(d, "cuda", dtype)
    st = st._replace(c=comp_residuals(st.x, force=True) if comp else None)
    name = f"megakernel_{avk}_turb"
    bufs, step_packed, unpack = make_megakernel_step(sim, st, block=lanes)
    K.reset_launches()
    ref = st
    for _ in range(3):
        bufs = step_packed(bufs)
        ref = megakernel_step_plain(sim, ref)
    got = unpack(bufs)
    torch.cuda.synchronize()
    assert K.LAUNCHES == dict.fromkeys(K.LAUNCHES, 0) | {name: 3}
    assert torch.equal(got.i, ref.i)
    assert torch.equal(got.s["vehicle"]["turb"]["n"],
                       ref.s["vehicle"]["turb"]["n"])
    assert bool(got.s["terminated"][SMALL_CRASH_LANE])
    if dtype == torch.float32:
        _assert_same(tuple(got), tuple(ref))
    assert _worst((got.t, got.x, got.u, got.s, got.c),
                  (ref.t, ref.x, ref.u, ref.s, ref.c)) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [32, 64])
@pytest.mark.parametrize("setting", ["default", "radar", "shadow",
                                     "synthetic", "perturb", "immediate"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_megakernel_gdc_nav_matches_plain_on_card(setting, lanes, dtype):
    """megakernel_gdc_nav, one step on the calm sensor-fed C172Xv2's
    mode-rich operands at B (`testing.nav_operand_state(gdc=True)`: the
    navigation operands with the mode-rich control laws and guidance)
    under each setting, against `megakernel_step_plain` (the pass each
    lane on its own sensor epoch, then the guidance and the control laws
    on the estimates), (t, x, u, s) held as `testing.nav_hold` says."""
    from flightjax_torch.parallel.megakernel import (make_megakernel_step,
                                                     megakernel_step_plain)
    from flightjax_torch.testing import (nav_hold, nav_operand_state,
                                         nav_reference)
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    sim, st = nav_operand_state(B, 1016, "cuda", dtype, turbulence=False,
                                setting=setting, gdc=True)
    bufs, step_packed, unpack = make_megakernel_step(sim, st, block=lanes)
    K.reset_launches()
    got = unpack(step_packed(bufs))
    torch.cuda.synchronize()
    assert K.LAUNCHES == dict.fromkeys(K.LAUNCHES, 0) | {
        "megakernel_gdc_nav": 1}
    ref = megakernel_step_plain(sim, st)
    ref_c = nav_reference(sim, dtype, megakernel_step_plain, st)
    tr = lambda x: (x.t, x.x, x.u, x.s)
    nav_hold(dtype, tr(got), tr(ref), tr(ref_c), got.s["avionics"],
             ref.s["avionics"], sim.system.aircraft.avionics,
             "megakernel_gdc_nav")


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [32, 64])
@pytest.mark.parametrize("operands", ["mode-rich", "fleet"])
@pytest.mark.parametrize("dtype,tol", TOLS, ids=["f64", "f32"])
def test_msn_nav_ctl_laws_matches_plain_on_card(operands, lanes, dtype, tol):
    """msn_nav_ctl_laws against `msn_nav_ctl_laws_plain` at B, float64 to
    1e-12 and float32 exactly, phases and modes exactly: on the mode-rich
    mission operands whose final leg ends at the radar gate
    (`testing.msn_nav_laws_args`) and on the estimates of the two-mission
    fleet (`testing.msn_nav_fleet_sim`, its plain navigation pass)."""
    from flightjax_torch.testing import (msn_nav_fleet_sim,
                                         msn_nav_laws_args,
                                         msn_nav_pass_args)
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if operands == "mode-rich":
        args = msn_nav_laws_args(B, 1016, "cuda", dtype, (3, 77))
    else:
        args = msn_nav_pass_args(*msn_nav_fleet_sim(B, "cuda", dtype))
    from flightjax_torch.parallel import launch as L
    buf, n_out, scal, ops = K.PACK["msn_nav_ctl_laws"](*args)
    got = K.unpack_out("msn_nav_ctl_laws", L.launch(
        "msn_nav_ctl_laws", buf, n_out, scal, block=lanes, **ops))
    ref = K.msn_nav_ctl_laws_plain(*args)
    torch.cuda.synchronize()
    if dtype == torch.float32:
        _assert_same(got, ref)
    else:
        assert _worst(got, ref) <= tol
        for (p, a), (_, b) in zip(tree_leaves_with_path(got),
                                  tree_leaves_with_path(ref)):
            assert a.dtype.is_floating_point or torch.equal(a, b), p


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [32, 64])
@pytest.mark.parametrize("setting", ["default", "radar", "shadow",
                                     "synthetic", "perturb", "immediate"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_megakernel_msn_nav_matches_plain_on_card(setting, lanes, dtype):
    """megakernel_msn_nav and nav_pass's mission instance, one step on the
    sensor-fed mission operands at B (`testing.msn_nav_operand_state`:
    each phase of both missions, lanes either side of the radar gate, the
    radar out of range, a latched radar monitor) under each setting,
    against their plain versions, held as `testing.nav_hold` says (the
    phases exactly but, in float32, on lanes at the radar gate)."""
    from flightjax_torch.parallel.megakernel import (make_megakernel_step,
                                                     megakernel_step_plain)
    from flightjax_torch.testing import (msn_gate_lanes,
                                         msn_nav_operand_state, nav_hold,
                                         nav_pass_args, nav_reference)
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    sim, st = msn_nav_operand_state(B, 1016, "cuda", dtype, setting=setting)
    nav = sim.system.aircraft.avionics
    args = nav_pass_args(sim, st)
    ref = K.nav_pass_plain(*args)
    ref_c = nav_reference(sim, dtype, lambda s_, a: K.nav_pass_plain(
        s_.system.aircraft.avionics, *a), args[1:])
    got = K.nav_pass(*args, block=lanes)
    torch.cuda.synchronize()
    nav_hold(dtype, got, ref, ref_c, got[0], ref[0], nav, "nav_pass")
    bufs, step_packed, unpack = make_megakernel_step(sim, st, block=lanes)
    K.reset_launches()
    got = unpack(step_packed(bufs))
    torch.cuda.synchronize()
    assert K.LAUNCHES == dict.fromkeys(K.LAUNCHES, 0) | {
        "megakernel_msn_nav": 1}
    ref = megakernel_step_plain(sim, st)
    ref_c = nav_reference(sim, dtype, megakernel_step_plain, st)
    tr = lambda x: (x.t, x.x, x.u, x.s)
    nav_hold(dtype, tr(got), tr(ref), tr(ref_c), got.s["avionics"],
             ref.s["avionics"], nav, "megakernel_msn_nav",
             msn_gate_lanes(sim, ref) | msn_gate_lanes(sim, got))


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [32, 64])
@pytest.mark.parametrize("setting", ["default", "radar", "shadow",
                                     "immediate"])
@pytest.mark.parametrize("avk", ["gdc", "msn"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_megakernel_nav_turb_xv2_matches_plain_on_card(avk, setting, lanes,
                                                      dtype):
    """megakernel_gdc_nav_turb and megakernel_msn_nav_turb, one step on
    the turbulent sensor-fed C172Xv2's mode-rich operands at B
    (`testing.nav_operand_state(turbulence=True, gdc=True)`) and on the
    sensor-fed mission operands in turbulence (`testing.
    msn_nav_operand_state(turbulence=True)`) under each setting, against
    `megakernel_step_plain`, held as `testing.nav_hold` says (around the
    mission the phases exactly but, in float32, on lanes at the radar
    gate); the turbulence's counters exactly."""
    from flightjax_torch.parallel.megakernel import (make_megakernel_step,
                                                     megakernel_step_plain)
    from flightjax_torch.testing import (msn_gate_lanes,
                                         msn_nav_operand_state, nav_hold,
                                         nav_operand_state, nav_reference)
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if avk == "gdc":
        sim, st = nav_operand_state(B, 1016, "cuda", dtype, turbulence=True,
                                    setting=setting, gdc=True)
    else:
        sim, st = msn_nav_operand_state(B, 1016, "cuda", dtype,
                                        setting=setting, turbulence=True)
    name = f"megakernel_{avk}_nav_turb"
    bufs, step_packed, unpack = make_megakernel_step(sim, st, block=lanes)
    K.reset_launches()
    got = unpack(step_packed(bufs))
    torch.cuda.synchronize()
    assert K.LAUNCHES == dict.fromkeys(K.LAUNCHES, 0) | {name: 1}
    ref = megakernel_step_plain(sim, st)
    assert torch.equal(got.s["vehicle"]["turb"]["n"],
                       ref.s["vehicle"]["turb"]["n"])
    ref_c = nav_reference(sim, dtype, megakernel_step_plain, st)
    tr = lambda x: (x.t, x.x, x.u, x.s)
    gate = (msn_gate_lanes(sim, ref) | msn_gate_lanes(sim, got)
            if avk == "msn" else None)
    nav_hold(dtype, tr(got), tr(ref), tr(ref_c), got.s["avionics"],
             ref.s["avionics"], sim.system.aircraft.avionics, name, gate)


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["fleet", "vehicle", "megakernel"])
@pytest.mark.parametrize("avk", ["gdc", "msn"])
def test_nav_turb_xv2_paths_match_plain_on_card(avk, path):
    """The turbulent loiter on estimates (`testing.turb_loiter_fleet_sim`)
    and the two sensor-fed missions in turbulence (`testing.
    msn_nav_fleet_sim(turbulence=True)`), 12 float64 steps (a GPS epoch
    among them) through `Simulation.fleet_step`, the vehicle split and
    `make_megakernel_step` (`megakernel_gdc_nav_turb`,
    `megakernel_msn_nav_turb`) against the card's plain step within 1e-9,
    held as `testing.nav_hold` holds them; the launch counts."""
    from flightjax_torch.parallel.clusterstep import (make_cluster_step,
                                                      vehicle_step)
    from flightjax_torch.parallel.megakernel import (make_megakernel_step,
                                                     megakernel_step_plain)
    from flightjax_torch.testing import (msn_gate_lanes, msn_nav_fleet_sim,
                                         nav_hold, nav_reference,
                                         turb_loiter_fleet_sim)
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dtype = torch.float64
    if avk == "gdc":
        sim, st, _ = turb_loiter_fleet_sim(B, "cuda", dtype)
    else:
        sim, st = msn_nav_fleet_sim(B, "cuda", dtype, turbulence=True)
    K.reset_launches()
    if path == "megakernel":
        bufs, step_packed, unpack = make_megakernel_step(sim, st)
        for _ in range(12):
            bufs = step_packed(bufs)
        got = unpack(bufs)
    else:
        step = (sim.fleet_step if path == "fleet"
                else make_cluster_step(sim, st, split="vehicle"))
        got = st
        for i in range(12):
            got = step(got, i=i)
    torch.cuda.synchronize()
    laws = "gdc_ctl_laws" if avk == "gdc" else "msn_nav_ctl_laws"
    want = ({f"megakernel_{avk}_nav_turb": 12} if path == "megakernel" else
            {"rk4_stage_fbw_turb": 48, "rk4_finish_fbw_turb": 12,
             "systems_fbw": 12, laws: 12, "geoid": 12, "nav_pass": 12})
    assert K.LAUNCHES == dict.fromkeys(K.LAUNCHES, 0) | want

    def plain(sim, st):
        for i in range(12):
            st = (megakernel_step_plain(sim, st) if path == "megakernel"
                  else vehicle_step(sim, st, i, plain=True))
        return st
    ref = plain(sim, st)
    tr = lambda x: (x.t, x.x, x.u, x.s)
    assert _worst(tr(got), tr(ref)) <= 1e-9
    ref_c = nav_reference(sim, dtype, plain, st)
    gate = (msn_gate_lanes(sim, ref) | msn_gate_lanes(sim, got)
            if avk == "msn" else None)
    nav_hold(dtype, tr(got), tr(ref), tr(ref_c), got.s["avionics"],
             ref.s["avionics"], sim.system.aircraft.avionics, path, gate)


@pytest.mark.cuda
def test_normal_f32_table_equals_the_chain_on_card():
    """The sensors' float32 normals on the card, read from the table of
    the 2^23 mantissas, equal the chain `normal_f32` runs on the CPU (JAX's
    float32 normals), for keys per lane."""
    from flightjax_torch.ops import random as R
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    seed = torch.arange(4096, dtype=torch.int64) * 524287
    key = R.fold_in(R.PRNGKey(0x5E45), seed)
    got = R.normal_f32(key.cuda(), (20,))
    assert torch.equal(got.cpu(), R.normal_f32(key, (20,)))
