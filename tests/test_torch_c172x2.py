"""The C172Xv2 guidance path of flightjax_torch against flightjax, float64
on the CPU (the kernels' plain versions), on inputs drawn with numpy from a
seed and handed to both packages:

- `nvector_from_latlon` and `ltf` to 1e-12;
- `segment_from_vector`, `reversed_segment`, `segment_data` and
  `circle_data` at seeded points: lengths to 1e-8 m, angles to 1e-12;
- `GuidanceLaws.f_periodic` and `override_ctl_u` on the mode-rich
  operands (`testing.gdc_laws_args`: every guidance mode, lanes on the
  ground, every combination of the two requests, cross-track errors on
  both sides of the 1000 m gate, far off the track, exactly on it, both
  turn directions, reversed segments): every GdcY leaf to 1e-12, modes and
  flags exactly;
- `Avionics.f_periodic` with `assign` there, and `init_from_trim` at the
  stored trim (its control laws' part as the C172Xv1's, which
  `tests/test_torch_c172x.py` holds to JAX);
- 3 segment lanes and 3 circle lanes of the card's scenario, one of them
  idle (guidance worked out, not engaged) and one crossing the
  cross-track gate, so that its vertical guidance engages during the run,
  stepped 5 times through `Simulation.fleet_step`,
  `make_cluster_step(split="vehicle")` and `make_megakernel_step` with the
  geoid refreshed every step, against `jax.jit(sim.fleet_step)` of the JAX
  C172Xv2 world at `geoid_every=1`, every leaf to 1e-9;
- the `megakernel_gdc` buffer round trip and the guidance's row maps
  against `csrc/c172x_gdc.cuh`.

The JAX fleet step at `geoid_every=1` is compiled once, shared by the
splits and the megakernel; the avionics' pass is compiled too (faster than
its eager run); the guidance runs eagerly.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flightjax.core.sim import SimState as JSimState
from flightjax.core.sim import Simulation as JSimulation
from flightjax.models.c172 import c172x as Jx
from flightjax.models.c172 import c172x_gdc as JGDC
from flightjax.ops import geodesy as Jgeo
from flightjax.physics.aircraftbase import SimpleWorld as JSimpleWorld

from flightjax_torch.bridge import tree_to_numpy
from flightjax_torch.core.modeling import tree_leaves_with_path
from flightjax_torch.core.sim import SimState, Simulation
from flightjax_torch.models.c172 import c172x as Tx
from flightjax_torch.models.c172 import c172x_ctl as TCTL
from flightjax_torch.models.c172 import c172x_gdc as TGDC
from flightjax_torch.ops import geodesy as Tgeo
from flightjax_torch.parallel import kernels as K
from flightjax_torch.parallel.clusterstep import make_cluster_step
from flightjax_torch.parallel.megakernel import make_megakernel_step
from flightjax_torch.testing import (gdc_laws_args, xv2_operand_state,
                                     xv2_scenario)

from test_torch_support import F64, assert_tree_close, to_jax, to_torch

TOL_OP = 1e-12
TOL = 1e-9
TOL_M = 1e-8
DT = 0.02
SEED = 20261017
B = 6
STEPS = 5
# the scenario's idle lane (guidance worked out, not engaged) and the
# segment lane that starts just outside the cross-track gate and flies
# into it
IDLE_LANE, GATE_LANE = 1, 2
# how far outside the gate the gate lane starts, in steps of its northward
# ground speed (it flies north across an eastward segment)
GATE_STEPS = 1.5


def _as_jax(tree_np, template):
    """The port's numpy tree with the JAX package's NamedTuple classes of
    `template` (the leaves pair by path; both flatten dict keys sorted)."""
    leaves = tree_leaves_with_path(tree_np)
    ref = jax.tree_util.tree_flatten_with_path(template)
    names = [tuple(getattr(k, "key", getattr(k, "name", None)) for k in p)
             for p, _ in ref[0]]
    assert [p for p, _ in leaves] == names
    return jax.tree_util.tree_unflatten(ref[1], [jnp.asarray(v)
                                                 for _, v in leaves])


@pytest.fixture(scope="module")
def jax_xv2():
    aircraft = Jx.build_xv2("wa")
    return {"aircraft": aircraft, "world": JSimpleWorld(aircraft)}


# ------------------------------------------------------------ geodesy

def test_nvector_and_ltf_match_jax():
    rng = np.random.default_rng(SEED)
    lat, lon = rng.uniform(-1.5, 1.5, 64), rng.uniform(-np.pi, np.pi, 64)
    got = Tgeo.nvector_from_latlon(torch.as_tensor(lat),
                                   torch.as_tensor(lon))
    ref = Jgeo.nvector_from_latlon(jnp.asarray(lat), jnp.asarray(lon))
    assert_tree_close(got, np.asarray(ref), TOL_OP)
    psi = rng.uniform(-np.pi, np.pi, 64)
    for wander in (0.0, psi):
        g = Tgeo.ltf(got, torch.as_tensor(wander) if np.ndim(wander)
                     else wander)
        r = jax.vmap(Jgeo.ltf)(ref, jnp.broadcast_to(jnp.asarray(wander),
                                                     (64,)))
        assert_tree_close(g, np.asarray(r), TOL_OP)


# ------------------------------------------------------------ geometry

def _assert_lengths_angles(got, ref, angles):
    """Each field of two NamedTuples: angles to 1e-12, lengths to 1e-8 m
    (absolute)."""
    for name in got._fields:
        a = getattr(got, name).numpy()
        b = np.asarray(getattr(ref, name))
        tol = TOL_OP if name in angles else TOL_M
        np.testing.assert_allclose(a, b, rtol=0, atol=tol, err_msg=name)


def test_segment_from_vector_and_reversed_match_jax():
    rng = np.random.default_rng(SEED + 1)
    for _ in range(6):
        lat, lon = rng.uniform(-1.2, 1.2), rng.uniform(-3.0, 3.0)
        h, chi = rng.uniform(0.0, 3000.0), rng.uniform(-np.pi, np.pi)
        s, gamma = rng.uniform(500.0, 60000.0), rng.uniform(-0.1, 0.1)
        got = TGDC.segment_from_vector(lat, lon, h, chi, s, gamma=gamma)
        ref = JGDC.segment_from_vector(lat, lon, h, chi, s, gamma=gamma)
        for g, r in ((got, ref), (TGDC.reversed_segment(got),
                                  JGDC.reversed_segment(ref))):
            np.testing.assert_allclose(g.n_e1.numpy(), np.asarray(r.n_e1),
                                       rtol=0, atol=TOL_OP)
            np.testing.assert_allclose(g.n_e2.numpy(), np.asarray(r.n_e2),
                                       rtol=0, atol=TOL_OP)
            np.testing.assert_allclose(float(g.h_e1), float(r.h_e1), rtol=0,
                                       atol=TOL_M)
            np.testing.assert_allclose(float(g.h_e2), float(r.h_e2), rtol=0,
                                       atol=TOL_M)
        assert TGDC.segment_latlon(got.n_e2) == pytest.approx(
            JGDC.segment_latlon(ref.n_e2), abs=TOL_OP)


@pytest.fixture(scope="module")
def mode_rich():
    """The mode-rich guidance operands: (avionics, y, u, s, dt) of
    `gdc_laws_args`, lanes 3 and 17 on the ground."""
    return gdc_laws_args(24, SEED, "cpu", F64, ground_lanes=(3, 17))


def _gdc_u(u):
    return tree_to_numpy(u["gdc"])


def _jax_gdc_u(u_np):
    return _as_jax(u_np, JGDC.GuidanceLaws().init_u())


@pytest.mark.parametrize("which", ["segment", "circle"])
def test_segment_and_circle_data_match_jax(mode_rich, which):
    _, y, u, _, _ = mode_rich
    u_np = _gdc_u(u)
    ju = _jax_gdc_u(u_np)
    n_e, h_e = y["n_e"], y["h_e"]
    jn, jh = jnp.asarray(n_e.numpy()), jnp.asarray(h_e.numpy())
    if which == "segment":
        got = TGDC.segment_data(u["gdc"]["target"], n_e, h_e)
        ref = jax.vmap(JGDC.segment_data)(ju["target"], jn, jh)
        _assert_lengths_angles(got, ref, ("chi_12", "gamma_12"))
        e = got.e_sb
    else:
        got = TGDC.circle_data(u["gdc"]["orbit"], n_e, h_e)
        ref = jax.vmap(JGDC.circle_data)(ju["orbit"], jn, jh)
        _assert_lengths_angles(got, ref, ("sigma", "chi_tan"))
        e = got.e_cb
    # both sides of the cross-track gate, and far off the track
    far = e.abs() > 1e5
    assert bool(far.any()) and bool(((e.abs() > 1000) & ~far).any())
    assert bool(((e.abs() < 1000) & (e.abs() > 990)).any())


def test_guidance_matches_jax(mode_rich):
    """`GuidanceLaws.f_periodic` (every GdcY leaf, the mode and the flags
    exactly) and `override_ctl_u` on the mode-rich operands."""
    avionics, y, u, _, _ = mode_rich
    vy = K.ctl_vehicle_y(y)
    jvy = K.ctl_vehicle_y(to_jax(tree_to_numpy(y)))
    jgdc = JGDC.GuidanceLaws()
    got = avionics.gdc.f_periodic(u["gdc"], vy)
    ref = jax.vmap(jgdc.f_periodic)(_jax_gdc_u(_gdc_u(u)), jvy)
    assert_tree_close(got, jax.tree.map(np.asarray, ref), TOL_OP)
    # every mode, the ground override, every pair of engaged flags
    assert set(got.mode.tolist()) == {0, 1, 2}
    assert got.mode[3] == got.mode[17] == TGDC.GDC_DIRECT
    pairs = set(zip(got.hor_gdc.tolist(), got.vrt_gdc.tolist()))
    assert pairs == {(False, False), (False, True), (True, False),
                     (True, True)}
    ctl_np = tree_to_numpy(u["ctl"])
    got_u = avionics.gdc.override_ctl_u(u["ctl"], got)
    ref_u = jax.vmap(jgdc.override_ctl_u)(to_jax(ctl_np), ref)
    assert_tree_close(got_u, jax.tree.map(np.asarray, ref_u), TOL_OP)


def test_avionics_pass_matches_jax(mode_rich):
    """`Avionics.f_periodic` and `assign` on the mode-rich operands: the new
    state, the control laws' outputs and the commands to 1e-12, the
    guidance's mode and flags exactly, against the JAX package's pass
    compiled (whose fused geometry rounds apart from its eager ops by up to
    1e-9 m in a cross-track error: the guidance's every leaf is held to the
    eager JAX guidance in `test_guidance_matches_jax`)."""
    avionics, y, u, s, dt = mode_rich
    jav = JGDC.Avionics()
    u_np, s_np = tree_to_numpy(u), tree_to_numpy(s)
    ju = _as_jax(u_np, jav.init_u())
    js = _as_jax(s_np, jav.init_s())
    jvy = K.ctl_vehicle_y(to_jax(tree_to_numpy(y)))
    got = avionics.f_periodic(s, u, K.ctl_vehicle_y(y), dt)
    ref = jax.jit(jax.vmap(jav.f_periodic, in_axes=(0, 0, 0, None)),
                  static_argnums=3)(js, ju, jvy, dt)
    assert_tree_close((got[0], got[1]["ctl"]),
                      jax.tree.map(np.asarray, (ref[0], ref[1]["ctl"])),
                      TOL_OP)
    flags = ("mode", "hor_gdc", "vrt_gdc")
    assert_tree_close({k: getattr(got[1]["gdc"], k) for k in flags},
                      {k: np.asarray(getattr(ref[1]["gdc"], k))
                       for k in flags}, 0.0)
    act = {"act": {ch: torch.zeros(24, dtype=F64) for ch in K.CTL_CMD}}
    got_sys = avionics.assign(act, got[1])
    ref_sys = jav.assign(to_jax(tree_to_numpy(act)), ref[1])
    assert_tree_close(got_sys, jax.tree.map(np.asarray, ref_sys), TOL_OP)
    # the wrapper's plain version is this pass
    s2, cmd, g = K.gdc_ctl_laws_plain(*mode_rich)
    assert_tree_close(s2, tree_to_numpy(got[0]), 0.0)
    assert_tree_close(cmd, tree_to_numpy(got_sys["act"]), 0.0)
    assert_tree_close(g, {k: getattr(got[1]["gdc"], k)
                          for k, _ in K.GDC_YOUT}, 0.0)


def test_init_from_trim_matches_jax():
    """The C172Xv2's bumpless start at the stored trim: the control laws'
    part is the C172Xv1's (whose `init_from_trim` is held to the JAX
    package's at the same trim in `tests/test_torch_c172x.py`), the
    guidance's the JAX package's `GuidanceLaws.init_u`, as JAX's
    `Avionics.init_from_trim` composes them (`c172x_gdc.py:259-261`)."""
    st = Tx.trimmed_xv2_state(DT, F64, "cpu")
    xv1 = Tx.trimmed_xv1_state(DT, F64, "cpu")
    assert_tree_close(st.u["avionics"]["ctl"],
                      tree_to_numpy(xv1.u["avionics"]), 0.0)
    assert_tree_close(st.s["avionics"], {"ctl": tree_to_numpy(
        xv1.s["avionics"])}, 0.0)
    assert_tree_close(st.u["avionics"]["gdc"], jax.tree.map(
        np.asarray, JGDC.GuidanceLaws().init_u()), TOL_OP)
    for name in ("x", "u", "s"):
        assert_tree_close(getattr(st, name)["vehicle"], tree_to_numpy(
            getattr(xv1, name)["vehicle"]), 0.0)
    assert int(st.u["avionics"]["gdc"]["mode_req"]) == TGDC.GDC_DIRECT


# ------------------------------------------------------------ fleet step

def _fleet():
    """numpy (t, i, x, u, s) of the step tests: the card's scenario on B
    lanes (3 segment, 3 circle lanes), IDLE_LANE idle, GATE_LANE on a
    segment due east that it meets at the cross-track gate GATE_STEPS
    steps after its start, flying north, its own longitudinal request the
    direct mode: its vertical guidance is off at the first passes and on
    at the last."""
    (t, i, x, u, s), _ = xv2_scenario(B, SEED, idle_lanes=(IDLE_LANE,))
    vehicle = Tx.build_vehicle(device="cpu", dtype=F64)
    vy = vehicle.output(*(to_torch(tree["vehicle"]) for tree in (x, u, s)))
    lat, lon = (v[GATE_LANE].item() for v in Tgeo.latlon_from_nvector(
        vy.kinematics.n_e))
    h = float(vy.kinematics.h_e[GATE_LANE])
    north = float(vy.kinematics.v_eb_n[GATE_LANE, 0])
    d = 1000.0 + GATE_STEPS * north * DT
    lat1, lon1 = Tx.offset_point(lat, lon, h, d, -25000.0)
    seg = TGDC.segment_from_vector(lat1, lon1, h, np.pi / 2, 50000.0, dh=0.0)
    for k, v in zip(seg._fields, seg):
        getattr(u["avionics"]["gdc"]["target"], k)[GATE_LANE] = v.numpy()
    u["avionics"]["ctl"]["lon"]["mode_req"][GATE_LANE] = TCTL.LON_DIRECT
    return t, i, x, u, s


def _jax_state(t, i, x, u, s, aircraft):
    av = aircraft.avionics
    u = dict(u, avionics=_as_jax(u["avionics"], av.init_u()))
    s = dict(s, avionics=_as_jax(s["avionics"], av.init_s()))
    return JSimState(t=jnp.asarray(t), i=jnp.asarray(i), x=to_jax(x),
                     u=to_jax(u), s=to_jax(s))


@pytest.fixture(scope="module")
def jax_steps(jax_xv2):
    """The JAX fleet step with the geoid refreshed after every step, STEPS
    times from `_fleet`: the reference of both splits and the
    megakernel."""
    sim = JSimulation(jax_xv2["world"], dt=DT, periodic_dt=DT, geoid_every=1)
    step = jax.jit(sim.fleet_step)
    st = _jax_state(*_fleet(), jax_xv2["aircraft"])
    out = []
    for _ in range(STEPS):
        st = step(st)
        out.append(jax.tree.map(np.asarray, st))
    return out


def _sim():
    sim0, _, _ = Tx.c172xv2_sim("cpu", F64)
    return Simulation(sim0.system, dt=DT, periodic_dt=DT, geoid_every=1)


@pytest.mark.parametrize("path", ["subsystems", "vehicle", "megakernel"])
def test_fleet_step_matches_jax(jax_steps, path):
    """Both splits and the megakernel of the C172Xv2 with the geoid
    refreshed every step against the JAX fleet step, every leaf after each
    of STEPS steps to 1e-9; the gate lane's vertical guidance engages."""
    t, i, x, u, s = _fleet()
    sim = _sim()
    st = SimState(t=torch.tensor(t), i=torch.tensor(i), x=to_torch(x),
                  u=to_torch(u), s=to_torch(s))
    if path == "megakernel":
        bufs, step_packed, unpack = make_megakernel_step(sim, st)
    step = (make_cluster_step(sim, st, split="vehicle") if path == "vehicle"
            else sim.fleet_step)
    K.reset_launches()
    lon_modes = []
    for k in range(STEPS):
        if path == "megakernel":
            bufs = step_packed(bufs)
            st = unpack(bufs)
        else:
            st = step(st, i=k)
        ref = jax_steps[k]
        for name in ("t", "i", "x", "u", "s"):
            assert_tree_close({name: getattr(st, name)},
                              {name: getattr(ref, name)}, TOL, f"step {k}: ")
        lon_modes.append(int(st.s["avionics"]["ctl"]["lon"]["mode_prev"][
            GATE_LANE]))
    assert not any(K.LAUNCHES.values())
    # the gate lane enters the altitude modes when its vertical guidance
    # engages; the engaged lanes fly course hold, the idle lane too, on its
    # own request
    assert lon_modes[0] == TCTL.LON_DIRECT, lon_modes
    assert lon_modes[-1] in (TCTL.LON_EAS_ALT, TCTL.LON_THR_EAS), lon_modes
    lat = st.s["avionics"]["ctl"]["lat"]["mode_prev"]
    assert lat.tolist() == [TCTL.LAT_CHI_BETA] * B
    act0, act = x["vehicle"]["systems"]["act"], st.x["vehicle"]["systems"][
        "act"]
    assert any(float((act[ch] - torch.as_tensor(act0[ch])).abs().max())
               > 1e-3 for ch in act)


def test_megakernel_buffers_roundtrip_xv2():
    """The C172Xv2 resident buffer (t, X, CTX, C, the control laws' u and
    s, the guidance's inputs) round-trips through pack / unpack exactly,
    the modes, flags and saturation flags back in their types and the
    segment and circle as their NamedTuples."""
    from flightjax_torch.core.sim import comp_residuals
    sim = _sim()
    st = xv2_operand_state(24, SEED, "cpu", F64, (3, 17), (5,), (11,))
    st = st._replace(c=comp_residuals(st.x, force=True))
    bufs, _, unpack = make_megakernel_step(sim, st)
    assert bufs[0].shape == (K.rows(K.GDC.mega), 24) == (158, 24)
    back = unpack(bufs)
    pa, pb = tree_leaves_with_path(tuple(back)), tree_leaves_with_path(
        tuple(st))
    assert [p for p, _ in pa] == [p for p, _ in pb]
    for (p, a), (_, b) in zip(pa, pb):
        assert a.dtype == b.dtype and torch.equal(a, b), p
    g = back.u["avionics"]["gdc"]
    assert type(g["target"]).__name__ == "Segment"
    assert g["mode_req"].dtype == torch.int32
    assert g["hor_gdc_req"].dtype == torch.bool
    again, _, _ = make_megakernel_step(sim, back)
    assert torch.equal(again[0], bufs[0]) and torch.equal(again[1], bufs[1])


def test_scenario_geometry():
    """The card's scenario: segment lanes start within the shift of their
    eastward segment, circle lanes 500 m outside their circle, every
    engaged lane in a guided mode."""
    (t, i, x, u, s), (seg, crc, idle, h0) = xv2_scenario(8, SEED)
    vehicle = Tx.build_vehicle(device="cpu", dtype=F64)
    vy = vehicle.output(*(to_torch(tree["vehicle"]) for tree in (x, u, s)))
    g = to_torch(u["avionics"]["gdc"])
    d = TGDC.segment_data(TGDC.Segment(**g["target"]._asdict()),
                          vy.kinematics.n_e, vy.kinematics.h_e)
    c = TGDC.circle_data(TGDC.Circle(**g["orbit"]._asdict()),
                         vy.kinematics.n_e, vy.kinematics.h_e)
    assert bool((d.e_sb[seg].abs() < 401.0).all())
    np.testing.assert_allclose(d.chi_12[seg].numpy(), np.pi / 2, atol=1e-2)
    np.testing.assert_allclose(c.e_cb[crc].numpy(), 500.0, atol=2.0)
    assert h0 == pytest.approx(1050.0)
    assert set(g["mode_req"][seg].tolist()) == {TGDC.GDC_SEGMENT}
    assert set(g["mode_req"][crc].tolist()) == {TGDC.GDC_CIRCULAR}
    assert bool(g["hor_gdc_req"].all()) and len(idle) == 0


def test_gdc_layouts_match_csrc():
    """The guidance's row maps (`csrc/c172x_gdc.cuh`) against
    `parallel/kernels.py` and `parallel/launch.py`."""
    from flightjax_torch.parallel import launch as L
    from test_torch_support import _constexprs, _csrc, _enums
    env = _constexprs(_csrc("flight_math.cuh"), {})
    sys_src = _csrc("c172_systems.cuh")
    for members in _enums(sys_src).values():
        env.update({m: i for i, m in enumerate(members)})
    env = _constexprs(sys_src, env)
    env = _constexprs(_csrc("c172x_gdc.cuh"), _constexprs(
        _csrc("c172x_ctl.cuh"), env))
    for name, groups in (("N_UGDC", (K.AV_U_GDC,)), ("N_GDCY", (K.GDC_Y,)),
                         ("N_GDCO", (K.GDC_YOUT,)), ("GDC_N_IN", K.GDC_IN),
                         ("GDC_N_OUT", K.GDC_OUT),
                         ("MEGA_N_ROWS_GDC", K.GDC.mega),
                         ("AV_UGDC", K.AV_GROUPS)):
        assert env[name] == K.rows(groups), name
    assert env["CY_N_E"] == K.rows_of((K.GDC_Y,), "n_e").start
    for name, key in (("MODE", "mode_req"), ("N_E1", ("target", "n_e1")),
                      ("H_E1", ("target", "h_e1")),
                      ("N_E2", ("target", "n_e2")),
                      ("H_E2", ("target", "h_e2")), ("N_C", ("orbit", "n_e")),
                      ("H_C", ("orbit", "h_e")),
                      ("RADIUS", ("orbit", "radius")),
                      ("TURN", ("orbit", "turn_dir")), ("HOR", "hor_gdc_req"),
                      ("VRT", "vrt_gdc_req")):
        assert env["UG_" + name] == K.rows_of((K.AV_U_GDC,), key).start, name
    assert [env["GO_" + n] for n in ("MODE", "DCHI", "CHI_REF", "H_REF",
                                     "HOR", "VRT")] == list(range(6))
    assert [k for k, _ in K.GDC_YOUT] == ["mode", "dchi", "chi_ref",
                                          "h_ref", "hor_gdc", "vrt_gdc"]
    assert {"megakernel_gdc", "gdc_ctl_laws"} <= set(L.ROLE_KERNELS)
    assert len(L.KERNELS) == 35
    assert K.GDC.mega_name == "megakernel_gdc"
    assert K.GDC.pass_name == "gdc_ctl_laws"


def test_xv2_paths_never_import_jax():
    """Building the C172Xv2 and stepping it through both splits and the
    megakernel with the guidance engaged, and the mission fleet (the LOWS
    traffic pattern's phase machine over it) alike, leaves JAX out of the
    process."""
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import sys, torch\n"
        "from flightjax_torch.testing import xv2_fleet_sim\n"
        "from flightjax_torch.parallel.fleet import fleet_rollout\n"
        "from flightjax_torch.parallel.clusterstep import make_cluster_step\n"
        "from flightjax_torch.parallel.megakernel import "
        "make_megakernel_step\n"
        "from flightjax_torch.testing import msn_fleet_sim\n"
        "out = []\n"
        "for make in (xv2_fleet_sim, msn_fleet_sim):\n"
        "    sim, st, _ = make(4, 1, 'cpu', torch.float32)\n"
        "    out.append(fleet_rollout(sim, st, 1))\n"
        "    out.append(make_cluster_step(sim, st, split='vehicle')(st, i=0))\n"
        "    bufs, step, unpack = make_megakernel_step(sim, st)\n"
        "    out.append(unpack(step(bufs)))\n"
        "for r in out:\n"
        "    assert bool(torch.isfinite(r.x['vehicle']['kinematics']['h_e'])"
        ".all())\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'flightjax.')) or m == 'flightjax')\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=root)
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.slow
def test_fleet_step_matches_jax_over_20s(jax_xv2):
    """16 lanes of the card's scenario over 1000 steps (20 s: the capture
    turns onto the segments and circles) through `Simulation.fleet_step`
    against JAX's with the geoid refreshed every step, every leaf to 1e-9
    (about 4 min on the CPU). Lane 14 loses 86 m in its capture turn and
    acquires at full throttle without climbing back, in both packages."""
    from flightjax_torch.parallel.fleet import fleet_rollout
    t, i, x, u, s = xv2_scenario(16, 1016)[0]
    sim = JSimulation(jax_xv2["world"], dt=DT, periodic_dt=DT, geoid_every=1)
    step = jax.jit(sim.fleet_step)
    js = _jax_state(t, i, x, u, s, jax_xv2["aircraft"])
    for _ in range(1000):
        js = step(js)
    st = fleet_rollout(_sim(), SimState(
        t=torch.tensor(t), i=torch.tensor(i), x=to_torch(x), u=to_torch(u),
        s=to_torch(s)), 1000)
    ref = jax.tree.map(np.asarray, js)
    for name in ("t", "i", "x", "u", "s"):
        assert_tree_close({name: getattr(st, name)},
                          {name: getattr(ref, name)}, TOL)
    h0 = xv2_scenario(1, 1016)[1][3]  # the trim's, the guidance's
    assert float(st.x["vehicle"]["kinematics"]["h_e"][14]) - h0 < -50.0
    assert int(st.s["avionics"]["ctl"]["lon"]["mode_prev"][14]) == \
        TCTL.LON_THR_EAS
