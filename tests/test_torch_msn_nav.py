"""The sensor-fed LOWS missions (`NavAvionics(MissionAvionics(...),
use_radar=True)` over the calm C172Xv2 on the LOWS-elevation terrain, the
phase machine, the guidance and the control laws all on the filter's
estimates) of flightjax_torch against flightjax, float64 on the CPU (the
kernels' plain versions), on inputs drawn with numpy from a seed and handed
to both packages:

- the radar flare gate `MD_AGL` against JAX's `final_done_agl`
  (`tests/test_missions.py:224-225`), on both sides of the gate and on it;
- both missions in one world (`testing.msn_nav_phases`: the landing's
  three phases, then the takeoff's four, each lane in its mission's
  phase): the first eight lanes of `testing.msn_nav_operand_state` at step
  and sensor epoch 7 (the GPS, baro, mag and radar aiding at epoch 10),
  through `Simulation.fleet_step`, `make_cluster_step(split="vehicle")`
  (the plain `rk4_stage_fbw`, `rk4_finish_fbw`, `nav_pass` and
  `msn_nav_ctl_laws`) and `make_megakernel_step` (the plain version of
  `megakernel_msn_nav`), 5 steps against `jax.jit(sim.fleet_step)` of
  JAX's `_mission_world_nav` at `geoid_every=1`, every leaf to 1e-9: a
  lane crosses the 6 m radar gate on its estimated height inside the
  window, another whose radar is out of range flares on its filter's
  altitude, 2.5 m under the truth, a standby lane's clock reaches 5 s and
  starts its engine;
- the resident buffers of `megakernel_msn_nav` round-trip;
- `slow`: the 100 s three-lane sensor-fed landing of
  `tests/test_missions.py:157-205` through the port's
  `Simulation.fleet_step`, held to that test's assertions.

One JAX compile (the fleet step).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flightjax.core.mission import Phase as JPhase
from flightjax.core.sim import Simulation as JSimulation
from flightjax.demos import c172_demos as JD

from flightjax_torch.bridge import tree_to_numpy
from flightjax_torch.models.c172 import missions as M
from flightjax_torch.parallel import kernels as K
from flightjax_torch.parallel.megakernel import make_megakernel_step
from flightjax_torch.testing import (NAV_FINAL, NAV_FLARE, NAV_STANDBY,
                                     NAV_STARTUP, msn_nav_operand_state,
                                     msn_nav_phases)

from test_torch_navigation import _compare, _jax_state, _port_state, _stepper
from test_torch_support import F64

DT = 0.02
STEPS = 5
# the window: steps 7..11 make the sensor epochs 8..12, every channel
# aiding at epoch 10
I0 = 7
B = 8
SEED = 1016
# the lane that crosses the radar gate, the lane out of the radar's range
# that flares on its filter's altitude, the standby lane whose clock
# reaches 5 s (testing.MSN_NAV_LANES)
GATE_LANE, RANGE_LANE, CLOCK_LANE = 0, 1, 5


@pytest.fixture(scope="module")
def jax_phases():
    """`testing.msn_nav_phases` in the JAX package: the landing's phases of
    `crosswind_landing_nav` (`c172_demos.py:455-464`), then the takeoff's
    of `takeoff_nav` (`:508-518`); built once (the legs' geometry runs
    eagerly in JAX) for the gate's test and the world."""
    legs = JD._lows_pattern()
    lib = JD._mission_phase_lib(legs)

    def final_done_agl(y, t):
        return (y.kinematics.h_o - JD.H_LOWS15) < 6.0

    hold = lambda u, y, t: u
    fly = lib["fly_leg"]
    return [
        JPhase("final", fly(legs["final"], 30.0), final_done_agl,
               systems=lib["flaps"](1.0)),
        JPhase("flare", lib["flare_apply"], lib["on_gnd"],
               systems=lib["flaps"](1.0)),
        JPhase("ground", lib["ground_apply"],
               lambda y, t: jnp.asarray(False),
               systems=lib["ground_systems"]),
        JPhase("standby", hold, lambda y, t: t >= 5.0),
        JPhase("startup", hold, lib["engine_running"],
               systems=lib["engine_start"]),
        JPhase("takeoff", fly(legs["departure"], 35.0, throttle=1.0),
               lib["airborne"]),
        JPhase("departure", fly(legs["departure"], 35.0, throttle=1.0),
               lib["captured"](legs["departure"])),
    ]


@pytest.fixture(scope="module")
def fleet():
    """numpy (t, i, x, u, s) of the B mode-rich lanes at the window."""
    _, st = msn_nav_operand_state(B, SEED, "cpu", F64, i0=I0)
    return tree_to_numpy(st)[:5]


@pytest.fixture(scope="module")
def jax_steps(fleet, jax_phases):
    """JAX's fleet step of `_mission_world_nav` over `jax_phases` with the
    geoid refreshed after every step, STEPS times from `fleet`."""
    world = JD._mission_world_nav(jax_phases, dt=DT)
    sim = JSimulation(world, dt=DT, periodic_dt=DT, geoid_every=1)
    step = jax.jit(sim.fleet_step)
    st = _jax_state(*fleet, world.aircraft.avionics)
    out = []
    for _ in range(STEPS):
        st = step(st)
        out.append(jax.tree.map(np.asarray, st))
    return out


def test_radar_gate_matches_jax(jax_phases):
    """`MD_AGL` (`missions.mission_phase_lib`'s `final_done_agl`) against
    JAX's radar gate on the orthometric height, below, on and above the
    6 m gate, and `MD_FINAL` beside it reading h_e."""
    rng = np.random.default_rng(SEED)
    h_o = np.concatenate([JD.H_LOWS15 + np.array([
        6.0, np.nextafter(6.0, 0.0), np.nextafter(6.0, 7.0), -1.0, 0.0,
        150.0]), JD.H_LOWS15 + rng.uniform(-5.0, 20.0, 64)])
    lib = M.mission_phase_lib(M.lows_pattern())
    done = lib["final_done_agl"]
    assert done.kind == M.MD_AGL and done.values["value"] == M.H_LOWS15

    class Kin:
        def __init__(self, h_o, h_e):
            self.h_o, self.h_e = h_o, h_e

    class Y:
        def __init__(self, h_o, h_e):
            self.kinematics = Kin(h_o, h_e)

    got = done(Y(torch.tensor(h_o), torch.tensor(h_o + 1e3)), 0.0)
    want = jax_phases[0].done(Y(jnp.asarray(h_o), jnp.asarray(h_o + 1e3)),
                              0.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.sum() not in (0, len(h_o))
    # the truth-fed final gate reads h_e, not h_o
    final = lib["final_done"](Y(torch.tensor(h_o), torch.tensor(h_o + 1e3)),
                              0.0)
    assert not bool(final.any())


@pytest.mark.parametrize("path", ["fleet", "vehicle", "megakernel"])
def test_sensor_fed_missions_match_jax(fleet, jax_steps, path):
    """Both sensor-fed missions through `Simulation.fleet_step`,
    `make_cluster_step(split="vehicle")` and `make_megakernel_step` (the
    plain version of `megakernel_msn_nav`, each lane's pass on its own
    sensor epoch) against the JAX fleet step, every leaf after each of
    STEPS steps to 1e-9: the filter, the monitors, the phase machine, the
    guided control laws and the phases' systems inputs among them. Inside
    the window the gate lane's estimated height falls under the radar gate
    and it flares, the out-of-range lane flares on its filter's altitude
    while its truth stands above the gate, and the standby lane's clock
    reaches 5 s and starts its engine."""
    sim = M.mission_nav_sim(msn_nav_phases(), device="cpu", dtype=F64)
    sim.geoid_every = 1
    assert K.avionics_layout(sim.system.aircraft.vehicle,
                             sim.system.aircraft.avionics) is K.MSN_NAV
    st = _port_state(fleet)
    step = _stepper(sim, st, path)
    K.reset_launches()
    phases = [st.s["avionics"]["inner"]["phase"].clone()]
    for k in range(STEPS):
        st = step(st, I0 + k)
        _compare(st, jax_steps[k], f"{path} step {k}: ")
        phases.append(st.s["avionics"]["inner"]["phase"].clone())
    assert not any(K.LAUNCHES.values())
    ph = torch.stack(phases)
    assert ph[0, GATE_LANE] == NAV_FINAL and ph[-1, GATE_LANE] == NAV_FLARE
    assert int(ph[:, GATE_LANE].argmax()) > 1  # inside the window
    assert ph[1, RANGE_LANE] == NAV_FLARE
    h_o = st.x["vehicle"]["kinematics"]["h_e"][RANGE_LANE] - st.s[
        "vehicle"]["geoid_N"][RANGE_LANE]
    assert float(h_o) - M.H_LOWS15 > M.FINAL_DH
    assert ph[0, CLOCK_LANE] == NAV_STANDBY
    assert ph[-1, CLOCK_LANE] == NAV_STARTUP
    assert bool(st.u["vehicle"]["systems"]["pwp"]["engine"]["start"][
        CLOCK_LANE])
    assert (st.s["avionics"]["nis"]["radar"] > 0).any()


def test_megakernel_buffers_roundtrip_msn_nav():
    """The sensor-fed missions' resident buffers (megakernel_msn's rows,
    then NAV_U and NAV_S; the step counter and NAV_INT) round-trip through
    pack / unpack exactly, with their types; the gains hold the filter's
    constants and the mission table behind two offsets."""
    from flightjax_torch.core.modeling import tree_leaves_with_path
    sim, st = msn_nav_operand_state(24, SEED, "cpu", F64)
    bufs, _, unpack = make_megakernel_step(sim, st)
    assert bufs[0].shape == (K.rows(K.MSN_NAV.mega), 24)
    assert K.rows(K.MSN_NAV.mega) == K.rows(K.MSN.mega) + K.rows(
        (K.NAV_U, K.NAV_S))
    assert bufs[1].shape == (1 + len(K.NAV_INT), 24)
    back = unpack(bufs)
    pa, pb = (tree_leaves_with_path(tuple(v)) for v in (back, st))
    assert [p for p, _ in pa] == [p for p, _ in pb]
    for (p, a), (_, b) in zip(pa, pb):
        assert a.dtype == b.dtype and torch.equal(a, b), p
    nav = sim.system.aircraft.avionics
    g = K.ctl_gains(nav).double()
    n = len(K.CTL_TABLES)
    nav_p = K.nav_param_values(nav)
    table = K.mission_table_values(nav.inner)
    o_nav, o_msn = int(g[n]), int(g[n + 1])
    assert g[o_nav:o_nav + len(nav_p)].tolist() == nav_p
    assert g[o_msn:o_msn + len(table)].tolist() == table
    assert M.MD_AGL in table[2 + 6::len(K.PHASE_FIELDS)]


@pytest.mark.slow
def test_crosswind_landing_nav_fleet_on_port():
    """`tests/test_missions.py:157-205` on the port's plain path: three
    lanes of the sensor-fed crosswind landing (`testing.
    landing_nav_fleet_sim`, seeds 100..102), 100 s through
    `Simulation.fleet_step`: every lane on the ground phase, not
    terminated, below 2 m/s, no monitor alarm, the wheels-stop points
    within 12 m of each other across the track and 150 m along it."""
    from flightjax_torch.models.c172 import c172x_gdc as TGDC
    from flightjax_torch.ops import geodesy as Tgeo
    from flightjax_torch.testing import landing_nav_fleet_sim
    sim, st = landing_nav_fleet_sim(3, "cpu", F64)
    for i in range(int(round(100.0 / DT))):
        st = sim.fleet_step(st, i=i)
    s_av = st.s["avionics"]
    assert (s_av["inner"]["phase"] == 2).all()
    assert not bool(st.s["terminated"].any())
    v = st.x["vehicle"]["dynamics"]["v_eb_b"]
    assert bool((torch.linalg.vector_norm(v, dim=-1) < 2.0).all())
    for mon in ("mon_gps", "mon_vel", "mon_baro", "mon_mag", "mon_radar"):
        assert not bool(s_av[mon]["alarm"].any()), mon
    kin = st.x["vehicle"]["kinematics"]
    d = TGDC.segment_data(M.lows_pattern()["final"],
                          Tgeo.nvector_from_qew(kin["q_ew"]), kin["h_e"])
    assert float(d.e_sb.max() - d.e_sb.min()) < 12.0
    assert float(d.s_2b.max() - d.s_2b.min()) < 150.0
