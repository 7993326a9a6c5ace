"""The sensor-fed C172Xv2 and the sensor-fed LOWS missions in Dryden
turbulence (`c172x.c172xv2_nav_sim(turbulence=)`, `missions.
mission_nav_sim(turbulence=)`: NavAvionics around the C172Xv2's guidance
and control laws, or around a mission over them, on the turbulent
fly-by-wire vehicle) of flightjax_torch against flightjax, float64 on the
CPU (the kernels' plain versions), on inputs drawn with numpy from a seed
and handed to both packages:

- the C172Xv2: the six guidance lanes of `tests/test_torch_xv2_nav.py` at
  sensor epochs 8..12 (the GPS, baro and mag aiding at epoch 10; the gate
  lane's vertical guidance engaging; the circle lane whose GPS is biased
  40 m on each axis, its guidance steering on an estimate tens of metres
  off the truth), in turbulence at W20 = 10 m/s, the shear on one lane
  and a discrete gust inside the window on another;
- the missions: the first eight lanes of `testing.msn_nav_operand_state(
  turbulence=True)` at step and sensor epoch 7 (each phase of both
  missions, lanes either side of the radar gate, the radar out of range on
  one), W20 = 10 m/s, the shear on every third lane, a discrete gust on
  every third lane from lane 1;

each through `Simulation.fleet_step`, `make_cluster_step(split="vehicle")`
(the plain `rk4_stage_fbw_turb`, `rk4_finish_fbw_turb`, `nav_pass` and
`gdc_ctl_laws` / `msn_nav_ctl_laws`) and `make_megakernel_step` (the plain
version of `megakernel_gdc_nav_turb` / `megakernel_msn_nav_turb`), 5 steps
against `jax.jit(sim.fleet_step)` of the JAX world at `geoid_every=1`,
built by hand on `build_vehicle(turbulence=DrydenTurbulence(dt))`, every
leaf to 1e-9. One JAX compile per world.
"""

import jax
import numpy as np
import pytest
import torch

from flightjax.core.mission import MissionAvionics as JMissionAvionics
from flightjax.core.sim import Simulation as JSimulation
from flightjax.demos import c172_demos as JD
from flightjax.models.c172 import c172x as Jx
from flightjax.models.c172 import c172x_gdc as JGDC
from flightjax.physics.aircraftbase import Aircraft as JAircraft
from flightjax.physics.aircraftbase import SimpleWorld as JSimpleWorld
from flightjax.physics.navigation import NavAvionics as JNavAvionics
from flightjax.physics.terrain import HorizontalTerrain as JHorizontalTerrain
from flightjax.physics.turbulence import DrydenTurbulence as JDryden

from flightjax_torch.bridge import tree_to_numpy
from flightjax_torch.models.c172 import c172x as Tx
from flightjax_torch.models.c172 import c172x_ctl as TCTL
from flightjax_torch.models.c172 import missions as M
from flightjax_torch.parallel import kernels as K
from flightjax_torch.parallel.megakernel import make_megakernel_step
from flightjax_torch.physics.turbulence import DrydenTurbulence
from flightjax_torch.testing import (NAV_FINAL, msn_nav_operand_state,
                                     msn_nav_phases, turb_trees)

from test_torch_c172x2 import GATE_LANE as XV2_GATE_LANE
from test_torch_msn_nav import jax_phases  # noqa: F401 (a fixture)
from test_torch_navigation import _compare, _jax_state, _port_state, _stepper
from test_torch_support import F64
from test_torch_xv2_nav import FAULT_LANE, I0, _cross_track
from test_torch_xv2_nav import _fleet as xv2_nav_fleet

DT = 0.02
STEPS = 5
B = 8
SEED = 1017
W20 = 10.0
SHEAR_LANE, GUST_LANE = 0, 1
PATHS = ["fleet", "vehicle", "megakernel"]


def _run(sim, fleet, path, ref):
    """STEPS steps of the port's `path` from the numpy `fleet`, each held
    to the JAX step `ref[k]`; returns the states."""
    st = _port_state(fleet)
    step = _stepper(sim, st, path)
    K.reset_launches()
    out = []
    for k in range(STEPS):
        st = step(st, I0 + k)
        _compare(st, ref[k], f"{path} step {k}: ")
        out.append(st)
    assert not any(K.LAUNCHES.values())
    return out


def _jax_steps(world, fleet):
    """The JAX fleet step of `world` with the geoid refreshed after every
    step, STEPS times from the numpy `fleet`."""
    sim = JSimulation(world, dt=DT, periodic_dt=DT, geoid_every=1)
    step = jax.jit(sim.fleet_step)
    st = _jax_state(*fleet, world.aircraft.avionics)
    out = []
    for _ in range(STEPS):
        st = step(st)
        out.append(jax.tree.map(np.asarray, st))
    return out


# ------------------------------------------------------------ the C172Xv2

@pytest.fixture(scope="module")
def xv2_fleet():
    """numpy (t, i, x, u, s) of the sensor-fed C172Xv2's six lanes at the
    window with the turbulence's trees at W20, the shear on SHEAR_LANE and
    a discrete gust inside the window on GUST_LANE."""
    t, i, x, u, s = xv2_nav_fleet()
    x["vehicle"]["turb"], u["vehicle"]["turb"], s["vehicle"]["turb"] = (
        turb_trees(np.shape(t)[0], SEED, t, i, W20, (SHEAR_LANE,),
                   (GUST_LANE,)))
    return t, i, x, u, s


@pytest.fixture(scope="module")
def xv2_steps(xv2_fleet):
    aircraft = Jx.build_xv2_nav("wa", periodic_dt=DT, turbulence=JDryden(DT))
    return _jax_steps(JSimpleWorld(aircraft), xv2_fleet)


@pytest.mark.parametrize("path", PATHS)
def test_turbulent_sensor_fed_xv2_matches_jax(xv2_fleet, xv2_steps, path):
    """The turbulent sensor-fed C172Xv2 through each entry point (the
    plain versions of `rk4_stage_fbw_turb`, `rk4_finish_fbw_turb`,
    `nav_pass`, `gdc_ctl_laws` and `megakernel_gdc_nav_turb`, each lane's
    pass on its own sensor epoch) against the JAX fleet step, every leaf
    after each of STEPS steps to 1e-9: the filter, the monitors, the
    turbulence's filters and drive, the guided control laws among them;
    the GPS aids on every lane, the gate lane's vertical guidance engages,
    the gust lane flies through its discrete gust, and the fault lane's
    guidance steers on its estimate, tens of metres from the truth."""
    sim0, _, _ = Tx.c172xv2_nav_sim("cpu", F64,
                                    turbulence=DrydenTurbulence(DT))
    sim = type(sim0)(sim0.system, dt=DT, periodic_dt=DT, geoid_every=1)
    assert K.avionics_layout(sim.system.aircraft.vehicle,
                             sim.system.aircraft.avionics) is K.GDC_TURB_NAV
    out = _run(sim, xv2_fleet, path, xv2_steps)
    st = out[-1]
    lon = [int(o.s["avionics"]["inner"]["ctl"]["lon"]["mode_prev"][
        XV2_GATE_LANE]) for o in out]
    assert lon[0] == TCTL.LON_DIRECT, lon
    assert lon[-1] in (TCTL.LON_EAS_ALT, TCTL.LON_THR_EAS), lon
    assert (st.s["avionics"]["nis"]["gps"] > 0).all()
    assert not st.s["avionics"]["mon_gps"]["alarm"].any()
    ug = xv2_fleet[2]["vehicle"]["turb"]["ug"]
    assert float(abs(st.x["vehicle"]["turb"]["ug"][GUST_LANE]
                     - ug[GUST_LANE])) > 0.0
    e_est, e_true = _cross_track(st, FAULT_LANE)
    e_ref, _ = _cross_track(xv2_steps[-1], FAULT_LANE)
    assert abs(e_est - e_ref) <= 1e-9 * max(1.0, abs(e_ref))
    assert abs(e_est - e_true) > 10.0, (e_est, e_true)


# ------------------------------------------------------------ the missions

@pytest.fixture(scope="module")
def msn_fleet():
    """numpy (t, i, x, u, s) of the B mode-rich mission lanes in
    turbulence at the window."""
    _, st = msn_nav_operand_state(B, SEED, "cpu", F64, i0=I0,
                                  turbulence=True)
    return tree_to_numpy(st)[:5]


@pytest.fixture(scope="module")
def msn_steps(msn_fleet, jax_phases):  # noqa: F811
    """JAX's fleet step of `_mission_world_nav` over `jax_phases`, built by
    hand on the turbulent vehicle (`c172_demos.py:413-429` with
    `build_vehicle(turbulence=DrydenTurbulence(dt))`)."""
    vehicle = Jx.build_vehicle("wa", terrain=JHorizontalTerrain(JD.H_LOWS15),
                               turbulence=JDryden(DT))
    nav = JNavAvionics(JMissionAvionics(JGDC.Avionics(), jax_phases), dt=DT,
                       use_radar=True)
    return _jax_steps(JSimpleWorld(JAircraft(vehicle, avionics=nav)),
                      msn_fleet)


@pytest.mark.parametrize("path", PATHS)
def test_turbulent_sensor_fed_missions_match_jax(msn_fleet, msn_steps,
                                                 path):
    """Both sensor-fed missions on the turbulent C172Xv2 through each entry
    point (the plain versions of the turbulent whole-vehicle kernels,
    `nav_pass`'s mission instance, `msn_nav_ctl_laws` and
    `megakernel_msn_nav_turb`) against the JAX fleet step, every leaf after
    each of STEPS steps to 1e-9: the filter, the monitors, the phase
    machine on the estimated h_o, the guided control laws, the phases'
    systems inputs and the turbulence among them. Inside the window a
    lane on the final crosses the radar gate and flares, and the lanes on
    the shear and in the discrete gusts fly through them."""
    sim = M.mission_nav_sim(msn_nav_phases(), device="cpu", dtype=F64,
                            turbulence=DrydenTurbulence(DT))
    sim.geoid_every = 1
    assert K.avionics_layout(sim.system.aircraft.vehicle,
                             sim.system.aircraft.avionics) is K.MSN_TURB_NAV
    out = _run(sim, msn_fleet, path, msn_steps)
    ph0 = torch.as_tensor(msn_fleet[4]["avionics"]["inner"]["phase"])
    ph = out[-1].s["avionics"]["inner"]["phase"]
    assert bool(((ph0 == NAV_FINAL) & (ph != ph0)).any())
    assert (out[-1].s["avionics"]["nis"]["radar"] > 0).any()
    t0 = msn_fleet[3]["vehicle"]["turb"]["gust_t0"]
    assert float(t0[GUST_LANE]) < float(out[-1].t[GUST_LANE])


def test_megakernel_buffers_roundtrip_nav_turb():
    """The turbulent sensor-fed C172Xv2's and missions' resident buffers
    (megakernel_gdc_turb's and megakernel_msn_turb's rows, then NAV_U and
    NAV_S; the int32 rows i, seed, n, then NAV_INT) round-trip through
    pack / unpack exactly, with their types, and name the instances."""
    from flightjax_torch.core.modeling import tree_leaves_with_path
    from flightjax_torch.testing import nav_operand_state
    cases = ((K.GDC_TURB_NAV, K.GDC_TURB, nav_operand_state(
        B, SEED, "cpu", F64, turbulence=True, gdc=True)),
             (K.MSN_TURB_NAV, K.MSN_TURB, msn_nav_operand_state(
                 B, SEED, "cpu", F64, turbulence=True)))
    for lay, twin, (sim, st) in cases:
        assert K.avionics_layout(sim.system.aircraft.vehicle,
                                 sim.system.aircraft.avionics) is lay
        assert lay.mega_name == twin.mega_name.replace("_turb", "_nav_turb")
        bufs, _, unpack = make_megakernel_step(sim, st)
        assert bufs[0].shape == (K.rows(lay.mega), B)
        assert K.rows(lay.mega) == K.rows(twin.mega) + K.rows(
            (K.NAV_U, K.NAV_S))
        assert bufs[1].shape == (3 + len(K.NAV_INT), B)
        back = unpack(bufs)
        pa, pb = (tree_leaves_with_path(tuple(v)) for v in (back, st))
        assert [p for p, _ in pa] == [p for p, _ in pb]
        for (p, a), (_, b) in zip(pa, pb):
            assert a.dtype == b.dtype and torch.equal(a, b), p
