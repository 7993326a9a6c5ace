"""The sensor-fed C172Xv2 (`c172x.build_xv2_nav`: NavAvionics around its
guidance and control laws, which read the filter's estimates) of
flightjax_torch against flightjax, float64 on the CPU (the kernels' plain
versions), on inputs drawn with numpy from a seed and handed to both
packages:

- the card's guidance scenario of `tests/test_torch_c172x2.py` (3 segment
  and 3 circle lanes, one idle, one crossing the cross-track gate so that
  its vertical guidance engages inside the window) on the navigation
  avionics: each lane's filter origin and baro datum at its own fix, its
  own sensor seed, the window at sensor epochs 8..12 (the GPS, baro and
  mag aiding at epoch 10); on one circle lane a GPS bias fault of 40 m on
  each axis, which its filter has absorbed, so that its estimated position
  lies 69 m off the truth;
- through `Simulation.fleet_step`, `make_cluster_step(split="vehicle")`
  (the plain `rk4_stage_fbw`, `rk4_finish_fbw`, `nav_pass` and
  `gdc_ctl_laws`) and `make_megakernel_step` (the plain version of
  `megakernel_gdc_nav`), 5 steps against `jax.jit(sim.fleet_step)` of the
  JAX world at `geoid_every=1`, every leaf to 1e-9; the fault lane's
  guidance reads its estimate: its circle's cross-track error from the
  estimated position follows JAX's and lies tens of metres from the
  truth's;
- `slow`: the 60 s loiter on estimates of `tests/test_navigation.py:
  276-327` through the port's `Simulation.fleet_step`, held to that test's
  assertions.

One JAX compile (the fleet step).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flightjax.core.sim import Simulation as JSimulation
from flightjax.models.c172 import c172x as Jx
from flightjax.physics.aircraftbase import SimpleWorld as JSimpleWorld

from flightjax_torch.bridge import tree_to_numpy
from flightjax_torch.core.sim import Simulation
from flightjax_torch.models.c172 import c172x as Tx
from flightjax_torch.models.c172 import c172x_ctl as TCTL
from flightjax_torch.models.c172 import c172x_gdc as TGDC
from flightjax_torch.ops import geodesy as Tgeo
from flightjax_torch.parallel import fleet
from flightjax_torch.parallel import kernels as K
from flightjax_torch.parallel.megakernel import make_megakernel_step
from flightjax_torch.physics import navigation as TN
from flightjax_torch.physics.sensors import pressure_altitude

from test_torch_c172x2 import GATE_LANE
from test_torch_c172x2 import _fleet as xv2_fleet
from test_torch_navigation import _compare, _jax_state, _port_state, _stepper
from test_torch_support import F64, to_torch

DT = 0.02
STEPS = 5
# the window: steps 7..11 make the sensor epochs 8..12, the GPS, baro and
# mag all aiding at epoch 10
I0 = 7
# the circle lane whose GPS is biased by FAULT_BIAS m on each axis from the
# first epoch, its filter's position off the truth by as much
FAULT_LANE, FAULT_BIAS = 4, 40.0
SEED_BASE = 1000


def _fleet():
    """numpy (t, i, x, u, s) of the sensor-fed C172Xv2 fleet: the C172Xv2
    scenario's lanes (`test_torch_c172x2._fleet`) with the navigation
    avionics of the trimmed start (`c172x.c172xv2_nav_sim`), each lane's
    origin and baro datum at its own fix, its own sensor seed, at step and
    sensor epoch I0, and the GPS bias fault on FAULT_LANE."""
    t, i, x, u, s = xv2_fleet()
    B = np.shape(t)[0]
    sim, st1, _ = Tx.c172xv2_nav_sim("cpu", F64)
    nav_st = tree_to_numpy(fleet.broadcast_state(st1._replace(c=None), B))
    u_av, s_av = nav_st.u["avionics"], nav_st.s["avionics"]
    u_av["inner"], s_av["inner"] = u["avionics"], s["avionics"]
    vehicle = sim.system.aircraft.vehicle
    y = vehicle.output(*(to_torch(tree["vehicle"]) for tree in (x, u, s)))
    kin, air = y.kinematics, y.airflow
    qnh = torch.as_tensor(u_av["sens"]["params"]["baro"]["qnh"])
    u_av["origin"].update(
        lat0=kin.lat.numpy(), lon0=kin.lon.numpy(), h0=kin.h_e.numpy(),
        baro_datum=(pressure_altitude(air.p) - pressure_altitude(qnh)
                    - kin.h_e).numpy())
    u_av["sens"]["seed"] = (SEED_BASE + np.arange(B)).astype(np.int32)
    f = u_av["fault"]
    f["channel"][FAULT_LANE] = TN.FAULT_GPS
    f["mode"][FAULT_LANE] = TN.MODE_BIAS
    f["k0"][FAULT_LANE] = 0
    f["delta"][FAULT_LANE] = FAULT_BIAS
    p_n = s_av["nav"].p_n.copy()
    p_n[FAULT_LANE] += FAULT_BIAS
    s_av["nav"] = s_av["nav"]._replace(p_n=p_n)
    s_av["sens"]["n"][:] = I0
    return (np.full_like(t, I0 * DT), np.full_like(i, I0), x,
            dict(u, avionics=u_av), dict(s, avionics=s_av))


def _sim():
    sim0, _, _ = Tx.c172xv2_nav_sim("cpu", F64)
    return Simulation(sim0.system, dt=DT, periodic_dt=DT, geoid_every=1)


@pytest.fixture(scope="module")
def jax_steps():
    """The JAX fleet step of `build_xv2_nav` with the geoid refreshed
    after every step, STEPS times from `_fleet`."""
    aircraft = Jx.build_xv2_nav("wa", periodic_dt=DT)
    sim = JSimulation(JSimpleWorld(aircraft), dt=DT, periodic_dt=DT,
                      geoid_every=1)
    step = jax.jit(sim.fleet_step)
    st = _jax_state(*_fleet(), aircraft.avionics)
    out = []
    for _ in range(STEPS):
        st = step(st)
        out.append(jax.tree.map(np.asarray, st))
    return out


def _cross_track(st, lane):
    """(estimated, true) cross-track error of `lane` from its circle: from
    the filter's position (the estimated n-vector and height the guidance
    reads, `NavAvionics.nav_pass`) and from the truth's."""
    t = lambda v: torch.tensor(np.array(v))
    u_av, s_av = st.u["avionics"], st.s["avionics"]
    org, p_n = u_av["origin"], t(s_av["nav"].p_n)[lane]
    lat0, lon0, h0 = (t(org[k])[lane] for k in ("lat0", "lon0", "h0"))
    M, N = Tgeo.radii(Tgeo.nvector_from_latlon(lat0, lon0))
    n_est = Tgeo.nvector_from_latlon(lat0 + p_n[0] / (M + h0),
                                     lon0 + p_n[1] / ((N + h0)
                                                      * torch.cos(lat0)))
    orbit = TGDC.Circle(*(t(v)[lane] for v in u_av["inner"]["gdc"]["orbit"]))
    kin = st.x["vehicle"]["kinematics"]
    n_true = Tgeo.nvector_from_qew(t(kin["q_ew"])[lane])
    return (float(TGDC.circle_data(orbit, n_est, h0 - p_n[2]).e_cb),
            float(TGDC.circle_data(orbit, n_true, t(kin["h_e"])[lane]).e_cb))


@pytest.mark.parametrize("path", ["fleet", "vehicle", "megakernel"])
def test_sensor_fed_xv2_matches_jax(jax_steps, path):
    """The sensor-fed C172Xv2 through `Simulation.fleet_step`,
    `make_cluster_step(split="vehicle")` and `make_megakernel_step` (the
    plain version of `megakernel_gdc_nav`, each lane's pass on its own
    sensor epoch) against the JAX fleet step, every leaf after each of
    STEPS steps to 1e-9: the filter, the monitors and the guided control
    laws among them; the GPS aids at the third step on every lane, the
    gate lane's vertical guidance engages, and the fault lane's guidance
    steers on its estimate, tens of metres from the truth."""
    sim = _sim()
    assert K.avionics_layout(sim.system.aircraft.vehicle,
                             sim.system.aircraft.avionics) is K.GDC_NAV
    st = _port_state(_fleet())
    step = _stepper(sim, st, path)
    K.reset_launches()
    lon = []
    for k in range(STEPS):
        st = step(st, I0 + k)
        _compare(st, jax_steps[k], f"{path} step {k}: ")
        lon.append(int(st.s["avionics"]["inner"]["ctl"]["lon"]["mode_prev"][
            GATE_LANE]))
    assert not any(K.LAUNCHES.values())
    assert (st.s["avionics"]["nis"]["gps"] > 0).all()
    assert lon[0] == TCTL.LON_DIRECT, lon
    assert lon[-1] in (TCTL.LON_EAS_ALT, TCTL.LON_THR_EAS), lon
    assert not st.s["avionics"]["mon_gps"]["alarm"].any()
    e_est, e_true = _cross_track(st, FAULT_LANE)
    ref = jax_steps[-1]
    e_ref, _ = _cross_track(ref, FAULT_LANE)
    assert abs(e_est - e_ref) <= 1e-9 * max(1.0, abs(e_ref))
    assert abs(e_est - e_true) > 10.0, (e_est, e_true)


def test_megakernel_buffers_roundtrip_xv2_nav():
    """The sensor-fed C172Xv2's resident buffers (megakernel_gdc's rows,
    then NAV_U and NAV_S; the step counter and NAV_INT) round-trip through
    pack / unpack exactly, with their types; the turbulent sensor-fed
    C172Xv2 has its instance, megakernel_gdc_nav_turb."""
    from flightjax_torch.core.modeling import tree_leaves_with_path
    from flightjax_torch.physics.turbulence import DrydenTurbulence
    sim = _sim()
    st = _port_state(_fleet())
    bufs, _, unpack = make_megakernel_step(sim, st)
    assert bufs[0].shape == (K.rows(K.GDC_NAV.mega), 6)
    assert bufs[1].shape == (1 + len(K.NAV_INT), 6)
    back = unpack(bufs)
    pa, pb = (tree_leaves_with_path(tuple(v)) for v in (back, st))
    assert [p for p, _ in pa] == [p for p, _ in pb]
    for (p, a), (_, b) in zip(pa, pb):
        assert a.dtype == b.dtype and torch.equal(a, b), p
    turb = Tx.build_xv2_nav(device="cpu", dtype=F64,
                            turbulence=DrydenTurbulence(DT))
    lay = K.avionics_layout(turb.vehicle, turb.avionics)
    assert lay is K.GDC_TURB_NAV
    assert lay.mega_name == "megakernel_gdc_nav_turb"
    assert K.rows(lay.mega) == K.rows(K.GDC_NAV.mega) + K.rows(
        K.GDC_TURB.mega) - K.rows(K.GDC.mega)


@pytest.mark.slow
def test_guided_loiter_on_estimates():
    """`tests/test_navigation.py:276-327` on the port's plain path: the
    trimmed sensor-fed C172Xv2 on circular guidance over the filter's
    solution (`testing.loiter_fleet_sim`: a 1500 m circle centred 2000 m
    north of the start, EAS_ref 40 m/s), 60 s through
    `Simulation.fleet_step`: not terminated, altitude within 10 m, the
    final radial error under 0.7 of the start's, no GPS or baro alarm."""
    from flightjax_torch.testing import LOITER_STEPS, loiter_fleet_sim
    sim, st, orbit = loiter_fleet_sim(1, "cpu", F64)
    orbit = TGDC.Circle(*(v[None] for v in orbit))

    def e_cb(st):
        kin = st.x["vehicle"]["kinematics"]
        return float(TGDC.circle_data(orbit, Tgeo.nvector_from_qew(
            kin["q_ew"]), kin["h_e"]).e_cb[0])
    h0, d0 = float(st.x["vehicle"]["kinematics"]["h_e"][0]), e_cb(st)
    alarms = torch.zeros(1, dtype=torch.bool)
    for i in range(LOITER_STEPS):
        st = sim.fleet_step(st, i=i)
        s_av = st.s["avionics"]
        alarms |= s_av["mon_gps"]["alarm"] | s_av["mon_baro"]["alarm"]
    assert not bool(st.s["terminated"].any())
    assert abs(float(st.x["vehicle"]["kinematics"]["h_e"][0]) - h0) < 10.0
    assert abs(e_cb(st)) < abs(d0) * 0.7, (d0, e_cb(st))
    assert not bool(alarms.any())
