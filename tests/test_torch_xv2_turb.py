"""The turbulent C172Xv2 and a mission flown on it, of flightjax_torch
against flightjax, float64 on the CPU (the kernels' plain versions), on
inputs drawn with numpy from a seed and handed to both packages:

- the C172Xv2 on `c172x.build_xv2(turbulence=DrydenTurbulence(dt))`: the
  card's guidance scenario of `tests/test_torch_c172x2.py` (3 segment and
  3 circle lanes, one idle, one crossing the cross-track gate so that its
  vertical guidance engages inside the window) with the turbulence's trees
  at W20 = 10 m/s, the shear on one lane and a discrete gust inside the
  window on another;
- the traffic pattern's mission on the turbulent C172Xv2
  (`missions.mission_world(turbulence=)`): the mission fleet of
  `tests/test_torch_mission.py` (lanes moving to their next phase inside
  the window, one starting its engine) with the same turbulence;

each through `Simulation.fleet_step`, `make_cluster_step(split="vehicle")`
(the plain `rk4_stage_fbw_turb`, `rk4_finish_fbw_turb` and the
`gdc_ctl_laws` / `msn_ctl_laws` pass) and `make_megakernel_step` (the plain
version of `megakernel_gdc_turb` / `megakernel_msn_turb`), 5 steps against
`jax.jit(sim.fleet_step)` of the JAX world at `geoid_every=1`, every leaf
to 1e-9. One JAX compile per world.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flightjax.core.mission import MissionAvionics as JMissionAvionics
from flightjax.core.sim import SimState as JSimState
from flightjax.core.sim import Simulation as JSimulation
from flightjax.demos import c172_demos as D
from flightjax.models.c172 import c172x as Jx
from flightjax.models.c172 import c172x_gdc as JGDC
from flightjax.physics.aircraftbase import Aircraft as JAircraft
from flightjax.physics.aircraftbase import SimpleWorld as JSimpleWorld
from flightjax.physics.terrain import HorizontalTerrain as JHorizontalTerrain
from flightjax.physics.turbulence import DrydenTurbulence as JDryden

from flightjax_torch.core.modeling import tree_leaves_with_path
from flightjax_torch.core.sim import SimState, Simulation
from flightjax_torch.models.c172 import c172x as Tx
from flightjax_torch.models.c172 import c172x_ctl as TCTL
from flightjax_torch.models.c172 import missions as M
from flightjax_torch.parallel import kernels as K
from flightjax_torch.parallel.clusterstep import make_cluster_step
from flightjax_torch.parallel.megakernel import make_megakernel_step
from flightjax_torch.physics.aircraftbase import SimpleWorld
from flightjax_torch.physics.turbulence import DrydenTurbulence
from flightjax_torch.testing import turb_trees

from test_torch_c172x2 import GATE_LANE
from test_torch_c172x2 import _fleet as xv2_fleet
from test_torch_mission import CLOCK_LANE, _jax_pattern
from test_torch_mission import _fleet as msn_fleet
from test_torch_support import F64, assert_tree_close, to_jax, to_torch

TOL = 1e-9
DT = 0.02
SEED = 20261018
STEPS = 5
W20 = 10.0
SHEAR_LANE, GUST_LANE = 0, 1
PATHS = ["fleet", "vehicle", "megakernel"]


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


def _turbulent(tree):
    """numpy (t, i, x, u, s) with the turbulence's trees at W20, the shear
    on SHEAR_LANE and a discrete gust inside the window on GUST_LANE."""
    t, i, x, u, s = tree
    batch = np.shape(t)[0]
    x["vehicle"]["turb"], u["vehicle"]["turb"], s["vehicle"]["turb"] = (
        turb_trees(batch, SEED, t, i, W20, (SHEAR_LANE,), (GUST_LANE,)))
    return t, i, x, u, s


def _jax_steps(world, tree):
    """The JAX fleet step of `world` with the geoid refreshed after every
    step, STEPS times from the numpy `tree`."""
    t, i, x, u, s = tree
    av = world.aircraft.avionics
    sim = JSimulation(world, dt=DT, periodic_dt=DT, geoid_every=1)
    step = jax.jit(sim.fleet_step)
    st = JSimState(t=jnp.asarray(t), i=jnp.asarray(i), x=to_jax(x),
                   u=to_jax(dict(u, avionics=_as_jax(u["avionics"],
                                                     av.init_u()))),
                   s=to_jax(dict(s, avionics=_as_jax(s["avionics"],
                                                     av.init_s()))))
    out = []
    for _ in range(STEPS):
        st = step(st)
        out.append(jax.tree.map(np.asarray, st))
    return out


def _run(sim, tree, path, ref):
    """STEPS steps of the port's `path` from the numpy `tree`, each held to
    the JAX step `ref[k]`; returns the states."""
    t, i, x, u, s = tree
    st = SimState(t=torch.tensor(t), i=torch.tensor(i), x=to_torch(x),
                  u=to_torch(u), s=to_torch(s))
    if path == "megakernel":
        bufs, step_packed, unpack = make_megakernel_step(sim, st)
    step = (make_cluster_step(sim, st, split="vehicle") if path == "vehicle"
            else sim.fleet_step)
    K.reset_launches()
    out = []
    for k in range(STEPS):
        if path == "megakernel":
            bufs = step_packed(bufs)
            st = unpack(bufs)
        else:
            st = step(st, i=k)
        for name in ("t", "i", "x", "u", "s"):
            assert_tree_close({name: getattr(st, name)},
                              {name: getattr(ref[k], name)}, TOL,
                              f"{path} step {k}: ")
        out.append(st)
    assert not any(K.LAUNCHES.values())
    return out


# ------------------------------------------------------------ the C172Xv2

@pytest.fixture(scope="module")
def xv2_steps():
    world = JSimpleWorld(Jx.build_xv2("wa", turbulence=JDryden(DT)))
    return _jax_steps(world, _turbulent(xv2_fleet()))


@pytest.mark.parametrize("path", PATHS)
def test_turbulent_xv2_matches_jax(xv2_steps, path):
    """The turbulent C172Xv2 through each entry point (the plain versions
    of `rk4_stage_fbw_turb`, `rk4_finish_fbw_turb`, `gdc_ctl_laws` and
    `megakernel_gdc_turb`) against the JAX fleet step, every leaf after
    each of STEPS steps to 1e-9: the gate lane's vertical guidance engages
    (its longitudinal mode changes), the gust lane flies through its
    discrete gust, the drive is redrawn every step."""
    sim = Simulation(SimpleWorld(Tx.build_xv2(
        device="cpu", dtype=F64, turbulence=DrydenTurbulence(DT))),
        dt=DT, periodic_dt=DT, geoid_every=1)
    assert K.avionics_layout(sim.system.aircraft.vehicle,
                             sim.system.aircraft.avionics) is K.GDC_TURB
    tree = _turbulent(xv2_fleet())
    out = _run(sim, tree, path, xv2_steps)
    lon = [int(st.s["avionics"]["ctl"]["lon"]["mode_prev"][GATE_LANE])
           for st in out]
    assert lon[0] == TCTL.LON_DIRECT, lon
    assert lon[-1] in (TCTL.LON_EAS_ALT, TCTL.LON_THR_EAS), lon
    ug = tree[2]["vehicle"]["turb"]["ug"]
    assert float(abs(out[-1].x["vehicle"]["turb"]["ug"][GUST_LANE]
                     - ug[GUST_LANE])) > 0.0


# ------------------------------------------------------------ the mission

@pytest.fixture(scope="module")
def msn_steps():
    vehicle = Jx.build_vehicle("wa", terrain=JHorizontalTerrain(D.H_LOWS15),
                               turbulence=JDryden(DT))
    world = JSimpleWorld(JAircraft(vehicle, avionics=JMissionAvionics(
        JGDC.Avionics(), _jax_pattern())))
    return _jax_steps(world, _turbulent(msn_fleet()))


@pytest.mark.parametrize("path", PATHS)
def test_turbulent_mission_matches_jax(msn_steps, path):
    """The traffic pattern's mission on the turbulent C172Xv2 through each
    entry point (the plain versions of the turbulent whole-vehicle
    kernels, `msn_ctl_laws` and `megakernel_msn_turb`) against the JAX
    fleet step, every leaf after each of STEPS steps to 1e-9: the takeoff
    lane moves on to the departure at the first firing, the standby lane
    to the startup at the fourth and starts its engine."""
    sim = Simulation(M.mission_world(
        M.traffic_pattern_phases(), device="cpu", dtype=F64,
        turbulence=DrydenTurbulence(DT)), dt=DT, periodic_dt=DT,
        geoid_every=1)
    assert K.avionics_layout(sim.system.aircraft.vehicle,
                             sim.system.aircraft.avionics) is K.MSN_TURB
    out = _run(sim, _turbulent(msn_fleet()), path, msn_steps)
    phases = [st.s["avionics"]["phase"].tolist() for st in out]
    assert phases[0][2] == M.DEPARTURE
    assert [p[CLOCK_LANE] for p in phases] == [0, 0, 0, 1, 1]
    start = out[-1].u["vehicle"]["systems"]["pwp"]["engine"]["start"]
    assert bool(start[CLOCK_LANE])
