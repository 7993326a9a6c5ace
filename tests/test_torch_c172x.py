"""The truth-fed C172Xv1 autopilot path of flightjax_torch against flightjax,
float64 on the CPU (the kernels' plain versions), on inputs drawn with
numpy from a seed and handed to both packages:

- `Actuator1`, `Actuator2` and `FlyByWireActuation.f_ode` to 1e-12;
- each lon and lat mode's `lon_step` / `lat_step` of `ControlLaws`, the
  port's gains from its own npz and the JAX package's from its own, to
  1e-12, on lanes with varied previous modes, saturations and controller
  states, one lane on the runway;
- `init_from_trim` at the stored trim against the JAX package's;
- the VehicleY the avionics read, as `Vehicle.output` gives it and as the
  fleet step assembles it from the finish clusters, against JAX's
  `vehicle.f_ode` at the same state, to 1e-12;
- 4 turning-climb lanes, one SAS lane and one lane that changes mode
  stepped 5 times through `Simulation.fleet_step`,
  `make_cluster_step(split="vehicle")` and `make_megakernel_step`, with
  the geoid refreshed every step, against `jax.jit(sim.fleet_step)` of the
  JAX C172Xv1 world at `geoid_every=1`, every leaf (the servo states and
  the avionics' u and s included) to 1e-9.

The JAX reference state is the stored trim (`c172xv1_trim.npz`) with the
port's trim start, whose agreement with JAX's `init_from_trim` is tested
here; JAX does not trim. Two JAX functions are compiled (the fleet step at
`geoid_every=1` and `vehicle.f_ode`; the `slow` 10 s test compiles the
fleet step at 128 too); the control-law steps run eagerly.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flightjax.core.sim import SimState as JSimState
from flightjax.core.sim import Simulation as JSimulation
from flightjax.models.c172 import c172x as Jx
from flightjax.models.c172 import c172x_ctl as JCTL
from flightjax.physics.aircraftbase import SimpleWorld as JSimpleWorld

from flightjax_torch.bridge import tree_to_numpy
from flightjax_torch.core.modeling import tree_leaves_with_path, tree_map
from flightjax_torch.core.sim import SimState
from flightjax_torch.models.c172 import c172x as Tx
from flightjax_torch.models.c172 import c172x_ctl as TCTL
from flightjax_torch.models.c172.common import (AeroY, EngineY, LdgY,
                                                StrutWow, SystemsY,
                                                ThrusterY)
from flightjax_torch.parallel import kernels as K
from flightjax_torch.parallel.clusterstep import make_cluster_step
from flightjax_torch.parallel.fleet import fleet_rollout
from flightjax_torch.physics.aircraftbase import VehicleY
from flightjax_torch.physics.atmosphere import AirData
from flightjax_torch.physics.kinematics import KinData
from flightjax_torch.testing import fbw_cluster_operands, perturbed_xv1

from test_torch_support import F64, assert_tree_close, to_jax, to_torch

TOL_OP = 1e-12
TOL = 1e-9
DT = 0.02
SEED = 20261017
B = 5
SAS_LANE = 4
STEPS = 5
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ------------------------------------------------------------ fixtures

@pytest.fixture(scope="module")
def jax_world():
    """The JAX C172Xv1 world, its jitted fleet step (geoid every 128
    steps, for the 10 s test) and its jitted vmapped `vehicle.f_ode`."""
    aircraft = Jx.build_xv1("wa")
    world = JSimpleWorld(aircraft)
    sim = JSimulation(world, dt=DT, periodic_dt=DT, geoid_every=128)
    vehicle = aircraft.vehicle
    f_ode = jax.jit(jax.vmap(lambda x, u, s: vehicle.f_ode(x, u, s, 0.0)[1]))
    return {"aircraft": aircraft, "world": world,
            "fleet_step": jax.jit(sim.fleet_step), "f_ode": f_ode}


def _as_jax_avionics(av_np, template):
    """The port's numpy avionics tree with the JAX package's NamedTuple
    classes (the leaves pair by path; both flatten dict keys sorted)."""
    leaves = tree_leaves_with_path(av_np)
    ref = jax.tree_util.tree_flatten_with_path(template)
    names = [tuple(getattr(k, "key", getattr(k, "name", None)) for k in p)
             for p, _ in ref[0]]
    assert [p for p, _ in leaves] == names
    return jax.tree_util.tree_unflatten(ref[1], [jnp.asarray(v)
                                                 for _, v in leaves])


def _jax_state(t, i, x, u, s, aircraft):
    av = aircraft.avionics
    u = dict(u, avionics=_as_jax_avionics(u["avionics"], av.init_u()))
    s = dict(s, avionics=_as_jax_avionics(s["avionics"], av.init_s()))
    return JSimState(t=jnp.asarray(t), i=jnp.asarray(i), x=to_jax(x),
                     u=to_jax(u), s=to_jax(s))


@pytest.fixture(scope="module")
def fleet():
    """The numpy fleet of the step tests: 4 turning-climb lanes, one SAS
    lane."""
    return perturbed_xv1(B, SEED, sas_lanes=(SAS_LANE,))


# ------------------------------------------------------------ sources

def _path_strings(src):
    """The string constants of a Python source that are no docstring."""
    import ast
    tree = ast.parse(src)
    docs = {id(node.body[0].value) for node in ast.walk(tree)
            if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                                 ast.AsyncFunctionDef))
            and node.body and isinstance(node.body[0], ast.Expr)
            and isinstance(node.body[0].value, ast.Constant)}
    return [node.value for node in ast.walk(tree)
            if isinstance(node, ast.Constant) and isinstance(node.value, str)
            and id(node) not in docs]


def test_port_sources_import_no_jax():
    """No module of flightjax_torch imports jax or anything of flightjax,
    and none names a path into the flightjax directory (a string that is
    no docstring and holds `flightjax` as a path component): the port
    reads its own copies of the JAX package's data."""
    bad = re.compile(r"^\s*(import|from)\s+(jax|flightjax)(\.|\s|$)", re.M)
    into = re.compile(r"(^|[/\\])flightjax([/\\]|$)")
    found = []
    for d, _, files in os.walk(os.path.join(ROOT, "flightjax_torch")):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(d, f)) as fh:
                    src = fh.read()
                if bad.search(src) or any(into.search(v)
                                          for v in _path_strings(src)):
                    found.append(os.path.join(d, f))
    assert not found, found
    # the scan sees a path built from components and one written out
    assert any(into.search(v) for v in _path_strings(
        'p = os.path.join(root, "flightjax", "data")'))
    assert any(into.search(v) for v in _path_strings(
        'p = "../flightjax/data/x.npz"'))
    assert not any(into.search(v) for v in _path_strings(
        '"""port of `flightjax/ops/geodesy.py`"""'))


def test_xv1_paths_never_import_jax():
    """Building the C172Xv1 and stepping it through both splits and the
    megakernel with the periodic pass leaves JAX out of the process."""
    import subprocess
    import sys
    code = (
        "import sys, torch\n"
        "from flightjax_torch.models.c172.c172x import c172xv1_sim, "
        "turning_climb\n"
        "from flightjax_torch.parallel.fleet import broadcast_state, "
        "fleet_rollout\n"
        "from flightjax_torch.parallel.clusterstep import make_cluster_step\n"
        "sim, st, _ = c172xv1_sim('cpu', torch.float32)\n"
        "st = turning_climb(broadcast_state(st, 4))\n"
        "a = fleet_rollout(sim, st, 2)\n"
        "b = make_cluster_step(sim, st, split='vehicle')(st, i=0)\n"
        "from flightjax_torch.parallel.megakernel import "
        "make_megakernel_step\n"
        "bufs, step, unpack = make_megakernel_step(sim, st)\n"
        "c = unpack(step(step(bufs)))\n"
        "for r in (a, b, c):\n"
        "    assert bool(torch.isfinite(r.x['vehicle']['kinematics']['h_e'])"
        ".all())\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'flightjax.')) or m == 'flightjax')\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_gains_npz_is_the_jax_one():
    with open(os.path.join(ROOT, "flightjax", "data",
                           "c172x_gains.npz"), "rb") as a, \
            open(TCTL.GAINS_NPZ, "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("name", ["egm96_ww15mgh", "c172_prop_2blade"])
def test_data_npz_is_the_jax_one(name):
    """The EGM96 grid and the propeller table the port reads are byte
    copies of the JAX package's."""
    from flightjax_torch.ops.geodesy import EGM96_PATH
    from flightjax_torch.physics.propellers import PROP_TABLE_PATH
    path = {"egm96_ww15mgh": EGM96_PATH,
            "c172_prop_2blade": PROP_TABLE_PATH}[name]
    assert os.path.realpath(path) == os.path.join(
        ROOT, "flightjax_torch", "data", name + ".npz")
    with open(os.path.join(ROOT, "flightjax", "data", name + ".npz"),
              "rb") as a, open(path, "rb") as b:
        assert a.read() == b.read()


# ------------------------------------------------------------ actuators

def _servo_inputs(rng, n=64):
    return (rng.uniform(-1.5, 1.5, n), rng.uniform(-1.5, 1.5, n),
            rng.uniform(-3.0, 3.0, n))


@pytest.mark.parametrize("kind", ["Actuator1", "Actuator2"])
def test_actuator_f_ode(kind):
    rng = np.random.default_rng(SEED)
    x, cmd, v = _servo_inputs(rng)
    rng_kw = dict(range=(-0.8, 0.9))
    got_a, ref_a = getattr(Tx, kind)(**rng_kw), getattr(Jx, kind)(**rng_kw)
    xs = {"p": x, "v": v} if kind == "Actuator2" else x
    got = got_a.f_ode(to_torch(xs), torch.as_tensor(cmd))
    ref = ref_a.f_ode(to_jax(xs), jnp.asarray(cmd))
    assert_tree_close(got, jax.tree.map(np.asarray, ref), TOL_OP)


@pytest.mark.parametrize("override", [False, True],
                         ids=["Actuator1", "Actuator2-elevator"])
def test_fly_by_wire_f_ode(override):
    rng = np.random.default_rng(SEED + 1)
    over = lambda mod: ({"elevator": mod.Actuator2(zeta=0.7)} if override
                        else None)
    got_a = Tx.FlyByWireActuation(over(Tx))
    ref_a = Jx.FlyByWireActuation(over(Jx))
    x, u = {}, {}
    for ch in Tx.ACT_CHANNELS:
        p, c, v = _servo_inputs(rng, 16)
        x[ch] = {"p": p, "v": v} if (override and ch == "elevator") else p
        u[ch] = c
    u["mixture"] = rng.uniform(-0.2, 1.2, 16)
    got = got_a.f_ode(to_torch(x), to_torch(u))
    ref = ref_a.f_ode({"act": to_jax(x)}, to_jax(u), 0.0)
    assert_tree_close(got, jax.tree.map(np.asarray, ref), TOL_OP)


def test_kernel_paths_refuse_second_order_servos():
    """A second-order rudder has a plain layout of its own (two rows, its
    instances' names tagged with the set), which the card refuses by its
    ROADMAP item: the card carries the elevator set alone; in turbulence
    the layout itself is refused."""
    from flightjax_torch.physics.turbulence import DrydenTurbulence
    vehicle = Tx.build_vehicle(device="cpu", dtype=F64,
                               actuators={"rudder": Tx.Actuator2()})
    lay = K.layout_of(vehicle)
    assert lay.a2 == ("rudder",) and lay is not K.FBW_A2
    assert K.rows(lay.x_groups) == K.rows(K.FBW.x_groups) + 1
    assert K.rows_of((lay.x_sys,), ("act", "rudder", "v")).start == \
        K.rows_of((K.X_SYS_FBW,), ("act", "rudder")).start + 1
    assert lay.mega_name == "megakernel_fbw_a2_rudder"
    for kernels in (("rk4_stage",), ("megakernel",), ("systems",)):
        why = K.a2_refusal(lay, kernels)
        assert isinstance(why, ValueError) and "ROADMAP" in str(why)
    with pytest.raises(ValueError, match="ROADMAP"):
        K.launch_kernel(lay.names["rk4_stage"], None, 0, (), {})
    turbulent = Tx.build_vehicle(device="cpu", dtype=F64,
                                 actuators={"rudder": Tx.Actuator2()},
                                 turbulence=DrydenTurbulence(DT))
    with pytest.raises(ValueError, match="ROADMAP"):
        K.layout_of(turbulent)


# ------------------------------------------------------------ primitives

@pytest.mark.parametrize("which", ["integrator", "leadlag", "pid", "lqr"])
def test_control_primitive_matches_jax(which):
    """The discrete controllers of `physics/control.py` against the JAX
    package's, with scheduled (per-lane) gains, saturated states and an
    external saturation input, to 1e-12."""
    from flightjax.physics import control as JC
    from flightjax_torch.physics import control as TC
    rng = np.random.default_rng(SEED + 5)
    n = 32
    inp = rng.normal(0.0, 2.0, n)
    sat = rng.integers(-1, 2, n).astype(np.int32)
    ext = rng.integers(-1, 2, n).astype(np.int32)
    if which == "integrator":
        x0 = rng.normal(0.0, 1.0, n)
        got = TC.integrator_step(
            TC.IntegratorState(torch.as_tensor(x0), torch.as_tensor(sat)),
            torch.as_tensor(inp), DT, -0.5, 0.7, torch.as_tensor(ext))
        ref = JC.integrator_step(
            JC.IntegratorState(jnp.asarray(x0), jnp.asarray(sat)),
            jnp.asarray(inp), DT, -0.5, 0.7, jnp.asarray(ext))
    elif which == "leadlag":
        u0, x0 = rng.normal(size=n), rng.normal(size=n)
        got = TC.leadlag_step(TC.LeadLagState(torch.as_tensor(u0),
                                              torch.as_tensor(x0)),
                              torch.as_tensor(inp), DT, -2.0, -15.0, 1.5)
        ref = JC.leadlag_step(JC.LeadLagState(jnp.asarray(u0),
                                              jnp.asarray(x0)),
                              jnp.asarray(inp), DT, -2.0, -15.0, 1.5)
    elif which == "pid":
        g = {k: rng.uniform(0.1, 2.0, n) for k in ("k_p", "k_i", "k_d",
                                                    "tau_f")}
        st = [rng.normal(size=n), rng.normal(size=n), sat]
        got = TC.pid_step(
            TC.pid_params(**{k: torch.as_tensor(v) for k, v in g.items()},
                          bound_lo=-1.0, bound_hi=1.0),
            TC.PIDState(*map(torch.as_tensor, st)), torch.as_tensor(inp),
            DT, sat_ext=torch.as_tensor(ext))
        ref = JC.pid_step(
            JC.pid_params(**{k: jnp.asarray(v) for k, v in g.items()},
                          bound_lo=-1.0, bound_hi=1.0),
            JC.PIDState(*map(jnp.asarray, st)), jnp.asarray(inp), DT,
            sat_ext=jnp.asarray(ext))
    else:
        nx, nu, nz = 8, 2, 2
        kw = dict(K_fbk=rng.normal(size=(n, nu, nx)),
                  K_fwd=rng.normal(size=(n, nu, nz)),
                  K_int=rng.normal(size=(n, nu, nz)),
                  x_trim=rng.normal(size=(n, nx)),
                  u_trim=rng.normal(size=(n, nu)),
                  z_trim=rng.normal(size=(n, nz)),
                  bound_lo=[0.0, -1.0], bound_hi=[1.0, 1.0])
        x, z, zr = (rng.normal(size=(n, m)) for m in (nx, nz, nz))
        s0 = [rng.normal(size=(n, nu)), rng.integers(-1, 2, (n, nu)).astype(
            np.int32)]
        got = TC.lqr_step(TC.lqr_params(nx, nu, nz, **kw),
                          TC.LQRState(*map(torch.as_tensor, s0)),
                          *map(torch.as_tensor, (x, z, zr)), DT,
                          sat_ext=torch.as_tensor(ext)[:, None])
        ref = JC.lqr_step(JC.lqr_params(nx, nu, nz, **kw),
                          JC.LQRState(*map(jnp.asarray, s0)),
                          *map(jnp.asarray, (x, z, zr)), DT,
                          sat_ext=jnp.asarray(ext)[:, None])
    assert_tree_close(got, jax.tree.map(np.asarray, ref), TOL_OP)


def test_schedules_match_jax(tmp_path):
    """`schedule` over a tree of Lookups, `load_schedule` of a file the JAX
    package's `save_schedule` wrote, and the control laws' fused schedule
    (which must equal the one-by-one lookups exactly) at EAS and h inside
    and outside the grid."""
    from flightjax.models.c172.c172x_design import load_gains as jgains
    from flightjax.physics import control as JC
    from flightjax_torch.physics import control as TC
    rng = np.random.default_rng(SEED + 6)
    EAS, h = rng.uniform(15.0, 65.0, 40), rng.uniform(-500.0, 4000.0, 40)
    tg, jg = TCTL.load_gains(device="cpu", dtype=F64), jgains()
    got = TC.schedule(tg, torch.as_tensor(EAS), torch.as_tensor(h))
    ref = jax.vmap(lambda e, a: JC.schedule(jg, e, a))(jnp.asarray(EAS),
                                                       jnp.asarray(h))
    assert_tree_close(got, jax.tree.map(np.asarray, ref), TOL_OP)
    fused = TCTL.FusedSchedule(tg, tuple(tg))(torch.as_tensor(EAS),
                                               torch.as_tensor(h))
    for path, leaf in tree_leaves_with_path(got):
        assert torch.equal(fused[path[0]][path[1]], leaf), path
    # a table on a grid of its own is refused, not evaluated apart
    from flightjax_torch.ops.interp import Lookup
    odd = {ch: dict(t) for ch, t in tg.items()}
    ch0 = next(iter(odd))
    lk = next(iter(odd[ch0].values()))
    odd[ch0]["k_odd"] = Lookup(
        [a.numpy() + 1.0 for a in lk.axes], lk.values.numpy(), "flat",
        device="cpu", dtype=F64)
    with pytest.raises(ValueError, match="k_odd"):
        TCTL.FusedSchedule(odd, tuple(odd))
    # a saved schedule, loaded by both packages
    like = {"k_p": 0.0, "lqr": {"K": np.zeros((2, 3))}}
    grid = {"k_p": rng.normal(size=(4, 3)),
            "lqr": {"K": rng.normal(size=(4, 3, 2, 3))}}
    axes = (np.array([20.0, 30.0, 45.0, 60.0]), np.array([0.0, 1e3, 3e3]))
    JC.save_schedule(tmp_path / "s.npz", grid, axes, ("EAS", "h"))
    got = TC.schedule(TC.load_schedule(tmp_path / "s.npz", like),
                      torch.as_tensor(EAS), torch.as_tensor(h))
    ref = jax.vmap(lambda e, a: JC.schedule(
        JC.load_schedule(tmp_path / "s.npz", like), e, a))(
        jnp.asarray(EAS), jnp.asarray(h))
    assert_tree_close(got, jax.tree.map(np.asarray, ref), TOL_OP)


def test_tree_helpers():
    from flightjax_torch.core.modeling import canonical, tree_where
    a = {"x": torch.arange(3.0), "f": torch.tensor([True, False, True]),
         "v": torch.ones(3, 2)}
    b = {"x": -torch.arange(3.0), "f": torch.tensor([False, True, False]),
         "v": torch.zeros(3, 2)}
    pred = torch.tensor([True, False, True])
    out = tree_where(pred, a, b)
    assert out["x"].tolist() == [0.0, -1.0, 2.0]
    assert out["f"].tolist() == [True, True, True]
    assert out["v"].tolist() == [[1, 1], [0, 0], [1, 1]]
    assert tree_where(pred, a, a)["x"] is a["x"]
    c = canonical({"a": 1.5, "b": (2, np.float32(3.0))})
    assert all(isinstance(l, torch.Tensor)
               for _, l in tree_leaves_with_path(c))


# ------------------------------------------------------------ VehicleY

def _y_fields(y):
    """The VehicleY fields the control laws read, as a flat dict."""
    k, sy = y.kinematics, y.systems
    return {"omega_eb_b": k.omega_eb_b, "omega_wb_b": k.omega_wb_b,
            "e_nb": k.e_nb, "h_e": k.h_e, "v_eb_n": k.v_eb_n,
            "chi_gnd": k.chi_gnd, "EAS": y.airflow.EAS,
            "alpha": sy.aero.alpha, "beta": sy.aero.beta,
            "alpha_filt": sy.aero.alpha_filt,
            "beta_filt": sy.aero.beta_filt, "n": sy.pwp.engine.n,
            "cmd": sy.act["cmd"], "pos": sy.act["pos"], "sat": sy.act["sat"],
            "wow": sy.ldg.strut.wow}


def _port_y(jy):
    """The port's VehicleY holding the fields of a (numpy) JAX one."""
    f = {k: torch.as_tensor(np.array(v)) if not isinstance(v, dict)
         else {c: torch.as_tensor(np.array(a)) for c, a in v.items()}
         for k, v in _y_fields(jy).items()}
    kin = KinData(**dict(dict.fromkeys(KinData._fields),
                         **{k: f[k] for k in ("omega_eb_b", "omega_wb_b",
                                              "e_nb", "h_e", "v_eb_n",
                                              "chi_gnd")}))
    air = AirData(**dict(dict.fromkeys(AirData._fields), EAS=f["EAS"]))
    sys_ = SystemsY(act={"cmd": f["cmd"], "pos": f["pos"], "sat": f["sat"]},
                    aero=AeroY(f["alpha"], f["beta"], f["alpha_filt"],
                               f["beta_filt"]),
                    ldg=LdgY(strut=StrutWow(wow=f["wow"])),
                    pwp=ThrusterY(engine=EngineY(n=f["n"])))
    return VehicleY(systems=sys_, kinematics=kin, dynamics=None,
                    airflow=air)


@pytest.fixture(scope="module")
def vehicle_states(jax_world, fleet):
    """The fleet's vehicle (x, u, s) with a lane on the runway, and JAX's
    VehicleY there."""
    _, _, x, u, s = perturbed_xv1(6, SEED + 2, ground_lanes=(2,))
    xv, uv, sv = x["vehicle"], u["vehicle"], s["vehicle"]
    jy = jax.tree.map(np.asarray, jax_world["f_ode"](
        to_jax(xv), to_jax(uv), to_jax(sv)))
    return xv, uv, sv, jy


def test_vehicle_output_matches_jax_f_ode(vehicle_states):
    xv, uv, sv, jy = vehicle_states
    veh = Tx.build_vehicle(device="cpu", dtype=F64)
    got = veh.output(to_torch(xv), to_torch(uv), to_torch(sv))
    assert_tree_close(_y_fields(got), _y_fields(jy), TOL_OP)
    assert jy.systems.ldg.strut.wow[2].any()  # the runway lane
    assert not jy.systems.ldg.strut.wow[[0, 1, 3]].any()


def test_finish_vehicle_y_matches_jax_f_ode(jax_world):
    """The VehicleY the fleet step assembles from the finish clusters
    (finish_kin's KinData and AirData, finish_sys's airflow angles and
    weight on wheels, the state's own fields) at the finish's new state,
    against JAX's `vehicle.f_ode` there; lanes on the runway, one
    terminated, one crashing."""
    d = fbw_cluster_operands(8, SEED, (3, 6), (5,), (1,))
    veh = Tx.build_vehicle(device="cpu", dtype=F64)
    args = K.operand_args(d, veh, "cpu", F64)["rk4_finish"]
    xv2, _, _, _, kin_y, sys_y = K.finish_clusters(K.PLAIN, *args)
    uv, sv = args[3], args[4]
    got = K.vehicle_y(veh, xv2, uv, kin_y, sys_y)
    x_np = tree_to_numpy(xv2)
    jy = jax.tree.map(np.asarray, jax_world["f_ode"](
        to_jax(x_np), to_jax(tree_to_numpy(uv)), to_jax(tree_to_numpy(sv))))
    assert_tree_close(_y_fields(got), _y_fields(jy), TOL_OP)
    on_gnd = sys_y["wow"].any(dim=-1)
    assert on_gnd.any() and not on_gnd.all()


# ------------------------------------------------------------ control laws

def _ctl_inputs(seed, mode, lon, y):
    """numpy (s, u) of the lon or lat pass at the trim start, spread: the
    previous mode of each lane differs, the saturation flags, integrators
    and PID states are drawn, and the altitude reference sits on either
    side of the acquire / hold thresholds."""
    st = Tx.trimmed_xv1_state(DT, F64, "cpu")
    key = "lon" if lon else "lat"
    s1 = tree_to_numpy(st.s["avionics"][key])
    u1 = tree_to_numpy(st.u["avionics"][key])
    n = y.airflow.EAS.shape[0]
    rng = np.random.default_rng(seed)
    s = tree_map(lambda l: np.broadcast_to(l, (n,) + l.shape).copy(), s1)
    u = tree_map(lambda l: np.broadcast_to(l, (n,) + l.shape).copy(), u1)
    n_modes = 9 if lon else 5
    s["mode_prev"] = np.arange(mode, mode + n).astype(np.int32) % n_modes
    for k, v in s.items():
        if hasattr(v, "_fields"):  # saturation flags and controller states
            s[k] = v._replace(**{
                f: (rng.integers(-1, 2, a.shape).astype(np.int32)
                    if a.dtype.kind == "i" else rng.normal(0.0, 0.1, a.shape))
                for f, a in zip(v._fields, v)})
    u["mode_req"] = np.full(n, mode, np.int32)
    if lon:
        s["h_state"] = rng.integers(0, 2, n).astype(np.int32)
        u["h_ref"] = np.asarray(y.kinematics.h_e) + rng.choice(
            [-12.0, -9.5, -5.0, 5.0, 9.5, 12.0], n)
        u["EAS_ref"] = rng.uniform(40.0, 55.0, n)
        u["clm_ref"] = rng.uniform(-1.0, 2.0, n)
        u["throttle_offset"] = rng.uniform(-0.1, 0.1, n)
    else:
        u["chi_ref"] = rng.uniform(-4.0, 4.0, n)
        u["p_ref"] = rng.normal(0.0, 0.05, n)
        u["rudder_offset"] = rng.uniform(-0.1, 0.1, n)
    return s, u


def _ctl_pair():
    return (TCTL.ControlLaws(device="cpu", dtype=F64),
            JCTL.ControlLaws())


@pytest.mark.parametrize("mode", range(9),
                         ids=["DIRECT", "SAS", "THR_Q", "THR_THETA",
                              "THR_EAS", "EAS_Q", "EAS_THETA", "EAS_CLM",
                              "EAS_ALT"])
def test_lon_step_matches_jax(vehicle_states, jax_world, mode):
    jy = vehicle_states[3]
    s, u = _ctl_inputs(SEED + mode, mode, True, jy)
    tctl, jctl = _ctl_pair()
    js = _as_jax_avionics({"lon": s}, {"lon": jctl.init_s()["lon"]})["lon"]
    got = tctl.lon_step(to_torch(s), to_torch(u), _port_y(jy), DT)
    ref = jax.vmap(jctl.lon_step, in_axes=(0, 0, 0, None))(
        js, to_jax(u), to_jax(jy), DT)
    assert_tree_close(got, jax.tree.map(np.asarray, ref), TOL_OP)


@pytest.mark.parametrize("mode", range(5),
                         ids=["DIRECT", "SAS", "P_BETA", "PHI_BETA",
                              "CHI_BETA"])
def test_lat_step_matches_jax(vehicle_states, jax_world, mode):
    jy = vehicle_states[3]
    s, u = _ctl_inputs(SEED + 20 + mode, mode, False, jy)
    tctl, jctl = _ctl_pair()
    js = _as_jax_avionics({"lat": s}, {"lat": jctl.init_s()["lat"]})["lat"]
    got = tctl.lat_step(to_torch(s), to_torch(u), _port_y(jy), DT)
    ref = jax.vmap(jctl.lat_step, in_axes=(0, 0, 0, None))(
        js, to_jax(u), to_jax(jy), DT)
    assert_tree_close(got, jax.tree.map(np.asarray, ref), TOL_OP)


def test_aircraft_init_matches_jax(jax_world):
    """The avionics' initial inputs and state `Aircraft.init_u` / `init_s`
    add to the vehicle's, against the JAX package's, for one aircraft and
    for a fleet of 3."""
    aircraft = Tx.build_xv1(device="cpu", dtype=F64)
    ref_u = jax_world["aircraft"].init_u()["avionics"]
    ref_s = jax_world["aircraft"].init_s()["avionics"]
    for shape in ((), (3,)):
        got_u = aircraft.init_u({}, shape)
        got_s = aircraft.init_s({}, shape)
        assert set(got_u) == set(got_s) == {"vehicle", "avionics"}
        want = jax.tree.map(lambda l: np.broadcast_to(
            np.asarray(l), shape + np.shape(l)), {"u": ref_u, "s": ref_s})
        assert_tree_close({"u": got_u["avionics"], "s": got_s["avionics"]},
                          want, 0.0)


def test_init_from_trim_matches_jax(jax_world):
    """The avionics' bumpless start at the stored trim: inputs and states
    as the JAX package's `init_from_trim` gives them at its own VehicleY
    there (JAX's `trim_world` without the trim)."""
    x, u, s, _, _ = Tx.load_xv1_state()
    aircraft = jax_world["aircraft"]
    one = lambda tree: tree_map(lambda l: np.asarray(l)[None], tree)
    jy = jax_world["f_ode"](to_jax(one(x["vehicle"])),
                            to_jax(one(u["vehicle"])),
                            to_jax(one(s["vehicle"])))
    jy = jax.tree.map(lambda l: l[0], jy)
    ref_u, ref_s = aircraft.avionics.init_from_trim(jy, DT)
    st = Tx.trimmed_xv1_state(DT, F64, "cpu")
    assert_tree_close({"u": st.u["avionics"], "s": st.s["avionics"]},
                      jax.tree.map(np.asarray, {"u": ref_u, "s": ref_s}),
                      TOL_OP)
    assert int(st.u["avionics"]["lon"]["mode_req"]) == TCTL.LON_DIRECT


# ------------------------------------------------------------ fleet step

MODE_LANE = 5  # requests the altitude mode 11.5 m below its reference


def _mega_fleet():
    """numpy (t, i, x, u, s) of the fleet-step tests: the 4 turning-climb
    lanes and the SAS lane of `fleet`, and MODE_LANE, which requests
    `LON_EAS_ALT` (and `LAT_PHI_BETA`) with the altitude 11.5 m below its
    reference: it enters the altitude mode holding, its altitude machine
    turns to acquire past the 11 m switch point, and on the next firing it
    changes mode to `LON_THR_EAS`."""
    t, i, x, u, s = perturbed_xv1(B + 1, SEED, sas_lanes=(SAS_LANE,))
    lon, lat = u["avionics"]["lon"], u["avionics"]["lat"]
    lon["mode_req"][MODE_LANE] = TCTL.LON_EAS_ALT
    lon["h_ref"][MODE_LANE] = x["vehicle"]["kinematics"]["h_e"][
        MODE_LANE] + 11.5
    lat["mode_req"][MODE_LANE] = TCTL.LAT_PHI_BETA
    return t, i, x, u, s


@pytest.fixture(scope="module")
def jax_steps(jax_world):
    """The JAX fleet step with the geoid refreshed after every step
    (`fleet_step(geoid_every=1)`: the order of the JAX megakernel, whose
    pass reads the undulation from before the refresh), STEPS times from
    the megakernel's fleet; JAX's states after each step. The reference of
    the megakernel and of both splits."""
    sim = JSimulation(jax_world["world"], dt=DT, periodic_dt=DT,
                      geoid_every=1)
    step = jax.jit(sim.fleet_step)
    st = _jax_state(*_mega_fleet(), jax_world["aircraft"])
    out = []
    for _ in range(STEPS):
        st = step(st)
        out.append(jax.tree.map(np.asarray, st))
    return out


@pytest.mark.parametrize("split", ["subsystems", "vehicle"])
def test_fleet_step_matches_jax(jax_steps, split):
    """Both splits of the C172Xv1 with the geoid refreshed every step
    against the JAX fleet step, every leaf after each of STEPS steps to
    1e-9, on the megakernel's fleet (MODE_LANE changes mode)."""
    from flightjax_torch.core.sim import Simulation
    t, i, x, u, s = _mega_fleet()
    sim0, _, _ = Tx.c172xv1_sim("cpu", F64)
    sim = Simulation(sim0.system, dt=DT, periodic_dt=DT, geoid_every=1)
    st = SimState(t=torch.tensor(t), i=torch.tensor(i), x=to_torch(x),
                  u=to_torch(u), s=to_torch(s))
    step = (make_cluster_step(sim, st, split=split) if split == "vehicle"
            else sim.fleet_step)
    K.reset_launches()
    for k in range(STEPS):
        st = step(st, i=k)
        ref = jax_steps[k]
        for name in ("t", "i", "x", "u", "s"):
            assert_tree_close({name: getattr(st, name)},
                              {name: getattr(ref, name)}, TOL,
                              f"step {k}: ")
    assert not any(K.LAUNCHES.values())
    lon = st.s["avionics"]["lon"]["mode_prev"].tolist()
    lat = st.s["avionics"]["lat"]["mode_prev"].tolist()
    assert lon == [TCTL.LON_EAS_CLM] * 4 + [TCTL.LON_SAS, TCTL.LON_THR_EAS]
    assert lat == [TCTL.LAT_CHI_BETA] * 4 + [TCTL.LAT_SAS,
                                             TCTL.LAT_PHI_BETA]
    # the commands moved the servos
    act0, act = x["vehicle"]["systems"]["act"], st.x["vehicle"]["systems"][
        "act"]
    assert any(float((act[ch] - torch.as_tensor(act0[ch])).abs().max())
               > 1e-3 for ch in act)


def test_fleet_rollout_fires_on_the_periodic_cadence(fleet):
    """periodic_dt = 2 dt: the pass fires after every second step (the
    counter reaching a multiple of 2), so the avionics' state stands still
    after the first step and moves after the second."""
    from flightjax_torch.core.sim import Simulation
    t, i, x, u, s = fleet
    sim0, _, _ = Tx.c172xv1_sim("cpu", F64)
    sim = Simulation(sim0.system, dt=DT, periodic_dt=2 * DT,
                     geoid_every=128)
    assert sim.system.periodic_dt == 2 * DT
    st = SimState(t=torch.tensor(t), i=torch.tensor(i), x=to_torch(x),
                  u=to_torch(u), s=to_torch(s))
    a = fleet_rollout(sim, st, 1)
    assert_tree_close(a.s["avionics"], tree_to_numpy(st.s["avionics"]), 0.0)
    b = fleet_rollout(sim, a, 1)
    assert not torch.equal(b.s["avionics"]["lon"]["out"]["throttle_cmd"],
                           a.s["avionics"]["lon"]["out"]["throttle_cmd"])


def test_entry_points_refuse_what_is_not_ported(fleet):
    from flightjax_torch.core.sim import Simulation
    from flightjax_torch.parallel.megakernel import make_megakernel_step
    from flightjax_torch.physics.aircraftbase import Aircraft, SimpleWorld
    t, i, x, u, s = fleet
    sim, _, _ = Tx.c172xv1_sim("cpu", F64)
    st = SimState(t=torch.tensor(t), i=torch.tensor(i), x=to_torch(x),
                  u=to_torch(u), s=to_torch(s))
    make_megakernel_step(sim, st)  # the C172Xv1 with its control laws
    with pytest.raises(NotImplementedError, match="core/mission.py"):
        make_megakernel_step(sim, st, ("mission",))
    with pytest.raises(NotImplementedError, match="core/mission.py"):
        sim.fleet_step(st, ("mission",), i=0)
    # a second-order servo under the C172Xv2's guidance (ROADMAP Queue 2),
    # the subsystems split's instances over the elevator servo on the card,
    # and avionics other than the C172X's control laws, guidance and
    # missions over them have no kernel
    servo2 = Simulation(SimpleWorld(Tx.build_xv2(
        device="cpu", dtype=F64, actuators={"elevator": Tx.Actuator2()})))
    with pytest.raises(ValueError, match="Actuator2"):
        make_megakernel_step(servo2, st)
    why = K.a2_refusal(K.FBW_A2, ("systems", "finish_sys"))
    assert isinstance(why, NotImplementedError)
    assert all(n in str(why) for n in ("systems_fbw_a2", "finish_sys_fbw_a2",
                                       "ROADMAP Queue 2"))
    assert K.a2_refusal(K.FBW_A2, ("rk4_stage", "rk4_finish",
                                   "megakernel")) is None

    class Guidance:
        pass
    other = Simulation(SimpleWorld(Aircraft(sim.system.aircraft.vehicle,
                                            Guidance())))
    with pytest.raises(NotImplementedError, match="have no kernel"):
        make_megakernel_step(other, st)
    # the splits' periodic pass is the `ctl_laws`, `gdc_ctl_laws` or
    # `msn_ctl_laws` kernel
    with pytest.raises(NotImplementedError, match="have no kernel"):
        other.fleet_step(st, i=0)
    with pytest.raises(NotImplementedError, match="have no kernel"):
        make_cluster_step(other, st, split="vehicle")(st, i=0)
    # a mission of arbitrary callables (over the control laws) flies the
    # plain path only
    from flightjax_torch.core.mission import MissionAvionics, Phase
    hold = Phase("hold", lambda u, y, t: u, lambda y, t: torch.tensor(False))
    mission = Simulation(SimpleWorld(Aircraft(
        sim.system.aircraft.vehicle,
        MissionAvionics(sim.system.aircraft.avionics, [hold]))))
    with pytest.raises(NotImplementedError, match="c172x_gdc.Avionics"):
        make_megakernel_step(mission, st)

    class Nav:  # avionics that read the terrain fly on the plain path
        needs_terrain = True
    other = Simulation(SimpleWorld(Aircraft(sim.system.aircraft.vehicle,
                                            Nav())))
    with pytest.raises(NotImplementedError, match="have no kernel"):
        make_cluster_step(other, st, split="vehicle")(st, i=0)
    from flightjax_torch.models.c172.c172s import build_vehicle as c172s
    with pytest.raises(NotImplementedError, match="fly-by-wire"):
        Aircraft(c172s(device="cpu", dtype=F64),
                 sim.system.aircraft.avionics)


# ------------------------------------------------------------ megakernel

def test_megakernel_step_matches_jax(jax_steps):
    """`make_megakernel_step` of the C172Xv1 (its plain version on CPU
    tensors) against the JAX fleet step with the geoid refreshed every
    step, every leaf (servos, commands and the avionics' u and s among
    them) after each of STEPS steps to 1e-9; MODE_LANE changes mode."""
    from flightjax_torch.parallel.megakernel import make_megakernel_step
    t, i, x, u, s = _mega_fleet()
    sim, _, _ = Tx.c172xv1_sim("cpu", F64)
    st = SimState(t=torch.tensor(t), i=torch.tensor(i), x=to_torch(x),
                  u=to_torch(u), s=to_torch(s))
    bufs, step, unpack = make_megakernel_step(sim, st)
    K.reset_launches()
    modes = []
    for k in range(STEPS):
        bufs = step(bufs)
        got, ref = unpack(bufs), jax_steps[k]
        for name in ("t", "i", "x", "u", "s"):
            assert_tree_close({name: getattr(got, name)},
                              {name: getattr(ref, name)}, TOL,
                              f"step {k}: ")
        modes.append(int(got.s["avionics"]["lon"]["mode_prev"][MODE_LANE]))
    assert not any(K.LAUNCHES.values())
    assert modes[:2] == [TCTL.LON_EAS_ALT, TCTL.LON_THR_EAS], modes


def _leaf_list(tree):
    return [v for _, v in tree_leaves_with_path(tree)]


def test_megakernel_fires_on_the_periodic_cadence():
    """periodic_dt = 2 dt on the megakernel (port only): each lane's pass
    fires where the counter its step makes is even, so on lanes whose
    counter starts even the avionics and the commands stand still after
    the first step and move after the second, and the lanes whose counter
    starts odd do the opposite."""
    from flightjax_torch.core.sim import Simulation
    from flightjax_torch.parallel.megakernel import make_megakernel_step
    t, i, x, u, s = _mega_fleet()
    sim0, _, _ = Tx.c172xv1_sim("cpu", F64)
    sim = Simulation(sim0.system, dt=DT, periodic_dt=2 * DT,
                     geoid_every=128)
    st = SimState(t=torch.tensor(t), i=torch.tensor(i) + torch.arange(
        B + 1, dtype=torch.int32) % 2, x=to_torch(x), u=to_torch(u),
                  s=to_torch(s))
    bufs, step, unpack = make_megakernel_step(sim, st)
    states = [st]
    for _ in range(2):
        bufs = step(bufs)
        states.append(unpack(bufs))
    odd = st.i % 2 == 1
    for k in (1, 2):
        still = ~odd if k == 1 else odd
        a, b = states[k], states[k - 1]
        for la, lb in zip(_leaf_list((a.s["avionics"], a.u)),
                          _leaf_list((b.s["avionics"], b.u))):
            assert torch.equal(la[still], lb[still])
        moved = (a.s["avionics"]["lon"]["out"]["throttle_cmd"]
                 != b.s["avionics"]["lon"]["out"]["throttle_cmd"])
        assert bool(moved[~still].all())


def test_megakernel_buffers_roundtrip_xv1():
    """The fly-by-wire resident buffer (t, X, CTX, C and the avionics'
    u and s) round-trips through pack / unpack exactly, with the modes,
    the altitude machine's state and the saturation flags back as int32
    and the controller states as their NamedTuples."""
    from flightjax_torch.core.sim import comp_residuals
    from flightjax_torch.parallel.megakernel import make_megakernel_step
    from flightjax_torch.testing import xv1_operand_state
    sim, _, _ = Tx.c172xv1_sim("cpu", F64)
    st = xv1_operand_state(24, SEED, "cpu", F64, (3, 17), (5,), (11,))
    st = st._replace(c=comp_residuals(st.x, force=True))
    bufs, _, unpack = make_megakernel_step(sim, st)
    assert bufs[0].shape == (K.rows(K.FBW.mega), 24)
    back = unpack(bufs)
    pa, pb = tree_leaves_with_path(tuple(back)), tree_leaves_with_path(
        tuple(st))
    assert [p for p, _ in pa] == [p for p, _ in pb]
    for (p, a), (_, b) in zip(pa, pb):
        assert a.dtype == b.dtype and torch.equal(a, b), p
    lon = back.s["avionics"]["lon"]
    assert lon["mode_prev"].dtype == lon["te2te"].out_sat_0.dtype \
        == torch.int32
    assert type(lon["te2te"]).__name__ == "LQRState"
    again, _, _ = make_megakernel_step(sim, back)
    assert torch.equal(again[0], bufs[0]) and torch.equal(again[1], bufs[1])


def test_ctl_gains_decode_to_the_schedules():
    """Each table of the control laws' gain buffer, read back the way the
    kernels read it, gives the fused schedules' values for its channel,
    inside the (EAS, h) grid and past both ends."""
    from test_torch_support import _decode_lookup
    ctl = TCTL.ControlLaws(device="cpu", dtype=F64)
    buf = K.ctl_gains(ctl).numpy()
    ends = [int(v) for v in buf[1:len(K.CTL_TABLES)]] + [len(buf)]
    rng = np.random.default_rng(SEED)
    for EAS, h in zip(rng.uniform(15.0, 65.0, 12), rng.uniform(-500.0,
                                                               4000.0, 12)):
        fused = dict(ctl.lon_gains(torch.tensor(EAS), torch.tensor(h)),
                     **ctl.lat_gains(torch.tensor(EAS), torch.tensor(h)))
        for k, ch in enumerate(K.CTL_TABLES):
            got = _decode_lookup(buf[int(buf[k]):ends[k]], (EAS, h))
            keys = K.PID_GAINS if "k_p" in fused[ch] else K.LQR_GAINS
            want = np.concatenate([fused[ch][n].reshape(-1).numpy()
                                   for n in keys])
            np.testing.assert_allclose(got, want, rtol=1e-13, atol=1e-13)


def test_ctl_layouts_match_csrc():
    """The control laws' row maps and gain tables (`csrc/c172x_ctl.cuh`)
    against `parallel/kernels.py` and `parallel/launch.py`."""
    from flightjax_torch.parallel import launch as L
    from test_torch_support import _constexprs, _csrc, _enums
    env = _constexprs(_csrc("flight_math.cuh"), {})
    sys_src = _csrc("c172_systems.cuh")
    for members in _enums(sys_src).values():
        env.update({m: i for i, m in enumerate(members)})
    env = _constexprs(_csrc("c172x_ctl.cuh"), _constexprs(sys_src, env))
    for name, groups in (("N_ULON", (K.AV_U_LON,)),
                         ("N_ULAT", (K.AV_U_LAT,)),
                         ("N_SLON", (K.AV_S_LON,)),
                         ("N_SLAT", (K.AV_S_LAT,)), ("N_AV", K.AV_GROUPS),
                         ("N_CTLY", (K.CTL_Y,)), ("CTL_N_IN", K.CTL_IN),
                         ("CTL_N_OUT", K.CTL_OUT),
                         ("MEGA_N_ROWS_FBW", K.FBW.mega)):
        assert env[name] == K.rows(groups), name
    assert env["MG_AV_FBW"] == K.rows(K.FBW.mega[:-4])
    for prefix, group, keys in (
            ("SL_", K.AV_S_LON, {"TE2TE": ("te2te", "int_out_0"),
                                 "Q2E_INT": ("q2e_int", "x0"),
                                 "V2T_PID": ("v2t_pid", "x_i0"),
                                 "PREV_ELV": "prev_te_zref_ele",
                                 "OUT_THR": ("out", "throttle_cmd")}),
            ("SA_", K.AV_S_LAT, {"PB2AR": ("pb2ar", "int_out_0"),
                                 "CHI2PHI_PID": ("chi2phi_pid", "x_i0"),
                                 "OUT_RUD": ("out", "rudder_cmd")}),
            ("UL_", K.AV_U_LON, {"EAS_REF": "EAS_ref", "H_REF": "h_ref"}),
            ("UA_", K.AV_U_LAT, {"CHI_REF": "chi_ref"}),
            ("CY_", K.CTL_Y, {"CHI": "chi_gnd", "N": "n",
                              "CMD": ("cmd", "aileron"),
                              "POS": ("pos", "aileron"), "WOW": "wow"})):
        for name, key in keys.items():
            assert env[prefix + name] == K.rows_of((group,), key).start, name
    assert [env["CC_" + c] for c in ("AIL", "ELV", "RUD", "THR")] == list(
        range(len(K.CTL_CMD)))
    assert env["N_GAIN_TABLES"] == len(K.CTL_TABLES) == L.N_GAIN_TABLES
    assert [env["GT_" + c] for c in ("V2T", "C2THETA", "Q2E", "TE2TE",
                                     "TV2TE", "VH2TE", "P2PHI", "CHI2PHI",
                                     "AR2AR", "PB2AR")] == list(range(10))


def test_entry_points_default_to_the_card():
    import inspect
    from flightjax_torch.models.c172.c172s import flagship_sim
    for fn in (flagship_sim, Tx.c172xv1_sim, Tx.c172xv2_sim):
        assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_fbw_layouts_match_csrc():
    """The fly-by-wire instances' row maps, servo parameters and channel
    order (`csrc/c172_systems.cuh`) against `parallel/kernels.py`."""
    from test_torch_support import _constexprs, _csrc, _enums
    src = _csrc("c172_systems.cuh")
    enums = _enums(src)
    env = _constexprs(_csrc("flight_math.cuh"), {})
    for members in enums.values():
        env.update({m: i for i, m in enumerate(members)})
    env = _constexprs(src, env)
    lay = K.FBW
    for name, groups in (("SYS_N_IN_FBW", lay.sys_in),
                         ("SYS_N_OUT_FBW", lay.sys_out),
                         ("FSYS_N_IN_FBW", lay.fsys_in),
                         ("FSYS_N_OUT_FBW", lay.fsys_out),
                         ("N_X_FBW", lay.x_groups),
                         ("N_CTX_FBW", lay.ctx_groups),
                         ("STAGE_N_IN_FBW", lay.stage_in),
                         ("STAGE_N_OUT_FBW", lay.stage_out),
                         ("RKFIN_N_IN_FBW", lay.rkfin_in),
                         ("RKFIN_N_OUT_FBW", lay.rkfin_out),
                         ("N_SYSY", (K.SYS_Y,)), ("N_KINY", (K.KIN_Y,))):
        assert env[name] == K.rows(groups), name
    assert env["N_XSYS_FBW"] == K.rows((K.X_SYS_FBW,))
    assert env["N_USYS_FBW"] == K.rows((K.U_SYS_FBW,))
    # the servo rows in channel order, the commands with the mixture
    chans = [c for c in ("AIL", "BRK_L", "BRK_R", "ELV", "FLAPS", "RUD",
                         "THR")]
    assert [env["CH_" + c] for c in chans] == list(range(env["N_ACT"]))
    assert len(K.FBW_CHANNELS) == env["N_ACT"]
    assert K.rows_of((K.X_SYS_FBW,), ("act", "aileron")).start == env[
        "XS_ACT"]
    assert K.FBW_CMD_KEYS.index("mixture") == env["UF_MIX"]
    assert K.rows_of((K.U_SYS_FBW,), ("pwp", "engine", "mixture")).start \
        == env["UF_E_MIX"]
    assert K.rows_of((K.U_SYS_FBW,), ("pld", "pilot")).start == env["UF_PLD"]
    assert [m[3:] for m in enums["ActP"][:-1]] == list(K.ACT_P)
    # the buffer: head, table offsets, the servos, the tables
    veh = Tx.build_vehicle(device="cpu", dtype=F64)
    buf = K.system_params(veh)
    assert env["P_HEAD_FBW"] == env["P_HEAD"] + len(K.param_act(veh))
    assert buf[env["P_ACT"]:env["P_HEAD_FBW"]].tolist() == K.param_act(veh)
    assert buf[env["P_ACT"] + 5 * 3 + 1] == -1.0  # rudder lo


@pytest.mark.slow
def test_fleet_step_matches_jax_over_10s(jax_world):
    """256 turning-climb lanes over 500 steps (10 s of the closed loop)
    through `Simulation.fleet_step` against JAX's, every leaf to 1e-9 (about
    100 s on the CPU)."""
    t, i, x, u, s = perturbed_xv1(256, 1016)
    js = _jax_state(t, i, x, u, s, jax_world["aircraft"])
    for _ in range(500):
        js = jax_world["fleet_step"](js)
    sim, _, _ = Tx.c172xv1_sim("cpu", F64)
    st = fleet_rollout(sim, SimState(t=torch.tensor(t), i=torch.tensor(i),
                                     x=to_torch(x), u=to_torch(u),
                                     s=to_torch(s)), 500)
    ref = jax.tree.map(np.asarray, js)
    for name in ("t", "i", "x", "u", "s"):
        assert_tree_close({name: getattr(st, name)},
                          {name: getattr(ref, name)}, TOL)
