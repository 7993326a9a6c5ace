"""The sensor-fed navigation fleet of flightjax_torch against flightjax,
float64 on the CPU (the kernels' plain versions), on inputs drawn with numpy
from a seed and handed to both packages:

- the sensors' stream: the keys and float32 uniforms exactly, and the
  float32 normals (`ops.random.normal_f32`) bit for bit, for seeds and
  epochs above 2^24; `SensorSuite.draws` in both tags;
- `pressure_altitude`, the geomagnetic fields, `cas_from_pressures`,
  `estimate_airspeed`, `SensorSuite.f_step` and `measure` (noisy and exact
  grades, the radar on and off the ground) to 1e-12;
- the small solves, `nis`, `attitude_error_deg`, `ned_from_geodetic`, each
  `InsGps` method, `update_stacked` under every combination of its channel
  masks, an `innovation_monitor` across its latch and every fault mode of
  `apply_faults` to 1e-12;
- `NavAvionics.f_periodic` at B = 4 on an aiding epoch and off one (the
  port skipping the block, as the gated reference does), in shadow mode,
  with the synthetic airflow angles and with the radar aiding, to 1e-12;
  the host's epoch gate against `epoch_preds` over 50 firings;
- the turbulent C172Xv1 on its control laws (the plain versions of
  `rk4_stage_fbw_turb`, `rk4_finish_fbw_turb` and `megakernel_fbw_turb`)
  through the three entry points, and the navigation fleet through
  `Simulation.fleet_step` and `make_cluster_step(split="vehicle")`, 5
  steps of 4 lanes with the shear and a discrete gust, against
  `jax.jit(sim.fleet_step)` to 1e-9 (the navigation fleet with a GPS epoch
  inside the window);
- shadow mode (`use_estimates=False`) flies the vehicle bit for bit like
  the truth-fed turbulent C172Xv1; the refusals.

The JAX references compile once each: the two fleet steps, `vehicle.f_ode`
and the pass in four settings. Starts come from `data/*.npz`, not a JAX
trim.
"""

import collections
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flightjax.core.sim import SimState as JSimState
from flightjax.core.sim import Simulation as JSimulation
from flightjax.models.c172 import c172x as Jx
from flightjax.models.c172.c172x_ctl import ControlLaws as JControlLaws
from flightjax.physics import navigation as JN
from flightjax.physics import sensors as JS
from flightjax.physics.aircraftbase import SimpleWorld as JSimpleWorld
from flightjax.physics.turbulence import DrydenTurbulence as JDryden
from flightjax.utils import estimation as JE

from flightjax_torch.bridge import tree_to_numpy
from flightjax_torch.core.modeling import tree_leaves_with_path
from flightjax_torch.core.sim import SimState
from flightjax_torch.demos.estimation_demos import nav_fleet_setup
from flightjax_torch.models.c172 import c172x as Tx
from flightjax_torch.models.c172.common import (AeroY, EngineY, LdgY,
                                                StrutWow, SystemsY,
                                                ThrusterY)
from flightjax_torch.ops import random as R
from flightjax_torch.parallel import kernels as K
from flightjax_torch.parallel.clusterstep import make_cluster_step
from flightjax_torch.parallel.megakernel import make_megakernel_step
from flightjax_torch.physics import navigation as TN
from flightjax_torch.physics import sensors as TS
from flightjax_torch.physics.aircraftbase import VehicleY
from flightjax_torch.physics.atmosphere import AirData
from flightjax_torch.physics.dynamics import DynamicsY, MassProps
from flightjax_torch.physics.kinematics import KinData
from flightjax_torch.physics.turbulence import DrydenTurbulence
from flightjax_torch.utils import estimation as TE

from test_torch_support import (F64, assert_close, assert_tree_close, to_jax,
                                to_torch)

TOL_OP = 1e-12
TOL = 1e-9
DT = 0.02
SEED = 20261017
B = 4
STEPS = 5
# the navigation fleet's window: steps 7..11 make the sensor epochs 8..12,
# the GPS, baro and mag all aiding at epoch 10
I0 = 7
SHEAR_LANE, GUST_LANE = 0, 1


# ------------------------------------------------------------ helpers

def _t(a):
    return torch.as_tensor(np.asarray(a))


def _like_template(np_tree, template):
    """The port's numpy tree as a JAX tree with the template's NamedTuple
    classes and integer types (the leaves pair by path)."""
    leaves = tree_leaves_with_path(np_tree)
    ref, treedef = jax.tree_util.tree_flatten_with_path(template)
    names = [tuple(getattr(k, "key", getattr(k, "name", None)) for k in p)
             for p, _ in ref]
    assert [p for p, _ in leaves] == names
    conv = [jnp.asarray(v, dtype=t.dtype) if t.dtype.kind in "biu"
            else jnp.asarray(v) for (_, v), (_, t) in zip(leaves, ref)]
    return jax.tree_util.tree_unflatten(treedef, conv)


def _jax_state(t, i, x, u, s, avionics):
    u = dict(u, avionics=_like_template(u["avionics"], avionics.init_u()))
    s = dict(s, avionics=_like_template(s["avionics"], avionics.init_s()))
    return JSimState(t=jnp.asarray(t), i=jnp.asarray(i), x=to_jax(x),
                     u=to_jax(u), s=to_jax(s))


def _set_window(st):
    """The fleet state at step I0 with the sensors' epoch I0, the shear on
    SHEAR_LANE and a discrete gust inside the window on GUST_LANE."""
    uv, sav = st.u["vehicle"], st.s["avionics"]
    turb = dict(uv["turb"])
    z0 = turb["shear_z0_ft"].clone()
    z0[SHEAR_LANE] = 2.0
    t0 = turb["gust_t0"].clone()
    T = turb["gust_T"].clone()
    amp = turb["gust_amp"].clone()
    t0[GUST_LANE], T[GUST_LANE] = I0 * DT + 0.015, 0.05
    amp[GUST_LANE] = torch.tensor([1.5, -2.0, 2.5], dtype=amp.dtype)
    turb.update(shear_z0_ft=z0, gust_t0=t0, gust_T=T, gust_amp=amp)
    sens = dict(sav["sens"], n=torch.full_like(sav["sens"]["n"], I0))
    return st._replace(
        t=torch.full_like(st.t, I0 * DT), i=torch.full_like(st.i, I0),
        u=dict(st.u, vehicle=dict(uv, turb=turb)),
        s=dict(st.s, avionics=dict(sav, sens=sens)))


@pytest.fixture(scope="module")
def nav_fleet():
    """The study's fleet of B lanes (`nav_fleet_setup`, PRNGKey(5)) in
    numpy at the window, and its port Simulation."""
    sim, st = nav_fleet_setup(B, key=R.PRNGKey(5), device="cpu", dtype=F64)
    return sim, tree_to_numpy(_set_window(st))[:5]


@pytest.fixture(scope="module")
def jax_nav():
    """The JAX navigation world (the study's aircraft) and its jitted
    fleet step at geoid_every = 1."""
    aircraft = Jx.build_xv1_nav("wa", periodic_dt=DT,
                                turbulence=JDryden(DT))
    sim = JSimulation(JSimpleWorld(aircraft), dt=DT, periodic_dt=DT)
    f_ode = jax.jit(jax.vmap(
        lambda x, u, s, t: aircraft.vehicle.f_ode(x, u, s, t)[1]))
    return {"aircraft": aircraft, "step": jax.jit(sim.fleet_step),
            "f_ode": f_ode}


def _jv(fn):
    """`fn` vmapped over the lanes and jitted (the references of the
    per-function checks compile in less time than they run eagerly)."""
    return jax.jit(jax.vmap(fn))


def _port_state(np_state):
    return SimState(*(to_torch(v) if isinstance(v, dict) else _t(v)
                      for v in np_state))


# ------------------------------------------------------------ the stream

def test_sensor_stream_matches_jax():
    """The sensors' keys (seeds and epochs above 2^24 among them), the
    float32 uniforms exactly, `normal_f32` bit for bit against JAX's
    float32 normals, and `SensorSuite.draws` in both tags, cast to
    float64."""
    rng = np.random.default_rng(SEED)
    seed = rng.integers(0, 2 ** 31 - 1, 64).astype(np.int32)
    n = rng.integers(0, 2 ** 31 - 1, 64).astype(np.int32)
    seed[:3], n[:3] = [0, 2 ** 24 + 1, 7], [0, 5, 2 ** 24 + 3]
    for tag, count in ((0, 9), (1, 20)):
        base = jax.random.PRNGKey(TS.KEY_BASE)
        jk = jax.vmap(lambda a, b: jax.random.fold_in(jax.random.fold_in(
            jax.random.fold_in(base, a), b), tag))(jnp.asarray(seed),
                                                   jnp.asarray(n))
        tk = R.fold_in(R.fold_in(R.fold_in(R.PRNGKey(TS.KEY_BASE),
                                           _t(seed)), _t(n)), tag)
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(
            R.normal_f32(tk, (count,)).numpy(),
            np.asarray(jax.vmap(lambda k: jax.random.normal(
                k, (count,), jnp.float32))(jk)))
        got = TS.SensorSuite.draws(_t(seed), _t(n), tag, count, F64)
        ref = jax.vmap(lambda a, b: JS.SensorSuite._draws(
            a, b, tag, count, jnp.float64))(jnp.asarray(seed),
                                            jnp.asarray(n))
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


# ------------------------------------------------------------ the sensors

Kin = collections.namedtuple("Kin", "q_eb q_nb omega_eb_b n_e lat lon h_e "
                             "h_o v_eb_n")
Air = collections.namedtuple("Air", "p pt T")
Dyn = collections.namedtuple("Dyn", "f_c_c alpha_ib_b mp_sum_b")
Mp = collections.namedtuple("Mp", "r_OG")


def _unit(rng, n, k=4):
    q = rng.normal(size=(n, k))
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _truth(rng, n):
    """Truth operands of the sensors: attitudes, rates, positions, heights
    (every ISA layer of the pressure among them), air data, dynamics."""
    lat = rng.uniform(-1.2, 1.2, n)
    lon = rng.uniform(-3.0, 3.0, n)
    n_e = np.stack([np.cos(lat) * np.cos(lon), np.cos(lat) * np.sin(lon),
                    np.sin(lat)], -1)
    h = rng.uniform(-50.0, 3000.0, n)
    p = np.exp(rng.uniform(np.log(500.0), np.log(1.1e5), n))
    kin = Kin(_unit(rng, n), _unit(rng, n), rng.normal(0, 0.2, (n, 3)), n_e,
              lat, lon, h, h - rng.uniform(-40, 40, n),
              rng.normal(0, 40, (n, 3)))
    air = Air(p, p + rng.uniform(0, 3000, n), rng.uniform(200, 310, n))
    dyn = Dyn(rng.normal(0, 5, (n, 3)), rng.normal(0, 0.5, (n, 3)),
              Mp(rng.normal(0, 0.3, (n, 3))))
    return kin, air, dyn


def _params(rng, n, exact=False):
    """Per-lane sensor grades: the catalog scaled by U(0.5, 2), hard iron,
    a lever arm and biases; or the exact suite."""
    cat = TS.exact_suite_params() if exact else TS.suite_params()
    p = tree_to_numpy(TS.param_tensors(cat, (n,), "cpu", F64))
    if not exact:
        for grp in p.values():
            for k in grp:
                if k != "B_n":
                    grp[k] = grp[k] * rng.uniform(0.5, 2.0, grp[k].shape)
        p["imu"]["r_imu_b"] = rng.normal(0, 0.5, (n, 3))
        p["mag"]["hard_iron"] = rng.normal(0, 1e-6, (n, 3))
        p["airdata"]["bias_p"] = rng.normal(0, 20.0, n)
        p["radar"]["h_max"] = np.full(n, 762.0)
    return p


@pytest.mark.parametrize("grade", ["noisy", "exact"])
def test_sensor_suite_matches_jax(grade):
    """`pressure_altitude` over every ISA layer, the fields and
    declination, `cas_from_pressures`, `f_step` and `measure` (the radar's
    ground above and below the aircraft) and `estimate_airspeed`, per lane
    against the JAX functions to 1e-12."""
    rng = np.random.default_rng(SEED + (grade == "exact"))
    n = 24
    kin, air, dyn = _truth(rng, n)
    p = _params(rng, n, grade == "exact")
    seed = rng.integers(0, 2 ** 31 - 1, n).astype(np.int32)
    s = {"b_g": rng.normal(0, 1e-3, (n, 3)), "b_a": rng.normal(0, 0.05,
                                                                (n, 3)),
         "gm_gps": rng.normal(0, 1.5, (n, 3)),
         "n": rng.integers(0, 2 ** 30, n).astype(np.int32)}
    h_trn = kin.h_o - rng.uniform(-30.0, 900.0, n)
    gps_every = 3

    pa = np.concatenate([np.exp(np.linspace(np.log(1.0), np.log(1.2e5),
                                            40)), air.p])
    assert_close(TS.pressure_altitude(_t(pa)),
                 np.asarray(JS.pressure_altitude(jnp.asarray(pa))), TOL_OP)
    assert_close(TS.mag_field_ned(), np.asarray(JS.mag_field_ned()), TOL_OP)
    assert_close(TS.mag_field_ned(4e-5, _t(kin.lat), _t(kin.lon)),
                 np.asarray(JS.mag_field_ned(4e-5, jnp.asarray(kin.lat),
                                             jnp.asarray(kin.lon))), TOL_OP)
    Bd = TS.mag_field_dipole(_t(kin.lat), _t(kin.lon), _t(kin.h_e))
    assert_close(Bd, np.asarray(JS.mag_field_dipole(
        jnp.asarray(kin.lat), jnp.asarray(kin.lon), jnp.asarray(kin.h_e))),
        1e-18)
    for a, b in zip(TS.mag_declination(Bd),
                    JS.mag_declination(jnp.asarray(Bd.numpy()))):
        assert_close(a, np.asarray(b), TOL_OP)
    assert_close(TS.cas_from_pressures(_t(air.pt), _t(air.p)),
                 np.asarray(JS.cas_from_pressures(jnp.asarray(air.pt),
                                                  jnp.asarray(air.p))),
                 TOL_OP)

    suite, jsuite = TS.SensorSuite(DT, gps_every), JS.SensorSuite(DT,
                                                                 gps_every)
    u = {"seed": seed, "params": p}
    s2 = suite.f_step(to_torch(u), to_torch(s))
    _, js2 = _jv(lambda uu, ss: jsuite.f_step(None, uu, ss, 0.0))(
        to_jax(u), to_jax(s))
    assert_tree_close(s2, jax.tree.map(np.asarray, js2), TOL_OP)
    tt = lambda nt: type(nt)(*(tt(v) if isinstance(v, tuple) else _t(v)
                               for v in nt))
    z = suite.measure(to_torch(u), s2, tt(kin), tt(air), tt(dyn),
                      _t(h_trn))
    jz = _jv(lambda uu, ss, k, a, d, h: jsuite.measure(
        uu, ss, k, a, d, h_trn=h))(to_jax(u), js2, to_jax(kin), to_jax(air),
                                   to_jax(dyn), jnp.asarray(h_trn))
    assert_tree_close(z._asdict(), jax.tree.map(np.asarray, jz._asdict()),
                      TOL_OP)
    assert z.radar_valid.any() and not z.radar_valid.all()
    assert z.gps_new.any() and not z.gps_new.all()
    for a, b in zip(TN.estimate_airspeed(z), JN.estimate_airspeed(jz)):
        assert_close(a, np.asarray(b), TOL_OP)


# ------------------------------------------------------------ estimation

def _spd(rng, n, m):
    A = rng.normal(size=(n, m, m))
    return A @ A.transpose(0, 2, 1) + m * np.eye(m)


def test_small_solves_and_helpers_match_jax():
    """`_inv3`, `_gain` for 1, 3 and 5 rows, `blocked_spd_solve` over the
    shipped partitions, `chol_solve`, `nis` for 1, 3 and 5 rows,
    `attitude_error_deg`, `ned_from_geodetic` and `masked_update`, to
    1e-12."""
    rng = np.random.default_rng(SEED + 2)
    n = 8
    S3 = _spd(rng, n, 3)
    assert_close(TE._inv3(_t(S3)), np.asarray(_jv(JE._inv3)(
        jnp.asarray(S3))), TOL_OP)
    P = _spd(rng, n, 15)
    for m in (1, 3, 5):
        H = rng.normal(size=(n, m, 15))
        S = _spd(rng, n, m)
        assert_close(TE._gain(_t(P), _t(H), _t(S)), np.asarray(_jv(
            JE._gain)(jnp.asarray(P), jnp.asarray(H), jnp.asarray(S))),
            TOL_OP)
        y = rng.normal(size=(n, m))
        assert_close(TE.nis(_t(y), _t(S)), np.asarray(_jv(JE.nis)(
            jnp.asarray(y), jnp.asarray(S))), TOL_OP)
    for sizes in ((3, 3, 1, 3), (3, 3, 1, 3, 1)):
        m = sum(sizes)
        S, Bm = _spd(rng, n, m), rng.normal(size=(n, m, 15))
        assert_close(TE.blocked_spd_solve(_t(S), _t(Bm), sizes),
                     np.asarray(_jv(lambda a, b: JE.blocked_spd_solve(
                         a, b, sizes))(jnp.asarray(S), jnp.asarray(Bm))),
                     TOL_OP)
        assert_close(TE.chol_solve(_t(S), _t(Bm)), np.asarray(_jv(
            JE.chol_solve)(jnp.asarray(S), jnp.asarray(Bm))), TOL_OP)
    qa, qb = _unit(rng, n), _unit(rng, n)
    assert_close(TE.attitude_error_deg(_t(qa), _t(qb)),
                 np.asarray(JE.attitude_error_deg(jnp.asarray(qa),
                                                  jnp.asarray(qb))), TOL_OP)
    g = [rng.uniform(-1, 1, n), rng.uniform(-3, 3, n), rng.uniform(0, 3e3, n)]
    o = [rng.uniform(-1, 1, n), rng.uniform(-3, 3, n), rng.uniform(0, 3e3, n)]
    assert_close(TE.ned_from_geodetic(*map(_t, g + o)), np.asarray(
        JE.ned_from_geodetic(*map(jnp.asarray, g + o))), TOL_OP)
    valid = rng.random(n) < 0.5
    a, b = rng.normal(size=(n, 3, 3)), rng.normal(size=(n, 3, 3))
    got = TE.masked_update(_t(valid), {"P": _t(a)}, {"P": _t(b)})
    ref = _jv(JE.masked_update)(jnp.asarray(valid),
                                     {"P": jnp.asarray(a)},
                                     {"P": jnp.asarray(b)})
    assert_tree_close(got, jax.tree.map(np.asarray, ref), 0.0)


def _filter_state(rng, n):
    return {"q_nb": _unit(rng, n), "v_n": rng.normal(0, 40, (n, 3)),
            "p_n": rng.normal(0, 300, (n, 3)),
            "b_g": rng.normal(0, 1e-3, (n, 3)),
            "b_a": rng.normal(0, 0.05, (n, 3)),
            "P": _spd(rng, n, 15) * 1e-2}


def _filters():
    kw = dict(sigma_gps_pos=1.6, sigma_baro=1.3, sigma_radar=0.5)
    return TE.InsGps(DT, **kw), JE.InsGps(DT, **kw)


def test_insgps_methods_match_jax():
    """`init`, `predict`, `predict_mean`, `accum_A`, `propagate_P`,
    `update_gps` (a valid and an invalid lane), `stacked_rows` with and
    without the radar row and `stacked_innovation`, to 1e-12."""
    rng = np.random.default_rng(SEED + 3)
    n = 6
    tf, jf = _filters()
    st_np = _filter_state(rng, n)
    st, jst = TE.InsGpsState(**to_torch(st_np)), JE.InsGpsState(
        **to_jax(st_np))
    chk = lambda a, b, what: assert_tree_close(
        a._asdict() if hasattr(a, "_asdict") else a,
        jax.tree.map(np.asarray, b._asdict() if hasattr(b, "_asdict")
                     else b), TOL_OP, what)
    chk(tf.init(st.q_nb, st.v_n, st.p_n, att_std=0.1, bg_std=6e-3),
        _jv(lambda q, v, p: jf.init(q_nb=q, v_n=v, p_n=p, att_std=0.1,
                                         bg_std=6e-3))(jst.q_nb, jst.v_n,
                                                        jst.p_n), "init ")
    om, f = rng.normal(0, 0.3, (n, 3)), rng.normal(0, 5, (n, 3))
    chk(tf.predict(st, _t(om), _t(f)),
        _jv(jf.predict)(jst, jnp.asarray(om), jnp.asarray(f)),
        "predict ")
    pm, parts = tf.predict_mean(st, _t(om), _t(f))
    jpm, jparts = _jv(jf.predict_mean)(jst, jnp.asarray(om),
                                            jnp.asarray(f))
    chk(pm, jpm, "predict_mean ")
    A = TE.InsGps.accum_A(TE.InsGps.zero_A(st.v_n), parts)
    jA = _jv(JE.InsGps.accum_A)(
        _jv(lambda _: JE.InsGps.zero_A(jnp.float64))(jnp.arange(n)),
        jparts)
    A = TE.InsGps.accum_A(A, parts)
    jA = _jv(JE.InsGps.accum_A)(jA, jparts)
    chk(A, jA, "A ")
    chk(tf.propagate_P(st, A, 2), _jv(
        lambda s, a: jf.propagate_P(s, a, 2))(jst, jA), "propagate_P ")
    pg, vg = rng.normal(0, 300, (n, 3)), rng.normal(0, 40, (n, 3))
    valid = np.arange(n) % 2 == 0
    chk(tf.update_gps(st, _t(pg), _t(vg), _t(valid)),
        _jv(jf.update_gps)(jst, jnp.asarray(pg), jnp.asarray(vg),
                                jnp.asarray(valid)), "update_gps ")
    hb, h0, hr = rng.normal(900, 30, n), rng.normal(900, 30, n), \
        rng.normal(900, 30, n)
    mag = rng.normal(0, 3e-5, (n, 3))
    Bn = rng.normal(0, 3e-5, (n, 3))
    for radar in (None, hr):
        got = tf.stacked_rows(st, _t(pg), _t(vg), _t(hb), _t(h0), _t(mag),
                              _t(Bn), None if radar is None else _t(radar))
        ref = _jv(lambda s, a, b, c, d, e, g, r: jf.stacked_rows(
            s, a, b, c, d, e, B_n=g, h_radar_e=r))(
                jst, *map(jnp.asarray, (pg, vg, hb, h0, mag, Bn)),
                None if radar is None else jnp.asarray(radar))
        chk(list(got), list(ref), "stacked_rows ")
        chk(list(TE.InsGps.stacked_innovation(st, got[0], got[2])),
            list(_jv(jf.stacked_innovation)(jst, ref[0], ref[2])),
            "stacked_innovation ")


def test_update_stacked_every_mask_matches_jax():
    """`update_stacked` with the radar row, one lane per combination of
    the four channels' masks (GPS, baro, mag, radar; all off and all on
    among them), from the shared innovation system and without it, to
    1e-12."""
    rng = np.random.default_rng(SEED + 4)
    combos = list(itertools.product((False, True), repeat=4))
    n = len(combos)
    tf, jf = _filters()
    st_np = _filter_state(rng, n)
    st, jst = TE.InsGpsState(**to_torch(st_np)), JE.InsGpsState(
        **to_jax(st_np))
    meas = [rng.normal(0, 300, (n, 3)), rng.normal(0, 40, (n, 3)),
            rng.normal(900, 3, n), rng.normal(900, 3, n),
            rng.normal(0, 3e-5, (n, 3)), rng.normal(0, 3e-5, (n, 3)),
            rng.normal(900, 3, n)]
    H, y, r = tf.stacked_rows(st, *map(_t, meas))
    mask = np.array([[g] * 6 + [b] + [m] * 3 + [rd]
                     for g, b, m, rd in combos])
    PHt, S = TE.InsGps.stacked_innovation(st, H, r)
    sizes = (3, 3, 1, 3, 1)
    jH, jy, jr, jPHt, jS = (jnp.asarray(v.numpy())
                            for v in (H, y, r, PHt, S))
    for shared in (True, False):
        got = tf.update_stacked(st, H, y, r, _t(mask),
                                *((PHt, S) if shared else (None, None)),
                                sizes=sizes)
        ref = _jv(lambda s, h, yy, rr, mm, p, ss: jf.update_stacked(
            s, h, yy, rr, mm, PHt=p if shared else None,
            S=ss if shared else None, sizes=sizes))(
                jst, jH, jy, jr, jnp.asarray(mask), jPHt, jS)
        assert_tree_close(got._asdict(), jax.tree.map(np.asarray,
                                                      ref._asdict()),
                          TOL_OP, f"shared={shared} ")
    # all masks off: the prior
    assert torch.allclose(got.P[0], st.P[0], atol=1e-15, rtol=0)


def test_innovation_monitor_latches_as_jax():
    """An `innovation_monitor` (window 6, 3 hits) over 24 epochs of NIS
    around its gate with invalid epochs among them, per lane: the bits
    and the alarm after every epoch equal JAX's, and the alarm latches on
    some lanes and stays latched."""
    rng = np.random.default_rng(SEED + 5)
    n = 8
    ti, tu = TE.innovation_monitor(16.27, window=6, min_hits=3)
    ji, ju = JE.innovation_monitor(16.27, window=6, min_hits=3)
    ts = ti(torch.zeros(n))
    js = jax.vmap(lambda _: ji())(jnp.arange(n))
    for k in range(24):
        v = rng.exponential(10.0 + 2.0 * np.arange(n), n)
        valid = rng.random(n) < 0.8
        ts, ta = tu(ts, _t(v), _t(valid))
        js, ja = jax.vmap(ju)(js, jnp.asarray(v), jnp.asarray(valid))
        np.testing.assert_array_equal(ts["bits"].numpy(),
                                      np.asarray(js["bits"]))
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    assert ta.any() and not ta.all()


def test_apply_faults_matches_jax():
    """Every fault channel (none, GPS, baro, GPS velocity, mag) in every
    mode (freeze, bias, dropout, ramp), one lane each, over the epochs
    before, at, inside and after the fault window: the hold registers and
    the faulted measurements to 1e-12, the GPS epoch flags exactly."""
    rng = np.random.default_rng(SEED + 6)
    combos = list(itertools.product(range(5), range(4)))
    n = len(combos)
    jnav = JN.NavAvionics(JControlLaws(), dt=DT)
    tnav = TN.NavAvionics(None, dt=DT, device="cpu", dtype=F64)
    fault = {"channel": np.array([c for c, _ in combos], np.int32),
             "mode": np.array([m for _, m in combos], np.int32),
             "k0": np.full(n, 3, np.int32), "k1": np.full(n, 6, np.int32),
             "delta": rng.normal(0, 2.0, n)}
    hold = {"gps_p": np.zeros((n, 3)), "gps_v": np.zeros((n, 3)),
            "h_baro": np.zeros(n), "mag": np.zeros((n, 3))}
    th, jh = to_torch(hold), to_jax(hold)
    for k in range(1, 9):
        meas = (rng.normal(0, 300, (n, 3)), rng.normal(0, 40, (n, 3)),
                rng.random(n) < 0.7, rng.normal(900, 3, n),
                rng.normal(0, 3e-5, (n, 3)))
        got = tnav.apply_faults(to_torch(fault), th, torch.full((n,), k),
                                *map(_t, meas))
        ref = jax.vmap(lambda f, h, *m: jnav._apply_faults(
            f, h, jnp.asarray(k), *m))(to_jax(fault), jh,
                                       *map(jnp.asarray, meas))
        assert_tree_close(list(got), jax.tree.map(np.asarray, list(ref)),
                          TOL_OP, f"k={k} ")
        th, jh = got[0], ref[0]


# ------------------------------------------------------------ the pass

def _port_veh_y(jy):
    """The port's VehicleY of a (numpy) JAX one: whole KinData and
    AirData, the dynamics' IMU fields, the systems' fields the laws
    read."""
    t = lambda v: _t(np.array(v))
    k, a, d, sy = jy.kinematics, jy.airflow, jy.dynamics, jy.systems
    kin = KinData(**{f: t(getattr(k, f)) for f in KinData._fields})
    air = AirData(**{f: t(getattr(a, f)) for f in AirData._fields})
    dyn = DynamicsY(f_c_c=t(d.f_c_c), alpha_ib_b=t(d.alpha_ib_b),
                    mp_sum_b=MassProps(t(d.mp_sum_b.m), t(d.mp_sum_b.J),
                                       t(d.mp_sum_b.r_OG)))
    act = {g: {c: t(v) for c, v in sy.act[g].items()}
           for g in ("cmd", "pos", "sat")}
    sys_ = SystemsY(act=act, aero=AeroY(t(sy.aero.alpha), t(sy.aero.beta),
                                        t(sy.aero.alpha_filt),
                                        t(sy.aero.beta_filt)),
                    ldg=LdgY(strut=StrutWow(wow=t(sy.ldg.strut.wow))),
                    pwp=ThrusterY(engine=EngineY(n=t(sy.pwp.engine.n))))
    return VehicleY(systems=sys_, kinematics=kin, dynamics=dyn, airflow=air)


def _out_tree(s, y):
    """The pass's state and its NavY and inner outputs as one dict."""
    nav = y["nav"]._asdict()
    nav["z"] = nav["z"]._asdict()
    return {"s": s, "nav": nav, "inner": y["inner"]}


def _port_laws():
    from flightjax_torch.models.c172.c172x_ctl import ControlLaws
    return ControlLaws(device="cpu", dtype=F64)


PASS_SETTINGS = {
    "epoch": ({}, 9), "off_epoch": ({}, 10),
    "shadow": ({"use_estimates": False}, 9),
    "synthetic": ({"alpha_beta": "synthetic"}, 9),
    "radar": ({"use_radar": True}, 9),
}


@pytest.fixture(scope="module")
def pass_inputs(nav_fleet, jax_nav):
    """The pass's operands on the navigation fleet: its avionics' numpy
    u and s and the JAX VehicleY at its state."""
    _, (t, i, x, u, s) = nav_fleet
    jy = jax_nav["f_ode"](to_jax(x["vehicle"]), to_jax(u["vehicle"]),
                          to_jax(s["vehicle"]), jnp.asarray(t))
    return u["avionics"], s["avionics"], jax.tree.map(np.asarray, jy)


@pytest.fixture(scope="module")
def jax_passes():
    """The JAX pass, jitted once per setting (the aiding epoch and off it
    share one)."""
    out = {}
    for name in ("epoch", "shadow", "synthetic", "radar"):
        nav = JN.NavAvionics(JControlLaws(), dt=DT, **PASS_SETTINGS[name][0])
        out[name] = (nav, jax.jit(jax.vmap(
            lambda s, u, y, h, nav=nav: nav.f_periodic(s, u, y, DT,
                                                       h_trn=h))))
    out["off_epoch"] = out["epoch"]
    return out


@pytest.mark.parametrize("setting", list(PASS_SETTINGS))
def test_f_periodic_matches_jax(pass_inputs, jax_passes, setting):
    """`NavAvionics.f_periodic` on the fleet's lanes against JAX's, the new
    state and both outputs to 1e-12: on an aiding epoch (GPS, baro and
    mag), off one (where the port skips the aiding block, as the gated
    reference does, against the reference running it masked), in shadow
    mode, with the synthetic airflow angles and with the radar aiding on
    two lanes within 150 m of their terrain."""
    kw, n0 = PASS_SETTINGS[setting]
    u_np, s_np, jy = pass_inputs
    s_np = dict(s_np, sens=dict(s_np["sens"], n=np.full(B, n0, np.int32)))
    jnav, jfn = jax_passes[setting]
    tnav = TN.NavAvionics(_port_laws(), dt=DT, device="cpu", dtype=F64, **kw)
    h_o = jy.kinematics.h_o
    h_trn = np.where(np.arange(B) < 2, h_o - 120.0, h_o - 2000.0) \
        if kw.get("use_radar") else np.zeros(B)
    vy = _port_veh_y(jy)
    aid = tnav.epoch_gate(n0 + 1)
    assert aid == ((n0 + 1) % 5 == 0)
    s2, y2 = tnav.f_periodic(to_torch(s_np), to_torch(u_np), vy, DT,
                             _t(h_trn), aid=aid)
    js2, jy2 = jfn(_like_template(s_np, jnav.init_s()),
                   _like_template(u_np, jnav.init_u()), jy,
                   jnp.asarray(h_trn))
    got = _out_tree(s2, y2)
    ref = jax.tree.map(np.asarray, _out_tree(js2, jy2))
    if not aid:  # the skipped block outputs zero NIS where none was formed
        for k in ("nis_gps", "nis_gps_vel", "nis_baro", "nis_mag",
                  "nis_radar"):
            assert not got["nav"][k].any()
            got["nav"][k] = ref["nav"][k] = np.zeros(B)
    assert_tree_close(got, ref, TOL_OP, f"{setting}: ")
    if setting == "radar":
        assert (np.asarray(js2["nis"]["radar"]) != 0).sum() == 2


def test_epoch_gate_matches_epoch_preds():
    """The host's gate from the sensor epoch equals JAX's `epoch_preds` on
    the state of every firing of a 50-firing run, at the default cadences
    and at GPS 7, baro 4, mag 6 with the radar at 3; a channel aiding on
    every firing gives no gate on either side."""
    for kw in ({}, {"gps_every": 7, "baro_every": 4, "mag_every": 6,
                    "use_radar": True, "radar_every": 3}):
        jnav = JN.NavAvionics(JControlLaws(), dt=DT, **kw)
        tnav = TN.NavAvionics(None, dt=DT, device="cpu", dtype=F64, **kw)
        for n in range(50):
            s = {"sens": {"n": jnp.asarray(n, jnp.int32)}}
            ref = bool(jnav.epoch_preds(s)["aid"])
            assert tnav.epoch_gate(n + 1) is ref, (kw, n)
    kw = {"baro_every": 1}
    assert JN.NavAvionics(JControlLaws(), dt=DT, **kw).epoch_preds(
        {"sens": {"n": jnp.asarray(0)}}) is None
    assert TN.NavAvionics(None, dt=DT, device="cpu", dtype=F64,
                          **kw).epoch_gate(1) is None


# ------------------------------------------------------------ the paths

def _twin_state(np_state):
    """The truth-fed turbulent C172Xv1 of the navigation fleet: its
    vehicle, its inner control laws' inputs and state."""
    t, i, x, u, s = np_state
    return (t, i, x, dict(u, avionics=u["avionics"]["inner"]),
            dict(s, avionics=s["avionics"]["inner"]))


@pytest.fixture(scope="module")
def jax_twin_steps(nav_fleet):
    """The JAX fleet step of the turbulent C172Xv1 on ControlLaws from the
    twin's state, STEPS times: the reference of the three entry points."""
    aircraft = Jx.build_xv1("wa", turbulence=JDryden(DT))
    sim = JSimulation(JSimpleWorld(aircraft), dt=DT, periodic_dt=DT)
    st = _jax_state(*_twin_state(nav_fleet[1]), aircraft.avionics)
    step = jax.jit(sim.fleet_step)
    out = []
    for _ in range(STEPS):
        st = step(st)
        out.append(jax.tree.map(np.asarray, st))
    return out


def _stepper(sim, st, path):
    if path == "megakernel":
        bufs, step_packed, unpack = make_megakernel_step(sim, st)
        box = [bufs]

        def step(_, k):
            box[0] = step_packed(box[0])
            return unpack(box[0])
        return step
    f = (make_cluster_step(sim, st, split="vehicle") if path == "vehicle"
         else sim.fleet_step)
    return lambda s, k: f(s, i=k)


def _compare(st, ref, what):
    for name in ("t", "i", "x", "u", "s"):
        assert_tree_close({name: getattr(st, name)},
                          {name: getattr(ref, name)}, TOL, what)


@pytest.mark.parametrize("path", ["fleet", "vehicle", "megakernel"])
def test_turbulent_xv1_matches_jax(nav_fleet, jax_twin_steps, path):
    """The turbulent C172Xv1 on its control laws through each entry point
    (the plain versions of `rk4_stage_fbw_turb`, `rk4_finish_fbw_turb` and
    `megakernel_fbw_turb`) against the JAX fleet step, every leaf after
    each of STEPS steps to 1e-9: the shear on one lane, a discrete gust
    inside the window on another, the drive redrawn every step."""
    sim, _, _ = Tx.c172xv1_sim("cpu", F64, turbulence=DrydenTurbulence(DT))
    sim.geoid_every = 1
    st = _port_state(_twin_state(nav_fleet[1]))
    step = _stepper(sim, st, path)
    K.reset_launches()
    for k in range(STEPS):
        st = step(st, I0 + k)
        _compare(st, jax_twin_steps[k], f"{path} step {k}: ")
    assert not any(K.LAUNCHES.values())


@pytest.fixture(scope="module")
def jax_nav_steps(nav_fleet, jax_nav):
    st = _jax_state(*nav_fleet[1], jax_nav["aircraft"].avionics)
    out = []
    for _ in range(STEPS):
        st = jax_nav["step"](st)
        out.append(jax.tree.map(np.asarray, st))
    return out


@pytest.mark.parametrize("path", ["fleet", "vehicle", "megakernel"])
def test_nav_fleet_matches_jax(nav_fleet, jax_nav_steps, path):
    """The navigation fleet through `Simulation.fleet_step`,
    `make_cluster_step(split="vehicle")` and `make_megakernel_step` (the
    plain version of `megakernel_nav_turb`, each lane's pass on its own
    sensor epoch as `Simulation.step` runs it) against the JAX fleet step (its aiding gate
    from `epoch_preds`; the geoid refreshed every step, so its step is the
    megakernel's `vmap(Simulation.step)`), every leaf after each of STEPS
    steps to 1e-9: the filter, its accumulator, the monitors and the
    sensors' error states among them; the GPS, baro and mag aid at the
    third step."""
    sim, np_state = nav_fleet
    st = _port_state(np_state)
    step = _stepper(sim, st, path)
    K.reset_launches()
    for k in range(STEPS):
        st = step(st, I0 + k)
        _compare(st, jax_nav_steps[k], f"{path} step {k}: ")
    assert not any(K.LAUNCHES.values())
    assert (st.s["avionics"]["nis"]["gps"] > 0).all()


def test_shadow_mode_flies_as_the_truth_fed_xv1(nav_fleet):
    """`use_estimates=False` (`tests/test_navigation.py:102`): the filters
    run in shadow, and the vehicle and its control laws step bit for bit
    as the truth-fed turbulent C172Xv1 from the same state, through both
    entry points."""
    sim_t, _, _ = Tx.c172xv1_sim("cpu", F64, turbulence=DrydenTurbulence(DT))
    sim_t.geoid_every = 1
    sim_s, _ = nav_fleet_setup(B, key=R.PRNGKey(5), device="cpu", dtype=F64,
                               use_estimates=False)
    for path in ("fleet", "vehicle"):
        st_s = _port_state(nav_fleet[1])
        st_t = _port_state(_twin_state(nav_fleet[1]))
        step_s, step_t = (_stepper(sim_s, st_s, path),
                          _stepper(sim_t, st_t, path))
        for k in range(STEPS):
            st_s, st_t = step_s(st_s, I0 + k), step_t(st_t, I0 + k)
        a = {"x": st_s.x, "u": dict(st_s.u, avionics=st_s.u["avionics"][
            "inner"]), "s": dict(st_s.s, avionics=st_s.s["avionics"][
                "inner"]), "t": st_s.t}
        b = {"x": st_t.x, "u": st_t.u, "s": st_t.s, "t": st_t.t}
        for (p, va), (q, vb) in zip(tree_leaves_with_path(a),
                                    tree_leaves_with_path(b)):
            assert p == q and torch.equal(va, vb), (path, p)


def test_refusals_and_layouts(nav_fleet):
    """The kernels carry the turbulent fly-by-wire vehicle (FBW_TURB), the
    navigation avionics' splits (their pass `nav_pass`, then the inner
    laws' kernel) and their megakernel around the C172Xv1's control laws
    (`megakernel_nav_turb`, calm `megakernel_nav`), around the calm
    C172Xv2's guidance and control laws (`megakernel_gdc_nav`), around a
    mission over them (`megakernel_msn_nav`, its splits' pass
    `msn_nav_ctl_laws`), and the turbulent C172Xv2's and a mission's
    megakernels (`megakernel_gdc_turb`, `megakernel_msn_turb`); they refuse
    the navigation megakernel around the turbulent C172Xv2
    (`build_xv2_nav(turbulence=)`) and an `Actuator2` channel, each naming
    its ROADMAP item; the sensors' epoch must count the firings from step
    0."""
    sim, np_state = nav_fleet
    st = _port_state(np_state)
    veh = sim.system.aircraft.vehicle
    nav = sim.system.aircraft.avionics
    assert K.layout_of(veh) is K.FBW_TURB
    lay = K.avionics_layout(veh, nav)
    assert lay is K.FBW_TURB_NAV and lay.pass_name == "ctl_laws"
    assert lay.mega_name == "megakernel_nav_turb"
    assert K.mega_refusal(lay) is None
    assert K.FBW_NAV.mega_name == "megakernel_nav"
    assert K.FBW_TURB.names == {
        "systems": "systems_fbw", "finish_sys": "finish_sys_fbw",
        "rk4_stage": "rk4_stage_fbw_turb",
        "rk4_finish": "rk4_finish_fbw_turb"}
    assert K.FBW_TURB.mega_name == "megakernel_fbw_turb"
    xv2_nav = Tx.build_xv2_nav(device="cpu", dtype=F64,
                               turbulence=DrydenTurbulence(DT))
    from flightjax_torch.core.sim import Simulation as TSim
    from flightjax_torch.physics.aircraftbase import SimpleWorld as TWorld
    with pytest.raises(NotImplementedError,
                       match="megakernel_gdc_nav_turb"):
        make_megakernel_step(TSim(TWorld(xv2_nav)), st)
    assert "megakernel_gdc_nav_turb" in K.mega_refusal(
        K.avionics_layout(xv2_nav.vehicle, xv2_nav.avionics))
    calm = Tx.build_xv2_nav(device="cpu", dtype=F64)
    lay = K.avionics_layout(calm.vehicle, calm.avionics)
    assert lay is K.GDC_NAV and lay.mega_name == "megakernel_gdc_nav"
    assert lay.pass_name == "gdc_ctl_laws" and K.mega_refusal(lay) is None
    xv2 = Tx.build_xv2(device="cpu", dtype=F64,
                       turbulence=DrydenTurbulence(DT))
    lay = K.avionics_layout(xv2.vehicle, xv2.avionics)
    assert lay is K.GDC_TURB and lay.mega_name == "megakernel_gdc_turb"
    assert K.mega_refusal(lay) is None
    assert K.MSN_TURB.mega_name == "megakernel_msn_turb"
    assert K.mega_refusal(K.MSN_TURB) is None
    servo2 = Tx.build_xv1_nav(device="cpu", dtype=F64,
                              actuators={"elevator": Tx.Actuator2()},
                              turbulence=DrydenTurbulence(DT))
    with pytest.raises(ValueError, match="Actuator2"):
        K.layout_of(servo2.vehicle, servo2.avionics)
    from flightjax_torch.core.mission import MissionAvionics
    from flightjax_torch.models.c172.missions import traffic_pattern_phases
    from flightjax_torch.models.c172.c172x_gdc import Avionics
    msn = MissionAvionics(Avionics(device="cpu", dtype=F64),
                          traffic_pattern_phases())
    sensor_fed = TN.NavAvionics(msn, dt=DT, device="cpu", dtype=F64)
    calm_veh = calm.vehicle
    lay = K.avionics_layout(calm_veh, sensor_fed)
    assert lay is K.MSN_NAV and K.MSN_NAV.mega_name == "megakernel_msn_nav"
    assert lay.pass_name == "msn_nav_ctl_laws" and K.mega_refusal(lay) is None
    shifted = st._replace(i=st.i + 1)
    with pytest.raises(ValueError, match="sensor epoch"):
        sim.fleet_step(shifted, i=I0 + 1)
