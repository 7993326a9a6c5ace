"""flightjax_torch ops against flightjax: quaternions, attitude, geodesy
(geoid included), the interpolation tables and ISA / air data. float64 on
the CPU, the same numpy inputs to both; tolerance 1e-12 relative to
max(1, |reference|)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flightjax.models.c172 import common as JC
from flightjax.ops import attitude as jatt
from flightjax.ops import geodesy as jgeo
from flightjax.ops import quaternions as jq
from flightjax.physics import atmosphere as jatm
from flightjax.physics.kinematics import KinData as JKinData
from flightjax.physics.piston import PistonEngine as JEngine

from flightjax_torch.models.c172 import common as TC
from flightjax_torch.ops import attitude as tatt
from flightjax_torch.ops import geodesy as tgeo
from flightjax_torch.ops import quaternions as tq
from flightjax_torch.ops.interp import Lookup
from flightjax_torch.physics import atmosphere as tatm
from flightjax_torch.physics.piston import build_tables

from test_torch_support import assert_close

TOL = 1e-12
N = 64


def _rng(k=0):
    return np.random.default_rng(1000 + k)


def _unit(a):
    return a / np.linalg.norm(a, axis=-1, keepdims=True)


def _both(*arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.as_tensor(np.array(a)) for a in arrays])


def _cmp(j_out, t_out, what):
    if isinstance(j_out, tuple):
        for k, (a, b) in enumerate(zip(t_out, j_out)):
            assert_close(a, np.asarray(b), TOL, f"{what}[{k}]")
    else:
        assert_close(t_out, np.asarray(j_out), TOL, what)


QUAT_CASES = {
    "qmul": (lambda m: (m.qmul,), ("q", "q")),
    "qconj": (lambda m: (m.qconj,), ("q",)),
    "qrot": (lambda m: (m.qrot,), ("q", "v")),
    "qrot_inv": (lambda m: (m.qrot_inv,), ("q", "v")),
    "qdt": (lambda m: (m.qdt,), ("q", "v")),
    "qmul_zpre": (lambda m: (m.qmul_zpre,), ("s", "s", "q")),
    "qmul_zpost": (lambda m: (m.qmul_zpost,), ("q", "s", "s")),
    "rot2_z": (lambda m: (m.rot2_z,), ("s", "s", "v")),
    "rot2_y": (lambda m: (m.rot2_y,), ("s", "s", "v")),
}


def _draw(kind, rng):
    if kind == "q":
        return _unit(rng.normal(size=(N, 4)))
    if kind == "v":
        return rng.normal(size=(N, 3)) * 10.0
    return rng.uniform(-1.0, 1.0, N)


@pytest.mark.parametrize("name", sorted(QUAT_CASES))
def test_quaternions(name):
    getter, kinds = QUAT_CASES[name]
    rng = _rng(hash(name) % 97)
    args = [_draw(k, rng) for k in kinds]
    ja, ta = _both(*args)
    _cmp(getter(jq)[0](*ja), getter(tq)[0](*ta), name)


@pytest.mark.parametrize("name", ["quat_to_euler", "azimuth", "inclination",
                                  "half_angle_cs", "euler_to_quat",
                                  "quat_to_matrix", "matrix_to_quat"])
def test_attitude(name):
    rng = _rng(7)
    if name in ("quat_to_euler", "quat_to_matrix"):
        args = [_unit(rng.normal(size=(N, 4)))]
    elif name == "half_angle_cs":
        ang = rng.uniform(-np.pi, np.pi, N)
        ang[:2] = [np.pi, -np.pi / 2]
        args = [np.cos(ang), np.sin(ang)]
    elif name == "euler_to_quat":
        args = [rng.uniform(-1.5, 1.5, (N, 3))]
    elif name == "matrix_to_quat":
        q = _unit(rng.normal(size=(N, 4)))
        args = [np.asarray(jatt.quat_to_matrix(jnp.asarray(q)))]
    else:
        args = [rng.normal(size=(N, 3)) * 50.0]
    ja, ta = _both(*args)
    _cmp(getattr(jatt, name)(*ja), getattr(tatt, name)(*ta), name)


def _geo_inputs(rng):
    n_e = _unit(rng.normal(size=(N, 3)))
    n_e[0] = [0.0, 0.0, 1.0]          # pole
    n_e[1] = [-1.0, 1e-12, 0.0]       # longitude wrap
    h = rng.uniform(-100.0, 12000.0, N)
    return n_e, h


@pytest.mark.parametrize("name", [
    "nvector_from_qew", "get_psi_nw_ab", "latlon_from_nvector", "radii",
    "cartesian_from_geographic", "geographic_from_cartesian", "gravity",
    "geop_from_orth", "orth_from_geop", "geoid_height", "orth_from_ellip"])
def test_geodesy(name):
    rng = _rng(11)
    n_e, h = _geo_inputs(rng)
    if name in ("nvector_from_qew", "get_psi_nw_ab"):
        args = [_unit(rng.normal(size=(N, 4)))]
    elif name in ("latlon_from_nvector", "radii", "geoid_height"):
        args = [n_e]
    elif name == "geographic_from_cartesian":
        args = [np.asarray(jgeo.cartesian_from_geographic(jnp.asarray(n_e),
                                                          jnp.asarray(h)))]
    elif name in ("geop_from_orth", "orth_from_geop"):
        args = [h]
    elif name == "orth_from_ellip":
        args = [h, n_e]
    else:
        args = [n_e, h]
    ja, ta = _both(*args)
    _cmp(getattr(jgeo, name)(*ja), getattr(tgeo, name)(*ta), name)


def _engine_tables():
    je = JEngine()
    te = build_tables(je.omega_stall / je.omega_rated,
                      je.omega_max / je.omega_rated)
    return {f"engine.{k}": (je.tables[k], te[k]) for k in te}


def _aero_tables():
    return {f"aero.{k}": (JC.AERO_TABLES[k], TC.AERO_TABLES[k])
            for k in TC.AERO_TABLES}


TABLE_NAMES = ([f"aero.{k}" for k in sorted(TC.AERO_TABLES)]
               + [f"engine.{k}" for k in ("delta_wot", "mu_wot", "pi_std",
                                          "pi_wot", "pi_ratio", "sfc_ratio",
                                          "sfc_pow")])


@pytest.mark.parametrize("name", TABLE_NAMES)
def test_lookup_tables(name):
    """Every aero and engine table: the port's corner-gather lookup
    against the JAX Lookup, over and beyond each axis (flat and line
    extrapolation)."""
    jl, (axes, vals, ex) = {**_aero_tables(), **_engine_tables()}[name]
    rng = _rng(13)
    coords = []
    for a in axes:
        span = max(a[-1] - a[0], 1e-3)
        c = rng.uniform(a[0] - 0.2 * span, a[-1] + 0.2 * span, N)
        c[:len(a)] = a[:N]            # every knot exactly
        coords.append(c)
    tl = Lookup(axes, vals, ex, device="cpu", dtype=torch.float64)
    ref = jl(*[jnp.asarray(c) for c in coords])
    got = tl(*[torch.as_tensor(c) for c in coords])
    assert_close(got, np.asarray(ref), TOL, name)


def _kin_like(rng):
    q_nb = _unit(rng.normal(size=(N, 4)))
    v_eb_b = rng.normal(size=(N, 3)) * 30.0 + [50.0, 0.0, 0.0]
    return q_nb, v_eb_b


@pytest.mark.parametrize("name", ["isa_data", "atmospheric_data", "air_data",
                                  "get_airflow_angles"])
def test_atmosphere(name):
    rng = _rng(17)
    h = rng.uniform(-500.0, 90000.0, N)
    T_sl = rng.uniform(220.0, 360.0, N)
    p_sl = rng.uniform(85000.0, 115000.0, N)
    wind = rng.normal(size=(N, 3)) * 5.0
    if name == "isa_data":
        ja, ta = _both(h, T_sl, p_sl)
        _cmp(jatm.isa_data(*ja), tatm.isa_data(*ta), name)
        return
    u_np = {"T_sl": T_sl, "p_sl": p_sl, "wind": wind}
    ju = {k: jnp.asarray(v) for k, v in u_np.items()}
    tu = {k: torch.as_tensor(v) for k, v in u_np.items()}
    if name == "get_airflow_angles":
        v = rng.normal(size=(N, 3)) * 20.0
        v[0] = [0.01, 0.0, 0.01]
        _cmp(jatm.get_airflow_angles(jnp.asarray(v)),
             tatm.get_airflow_angles(torch.as_tensor(v)), name)
        return
    h_o = np.clip(h, -500.0, 20000.0)
    jd = jatm.SimpleAtmosphere().atmospheric_data(ju, None, jnp.asarray(h_o))
    td = tatm.SimpleAtmosphere().atmospheric_data(tu, None,
                                                  torch.as_tensor(h_o))
    if name == "atmospheric_data":
        _cmp(tuple(jd), tuple(td), name)
        return
    q_nb, v_eb_b = _kin_like(rng)
    zeros = np.zeros(N)
    jk = JKinData(*([jnp.asarray(zeros)] * 17))._replace(
        q_nb=jnp.asarray(q_nb), v_eb_b=jnp.asarray(v_eb_b))
    tk = JKinData(*([None] * 17))._replace(q_nb=torch.as_tensor(q_nb),
                                          v_eb_b=torch.as_tensor(v_eb_b))
    _cmp(tuple(jatm.air_data(jd, jk)), tuple(tatm.air_data(td, tk)), name)


def test_tables_equal_reference_exactly():
    """AERO_TABLES / AERO_CONST literals and the engine chart tables built
    in numpy equal the JAX package's, bit for bit."""
    assert TC.AERO_CONST == JC.AERO_CONST
    for name, (jl, (axes, vals, ex)) in {**_aero_tables(),
                                         **_engine_tables()}.items():
        assert len(axes) == len(jl.axes), name
        for a, b in zip(axes, jl.axes):
            np.testing.assert_array_equal(a, np.asarray(b), err_msg=name)
        np.testing.assert_array_equal(vals, np.asarray(jl.values),
                                      err_msg=name)
        ex = (ex,) * len(axes) if isinstance(ex, str) else tuple(ex)
        assert ex == tuple(jl.extrap), name


def test_jax_stays_on_cpu_float64():
    assert jax.config.jax_enable_x64
    assert jnp.asarray(1.0).dtype == jnp.float64
