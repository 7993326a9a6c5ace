"""The turbulent Monte Carlo path of flightjax_torch against flightjax,
float64 on the CPU (the kernels' plain versions), on inputs drawn with numpy
from a seed and handed to both packages:

- the threefry stream of `ops/random.py`: keys, `fold_in`, `split`, the raw
  bits in 32 and 64 bits, `uniform` and `randint` exactly, `normal` to
  1e-12, for several (seed, n), seeds above 2^24 among them, one key and a
  key per lane;
- `scales`, `shear_scale`, `discrete_gust` and `DrydenTurbulence.f_ode`,
  `gust` and `f_step` to 1e-12 on the operands of the kernel checks
  (`testing.turb_operands`: every severity, the heights below 10 ft, in the
  low band, in the blend and above 2000 ft, V below V_MIN, shear on and off
  with h below z0, before, during and after a discrete gust);
- W20 = 0 with the shear and the discrete gust off: bit for bit the
  turbulence-free flagship, through each entry point;
- 5 steps of 8 lanes at W20 = 10 (the shear on three lanes, a discrete gust
  inside the window on two, a lane on the runway, a terminated one)
  through `Simulation.fleet_step`, `make_cluster_step(split="vehicle")` and
  `make_megakernel_step` against `jax.jit(sim.fleet_step)` of the JAX
  turbulent world at `geoid_every=1`, every leaf to 1e-9;
- `monte_carlo_c172`'s draws for one key; `fleet_rollout_loads`' peaks to
  1e-9 and `exceedance` exactly against that compiled step and a jitted
  `vmap(sim.output)` (`slow`: against JAX's own `fleet_rollout_loads`);
- the gust-load demo at batch 8 for 2 s under the bounds of
  `tests/test_missions.py:95-99`; the refusals; the turbulent layouts
  against `csrc/`; the turbulent start against JAX's trim (`slow`).

The JAX fleet step at `geoid_every=1` is compiled once, shared by the three
entry points and the loads.
"""

import math
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flightjax.core.sim import SimState as JSimState
from flightjax.core.sim import Simulation as JSimulation
from flightjax.models.c172 import c172s as Jc
from flightjax.parallel import fleet as Jfleet
from flightjax.physics import turbulence as JT

from flightjax_torch.core.modeling import tree_leaves_with_path
from flightjax_torch.core.sim import SimState, Simulation
from flightjax_torch.models.c172 import c172s as Tc
from flightjax_torch.ops import random as R
from flightjax_torch.parallel import fleet as Tfleet
from flightjax_torch.parallel import kernels as K
from flightjax_torch.parallel.clusterstep import make_cluster_step
from flightjax_torch.parallel.megakernel import make_megakernel_step
from flightjax_torch.physics import turbulence as TT
from flightjax_torch.testing import (turb_fleet, turb_operand_state,
                                     turb_operands)

from test_torch_support import (F64, assert_close, assert_tree_close, to_jax,
                                to_torch)

TOL_OP = 1e-12
TOL = 1e-9
DT = 0.02
SEED = 20261017
B = 8
STEPS = 5
# the fleet of the step tests: a lane on the runway, a terminated one, the
# shear on three lanes, a discrete gust inside the first steps on two
GROUND_LANE, TERMINATED_LANE = 5, 6
SHEAR_LANES, GUST_LANES = (0, 2, 5), (1, 3)


def _fleet_np(W20=10.0, shear_lanes=SHEAR_LANES, gust_lanes=GUST_LANES):
    return turb_fleet(B, SEED, ground_lanes=(GROUND_LANE,),
                      terminated_lanes=(TERMINATED_LANE,), W20=W20,
                      shear_lanes=shear_lanes, gust_lanes=gust_lanes)


def _torch_state(t, i, x, u, s, dtype=F64):
    return SimState(t=torch.tensor(t, dtype=dtype), i=torch.tensor(i),
                    x=to_torch(x) if dtype == F64 else _conv(x, dtype),
                    u=to_torch(u) if dtype == F64 else _conv(u, dtype),
                    s=to_torch(s) if dtype == F64 else _conv(s, dtype))


def _conv(tree, dtype):
    from flightjax_torch.bridge import tree_from_numpy
    return tree_from_numpy(tree, "cpu", dtype)


def _jax_state(t, i, x, u, s):
    return JSimState(t=jnp.asarray(t), i=jnp.asarray(i), x=to_jax(x),
                     u=to_jax(u), s=to_jax(s))


def _port_sim(geoid_every=1, dtype=F64):
    sim0, _, _ = Tc.turbulent_flagship_sim("cpu", dtype)
    return Simulation(sim0.system, dt=DT, periodic_dt=DT,
                      geoid_every=geoid_every, gear_gate_margin=10.0)


@pytest.fixture(scope="module")
def jax_turb():
    world = Jc.flagship_world("wa", turbulence=JT.DrydenTurbulence(DT))
    sim = JSimulation(world, dt=DT, periodic_dt=DT, geoid_every=1,
                      gear_gate_margin=10.0)
    return {"world": world, "sim": sim, "step": jax.jit(sim.fleet_step),
            "output": jax.jit(jax.vmap(lambda st: sim.output(st)))}


# ------------------------------------------------------------ the stream

SEEDS = (0, 7, 2 ** 24 + 3, 2 ** 31 - 2)


@pytest.mark.parametrize("seed", SEEDS)
def test_stream_matches_jax(seed):
    """One key: PRNGKey, fold_in (data above 2^24 too), split, the bits in
    32 and 64 bits, uniform in float32 and float64 (two ranges) and randint
    in int32 and int64 exactly; normal in float64 to 1e-12."""
    jk, tk = jax.random.PRNGKey(seed), R.PRNGKey(seed)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    for d in (0, 1, 2 ** 24 + 9, 2 ** 31 - 1):
        np.testing.assert_array_equal(R.fold_in(tk, d).numpy(),
                                      np.asarray(jax.random.fold_in(jk, d)))
    np.testing.assert_array_equal(R.split(tk, 5).numpy(),
                                  np.asarray(jax.random.split(jk, 5)))
    b32 = np.asarray(jax.random.bits(jk, (9,), jnp.uint32))
    np.testing.assert_array_equal(R.random_bits(tk, 32, (9,)).numpy(), b32)
    b64 = np.asarray(jax.random.bits(jk, (2, 3), jnp.uint64))
    np.testing.assert_array_equal(R.random_bits(tk, 64, (2, 3)).numpy(),
                                  b64.view(np.int64))
    for jd, td in ((jnp.float32, torch.float32), (jnp.float64, F64)):
        for lo, hi in ((0.0, 1.0), (0.2, 0.9), (-3.5, 1e-3)):
            np.testing.assert_array_equal(
                R.uniform(tk, (64,), td, lo, hi).numpy(),
                np.asarray(jax.random.uniform(jk, (64,), jd, lo, hi)))
    for jd, td in ((jnp.int32, torch.int32), (jnp.int64, torch.int64)):
        np.testing.assert_array_equal(
            R.randint(tk, (7,), 0, 2 ** 31 - 1 - 4096, td).numpy(),
            np.asarray(jax.random.randint(jk, (7,), 0, 2 ** 31 - 1 - 4096,
                                          jd)))
    assert_close(R.normal(tk, (64,), F64),
                 np.asarray(jax.random.normal(jk, (64,), jnp.float64)),
                 TOL_OP)


def test_lane_streams_match_jax():
    """A key per lane, fold_in(fold_in(PRNGKey(0x0D27), seed), n) as the
    drive's redraw forms it, seeds and counters above 2^24 among them: the
    keys and uniforms exactly, the normals to 1e-12 (float64)."""
    rng = np.random.default_rng(SEED)
    seed = rng.integers(0, 2 ** 31 - 1, 64).astype(np.int32)
    n = rng.integers(0, 2 ** 31 - 1, 64).astype(np.int32)
    seed[:4], n[:4] = [0, 1, 2 ** 24, 2 ** 24 + 1], [1, 2 ** 24 + 5, 3, 0]
    base = jax.random.PRNGKey(TT.STREAM)
    jk = jax.vmap(lambda a, b: jax.random.fold_in(
        jax.random.fold_in(base, a), b))(jnp.asarray(seed), jnp.asarray(n))
    tk = R.fold_in(R.fold_in(R.PRNGKey(TT.STREAM), torch.tensor(seed)),
                   torch.tensor(n))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    for jd, td in ((jnp.float32, torch.float32), (jnp.float64, F64)):
        np.testing.assert_array_equal(
            R.uniform(tk, (3,), td).numpy(),
            np.asarray(jax.vmap(lambda k: jax.random.uniform(
                k, (3,), jd))(jk)))
    assert_close(R.normal(tk, (3,), F64), np.asarray(jax.vmap(
        lambda k: jax.random.normal(k, (3,), jnp.float64))(jk)), TOL_OP)


# ------------------------------------------------------------ turbulence

@pytest.fixture(scope="module")
def ops():
    """The operands of the kernel checks (24 lanes; lanes 3 and 17 on the
    runway): the turbulence's trees, each lane's height above the runway,
    V against the sheared mean wind, and the stage times."""
    d = turb_operands(24, 1016, (3, 17), (5,), (11,))
    h_agl = d["x_kin"]["h_e"] - d["geoid_N"]
    v = np.linalg.norm(d["x_dyn"]["v_eb_b"], axis=-1)
    # spread a few more heights: negative, on z0, at the band edges
    h_agl[[0, 7, 8, 9]] = [-0.5, 2.0 * TT.FT, 1000.0 * TT.FT, 2000.0 * TT.FT]
    return d, h_agl, v


def test_ops_cover_the_branches(ops):
    d, h_agl, v = ops
    h_ft = h_agl / TT.FT
    assert (h_ft < 10).any() and ((h_ft > 10) & (h_ft < 1000)).any()
    assert ((h_ft > 1000) & (h_ft < 2000)).any() and (h_ft > 2000).any()
    assert (v < TT.V_MIN).any() and (v > TT.V_MIN).any()
    u, t = d["u_turb"], d["t"]
    z0 = u["shear_z0_ft"]
    assert (z0 == 0).any() and (z0 > 0).any() and (h_ft < z0).any()
    tau = (t - u["gust_t0"]) / u["gust_T"]
    assert (tau < 0).any() and ((tau >= 0) & (tau <= 2)).any() \
        and (tau > 2).any()
    assert set(np.unique(u["W20"])) == {0.0, 7.7, 15.4, 23.2}
    assert (d["u_turb"]["seed"] > 2 ** 24).any()
    assert (d["s_turb"]["n"] > 2 ** 24).any()


def test_turbulence_functions_match_jax(ops):
    """scales, shear_scale, discrete_gust, f_ode (derivative and gust),
    gust and f_step to 1e-12 on the operands."""
    d, h_agl, v = ops
    jt, tt = JT.DrydenTurbulence(DT), TT.DrydenTurbulence(DT)
    th, tv, ttm = (torch.tensor(a) for a in (h_agl, v, d["t"]))
    jh, jv, jtm = (jnp.asarray(a) for a in (h_agl, v, d["t"]))
    ju, tu = to_jax(d["u_turb"]), to_torch(d["u_turb"])
    jx, tx = to_jax(d["x_turb"]), to_torch(d["x_turb"])
    js, ts = to_jax(d["s_turb"]), to_torch(d["s_turb"])
    for a, b in zip(TT.scales(th, tu["W20"]), JT.scales(jh, ju["W20"])):
        assert_close(a, np.asarray(b), TOL_OP, "scales")
    assert_close(TT.shear_scale(tu, th),
                 np.asarray(JT.shear_scale(ju, jh)), TOL_OP, "shear")
    assert_close(TT.discrete_gust(tu, ttm),
                 np.asarray(JT.discrete_gust(ju, jtm)), TOL_OP, "gust")
    x_dot, g = tt.f_ode(tx, tu, ts, ttm, tv, th)
    jx_dot, jg = jt.f_ode(jx, ju, js, jtm, jv, jh)
    assert_tree_close(x_dot, jax.tree.map(np.asarray, jx_dot), TOL_OP)
    assert_close(g, np.asarray(jg), TOL_OP, "f_ode gust")
    assert_close(tt.gust(tx, tu, tv, th, ttm),
                 np.asarray(jt.gust(jx, ju, jv, jh, jtm)), TOL_OP)
    s2 = tt.f_step(tu, ts)
    _, js2 = jax.vmap(jt.f_step)(jx, ju, js, jtm)
    assert torch.equal(s2["n"], torch.tensor(np.asarray(js2["n"])))
    assert_close(s2["eta"], np.asarray(js2["eta"]), TOL_OP, "eta")


# ------------------------------------------------------------ the paths

def _stepper(sim, st, path):
    """(step(st, k) -> st) of entry point `path` from state `st`."""
    if path == "megakernel":
        bufs, step_packed, unpack = make_megakernel_step(sim, st)
        box = [bufs]

        def step(_, k):
            box[0] = step_packed(box[0])
            return unpack(box[0])
        return step
    if path == "vehicle":
        f = make_cluster_step(sim, st, split="vehicle")
    else:
        f = sim.fleet_step
    return lambda s, k: f(s, i=k)


PATHS = ["fleet", "vehicle", "megakernel"]


@pytest.mark.parametrize("dtype", [F64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("path", PATHS)
def test_w20_zero_is_the_turbulence_free_flagship(path, dtype):
    """At W20 = 0 with the shear and the discrete gust off (the filter
    states and the drive not zero) each entry point steps the C172S bit
    for bit as the turbulence-free flagship does through the same entry
    point: the gust adds exactly 0 to the wind (`tests/test_turbulence.py:
    142-180` holds JAX to the same)."""
    t, i, x, u, s = _fleet_np(W20=0.0, shear_lanes=(), gust_lanes=())
    turb = _port_sim(1, dtype)
    free_sim, _, _ = Tc.flagship_sim("cpu", dtype)
    free = Simulation(free_sim.system, dt=DT, periodic_dt=DT, geoid_every=1)
    st_t = turb.with_compensation(_torch_state(t, i, x, u, s, dtype))
    strip = lambda tree: {"vehicle": {k: v for k, v in tree["vehicle"].items()
                                      if k != "turb"},
                          **{k: v for k, v in tree.items() if k != "vehicle"}}
    st_f = free.with_compensation(_torch_state(t, i, strip(x), strip(u),
                                               strip(s), dtype))
    if path == "vehicle":
        st_t, st_f = st_t._replace(c=None), st_f._replace(c=None)
    step_t, step_f = _stepper(turb, st_t, path), _stepper(free, st_f, path)
    for k in range(STEPS):
        st_t, st_f = step_t(st_t, k), step_f(st_f, k)
    for name in ("t", "i", "c"):
        for (p, a), (_, b) in zip(
                *(tree_leaves_with_path(getattr(st, name))
                  for st in (st_t, st_f))):
            assert torch.equal(a, b), (name, p)
    for name in ("x", "s"):
        a, b = strip(getattr(st_t, name)), getattr(st_f, name)
        for (p, va), (q, vb) in zip(tree_leaves_with_path(a),
                                    tree_leaves_with_path(b)):
            assert p == q and torch.equal(va, vb), (name, p)


@pytest.fixture(scope="module")
def jax_steps(jax_turb):
    """The JAX fleet step, STEPS times from `_fleet_np`: the reference of
    the three entry points."""
    st = _jax_state(*_fleet_np())
    out = []
    for _ in range(STEPS):
        st = jax_turb["step"](st)
        out.append(jax.tree.map(np.asarray, st))
    return out


@pytest.mark.parametrize("path", PATHS)
def test_fleet_step_matches_jax(jax_steps, path):
    """Each entry point on the turbulent fleet at W20 = 10 with the geoid
    refreshed every step against the JAX fleet step, every leaf after each
    of STEPS steps to 1e-9; the discrete gust and the shear act, and the
    drive is redrawn on every lane, the terminated one too."""
    st = _torch_state(*_fleet_np())
    sim = _port_sim()
    step = _stepper(sim, st, path)
    K.reset_launches()
    for k in range(STEPS):
        st = step(st, k)
        ref = jax_steps[k]
        for name in ("t", "i", "x", "u", "s"):
            assert_tree_close({name: getattr(st, name)},
                              {name: getattr(ref, name)}, TOL, f"step {k}: ")
    assert not any(K.LAUNCHES.values())
    n = st.s["vehicle"]["turb"]["n"]
    assert torch.equal(n, torch.tensor(_fleet_np()[4]["vehicle"]["turb"][
        "n"]) + STEPS)


def test_monte_carlo_draws_match_jax(jax_turb):
    """`monte_carlo_c172` on a turbulent fleet from one key: the seeds and
    the fuel exactly, the winds, payloads and heights to 1e-12."""
    t, i, x, u, s = _fleet_np()
    key = 20261017
    got = Tfleet.monte_carlo_c172(_torch_state(t, i, x, u, s),
                                  R.PRNGKey(key))
    ref = Jfleet.monte_carlo_c172(_jax_state(t, i, x, u, s),
                                  jax.random.PRNGKey(key))
    seed = got.u["vehicle"]["turb"]["seed"]
    assert seed.dtype == torch.int64
    np.testing.assert_array_equal(
        seed.numpy(), np.asarray(ref.u["vehicle"]["turb"]["seed"]))
    fuel = got.x["vehicle"]["systems"]["fuel"]
    np.testing.assert_array_equal(
        fuel.numpy(), np.asarray(ref.x["vehicle"]["systems"]["fuel"]))
    for name in ("x", "u"):
        assert_tree_close({name: getattr(got, name)},
                          {name: jax.tree.map(np.asarray,
                                              getattr(ref, name))}, TOL_OP)


def _jax_loads(jax_turb, st):
    y = jax_turb["output"](st)
    return np.linalg.norm(np.asarray(y.vehicle.dynamics.f_c_c), axis=-1) \
        / 9.80665


def test_loads_match_jax(jax_turb, jax_steps):
    """`fleet_rollout_loads` over 10 steps sampled every 5 against the
    compiled JAX step and `vmap(sim.output)`: the peaks to 1e-9, the final
    state to 1e-9 and `exceedance` exactly (thresholds between the peaks,
    and a NaN peak exceeding every one)."""
    t, i, x, u, s = _fleet_np()
    final, peaks = Tfleet.fleet_rollout_loads(
        _port_sim(), _torch_state(t, i, x, u, s), 10, sample_every=5)
    st = _jax_state(t, i, x, u, s)
    peak = _jax_loads(jax_turb, st)
    for k in range(10):
        st = jax_turb["step"](st)
        if (k + 1) % 5 == 0:
            peak = np.maximum(peak, _jax_loads(jax_turb, st))
    assert_close(peaks, peak, TOL, "peaks")
    assert_tree_close({"x": final.x}, {"x": jax.tree.map(np.asarray, st.x)},
                      TOL)
    srt = np.sort(peak)
    th = list(0.5 * (srt[1:] + srt[:-1]))
    for p_t, p_j in ((peaks, peak),
                     (torch.cat([peaks[:-1], torch.tensor([math.nan])]),
                      np.concatenate([peak[:-1], [np.nan]]))):
        np.testing.assert_array_equal(
            Tfleet.exceedance(p_t, th).numpy(),
            np.asarray(Jfleet.exceedance(jnp.asarray(p_j), th)))
    assert 0.0 < float(Tfleet.exceedance(peaks, th)[3]) < 1.0
    with pytest.raises(ValueError, match="multiple of sample_every"):
        Tfleet.fleet_rollout_loads(_port_sim(), _torch_state(t, i, x, u, s),
                                   7)


@pytest.mark.slow
def test_loads_match_jax_rollout_loads():
    """`fleet_rollout_loads` against JAX's own (its scan of the fleet step
    at the flagship's geoid_every of 128), 20 steps."""
    t, i, x, u, s = _fleet_np()
    world = Jc.flagship_world("wa", turbulence=JT.DrydenTurbulence(DT))
    jsim = JSimulation(world, dt=DT, periodic_dt=DT, geoid_every=128,
                       gear_gate_margin=10.0)
    jfinal, jpeaks = Jfleet.fleet_rollout_loads(jsim, _jax_state(
        t, i, x, u, s), 20)
    final, peaks = Tfleet.fleet_rollout_loads(
        _port_sim(128), _torch_state(t, i, x, u, s), 20)
    assert_close(peaks, np.asarray(jpeaks), TOL, "peaks")
    assert_tree_close({"x": final.x}, {"x": jax.tree.map(np.asarray,
                                                         jfinal.x)}, TOL)


def test_gust_load_demo_small():
    """The gust-load study at batch 8 for 2 s on the CPU, under the bounds
    of `tests/test_missions.py:95-99`: peaks finite in (0.7, 5), the
    exceedance fractions monotone in the threshold, none terminated."""
    from flightjax_torch.demos.c172_demos import turbulent_fleet_loads
    final, peaks, frac = turbulent_fleet_loads(batch=8, t_end=2.0, W20=10.0,
                                               device="cpu", dtype=F64)
    peaks, frac = peaks.numpy(), frac.numpy()
    assert peaks.shape == (8,) and np.all(np.isfinite(peaks))
    assert np.all(peaks > 0.7) and np.all(peaks < 5.0)
    assert np.all(np.diff(frac) <= 1e-12)
    assert float(final.s["terminated"].sum()) == 0.0
    assert int(final.i[0]) == 100


def test_refusals():
    """The subsystems split carries no turbulence (as JAX's has no
    turbulent instance); the kernels carry the turbulent fly-by-wire
    vehicle (its own layout) and the turbulent C172Xv2's megakernel
    (`megakernel_gdc_turb`); and a turbulence whose hold interval is not
    the step's is refused."""
    from flightjax_torch.models.c172 import c172x as Tx
    from flightjax_torch.physics.aircraftbase import SimpleWorld
    sim = _port_sim()
    st = _torch_state(*_fleet_np())
    with pytest.raises(NotImplementedError, match="subsystems split"):
        make_cluster_step(sim, st, split="subsystems")
    fbw = Tx.build_vehicle(device="cpu", dtype=F64)
    fbw.turbulence = TT.DrydenTurbulence(DT)
    assert K.layout_of(fbw) is K.FBW_TURB
    xv2 = Simulation(SimpleWorld(Tx.build_xv2(
        device="cpu", dtype=F64, turbulence=TT.DrydenTurbulence(DT))))
    lay = K.avionics_layout(xv2.system.aircraft.vehicle,
                            xv2.system.aircraft.avionics)
    assert lay is K.GDC_TURB and lay.mega_name == "megakernel_gdc_turb"
    assert K.mega_refusal(lay) is None
    with pytest.raises(ValueError, match="does not match"):
        Simulation(sim.system, dt=0.01)


def test_megakernel_turb_buffers_roundtrip():
    """The turbulent megakernel's buffers (84 rows t, X, CTX, C and the
    int32 rows i, seed, n) round-trip through pack / unpack exactly, seeds
    and counters above 2^24 included."""
    sim = _port_sim()
    st = turb_operand_state(turb_operands(B, 1016), "cpu", F64)
    bufs, _, unpack = make_megakernel_step(sim, st)
    assert tuple(bufs[0].shape) == (84, B)
    assert tuple(bufs[1].shape) == (3, B) and bufs[1].dtype == torch.int32
    back = unpack(bufs)
    for name in ("t", "i", "x", "u", "s"):
        a, b = (tree_leaves_with_path(getattr(v, name)) for v in (back, st))
        assert [p for p, _ in a] == [p for p, _ in b]
        for (p, va), (_, vb) in zip(a, b):
            assert torch.equal(va, vb.to(va.dtype)), (name, p)
    assert int(bufs[1][1].max()) > 2 ** 24 and int(bufs[1][2].max()) > 2 ** 24


def _csrc(name):
    with open(os.path.join(os.path.dirname(K.__file__), os.pardir, "csrc",
                           name)) as fh:
        return fh.read()


def test_turb_layouts_match_csrc():
    """The turbulent row maps of `parallel/kernels.py` against
    `csrc/turbulence.cuh` and `csrc/c172_systems.cuh`: the rows of each
    group and of each kernel's buffers, the inputs' order."""
    from test_torch_support import _constexprs, _enums
    src = _csrc("c172_systems.cuh")
    env = _constexprs(_csrc("flight_math.cuh"), {})
    env = _constexprs(_csrc("turbulence.cuh"), env)
    for members in _enums(src).values():
        env.update({m: i for i, m in enumerate(members)})
    env = _constexprs(src, env)
    block = re.search(r"enum : int \{\s*(N_X_TURB[^}]*)\}", src).group(1)
    for item in re.sub(r"//[^\n]*", "", block).split(","):
        name, expr = item.split("=")
        env[name.strip()] = eval(expr.strip(), {}, dict(env))
    lay = K.TURB
    assert env["N_XTURB"] == K.rows((K.X_TURB,))
    assert env["N_UTURB"] == K.rows((K.U_TURB,))
    assert env["N_ETA"] == K.rows((K.S_TURB,))
    assert env["N_X_TURB"] == K.rows(lay.x_groups)
    assert env["N_CTX_TURB"] == K.rows(lay.ctx_groups)
    assert env["STAGE_N_IN_TURB"] == K.rows(lay.stage_in)
    assert env["STAGE_N_OUT_TURB"] == K.rows(lay.stage_out)
    assert env["RKFIN_N_IN_TURB"] == K.rows(lay.rkfin_in)
    assert env["RKFIN_N_OUT_TURB"] == K.rows(lay.rkfin_out)
    assert env["MEGA_N_ROWS_TURB"] == K.rows(lay.mega)
    assert env["N_TURB_INT"] == len(K.TURB_INT)
    o = 0
    for key, w in K.U_TURB:
        assert env["TU_" + {"W20": "W20", "gust_amp": "AMP", "gust_t0": "T0",
                            "gust_T": "TG", "shear_z0_ft": "Z0"}[key]] == o
        o += w
    assert [env["TI_" + k] for k in ("I", "SEED", "N")] == [0, 1, 2]
    head = K.system_params(Tc.build_vehicle(
        device="cpu", dtype=F64, turbulence=TT.DrydenTurbulence(DT)))
    assert float(head[env["P_TURB_K_ETA"]]) == math.sqrt(math.pi / DT)


# the modules this slice added to the port, which the source scan of
# `tests/test_torch_c172x.py` walks with the rest of the package
NEW_MODULES = ("ops/random.py", "physics/turbulence.py", "demos/__init__.py",
               "demos/c172_demos.py")


def test_turb_paths_never_import_jax():
    """The slice's new modules are among the port's sources the scan reads
    and import neither jax nor flightjax; building the turbulent fleet,
    randomizing it and stepping it through the three entry points and the
    loads leaves JAX out of the process."""
    import subprocess
    import sys
    pkg = os.path.join(os.path.dirname(K.__file__), os.pardir)
    bad = re.compile(r"^\s*(import|from)\s+(jax|flightjax)(\.|\s|$)", re.M)
    for name in NEW_MODULES:
        with open(os.path.join(pkg, name)) as fh:
            assert not bad.search(fh.read()), name
    code = (
        "import sys, torch\n"
        "from flightjax_torch.testing import turb_fleet_sim\n"
        "from flightjax_torch.parallel import fleet\n"
        "from flightjax_torch.ops import random as R\n"
        "from flightjax_torch.parallel.clusterstep import make_cluster_step\n"
        "from flightjax_torch.parallel.megakernel import "
        "make_megakernel_step\n"
        "sim, st = turb_fleet_sim(4, 1, 'cpu', torch.float32)\n"
        "st = fleet.monte_carlo_c172(st, R.PRNGKey(3))\n"
        "sim.fleet_step(st, i=0)\n"
        "make_cluster_step(sim, st._replace(c=None))(st._replace(c=None), "
        "i=0)\n"
        "b, f, u = make_megakernel_step(sim, st)\n"
        "u(f(b))\n"
        "fleet.fleet_rollout_loads(sim, st, 5)\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'jaxlib', "
        "'flightjax.')) for m in sys.modules), 'jax imported'\n")
    root = os.path.join(os.path.dirname(__file__), os.pardir)
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, PYTHONPATH=root))
    assert proc.returncode == 0, proc.stderr[-3000:]


@pytest.mark.slow
def test_turbulent_start_is_jax_trim():
    """The turbulent flagship's start (the trim of c172s_flagship.npz with
    the turbulence's initial trees) against JAX's `c172s.trim` of the
    turbulent vehicle at W20 = 0: every leaf to 1e-9."""
    veh = Jc.build_vehicle("wa", turbulence=JT.DrydenTurbulence(DT))
    x, u, s, _, rnorm = Jc.trim(veh)
    _, st, _ = Tc.turbulent_flagship_sim("cpu", F64)
    for name, ref in (("x", x), ("u", u), ("s", s)):
        assert_tree_close({name: getattr(st, name)["vehicle"]},
                          {name: jax.tree.map(np.asarray, ref)}, TOL)
    assert float(rnorm) < 1e-6
