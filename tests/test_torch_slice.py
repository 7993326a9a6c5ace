"""The flagship fleet step of flightjax_torch against `jax.jit(sim.
fleet_step)` of flightjax on the flagship settings (WA kinematics, dt 0.02 s,
geoid refresh every 128 steps, gear gate at 10 m): 8 perturbed lanes, two
of them on the runway and one terminated, 3 steps from i = 126 so the geoid
refresh fires, with and without forced compensation. float64 on the CPU;
every state leaf within 1e-9 relative to max(1, |reference|) (the Pallas
paths are held to 1e-6 in tests/test_clusterstep.py)."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flightjax.core.sim import SimState as JSimState
from flightjax.core.sim import Simulation as JSimulation
from flightjax.core.sim import comp_residuals as jcomp_residuals
from flightjax.models.c172 import c172s as Jc

from flightjax_torch.core.sim import SimState, comp_residuals
from flightjax_torch.models.c172 import c172s as Tc
from flightjax_torch.parallel.fleet import fleet_rollout

from test_torch_support import (F64, TERMINATED_LANE, assert_tree_close,
                                perturbed_fleet, to_jax, to_torch)

TOL = 1e-9
I0 = 126
STEPS = 3


@pytest.fixture(scope="module")
def jax_step():
    world = Jc.flagship_world("wa")
    sim = JSimulation(world, dt=0.02, periodic_dt=0.02, geoid_every=128,
                      gear_gate_margin=10.0)
    return jax.jit(sim.fleet_step)


def _jax_c_as_tree(x, c):
    """The JAX residual list (aligned with x's flattened leaves) as the
    port's nested dict of compensated leaves."""
    out = {}
    for (path, _), cv in zip(jax.tree_util.tree_flatten_with_path(x)[0], c):
        if cv is not None:
            node = out
            keys = [p.key for p in path]
            for k in keys[:-1]:
                node = node.setdefault(k, {})
            node[keys[-1]] = np.asarray(cv)
    return out


@pytest.mark.parametrize("force_comp", [False, True],
                         ids=["uncompensated", "compensated"])
def test_fleet_step_matches_jax(jax_step, force_comp):
    t, i, x, u, s = perturbed_fleet(I0)
    ref = JSimState(t=jnp.asarray(t), i=jnp.asarray(i), x=to_jax(x),
                    u=to_jax(u), s=to_jax(s))
    sim, _, _ = Tc.flagship_sim("cpu", F64)
    got = SimState(t=torch.tensor(t), i=torch.tensor(i), x=to_torch(x),
                   u=to_torch(u), s=to_torch(s))
    if force_comp:
        ref = ref._replace(c=jcomp_residuals(ref.x, force=True))
        got = got._replace(c=comp_residuals(got.x, force=True))
    for k in range(STEPS):
        ref = jax_step(ref)
        got = sim.fleet_step(got, i=I0 + k)
    ref = jax.tree.map(np.asarray, ref)

    for name in ("t", "i", "x", "u", "s"):
        assert_tree_close({name: getattr(got, name)},
                          {name: getattr(ref, name)}, TOL)
    if force_comp:
        assert_tree_close(got.c, _jax_c_as_tree(ref.x, ref.c), TOL, "c/")
    else:
        assert got.c is None and ref.c is None
    # the refresh at step 128 moved the carried undulation, the terminated
    # lane stayed frozen, and nothing else latched
    assert not np.array_equal(ref.s["vehicle"]["geoid_N"],
                              s["vehicle"]["geoid_N"])
    assert np.array_equal(ref.s["terminated"],
                          np.arange(8) == TERMINATED_LANE)
    assert np.array_equal(ref.x["vehicle"]["kinematics"]["h_e"][
        TERMINATED_LANE], x["vehicle"]["kinematics"]["h_e"][TERMINATED_LANE])


def test_fleet_rollout_keeps_the_step_counter():
    t, i, x, u, s = perturbed_fleet(I0)
    sim, _, _ = Tc.flagship_sim("cpu", F64)
    st = SimState(t=torch.tensor(t), i=torch.tensor(i), x=to_torch(x),
                  u=to_torch(u), s=to_torch(s))
    a = fleet_rollout(sim, st, STEPS)
    b = st
    for k in range(STEPS):
        b = sim.fleet_step(b, i=I0 + k)
    for name in ("x", "s"):
        assert_tree_close(getattr(a, name), getattr(b, name), 0.0,
                          name + "/")
    assert torch.equal(a.i, torch.full_like(a.i, I0 + STEPS))
    with pytest.raises(ValueError):
        fleet_rollout(sim, st._replace(i=st.i + torch.arange(8,
                                                             dtype=torch.int32)),
                      1)


def test_port_never_imports_jax():
    """Building the flagship and stepping it through all three entry points
    (`fleet_step`, the `vehicle` split, the megakernel) leaves JAX out of
    the process."""
    code = (
        "import sys, torch\n"
        "import flightjax_torch\n"
        "from flightjax_torch.models.c172.c172s import flagship_sim\n"
        "from flightjax_torch.parallel.fleet import broadcast_state, "
        "fleet_rollout\n"
        "from flightjax_torch.parallel.clusterstep import make_cluster_step\n"
        "from flightjax_torch.parallel.megakernel import "
        "make_megakernel_step\n"
        "sim, st, _ = flagship_sim('cpu', torch.float32)\n"
        "st = broadcast_state(st, 4)\n"
        "a = fleet_rollout(sim, st, 1)\n"
        "b = make_cluster_step(sim, st, split='vehicle')(st, i=0)\n"
        "bufs, step, unpack = make_megakernel_step(sim, st)\n"
        "c = unpack(step(bufs))\n"
        "for r in (a, b, c):\n"
        "    assert bool(torch.isfinite(r.x['vehicle']['kinematics']['h_e'])"
        ".all())\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'flightjax.')) or m == 'flightjax')\n"
        "assert not bad, bad\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
