"""C172 studies (port of the parts of `flightjax/demos/c172_demos.py` the
port carries): the certification-style gust-load study of a turbulent
Monte Carlo fleet."""

import torch

from flightjax_torch.models.c172.c172s import turbulent_flagship_sim
from flightjax_torch.ops import random as R
from flightjax_torch.parallel import fleet


def turbulent_fleet_loads(batch=256, t_end=60.0, dt=0.02, W20=10.0,
                          thresholds=(1.5, 2.0, 2.5), seed=0, device="cuda",
                          dtype=torch.float32):
    """A Monte Carlo C172S fleet flies `t_end` s through MIL-F-8785C Dryden
    turbulence of severity `W20` (20-ft wind, m/s), tracking each lane's
    peak load factor (`c172_demos.py:165-204`): the turbulent flagship
    (`c172s.turbulent_flagship_sim`: dt, geoid every 128 steps, the gear
    gate's margin, Kahan-compensated position in float32) broadcast to
    `batch` lanes, randomized by `monte_carlo_c172` from PRNGKey(seed),
    every lane at W20. Returns (final fleet state, per-lane peak n,
    exceedance fractions over `thresholds`)."""
    sim, state, _ = turbulent_flagship_sim(device, dtype, dt)
    st = fleet.broadcast_state(state, batch)
    st = fleet.monte_carlo_c172(st, R.PRNGKey(seed, st.t.device))
    uv = st.u["vehicle"]
    turb_u = dict(uv["turb"], W20=torch.full((batch,), float(W20),
                                             dtype=dtype, device=st.t.device))
    st = st._replace(u=dict(st.u, vehicle=dict(uv, turb=turb_u)))
    n_steps = int(round(t_end / dt))
    n_steps -= n_steps % 5  # the loads' sampling cadence
    final, peaks = fleet.fleet_rollout_loads(sim, st, n_steps=n_steps)
    return final, peaks, fleet.exceedance(peaks, list(thresholds))
