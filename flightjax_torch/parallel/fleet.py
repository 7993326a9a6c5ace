"""Fleets of aircraft stepped together (port of `flightjax/parallel/
fleet.py` without its mesh part, `shard_fleet`, `sharded_rollout_fn` and
`sharded_loads_fn`): `broadcast_state`, `fleet_step_fn`, `fleet_rollout`,
`fleet_metrics`, the gust-load study's `fleet_rollout_loads` and
`exceedance`, and `monte_carlo_c172` on the stream of `ops/random.py`,
whose draws equal the JAX package's for the same key."""

import torch

from flightjax_torch.core.modeling import tree_map
from flightjax_torch.ops import random as R
from flightjax_torch.physics.atmosphere import G_STD, norm3


def broadcast_state(state, batch):
    """Tile a single-aircraft SimState across a leading fleet axis (a
    contiguous copy per leaf)."""
    return tree_map(
        lambda l: l.expand((batch,) + tuple(l.shape)).contiguous(), state)


def _shared_counter(state):
    i = int(state.i[0])
    if not bool(torch.all(state.i == i)):
        raise ValueError("fleet lanes must share one step counter")
    return i


def fleet_step_fn(sim, ctx=()):
    """The fleet step as a function of the state alone (`fleet.py:31-35`):
    `Simulation.fleet_step` with the shared step counter read from the
    state (one device read a step; `fleet_rollout` keeps it on the
    host)."""
    return lambda st: sim.fleet_step(st, ctx, i=_shared_counter(st))


def fleet_rollout(sim, state, n_steps):
    """Step a fleet `n_steps` times. The shared step counter is read from
    the device once, here, and then kept on the host, so the geoid cadence
    needs no per-step synchronisation."""
    i = _shared_counter(state)
    for _ in range(int(n_steps)):
        state = sim.fleet_step(state, i=i)
        i += 1
    return state


def fleet_metrics(state):
    """Fleet-level summaries (`fleet.py:59-65`): the mean time and, for a
    world state, the terminated fraction."""
    out = {"t": torch.mean(state.t)}
    if isinstance(state.s, dict) and "terminated" in state.s:
        out["terminated_frac"] = torch.mean(
            state.s["terminated"].to(state.t.dtype))
    return out


def fleet_loads(sim, state):
    """Each lane's load factor |f_c_c| / g at `state` (`Simulation.output`,
    plain PyTorch)."""
    f = sim.output(state).vehicle.dynamics.f_c_c
    return norm3(f) / G_STD


def fleet_rollout_loads(sim, state, n_steps, ctx=(), sample_every=5):
    """Roll the fleet forward while tracking each lane's peak load factor
    n = |f_c| / g, sampled at the start and every `sample_every` steps
    (`fleet.py:68-108`). Returns (final state, peak n [batch])."""
    n_outer, rem = divmod(int(n_steps), int(sample_every))
    if rem:
        raise ValueError("n_steps must be a multiple of sample_every")
    if ctx != ():
        raise NotImplementedError("the step takes no context")
    i = _shared_counter(state)
    peak = fleet_loads(sim, state)
    for _ in range(n_outer):
        for _ in range(int(sample_every)):
            state = sim.fleet_step(state, i=i)
            i += 1
        peak = torch.maximum(peak, fleet_loads(sim, state))
    return state, peak


def exceedance(peaks, thresholds):
    """For each threshold the fraction of lanes whose peak exceeds it; a
    NaN peak (a lane that diverged) exceeds every threshold
    (`fleet.py:111-122`). Returns [len(thresholds)]."""
    peaks = torch.as_tensor(peaks)
    peaks = torch.where(torch.isnan(peaks), torch.full_like(peaks, torch.inf),
                        peaks)
    th = torch.as_tensor(thresholds, dtype=peaks.dtype, device=peaks.device)
    return torch.mean((peaks[None, :] > th[:, None]).to(peaks.dtype), dim=1)


def monte_carlo_c172(state, key, wind_std=5.0, payload_std=15.0,
                     fuel_range=(0.2, 0.9), h_jitter=50.0):
    """Per-lane randomized NED wind, payload masses, fuel load and altitude
    over a batched C172 world SimState, and each turbulent lane's own noise
    stream (`fleet.py:125-175`), drawn from `key` (`ops/random.PRNGKey`)
    exactly as the JAX package draws them. The draws take the state's
    float dtype, and integers of the matching width (int64 beside
    float64, JAX's default int under x64; int32 beside float32)."""
    dtype = state.t.dtype
    itype = torch.int64 if dtype == torch.float64 else torch.int32
    batch = state.t.shape[0]
    k_wind, k_pld, k_fuel, k_h, k_turb = R.split(key, 5)

    u = state.u
    veh_u = dict(u["vehicle"])
    veh_u["atm"] = dict(veh_u["atm"], wind=wind_std * R.normal(
        k_wind, (batch, 3), dtype))
    sys_u = dict(veh_u["systems"])
    pld = dict(sys_u["pld"])
    for j, name in enumerate(("pilot", "copilot", "baggage")):
        kk = R.fold_in(k_pld, j)
        pld[name] = torch.clamp(
            pld[name] + payload_std * R.normal(kk, (batch,), dtype), 0.0,
            100.0)
    sys_u["pld"] = pld
    veh_u["systems"] = sys_u
    if "turb" in veh_u:
        base = R.randint(k_turb, (), 0, 2 ** 31 - 1 - batch, itype)
        veh_u["turb"] = dict(veh_u["turb"], seed=base + torch.arange(
            batch, dtype=itype, device=key.device))

    veh_x = dict(state.x["vehicle"])
    veh_x["systems"] = dict(veh_x["systems"], fuel=R.uniform(
        k_fuel, (batch,), dtype, fuel_range[0], fuel_range[1]))
    kin_x = dict(veh_x["kinematics"])
    kin_x["h_e"] = kin_x["h_e"] + h_jitter * R.normal(k_h, (batch,), dtype)
    veh_x["kinematics"] = kin_x
    return state._replace(x=dict(state.x, vehicle=veh_x),
                          u=dict(u, vehicle=veh_u))
