"""Fleets of aircraft stepped together (port of `broadcast_state` and
`fleet_rollout` from `flightjax/parallel/fleet.py:25-59`)."""

import torch

from flightjax_torch.core.modeling import tree_map


def broadcast_state(state, batch):
    """Tile a single-aircraft SimState across a leading fleet axis (a
    contiguous copy per leaf)."""
    return tree_map(
        lambda l: l.expand((batch,) + tuple(l.shape)).contiguous(), state)


def fleet_rollout(sim, state, n_steps):
    """Step a fleet `n_steps` times. The shared step counter is read from
    the device once, here, and then kept on the host, so the geoid cadence
    needs no per-step synchronisation."""
    i = int(state.i[0])
    if not bool(torch.all(state.i == i)):
        raise ValueError("fleet lanes must share one step counter")
    for _ in range(int(n_steps)):
        state = sim.fleet_step(state, i=i)
        i += 1
    return state
