"""Flat terrain (port of `flightjax/physics/terrain.py`)."""

from typing import NamedTuple

import torch

DRY_TARMAC = 0
WET_TARMAC = 1
ICY_TARMAC = 2


class TerrainData(NamedTuple):
    elevation: torch.Tensor  # orthometric elevation (m), scalar
    normal: torch.Tensor     # (3,) inward surface normal, NED
    surface: torch.Tensor    # [B] int32 surface code


class HorizontalTerrain:
    """Flat terrain at constant orthometric elevation; u = {surface}."""

    def __init__(self, elevation=0.0, *, device, dtype):
        self.elevation = torch.tensor(float(elevation), dtype=dtype,
                                      device=device)
        self.normal = torch.tensor([0.0, 0.0, 1.0], dtype=dtype,
                                   device=device)

    def terrain_data(self, u) -> TerrainData:
        return TerrainData(elevation=self.elevation, normal=self.normal,
                           surface=u["surface"])
