"""Vehicle / Aircraft / World scaffolding (port of
`flightjax/physics/aircraftbase.py:115-411`).

The update order kinematics -> air data -> systems -> dynamics of
`Vehicle.f_ode`, and the renorm -> systems step of `Vehicle.f_step`, are
carried out cluster by cluster in `parallel/clusterstep.py`. The carried
geoid undulation `s['geoid_N']` is refreshed by the fleet step on its
cadence (`refresh_geoid`, the `geoid` kernel on the card), the
deferred-geoid semantics of the JAX fleet step.
"""

from flightjax_torch.ops import geodesy as geo
from flightjax_torch.physics.atmosphere import SimpleAtmosphere
from flightjax_torch.physics.dynamics import VehicleDynamics


class Vehicle:
    """Systems + kinematics + dynamics, in an atmosphere over terrain;
    x = {kinematics, dynamics, systems}, u = {systems, atm, trn},
    s = {systems, geoid_N}."""

    def __init__(self, systems, kinematics, terrain, *, device, dtype,
                 atmosphere=None):
        self.systems = systems
        self.kinematics = kinematics
        self.dynamics = VehicleDynamics()
        self.atmosphere = atmosphere if atmosphere is not None \
            else SimpleAtmosphere()
        self.terrain = terrain
        self.geoid = geo.geoid(device, dtype)

    def refresh_geoid(self, x, s, plain=False):
        """The carried undulation refreshed under the WA position states:
        the `geoid` kernel on the card, `Geoid.height` on the CPU or with
        `plain`."""
        from flightjax_torch.parallel import kernels as K
        fn = K.geoid_plain if plain else K.geoid
        return dict(s, geoid_N=fn(self.geoid, x["kinematics"]["q_ew"]))

    def h_agl(self, x, u, s):
        """Ellipsoidal height of the body origin above the terrain."""
        trn = self.terrain.terrain_data(u["trn"])
        return x["kinematics"]["h_e"] - (trn.elevation + s["geoid_N"])


class Aircraft:
    """Vehicle + avionics; only `avionics=None` is ported (ROADMAP P9)."""

    def __init__(self, vehicle: Vehicle, avionics=None):
        if avionics is not None:
            raise NotImplementedError("avionics are not ported")
        self.vehicle = vehicle
        self.avionics = None


class SimpleWorld:
    """Aircraft in an atmosphere over terrain plus the `terminated` latch
    (`aircraftbase.py:368-411`)."""

    def __init__(self, aircraft: Aircraft):
        self.aircraft = aircraft
