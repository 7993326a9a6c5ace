"""Dryden continuous-gust turbulence, MIL-F-8785C (port of
`flightjax/physics/turbulence.py`).

Five filter states ride in the vehicle's continuous state, x = {ug, vg (2),
wg (2)}, and integrate under the RK4 of the airframe; the white-noise drive
s["eta"] (3) is held over each step and redrawn in `f_step` from the stream
fold_in(fold_in(PRNGKey(0x0D27), seed), n) of `ops/random.py`, exact to the
JAX package's. u = {seed, W20, gust_amp (3), gust_t0, gust_T,
shear_z0_ft}: W20 = 0 switches the field off exactly, the "1-cosine"
discrete gust is off until gust_t0, shear_z0_ft <= 0 turns the mean-wind
shear off. Every formula keeps the reference's association order; divisions
by constants go through `rdiv` / `divc` as in the rest of the port.
"""

import math

import torch

from flightjax_torch.core.modeling import divc, rdiv
from flightjax_torch.ops import random as R

FT = 0.3048  # m per ft

# below V_MIN m/s relative airspeed the Dryden coefficients are evaluated
# at V_MIN
V_MIN = 5.0
H_AGL_MIN_FT = 10.0
H_LOW_FT = 1000.0
H_HIGH_FT = 2000.0
L_HIGH_FT = 1750.0
# the key of the drive's stream (`turbulence.py:213`)
STREAM = 0x0D27


def scales(h_agl, W20):
    """(L_u, L_v, L_w, sigma_u, sigma_v, sigma_w) in SI units at the height
    above ground h_agl [m] and the 20-ft wind W20 [m/s] (`turbulence.py:
    61-80`): the low-altitude model below 1000 ft, L = 1750 ft above 2000 ft,
    blended linearly between."""
    h_ft = torch.clamp_min(divc(h_agl, FT), H_AGL_MIN_FT)
    h_low = torch.clamp(h_ft, H_AGL_MIN_FT, H_LOW_FT)
    den = 0.177 + 0.000823 * h_low
    L_w_lo = h_low
    L_uv_lo = h_low / den ** 1.2
    sig_w = 0.1 * W20
    sig_uv_lo = sig_w / den ** 0.4
    blend = torch.clamp(divc(h_ft - H_LOW_FT, H_HIGH_FT - H_LOW_FT), 0.0,
                        1.0)
    L_u = ((1 - blend) * L_uv_lo + blend * L_HIGH_FT) * FT
    L_w = ((1 - blend) * L_w_lo + blend * L_HIGH_FT) * FT
    sig_u = (1 - blend) * sig_uv_lo + blend * sig_w
    return L_u, L_u, L_w, sig_u, sig_u, sig_w


def shear_scale(u, h_agl):
    """The multiplier of the horizontal mean wind under the logarithmic
    boundary-layer profile W20 ln(h / z0) / ln(20 ft / z0) (`turbulence.py:
    83-106`): 1 with shear off (shear_z0_ft <= 0), never negative, the
    height floored above z0 and 1e-3 ft."""
    z0 = u["shear_z0_ft"]
    h_ft = torch.maximum(divc(h_agl, FT),
                         torch.clamp_min(z0 * (1.0 + 1e-6), 1e-3))
    on = z0 > 0.0
    safe_z0 = torch.where(on, z0, torch.ones_like(z0))
    k = torch.log(h_ft / safe_z0) / torch.log(rdiv(20.0, safe_z0))
    return torch.where(on, torch.clamp_min(k, 0.0), torch.ones_like(k))


def discrete_gust(u, t):
    """The body-axes "1-cosine" gust amp/2 (1 - cos(pi (t - t0)/T)) over
    t in [t0, t0 + 2T], zero outside (`turbulence.py:109-118`)."""
    tau = (t - u["gust_t0"]) / u["gust_T"]
    env = torch.where((tau >= 0.0) & (tau <= 2.0),
                      0.5 * (1.0 - torch.cos(math.pi * tau)),
                      torch.zeros_like(tau))
    return u["gust_amp"] * env[..., None]


class DrydenTurbulence:
    """The five-state Dryden gust filter bank (`turbulence.py:121-216`);
    `dt` must equal the Simulation's step (the hold interval sets the
    drive's PSD: eta sqrt(pi / dt))."""

    def __init__(self, dt):
        self.dt = float(dt)

    @staticmethod
    def init_x(like):
        z = torch.zeros_like(like)
        return {"ug": z, "vg": torch.zeros(like.shape + (2,), dtype=like.dtype,
                                           device=like.device),
                "wg": torch.zeros(like.shape + (2,), dtype=like.dtype,
                                  device=like.device)}

    @staticmethod
    def init_u(like):
        """The inputs off: W20 = 0, the discrete gust at t0 = 1e30, shear
        off; seed 0."""
        f = lambda v: torch.full_like(like, v)
        return {"seed": torch.zeros(like.shape, dtype=torch.int32,
                                    device=like.device),
                "W20": f(0.0), "gust_amp": torch.zeros(
                    like.shape + (3,), dtype=like.dtype, device=like.device),
                "gust_t0": f(1e30), "gust_T": f(1.0),
                "shear_z0_ft": f(0.0)}

    @staticmethod
    def init_s(like):
        return {"eta": torch.zeros(like.shape + (3,), dtype=like.dtype,
                                   device=like.device),
                "n": torch.zeros(like.shape, dtype=torch.int32,
                                 device=like.device)}

    def f_ode(self, x, u, s, t, V, h_agl):
        """The filters' derivatives and the body-axes gust (..., 3)."""
        V = torch.clamp_min(V, V_MIN)
        L_u, L_v, L_w, sig_u, sig_v, sig_w = scales(h_agl, u["W20"])
        eta = s["eta"] * math.sqrt(math.pi / self.dt)

        T_u = L_u / V
        ug_dot = (eta[..., 0] - x["ug"]) / T_u

        def second_order(xv, T, eta_i):
            x1, x2 = xv[..., 0], xv[..., 1]
            x2_dot = (eta_i - x1 - 2.0 * T * x2) / (T * T)
            return torch.stack([x2, x2_dot], dim=-1)

        T_v, T_w = L_v / V, L_w / V
        x_dot = {"ug": ug_dot, "vg": second_order(x["vg"], T_v, eta[..., 1]),
                 "wg": second_order(x["wg"], T_w, eta[..., 2])}
        g = (self._gust(x, T_u, T_v, T_w, sig_u, sig_v, sig_w)
             + discrete_gust(u, t))
        return x_dot, g

    def gust(self, x, u, V, h_agl, t):
        """The body-axes gust from the states alone."""
        V = torch.clamp_min(V, V_MIN)
        L_u, L_v, L_w, sig_u, sig_v, sig_w = scales(h_agl, u["W20"])
        return (self._gust(x, L_u / V, L_v / V, L_w / V, sig_u, sig_v, sig_w)
                + discrete_gust(u, t))

    @staticmethod
    def _gust(x, T_u, T_v, T_w, sig_u, sig_v, sig_w):
        sqrt2pi = math.sqrt(2.0 / math.pi)
        sqrt1pi = math.sqrt(1.0 / math.pi)
        sqrt3 = math.sqrt(3.0)
        gu = sig_u * sqrt2pi * torch.sqrt(T_u) * x["ug"]
        gv = (sig_v * sqrt1pi * torch.sqrt(T_v)
              * (x["vg"][..., 0] + sqrt3 * T_v * x["vg"][..., 1]))
        gw = (sig_w * sqrt1pi * torch.sqrt(T_w)
              * (x["wg"][..., 0] + sqrt3 * T_w * x["wg"][..., 1]))
        return torch.stack([gu, gv, gw], dim=-1)

    def f_step(self, u, s):
        """The drive redrawn for the next step: n + 1 and eta = normal(
        fold_in(fold_in(PRNGKey(0x0D27), seed), n + 1), (3,)) in eta's
        dtype, lane by lane."""
        n = s["n"] + 1
        key = R.fold_in(R.fold_in(R.PRNGKey(STREAM, n.device), u["seed"]),
                        n)
        return {"eta": R.normal(key, (3,), s["eta"].dtype), "n": n}
