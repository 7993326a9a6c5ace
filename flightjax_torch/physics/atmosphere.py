"""ISA atmosphere and air data (port of the parts of
`flightjax/physics/atmosphere.py` the fleet step uses)."""

from typing import NamedTuple

import torch

from flightjax_torch.core.modeling import divc, rdiv
from flightjax_torch.ops import geodesy as geo
from flightjax_torch.ops.quaternions import qrot_inv

R_GAS = 287.05287
GAMMA = 1.40
BETA_S = 1.458e-6
S_SUTH = 110.4

T_STD = 288.15
P_STD = 101325.0
RHO_STD = P_STD / (R_GAS * T_STD)
G_STD = 9.80665

ISA_LAYERS = (
    (-6.5e-3, 11000.0),
    (0.0, 20000.0),
    (1e-3, 32000.0),
    (2.8e-3, 47000.0),
    (0.0, 51000.0),
    (-2.8e-3, 71000.0),
    (-2e-3, 84852.0),
)

TAS_MIN_ALPHA_BETA = 0.1


def density(p, T):
    return p / (R_GAS * T)


def speed_of_sound(T):
    return torch.sqrt(GAMMA * R_GAS * T)


def dynamic_viscosity(T):
    return (BETA_S * T ** 1.5) / (T + S_SUTH)


def isa_data(h_geop, T_sl, p_sl):
    """(T, p) at geopotential altitude through the seven ISA layers,
    unrolled (`atmosphere.py:64-85`); below sea level the first layer
    extrapolates, above the table the ceiling clamps."""
    T = torch.broadcast_to(T_sl, h_geop.shape)
    p = torch.broadcast_to(p_sl, h_geop.shape)
    h_base = 0.0
    for i, (beta, h_ceil) in enumerate(ISA_LAYERS):
        if i == 0:
            dh = torch.clamp_max(h_geop, h_ceil) - h_base
        else:
            dh = torch.clamp(h_geop, h_base, h_ceil) - h_base
        if beta != 0.0:
            T_new = T + beta * dh
            p_new = p * (1 + rdiv(beta, T) * dh) ** (-G_STD / (beta * R_GAS))
        else:
            T_new = T
            p_new = p * torch.exp(rdiv(-G_STD, R_GAS * T) * dh)
        T, p = T_new, p_new
        h_base = h_ceil
    return T, p


class AtmosphericData(NamedTuple):
    T: torch.Tensor
    p: torch.Tensor
    rho: torch.Tensor
    a: torch.Tensor
    mu: torch.Tensor
    v: torch.Tensor


class AirData(NamedTuple):
    v_ew_n: torch.Tensor
    v_ew_b: torch.Tensor
    v_wb_b: torch.Tensor
    T: torch.Tensor
    p: torch.Tensor
    rho: torch.Tensor
    a: torch.Tensor
    mu: torch.Tensor
    M: torch.Tensor
    Tt: torch.Tensor
    pt: torch.Tensor
    Dp: torch.Tensor
    q: torch.Tensor
    TAS: torch.Tensor
    EAS: torch.Tensor
    CAS: torch.Tensor


def tas2eas(TAS, rho):
    return TAS * torch.sqrt(divc(rho, RHO_STD))


def norm3(v):
    return torch.sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1]
                      + v[..., 2] * v[..., 2])


def air_data(atm: AtmosphericData, kin) -> AirData:
    """`atmosphere.py:125-147` without a gust field."""
    v_ew_n = atm.v
    v_ew_b = qrot_inv(kin.q_nb, v_ew_n)
    v_wb_b = kin.v_eb_b - v_ew_b
    TAS = norm3(v_wb_b)
    M = TAS / atm.a
    Tt = atm.T * (1 + (GAMMA - 1) / 2 * (M * M))
    pt = atm.p * (Tt / atm.T) ** (GAMMA / (GAMMA - 1))
    Dp = pt - atm.p
    q = 0.5 * atm.rho * (TAS * TAS)
    EAS = tas2eas(TAS, atm.rho)
    CAS = torch.sqrt(2 * GAMMA / (GAMMA - 1) * P_STD / RHO_STD
                     * ((1 + divc(Dp, P_STD)) ** ((GAMMA - 1) / GAMMA) - 1))
    return AirData(v_ew_n=v_ew_n, v_ew_b=v_ew_b, v_wb_b=v_wb_b, T=atm.T,
                   p=atm.p, rho=atm.rho, a=atm.a, mu=atm.mu, M=M, Tt=Tt,
                   pt=pt, Dp=Dp, q=q, TAS=TAS, EAS=EAS, CAS=CAS)


class SimpleAtmosphere:
    """ISA with tunable sea-level conditions and a uniform NED wind;
    u = {T_sl, p_sl, wind (3,)} clamped to the reference's ranges."""

    T_SL_MIN, T_SL_MAX = T_STD - 50.0, T_STD + 50.0
    P_SL_MIN, P_SL_MAX = P_STD - 10000.0, P_STD + 10000.0

    def atmospheric_data(self, u, n_e, h_orth) -> AtmosphericData:
        T_sl = torch.clamp(u["T_sl"], self.T_SL_MIN, self.T_SL_MAX)
        p_sl = torch.clamp(u["p_sl"], self.P_SL_MIN, self.P_SL_MAX)
        h_geop = geo.geop_from_orth(h_orth)
        T, p = isa_data(h_geop, T_sl, p_sl)
        return AtmosphericData(T=T, p=p, rho=density(p, T),
                               a=speed_of_sound(T), mu=dynamic_viscosity(T),
                               v=u["wind"])


def get_airflow_angles(v_wa_a):
    """(alpha, beta), gated to 0 below 0.1 m/s."""
    n = norm3(v_wa_a)
    valid = n >= TAS_MIN_ALPHA_BETA
    zero = torch.zeros_like(n)
    alpha = torch.where(valid, torch.atan2(v_wa_a[..., 2], v_wa_a[..., 0]),
                        zero)
    beta = torch.where(valid, torch.atan2(
        v_wa_a[..., 1], torch.sqrt(v_wa_a[..., 0] * v_wa_a[..., 0]
                                   + v_wa_a[..., 2] * v_wa_a[..., 2])), zero)
    return alpha, beta
