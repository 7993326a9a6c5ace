"""Onboard sensor models: IMU, pitot-static, baro and radar altimeters, GPS,
magnetometer (port of `flightjax/physics/sensors.py:1-422`).

Every sensor is a function of the truth (KinData, AirData and the
dynamics' outputs at the same state), a small error state and draws of a
counter-based stream: `key = fold_in(fold_in(fold_in(PRNGKey(0x5E45),
seed), n), tag)` per lane. The stream is defined in float32 and cast up,
so a float64 run and a float32 run see the same noise: the draws are
`ops.random.normal_f32`, JAX's float32 normals bit for bit. Zeroing the
noise parameters makes `measure` return the truth.

The models are fleet-shaped: every leaf carries the batch's leading shape.
The parameter catalog (`imu_params`, ...) holds plain numbers, as the JAX
package's holds scalars; `param_tensors` broadcasts it over a batch, and a
Monte Carlo fleet may then set any leaf per lane. `measure_trajectory` and
`inject_fault` are not ported (ROADMAP Queue 1, P11).
"""

import math
from typing import NamedTuple

import torch

from flightjax_torch.ops import geodesy as geo
from flightjax_torch.ops import random as R
from flightjax_torch.ops.quaternions import cross, qrot_inv
from flightjax_torch.physics.atmosphere import (GAMMA, G_STD, ISA_LAYERS,
                                                P_STD, R_GAS, RHO_STD, T_STD)

KEY_BASE = 0x5E45  # the sensors' stream (the turbulence's is 0x0D27)


# ------------------------------------------------ the baro altimeter's core

def _layer_bases():
    """(h_base, T_base, p_base) of each ISA layer, in Python floats."""
    bases = []
    T, p, h = T_STD, P_STD, 0.0
    for beta, h_ceil in ISA_LAYERS:
        bases.append((h, T, p))
        dh = h_ceil - h
        if beta != 0.0:
            p = p * (1 + beta / T * dh) ** (-G_STD / (beta * R_GAS))
            T = T + beta * dh
        else:
            p = p * math.exp(-G_STD / (R_GAS * T) * dh)
        h = h_ceil
    return tuple(bases)


_ISA_BASES = _layer_bases()


def pressure_altitude(p):
    """Geopotential altitude [m] of static pressure `p` [Pa] in the standard
    atmosphere (`sensors.py:72-90`): the layer of the pressure selected
    without branches, the first layer's law below sea level."""
    h_out = None
    for (beta, _), (h_b, T_b, p_b) in zip(ISA_LAYERS, _ISA_BASES):
        if beta != 0.0:
            h = h_b + T_b / beta * ((p / p_b) ** (-beta * R_GAS / G_STD) - 1.0)
        else:
            h = h_b - R_GAS * T_b / G_STD * torch.log(p / p_b)
        h_out = h if h_out is None else torch.where(p < p_b, h, h_out)
    return h_out


# ------------------------------------------------------ the parameter catalog

def imu_params(sigma_gyro=8.7e-4, sigma_accel=0.02, rw_gyro=3.0e-5,
               rw_accel=1.0e-3, bias0_gyro=4.8e-3, bias0_accel=0.05,
               scale_gyro=0.0, scale_accel=0.0, r_imu_b=(0.0, 0.0, 0.0)):
    """Tactical/consumer-grade MEMS defaults (`sensors.py:93-117`): white
    noise per sample, bias random walk per sqrt(s), turn-on bias, scale
    factor, the IMU's lever arm from the body origin."""
    return {"sigma_gyro": sigma_gyro, "sigma_accel": sigma_accel,
            "rw_gyro": rw_gyro, "rw_accel": rw_accel,
            "bias0_gyro": bias0_gyro, "bias0_accel": bias0_accel,
            "scale_gyro": scale_gyro, "scale_accel": scale_accel,
            "r_imu_b": tuple(r_imu_b)}


def airdata_params(sigma_p=15.0, sigma_pt=15.0, bias_p=0.0, bias_pt=0.0,
                   sigma_T=0.5):
    return {"sigma_p": sigma_p, "sigma_pt": sigma_pt, "bias_p": bias_p,
            "bias_pt": bias_pt, "sigma_T": sigma_T}


def gps_params(sigma_pos=0.5, sigma_vel=0.05, gm_sigma=1.5, gm_tau=60.0):
    return {"sigma_pos": sigma_pos, "sigma_vel": sigma_vel,
            "gm_sigma": gm_sigma, "gm_tau": gm_tau}


def mag_field_ned(magnitude=None, inclination=None, declination=0.0):
    """NED geomagnetic field [T] F [cos I cos D, cos I sin D, sin I]
    (`sensors.py:133-155`), as a float64 tensor (`[..., 3]` for arrays);
    the defaults give (19, 0, 45) uT."""
    if magnitude is None:
        magnitude = math.hypot(19.0e-6, 45.0e-6)
    if inclination is None:
        inclination = math.atan2(45.0, 19.0)
    f = lambda v: torch.as_tensor(v, dtype=torch.float64)
    F, I, D = f(magnitude), f(inclination), f(declination)
    cI = torch.cos(I)
    return F[..., None] * torch.stack(torch.broadcast_tensors(
        cI * torch.cos(D), cI * torch.sin(D), torch.sin(I) * torch.ones_like(
            D)), dim=-1)


# IGRF-13 epoch-2020 degree-1 Gauss coefficients [T]: the centred tilted
# dipole (`sensors.py:158-162`)
_G10, _G11, _H11 = -29404.8e-9, -1450.9e-9, 4652.5e-9


def mag_field_dipole(lat, lon, h=0.0):
    """NED geomagnetic field [T] at a geodetic fix from the centred tilted
    dipole (`sensors.py:165-187`), tensors `[..., 3]`."""
    theta = math.pi / 2 - lat
    st, ct = torch.sin(theta), torch.cos(theta)
    sp, cp = torch.sin(lon), torch.cos(lon)
    ar3 = (geo.a / (geo.a + h)) ** 3
    m = _G11 * cp + _H11 * sp
    B_r = 2.0 * ar3 * (_G10 * ct + m * st)
    B_t = -ar3 * (-_G10 * st + m * ct)
    B_p = -ar3 * (-_G11 * sp + _H11 * cp)
    return torch.stack(torch.broadcast_tensors(-B_t, B_p, -B_r), dim=-1)


def mag_declination(B_n):
    """(declination, inclination, intensity) of a NED field vector."""
    D = torch.atan2(B_n[..., 1], B_n[..., 0])
    H = torch.hypot(B_n[..., 0], B_n[..., 1])
    I = torch.atan2(B_n[..., 2], H)
    return D, I, torch.linalg.vector_norm(B_n, dim=-1)


def mag_params(B_n=None, sigma=150.0e-9, hard_iron=(0.0, 0.0, 0.0),
               magnitude=None, inclination=None, declination=0.0):
    """The NED field (explicit, or from `mag_field_ned`), white noise and
    hard-iron offset [T] (`sensors.py:198-210`)."""
    if B_n is None:
        B_n = mag_field_ned(magnitude, inclination, declination)
    return {"B_n": B_n, "sigma": sigma, "hard_iron": tuple(hard_iron)}


def baro_params(sigma=0.3, qnh=P_STD):
    return {"sigma": sigma, "qnh": qnh}


def radar_params(sigma=0.2, h_max=762.0):
    return {"sigma": sigma, "h_max": h_max}


def suite_params(imu=None, airdata=None, gps=None, mag=None, baro=None,
                 radar=None):
    return {"imu": imu_params() if imu is None else imu,
            "airdata": airdata_params() if airdata is None else airdata,
            "gps": gps_params() if gps is None else gps,
            "mag": mag_params() if mag is None else mag,
            "baro": baro_params() if baro is None else baro,
            "radar": radar_params() if radar is None else radar}


def exact_suite_params():
    """Every noise and bias parameter zero: `measure` returns the truth
    (`sensors.py:236-249`)."""
    p = suite_params()

    def zero(d, keep=()):
        return {k: (v if k in keep else
                    (tuple(0.0 for _ in v) if isinstance(v, tuple)
                     else 0.0)) for k, v in d.items()}

    p["imu"] = zero(p["imu"], keep=("r_imu_b",))
    p["airdata"] = zero(p["airdata"])
    p["gps"] = zero(p["gps"], keep=("gm_tau",))
    p["mag"] = zero(p["mag"], keep=("B_n",))
    p["baro"] = zero(p["baro"], keep=("qnh",))
    p["radar"] = zero(p["radar"], keep=("h_max",))
    return p


VECTOR_PARAMS = ("r_imu_b", "B_n", "hard_iron")


def param_tensors(p, shape, device, dtype):
    """The catalog `p` as tensors over a batch of `shape`: scalars
    `shape`, the three vectors `shape + (3,)`."""
    out = {}
    for k, v in p.items():
        if isinstance(v, dict):
            out[k] = param_tensors(v, shape, device, dtype)
            continue
        t = torch.as_tensor(v, dtype=torch.float64).to(device=device,
                                                       dtype=dtype)
        out[k] = t.expand(tuple(shape) + ((3,) if k in VECTOR_PARAMS
                                          else ())).clone()
    return out


# ------------------------------------------------------------- the suite

class SensorData(NamedTuple):
    """One measurement epoch (`sensors.py:252-270`)."""
    omega_b: torch.Tensor
    f_b: torch.Tensor
    p_s: torch.Tensor
    p_t: torch.Tensor
    T_oat: torch.Tensor
    CAS: torch.Tensor
    h_baro: torch.Tensor
    mag_b: torch.Tensor
    gps_lat: torch.Tensor
    gps_lon: torch.Tensor
    gps_h: torch.Tensor
    gps_v_n: torch.Tensor
    gps_new: torch.Tensor
    h_radar: torch.Tensor
    radar_valid: torch.Tensor


def cas_from_pressures(p_t, p_s):
    """Calibrated airspeed from the measured impact pressure."""
    Dp = torch.clamp_min(p_t - p_s, 0.0)
    return torch.sqrt(2 * GAMMA / (GAMMA - 1) * P_STD / RHO_STD
                      * ((1 + Dp / P_STD) ** ((GAMMA - 1) / GAMMA) - 1))


def _c(v):
    """A per-lane scalar against per-lane 3-vectors."""
    return v[..., None]


class SensorSuite:
    """The full sensor complement (`sensors.py:282-422`).

    u = {"seed": int per-lane stream id, "params": `param_tensors` of the
    catalog}; s = {"b_g", "b_a": IMU bias random walks, "gm_gps": the GPS
    Gauss-Markov position error [m NED], "n": int32 epoch counter}, each
    leaf batch-leading. `f_step` advances the error processes once per
    firing; `measure` is a function of (u, s, truth)."""

    def __init__(self, dt, gps_every=1):
        self.dt = float(dt)
        self.gps_every = int(gps_every)

    def init_u(self, shape=(), *, device, dtype):
        return {"seed": torch.zeros(shape, dtype=torch.int32, device=device),
                "params": param_tensors(suite_params(), shape, device,
                                        dtype)}

    def init_s(self, u, init_key=None):
        """Error states at zero, or with `init_key` (a key, `[2]` or one per
        lane `[..., 2]`) the turn-on biases drawn at their bias0 stds and
        the Gauss-Markov state at its stationary std (`sensors.py:
        305-320`), in float64 draws as JAX's default."""
        p = u["params"]
        like = p["imu"]["sigma_gyro"]
        z = torch.zeros(like.shape + (3,), dtype=like.dtype,
                        device=like.device)
        if init_key is None:
            b_g = b_a = gm = z
        else:
            keys = R.split(init_key.to(like.device), 3)
            draw = lambda j: R.normal(keys[..., j, :], (3,),
                                      torch.float64).to(like.dtype)
            b_g = _c(p["imu"]["bias0_gyro"]) * draw(0)
            b_a = _c(p["imu"]["bias0_accel"]) * draw(1)
            gm = _c(p["gps"]["gm_sigma"]) * draw(2)
        return {"b_g": b_g, "b_a": b_a, "gm_gps": gm,
                "n": torch.zeros(like.shape, dtype=torch.int32,
                                 device=like.device)}

    @staticmethod
    def draws(seed, n, tag, count, dtype):
        """`[..., count]` standard normal draws of epoch n of lane `seed`
        in domain `tag` (0 the process noise, 1 the measurement noise),
        defined in float32 and cast to `dtype` (`sensors.py:322-336`)."""
        key = R.fold_in(R.fold_in(R.fold_in(
            R.PRNGKey(KEY_BASE, seed.device), seed), n), tag)
        return R.normal_f32(key, (count,)).to(dtype)

    @staticmethod
    def epoch_draws(seed, n, dtype):
        """`draws` of epoch n in both domains from one hash of the lane's
        epoch key: (the 9 process draws, the 20 measurement draws), the
        ones `f_step` and `measure` take at that epoch (the stream's j-th
        draw does not depend on how many are drawn)."""
        key = R.fold_in(R.fold_in(R.PRNGKey(KEY_BASE, seed.device), seed), n)
        tags = torch.tensor([0, 1], device=seed.device)
        eta = R.normal_f32(R.fold_in(key[..., None, :], tags), (20,))
        eta = eta.to(dtype)
        return eta[..., 0, :9], eta[..., 1, :]

    def f_step(self, u, s, eta=None):
        """The bias random walks and the GPS Gauss-Markov error advanced
        one firing (its exact discrete transition), the counter bumped
        (`sensors.py:338-350`); `eta` the epoch's process draws if they
        are drawn already (`epoch_draws`)."""
        p = u["params"]
        n = s["n"] + 1
        if eta is None:
            eta = self.draws(u["seed"], n, 0, 9, s["b_g"].dtype)
        sq = math.sqrt(self.dt)
        b_g = s["b_g"] + _c(p["imu"]["rw_gyro"] * sq) * eta[..., 0:3]
        b_a = s["b_a"] + _c(p["imu"]["rw_accel"] * sq) * eta[..., 3:6]
        phi = torch.exp(-self.dt / p["gps"]["gm_tau"])
        gm = (_c(phi) * s["gm_gps"]
              + _c(p["gps"]["gm_sigma"] * torch.sqrt(1.0 - phi * phi))
              * eta[..., 6:9])
        return {"b_g": b_g, "b_a": b_a, "gm_gps": gm, "n": n}

    def measure(self, u, s, kin, air, dyn, h_trn=0.0,
                eta=None) -> SensorData:
        """The measurements at the current epoch from the truth (KinData,
        AirData, DynamicsY with alpha_ib_b and mp_sum_b) and the error
        state; `h_trn` the terrain's orthometric elevation under the
        vehicle, the radar's ground (`sensors.py:354-422`); `eta` the
        epoch's measurement draws if they are drawn already. The draws are
        made on every call: with zero sigmas they add exactly zero."""
        p = u["params"]
        dtp = s["b_g"].dtype
        if eta is None:
            eta = self.draws(u["seed"], s["n"], 1, 20, dtp)

        def white(sl, sigma):
            if isinstance(sl, int):
                return sigma * eta[..., sl]
            return _c(sigma) * eta[..., sl]

        imu = p["imu"]
        om_ie = torch.zeros_like(kin.omega_eb_b)
        om_ie[..., 2] = geo.omega_ie
        omega_ib_b = kin.omega_eb_b + qrot_inv(kin.q_eb, om_ie)
        r = imu["r_imu_b"] - dyn.mp_sum_b.r_OG
        f_imu = (dyn.f_c_c + cross(dyn.alpha_ib_b, r)
                 + cross(omega_ib_b, cross(omega_ib_b, r)))
        omega_m = (omega_ib_b * _c(1.0 + imu["scale_gyro"]) + s["b_g"]
                   + white(slice(0, 3), imu["sigma_gyro"]))
        f_m = (f_imu * _c(1.0 + imu["scale_accel"]) + s["b_a"]
               + white(slice(3, 6), imu["sigma_accel"]))

        ad = p["airdata"]
        p_s = air.p + ad["bias_p"] + white(6, ad["sigma_p"])
        p_t = air.pt + ad["bias_pt"] + white(7, ad["sigma_pt"])
        p_t = torch.maximum(p_t, p_s)
        T_oat = air.T + white(8, ad["sigma_T"])
        CAS = cas_from_pressures(p_t, p_s)

        h_baro = (pressure_altitude(p_s)
                  - pressure_altitude(p["baro"]["qnh"])
                  + white(9, p["baro"]["sigma"]))

        mag_b = (qrot_inv(kin.q_nb, p["mag"]["B_n"]) + p["mag"]["hard_iron"]
                 + white(slice(10, 13), p["mag"]["sigma"]))

        d_ned = s["gm_gps"] + white(slice(13, 16), p["gps"]["sigma_pos"])
        M, N = geo.radii(kin.n_e)
        gps_lat = kin.lat + d_ned[..., 0] / (M + kin.h_e)
        gps_lon = kin.lon + d_ned[..., 1] / ((N + kin.h_e)
                                             * torch.cos(kin.lat))
        gps_h = kin.h_e - d_ned[..., 2]
        gps_v = kin.v_eb_n + white(slice(16, 19), p["gps"]["sigma_vel"])
        gps_new = (s["n"] % self.gps_every) == 0

        h_agl = kin.h_o - h_trn + white(19, p["radar"]["sigma"])
        h_max = p["radar"]["h_max"]
        radar_valid = (h_agl >= 0.0) & (h_agl <= h_max)
        h_radar = torch.minimum(torch.clamp_min(h_agl, 0.0), h_max)

        return SensorData(
            omega_b=omega_m, f_b=f_m, p_s=p_s, p_t=p_t, T_oat=T_oat,
            CAS=CAS, h_baro=h_baro, mag_b=mag_b, gps_lat=gps_lat,
            gps_lon=gps_lon, gps_h=gps_h, gps_v_n=gps_v, gps_new=gps_new,
            h_radar=h_radar, radar_valid=radar_valid)
