"""Frozen numpy copy of the paper's delay model and of Alg. 1's plan, as the
configurations run them (homogeneous devices, no faults, the closed form).

Copied from repro_torch as it stood when the benchmark was written:
  gpu_frequency, uplink_rate, Eqs. 4-8           core/delay.py
  the closed form (Eq. 29), quantize_batch       core/kkt.py, core/defl.py
  local_rounds (V from theta)                    configs/base.py FedConfig
  compressed_bits                                federated/compression.py
The arrays keep the program's shapes (one entry a client of the
population), so numpy takes the same code paths and the float64 clock
agrees to the bit. The model enters only by its leaf shapes (`shapes`,
{leaf: shape}), which its family gives (fedbench/families/).
"""
from __future__ import annotations

import numpy as np


def n_params(shapes: dict) -> int:
    return sum(int(np.prod(s)) for s in shapes.values())


def update_bits(shapes: dict, compress: bool) -> float:
    """Wire bits of one client update of leaves `shapes` (the model
    family's param_shapes): int8 codes and one float32 scale a 1024-row
    when compressed, else the float32 parameters."""
    if not compress:
        return float(n_params(shapes) * 4 * 8.0)
    total = 0
    for shape in shapes.values():
        n = int(np.prod(shape))
        total += n * 8 + int(np.ceil(n / 1024)) * 32
    return float(total)


def _gpu_frequency(cc: dict) -> float:
    return 1.0 / (cc["a_s"] + cc["a_c"] / cc["core_freq_hz"]
                  + cc["a_m"] / cc["mem_freq_hz"])


def population(cfg: dict, M: int):
    """(G, f, p, h), (M,) each: the homogeneous population."""
    cc, wc = cfg["compute"], cfg["wireless"]
    G0 = cc["cycles_per_bit"] * cc["bits_per_sample"]
    f0 = _gpu_frequency(cc)
    return (np.full(M, G0), np.full(M, f0), np.full(M, wc["tx_power_w"]),
            wc["mean_channel_gain"] * np.ones(M))


def uplink_times(bits: float, wc: dict, p, h) -> np.ndarray:
    n0_w = 10 ** (wc["noise_dbm_per_hz"] / 10.0) * 1e-3 * wc["bandwidth_hz"]
    snr = np.asarray(p, np.float64) * np.asarray(h, np.float64) / n0_w
    return bits / (wc["bandwidth_hz"] * np.log2(1.0 + snr))


def compute_times(b: int, G, f) -> np.ndarray:
    return np.asarray(G, np.float64) * b / np.asarray(f, np.float64)


def local_rounds(theta: float, nu: float) -> int:
    return max(int(round(nu * np.log(1.0 / max(theta, 1e-9)))), 1)


def _quantize_batch(b: float) -> int:
    b = max(b, 1.0)
    lo = 2 ** int(np.floor(np.log2(b)))
    hi = lo * 2
    return int(lo if b / lo <= hi / b else hi)


def plan(cfg: dict, shapes: dict, M: int, compress: bool, K=None):
    """(b, V) the DEFL arm runs: the closed form over the population of M
    (Eq. 12's M being the cohort's K when sampled), b quantized to a power
    of two and capped at the configuration's batch_cap."""
    fed = cfg["fed"]
    bits = n_params(shapes) * 4 * 8.0
    if compress:
        bits = bits / 4.0
    G, f, p, h = population(cfg, M)
    T_cm = float(np.max(uplink_times(bits, cfg["wireless"], p, h)))
    g = float(max(G / f))
    M_eff = max(1, int(round((M if K is None else K) * 1.0)))
    eps, nu, c = fed["epsilon"], fed["nu"], fed["c"]
    inv_g = 1.0 / g
    alpha = np.sqrt(T_cm * inv_g / (M_eff ** 2 * eps * nu ** 2))
    b = max(2.0 * c * M_eff * np.sqrt(T_cm * inv_g * eps), 1.0)
    alpha = max(alpha, 1e-6)
    b = _quantize_batch(b)
    theta = float(np.exp(-alpha))
    cap = cfg.get("batch_cap")
    return (b if cap is None else min(b, cap)), local_rounds(theta, nu)


def fixed_V(V: int, nu: float) -> int:
    """V a baseline arm runs: its theta = exp(-V / nu) back through V =
    nu log(1 / theta)."""
    return local_rounds(float(np.exp(-V / nu)), nu)


def records(cfg: dict, shapes: dict, M: int, b: int, V: int, compress: bool,
            rounds: int, cohorts=None, scenario: bool = True):
    """The Eq. 8 records of `rounds` rounds from round 1 and clock 0:
    [(round, sim_time, T_cm, T_cp, uplink_bits, n_participants)].
    `cohorts` (rounds, K) restricts each round to its cohort's clients;
    without a scenario n_participants is None (every client)."""
    G, f, p, h = population(cfg, M)
    bits = update_bits(shapes, compress)
    t_cm = uplink_times(bits, cfg["wireless"], p, h)
    t_cp = compute_times(b, G, f)
    out, sim_time = [], 0.0
    for r in range(rounds):
        if cohorts is not None:
            cm, cp = t_cm[cohorts[r]], t_cp[cohorts[r]]
        else:
            cm, cp = t_cm, t_cp
        T_cm, T_cp = float(np.max(cm)), float(np.max(cp))
        n = len(cm) if scenario else None
        sim_time += T_cm + V * T_cp
        out.append((r + 1, sim_time, T_cm, T_cp,
                    float(len(cm) * bits), n))
    return out

