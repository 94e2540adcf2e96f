"""The paper's delay models (§II-B/C/D, Eqs. 3-8).

Deterministic numpy functions of device and channel parameters: the
simulator draws a heterogeneous device population and evaluates these,
and the KKT optimizer (core/kkt.py) inverts them. Units: seconds, Hz,
watts, bits. Copy of the part of repro/core/delay.py that the dense,
scenario-free simulator and the DEFL plan use; the arithmetic is the
reference's, so clocks are bit-identical to it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np

from repro_torch.configs.base import ComputeConfig, WirelessConfig


# ---------------------------------------------------------------------------
# Computation model (Eqs. 3-5)
# ---------------------------------------------------------------------------


def gpu_frequency(cc: ComputeConfig) -> float:
    """Eq. 3: f_m = 1 / (a_s + a_c/f_c + a_M/f_M)."""
    return 1.0 / (cc.a_s + cc.a_c / cc.core_freq_hz + cc.a_m / cc.mem_freq_hz)


def cycles_per_iteration(cc: ComputeConfig) -> float:
    """G_m: GPU cycles for one mini-batch-size-1 iteration (cycles/bit x
    bits/sample)."""
    return cc.cycles_per_bit * cc.bits_per_sample


def per_client_compute_time(
    b: float, G: Sequence[float], f: Sequence[float],
) -> np.ndarray:
    """Vectorized Eq. 4: T_cp^m = G_m * b / f_m for every device, (M,)."""
    return np.asarray(G, np.float64) * b / np.asarray(f, np.float64)


def round_compute_time(b: float, G: Sequence[float], f: Sequence[float]) -> float:
    """Eq. 5: synchronous straggler bound T_cp = max_m T_cp^m."""
    return float(np.max(per_client_compute_time(b, G, f)))


# ---------------------------------------------------------------------------
# Communication model (Eqs. 6-7)
# ---------------------------------------------------------------------------


def uplink_rate(wc: WirelessConfig, p_m, h_m):
    """Shannon rate B*log2(1 + p*h/N0) in bits/s. N0 is total noise power
    over the band (noise PSD x bandwidth)."""
    n0_w = 10 ** (wc.noise_dbm_per_hz / 10.0) * 1e-3 * wc.bandwidth_hz
    snr = p_m * h_m / n0_w
    return wc.bandwidth_hz * np.log2(1.0 + snr)


def per_client_uplink_time(
    update_bits: float, wc: WirelessConfig,
    p: Sequence[float], h: Sequence[float],
) -> np.ndarray:
    """Vectorized Eq. 6: T_cm^m = s / rate for every device, (M,)."""
    return update_bits / uplink_rate(
        wc, np.asarray(p, np.float64), np.asarray(h, np.float64))


def round_comm_time(
    update_bits: float, wc: WirelessConfig,
    p: Sequence[float], h: Sequence[float],
) -> float:
    """Eq. 7: synchronous T_cm = max_m T_cm^m."""
    return float(np.max(per_client_uplink_time(update_bits, wc, p, h)))


# ---------------------------------------------------------------------------
# Round time (Eq. 8)
# ---------------------------------------------------------------------------


def round_time(T_cm: float, T_cp: float, V: int) -> float:
    """Eq. 8: T = T_cm + V * T_cp."""
    return T_cm + V * T_cp


# ---------------------------------------------------------------------------
# Device population (heterogeneity draw for the simulator)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class DevicePopulation:
    """Per-device compute (G_m, f_m) and channel (p_m, h_m) draws."""

    G: np.ndarray  # cycles per sample per iteration
    f: np.ndarray  # effective processor frequency, Hz
    p: np.ndarray  # tx power, W
    h: np.ndarray  # channel gain

    @property
    def n(self) -> int:
        return len(self.G)


def draw_population(
    n_devices: int,
    cc: ComputeConfig,
    wc: WirelessConfig,
    seed: int = 0,
    heterogeneity: float = 0.3,
) -> DevicePopulation:
    """Draw a heterogeneous device population.

    G_m and f_m jitter log-normally around the paper's nominal values;
    channel gains follow exponential (Rayleigh-power) fading around the
    mean pathloss. heterogeneity=0 gives the paper's homogeneous setting.
    The RNG calls are the reference's, in its order, so the same seed
    draws the same population.
    """
    rng = np.random.default_rng(seed)
    G0 = cycles_per_iteration(cc)
    f0 = gpu_frequency(cc)
    jitter = lambda: np.exp(rng.normal(0.0, heterogeneity, n_devices))  # noqa: E731
    h = wc.mean_channel_gain * (
        rng.exponential(1.0, n_devices) if heterogeneity > 0
        else np.ones(n_devices))
    return DevicePopulation(
        G=G0 * jitter() if heterogeneity > 0 else np.full(n_devices, G0),
        f=f0 / jitter() if heterogeneity > 0 else np.full(n_devices, f0),
        p=np.full(n_devices, wc.tx_power_w),
        h=h,
    )
