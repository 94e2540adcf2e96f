"""The paper's delay models (§II-B/C/D, Eqs. 3-8).

Deterministic numpy functions of device and channel parameters: the
simulator draws a heterogeneous device population and evaluates these,
and the KKT optimizer (core/kkt.py) inverts them. Units: seconds, Hz,
watts, bits. Copy of repro/core/delay.py; the arithmetic is the
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


def local_compute_time(b: float, G_m: float, f_m: float) -> float:
    """Eq. 4: T_cp^m = G_m * b / f_m (one mini-batch SGD iteration)."""
    return G_m * b / f_m


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


def uplink_time(update_bits: float, wc: WirelessConfig, p_m: float,
                h_m: float) -> float:
    """Eq. 6: T_cm^m = s / rate."""
    return update_bits / uplink_rate(wc, p_m, h_m)


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


def effective_uplink_times(
    update_bits: float, wc: WirelessConfig,
    p: Sequence[float], h_att: np.ndarray, attempts: np.ndarray,
    backoff_base: float = 0.0, backoff_factor: float = 2.0,
) -> np.ndarray:
    """Per-client uplink time under retransmission (fault path).

    A client that made `a` attempts occupies the channel for the SUM of
    its per-attempt Eq. 6 airtimes (each against that attempt's realized
    gain, h_att[..., k]) plus the exponential-backoff waits before
    attempts 2..a (backoff_base * backoff_factor**(k-1) before attempt
    k+1). Clients with attempts == 0 (absent/crashed) fall back to their
    attempt-0 single-shot time, so the zero-participation
    full-population clock fallback stays meaningful.

    Shapes: p (M,) or broadcastable; h_att (..., M, A); attempts (..., M)
    int. Returns (..., M) float64, vectorized over an optional leading
    round axis: each row of the (R, M, A) chunk case is bit-identical to
    the per-round call.
    """
    h_att = np.asarray(h_att, np.float64)
    attempts = np.asarray(attempts)
    p = np.asarray(p, np.float64)
    t_att = per_client_uplink_time(update_bits, wc, p[..., None], h_att)
    k = np.arange(h_att.shape[-1])
    used = k < attempts[..., None]
    t_used = np.where(used, t_att, 0.0).sum(axis=-1)
    wait = np.where((k >= 1) & used,
                    backoff_base * np.power(backoff_factor, k - 1.0),
                    0.0).sum(axis=-1)
    return np.where(attempts > 0, t_used + wait, t_att[..., 0])


# ---------------------------------------------------------------------------
# Round / overall time (Eq. 8, Eq. 13)
# ---------------------------------------------------------------------------


def finish_times(t_cp, t_cm, V: int) -> np.ndarray:
    """Per-client round finish time V * T_cp^m + T_cm^m (float64, Eqs.
    4+6): with a round deadline in force, `finish <= deadline` is the
    feasibility mask of the simulator's deadline cut."""
    return (np.asarray(t_cp, np.float64) * V
            + np.asarray(t_cm, np.float64))


def round_time(T_cm: float, T_cp: float, V: int, deadline=None) -> float:
    """Eq. 8: T = T_cm + V * T_cp, truncated at the server's round
    deadline when one is set (the server stops waiting at `deadline`
    seconds and aggregates what arrived)."""
    T = T_cm + V * T_cp
    return min(deadline, T) if deadline is not None else T


def masked_round_times(
    t_cp: Sequence[float], t_cm: Sequence[float], mask: Sequence[bool],
) -> tuple[float, float]:
    """(T_cm, T_cp) as the straggler max over *participating* clients.

    Eq. 5/7 restricted to the round's realized population: absent clients
    neither compute nor upload, so they cannot be the straggler. A
    zero-participation round falls back to the full-population max (the
    server's synchronous wait times out at the slowest possible client).
    """
    t_cp = np.asarray(t_cp, np.float64)
    t_cm = np.asarray(t_cm, np.float64)
    mask = np.asarray(mask, bool)
    if not mask.any():
        return float(np.max(t_cm)), float(np.max(t_cp))
    return float(np.max(t_cm[mask])), float(np.max(t_cp[mask]))


def chunk_round_times(
    t_cp: Sequence[float], t_cm: Sequence[float], mask: Sequence[bool],
) -> tuple[np.ndarray, np.ndarray]:
    """`masked_round_times` over a leading round axis: t_cp (M,) or
    (R, M), t_cm and mask (R, M) -> (T_cm, T_cp), each (R,) float64, with
    the same zero-participation fallback. A max over a selected subset is
    exact, so each row is bit-identical to a per-round call."""
    mask = np.asarray(mask, bool)
    t_cp = np.broadcast_to(np.asarray(t_cp, np.float64), mask.shape)
    t_cm = np.broadcast_to(np.asarray(t_cm, np.float64), mask.shape)
    any_p = mask.any(axis=1)

    def mmax(t):
        masked = np.where(mask, t, -np.inf).max(axis=1)
        return np.where(any_p, masked, t.max(axis=1))

    return mmax(t_cm), mmax(t_cp)


def overall_time(H: float, T: float) -> float:
    """Eq. 13: the overall time H * T."""
    return H * T


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


def population_round_times(
    pop: DevicePopulation, b: float, update_bits: float, wc: WirelessConfig,
) -> tuple[float, float]:
    """(T_cm, T_cp) for a population at batch size b (Eqs. 5, 7)."""
    T_cp = round_compute_time(b, pop.G, pop.f)
    T_cm = round_comm_time(update_bits, wc, pop.p, pop.h)
    return T_cm, T_cp
