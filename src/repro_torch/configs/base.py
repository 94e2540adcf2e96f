"""Federated / wireless / compute configs (the paper's system model).

Copy of the FL configs in repro/configs/base.py, kept here so the port
imports nothing of the reference package."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass(frozen=True)
class WirelessConfig:
    """Paper §II-C communication model parameters (Eq. 6)."""

    bandwidth_hz: float = 20e6  # B = 20 MHz
    noise_dbm_per_hz: float = -174.0  # N_o
    tx_power_w: float = 0.5  # p_m
    # Channel gains h_m are drawn per device by the simulator; this is the
    # mean pathloss used when a deterministic value is needed.
    mean_channel_gain: float = 1e-8


@dataclass(frozen=True)
class ComputeConfig:
    """Paper §II-B computation model parameters (Eqs. 3-4)."""

    # GPU frequency model constants (Eq. 3), from Abe et al. [12].
    a_s: float = 1e-10
    a_c: float = 0.7
    a_m: float = 0.3
    core_freq_hz: float = 2.0e9  # f_c (paper: 2 GHz cap)
    mem_freq_hz: float = 7.0e9  # f_M
    cycles_per_bit: float = 30.0  # G_m base (paper: 30 cycles/bit)
    # Per-sample bits processed per iteration (dataset dependent).
    bits_per_sample: float = 28 * 28 * 8.0


@dataclass(frozen=True)
class FedConfig:
    """DEFL algorithm configuration (Alg. 1)."""

    n_devices: int = 10  # M
    epsilon: float = 0.01  # preset global convergence error
    theta: float = 0.15  # relative local error (theta* from Eq. 29)
    batch_size: int = 32  # b (b* from Eq. 29)
    nu: float = 2.0  # ν: step-size/gradient-noise constant (Remark 3)
    c: float = 1.0  # big-O constant of Eq. 12
    lr: float = 0.01
    update_bytes: Optional[int] = None  # s; None -> actual param bytes
    # Beyond-paper: int8 update compression on the uplink.
    compress_updates: bool = False
    seed: int = 0

    @property
    def local_rounds(self) -> int:
        """V = ν·log(1/θ) (Remark 3), at least 1."""
        return max(int(round(self.nu * np.log(1.0 / max(self.theta, 1e-9)))), 1)
