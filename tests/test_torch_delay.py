"""The port's delay models (core/delay.py) against the reference's, on
the cases of tests/test_core_delay.py and tests/test_properties.py's
uplink property: every function the reference has, the same values to
the bit."""
import numpy as np
import pytest

from repro.configs.base import ComputeConfig as JCompute
from repro.configs.base import WirelessConfig as JWireless
from repro.core import delay as j_delay
from repro_torch.configs.base import ComputeConfig as TCompute
from repro_torch.configs.base import WirelessConfig as TWireless
from repro_torch.core import delay as t_delay


def test_every_public_function_is_ported():
    def public(mod):
        return {n for n, v in vars(mod).items()
                if callable(v) and not n.startswith("_")
                and getattr(v, "__module__", None) == mod.__name__}

    assert public(j_delay) == public(t_delay)


@pytest.mark.parametrize("kw", [dict(a_s=0.0, a_c=1.0, a_m=0.0,
                                     core_freq_hz=2e9), dict()])
def test_gpu_frequency_eq3(kw):
    t = t_delay.gpu_frequency(TCompute(**kw))
    assert t == j_delay.gpu_frequency(JCompute(**kw))
    assert t > 0
    assert t_delay.cycles_per_iteration(TCompute(**kw)) == \
        j_delay.cycles_per_iteration(JCompute(**kw))


@pytest.mark.parametrize("b", [1, 4, 32])
def test_local_compute_time_eq4(b):
    t = t_delay.local_compute_time(b, 1e7, 2e9)
    assert t == j_delay.local_compute_time(b, 1e7, 2e9)
    assert t == pytest.approx(b * t_delay.local_compute_time(1, 1e7, 2e9))


def test_straggler_max_eq5():
    G, f = [1e7, 2e7, 1.5e7], [2e9, 2e9, 2e9]
    t = t_delay.round_compute_time(4, G, f)
    assert t == j_delay.round_compute_time(4, G, f)
    assert t == pytest.approx(t_delay.local_compute_time(4, 2e7, 2e9))


def test_uplink_time_eq6():
    tw, jw = TWireless(), JWireless()
    r = t_delay.uplink_rate(tw, 0.5, 1e-8)
    assert r == j_delay.uplink_rate(jw, 0.5, 1e-8)
    t = t_delay.uplink_time(1e6, tw, 0.5, 1e-8)
    assert t == j_delay.uplink_time(1e6, jw, 0.5, 1e-8)
    assert t == pytest.approx(1e6 / r)


def test_uplink_time_monotone_on_the_property_ranges():
    """tests/test_properties.py's uplink property on 200 seeded draws of
    its ranges: the reference's value, positive, longer for more bits and
    shorter for more power."""
    rng = np.random.default_rng(0)
    tw, jw = TWireless(), JWireless()
    for bits, p, h in zip(rng.uniform(1e3, 1e10, 200),
                          rng.uniform(0.01, 2.0, 200),
                          np.exp(rng.uniform(np.log(1e-10), np.log(1e-6),
                                             200))):
        bits, p, h = float(bits), float(p), float(h)
        t = t_delay.uplink_time(bits, tw, p, h)
        assert t == j_delay.uplink_time(bits, jw, p, h)
        assert t > 0
        assert t_delay.uplink_time(bits * 2, tw, p, h) > t
        assert t_delay.uplink_time(bits, tw, p * 2, h) < t


def test_round_and_overall_time_eq8_eq13():
    assert t_delay.round_time(0.5, 0.1, 5) == j_delay.round_time(0.5, 0.1, 5)
    assert t_delay.round_time(0.5, 0.1, 5) == pytest.approx(1.0)
    for H, T in ((10, 1.0), (123.4, 0.0567), (1, 3)):
        assert t_delay.overall_time(H, T) == j_delay.overall_time(H, T)
    assert t_delay.overall_time(10, 1.0) == pytest.approx(10.0)


@pytest.mark.parametrize("het", [0.0, 0.5])
def test_population_round_times(het):
    tp = t_delay.draw_population(10, TCompute(), TWireless(), seed=0,
                                 heterogeneity=het)
    jp = j_delay.draw_population(10, JCompute(), JWireless(), seed=0,
                                 heterogeneity=het)
    for f in ("G", "f", "p", "h"):
        np.testing.assert_array_equal(getattr(tp, f), getattr(jp, f))
    for b, bits in ((8, 1e6), (32, 5.3e7)):
        got = t_delay.population_round_times(tp, b, bits, TWireless())
        assert got == j_delay.population_round_times(jp, b, bits,
                                                     JWireless())
        assert got == (t_delay.round_comm_time(bits, TWireless(), tp.p, tp.h),
                       t_delay.round_compute_time(b, tp.G, tp.f))


def test_chunk_round_times_matches_per_round_and_the_references():
    rng = np.random.default_rng(7)
    for _ in range(20):
        R, M = int(rng.integers(1, 9)), int(rng.integers(2, 7))
        t_cp = rng.uniform(0.1, 5.0, M)
        t_cm = rng.uniform(0.1, 5.0, (R, M))
        mask = rng.random((R, M)) < 0.5
        T_cm, T_cp = t_delay.chunk_round_times(t_cp, t_cm, mask)
        J_cm, J_cp = j_delay.chunk_round_times(t_cp, t_cm, mask)
        np.testing.assert_array_equal(T_cm, J_cm)
        np.testing.assert_array_equal(T_cp, J_cp)
        for r in range(R):
            assert (T_cm[r], T_cp[r]) == t_delay.masked_round_times(
                t_cp, t_cm[r], mask[r])
