"""The port's int8 stochastic-rounding quantizer against the JAX reference.

The reference's plain version (`quantize_ref`) and its Pallas kernel
(`ops.quantize`, interpret mode on the CPU) draw their noise from a JAX
key; the port takes the noise as an argument. Each case draws the key's
noise with the reference's `stochastic_noise` and hands the same u to the
port: q and scale must EXACTLY equal quantize_ref's, and q the Pallas
kernel's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.quantize import ops as j_ops
from repro.kernels.quantize.ref import quantize_ref as j_quantize_ref
from repro.kernels.quantize.ref import stochastic_noise as j_noise
from repro_torch.kernels.quantize import ops, ref


def _cases():
    rng = np.random.default_rng(0)
    zero_rows = rng.normal(0, 0.05, (16, 128)).astype(np.float32)
    zero_rows[[0, 5, 15]] = 0.0
    ties = rng.normal(0, 1, (8, 256)).astype(np.float32)
    ties[:, 3] = 4.0
    ties[:, 100] = -4.0  # absmax tied between a +4 and a -4
    return {
        "zero_rows": zero_rows,
        "int8_range": (rng.normal(0, 1, (32, 256)) * 100).astype(np.float32),
        "rows_not_multiple_of_256": (rng.normal(0, 0.05, (300, 1024))
                                     ).astype(np.float32),
        "tiny_magnitudes": (rng.normal(0, 1e-30, (4, 64))).astype(np.float32),
        "tied_absmax": ties,
    }


CASES = _cases()


@pytest.mark.parametrize("name", sorted(CASES))
def test_ref_matches_jax_exactly(name):
    x = CASES[name]
    key = jax.random.PRNGKey(len(name))
    u = np.asarray(j_noise(key, x.shape))
    q_j, s_j = j_quantize_ref(jnp.asarray(x), key)
    q_p, s_p = j_ops.quantize(jnp.asarray(x), key)  # Pallas, interpret mode
    q_t, s_t = ref.quantize_ref(torch.tensor(x), torch.tensor(u))
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_p))
    # The reference's Pallas kernel in interpret mode rounds absmax/127 one
    # ulp away from its own quantize_ref on some rows (its own test holds
    # the two scales to rtol 1e-6); the port matches quantize_ref exactly.
    np.testing.assert_array_max_ulp(s_t.numpy(), np.asarray(s_p), maxulp=1)


def test_ref_matches_jax_on_non_finite_rows():
    """A NaN row gets scale 1.0 and code 0 at the NaN; an Inf row gets
    scale Inf and codes 0 — the reference's semantics, which the CUDA
    kernel states as its contract."""
    x = np.array([[1.0, np.nan, -2.0, 0.5], [np.inf, 1.0, -1.0, 0.0],
                  [1e-3, 2e-3, -3e-3, 0.0]], np.float32)
    key = jax.random.PRNGKey(0)
    u = np.asarray(j_noise(key, x.shape))
    q_j, s_j = j_quantize_ref(jnp.asarray(x), key)
    q_t, s_t = ref.quantize_ref(torch.tensor(x), torch.tensor(u))
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    assert s_t[0, 0] == 1.0 and q_t[0, 1] == 0


def test_noise_lies_on_the_8bit_grid():
    gen = torch.Generator().manual_seed(3)
    u = ref.stochastic_noise(gen, (64, 1024))
    assert u.dtype == torch.float32 and u.shape == (64, 1024)
    k = u * 256.0 - 0.5
    np.testing.assert_array_equal(k.numpy(), np.round(k.numpy()))
    assert k.min() >= 0 and k.max() <= 255
    # the grid's mean is exactly 1/2: the draw is close to it
    assert abs(float(u.mean()) - 0.5) < 5e-3


def test_noise_grid_is_the_reference_grid():
    """noise_from_bytes on the reference's bytes gives its noise bitwise."""
    key = jax.random.PRNGKey(7)
    n = 4 * 1000
    words = jax.random.bits(key, (n // 4,), jnp.uint32)
    b = np.asarray(jax.lax.bitcast_convert_type(words, jnp.uint8)).reshape(-1)
    u_t = ref.noise_from_bytes(torch.from_numpy(b.copy())).reshape(4, 1000)
    np.testing.assert_array_equal(u_t.numpy(),
                                  np.asarray(j_noise(key, (4, 1000))))


def test_cpu_tensor_takes_the_plain_path_without_a_launch():
    x = torch.from_numpy(CASES["int8_range"])
    u = ref.stochastic_noise(torch.Generator().manual_seed(0), x.shape)
    before = ops.launches
    q, s = ops.quantize(x, u)
    assert ops.launches == before
    q_r, s_r = ref.quantize_ref(x, u)
    assert torch.equal(q, q_r) and torch.equal(s, s_r)
    assert int(q.min()) >= -127 and int(q.max()) <= 127


def test_wrapper_rejects_bad_inputs():
    x = torch.zeros(4, 8)
    with pytest.raises(ValueError):
        ops.quantize(x, torch.zeros(4, 4))
    with pytest.raises(TypeError):
        ops.quantize(x.double(), x.double())
    with pytest.raises(ValueError):
        ops.quantize(x.t(), x.t())
    # an empty input would reach no launch, so the wrapper refuses it
    with pytest.raises(ValueError):
        ops.quantize(torch.zeros(0, 8), torch.zeros(0, 8))
