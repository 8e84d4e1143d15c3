"""Stochastic rounding fp32 -> bf16 of the port (``ops/stochastic.py``) vs the
JAX package's ``d9d_tpu/ops/stochastic.py`` on the CPU.

The JAX Pallas kernel cannot run here (its on-chip PRNG has no CPU lowering,
even in interpret mode), so the port's plain version is held, as the JAX
package's own tests hold theirs, to the rule and to the distribution:

- the rule ``_sr_bits`` bitwise against the JAX rule on the same bits, and
  the whole function with injected random bits bitwise against the JAX
  composition ``stochastic.py:39-51`` (NaN: both NaN);
- the four semantic tests of ``tests/optim/test_stochastic_adamw.py``;
- against JAX's ``stochastic_round_to_bf16`` on the same inputs (other
  random bits): both land only on the two neighbours and round up equally
  often, within 0.01.

The counter-based bits are held to an independent numpy ``uint32`` copy of
the hash (numpy's ``uint32`` products wrap as the kernel's do). The kernel
computes the same bits and is held to the plain version bit for bit on the
card by ``chip_smoke.py``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from d9d_tpu.ops import stochastic as jsr
from d9d_tpu_torch.ops import stochastic as tsr

torch.set_num_threads(1)


def _patterns(n=4096, seed=0):
    """fp32 bit patterns: random, denormal, ±0, ±inf, NaNs, near FLT_MAX,
    values exact in bf16."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    special = np.array([
        0x00000000, 0x80000000, 0x00000001, 0x807FFFFF, 0x00400000,
        0x7F800000, 0xFF800000, 0x7FC00000, 0x7F800001, 0xFFFFFFFF,
        0x7F7FFFFF, 0xFF7FFFFF, 0x7F7F0000, 0x3F800000, 0xBF808000,
    ], np.uint32)
    bits[: len(special)] = special
    return bits


def _t64(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def test_sr_bits_bitwise_against_jax():
    x_bits = _patterns()
    rand = np.random.default_rng(1).integers(
        0, 2**32, x_bits.shape, dtype=np.uint64).astype(np.uint32)
    want = np.asarray(jsr._sr_bits(jnp.asarray(x_bits), jnp.asarray(rand)))
    got = tsr._sr_bits(_t64(x_bits), _t64(rand)).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))


def test_rounding_with_injected_bits_bitwise_against_jax_composition():
    x_bits = _patterns()
    x = x_bits.view(np.float32)
    rand = np.random.default_rng(2).integers(
        0, 2**32, x.shape, dtype=np.uint64).astype(np.uint32)
    # stochastic.py:39-51 with the bits injected in place of jax.random.bits
    xf = jnp.asarray(x)
    bits = jax.lax.bitcast_convert_type(xf, jnp.uint32)
    out = jax.lax.bitcast_convert_type(
        jsr._sr_bits(bits, jnp.asarray(rand)), jnp.float32)
    want = np.asarray(jnp.where(jnp.isfinite(xf), out, xf).astype(jnp.bfloat16)
                      .astype(jnp.float32))
    got = tsr.stochastic_round_to_bf16_with_bits(
        torch.from_numpy(x.copy()), _t64(rand))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(got[~nan].view(np.uint32),
                                  want[~nan].view(np.uint32))
    # a finite value next to FLT_MAX may round up to inf, as in the JAX rule
    assert np.isinf(want).sum() > 2


def _np_fmix32(h):
    h = h ^ (h >> np.uint32(16))
    h = h * np.uint32(0x85EBCA6B)
    h = h ^ (h >> np.uint32(13))
    h = h * np.uint32(0xC2B2AE35)
    return h ^ (h >> np.uint32(16))


@pytest.mark.parametrize("seed", [0, 7, 2**63 + 12345, 2**64 - 1])
def test_random_bits_are_the_counter_hash(seed):
    n = 1000
    idx = np.arange(n, dtype=np.uint64)
    k0, k1 = np.uint32(seed & 0xFFFFFFFF), np.uint32(seed >> 32)
    with np.errstate(over="ignore"):
        h = _np_fmix32(idx.astype(np.uint32) ^ k0)
        want = _np_fmix32(h ^ (idx >> np.uint64(32)).astype(np.uint32) ^ k1)
    got = tsr.random_bits(seed, n).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))
    # the bits of element i do not depend on how many elements are drawn
    np.testing.assert_array_equal(tsr.random_bits(seed, 10).numpy(), got[:10])


def test_fold_seed_separates_count_leaf_and_role():
    seeds = {tsr.fold_seed(0, count, leaf, role)
             for count in (1, 2) for leaf in range(3) for role in range(3)}
    assert len(seeds) == 18
    assert tsr.fold_seed(5, 1, 2, 0) == tsr.fold_seed(5, 1, 2, 0)
    assert tsr.fold_seed(5, 1, 2, 0) != tsr.fold_seed(6, 1, 2, 0)
    assert all(0 <= s < 2**64 for s in seeds)


# the four semantic tests of tests/optim/test_stochastic_adamw.py, on the
# port's plain version


def test_lands_on_neighbours():
    x = torch.full((1024,), 1.0 + 1 / 256.0)  # between bf16 grid points
    out = tsr.stochastic_round_to_bf16(x, 0)
    vals = set(np.unique(out.float().numpy()).tolist())
    assert vals == {1.0, 1.0 + 1 / 128.0}


def test_mean_preserving():
    lo, hi = 1.0, 1.0 + 1 / 128.0
    x = torch.full((200_000,), lo + (hi - lo) * 0.25)
    out = tsr.stochastic_round_to_bf16(x, 1).float()
    assert abs(float((out > lo).float().mean()) - 0.25) < 0.01
    assert abs(float(out.double().mean()) - float(x[0])) < 1e-5


def test_exact_values_unchanged():
    x = torch.tensor([0.0, -0.0, 1.0, -2.0, 0.5, 2.0**-130])
    out = tsr.stochastic_round_to_bf16(x, 2)
    np.testing.assert_array_equal(out.float().numpy().view(np.uint32),
                                  x.numpy().view(np.uint32))


def test_nonfinite_passthrough():
    x = torch.tensor([float("inf"), float("-inf"), float("nan")])
    o = tsr.stochastic_round_to_bf16(x, 3).float().numpy()
    assert np.isposinf(o[0]) and np.isneginf(o[1]) and np.isnan(o[2])


@pytest.mark.parametrize("frac", [0.125, 0.5, 0.75])
def test_distribution_matches_jax_function(frac):
    """Same inputs, each side's own random bits: only the two neighbours,
    and the share rounded up agrees within 0.01 (both near ``frac``)."""
    lo, hi = -3.0, -3.0 - 1 / 64.0  # neighbours in bf16 at |x| = 3
    x = np.full(100_000, lo + (hi - lo) * frac, np.float32)
    jout = np.asarray(jsr.stochastic_round_to_bf16(
        jnp.asarray(x), jax.random.PRNGKey(4)).astype(jnp.float32))
    tout = tsr.stochastic_round_to_bf16(torch.from_numpy(x), 4).float().numpy()
    for out in (jout, tout):
        assert set(np.unique(out).tolist()) == {lo, hi}
    jshare, tshare = float((jout == hi).mean()), float((tout == hi).mean())
    assert abs(jshare - tshare) < 0.01
    assert abs(tshare - frac) < 0.01


def test_same_seed_same_bits_and_out_in_place():
    x = torch.randn(257, 3, generator=torch.Generator().manual_seed(0))
    a = tsr.stochastic_round_to_bf16(x, 11)
    dst = torch.empty(257, 3, dtype=torch.bfloat16)
    before = tsr.stochastic_round_to_bf16.plain_calls
    b = tsr.stochastic_round_to_bf16(x, 11, out=dst)
    assert b is dst and tsr.stochastic_round_to_bf16.plain_calls == before + 1
    assert torch.equal(a.view(torch.int16), dst.view(torch.int16))
    c = tsr.stochastic_round_to_bf16(x, 12)
    assert not torch.equal(a.view(torch.int16), c.view(torch.int16))
    with pytest.raises(ValueError, match="out must be"):
        tsr.stochastic_round_to_bf16(x, 11, out=torch.empty(257, 3))


def test_wrapper_raises_for_a_non_cpu_non_cuda_tensor():
    fn = tsr.stochastic_round_to_bf16
    before = (fn.plain_calls, fn.launches)
    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        fn(torch.zeros(8, device="meta"), 0)
    assert (fn.plain_calls, fn.launches) == before
