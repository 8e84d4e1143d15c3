"""MoE routing ops of the PyTorch port (``ops/moe.py``) and the aligned
layout (``ops/moe_ffn.py`` ``aligned_metadata``) vs the JAX package on the
CPU.

Integer outputs equal JAX's exactly (the port's int64 values against JAX's
int32 ones). Gathers are exact; the K-sum of the combine and the grouped
products are fp32 sums whose order may differ: rtol/atol 1e-6 and 1e-5.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from d9d_tpu.ops import moe as jmoe
from d9d_tpu.ops.moe_pallas import aligned_metadata as j_aligned_metadata
from d9d_tpu_torch.ops import moe as tmoe
from d9d_tpu_torch.ops.moe_ffn import aligned_metadata

torch.set_num_threads(1)


def _ids(case, seed=0):
    """(topk_ids [N, K], E): "random" — N*K = 111, a multiple of nothing
    the layout uses; "empty" — only experts 0 and 5 of 8 are chosen;
    "one" — every pair on expert 3; "wide" — 128 experts, top-8."""
    rng = np.random.default_rng(seed)
    if case == "random":
        n, k, e = 37, 3, 8
        ids = np.stack([rng.choice(e, k, replace=False) for _ in range(n)])
    elif case == "empty":
        n, k, e = 20, 2, 8
        ids = np.stack([rng.permutation([0, 5]) for _ in range(n)])
    elif case == "one":
        n, k, e = 24, 1, 6
        ids = np.full((n, k), 3)
    else:
        n, k, e = 64, 8, 128
        ids = np.stack([rng.choice(e, k, replace=False) for _ in range(n)])
    return ids.astype(np.int32), e


CASES = ["random", "empty", "one", "wide"]


@pytest.mark.parametrize("case", CASES)
def test_sort_tokens_by_expert_equals_jax(case):
    ids, e = _ids(case)
    want = jmoe.sort_tokens_by_expert(jnp.asarray(ids), e)
    got = tmoe.sort_tokens_by_expert(torch.from_numpy(ids), e)
    for name in ("sort_idx", "dest", "token_idx", "group_sizes"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    s, d, g = tmoe.stable_expert_order(torch.from_numpy(ids.reshape(-1)), e)
    js, jd, jg = jmoe.stable_expert_order(jnp.asarray(ids.reshape(-1)), e)
    for a, b in ((s, js), (d, jd), (g, jg)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("case", CASES)
def test_permute_and_combine_equal_jax(case):
    ids, e = _ids(case)
    n, k = ids.shape
    rng = np.random.default_rng(1)
    x = rng.standard_normal((n, 16)).astype(np.float32)
    probs = rng.random((n, k)).astype(np.float32)
    js = jmoe.sort_tokens_by_expert(jnp.asarray(ids), e)
    ts = tmoe.sort_tokens_by_expert(torch.from_numpy(ids), e)
    jx, jp = jmoe.permute_tokens(jnp.asarray(x), jnp.asarray(probs), js)
    tx, tp = tmoe.permute_tokens(torch.from_numpy(x), torch.from_numpy(probs),
                                 ts)
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    y = rng.standard_normal((n * k, 16)).astype(np.float32)
    want = jmoe.unpermute_combine(jnp.asarray(y), js, n)
    got = tmoe.unpermute_combine(torch.from_numpy(y), ts, n)
    # sums of K unit-normal rows: the two orders differ by a few fp32 ulps
    # of the row size where the K terms cancel
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    got2 = tmoe.combine_pairs(torch.from_numpy(y), ts.dest, n)
    np.testing.assert_array_equal(got2.numpy(), got.numpy())


@pytest.mark.parametrize("case", CASES)
def test_grouped_matmuls_match_jax(case):
    ids, e = _ids(case)
    n, k = ids.shape
    rng = np.random.default_rng(2)
    x = rng.standard_normal((n * k, 32)).astype(np.float32)
    wg = rng.standard_normal((e, 32, 16)).astype(np.float32)
    wu = rng.standard_normal((e, 32, 16)).astype(np.float32)
    js = jmoe.sort_tokens_by_expert(jnp.asarray(ids), e)
    ts = tmoe.sort_tokens_by_expert(torch.from_numpy(ids), e)
    jg, ju = jmoe.gate_up_grouped_matmul(jnp.asarray(x), jnp.asarray(wg),
                                         jnp.asarray(wu), js.group_sizes)
    before = tmoe.group_sizes_on_host.readbacks
    tg, tu = tmoe.gate_up_grouped_matmul(torch.from_numpy(x),
                                         torch.from_numpy(wg),
                                         torch.from_numpy(wu), ts.group_sizes)
    assert tmoe.group_sizes_on_host.readbacks == before + 1  # one readback
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=1e-5,
                               atol=1e-5)
    # rows past sum(group_sizes) come out zero, as ragged_dot gives them
    xt = np.concatenate([x, np.ones((5, 32), np.float32)])
    got = tmoe.grouped_matmul(torch.from_numpy(xt), torch.from_numpy(wg),
                              ts.group_sizes)
    want = jmoe.grouped_matmul(jnp.asarray(xt), jnp.asarray(wg),
                               js.group_sizes)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    assert not got[n * k:].any()


@pytest.mark.parametrize("block_m", [16, 128])
@pytest.mark.parametrize("case", CASES)
def test_aligned_metadata_equals_jax(case, block_m):
    ids, e = _ids(case)
    js = jmoe.sort_tokens_by_expert(jnp.asarray(ids), e)
    ts = tmoe.sort_tokens_by_expert(torch.from_numpy(ids), e)
    want = j_aligned_metadata(js, e, block_m)
    got = aligned_metadata(ts, e, block_m)
    assert got.m_pad == want.m_pad
    for name in ("dest_aligned", "pair_src", "gid"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    assert got.pair_src.dtype == got.gid.dtype == torch.int32
    # a tile whose first row is padding is all padding (the kernels skip
    # such tiles on that test alone)
    tiles = got.pair_src.reshape(-1, block_m)
    first_pad = tiles[:, 0] < 0
    assert bool((tiles[first_pad] < 0).all())
