"""The fused expert FFN of the PyTorch port (``ops/moe_ffn.py``) vs the JAX
package's Pallas kernels (``ops/moe_pallas.py``) in interpret mode, on the
CPU.

- Each plain version against its TPU kernel on the same aligned layout
  (``block_m`` 16): fp32 within rtol 1e-5; bf16 by the rule
  ``|err| <= 2^-7 |want| + 2^-8 max_row |want|`` — both sides multiply the
  same bf16 values in fp32, but where two fp32 sums in other orders fall on
  either side of a bf16 rounding point, the hidden or the output rounds to a
  neighbouring bf16 value: one bf16 step of the element, and a flipped
  hidden value moves its row by a share of the row's size.
- ``fused_moe_ffn_apply`` for each variant against JAX's, forward, and the
  gradients of x, probs and the three expert weights through the port's
  autograd function against JAX's ``custom_vjp`` gradients, fp32, rtol and
  atol 1e-5.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from d9d_tpu.ops import moe as jmoe
from d9d_tpu.ops import moe_pallas as jmp
from d9d_tpu_torch.ops import moe as tmoe
from d9d_tpu_torch.ops import moe_ffn as tmf

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
BM = 16
VARIANTS = {"aligned": (False, False), "gather": (True, False),
            "gather_combine": (True, True)}


def _problem(seed=0, n=48, h=64, inter=64, e=8, k=2, dtype=np.float32):
    """N = 48 (a multiple of 8, so the JAX gather variants run rather than
    falling back); N*K = 96 is not a multiple of 64 or 128."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, h)).astype(np.float32)
    wg = (rng.standard_normal((e, h, inter)) * 0.1).astype(np.float32)
    wu = (rng.standard_normal((e, h, inter)) * 0.1).astype(np.float32)
    wd = (rng.standard_normal((e, inter, h)) * 0.1).astype(np.float32)
    ids = np.stack([rng.choice(e, k, replace=False) for _ in range(n)])
    probs = (rng.random((n, k)) + 0.1).astype(np.float32)
    return x, wg, wu, wd, ids.astype(np.int32), probs


def _sorts(ids, e):
    return (jmoe.sort_tokens_by_expert(jnp.asarray(ids), e),
            tmoe.sort_tokens_by_expert(torch.from_numpy(ids), e))


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _bf16_rule(got, want):
    want = np.asarray(want, np.float64)
    err = np.abs(np.asarray(got, np.float64) - want)
    allowed = 2.0 ** -7 * np.abs(want) + 2.0 ** -8 * np.abs(want).max(
        axis=-1, keepdims=True)
    assert (err <= allowed).all(), float((err / allowed).max())


@pytest.mark.parametrize("kernel", list(VARIANTS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_version_matches_the_tpu_kernel(kernel, dtype):
    x, wg, wu, wd, ids, probs = _problem(seed=3)
    e, k = wg.shape[0], ids.shape[1]
    js, ts = _sorts(ids, e)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    jmeta = jmp.aligned_metadata(js, e, BM)
    meta = tmf.aligned_metadata(ts, e, BM)
    jw = [jnp.asarray(w).astype(jdt) for w in (wg, wu, wd)]
    tw = [_t(w, tdt) for w in (wg, wu, wd)]
    jx = jnp.asarray(x).astype(jdt)
    tx = _t(x, tdt)
    jpf = jnp.asarray(probs).reshape(-1, 1)
    tpf = _t(probs).reshape(-1)
    if kernel == "aligned":
        valid = (jmeta.pair_src >= 0)[:, None]
        src = jnp.maximum(jmeta.pair_src, 0)
        ja = jnp.where(valid, jnp.take(jx, src // k, axis=0), 0).astype(jdt)
        jap = jnp.where(valid, jnp.take(jpf[:, 0], src)[:, None], 0)
        want = jmp._fused_ffn_call(ja, jap, jmeta.gid, *jw, block_m=BM,
                                   interpret=True)
        a, p = tmf._gathered_rows(tx, tpf, meta.pair_src, k)
        np.testing.assert_array_equal(a.float().numpy(),
                                      np.asarray(ja.astype(jnp.float32)))
        got = tmf.moe_ffn_aligned(a, p, meta.gid, meta.pair_src, *tw)
    elif kernel == "gather":
        want = jmp._fused_gather_call(jx, jpf, jmeta.gid, jmeta.pair_src, *jw,
                                      block_m=BM, top_k=k, interpret=True)
        got = tmf.moe_ffn_gather(tx, tpf, meta.gid, meta.pair_src, *tw,
                                 top_k=k)
    else:
        want = jmp._fused_gather_combine_call(
            jx, jpf, jmeta.gid, jmeta.pair_src, *jw, block_m=BM, top_k=k,
            interpret=True)
        got = tmf.moe_ffn_gather_combine(tx, tpf, meta.gid, meta.pair_src,
                                         *tw, top_k=k)
    assert got.dtype == tdt and tuple(got.shape) == tuple(want.shape)
    got = got.float().numpy()
    want = np.asarray(want.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **TOL)
    else:
        _bf16_rule(got, want)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_fused_apply_values_and_grads_match_jax(variant):
    gather, combine = VARIANTS[variant]
    x, wg, wu, wd, ids, probs = _problem(seed=11)
    e = wg.shape[0]
    js, ts = _sorts(ids, e)
    cot = np.random.default_rng(5).standard_normal(x.shape).astype(np.float32)

    def jloss(*args):
        out = jmp.fused_moe_ffn_apply(
            args[0], args[1], js, *args[2:], jnp.float32, num_experts=e,
            block_m=BM, interpret=True, gather=gather, combine=combine)
        return (out * cot).sum(), out

    jargs = [jnp.asarray(a) for a in (x, probs, wg, wu, wd)]
    (_, jout), jgrads = jax.value_and_grad(
        jloss, argnums=(0, 1, 2, 3, 4), has_aux=True)(*jargs)

    targs = [_t(a).requires_grad_() for a in (x, probs, wg, wu, wd)]
    before = tmoe.group_sizes_on_host.readbacks
    tout = tmf.fused_moe_ffn_apply(
        targs[0], targs[1], ts, *targs[2:], torch.float32, num_experts=e,
        gather=gather, combine=combine)
    assert tmoe.group_sizes_on_host.readbacks == before  # forward: none
    (tout * _t(cot)).sum().backward()
    assert tmoe.group_sizes_on_host.readbacks == before + 1  # backward: one
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout), **TOL)
    for name, a, g in zip(("x", "probs", "gate", "up", "down"), targs,
                          jgrads):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(g), **TOL,
                                   err_msg=name)


def test_reference_chain_matches_jax_and_the_layout_size_changes_nothing():
    x, wg, wu, wd, ids, probs = _problem(seed=7, n=40, k=3)
    e = wg.shape[0]
    js, ts = _sorts(ids, e)
    want = jmp._reference_apply(*(jnp.asarray(a) for a in (x, probs)), js,
                                *(jnp.asarray(w) for w in (wg, wu, wd)),
                                jnp.float32)
    targs = [_t(a) for a in (x, probs, wg, wu, wd)]
    ref = tmf.reference_apply(targs[0], targs[1], ts, *targs[2:],
                              torch.float32)
    np.testing.assert_allclose(ref.numpy(), np.asarray(want), **TOL)
    for variant, (gather, combine) in VARIANTS.items():
        for bm in (8, 16, 64):
            got = tmf.fused_moe_ffn_apply(
                targs[0], targs[1], ts, *targs[2:], torch.float32,
                num_experts=e, gather=gather, combine=combine, block_m=bm)
            np.testing.assert_allclose(got.numpy(), ref.numpy(), **TOL,
                                       err_msg=f"{variant} block_m {bm}")


def test_cpu_tensors_take_the_plain_versions_and_count_them():
    x, wg, wu, wd, ids, probs = _problem()
    e = wg.shape[0]
    _, ts = _sorts(ids, e)
    fns = (tmf.moe_ffn_aligned, tmf.moe_ffn_gather, tmf.moe_ffn_gather_combine)
    before = [(f.plain_calls, f.launches) for f in fns]
    for gather, combine in VARIANTS.values():
        tmf.fused_moe_ffn_apply(_t(x), _t(probs), ts, _t(wg), _t(wu), _t(wd),
                                torch.float32, num_experts=e, gather=gather,
                                combine=combine)
    after = [(f.plain_calls, f.launches) for f in fns]
    assert after == [(p + 1, n) for p, n in before]
    with pytest.raises(ValueError, match="combine needs gather"):
        tmf.fused_moe_ffn_apply(_t(x), _t(probs), ts, _t(wg), _t(wu), _t(wd),
                                torch.float32, num_experts=e, combine=True)
