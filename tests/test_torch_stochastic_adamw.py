"""``StochasticAdamW`` of the port (``optim/stochastic_adamw.py``) vs the JAX
package's (``d9d_tpu/optim/stochastic_adamw.py``) on the CPU.

One step from the same bf16 parameters, fp32 leaves and fp32 gradients: the
moments agree within fp32 rtol 1e-6 (the same fp32 arithmetic, summed in
other orders); each bf16 parameter and bf16 moment lies within 2 bf16 ulps
of the JAX one — the two round the fp32 result stochastically with
different noise, so each picks one of the two bf16 values around fp32
values that agree to a few fp32 ulps; fp32 leaves within fp32 rtol 1e-6.
Then the JAX package's own tests of the optimizer, run on the port:
tracking an fp32 AdamW trajectory over 50 steps (tolerances of the JAX
test), bf16 moments, a quadratic that descends, and a resumed run that
repeats the noise stream bit for bit.
"""
import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from d9d_tpu.optim import StochasticAdamW as JStochasticAdamW
from d9d_tpu_torch.loop import StochasticAdamWConfig, build_optimizer
from d9d_tpu_torch.ops.stochastic import stochastic_round_to_bf16
from d9d_tpu_torch.optim import StochasticAdamW

torch.set_num_threads(1)

MOMENT_TOL = dict(rtol=1e-6, atol=0.0)


def bf16_ulps(got, want):
    """|got - want| in units of the bf16 spacing at the larger magnitude."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    mag = np.maximum(np.abs(got), np.abs(want))
    spacing = 2.0 ** (np.floor(np.log2(np.maximum(mag, 2.0 ** -126))) - 7)
    return np.abs(got - want) / spacing


def _problem(seed=0):
    """Two bf16 leaves and an fp32 one (a norm weight), fp32 grads."""
    rng = np.random.default_rng(seed)
    params = {
        "w": rng.standard_normal((16, 24)).astype(np.float32),
        "b": rng.standard_normal(40).astype(np.float32),
        "norm": (1.0 + 0.1 * rng.standard_normal(24)).astype(np.float32),
    }
    dtypes = {"w": jnp.bfloat16, "b": jnp.bfloat16, "norm": jnp.float32}
    jp = {k: jnp.asarray(v).astype(dtypes[k]) for k, v in params.items()}
    grads = {k: rng.standard_normal(v.shape).astype(np.float32)
             for k, v in params.items()}
    return jp, grads


def _torch_params(jp):
    """The JAX leaves as port parameters, in the JAX tree's leaf order."""
    out = []
    for v in jax.tree.leaves(jp):
        t = torch.from_numpy(np.array(v.astype(jnp.float32)))
        out.append(torch.nn.Parameter(
            t.to(torch.bfloat16 if v.dtype == jnp.bfloat16 else torch.float32)))
    return out


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_one_step_matches_jax(moment_dtype):
    jp, grads = _problem()
    kw = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)
    jdt = jnp.bfloat16 if moment_dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if moment_dtype == "bfloat16" else torch.float32
    jopt = JStochasticAdamW(2e-2, moment_dtype=jdt, **kw)
    jnew, jstate = jopt.update({k: jnp.asarray(v) for k, v in grads.items()},
                               jopt.init(jp), jp)
    params = _torch_params(jp)
    opt = StochasticAdamW(params, 2e-2, moment_dtype=tdt, **kw)
    opt.step([torch.from_numpy(g) for g in jax.tree.leaves(grads)])
    assert opt.count == 1 == int(jstate.count)
    for p, jv in zip(params, jax.tree.leaves(jnew)):
        want = np.asarray(jv.astype(jnp.float32))
        got = p.detach().float().numpy()
        if jv.dtype == jnp.bfloat16:
            assert p.dtype == torch.bfloat16
            assert bf16_ulps(got, want).max() <= 2
        else:
            assert p.dtype == torch.float32
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    for mine, theirs in ((opt.mu, jstate.mu), (opt.nu, jstate.nu)):
        for m, jm in zip(mine, jax.tree.leaves(theirs)):
            assert m.dtype == tdt
            got = m.float().numpy()
            want = np.asarray(jm.astype(jnp.float32))
            if moment_dtype == "bfloat16":
                assert bf16_ulps(got, want).max() <= 2
            else:
                np.testing.assert_allclose(got, want, **MOMENT_TOL)


def test_roundings_follow_the_dtypes():
    """One rounding per bf16 parameter a step (three with bf16 moments:
    parameter, m, v); fp32 leaves and fp32 moments are plain writes."""
    jp, grads = _problem()
    g = [torch.from_numpy(x) for x in jax.tree.leaves(grads)]
    for dt, per_step in ((torch.float32, 2), (torch.bfloat16, 2 + 2 * 3)):
        opt = StochasticAdamW(_torch_params(jp), 1e-2, moment_dtype=dt)
        before = stochastic_round_to_bf16.plain_calls
        opt.step(g)
        assert stochastic_round_to_bf16.plain_calls - before == per_step


def _grads_at(step):
    rng = np.random.default_rng(100 + step)
    return [rng.standard_normal(64).astype(np.float32),
            np.ones(8, np.float32)]


def test_tracks_fp32_adamw():
    """tests/optim/test_stochastic_adamw.py::test_tracks_fp32_adamw on the
    port: 50 steps against optax.adamw in fp32, same tolerances."""
    lr, wd = 1e-2, 0.1
    w0 = np.array(jnp.linspace(-1, 1, 64, dtype=jnp.float32)
                    .astype(jnp.bfloat16).astype(jnp.float32))
    params = [torch.nn.Parameter(torch.from_numpy(w0).bfloat16()),
              torch.nn.Parameter(torch.zeros(8, dtype=torch.bfloat16))]
    opt = StochasticAdamW(params, lr, b1=0.9, b2=0.999, eps=1e-8,
                          weight_decay=wd)
    ref = optax.adamw(lr, b1=0.9, b2=0.999, eps=1e-8, weight_decay=wd)
    p32 = [jnp.asarray(w0), jnp.zeros(8, jnp.float32)]
    ref_state = ref.init(p32)
    for step in range(50):
        g = _grads_at(step)
        opt.step([torch.from_numpy(x) for x in g])
        upd, ref_state = ref.update([jnp.asarray(x) for x in g], ref_state,
                                    p32)
        p32 = optax.apply_updates(p32, upd)
    for p, w in zip(params, p32):
        np.testing.assert_allclose(p.detach().float().numpy(), np.asarray(w),
                                   atol=8e-2, rtol=8e-2)
    err = params[0].detach().float().numpy() - np.asarray(p32[0])
    assert abs(err.mean()) < 5e-3
    assert params[0].dtype == torch.bfloat16


def test_moment_dtype_bf16():
    params = [torch.nn.Parameter(torch.zeros(64, dtype=torch.bfloat16))]
    opt = StochasticAdamW(params, 1e-2, moment_dtype=torch.bfloat16)
    assert opt.mu[0].dtype == opt.nu[0].dtype == torch.bfloat16
    opt.step([torch.from_numpy(_grads_at(0)[0])])
    assert opt.mu[0].dtype == torch.bfloat16
    assert params[0].dtype == torch.bfloat16
    assert float(opt.mu[0].float().abs().sum()) > 0


def test_in_trainer_loop_loss_decreases():
    w = torch.nn.Parameter(torch.full((128,), 2.0, dtype=torch.bfloat16))
    opt = StochasticAdamW([w], 5e-2)
    losses = []
    for _ in range(100):
        opt.step([2.0 * w.detach().float()])  # d/dw sum(w^2)
        losses.append(float((w.detach().float() ** 2).sum()))
    assert losses[-1] < losses[0] * 0.2


def test_resume_from_state_dict_repeats_the_noise_stream():
    def fresh():
        return [torch.nn.Parameter(torch.linspace(-1, 1, 64).bfloat16()),
                torch.nn.Parameter(torch.ones(8))]

    grads = [[torch.from_numpy(g) for g in _grads_at(s)] for s in range(6)]
    kw = dict(weight_decay=0.1, moment_dtype=torch.bfloat16, seed=7)
    unbroken = fresh()
    full = StochasticAdamW(unbroken, 1e-2, **kw)
    for g in grads:
        full.step(g)

    first = fresh()
    opt = StochasticAdamW(first, 1e-2, **kw)
    for g in grads[:3]:
        opt.step(g)
    state = opt.state_dict()
    resumed = [torch.nn.Parameter(p.detach().clone()) for p in first]
    opt2 = StochasticAdamW(resumed, 1e-2, **dict(kw, seed=0))
    opt2.load_state_dict(state)
    assert opt2.count == 3 and opt2.seed == 7
    for g in grads[3:]:
        opt2.step(g)
    for a, b in zip(resumed, unbroken):
        assert torch.equal(a.detach(), b.detach())
    for a, b in zip(opt2.mu + opt2.nu, full.mu + full.nu):
        assert a.dtype == b.dtype == torch.bfloat16 and torch.equal(a, b)


def test_reproducible_from_state():
    p1 = [torch.nn.Parameter(torch.linspace(-1, 1, 64).bfloat16())]
    p2 = [torch.nn.Parameter(p1[0].detach().clone())]
    g = [torch.from_numpy(_grads_at(0)[0])]
    for p in (p1, p2):
        StochasticAdamW(p, 1e-2, seed=7).step(g)
    assert torch.equal(p1[0].detach(), p2[0].detach())
    p3 = [torch.nn.Parameter(torch.linspace(-1, 1, 64).bfloat16())]
    StochasticAdamW(p3, 1e-2, seed=8).step(g)
    assert not torch.equal(p1[0].detach(), p3[0].detach())


def test_build_optimizer_from_config():
    params = [torch.nn.Parameter(torch.zeros(4, dtype=torch.bfloat16))]
    opt = build_optimizer(
        StochasticAdamWConfig(moment_dtype="bfloat16", seed=3, b2=0.99,
                              weight_decay=0.1), params, 1e-3)
    assert isinstance(opt, StochasticAdamW) and opt.accepts_fp32_grads
    assert opt.seed == 3 and opt.b2 == 0.99 and opt.weight_decay == 0.1
    assert opt.mu[0].dtype == torch.bfloat16
    assert build_optimizer(StochasticAdamWConfig(), params, 1e-3).mu[0].dtype \
        == torch.float32
    with pytest.raises(ValueError, match="moment_dtype"):
        build_optimizer(StochasticAdamWConfig(moment_dtype="float16"), params,
                        1e-3)
