"""The fused linear + cross-entropy of the port (``ops/linear_ce.py``) vs the
JAX package's ``linear_cross_entropy`` on the CPU: per-token loss, and the
gradients of a weighted sum of it with respect to the hidden states and the
weight.

fp32 matmul policy: tolerance rtol=1e-5, atol=1e-5 (same fp32 products,
sums and logsumexp in another order). bf16 policy: both sides round the
operands to bf16 identically and multiply them exactly into fp32 logits,
so the loss holds to rtol=1e-5 as well; the gradients pass through bf16
casts whose inputs differ in the last fp32 bits, which can flip a bf16
rounding — one bf16 step, 2^-7 relative — so they are held to rtol=1e-2,
atol=1e-3 of the largest gradient.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from d9d_tpu.ops import linear_ce as jlce
from d9d_tpu_torch.ops import linear_ce as tlce
from d9d_tpu_torch.ops.linear_ce import LM_IGNORE_INDEX, linear_cross_entropy

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(n, d, v, seed, ignore=0):
    rng = np.random.default_rng(seed)
    hidden = rng.standard_normal((n, d)).astype(np.float32)
    weight = (rng.standard_normal((v, d)) / np.sqrt(d)).astype(np.float32)
    labels = rng.integers(0, v, n).astype(np.int32)
    labels[rng.permutation(n)[:ignore]] = LM_IGNORE_INDEX
    cot = rng.standard_normal(n).astype(np.float32)
    return hidden, weight, labels, cot


def _jax(hidden, weight, labels, cot, hidden_dtype, **kw):
    def f(h, w):
        loss = jlce.linear_cross_entropy(h.astype(hidden_dtype), w,
                                         jnp.asarray(labels), **kw)
        return (loss * cot).sum(), loss

    (_, loss), grads = jax.jit(jax.value_and_grad(f, argnums=(0, 1),
                                                  has_aux=True))(
        jnp.asarray(hidden), jnp.asarray(weight))
    return [np.asarray(x, np.float32) for x in (loss, *grads)]


def _port(hidden, weight, labels, cot, hidden_dtype, **kw):
    h = torch.from_numpy(hidden).requires_grad_()
    w = torch.from_numpy(weight).requires_grad_()
    loss = linear_cross_entropy(h.to(hidden_dtype), w,
                                torch.from_numpy(labels).long(), **kw)
    assert loss.dtype == torch.float32 and loss.shape == (hidden.shape[0],)
    (loss * torch.from_numpy(cot)).sum().backward()
    return [x.detach().float().numpy() for x in (loss, h.grad, w.grad)]


_CASES = {
    "one_chunk": dict(n=24, chunk="auto"),
    "chunks_with_padding": dict(n=24, chunk=10),
    "auto_single_at_2048_tokens": dict(n=2048, d=8, v=32, chunk="auto"),
    "auto_chunks_past_2048_tokens": dict(n=2049, d=8, v=32, chunk="auto"),
    "auto_chunks_past_the_logit_budget": dict(n=1025, d=4, v=65536,
                                              chunk="auto"),
    "ignore_index": dict(n=24, chunk=8, ignore=7),
    "softcap": dict(n=24, chunk=10, softcap=3.0),
    "ignore_softcap_chunks": dict(n=30, chunk=7, ignore=5, softcap=5.0),
}


# the bf16 policy at the small shapes; the large auto-chunk shapes in fp32
_PARAMS = [(name, policy) for name in _CASES for policy in ("fp32", "bf16")
           if policy == "fp32" or _CASES[name]["n"] <= 64]


@pytest.mark.parametrize("name,policy", _PARAMS)
def test_loss_and_grads_match_jax(name, policy):
    spec = dict(_CASES[name])
    n, d, v = spec.pop("n"), spec.pop("d", 16), spec.pop("v", 96)
    hidden, weight, labels, cot = _inputs(n, d, v, seed=n + v,
                                          ignore=spec.pop("ignore", 0))
    kw = dict(chunk_size=spec.pop("chunk"), logit_softcap=spec.pop("softcap", None))
    assert not spec
    jdt, tdt = ((jnp.float32, torch.float32) if policy == "fp32"
                else (jnp.bfloat16, torch.bfloat16))
    want = _jax(hidden, weight, labels, cot, jdt, **kw)
    got = _port(hidden, weight, labels, cot, tdt, **kw)
    np.testing.assert_allclose(got[0], want[0], **TOL, err_msg="loss")
    assert (got[0][labels == LM_IGNORE_INDEX] == 0).all()
    for label, g, w in zip(("d_hidden", "d_weight"), got[1:], want[1:]):
        tol = TOL if policy == "fp32" else dict(
            rtol=1e-2, atol=1e-3 * float(np.abs(w).max()))
        np.testing.assert_allclose(g, w, **tol, err_msg=label)


def test_explicit_bf16_policy_on_fp32_hidden_matches_jax():
    hidden, weight, labels, cot = _inputs(24, 16, 96, seed=5)
    kw = dict(chunk_size=10, matmul_dtype="bf16")
    want = _jax(hidden, weight, labels, cot, jnp.float32, **kw)
    got = _port(hidden, weight, labels, cot, torch.float32, **kw)
    np.testing.assert_allclose(got[0], want[0], **TOL)
    # fp32 logits from bf16 operands: NOT the fp32 policy's result
    exact = _port(hidden, weight, labels, cot, torch.float32, chunk_size=10)
    assert np.abs(exact[0] - got[0]).max() > 1e-4


def test_auto_chunk_rule_is_the_jax_rule():
    assert (tlce._AUTO_SINGLE_CHUNK_MAX, tlce._AUTO_SINGLE_CHUNK_MAX_LOGITS) \
        == (jlce._AUTO_SINGLE_CHUNK_MAX, jlce._AUTO_SINGLE_CHUNK_MAX_LOGITS)
    assert tlce.resolve_chunk_size(2048, 32768, "auto") == 2048
    assert tlce.resolve_chunk_size(2049, 32768, "auto") == 512
    assert tlce.resolve_chunk_size(1024, 65536, "auto") == 1024
    assert tlce.resolve_chunk_size(1025, 65536, "auto") == 512
    assert tlce.resolve_chunk_size(4096, 151936, "auto") == 512
    assert tlce.resolve_chunk_size(4096, 151936, 300) == 300


def test_chunks_are_recomputed_not_stored():
    """With several chunks the backward recomputes each chunk's logits: no
    [N, V] tensor is saved for backward."""
    n, d, v, chunk = 64, 8, 512, 16
    h = torch.randn(n, d, requires_grad=True)
    w = torch.randn(v, d, requires_grad=True)
    labels = torch.randint(0, v, (n,))
    saved = []

    def pack(x):
        saved.append(tuple(x.shape))
        return x

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda x: x):
        loss = linear_cross_entropy(h, w, labels, chunk_size=chunk)
    # the largest tensor kept for backward is the weight, not a chunk's
    # [16, 512] logits (nor the [64, 512] of all tokens)
    assert saved and max(int(np.prod(s)) for s in saved) < chunk * v
    loss.sum().backward()
    assert h.grad.shape == (n, d) and w.grad.shape == (v, d)
