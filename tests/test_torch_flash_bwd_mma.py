"""The arithmetic of the tensor-core flash backward (``csrc/flash_bwd_mma.cuh``:
bf16 dq and dk/dv) against the plain backward and the JAX Pallas backward,
under the bf16 rule of the split kernels in ``chip_smoke.py``.

The CUDA kernels run only on the card, where ``chip_smoke.py`` holds them
against ``flash_attention_bwd_plain``. What changes against the plain
version is where the kernels round: the products take bf16 operands and sum
in fp32, and p and ds are rounded to bf16 before the second products (dv =
p^T.do, dk = ds^T.q, dq = ds.k); each output is rounded once. This file
writes that arithmetic as a plain PyTorch emulation and holds it to the rule
on small shapes (causal, window, segments, positive and negative shifts,
GQA groups of 2 and 8), so that the rule's constants are tied to the
arithmetic that they allow; the lost-tile emulations must break the rule.
The rule's constants are read from ``chip_smoke.py`` so the two cannot drift.
"""
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from d9d_tpu.ops.attention import pallas_flash as jflash
from d9d_tpu_torch.ops.attention import flash as tflash

torch.set_num_threads(1)

_SPEC = importlib.util.spec_from_file_location(
    "chip_smoke", pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py")
cs = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(cs)

BF16 = torch.bfloat16


def emulate_mma_bwd(q, k, v, do, lse, delta, *, causal=True, window_size=None,
                    q_segments=None, kv_segments=None, q_offset=0,
                    k_offset=0):
    """(dq, dk, dv) in bf16 as the tensor-core kernels compute them: products
    of the bf16 inputs summed in fp32; s masked to -1e30 and p = exp(s - lse)
    ungated, as in the plain version; p and ds rounded to bf16 before the
    second products; each output rounded to bf16 once."""
    b, t, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    scale = d ** -0.5
    qf = q.float().reshape(b, t, hkv, g, d)
    dof = do.float().reshape(b, t, hkv, g, d)
    kf, vf = k.float(), v.float()
    s = torch.einsum("bthgd,bshd->bhgts", qf, kf) * scale
    mask = tflash._mask(t, t, q.device, causal, window_size, q_segments,
                        kv_segments, q_offset, k_offset)
    s = torch.where(mask, s, torch.full_like(s, tflash.NEG_BIG))
    p = torch.exp(s - lse.float().reshape(b, hkv, g, t, 1))
    dp = torch.einsum("bthgd,bshd->bhgts", dof, vf)
    ds = p * (dp - delta.float().reshape(b, hkv, g, t, 1)) * scale
    p16, ds16 = p.to(BF16).float(), ds.to(BF16).float()
    dq = torch.einsum("bhgts,bshd->bthgd", ds16, kf).reshape(b, t, hq, d)
    dk = torch.einsum("bhgts,bthgd->bshd", ds16, qf)
    dv = torch.einsum("bhgts,bthgd->bshd", p16, dof)
    return dq.to(BF16), dk.to(BF16), dv.to(BF16)


def _inputs(b, t, hq, hkv, d, seed, **kw):
    """bf16 q, k, v, do from numpy, and the forward's o, lse and the
    cotangent's delta = rowsum(do * o), as the training path gives them."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.from_numpy(
        rng.standard_normal((b, t, h, d)).astype(np.float32)).to(BF16)
        for h in (hq, hkv, hkv, hq))
    o, lse = tflash.flash_attention_plain(q, k, v, **kw)
    delta = torch.einsum("bthd,bthd->bht", do.float(), o.float()).contiguous()
    return q, k, v, do, o, lse, delta


def _segments(b, t, seed):
    rng = np.random.default_rng(seed + 100)
    return torch.from_numpy(
        np.sort(rng.integers(0, 3, (b, t)), axis=1).astype(np.int32))


# (T, Hq, Hkv, mask keywords); D = 64, B = 2
_CASES = {
    "causal": (256, 4, 2, dict()),
    "causal_g8": (200, 8, 1, dict()),
    "window": (256, 4, 2, dict(window_size=50)),
    "segments": (200, 8, 1, dict(segments=True)),
    "shift_past": (256, 4, 2, dict(q_offset=256, k_offset=0)),
    "shift_positive_partial": (200, 4, 2, dict(q_offset=37, k_offset=0)),
    "shift_negative_causal": (256, 8, 1, dict(q_offset=0, k_offset=40)),
    "shift_negative_window_non_causal": (
        200, 4, 2, dict(q_offset=0, k_offset=30, causal=False,
                        window_size=64)),
}


def _case(name):
    t, hq, hkv, kw = _CASES[name]
    kw = dict(kw)
    if kw.pop("segments", False):
        seg = _segments(2, t, seed=t)
        kw.update(q_segments=seg, kv_segments=seg)
    return _inputs(2, t, hq, hkv, 64, seed=len(name), **kw), kw


@pytest.mark.parametrize("name", list(_CASES))
def test_emulated_tensor_core_backward_is_within_the_bf16_rule(name):
    (q, k, v, do, o, lse, delta), kw = _case(name)
    want = tflash.flash_attention_bwd_plain(q, k, v, do, lse, delta, **kw)
    got = emulate_mma_bwd(q, k, v, do, lse, delta, **kw)
    for label, g, w in zip(("dq", "dk", "dv"), got, want):
        assert torch.isfinite(g.float()).all(), label
        use = cs.bwd_tolerance_use(g, w, BF16)
        # within the rule, and the rounding of p and ds does show
        assert 0.0 < use <= 1.0, (label, use)


def _lost_key_tile_dq(q, k, v, do, lse, delta):
    """The emulation's dq without the terms of keys 0..63: with those k rows
    zeroed, ds.k has no term from them and every other term is unchanged."""
    k0 = k.clone()
    k0[:, :64] = 0
    return emulate_mma_bwd(q, k0, v, do, lse, delta)[0]


@pytest.mark.parametrize("which", ["dq_without_key_tile_0",
                                   "dk_without_last_row_tile_of_head_0",
                                   "dv_without_last_row_tile_of_head_0"])
def test_lost_tile_emulations_break_the_bf16_rule(which):
    (q, k, v, do, o, lse, delta), _ = _case("causal")
    want = tflash.flash_attention_bwd_plain(q, k, v, do, lse, delta)
    if which.startswith("dq"):
        got = _lost_key_tile_dq(q, k, v, do, lse, delta)
        i = 0
    else:
        t = q.shape[1]
        do_l = do.clone()
        do_l[:, t - 64:, 0] = 0
        delta_l = torch.einsum("bthd,bthd->bht", do_l.float(),
                               o.float()).contiguous()
        i = 1 if which.startswith("dk") else 2
        got = emulate_mma_bwd(q, k, v, do_l, lse, delta_l)[i]
    assert cs.bwd_tolerance_use(got, want[i], BF16) > 10.0


def test_chip_smoke_lost_tile_controls_break_the_rule_on_the_cpu():
    (q, k, v, do, o, lse, delta), _ = _case("causal")
    want = tflash.flash_attention_bwd_plain(q, k, v, do, lse, delta)
    controls = cs._lost_tile_controls(q, k, v, do, o, lse, delta, want, BF16)
    assert set(controls) == {"dq_without_key_tile_0",
                             "dk_without_last_row_tile_of_head_0",
                             "dv_without_last_row_tile_of_head_0"}
    assert min(controls.values()) > 10.0, controls


def test_emulation_matches_the_jax_pallas_backward_under_the_rule():
    """One causal case through the JAX package's split backward kernels
    (`_bwd_call`, interpret mode, bf16 inputs): they widen to fp32 as the
    plain version does, so the emulation is held to them by the same rule."""
    q, k, v, do, o, lse, delta = _inputs(1, 128, 4, 2, 64, seed=11)
    cfg = jflash._FlashConfig(
        causal=True, scale=64 ** -0.5, window=None, has_sinks=False,
        has_segments=False, block_q=32, block_kv=32, seq_len=128,
        interpret=True)

    def jx(x):
        return jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)

    call = jax.jit(lambda *a: jflash._bwd_call(cfg, *a, None, None, None))
    want = call(jx(q), jx(k), jx(v), jx(do), jnp.asarray(lse.numpy()),
                jnp.asarray(delta.numpy()))
    got = emulate_mma_bwd(q, k, v, do, lse, delta)
    plain = tflash.flash_attention_bwd_plain(q, k, v, do, lse, delta)
    for label, g, w, pl in zip(("dq", "dk", "dv"), got, want, plain):
        w = torch.from_numpy(np.array(w.astype(jnp.float32)))
        assert cs.bwd_tolerance_use(g, w, BF16) <= 1.0, label
        # the JAX kernels and the plain version agree up to the order of sums
        assert cs.bwd_tolerance_use(pl, w, BF16, fused=True) <= 1.0, label


def test_absolute_term_covers_a_cancelled_row():
    """Under causal masking the first row sees one key, where dp = delta
    exactly and dq is 0 but for fp32 rounding: delta summed in another order
    (here in float64, then rounded) moves that row by less than half the
    absolute term of the split kernels' bf16 rule, at D = 128."""
    q, k, v, do, o, lse, delta = _inputs(2, 64, 4, 2, 128, seed=5)
    delta64 = torch.einsum("bthd,bthd->bht", do.double(),
                           o.double()).float().contiguous()
    atol = cs.BWD_RULE["split"][BF16][0]
    dq_a = tflash.flash_attention_bwd_plain(q, k, v, do, lse, delta)[0]
    dq_b = tflash.flash_attention_bwd_plain(q, k, v, do, lse, delta64)[0]
    row0 = (dq_a[:, 0].float() - dq_b[:, 0].float()).abs().max()
    assert 0.0 < float(row0) <= atol / 2


def test_fp32_and_fused_rules_are_unchanged():
    # the fused bf16 kernel runs on the tensor cores: only its absolute term
    # moved, to the split kernels' 2^-17 (dp on the tensor cores); its
    # relative and row terms are those of exact products
    assert cs.BWD_RULE["fused"][BF16] == (2.0 ** -17, 2.0 ** -7, 2.0 ** -12)
    for kind in ("split", "fused"):
        assert cs.BWD_RULE[kind][torch.float32] == (1e-4, 1e-4, 0.0)
    assert cs.BWD_RULE["split"][BF16] == (2.0 ** -17, 2.0 ** -7, 2.0 ** -7)
