"""The port's pipeline programs and executor in one process, against the
JAX package and a sequential torch run.

- Every program builder's program (communication ops injected) equals
  JAX's, compared as ``format_program`` strings, over the ``(pp, v, m)``
  grid of JAX's ``tests/pipelining/test_e2e.py``.
- The executor without transfers (every stage in this process) over a
  tiny dense+tanh stage model is grad-exact against one sequential torch
  autograd run of the composed model, for every schedule and microbatch
  count of that grid under each residual policy: fp64, gradients and loss
  within 1e-12 (the microbatch sums may be taken in another order).
- A subset runs JAX's ``PipelineScheduleExecutor`` on the same weights
  (the flax ``Dense`` kernels carried across transposed) and the same
  microbatches: ZBV and DualPipeV under each policy, interleaved 1F1B at
  pp 4 and v 2, and the forward-only program; fp32 within rtol 1e-5.
- ``cache_acts``'s W slot runs no stage forward and no node of the carry
  chain: the stage forwards are counted, and every autograd node of the
  graph is hooked and the nodes the W slot visits are held to the weight
  edges.
"""
import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d9d_tpu.pipelining import PipelineScheduleExecutor as JExecutor
from d9d_tpu.pipelining import PipelineStageInfo as JStageInfo
from d9d_tpu.pipelining import PipelineStageRuntime as JStageRuntime
from d9d_tpu.pipelining import program as jprog
from d9d_tpu_torch.pipelining import (
    PipelineScheduleExecutor,
    PipelineStageInfo,
    PipelineStageRuntime,
)
from d9d_tpu_torch.pipelining import program as prog
from d9d_tpu_torch.pipelining.runtime import stage as stage_mod

HID, MB_SIZE = 8, 4
EXACT = dict(rtol=1e-12, atol=1e-12)
JAX_TOL = dict(rtol=1e-5, atol=1e-6)
POLICIES = ("remat", "cache_full", "cache_acts")

# (builder name, args, microbatch counts): JAX's e2e grid
GRID = (
    [("GPipe", (pp,), m) for pp in (1, 2, 4) for m in (1, 2, 4, 7)]
    + [("Interleaved1F1B", (pp,), m) for pp in (2, 4) for m in (1, 4, 7)]
    + [("Interleaved1F1B", (pp, v), m) for pp, v in ((2, 2), (4, 2))
       for m in (4, 8)]
    + [("ZB1P", (pp,), m) for pp in (2, 4) for m in (4, 8)]
    + [("LoopedBFS", (pp, v), m) for pp, v in ((2, 2), (2, 3), (4, 2))
       for m in (1, 4, 6)]
    + [("ZeroBubbleV", (pp,), m) for pp in (2, 4) for m in (2, 4, 7)]
    + [("DualPipeV", (pp,), m) for pp in (2, 4) for m in (2, 4, 7)]
    + [("Inference", (pp,), 4) for pp in (1, 4)]
)


def _builder(mod, name, args):
    if name == "ZB1P":
        return mod.Interleaved1F1BProgramBuilder(*args, zero_bubble=True)
    return getattr(mod, f"{name}ProgramBuilder")(*args)


def _id(case):
    name, args, m = case
    return f"{name}-{'x'.join(map(str, args))}-m{m}"


def _program(mod, builder, m):
    return mod.add_communication_ops(builder.compose(m),
                                     num_stages=builder.num_stages,
                                     stage_owner=builder.stage_owner)


@pytest.mark.parametrize("case", GRID, ids=_id)
def test_program_equals_jax(case):
    name, args, m = case
    ours, theirs = _builder(prog, name, args), _builder(jprog, name, args)
    assert ours.stage_owner == theirs.stage_owner
    assert (prog.format_program(_program(prog, ours, m))
            == jprog.format_program(_program(jprog, theirs, m)))


# --- the tiny stage model ------------------------------------------------

class Block(torch.nn.Module):
    def __init__(self, dtype):
        super().__init__()
        self.dense = torch.nn.Linear(HID, HID, dtype=dtype)

    def forward(self, x):
        return torch.tanh(self.dense(x))


class Task:
    """carry = activations; loss = weighted square error."""

    def split_microbatch(self, micro):
        return micro["x"], {}, {"y": micro["y"], "w": micro["w"]}

    def stage_forward(self, module, carry, kwargs):
        return module(carry)

    def last_stage_loss(self, module, carry, kwargs, state):
        err = ((module(carry) - state["y"]) ** 2).sum(-1)
        weight = state["w"].sum()
        return (err * state["w"]).sum(), weight, {"examples": weight}


def _weights(num_stages, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((HID, HID)) / np.sqrt(HID),
             rng.standard_normal(HID) * 0.1) for _ in range(num_stages)]


def _microbatches(m, seed=1):
    rng = np.random.default_rng(seed)
    return [{"x": rng.standard_normal((MB_SIZE, HID)),
             "y": rng.standard_normal((MB_SIZE, HID)),
             "w": rng.random(MB_SIZE) + 0.5} for _ in range(m)]


def _to_torch(mbs, dtype):
    return [{k: torch.tensor(v, dtype=dtype) for k, v in mb.items()}
            for mb in mbs]


def _port_stages(weights, policy, dtype):
    n = len(weights)
    stages = {}
    for s, (kernel, bias) in enumerate(weights):
        block = Block(dtype)
        with torch.no_grad():
            block.dense.weight.copy_(torch.tensor(kernel.T))
            block.dense.bias.copy_(torch.tensor(bias))
        stages[s] = PipelineStageRuntime(
            info=PipelineStageInfo(s, n), module=block, task=Task(),
            grad_dtype=dtype, residual_policy=policy)
    return stages


def _port_run(name, args, m, policy, dtype, train=True):
    b = _builder(prog, name, args)
    weights = _weights(b.num_stages)
    stages = _port_stages(weights, policy, dtype)
    ex = PipelineScheduleExecutor(
        stages=stages, program=_program(prog, b, m),
        stage_owner=b.stage_owner, num_microbatches=m, train=train)
    mbs = _microbatches(m)
    return ex.step(_to_torch(mbs, dtype)), stages, weights, mbs


def _sequential(stages, mbs, dtype):
    """Σ over microbatches of one composed forward and backward each."""
    for st in stages.values():
        st.module.zero_grad()
    total = 0.0
    for mb in _to_torch(mbs, dtype):
        h = mb["x"]
        for s in range(len(stages) - 1):
            h = stages[s].module(h)
        loss, _, _ = Task().last_stage_loss(stages[len(stages) - 1].module,
                                            h, {}, mb)
        loss.backward()
        total += loss.item()
    return total, {s: [p.grad for p in st.params] for s, st in stages.items()}


TRAIN_GRID = [c for c in GRID if c[0] != "Inference"]


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("case", TRAIN_GRID, ids=_id)
def test_executor_grad_exact_vs_sequential(case, policy):
    name, args, m = case
    result, stages, _, mbs = _port_run(name, args, m, policy, torch.float64)
    want_loss, want = _sequential(stages, mbs, torch.float64)
    np.testing.assert_allclose(result.loss_sum.item(), want_loss, rtol=1e-6)
    for s, grads in result.grads.items():
        for g, w in zip(grads, want[s]):
            np.testing.assert_allclose(g.numpy(), w.numpy(), **EXACT)


@pytest.mark.parametrize("pp", [1, 4])
def test_forward_only_program(pp):
    result, stages, _, mbs = _port_run("Inference", (pp,), 4, "remat",
                                       torch.float64, train=False)
    want_loss, _ = _sequential(stages, mbs, torch.float64)
    assert result.grads is None and len(result.outputs) == 4
    np.testing.assert_allclose(result.loss_sum.item(), want_loss, rtol=1e-6)


# --- against JAX's executor ---------------------------------------------

class JBlock(nn.Module):
    @nn.compact
    def __call__(self, x):
        return jnp.tanh(nn.Dense(HID, use_bias=True)(x))


class JTask:
    def split_microbatch(self, micro):
        return micro["x"], {}, {"y": micro["y"], "w": micro["w"]}

    def stage_forward(self, module, params, carry, kwargs):
        return module.apply(params, carry)

    def last_stage_loss(self, module, params, carry, kwargs, state):
        err = ((module.apply(params, carry) - state["y"]) ** 2).sum(-1)
        weight = state["w"].sum()
        return (err * state["w"]).sum(), weight, {"examples": weight}


def _jax_run(name, args, m, policy, train=True):
    b = _builder(jprog, name, args)
    weights = _weights(b.num_stages)
    stages = {}
    for s, (kernel, bias) in enumerate(weights):
        params = {"params": {"Dense_0": {
            "kernel": jnp.asarray(kernel, jnp.float32),
            "bias": jnp.asarray(bias, jnp.float32)}}}
        stages[s] = JStageRuntime(
            info=JStageInfo(stage_index=s, num_stages=b.num_stages),
            module=JBlock(), params=params, task=JTask(),
            residual_policy=policy)
    ex = JExecutor(stages=stages, program=_program(jprog, b, m),
                   stage_owner=b.stage_owner, num_microbatches=m,
                   train=train)
    mbs = [{k: jnp.asarray(v, jnp.float32) for k, v in mb.items()}
           for mb in _microbatches(m)]
    return ex.step(mbs)


JAX_CASES = ([("ZeroBubbleV", (2,), 4, p) for p in POLICIES]
             + [("DualPipeV", (2,), 4, p) for p in POLICIES]
             + [("Interleaved1F1B", (4, 2), 4, "remat")])


@pytest.mark.parametrize("case", JAX_CASES,
                         ids=lambda c: f"{_id(c[:3])}-{c[3]}")
def test_executor_matches_jax(case):
    name, args, m, policy = case
    ours, _, _, _ = _port_run(name, args, m, policy, torch.float32)
    theirs = _jax_run(name, args, m, policy)
    np.testing.assert_allclose(ours.loss_sum.item(),
                               float(theirs.loss_sum), **JAX_TOL)
    np.testing.assert_allclose(ours.weight_sum.item(),
                               float(theirs.weight_sum), **JAX_TOL)
    for s, (gw, gb) in ours.grads.items():
        dense = theirs.grads[s]["params"]["Dense_0"]
        np.testing.assert_allclose(gw.numpy(), np.asarray(dense["kernel"]).T,
                                   **JAX_TOL)
        np.testing.assert_allclose(gb.numpy(), np.asarray(dense["bias"]),
                                   **JAX_TOL)


def test_forward_only_program_matches_jax():
    ours, _, _, _ = _port_run("Inference", (4,), 4, "remat", torch.float32,
                              train=False)
    theirs = _jax_run("Inference", (4,), 4, "remat", train=False)
    np.testing.assert_allclose(ours.loss_sum.item(), float(theirs.loss_sum),
                               **JAX_TOL)
    assert len(ours.outputs) == len(theirs.outputs) == 4


# --- the split backward's W slot ----------------------------------------

def _all_nodes(roots):
    seen, stack = set(), list(roots)
    while stack:
        node = stack.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        stack.extend(n for n, _ in node.next_functions)
    return seen


@pytest.mark.parametrize("last", [False, True], ids=["middle", "last"])
def test_cache_acts_weight_slot_runs_no_carry_chain(last):
    """A middle (or last) stage of three: the W slot visits only the
    intermediates and the nodes on the weights' side, never a node of the
    carry chain, and runs no forward; its gradients equal the fused
    backward's."""
    torch.manual_seed(0)
    stage = PipelineStageRuntime(
        info=PipelineStageInfo(2 if last else 1, 3),
        module=torch.nn.Sequential(Block(torch.float64), Block(torch.float64)),
        task=Task(), grad_dtype=torch.float64, residual_policy="cache_acts")
    mb = _to_torch(_microbatches(1), torch.float64)[0]
    carry, _, state = Task().split_microbatch(mb)
    fl, _ = stage.begin(carry, {}, state)
    assert stage.forward_calls == 1
    out = fl.out
    visited: list = []
    nodes = _all_nodes([out.grad_fn])
    for node in nodes:
        node.register_prehook(lambda g, node=node: visited.append(node))
    cot = None if last else torch.randn_like(out)
    leaf = [t for t in [fl.carry]][0]
    carry_node = stage_mod._grad_node(leaf)
    rev = stage_mod._reverse_edges([out.grad_fn])
    chain, _ = stage_mod._closure([carry_node], set(), rev)
    gc, _ = stage.backward_input(fl, cot)
    intermediates = {n for g in fl.groups for n in g.intermediates}
    assert intermediates and intermediates < chain
    in_i = set(visited)
    visited.clear()
    stage.backward_weight(fl)
    in_w = set(visited)
    assert stage.forward_calls == 1  # no forward in either slot
    assert in_w, "the W slot visited no node"
    assert not (in_w & (chain - intermediates)), "W re-ran the carry chain"
    assert (in_w - intermediates).isdisjoint(in_i - intermediates)
    got = [g.clone() for g in stage.grads()]
    # the fused backward on a fresh forward gives the same gradients
    stage.reset_grads()
    fl2, _ = stage.begin(carry, {}, state)
    gc2, _ = stage.backward_full(fl2, cot)
    for a, b in zip(got, stage.grads()):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **EXACT)
    np.testing.assert_allclose(gc.numpy(), gc2.numpy(), **EXACT)


def test_weight_slot_before_input_slot_raises():
    stage = PipelineStageRuntime(
        info=PipelineStageInfo(1, 3), module=Block(torch.float64),
        task=Task(), grad_dtype=torch.float64, residual_policy="cache_acts")
    mb = _to_torch(_microbatches(1), torch.float64)[0]
    fl, _ = stage.begin(mb["x"], {}, None)
    with pytest.raises(RuntimeError, match="weight backward before"):
        stage.backward_weight(fl)


class _Linear(torch.autograd.Function):
    """A parameterised custom function: an intermediate whose node its
    Python object holds only weakly."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return x @ w.T

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        return g @ w, g.T @ x


class _CustomBlock(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.randn(HID, HID, dtype=torch.float64))
        self.scale = torch.nn.Parameter(torch.ones(HID, dtype=torch.float64))

    def forward(self, x):
        return torch.tanh(_Linear.apply(x, self.w)) * self.scale


@pytest.mark.parametrize("last", [False, True], ids=["middle", "last"])
def test_cache_acts_custom_function_intermediate(last):
    """The W slot replays a custom autograd.Function's node after the I
    slot dropped the graph's output (and a garbage collection ran): the
    gradients equal the fused backward's."""
    import gc

    torch.manual_seed(1)
    stage = PipelineStageRuntime(
        info=PipelineStageInfo(2 if last else 1, 3), module=_CustomBlock(),
        task=Task(), grad_dtype=torch.float64, residual_policy="cache_acts")
    mb = _to_torch(_microbatches(1), torch.float64)[0]
    carry, _, state = Task().split_microbatch(mb)
    cot = None if last else torch.randn(MB_SIZE, HID, dtype=torch.float64)
    fl, _ = stage.begin(carry, {}, state)
    gc_i, _ = stage.backward_input(fl, cot)
    gc.collect()
    stage.backward_weight(fl)
    split = [g.clone() for g in stage.grads()]
    stage.reset_grads()
    fl, _ = stage.begin(carry, {}, state)
    gc_f, _ = stage.backward_full(fl, cot)
    for a, b in zip(split, stage.grads()):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **EXACT)
    np.testing.assert_allclose(gc_i.numpy(), gc_f.numpy(), **EXACT)


# --- core/tree_sharding.py against the JAX package's ---------------------

def _tree(rng):
    return {"tokens": rng.integers(0, 9, (8, 4)),
            "x": rng.standard_normal((8, 6, 2)).astype(np.float32),
            "names": [f"row{i}" for i in range(8)], "step": 3}


@pytest.mark.parametrize("dim", [0, 1])
def test_tree_sharding_matches_jax(dim):
    from d9d_tpu.core import tree_sharding as jts
    from d9d_tpu_torch.core import tree_sharding as ts

    tree = _tree(np.random.default_rng(dim))
    ours_in = {k: torch.tensor(v) if isinstance(v, np.ndarray) else v
               for k, v in tree.items()}
    spec, jspec = ts.shard_spec_on_dim(ours_in, dim), jts.shard_spec_on_dim(
        tree, dim)
    ours, theirs = ts.shard_tree(ours_in, spec, 2), jts.shard_tree(
        tree, jspec, 2)
    for a, b in zip(ours, theirs):
        assert a["names"] == b["names"] and a["step"] == b["step"]
        for k in ("tokens", "x"):
            np.testing.assert_array_equal(a[k].numpy(), np.asarray(b[k]))
    with pytest.raises(ValueError, match="cannot shard"):
        ts.shard_tree(ours_in, spec, 3)
