"""The port's job checkpointer (``loop/components/checkpointer.py``, torch
DCP) in one process: the resume contract of
``tests/loop/test_checkpoint_resume.py`` on the tiny dense Qwen3 it
builds, and the walk-back cases of
``tests/resilience/test_checkpoint_fallback.py`` on small tensors.

- A run of 3 steps and a fresh trainer to 6 equal an unbroken 6-step run
  bit for bit (parameters, AdamW's ``mu``, ``nu`` and ``count``, the
  losses of steps 4–6); also with bf16 parameters under
  ``StochasticAdamW``.
- Async saves write what sync saves write, bit for bit (the staging is a
  copy: a later step's in-place update cannot reach a save in flight).
- Rotation keeps at most ``checkpoints_to_keep`` steps; the tracker's run
  hash is restored; prefetch on and off give the same run.
- Walk-back: manifests validate; a truncated newest data file falls back
  to the previous step bit for bit and the corrupt step is pruned and can
  be saved again; all steps corrupt raises; an empty directory gives
  ``None``; a step without a manifest restores unverified, and when its
  data is broken it is skipped but not pruned; a save killed mid-way
  restores an intact step.
- Two ranks: a save waits for rank 0 to clear and make the step's
  directory before any rank's DCP writer makes it.
"""
import json
import os
import pathlib
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

from d9d_tpu_torch.core import MeshParameters
from d9d_tpu_torch.loop import (
    AdamWProvider,
    CausalLMTask,
    DatasetProvider,
    ModelProvider,
    OptimizerProvider,
    StatefulDataLoader,
    StochasticAdamWConfig,
    Trainer,
    TrainerConfig,
    build_optimizer,
)
from d9d_tpu_torch.loop.components.checkpointer import StateCheckpointer
from d9d_tpu_torch.models.qwen3 import Qwen3DenseCausalLM, Qwen3DenseConfig
from d9d_tpu_torch.resilience import (
    MANIFEST_NAME,
    CheckpointIntegrityError,
    manifest_mesh,
    validate_checkpoint_dir,
)
from d9d_tpu_torch.tracker import MemoryTracker

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
VOCAB = 32
CFG = Qwen3DenseConfig(vocab_ranges=(("default", VOCAB),), hidden_size=32,
                       num_layers=2, num_heads=2, num_kv_heads=2,
                       head_dim=16, intermediate_size=64, remat=False)


class _Provider(ModelProvider):
    def __init__(self, param_dtype=torch.float32):
        self.param_dtype = param_dtype

    def build_module(self, ctx):
        return Qwen3DenseCausalLM(CFG, dtype=torch.float32,
                                  param_dtype=self.param_dtype,
                                  device=ctx.device, seed=0)


class _Items:
    def __len__(self):
        return 64

    def __getitem__(self, i):
        return {"input_ids": np.random.default_rng(i).integers(0, VOCAB, (17,))}


class _Loader(DatasetProvider):
    def build(self):
        return StatefulDataLoader(_Items(), 8, shuffle=True, seed=7,
                                  num_epochs=None)


class _StochasticProvider(OptimizerProvider):
    def build(self, params, learning_rate):
        return build_optimizer(StochasticAdamWConfig(weight_decay=0.1, seed=3),
                               params, learning_rate)


def _trainer(ckpt_dir, total_steps, *, tracker=None, every=2, bf16=False,
             **config):
    kw = dict(global_batch_size=8, microbatch_size=4, seq_len=16,
              total_steps=total_steps, log_every=1, gc_every_steps=None,
              checkpoint_dir=None if ckpt_dir is None else str(ckpt_dir),
              checkpoint_every_steps=every)
    kw.update(config)
    return Trainer(
        ctx=MeshParameters().build(["cpu"]), config=TrainerConfig(**kw),
        model_provider=_Provider(torch.bfloat16 if bf16 else torch.float32),
        dataset_provider=_Loader(), task=CausalLMTask(),
        optimizer_provider=(_StochasticProvider() if bf16
                            else AdamWProvider(weight_decay=0.1)),
        learning_rate=1e-2, tracker=tracker)


def _assert_state_equal(a: Trainer, b: Trainer):
    for (n, p), (m, q) in zip(a.module.named_parameters(),
                              b.module.named_parameters()):
        assert n == m
        assert torch.equal(p, q), n
    for x, y in zip(a.optimizer.mu + a.optimizer.nu,
                    b.optimizer.mu + b.optimizer.nu):
        assert torch.equal(x, y)
    assert a.optimizer.count == b.optimizer.count


@pytest.mark.parametrize("bf16", [False, True], ids=["adamw", "stochastic_bf16"])
def test_resume_matches_uninterrupted(tmp_path, bf16):
    full = _trainer(tmp_path / "full", 6, bf16=bf16)
    hist_full = full.train()
    first = _trainer(tmp_path / "split", 3, bf16=bf16)
    assert [h["step"] for h in first.train()] == [1, 2, 3]
    resumed = _trainer(tmp_path / "split", 6, bf16=bf16)
    hist = resumed.train()
    assert [h["step"] for h in hist] == [4, 5, 6]  # continued, not restarted
    assert [h["loss"] for h in hist] == [h["loss"] for h in hist_full[3:]]
    _assert_state_equal(resumed, full)
    assert full.optimizer.count == 6
    if bf16:
        assert resumed.optimizer.seed == full.optimizer.seed == 3
    for t in (full, first, resumed):
        t.close()


def _restored(trainer, directory, step):
    ck = StateCheckpointer(directory)
    arrays = trainer._job_arrays()
    arrays = {"model": {k: v.clone() for k, v in arrays["model"].items()},
              "optimizer": {k: ({n: t.clone() for n, t in v.items()}
                                if isinstance(v, dict) else v.clone())
                            for k, v in arrays["optimizer"].items()}}
    got_step, got, meta = ck.restore(arrays, step=step)
    assert got_step == step == meta["step"]
    return got


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def test_async_save_bitwise_matches_sync(tmp_path):
    """Saves at steps 2 and 4 of two identical runs, one per mode: every
    array of every step equal bit for bit; the async step 2 was written
    while steps 3 and 4 updated the live tensors in place."""
    runs = {}
    for mode in ("sync", "async"):
        t = _trainer(tmp_path / mode, 4, checkpoint_async=mode == "async")
        t.train()
        runs[mode] = t
    for step in (2, 4):
        a = _flat(_restored(runs["sync"], tmp_path / "sync", step))
        b = _flat(_restored(runs["async"], tmp_path / "async", step))
        assert a.keys() == b.keys() and len(a) > 20
        for k in a:
            assert torch.equal(a[k], b[k]), (step, k)
    live = _flat(runs["async"]._job_arrays())
    step2 = _flat(_restored(runs["async"], tmp_path / "async", 2))
    assert not all(torch.equal(live[k], step2[k]) for k in live)
    step4 = _flat(_restored(runs["async"], tmp_path / "async", 4))
    assert all(torch.equal(live[k], step4[k]) for k in live)


def test_rotation_keeps_the_newest_steps(tmp_path):
    t = _trainer(tmp_path, 8, every=1, checkpoints_to_keep=3)
    t.train()
    t.close()
    ck = StateCheckpointer(tmp_path)
    assert ck.all_steps() == [6, 7, 8]
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "save_6", "save_7", "save_8"]
    meta = json.loads((tmp_path / "save_8" / "meta.json").read_text())
    assert meta["step"] == 8
    assert meta["data_loader"]["process_0"]["batch_index"] == 8
    assert manifest_mesh(tmp_path / "save_8")["device_count"] == 1


def test_tracker_run_hash_is_restored(tmp_path):
    tracker = MemoryTracker()
    _trainer(tmp_path, 2, tracker=tracker).train()
    _trainer(tmp_path, 4, tracker=tracker).train()
    first, second = tracker.runs
    assert first.run_hash == second.run_hash
    assert [s["step"] for s in second.scalars if s["name"] == "train/loss"] \
        == [3, 4]


def test_prefetch_on_and_off_give_the_same_run(tmp_path):
    on = _trainer(None, 4, prefetch_batches=2)
    off = _trainer(None, 4, prefetch_batches=0)
    assert [h["loss"] for h in on.train()] == [h["loss"] for h in off.train()]
    _assert_state_equal(on, off)


def test_prefetch_is_off_for_a_loader_without_position(tmp_path):
    class NoPosition:
        def __init__(self):
            self.inner = _Loader().build()

        def __iter__(self):
            return iter(self.inner)

        def state_dict(self):
            return self.inner.state_dict()

        def load_state_dict(self, state):
            self.inner.load_state_dict(state)

    class Data(DatasetProvider):
        def build(self):
            return NoPosition()

    t = _trainer(None, 1)
    t.dataset_provider = Data()
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        t.train()
    assert any("disabling batch prefetch" in str(x.message) for x in w)


# -- the walk-back: tests/resilience/test_checkpoint_fallback.py -----------


def _arrays(step):
    return {"w": torch.arange(4096, dtype=torch.float32) * step,
            "b": torch.ones(8) * step}


def _checkpointer(path, **kw):
    kw.setdefault("save_every_steps", 1)
    kw.setdefault("num_to_keep", 3)
    return StateCheckpointer(path, **kw)


def _truncate_data(path, step):
    """Halve the largest DCP data file of ``save_{step}``: a file the
    restore reads."""
    files = sorted((path / f"save_{step}").glob("*.distcp"),
                   key=lambda p: p.stat().st_size)
    victim = files[-1]
    size = victim.stat().st_size
    with open(victim, "r+b") as fh:
        fh.truncate(size // 2)
    return victim


def test_manifest_written_and_validated(tmp_path):
    ck = _checkpointer(tmp_path, async_save=True)
    for s in (1, 2):
        ck.save(s, _arrays(s), {"step": s})
    ck.wait_until_finished()
    for s in (1, 2):
        step_dir = tmp_path / f"save_{s}"
        manifest = json.loads((step_dir / MANIFEST_NAME).read_text())
        names = {f["path"] for f in manifest["files"]}
        assert {"meta.json", ".metadata", "__0_0.distcp"} <= names
        assert all("sha256" in f for f in manifest["files"])
        assert validate_checkpoint_dir(step_dir) is True
    ck.close()


def test_truncated_latest_falls_back_bitwise(tmp_path):
    ck = _checkpointer(tmp_path, async_save=True)
    for s in (1, 2, 3):
        ck.save(s, _arrays(s), {"step": s})
    ck.wait_until_finished()
    _truncate_data(tmp_path, 3)
    with pytest.raises(CheckpointIntegrityError, match="size mismatch"):
        validate_checkpoint_dir(tmp_path / "save_3")
    got_step, got, meta = ck.restore(_arrays(0))
    assert got_step == 2 and meta == {"step": 2}
    for k, v in _arrays(2).items():
        assert torch.equal(got[k], v)
    assert ck.checkpoint_fallback == 1
    assert ck.all_steps() == [1, 2]  # the corrupt step is pruned
    # an explicit step keeps strict semantics (here: pruned, so missing)
    with pytest.raises(CheckpointIntegrityError):
        ck.restore(_arrays(0), step=3)
    ck.close()


def test_fallback_prunes_corrupt_steps_and_allows_resave(tmp_path):
    ck = _checkpointer(tmp_path, async_save=False)
    for s in (1, 2):
        ck.save(s, _arrays(s), {"step": s})
    _truncate_data(tmp_path, 2)
    assert ck.restore(_arrays(0))[0] == 1
    assert ck.all_steps() == [1]
    ck.save(2, _arrays(2), {"step": 2})
    again = ck.restore(_arrays(0))
    assert again[0] == 2 and torch.equal(again[1]["w"], _arrays(2)["w"])
    ck.close()


def test_all_checkpoints_corrupt_raises_not_fresh_start(tmp_path):
    ck = _checkpointer(tmp_path, async_save=False, num_to_keep=2)
    for s in (1, 2):
        ck.save(s, _arrays(s), {"step": s})
    for s in (1, 2):
        _truncate_data(tmp_path, s)
    with pytest.raises(RuntimeError, match="refusing to silently"):
        ck.restore(_arrays(0))
    assert ck.all_steps() == [1, 2]  # nothing pruned
    assert ck.checkpoint_fallback == 2
    ck.close()


def test_empty_directory_restores_none(tmp_path):
    ck = _checkpointer(tmp_path, async_save=False)
    assert ck.restore(_arrays(0)) is None
    ck.close()


def test_step_without_manifest_restores_unverified(tmp_path):
    ck = _checkpointer(tmp_path, async_save=False)
    ck.save(1, _arrays(1), {"step": 1})
    (tmp_path / "save_1" / MANIFEST_NAME).unlink()
    got_step, got, _ = ck.restore(_arrays(0))
    assert got_step == 1 and torch.equal(got["w"], _arrays(1)["w"])
    assert ck.unverified_restore == 1
    ck.close()


def test_unverified_broken_step_is_skipped_not_pruned(tmp_path):
    """No manifest to confirm the damage: the load's own failure walks
    back, and the step stays on disk (only a manifest-confirmed corruption
    is pruned)."""
    ck = _checkpointer(tmp_path, async_save=False)
    for s in (1, 2):
        ck.save(s, _arrays(s), {"step": s})
    (tmp_path / "save_2" / MANIFEST_NAME).unlink()
    _truncate_data(tmp_path, 2)
    got_step, got, _ = ck.restore(_arrays(0))
    assert got_step == 1 and torch.equal(got["b"], _arrays(1)["b"])
    assert (ck.checkpoint_fallback, ck.unverified_restore) == (1, 1)
    assert ck.all_steps() == [1, 2]
    ck.close()


_KILL_SCRIPT = r"""
import os, sys
sys.path.insert(0, {repo!r})
import torch
from d9d_tpu_torch.loop.components.checkpointer import StateCheckpointer

def arrays(step):
    return {{"w": torch.arange(4096, dtype=torch.float32) * step,
             "b": torch.ones(8) * step}}

ck = StateCheckpointer(sys.argv[1], save_every_steps=1, num_to_keep=3,
                       async_save=True)
ck.save(1, arrays(1), {{"step": 1}})
ck.wait_until_finished()
ck.save(2, arrays(2), {{"step": 2}})
# killed mid-save: no wait, no finalize
os._exit(9)
"""


def test_kill_mid_async_save_restores_an_intact_step(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-c", _KILL_SCRIPT.format(repo=str(ROOT)),
         str(tmp_path)], capture_output=True, text=True, timeout=120)
    assert proc.returncode == 9, proc.stderr
    # the unfinalized step is only a tmp directory: it never lists
    assert (tmp_path / "save_2.tmp").is_dir()
    ck = _checkpointer(tmp_path, async_save=True)
    assert not (tmp_path / "save_2.tmp").exists()  # cleared at build
    got_step, got, meta = ck.restore(_arrays(0))
    assert got_step == 1 and meta["step"] == 1
    assert torch.equal(got["w"], _arrays(1)["w"])
    ck.close()


_RACE_SCRIPT = r"""
import shutil, sys, time
sys.path.insert(0, {repo!r})
import torch
import torch.distributed as dist
from d9d_tpu_torch.loop.components import checkpointer as ck

rank = int(sys.argv[2])
dist.init_process_group("gloo", init_method=sys.argv[3], rank=rank,
                        world_size=2)
if rank == 0:  # a pause between clearing the step's directory and making it
    clear = shutil.rmtree

    def slow_clear(path, *args, **kwargs):
        clear(path, *args, **kwargs)
        time.sleep(1.5)

    ck.shutil.rmtree = slow_clear
c = ck.StateCheckpointer(sys.argv[1], async_save=False)
if rank == 1:
    time.sleep(0.5)  # reaches its save inside rank 0's pause
c.save(1, {{"w": torch.arange(4.0)}}, {{"step": 1}})
dist.destroy_process_group()
"""


def test_save_waits_for_rank0_to_make_the_step_directory(tmp_path):
    """DCP's writer makes the step's directory on every rank: a rank that
    got there while rank 0 was between clearing and making it failed rank
    0's ``mkdir`` with ``FileExistsError``."""
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="1")
    rdzv = f"file://{tmp_path / 'rdzv'}"
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RACE_SCRIPT.format(repo=str(ROOT)),
         str(tmp_path / "ck"), str(r), rdzv], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, (
            f"rank {r} exited {p.returncode}:\n{out[-3000:]}")
    ck = _checkpointer(tmp_path / "ck")
    assert ck.all_steps() == [1]
    ck.close()
