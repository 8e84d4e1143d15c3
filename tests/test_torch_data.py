"""The port's data path against the JAX package's, and its own contracts:
``dataset/`` (``pad_stack_1d``, the pooling masks, ``ShardedDataset``,
``BufferSortedDataset``), ``StatefulDataLoader``, ``BatchPrefetcher`` and
the trackers.

The example's own pipeline (``example/qwen3_moe/pretrain.py``
``CorpusProvider`` on ``pretrain.json``'s data section: the synthetic
corpus, buffered length sorting, padding and the loss mask) must give the
JAX example's batches bit for bit over 3 windows of 256 documents, also
after a ``state_dict`` → JSON → ``load_state_dict`` round trip and through
the prefetcher at depth 2, where ``state_dict_at(consumed_position)``
resumes at the batch after the last one consumed. The other cases mirror
``tests/loop/test_prefetch.py`` and ``tests/dataset/test_dataset.py``.
No model runs here.
"""
import importlib.util
import json
import pathlib
import threading
import time

import numpy as np
import pytest

from d9d_tpu.dataset import BufferSortedDataset as JBufferSortedDataset
from d9d_tpu.dataset import pad_stack_1d as j_pad_stack_1d
from d9d_tpu.loop.components.data_loader import (
    StatefulDataLoader as JStatefulDataLoader,
)
from d9d_tpu_torch.dataset import (
    BufferSortedDataset,
    PaddingSide1D,
    ShardIndexingMode,
    ShardedDataset,
    TokenPoolingType,
    pad_stack_1d,
    shard_dataset_data_parallel,
    token_pooling_mask_from_attention_mask,
)
from d9d_tpu_torch.example.qwen3_moe import pretrain as twin
from d9d_tpu_torch.loop import StatefulDataLoader, TrainerConfig
from d9d_tpu_torch.loop.components.data_loader import (
    DataFetchError,
    default_collate,
)
from d9d_tpu_torch.loop.components.prefetch import BatchPrefetcher
from d9d_tpu_torch.tracker import (
    JsonlTracker,
    MemoryTracker,
    MirrorTrackerRun,
    NullTracker,
    build_tracker,
)

ROOT = pathlib.Path(__file__).resolve().parent.parent
SPEC = json.loads((ROOT / "example/qwen3_moe/pretrain.json").read_text())
WINDOWS = 3  # of presort_buffer_size = 256 documents


def _jax_example():
    spec = importlib.util.spec_from_file_location(
        "jax_example_qwen3_moe_pretrain",
        ROOT / "example/qwen3_moe/pretrain.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_batches():
    """The JAX example's CorpusProvider on pretrain.json's sections: the
    batches of 3 windows of 256 documents (8 batches of 32 each)."""
    jex = _jax_example()
    cfg = jex.ProjectConfig.model_validate(SPEC)
    loader = jex.CorpusProvider(cfg.data, cfg.model.vocab_size,
                                cfg.trainer).build()
    n = WINDOWS * cfg.data.presort_buffer_size // cfg.trainer.global_batch_size
    it = iter(loader)
    return [next(it) for _ in range(n)]


def _twin_loader():
    cfg = twin.parse_config(SPEC)
    return twin.CorpusProvider(cfg.data, cfg.model.vocab_size,
                               cfg.trainer).build()


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert set(g) == set(w) == {"input_ids", "loss_mask"}
        for k in w:
            assert g[k].dtype == w[k].dtype, (i, k)
            np.testing.assert_array_equal(g[k], w[k], err_msg=f"{i} {k}")


def test_example_batches_equal_jax(jax_batches):
    it = iter(_twin_loader())
    _assert_batches_equal([next(it) for _ in jax_batches], jax_batches)


@pytest.mark.parametrize("cut", [3, 8, 13])
def test_example_batches_resume_through_json(jax_batches, cut):
    """Stop after ``cut`` batches (inside window 0, on its edge, inside
    window 1), carry the state through JSON, resume in a fresh loader."""
    loader = _twin_loader()
    it = iter(loader)
    head = [next(it) for _ in range(cut)]
    state = json.loads(json.dumps(loader.state_dict()))
    assert set(state) == {"process_0"}
    resumed = _twin_loader()
    resumed.load_state_dict(state)
    it2 = iter(resumed)
    tail = [next(it2) for _ in range(len(jax_batches) - cut)]
    _assert_batches_equal(head + tail, jax_batches)


def test_example_batches_resume_through_prefetch(jax_batches):
    """Depth-2 prefetch of the twin's batches: they are the JAX batches,
    the producer runs ahead, and the consumed position resumes at the
    batch after the last one consumed, not at the producer's."""
    loader = _twin_loader()
    pf = BatchPrefetcher(iter(loader), lambda b: b, depth=2,
                         position_fn=loader.position)
    head = [next(pf) for _ in range(5)]
    deadline = time.time() + 10.0
    while loader._batch_index < 7 and time.time() < deadline:
        time.sleep(0.01)
    # 5 consumed, 2 queued, and one fetched that waits for room
    assert loader._batch_index in (7, 8)
    assert pf.consumed_position["batch_index"] == 5
    state = json.loads(json.dumps(loader.state_dict_at(pf.consumed_position)))
    pf.close()
    resumed = _twin_loader()
    resumed.load_state_dict(state)
    it = iter(resumed)
    tail = [next(it) for _ in range(len(jax_batches) - 5)]
    _assert_batches_equal(head + tail, jax_batches)


def test_buffer_sorted_state_is_jax_state():
    """Same RNG stream and the same base64-pickled state: a JAX state
    loads into the port and continues identically, and the reverse."""
    lengths = list(np.random.default_rng(3).integers(1, 500, 100))

    class Items:
        def __len__(self):
            return len(lengths)

        def __getitem__(self, i):
            return lengths[i]

        def sort_key(self, i):
            return lengths[i]

    j = JBufferSortedDataset(Items(), buffer_size=32, pack_size=8, init_seed=5)
    t = BufferSortedDataset(Items(), buffer_size=32, pack_size=8, init_seed=5)
    assert [j[i] for i in range(40)] == [t[i] for i in range(40)]
    assert j.state_dict() == t.state_dict()
    t2 = BufferSortedDataset(Items(), buffer_size=32, pack_size=8)
    t2.load_state_dict(j.state_dict())
    assert [j[i] for i in range(40, 100)] == [t2[i] for i in range(40, 100)]


def test_loader_and_padding_equal_jax_on_shuffled_epochs():
    """Shuffled epochs from ``seed + epoch``, ``drop_last``, several
    epochs, and ``pad_stack_1d`` as collate: the JAX loader's batches."""

    class Ragged:
        def __len__(self):
            return 23

        def __getitem__(self, i):
            return np.arange(i % 7 + 1, dtype=np.int64)

    def collate(pad, side):
        return lambda items: pad(items, pad_value=-1, padding_side=side,
                                 pad_to_multiple_of=4)

    for side in ("right", "left"):
        kw = dict(shuffle=True, seed=11, num_epochs=3)
        j = list(JStatefulDataLoader(Ragged(), 5, collate_fn=collate(
            j_pad_stack_1d, side), **kw))
        t = list(StatefulDataLoader(Ragged(), 5, collate_fn=collate(
            pad_stack_1d, side), **kw))
        assert len(t) == len(j) == 12
        for a, b in zip(t, j):
            np.testing.assert_array_equal(a, b)


# -- the cases of tests/dataset/test_dataset.py ------------------------------


class ListDataset:
    def __init__(self, items):
        self.items = list(items)

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]

    def sort_key(self, i):
        return self.items[i]


def test_sharded_sequential_and_chunked():
    ds = ListDataset(range(14))
    seq = [ShardedDataset(ds, 4, i, ShardIndexingMode.sequential, False)
           for i in range(4)]
    assert [[s[i] for i in range(len(s))] for s in seq] == [
        [0, 4, 8, 12], [1, 5, 9, 13], [2, 6, 10], [3, 7, 11]]
    chk = [ShardedDataset(ds, 4, i, ShardIndexingMode.chunked, False)
           for i in range(4)]
    assert [[s[i] for i in range(len(s))] for s in chk] == [
        [0, 1, 2, 3], [4, 5, 6, 7], [8, 9, 10, 11], [12, 13]]
    padded = [ShardedDataset(ds, 4, i) for i in range(4)]
    assert {len(s) for s in padded} == {4}
    assert padded[3][3] == 13  # clamped to the last element


def test_sharded_validation_and_state():
    ds = ListDataset(range(10))
    with pytest.raises(ValueError):
        ShardedDataset(ds, 2, 2)
    s = ShardedDataset(ds, 2, 1)
    s2 = ShardedDataset(ds, 2, 0)
    s2.load_state_dict(s.state_dict())
    assert [s2[i] for i in range(len(s2))] == [s[i] for i in range(len(s))]
    with pytest.raises(ValueError):
        ShardedDataset(ds, 3, 0).load_state_dict(s.state_dict())


def test_shard_dataset_data_parallel_reads_no_environment():
    """The shard count and index come from the caller or the context."""
    ds = ListDataset(range(10))

    class Ctx:
        process_count, process_index = 2, 1

    by_ctx = shard_dataset_data_parallel(ds, ctx=Ctx())
    by_args = shard_dataset_data_parallel(ds, total_shards=2, current_shard=1)
    assert [by_ctx[i] for i in range(5)] == [by_args[i] for i in range(5)] \
        == [1, 3, 5, 7, 9]
    with pytest.raises(ValueError):
        shard_dataset_data_parallel(ds)
    with pytest.raises(ValueError):
        shard_dataset_data_parallel(ds, ctx=Ctx(), total_shards=2,
                                    current_shard=0)


def test_buffer_sorted_groups_similar_lengths():
    lengths = np.random.default_rng(0).integers(1, 100, size=64).tolist()
    bs = BufferSortedDataset(ListDataset(lengths), buffer_size=32,
                             pack_size=4, init_seed=42)
    served = [bs[i] for i in range(len(bs))]
    assert sorted(served) == sorted(lengths)
    packs = [served[i:i + 4] for i in range(0, 64, 4)]
    assert np.mean([max(p) - min(p) for p in packs]) < (
        max(lengths) - min(lengths)) / 3


def test_pad_stack_and_pooling_masks():
    items = [np.array([1, 2, 3]), np.array([4])]
    np.testing.assert_array_equal(pad_stack_1d(items, 0),
                                  [[1, 2, 3], [4, 0, 0]])
    np.testing.assert_array_equal(
        pad_stack_1d(items, 9, padding_side=PaddingSide1D.left),
        [[1, 2, 3], [9, 9, 4]])
    assert pad_stack_1d(items, 0, pad_to_multiple_of=4).shape == (2, 4)
    with pytest.raises(ValueError):
        pad_stack_1d([], 0)
    with pytest.raises(ValueError):
        pad_stack_1d(items, 0, pad_to_multiple_of=0)
    am = np.array([[1, 1, 1, 0], [1, 1, 0, 0]])
    np.testing.assert_array_equal(
        token_pooling_mask_from_attention_mask(am, TokenPoolingType.first),
        [[1, 0, 0, 0], [1, 0, 0, 0]])
    np.testing.assert_array_equal(
        token_pooling_mask_from_attention_mask(am, TokenPoolingType.last),
        [[0, 0, 1, 0], [0, 1, 0, 0]])
    np.testing.assert_array_equal(
        token_pooling_mask_from_attention_mask(am, TokenPoolingType.all), am)


# -- the loader's own contract ---------------------------------------------


class _Dataset:
    def __init__(self, n=32):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"x": np.full((4,), i, np.int32)}


def _loader(**kw):
    return StatefulDataLoader(_Dataset(), batch_size=4, shuffle=False, **kw)


def test_default_collate_stacks_trees():
    out = default_collate([{"a": np.ones(2), "b": (np.zeros(1), 3)},
                           {"a": np.zeros(2), "b": (np.ones(1), 4)}])
    np.testing.assert_array_equal(out["a"], [[1, 1], [0, 0]])
    np.testing.assert_array_equal(out["b"][1], [3, 4])


def test_loader_retries_then_raises_with_the_position():
    class Flaky:
        def __init__(self, fails):
            self.fails = fails

        def __len__(self):
            return 8

        def __getitem__(self, i):
            if self.fails > 0:
                self.fails -= 1
                raise OSError("transient")
            return {"x": np.array([i])}

    ok = StatefulDataLoader(Flaky(2), 4, shuffle=False, retry_attempts=2,
                            retry_backoff_s=0.0)
    assert next(iter(ok))["x"].shape == (4, 1) and ok.retries == 2
    bad = StatefulDataLoader(Flaky(5), 4, shuffle=False, retry_attempts=1,
                             retry_backoff_s=0.0)
    with pytest.raises(DataFetchError, match="epoch 0 batch 0") as e:
        next(iter(bad))
    assert (e.value.epoch, e.value.batch_index) == (0, 0)


def test_loader_state_needs_this_process_entry():
    with pytest.raises(KeyError, match="process_0"):
        _loader().load_state_dict({"process_1": {"epoch": 0,
                                                 "batch_index": 0}})


# -- the cases of tests/loop/test_prefetch.py -------------------------------


def test_prefetch_yields_same_batches_and_positions():
    plain = list(iter(_loader()))
    loader = _loader()
    pf = BatchPrefetcher(iter(loader), lambda b: b, depth=2,
                         position_fn=loader.position)
    got, positions = [], []
    for batch in pf:
        got.append(batch)
        positions.append(pf.consumed_position)
    assert len(got) == len(plain)
    for a, b in zip(got, plain):
        np.testing.assert_array_equal(a["x"], b["x"])
    assert [p["batch_index"] for p in positions[:3]] == [1, 2, 3]
    pf.close()


def test_prefetch_propagates_errors_and_counts_them():
    def broken():
        yield {"x": np.zeros(1)}
        raise RuntimeError("boom in dataset")

    pf = BatchPrefetcher(broken(), lambda b: b, depth=2)
    next(pf)
    with pytest.raises(RuntimeError, match="boom in dataset"):
        next(pf)
    assert pf.errors == 1
    pf.close()


def test_prefetch_dead_producer_raises():
    pf = BatchPrefetcher(iter(_loader()), lambda b: b, depth=1)
    pf.close()
    while not pf._q.empty():
        pf._q.get_nowait()
    with pytest.raises(RuntimeError, match="died without delivering"):
        next(pf)


def test_state_dict_at_serializes_consumed_position():
    loader = _loader()
    pf = BatchPrefetcher(iter(loader), lambda b: b, depth=3,
                         position_fn=loader.position)
    next(pf)
    next(pf)
    state = loader.state_dict_at(pf.consumed_position)
    pf.close()
    resumed = _loader()
    resumed.load_state_dict(state)
    np.testing.assert_array_equal(next(iter(resumed))["x"][:, 0],
                                  [8, 9, 10, 11])


def test_close_unblocks_full_queue():
    pf = BatchPrefetcher(iter(_loader()), lambda b: b, depth=1)
    next(pf)
    pf.close()
    assert not pf._thread.is_alive()


def test_stage_runs_in_producer_and_finish_on_consumer():
    consumer = threading.get_ident()
    staged, finished = [], []
    pf = BatchPrefetcher(
        iter(_loader()),
        lambda b: (staged.append(threading.get_ident()), b)[1], depth=2,
        finish_fn=lambda b: (finished.append(threading.get_ident()), b)[1])
    next(pf)
    next(pf)
    pf.close()
    assert staged and all(t != consumer for t in staged)
    assert finished == [consumer, consumer]


def test_finish_failure_does_not_mark_the_batch_consumed():
    loader = _loader()
    calls = []

    def finish(b):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("copy failed")
        return b

    pf = BatchPrefetcher(iter(loader), lambda b: b, depth=2,
                         position_fn=loader.position, finish_fn=finish)
    next(pf)
    with pytest.raises(RuntimeError, match="copy failed"):
        next(pf)
    assert pf.consumed_position["batch_index"] == 1
    pf.close()


# -- trackers -----------------------------------------------------------------


def test_jsonl_tracker_writes_and_restored_hash_repoints(tmp_path):
    run = JsonlTracker(tmp_path).new_run("exp")
    run.track_hparams({"lr": 1.0})
    run.track_scalar("train/loss", 2.5, step=1, context={"subset": "train"})
    run.track_histogram("h", [1, 2], [0.0, 1.0, 2.0], step=1)
    state = run.state_dict()
    run.close()
    assert state["run_hash"].startswith("exp-")
    rows = [json.loads(x) for x in
            (tmp_path / f"{state['run_hash']}.jsonl").read_text().splitlines()]
    assert [r["kind"] for r in rows] == ["hparams", "scalar", "histogram"]
    assert rows[1]["value"] == 2.5 and rows[1]["step"] == 1
    # a resumed job opens a new run, restores the hash, keeps appending
    again = JsonlTracker(tmp_path).new_run("exp")
    again.track_scalar("early", 0.0, step=0)
    again.load_state_dict(state)
    again.track_scalar("train/loss", 2.0, step=2)
    again.close()
    rows = (tmp_path / f"{state['run_hash']}.jsonl").read_text().splitlines()
    assert len(rows) == 4 and json.loads(rows[-1])["value"] == 2.0


def test_memory_and_mirror_runs_carry_state():
    run = MemoryTracker().new_run("r")
    run.track_scalar("a", 1, step=3)
    assert run.scalars == [{"name": "a", "value": 1.0, "step": 3,
                            "context": {}}]
    mirror = MirrorTrackerRun(run.state_dict())
    mirror.track_scalar("a", 1, step=3)  # writes nothing
    assert mirror.state_dict() == run.state_dict()
    mirror.load_state_dict({"run_hash": "h2"})
    run.load_state_dict(mirror.state_dict())
    assert run.run_hash == "h2"


def test_build_tracker_kinds(tmp_path, caplog):
    assert isinstance(build_tracker(), NullTracker)
    assert isinstance(build_tracker("memory"), MemoryTracker)
    assert isinstance(build_tracker("jsonl", directory=tmp_path), JsonlTracker)
    assert isinstance(build_tracker("nope"), NullTracker)
    assert "unknown tracker" in caplog.text
    try:
        import aim  # noqa: F401
    except ImportError:
        assert isinstance(build_tracker("aim"), NullTracker)
        assert "aim not installed" in caplog.text
    else:
        with pytest.raises(NotImplementedError, match="Aim tracker"):
            build_tracker("aim")


def test_trainer_config_takes_checkpointing_and_prefetch():
    cfg = TrainerConfig(global_batch_size=4, microbatch_size=2, seq_len=8,
                        total_steps=1, checkpoint_dir="c", prefetch_batches=3)
    assert (cfg.checkpoint_dir, cfg.prefetch_batches) == ("c", 3)
    assert TrainerConfig(global_batch_size=4, microbatch_size=2, seq_len=8,
                         total_steps=1).prefetch_batches == 2
