"""Qwen3-MoE pretraining through the port: the torch twin of
``example/qwen3_moe/pretrain.py``, on the same JSON config.

One JSON file wires mesh, model, data, trainer, optimizer, LR schedule,
tracker and export, in the JAX script's schema (``ProjectConfig`` and its
sections, here dataclasses with the same field names and defaults; the
``optimizer`` and ``lr_scheduler`` sections parse into ``loop/auto.py``'s
and ``lr_scheduler/config.py``'s dataclasses by their ``type`` tag). Run it
from the repository root::

    python -m d9d_tpu_torch.example.qwen3_moe.pretrain \\
        example/qwen3_moe/pretrain.json --backend gloo

on the card (one process a rank, every rank on the one card over gloo; with
``--backend nccl``, one card a rank), or with ``--device cpu --backend
gloo`` on the CPU. The script starts the mesh's ``world_size`` ranks itself
(``torch.multiprocessing`` with a ``file://`` rendezvous in a temp
directory), as the JAX script covers its devices from one command; it
reads nothing from the environment. ``--backend`` is required when the
mesh has more than one rank; ``--device`` defaults to ``cuda`` and raises
without a card. Paths in the JSON (``trainer.checkpoint_dir``,
``tracker.directory``, ``export_to``) are relative to the working
directory. A second launch with the same ``checkpoint_dir`` resumes from
its newest intact ``save_{step}``.

:func:`build_trainer` builds the ``Trainer`` from a parsed config and a
``MeshContext``; :func:`launch` (which :func:`main` calls) starts the
ranks, and each trains, prints, exports and closes (:func:`run_rank`).
"""

import argparse
import dataclasses
import json
import sys
import tempfile
from pathlib import Path
from typing import Any

import numpy as np
import torch

from d9d_tpu_torch.core import (
    MeshParameters,
    init_distributed,
    shutdown_distributed,
)
from d9d_tpu_torch.core.device import resolve_device
from d9d_tpu_torch.dataset import BufferSortedDataset, pad_stack_1d
from d9d_tpu_torch.loop import (
    CausalLMTask,
    DatasetProvider,
    ModelProvider,
    OptimizerProvider,
    StatefulDataLoader,
    Trainer,
    TrainerConfig,
)
from d9d_tpu_torch.loop.auto import (
    AdamWConfig,
    ConstantLRConfig,
    PiecewiseLRConfig,
    StochasticAdamWConfig,
    build_lr_schedule,
    build_optimizer,
)
from d9d_tpu_torch.lr_scheduler.config import (
    CurveCosineConfig,
    CurveExponentialConfig,
    CurveLinearConfig,
    CurvePolyConfig,
    PercentagePhaseConfig,
    PiecewiseSchedulerConfig,
    RestPhaseConfig,
    StepPhaseConfig,
)
from d9d_tpu_torch.models.qwen3 import Qwen3MoeCausalLM, Qwen3MoeConfig
from d9d_tpu_torch.nn.moe import SharedExpertParameters
from d9d_tpu_torch.nn.sdpa import build_sdpa_backend
from d9d_tpu_torch.parallel import fsdp_ep_plan
from d9d_tpu_torch.tracker import build_tracker

# -----------------------------------
# Configuration schema (dataclasses)
# -----------------------------------


@dataclasses.dataclass
class MeshConfig:
    pp: int = 1
    dp_replicate: int = 1
    dp_shard: int = 1
    cp_shard: int = 1
    cp_replicate: int = 1
    tp: int = 1
    ep_shard: int = 1


@dataclasses.dataclass
class ModelConfig:
    vocab_size: int
    hidden_size: int
    num_layers: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    moe_intermediate_size: int
    num_experts: int
    num_experts_per_tok: int
    remat: bool = True
    dtype: str = "bfloat16"
    linear_attention_layers: list[int] = dataclasses.field(default_factory=list)
    fused_qkv: bool = False
    use_output_gate: bool = False
    rope_fraction: float = 1.0
    zero_centered_norms: bool = False
    gdn_qk_heads: int = 0
    gdn_v_heads: int = 0
    gdn_head_qk_dim: int = 0
    gdn_head_v_dim: int = 0
    gdn_conv_size: int = 4
    shared_expert_intermediate_size: int = 0
    shared_expert_gate: bool = True


@dataclasses.dataclass
class DataConfig:
    num_documents: int
    max_len: int
    seed: int = 0
    presort_buffer_size: int = 256
    presort_pack_size: int = 32


@dataclasses.dataclass
class TrackerConfig:
    kind: str = "jsonl"
    directory: str = "runs"


@dataclasses.dataclass
class ProjectConfig:
    mesh: MeshConfig
    model: ModelConfig
    data: DataConfig
    trainer: TrainerConfig
    optimizer: "AdamWConfig | StochasticAdamWConfig"
    lr_scheduler: "ConstantLRConfig | PiecewiseLRConfig"
    tracker: TrackerConfig = dataclasses.field(default_factory=TrackerConfig)
    export_to: str | None = None


def _tagged(kinds: dict[str, type], raw: dict, tag: str, what: str):
    kind = raw.get(tag)
    if kind not in kinds:
        raise ValueError(f"{what}: unknown {tag} {kind!r} (known: "
                         f"{sorted(kinds)})")
    return kinds[kind], raw


_CURVES = {"linear": CurveLinearConfig, "cosine": CurveCosineConfig,
           "exponential": CurveExponentialConfig, "poly": CurvePolyConfig}
_PHASES = {"steps": StepPhaseConfig, "percentage": PercentagePhaseConfig,
           "rest": RestPhaseConfig}


def _parse_lr(raw: dict):
    cls, raw = _tagged({"constant": ConstantLRConfig,
                        "piecewise": PiecewiseLRConfig}, raw, "type",
                       "lr_scheduler")
    if cls is ConstantLRConfig:
        return ConstantLRConfig(**raw)
    sched = dict(raw["schedule"])
    phases = []
    for p in sched.pop("phases"):
        pcls, p = _tagged(_PHASES, dict(p), "mode", "lr phase")
        ccls, c = _tagged(_CURVES, dict(p.pop("curve")), "type", "lr curve")
        phases.append(pcls(**p, curve=ccls(**c)))
    return PiecewiseLRConfig(**{k: v for k, v in raw.items()
                                if k != "schedule"},
                             schedule=PiecewiseSchedulerConfig(
                                 **sched, phases=tuple(phases)))


def parse_config(raw: dict[str, Any]) -> ProjectConfig:
    """A :class:`ProjectConfig` from the JSON's dict; an unknown field
    raises, as the JAX schema's do."""
    opt_cls, opt = _tagged({"adamw": AdamWConfig,
                            "stochastic_adamw": StochasticAdamWConfig},
                           raw["optimizer"], "type", "optimizer")
    known = {f.name for f in dataclasses.fields(ProjectConfig)}
    extra = set(raw) - known
    if extra:
        raise ValueError(f"ProjectConfig: unknown fields {sorted(extra)}")
    return ProjectConfig(
        mesh=MeshConfig(**raw.get("mesh", {})),
        model=ModelConfig(**raw["model"]),
        data=DataConfig(**raw["data"]),
        trainer=TrainerConfig(**raw["trainer"]),
        optimizer=opt_cls(**opt),
        lr_scheduler=_parse_lr(raw["lr_scheduler"]),
        tracker=TrackerConfig(**raw.get("tracker", {})),
        export_to=raw.get("export_to"),
    )


# ----------------------
# Dataset implementation
# ----------------------


class SyntheticCorpus:
    """Variable-length 'documents' of a learnable arithmetic language
    (token_{i+1} = token_i + step mod V), the JAX script's corpus."""

    def __init__(self, cfg: DataConfig, vocab_size: int):
        self.cfg = cfg
        self.vocab = vocab_size

    def __len__(self) -> int:
        return self.cfg.num_documents

    def sort_key(self, index: int) -> int:
        return self._length(index)

    def _length(self, index: int) -> int:
        rng = np.random.default_rng(self.cfg.seed * 7919 + index)
        return int(rng.integers(self.cfg.max_len // 2, self.cfg.max_len + 1))

    def __getitem__(self, index: int) -> dict:
        rng = np.random.default_rng(self.cfg.seed * 7919 + index)
        length = int(rng.integers(self.cfg.max_len // 2, self.cfg.max_len + 1))
        start = int(rng.integers(0, self.vocab))
        step = int(rng.integers(1, 5))
        ids = (start + step * np.arange(length)) % self.vocab
        return {"input_ids": ids.astype(np.int64)}


class CorpusProvider(DatasetProvider):
    def __init__(self, cfg: DataConfig, vocab_size: int,
                 trainer: TrainerConfig):
        self.cfg = cfg
        self.vocab_size = vocab_size
        self.trainer = trainer

    def build(self):
        corpus = SyntheticCorpus(self.cfg, self.vocab_size)
        sorted_ds = BufferSortedDataset(
            corpus,
            buffer_size=self.cfg.presort_buffer_size,
            pack_size=self.cfg.presort_pack_size,
            init_seed=self.cfg.seed,
        )

        def collate(items):
            ids = pad_stack_1d([it["input_ids"] for it in items],
                               pad_value=0, pad_to_multiple_of=None)
            # clamp/pad to the static [B, seq_len+1] the task expects
            want = self.trainer.seq_len + 1
            if ids.shape[1] < want:
                ids = np.pad(ids, ((0, 0), (0, want - ids.shape[1])))
            ids = ids[:, :want]
            mask = (ids != 0).astype(np.int64)
            return {"input_ids": ids, "loss_mask": mask}

        return StatefulDataLoader(
            sorted_ds,
            self.trainer.global_batch_size,
            collate_fn=collate,
            shuffle=False,  # BufferSortedDataset already shuffles in packs
            num_epochs=None,
        )


# ----------------------
# Providers
# ----------------------

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def build_model_config(c: ModelConfig, *, ep_axes=None, moe_token_axes=None,
                       remat: bool | None = None) -> Qwen3MoeConfig:
    """ModelConfig (JSON schema) -> Qwen3MoeConfig, the JAX script's
    mapping. The GDN hybrid (``linear_attention_layers``) is not ported:
    it raises, naming its ROADMAP item."""
    if c.linear_attention_layers:
        raise NotImplementedError(
            "ModelConfig.linear_attention_layers: the GDN hybrid is not "
            "ported yet (ROADMAP A11)")
    return Qwen3MoeConfig(
        vocab_ranges=(("default", c.vocab_size),),
        hidden_size=c.hidden_size,
        num_layers=c.num_layers,
        num_heads=c.num_heads,
        num_kv_heads=c.num_kv_heads,
        head_dim=c.head_dim,
        moe_intermediate_size=c.moe_intermediate_size,
        num_experts=c.num_experts,
        num_experts_per_tok=c.num_experts_per_tok,
        remat=c.remat if remat is None else remat,
        fused_qkv=c.fused_qkv,
        use_output_gate=c.use_output_gate,
        rope_fraction=c.rope_fraction,
        zero_centered_norms=c.zero_centered_norms,
        shared_expert=SharedExpertParameters(
            intermediate_size=c.shared_expert_intermediate_size,
            enable_gate=c.shared_expert_gate,
        )
        if c.shared_expert_intermediate_size > 0
        else None,
        ep_axes=ep_axes,
        moe_token_axes=moe_token_axes,
    )


def compute_dtype(c: ModelConfig) -> torch.dtype:
    if c.dtype not in _DTYPES:
        raise ValueError(f"ModelConfig.dtype {c.dtype!r}: one of "
                         f"{sorted(_DTYPES)}")
    return _DTYPES[c.dtype]


class MoEProvider(ModelProvider):
    def __init__(self, cfg: ModelConfig, seed: int = 0):
        self.cfg = cfg
        self.seed = seed

    def build_module(self, ctx):
        return Qwen3MoeCausalLM(
            build_model_config(
                self.cfg,
                ep_axes=ctx.ep_shard_axes,
                # ride the token layout through the EP dispatch
                moe_token_axes=(ctx.batch_axes, ctx.sequence_axes),
            ),
            build_sdpa_backend(),
            dtype=compute_dtype(self.cfg),
            param_dtype=torch.float32,
            device=ctx.device,
            seed=self.seed,
        )

    def build_plan(self, ctx):
        return fsdp_ep_plan(ctx)


class ConfiguredOptimizerProvider(OptimizerProvider):
    def __init__(self, cfg):
        self.cfg = cfg

    def build(self, params, learning_rate):
        return build_optimizer(self.cfg, params, learning_rate)


# ----------------------
# Build and run
# ----------------------


def build_trainer(cfg: ProjectConfig, ctx, *,
                  lr_total_steps: int | None = None) -> Trainer:
    """The example's ``Trainer`` on the mesh context ``ctx``. The LR
    schedule spans ``lr_total_steps`` (default: ``trainer.total_steps``,
    as in the JAX script): a run cut short of the config's steps keeps the
    config's schedule."""
    lr = build_lr_schedule(
        cfg.lr_scheduler, total_steps=(cfg.trainer.total_steps
                                       if lr_total_steps is None
                                       else lr_total_steps))
    if cfg.tracker.kind == "jsonl":
        tracker = build_tracker("jsonl", directory=cfg.tracker.directory)
    else:
        tracker = build_tracker(cfg.tracker.kind)
    return Trainer(
        ctx=ctx,
        config=cfg.trainer,
        model_provider=MoEProvider(cfg.model, seed=cfg.trainer.seed),
        dataset_provider=CorpusProvider(cfg.data, cfg.model.vocab_size,
                                        cfg.trainer),
        task=CausalLMTask(),
        optimizer_provider=ConfiguredOptimizerProvider(cfg.optimizer),
        learning_rate=lr,
        tracker=tracker,
    )


def rank_devices(device: str, world: int, backend: str | None) -> list[str]:
    """One device a rank: the CPU; on the card, ``cuda:0`` for every rank
    over gloo (they share it) and ``cuda:r`` over NCCL."""
    if device == "cpu":
        return ["cpu"] * world
    if backend == "nccl":
        return [f"cuda:{r}" for r in range(world)]
    return ["cuda:0"] * world


def run_rank(rank: int, world: int, rendezvous: str | None,
             raw: dict, device: str, backend: str | None,
             observe=None) -> None:
    """One rank: build, train, print (rank 0), export and close.
    ``observe(event, trainer, history)``, when given, is called with
    ``"built"`` before the training and ``"done"`` after the export (a
    module-level function, or a ``functools.partial`` of one: it travels
    to the spawned ranks by pickle)."""
    cfg = parse_config(raw)
    if world > 1:
        init_distributed(rank=rank, world_size=world, init_method=rendezvous,
                         backend=backend)
    try:
        ctx = MeshParameters(**dataclasses.asdict(cfg.mesh)).build(
            rank_devices(device, world, backend))
        if rank == 0:
            print(f"mesh: {dataclasses.asdict(cfg.mesh)} on {world} "
                  f"rank(s), device {device}", flush=True)
        trainer = build_trainer(cfg, ctx)
        if observe is not None:
            observe("built", trainer, None)
        history = trainer.train()
        if history and rank == 0:
            print(f"trained {history[-1]['step']} steps: loss "
                  f"{history[0]['loss']:.4f} -> {history[-1]['loss']:.4f}",
                  flush=True)
        if cfg.export_to:
            trainer.export(Path(cfg.export_to))
            if rank == 0:
                print(f"exported model weights to {cfg.export_to}",
                      flush=True)
        trainer.close()
        if observe is not None:
            observe("done", trainer, history)
    finally:
        shutdown_distributed()


def launch(raw: dict, *, device: str = "cuda", backend: str | None = None,
           observe=None) -> None:
    """Run the config ``raw`` (the JSON's dict) on its mesh: one rank in
    this process, or the mesh's ``world_size`` ranks as processes of their
    own (``torch.multiprocessing``, ``file://`` rendezvous in a temp
    directory; a rank that fails fails the launch)."""
    cfg = parse_config(raw)
    world = MeshParameters(**dataclasses.asdict(cfg.mesh)).world_size
    if device == "cuda":
        resolve_device(None)  # raises without a card
    if world == 1:
        run_rank(0, 1, None, raw, device, backend, observe)
        return
    if backend is None:
        raise ValueError(f"the mesh has {world} ranks: pass --backend gloo "
                         f"or --backend nccl")
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(
            run_rank, args=(world, f"file://{tmp}/rendezvous", raw, device,
                            backend, observe),
            nprocs=world, start_method="spawn")


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("config", nargs="?",
                    default="example/qwen3_moe/pretrain.json")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--backend", choices=("gloo", "nccl"), default=None)
    args = ap.parse_args(argv)
    launch(json.loads(Path(args.config).read_text()), device=args.device,
           backend=args.backend)


if __name__ == "__main__":
    main(sys.argv[1:])
