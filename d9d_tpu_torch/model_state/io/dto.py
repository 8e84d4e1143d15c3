"""Checkpoint index schema (counterpart of
``d9d_tpu/model_state/io/dto.py``): the HF-compatible
``model.safetensors.index.json``, a ``metadata.total_size`` and a
weight → file map, as dataclasses with JSON I/O."""

import dataclasses
import json

MODEL_STATE_INDEX_FILE_NAME = "model.safetensors.index.json"


@dataclasses.dataclass
class ModelStateIndexMeta:
    total_size: int


@dataclasses.dataclass
class ModelStateIndex:
    metadata: ModelStateIndexMeta
    weight_map: dict[str, str]

    def to_json(self, indent: int = 4) -> str:
        return json.dumps(dataclasses.asdict(self), indent=indent)

    @classmethod
    def from_json(cls, text: str) -> "ModelStateIndex":
        raw = json.loads(text)
        meta = raw.get("metadata") or {}
        return cls(
            metadata=ModelStateIndexMeta(
                total_size=int(meta.get("total_size", 0))),
            weight_map={str(k): str(v) for k, v in raw["weight_map"].items()})
