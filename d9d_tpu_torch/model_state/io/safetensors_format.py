"""The safetensors file format, read and written with torch and json alone
(the port's installations need not hold the ``safetensors`` package).

A file is an 8-byte little-endian header length ``n``, ``n`` bytes of JSON
header — ``{name: {"dtype": "F32", "shape": [...], "data_offsets": [begin,
end]}, ...}``, perhaps with ``"__metadata__"`` (read past), padded with
spaces to a multiple of 8 — then the tensors' raw little-endian bytes, the
offsets counted from the end of the header. Tensors are written in order
of element size (largest first), then name, as the ``safetensors`` package
writes them, so every tensor starts aligned to its element.

:class:`SafetensorsFile` reads the header once and a tensor, or a range of
its rows (dim 0), by byte offset: a rank reads only the rows of its piece.
"""

import json
import math
import struct
from pathlib import Path

import torch

DTYPES: dict[str, torch.dtype] = {
    "F32": torch.float32,
    "BF16": torch.bfloat16,
    "F16": torch.float16,
    "I64": torch.int64,
    "I32": torch.int32,
    "I8": torch.int8,
    "U8": torch.uint8,
    "BOOL": torch.bool,
}
_NAMES = {v: k for k, v in DTYPES.items()}


def _raw(t: torch.Tensor) -> torch.Tensor:
    """The bytes of a CPU tensor, as a flat ``uint8`` tensor."""
    t = t.detach().to("cpu").contiguous().reshape(-1)
    return t.view(torch.uint8)


def save_file(tensors: dict[str, torch.Tensor], path) -> int:
    """Write ``tensors`` to ``path``; returns the bytes of tensor data."""
    for name, t in tensors.items():
        if t.dtype not in _NAMES:
            raise ValueError(f"{name}: dtype {t.dtype} has no safetensors "
                             f"name ({sorted(_NAMES.values())})")
    order = sorted(tensors, key=lambda n: (-tensors[n].element_size(), n))
    header: dict = {}
    offset = 0
    for name in order:
        t = tensors[name]
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    text = json.dumps(header, separators=(",", ":")).encode("utf-8")
    text += b" " * (-len(text) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(text)))
        f.write(text)
        for name in order:
            f.write(_raw(tensors[name]).numpy().data)
    return offset


class SafetensorsFile:
    """One safetensors file, opened for reading (a context manager)."""

    def __init__(self, path):
        self.path = Path(path)
        self._f = open(self.path, "rb")
        (n,) = struct.unpack("<Q", self._f.read(8))
        header = json.loads(self._f.read(n))
        header.pop("__metadata__", None)
        self._entries = header
        self._base = 8 + n
        for name, e in header.items():
            if e["dtype"] not in DTYPES:
                raise ValueError(f"{self.path}: {name} has dtype "
                                 f"{e['dtype']}, not one of {sorted(DTYPES)}")

    def __enter__(self) -> "SafetensorsFile":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        self._f.close()

    def keys(self) -> list[str]:
        return list(self._entries)

    def dtype(self, name: str) -> torch.dtype:
        return DTYPES[self._entries[name]["dtype"]]

    def shape(self, name: str) -> tuple[int, ...]:
        return tuple(self._entries[name]["shape"])

    def _read(self, begin: int, nbytes: int) -> torch.Tensor:
        buf = torch.empty(nbytes, dtype=torch.uint8)
        self._f.seek(self._base + begin)
        if self._f.readinto(buf.numpy()) != nbytes:
            raise ValueError(f"{self.path}: truncated at byte "
                             f"{self._base + begin}")
        return buf

    def get_tensor(self, name: str) -> torch.Tensor:
        """The whole tensor, on the CPU."""
        shape = self.shape(name)
        return self.get_rows(name, 0, shape[0]) if shape else self._scalar(
            name)

    def _scalar(self, name: str) -> torch.Tensor:
        dtype = self.dtype(name)
        begin, _ = self._entries[name]["data_offsets"]
        raw = self._read(begin, torch.empty((), dtype=dtype).element_size())
        return raw.view(dtype).reshape(())

    def get_rows(self, name: str, start: int, stop: int) -> torch.Tensor:
        """Rows ``[start, stop)`` of dim 0, read alone from the file."""
        shape, dtype = self.shape(name), self.dtype(name)
        begin, end = self._entries[name]["data_offsets"]
        row = math.prod(shape[1:]) * torch.empty((), dtype=dtype).element_size()
        if end - begin != shape[0] * row:
            raise ValueError(f"{self.path}: {name} holds {end - begin} bytes, "
                             f"its shape {shape} wants {shape[0] * row}")
        if not 0 <= start <= stop <= shape[0]:
            raise IndexError(f"{name}: rows [{start}, {stop}) of {shape[0]}")
        raw = self._read(begin + start * row, (stop - start) * row)
        return raw.view(dtype).reshape(stop - start, *shape[1:])


def load_file(path) -> dict[str, torch.Tensor]:
    """Every tensor of the file at ``path``."""
    with SafetensorsFile(path) as f:
        return {name: f.get_tensor(name) for name in f.keys()}


__all__ = ["DTYPES", "SafetensorsFile", "load_file", "save_file"]
