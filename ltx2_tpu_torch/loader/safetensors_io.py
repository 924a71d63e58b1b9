"""safetensors reader and writer (counterpart of
ltx2_tpu/loader/safetensors_io.py).

The container is an 8-byte little-endian header length, a JSON header of
{name: {dtype, shape, data_offsets}} (and "__metadata__"), then the data.
The data region is memory-mapped (copy-on-write, so nothing is ever written
back) and a tensor is a view of its bytes in the file, reinterpreted as its
dtype: BF16 and the F8 types map straight to torch's dtypes. A tensor whose
offset in the file is not a multiple of its element size (another writer may
place a 4-byte scale after an fp8 tensor of any length) cannot be such a
view; it is copied, never read misaligned.
"""

from __future__ import annotations

import json
import math
import struct
from pathlib import Path
from typing import Callable, Dict, Iterable, Iterator, Optional, Tuple

import numpy as np
import torch

DTYPES: Dict[str, torch.dtype] = {
    "F64": torch.float64,
    "F32": torch.float32,
    "F16": torch.float16,
    "BF16": torch.bfloat16,
    "F8_E4M3": torch.float8_e4m3fn,
    "F8_E5M2": torch.float8_e5m2,
    "I64": torch.int64,
    "I32": torch.int32,
    "I16": torch.int16,
    "I8": torch.int8,
    "U8": torch.uint8,
    "BOOL": torch.bool,
    "U16": torch.uint16,
    "U32": torch.uint32,
    "U64": torch.uint64,
}
DTYPE_NAMES: Dict[torch.dtype, str] = {v: k for k, v in DTYPES.items()}

# (name, dtype, shape, producer): the writer's description of one tensor;
# producer() returns its data when the writer reaches it.
Spec = Tuple[str, torch.dtype, Tuple[int, ...], Callable[[], torch.Tensor]]


def _read_header(path: str) -> Tuple[int, dict]:
    with open(path, "rb") as f:
        header_len = struct.unpack("<Q", f.read(8))[0]
        return header_len, json.loads(f.read(header_len))


class SafetensorsFile:
    """A lazily mapped safetensors container."""

    def __init__(self, path: str):
        self.path = str(path)
        header_len, header = _read_header(self.path)
        self.metadata: Dict[str, str] = header.pop("__metadata__", {}) or {}
        self._entries: Dict[str, dict] = header
        self._data_start = 8 + header_len
        self._bytes: Optional[torch.Tensor] = None

    def keys(self):
        return self._entries.keys()

    def __contains__(self, key: str) -> bool:
        return key in self._entries

    def info(self, key: str) -> Tuple[str, Tuple[int, ...]]:
        """(dtype name, shape) from the header alone."""
        e = self._entries[key]
        return e["dtype"], tuple(e["shape"])

    def nbytes(self, key: str) -> int:
        start, end = self._entries[key]["data_offsets"]
        return end - start

    def _map(self) -> torch.Tensor:
        if self._bytes is None:
            self._bytes = torch.from_numpy(np.memmap(self.path, dtype=np.uint8, mode="c"))
        return self._bytes

    def get(self, key: str) -> torch.Tensor:
        """The tensor on the CPU: a view of the mapped file where its offset
        is aligned to its element size, else a copy. Do not write to it."""
        e = self._entries[key]
        dtype = DTYPES[e["dtype"]]
        start, end = e["data_offsets"]
        offset = self._data_start + start
        buf = self._map()[offset: self._data_start + end]
        if offset % dtype.itemsize:
            buf = buf.clone()
        return buf.view(dtype).reshape(e["shape"])

    def items(self) -> Iterator[Tuple[str, torch.Tensor]]:
        for key in self._entries:
            yield key, self.get(key)

    def close(self) -> None:
        self._bytes = None


def read_metadata(path: str) -> Dict[str, str]:
    """The `__metadata__` block alone (reads only the header)."""
    return _read_header(str(path))[1].get("__metadata__", {}) or {}


def write_safetensors_streaming(path: str, specs: Iterable[Spec], metadata: Optional[Dict[str, str]] = None) -> None:
    """Write `specs` (name, dtype, shape, producer), one tensor produced at a
    time: the header is computed from dtypes and shapes alone, so the host
    holds one tensor, never the whole checkpoint. Each producer's tensor may
    live on any device; it must have the declared dtype and shape."""
    specs = list(specs)
    header: Dict[str, object] = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    offset = 0
    for name, dtype, shape, _producer in specs:
        if dtype not in DTYPE_NAMES:
            raise ValueError(f"Unsupported dtype {dtype} for {name}")
        nbytes = dtype.itemsize * math.prod(int(s) for s in shape)
        header[str(name)] = {"dtype": DTYPE_NAMES[dtype], "shape": [int(s) for s in shape],
                             "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    header_bytes = json.dumps(header).encode("utf-8")
    header_bytes += b" " * ((-len(header_bytes)) % 8)  # 8-byte aligned data, as the spec recommends
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(header_bytes)))
        f.write(header_bytes)
        for name, dtype, shape, producer in specs:
            t = producer()
            if t.dtype != dtype or tuple(t.shape) != tuple(int(s) for s in shape):
                raise ValueError(f"Producer for {name} returned {t.dtype}{tuple(t.shape)}, "
                                 f"declared {dtype}{tuple(shape)}")
            f.write(t.detach().contiguous().cpu().reshape(-1).view(torch.uint8).numpy().data)


def write_safetensors(path: str, tensors: Dict[str, torch.Tensor], metadata: Optional[Dict[str, str]] = None) -> None:
    """Write a dict of tensors (tests, small files)."""
    specs = [(name, t.dtype, tuple(t.shape), (lambda t=t: t)) for name, t in tensors.items()]
    write_safetensors_streaming(path, specs, metadata=metadata)
