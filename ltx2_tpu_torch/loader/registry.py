"""Thread-safe registry of loaded state dicts (counterpart of
ltx2_tpu/loader/registry.py): keyed by sha256 of the resolved paths and an
op name, so components sharing a checkpoint can share host reads."""

from __future__ import annotations

import hashlib
import threading
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Protocol

StateDict = Dict[str, object]


class Registry(Protocol):
    def add(self, paths: List[str], op_name: Optional[str], state_dict: StateDict) -> str: ...
    def pop(self, paths: List[str], op_name: Optional[str]) -> Optional[StateDict]: ...
    def get(self, paths: List[str], op_name: Optional[str]) -> Optional[StateDict]: ...
    def clear(self) -> None: ...


class DummyRegistry:
    """A registry that keeps nothing, for callers that want no caching."""

    def add(self, _paths, _op_name, _state_dict) -> str:
        return ""

    def pop(self, _paths, _op_name) -> Optional[StateDict]:
        return None

    def get(self, _paths, _op_name) -> Optional[StateDict]:
        return None

    def clear(self) -> None:
        pass


@dataclass
class StateDictRegistry:
    _state_dicts: Dict[str, StateDict] = field(default_factory=dict)
    _lock: threading.Lock = field(default_factory=threading.Lock)

    def _generate_id(self, paths: List[str], op_name: Optional[str]) -> str:
        parts = [str(Path(p).resolve()) for p in paths]
        if op_name is not None:
            parts.append(op_name)
        return hashlib.sha256("\0".join(parts).encode("utf-8")).hexdigest()

    def add(self, paths: List[str], op_name: Optional[str], state_dict: StateDict) -> str:
        """Register `state_dict`; raises if one is registered under the same
        key (concurrent loaders use `add_or_get`)."""
        sd_id = self._generate_id(paths, op_name)
        with self._lock:
            if sd_id in self._state_dicts:
                raise ValueError(f"State dict from {paths} with {op_name} already added; check with get() first.")
            self._state_dicts[sd_id] = state_dict
        return sd_id

    def add_or_get(self, paths: List[str], op_name: Optional[str], state_dict: StateDict) -> StateDict:
        """Register `state_dict` unless one is registered under the same key,
        atomically; returns whichever is registered."""
        sd_id = self._generate_id(paths, op_name)
        with self._lock:
            return self._state_dicts.setdefault(sd_id, state_dict)

    def pop(self, paths: List[str], op_name: Optional[str]) -> Optional[StateDict]:
        with self._lock:
            return self._state_dicts.pop(self._generate_id(paths, op_name), None)

    def get(self, paths: List[str], op_name: Optional[str]) -> Optional[StateDict]:
        with self._lock:
            return self._state_dicts.get(self._generate_id(paths, op_name), None)

    def clear(self) -> None:
        with self._lock:
            self._state_dicts.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._state_dicts)

    def keys(self) -> List[str]:
        with self._lock:
            return list(self._state_dicts.keys())
