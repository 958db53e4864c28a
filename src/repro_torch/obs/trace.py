"""Structured trace events: a bounded ring buffer with an optional JSONL
file sink.  Counterpart of ``repro/obs/trace.py``.

Every planner decision (background mark/exec, tier spill/promote
commits, PQ re-train slot evictions) emits one event with its reason,
so a tick's behaviour can be reconstructed afterwards.  Events are plain
dicts::

    {"seq": 17, "t": 0.482913, "kind": "tick", "executed": 4, ...}

Recording appends to a deque (bounded, oldest dropped) and, with a sink,
writes one JSON line.  A disabled tracer returns from ``emit`` before it
looks at its arguments, so the cost of tracing off is one attribute
check.  Fields are converted by :func:`_jsonable`; a device tensor there
costs a synchronisation, so the emit sites pass host values.
"""
from __future__ import annotations

import io
import json
import time
from collections import deque
from typing import Callable, Dict, Iterator, List, Optional


def _jsonable(x):
    """Best-effort conversion of numpy and torch scalars and arrays."""
    if isinstance(x, (str, int, float, bool)) or x is None:
        return x
    if isinstance(x, dict):
        return {str(k): _jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    item = getattr(x, "item", None)
    if item is not None and getattr(x, "ndim", 1) == 0:
        return item()
    tolist = getattr(x, "tolist", None)
    if tolist is not None:
        return tolist()
    return repr(x)


class Tracer:
    """Bounded in-memory event log + optional JSONL file sink."""

    def __init__(self, capacity: int = 4096,
                 path: Optional[str] = None,
                 clock: Callable[[], float] = time.perf_counter,
                 enabled: bool = True):
        self.enabled = enabled
        self.capacity = capacity
        self.clock = clock
        self._buf: deque = deque(maxlen=capacity)
        self._seq = 0
        self._fh: Optional[io.TextIOBase] = None
        if path is not None:
            self._fh = open(path, "a", encoding="utf-8")

    def emit(self, kind: str, **fields) -> None:
        if not self.enabled:
            return
        ev: Dict[str, object] = {"seq": self._seq,
                                 "t": round(float(self.clock()), 6),
                                 "kind": kind}
        for k, v in fields.items():
            ev[k] = _jsonable(v)
        self._seq += 1
        self._buf.append(ev)
        if self._fh is not None:
            self._fh.write(json.dumps(ev) + "\n")

    def events(self, kind: Optional[str] = None) -> List[Dict[str, object]]:
        if kind is None:
            return list(self._buf)
        return [e for e in self._buf if e["kind"] == kind]

    def __iter__(self) -> Iterator[Dict[str, object]]:
        return iter(self._buf)

    def __len__(self) -> int:
        return len(self._buf)

    def to_jsonl(self) -> str:
        return "\n".join(json.dumps(e) for e in self._buf)

    def clear(self) -> None:
        self._buf.clear()

    def close(self) -> None:
        if self._fh is not None:
            self._fh.flush()
            self._fh.close()
            self._fh = None
