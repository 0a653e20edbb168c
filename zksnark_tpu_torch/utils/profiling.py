"""Phase timing, the program's spans, and its kernel launch counters.

The port's counterpart of `zksnark_tpu/utils/profiling.py`.

- `PhaseTimer`: named phases on the host clock, a phase on a CUDA tensor
  ended by `torch.cuda.synchronize`.
- The span recorder: `span(name, **attrs)` opens a span in the calling
  thread's tree; `spans()` reads what was recorded.  A span holds its
  name, its own id, its parent's, the id of the `prove` span it belongs
  to, its start and end, attributes, and whether it ended without an
  exception.  Starts and ends are Unix-epoch nanoseconds, the clock of
  `torch.profiler`'s events, so a reader can place a span among the
  kernels and idle gaps of a trace; within one tree they are one anchor
  read of `time.time_ns` plus `time.perf_counter_ns` offsets, so
  durations are monotonic.  Spans are kept in memory, the last
  `MAX_SPANS` of them, and reach no profiler, exporter or NVTX range.
- When it records: a tree's root decides once, at its start, and its
  spans follow.  It records while `torch.profiler` is active and inside
  `tracing()`; otherwise a span costs a flag check and records nothing.
- Device stage marks: in a recording tree on a CUDA card,
  `stream_marks(device)` records CUDA events on the card's stream
  (`mark()`), and `close(intervals)`, once the stream has been waited
  for, turns them into spans of the stream's wall time between marks.
- Launch counters: `launch_counter(owner, kernels)` makes a module's
  counter and registers it; `launch_counts()` reads them all.
- Layout counters: `groth16.prover.compile_r1cs` sets the numbers of the
  constraint matrices' split layout (`set_layout`, `LAYOUT_COUNTERS`);
  `layout_counts()` reads the last compile's.

`MULADDS_PER_MONT_MUL` counts the port's own unit: 32-bit multiply-adds,
264 per Montgomery product (CIOS on 8 words: 8 rows of 2 x 16
half-products plus one quotient digit, `chip_smoke.py`'s IMAD_PER_MUL).
The JAX package's `limb_muls` counts 8-bit digit multiply-adds of its TPU
layout (3 x 32 x 32 per product); `butterflies` is the JAX package's.
"""

from __future__ import annotations

import itertools
import json
import math
import threading
import time
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, NamedTuple, Optional, Tuple

# 32-bit multiply-adds per Montgomery product
MULADDS_PER_MONT_MUL = 8 * (2 * 16 + 1)

# the spans kept, the newest
MAX_SPANS = 1 << 16
PROVE = "prove"


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------

class Span(NamedTuple):
    name: str
    id: int
    parent: Optional[int]
    prove: Optional[int]      # the id of the `prove` span it lies in
    start_ns: int
    end_ns: int
    # "epoch": Unix-epoch ns; "stream": ns on the device's stream from the
    # prove's first mark
    clock: str
    attrs: dict
    ok: bool                  # ended without an exception


_spans: deque = deque(maxlen=MAX_SPANS)
_ids = itertools.count(1)
_tracing = 0
_tracing_lock = threading.Lock()


class _Local(threading.local):
    def __init__(self):
        self.stack = []       # open spans; None for a tree not recorded


_local = _Local()


def _profiler_on() -> bool:
    """Whether a `torch.profiler` session is active (in any thread)."""
    from torch.autograd import profiler

    return profiler._is_profiler_enabled


class _Open:
    __slots__ = ("name", "attrs", "id", "parent", "prove", "epoch0",
                 "mono0", "start_ns")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        stack = _local.stack
        parent = stack[-1] if stack else None
        self.id = next(_ids)
        mono = time.perf_counter_ns()
        if parent is None:
            self.parent, self.epoch0, self.mono0 = None, time.time_ns(), mono
            self.prove = None
        else:
            self.parent, self.prove = parent.id, parent.prove
            self.epoch0, self.mono0 = parent.epoch0, parent.mono0
        if self.name == PROVE:
            self.prove = self.id
        self.start_ns = self.epoch0 + mono - self.mono0
        stack.append(self)
        return self

    def __exit__(self, et, ev, tb):
        end = self.epoch0 + time.perf_counter_ns() - self.mono0
        _local.stack.pop()
        _spans.append(Span(self.name, self.id, self.parent, self.prove,
                           self.start_ns, end, "epoch", self.attrs,
                           et is None))
        return False


class _Off:
    """A tree that records nothing: its root marks the thread's stack."""

    __slots__ = ("root",)

    def __init__(self, root: bool):
        self.root = root

    def __enter__(self):
        if self.root:
            _local.stack.append(None)
        return None

    def __exit__(self, et, ev, tb):
        if self.root:
            _local.stack.pop()
        return False


_OFF_ROOT, _OFF = _Off(True), _Off(False)


def span(name: str, **attrs):
    """A context that records a span `name` in this thread's tree, where
    the tree records (its root decides: the profiler or `tracing()` on)."""
    stack = _local.stack
    if stack:
        return _OFF if stack[-1] is None else _Open(name, attrs)
    if _tracing or _profiler_on():
        return _Open(name, attrs)
    return _OFF_ROOT


def recording() -> bool:
    """Whether the span open in this thread records."""
    stack = _local.stack
    return bool(stack) and stack[-1] is not None


class tracing:
    """Record every tree whose root opens inside (in any thread)."""

    def __enter__(self):
        global _tracing
        with _tracing_lock:
            _tracing += 1
        return self

    def __exit__(self, et, ev, tb):
        global _tracing
        with _tracing_lock:
            _tracing -= 1
        return False


def spans() -> List[Span]:
    """The recorded spans, oldest first (each when it ended)."""
    return list(_spans)


def clear_spans() -> None:
    _spans.clear()


class StreamMarks:
    """CUDA events recorded on a card's current stream at a prove's stage
    boundaries; `close` reads them, once the stream has been waited for,
    into the enclosing span's device spans."""

    def __init__(self, device, owner: _Open):
        import torch

        self.torch, self.device, self.owner = torch, device, owner
        self.events = []

    def mark(self) -> None:
        ev = self.torch.cuda.Event(enable_timing=True)
        ev.record(self.torch.cuda.current_stream(self.device))
        self.events.append(ev)

    def close(self, intervals: Iterable[Tuple[str, int, int]]) -> None:
        """One span an interval (name, i, j), from mark i to mark j: the
        stream's wall time, idle bubbles included, in ns from the first
        mark."""
        first, o = self.events[0], self.owner
        at = [0] + [round(first.elapsed_time(ev) * 1e6)
                    for ev in self.events[1:]]
        for name, i, j in intervals:
            _spans.append(Span(name, next(_ids), o.id, o.prove, at[i], at[j],
                               "stream", {}, True))


def stream_marks(device) -> Optional[StreamMarks]:
    """Marks whose spans go to the `prove` span open in this thread (or,
    outside a prove, the open span), where it records and `device` is a
    CUDA card; None otherwise."""
    if not recording() or getattr(device, "type", None) != "cuda":
        return None
    stack = _local.stack
    owner = next((o for o in stack if o.id == stack[-1].prove), stack[-1])
    return StreamMarks(device, owner)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

@dataclass
class PhaseTimer:
    phases: Dict[str, float] = field(default_factory=dict)

    @contextmanager
    def phase(self, name: str, block_on=None):
        """Time the block, also a span `name`; `block_on`, a tensor (or a
        tuple or list of them), is waited for before the clock stops: a
        CUDA tensor by synchronizing its card."""
        t0 = time.perf_counter()
        with span(name):
            try:
                yield
            finally:
                if block_on is not None:
                    _wait(block_on)
                self.phases[name] = self.phases.get(name, 0.0) + (
                    time.perf_counter() - t0)

    def report(self) -> str:
        out = {"phases_s": {k: round(v, 4) for k, v in self.phases.items()}}
        return json.dumps(out, indent=2)


def _wait(obj) -> None:
    if isinstance(obj, (tuple, list)):
        for o in obj:
            _wait(o)
        return
    import torch

    if isinstance(obj, torch.Tensor) and obj.is_cuda:
        torch.cuda.synchronize(obj.device)


# ---------------------------------------------------------------------------
# launch counters
# ---------------------------------------------------------------------------

_counters: Dict[str, Dict[str, int]] = {}


def launch_counter(owner: str, kernels: Iterable[str]) -> Dict[str, int]:
    """A zeroed counter of `owner`'s kernel launches, by kernel name,
    registered under `owner` (the module that increments it)."""
    counter = dict.fromkeys(kernels, 0)
    _counters[owner] = counter
    return counter


def launch_counters() -> Dict[str, Dict[str, int]]:
    return dict(_counters)


def launch_counts() -> Dict[str, int]:
    """Every registered counter's launches by kernel name, summed."""
    out: Dict[str, int] = {}
    for counter in _counters.values():
        for k, v in counter.items():
            out[k] = out.get(k, 0) + v
    return out


def reset_launch_counts() -> None:
    for counter in _counters.values():
        for k in counter:
            counter[k] = 0


# ---------------------------------------------------------------------------
# layout counters
# ---------------------------------------------------------------------------

# summed over u, v and w but the widths: the ELL width k0 of each matrix,
# the rows in the ELLs and in the wide rows' CSR, the CSR's non-zeros, the
# ELL slots that hold padding and every product slot (ELL slots and CSR
# non-zeros)
LAYOUT_COUNTERS = ("narrow_width_u", "narrow_width_v", "narrow_width_w",
                   "narrow_rows", "wide_rows", "wide_nonzeros",
                   "padded_slots", "product_slots")
_layout: Dict[str, int] = {}


def set_layout(**values: int) -> None:
    """The last compiled circuit's layout numbers (`LAYOUT_COUNTERS`)."""
    if set(values) != set(LAYOUT_COUNTERS):
        raise ValueError(f"set_layout: {sorted(values)}")
    _layout.clear()
    _layout.update(values)


def layout_counts() -> Dict[str, int]:
    """The layout numbers of the last `compile_r1cs` ({} before one)."""
    return dict(_layout)


# ---------------------------------------------------------------------------
# work
# ---------------------------------------------------------------------------

def ntt_work(n: int) -> Dict[str, float]:
    """Butterflies and 32-bit multiply-adds of one size-n transform (one
    Montgomery product per butterfly)."""
    butterflies = n // 2 * int(math.log2(n))
    return {"butterflies": butterflies,
            "limb_muls": butterflies * MULADDS_PER_MONT_MUL}
