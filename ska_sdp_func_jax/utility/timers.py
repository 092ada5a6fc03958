"""Hierarchical named timers.

Reference: utility/sdp_timer.{h,cpp} provides a single timer plus a named
timer tree with push/pop and a pretty-printed percentage report, with
wall-clock or CUDA-event backends (sdp_timer.h:20-148). Here the device
analogue of "CUDA events" is synchronising on the arrays produced by a
region (`jax.block_until_ready`), so `TimerType.DEVICE` timers call
`block_until_ready` on values registered via :meth:`Timers.sync` before
reading the clock.
"""

from __future__ import annotations

import enum
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import jax


class TimerType(enum.Enum):
    """Timer backend (reference: SDP_TIMER_NATIVE / SDP_TIMER_CUDA)."""

    NATIVE = "native"
    DEVICE = "device"


class Timer:
    """Single stopwatch accumulating elapsed time across start/pause cycles."""

    def __init__(self, timer_type: TimerType = TimerType.NATIVE):
        self.timer_type = timer_type
        self._elapsed = 0.0
        self._start: Optional[float] = None

    def start(self) -> None:
        if self._start is None:
            self._start = time.perf_counter()

    def pause(self) -> None:
        if self._start is not None:
            self._elapsed += time.perf_counter() - self._start
            self._start = None

    def reset(self) -> None:
        self._elapsed = 0.0
        self._start = None

    def elapsed(self) -> float:
        total = self._elapsed
        if self._start is not None:
            total += time.perf_counter() - self._start
        return total


@dataclass
class _TimerNode:
    name: str
    timer: Timer
    children: Dict[str, "_TimerNode"] = field(default_factory=dict)


class Timers:
    """Named timer tree with push/pop scoping and a percentage report.

    Mirrors `sdp_Timers` (sdp_timer.h:43-148): `push(name)` opens a nested
    section, `pop()` closes it, `report()` pretty-prints the tree with
    percentages of the root total.
    """

    def __init__(self, name: str = "Timing report",
                 timer_type: TimerType = TimerType.NATIVE):
        self.timer_type = timer_type
        self._root = _TimerNode(name, Timer(timer_type))
        self._stack: List[_TimerNode] = [self._root]
        self._root.timer.start()
        self._pending_sync: List = []

    def sync(self, *values) -> None:
        """Register device values the next pop should block on (DEVICE type)."""
        if self.timer_type is TimerType.DEVICE:
            self._pending_sync.extend(values)

    def _drain_sync(self) -> None:
        if self._pending_sync:
            jax.block_until_ready(self._pending_sync)
            self._pending_sync = []

    def push(self, name: str) -> "Timers":
        parent = self._stack[-1]
        node = parent.children.get(name)
        if node is None:
            node = _TimerNode(name, Timer(self.timer_type))
            parent.children[name] = node
        node.timer.start()
        self._stack.append(node)
        return self

    def pop(self) -> None:
        if len(self._stack) <= 1:
            return
        self._drain_sync()
        node = self._stack.pop()
        node.timer.pause()

    def pop_push(self, name: str) -> "Timers":
        self.pop()
        return self.push(name)

    def record(self, name: str, seconds: float) -> None:
        """Accumulate an externally measured duration under ``name``.

        Used by drivers that time each stage as the difference of two
        measured pipeline prefixes (parallel/packed.py report_timing)."""
        parent = self._stack[-1]
        node = parent.children.get(name)
        if node is None:
            node = _TimerNode(name, Timer(self.timer_type))
            parent.children[name] = node
        node.timer._elapsed += float(seconds)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.pop()
        return False

    def section(self, name: str) -> "Timers":
        """Context-manager sugar: ``with timers.section("fft"): ...``."""
        return self.push(name)

    def report(self, print_fn=print) -> str:
        self._drain_sync()
        total = self._root.timer.elapsed()
        lines = [f"{self._root.name} ({total:.3f} s total)"]

        def _walk(node: _TimerNode, indent: int):
            timed = 0.0
            for child in node.children.values():
                elapsed = child.timer.elapsed()
                timed += elapsed
                pct = 100.0 * elapsed / total if total > 0 else 0.0
                lines.append(
                    f"{'  ' * indent}+- {child.name}: "
                    f"{elapsed:.3f} s ({pct:.1f}%)"
                )
                _walk(child, indent + 1)
            if node.children:
                parent_elapsed = node.timer.elapsed()
                unaccounted = parent_elapsed - timed
                if unaccounted > 1e-4 and parent_elapsed > 0:
                    pct = 100.0 * unaccounted / total if total > 0 else 0.0
                    lines.append(
                        f"{'  ' * indent}+- (unaccounted): "
                        f"{unaccounted:.3f} s ({pct:.1f}%)"
                    )

        _walk(self._root, 0)
        text = "\n".join(lines)
        if print_fn is not None:
            print_fn(text)
        return text
