"""Fault tolerance of the PyTorch port for 1000+-node runs: heartbeat/straggler
monitoring and the restart/elastic-reshard policy.  The port's own copy of
the JAX package's ``train/fault.py`` (standard library only).

On real multi-host TPU pods each host runs the same SPMD program; failures
surface as missing heartbeats or collective timeouts.  The policy layer here
is host-agnostic (driven by step-duration samples + liveness callbacks) and
is exercised on CPU by the tests and the trainer with simulated failures —
the same code path a production launcher would call.

Design (matches the paper's scale story translated to pods):
* heartbeat: every worker stamps a monotonic step counter; the monitor flags
  workers > ``timeout`` behind the median.
* straggler mitigation: workers whose rolling step time exceeds
  ``straggler_factor`` × fleet median get flagged; the launcher's response is
  (1) re-route input shards away from them, (2) if persistent, treat as
  failed and trigger an elastic reshape.
* elastic reshape: pick the largest feasible mesh from the survivor count
  (power-of-two data axis, fixed model axis), restore the latest checkpoint
  onto it (checkpoint.restore is sharding-agnostic), and continue — the
  deterministic data pipeline replays from the exact step cursor.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple


@dataclass
class WorkerState:
    last_step: int = 0
    last_beat: float = 0.0
    step_times: deque = field(default_factory=lambda: deque(maxlen=16))
    alive: bool = True


class HeartbeatMonitor:
    def __init__(self, n_workers: int, timeout_s: float = 60.0, straggler_factor: float = 2.0):
        self.workers: Dict[int, WorkerState] = {i: WorkerState() for i in range(n_workers)}
        self.timeout_s = timeout_s
        self.straggler_factor = straggler_factor

    def beat(self, worker: int, step: int, now: Optional[float] = None) -> None:
        now = time.monotonic() if now is None else now
        w = self.workers[worker]
        if w.last_beat:
            w.step_times.append((now - w.last_beat) / max(step - w.last_step, 1))
        w.last_step, w.last_beat = step, now

    def _median_rate(self) -> float:
        rates = sorted(
            sum(w.step_times) / len(w.step_times)
            for w in self.workers.values()
            if w.alive and w.step_times
        )
        return rates[len(rates) // 2] if rates else 0.0

    def dead(self, now: Optional[float] = None) -> List[int]:
        now = time.monotonic() if now is None else now
        return [
            i for i, w in self.workers.items()
            if w.alive and w.last_beat and now - w.last_beat > self.timeout_s
        ]

    def stragglers(self) -> List[int]:
        med = self._median_rate()
        if med <= 0:
            return []
        out = []
        for i, w in self.workers.items():
            if w.alive and w.step_times:
                mine = sum(w.step_times) / len(w.step_times)
                if mine > self.straggler_factor * med:
                    out.append(i)
        return out

    def mark_dead(self, worker: int) -> None:
        self.workers[worker].alive = False

    def alive_count(self) -> int:
        return sum(w.alive for w in self.workers.values())


def elastic_mesh_shape(survivors: int, model_axis: int = 16, pod_axis: int = 1) -> Tuple[int, ...]:
    """Largest power-of-two data axis that the survivor count supports, model
    axis fixed (TP re-sharding changes per-op layouts; DP scaling does not)."""
    per_pod = survivors // pod_axis
    data = 1
    while 2 * data * model_axis <= per_pod:
        data *= 2
    if data * model_axis < model_axis:
        raise RuntimeError(f"not enough survivors ({survivors}) for model axis {model_axis}")
    if pod_axis > 1:
        return (pod_axis, data, model_axis)
    return (data, model_axis)


@dataclass
class RestartPolicy:
    """What the launcher does per failure class."""
    max_restarts: int = 100
    restarts: int = 0

    def on_failure(self, monitor: HeartbeatMonitor, dead: List[int]) -> Dict:
        for d in dead:
            monitor.mark_dead(d)
        self.restarts += 1
        if self.restarts > self.max_restarts:
            raise RuntimeError("restart budget exhausted")
        shape = elastic_mesh_shape(monitor.alive_count())
        return {
            "action": "elastic_restart",
            "new_mesh_shape": shape,
            "resume": "latest_checkpoint + deterministic data cursor",
        }
