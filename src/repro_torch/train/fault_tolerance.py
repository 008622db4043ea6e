"""Fault-tolerance harness for the train loop
(``repro/train/fault_tolerance.py``, with the same restart, data-rewind and
SIGTERM semantics):

  * checkpoint/restart — ``run_resilient`` wraps the step loop: it restores
    the latest complete checkpoint on entry (including the data-pipeline
    cursor), checkpoints every ``ckpt_every`` steps (async), and on a step
    failure restores and retries with bounded backoff.  Preemption (SIGTERM)
    triggers a final synchronous checkpoint before exit.
  * straggler mitigation — ``StepTimer`` keeps an EWMA of step wall-time and
    flags steps slower than ``threshold``x the mean (logged and counted; a
    single process cannot migrate a host).
  * failure injection — ``FailureInjector`` deterministically raises inside
    chosen steps so the restart path is exercised by tests.

``step_fn`` takes the batch as the data iterator gives it; the launcher
wraps it to move the batch to the device.  The loop reads each step's
metrics back to the host (``float``) to log them.
"""

from __future__ import annotations

import dataclasses
import signal
import time
from typing import Any, Callable, Dict, List, Optional

from repro_torch.train import checkpoint as C


@dataclasses.dataclass
class StepTimer:
    alpha: float = 0.1
    threshold: float = 2.0
    mean_s: float = 0.0
    stragglers: List[int] = dataclasses.field(default_factory=list)

    def record(self, step: int, dt: float) -> bool:
        if self.mean_s == 0.0:
            self.mean_s = dt
            return False
        slow = dt > self.threshold * self.mean_s
        if slow:
            self.stragglers.append(step)
        # EWMA excludes outliers so one straggler doesn't poison the baseline
        if not slow:
            self.mean_s = (1 - self.alpha) * self.mean_s + self.alpha * dt
        return slow


class FailureInjector:
    def __init__(self, fail_at: Optional[List[int]] = None):
        self.fail_at = set(fail_at or [])
        self.fired = set()

    def maybe_fail(self, step: int) -> None:
        if step in self.fail_at and step not in self.fired:
            self.fired.add(step)
            raise RuntimeError(f"injected failure at step {step}")


@dataclasses.dataclass
class RunReport:
    steps_done: int
    restarts: int
    stragglers: List[int]
    final_metrics: Dict[str, float]


def run_resilient(
    *,
    ckpt_dir: str,
    total_steps: int,
    init_fn: Callable[[], Any],  # () -> (params, opt_state)
    step_fn: Callable[[Any, Any, Dict], Any],  # -> (params, opt, metrics)
    data_iter,
    ckpt_every: int = 50,
    keep: int = 3,
    max_restarts: int = 5,
    injector: Optional[FailureInjector] = None,
    on_metrics: Optional[Callable[[int, Dict], None]] = None,
) -> RunReport:
    """The production step loop, shrunk to single-process semantics."""
    timer = StepTimer()
    restarts = 0
    pending_writer = None
    preempted = {"flag": False}

    def _sigterm(signum, frame):  # preemption notice
        preempted["flag"] = True

    old_handler = signal.signal(signal.SIGTERM, _sigterm)
    initial_data_state = data_iter.state()
    try:
        params, opt_state = init_fn()
        start = 0
        last = C.latest_step(ckpt_dir)
        if last is not None:
            params, opt_state, data_state, extra = C.restore(
                ckpt_dir, last, params, opt_state)
            if data_state:
                data_iter.restore(data_state)
            start = last
        metrics: Dict[str, float] = {}
        step = start
        while step < total_steps:
            try:
                batch = next(data_iter)
                if injector:
                    injector.maybe_fail(step)
                t0 = time.time()
                params, opt_state, metrics = step_fn(params, opt_state, batch)
                metrics = {k: float(v) for k, v in metrics.items()}
                timer.record(step, time.time() - t0)
                step += 1
                if on_metrics:
                    on_metrics(step, metrics)
                if step % ckpt_every == 0 or preempted["flag"]:
                    if pending_writer is not None:
                        pending_writer.join()
                    pending_writer = C.save(
                        ckpt_dir, step, params, opt_state,
                        data_state=data_iter.state(),
                        extra={"metrics": metrics},
                        async_write=not preempted["flag"],
                    )
                    C.gc_old(ckpt_dir, keep=keep)
                if preempted["flag"]:
                    break
            except Exception:  # noqa: BLE001 — restart path
                restarts += 1
                if restarts > max_restarts:
                    raise
                if pending_writer is not None:
                    # an async save may still be in flight — land it so we
                    # restore the newest complete checkpoint, not a stale one
                    pending_writer.join()
                    pending_writer = None
                last = C.latest_step(ckpt_dir)
                if last is not None:
                    params, opt_state, data_state, _ = C.restore(
                        ckpt_dir, last, params, opt_state)
                    if data_state:
                        data_iter.restore(data_state)
                    step = last
                else:
                    # fresh restart: rewind the data stream too, or the
                    # retried run trains on a shifted batch sequence
                    params, opt_state = init_fn()
                    data_iter.restore(initial_data_state)
                    step = 0
        if pending_writer is not None:
            pending_writer.join()
        return RunReport(step, restarts, timer.stragglers, metrics)
    finally:
        signal.signal(signal.SIGTERM, old_handler)
