"""Fault-tolerance manager: resume, straggler watchdog, device moves.

Port of ``repro.ckpt.ft``, plain Python over the port's
:class:`~repro_torch.ckpt.checkpoint.CheckpointManager`:

  * resume-from-latest with exact replay (a step-addressable batch
    function makes the replay deterministic),
  * straggler detection: a per-step wall-time watchdog flags steps slower
    than ``threshold x`` the running median,
  * :func:`reshard_to_mesh`: the elastic-restart placement of a restored
    tree onto a (new) mesh, from ``(mesh, placements)`` pairs
    (``sharding.tree_shardings``) with ``distribute_tensor``, or a plain
    device move.

Node loss itself is simulated: ``fail_at`` raises mid-run in tests, and
recovery is restore + replay.
"""
from __future__ import annotations

import collections
import statistics
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Deque, Dict, Optional

import torch

from repro_torch import tree as T
from repro_torch.ckpt.checkpoint import CheckpointManager

PyTree = Any


@dataclass
class StragglerWatchdog:
    """Flags steps slower than ``threshold`` x running median.

    Both buffers are bounded ring buffers: ``history`` keeps the last
    ``window`` step times, ``flagged`` the last ``flagged_cap`` flag
    records.
    """

    threshold: float = 2.0
    window: int = 32
    flagged_cap: int = 256
    history: Deque[float] = field(default_factory=collections.deque)
    flagged: Deque[Dict] = field(default_factory=collections.deque)

    def __post_init__(self):
        self.history = collections.deque(self.history, maxlen=self.window)
        self.flagged = collections.deque(self.flagged, maxlen=self.flagged_cap)

    def observe(self, step: int, seconds: float) -> bool:
        self.history.append(seconds)  # deque maxlen evicts the oldest
        if len(self.history) >= 5:
            med = statistics.median(self.history)
            if seconds > self.threshold * med:
                self.flagged.append({"step": step, "seconds": seconds, "median": med})
                return True
        return False


@dataclass
class TrainLoopRunner:
    """Checkpointed, watchdogged, resumable train loop."""

    ckpt: CheckpointManager
    save_every: int = 50
    watchdog: StragglerWatchdog = field(default_factory=StragglerWatchdog)
    async_save: bool = True

    def run(
        self,
        state: PyTree,
        step_fn: Callable[[PyTree, Dict], tuple],
        batch_fn: Callable[[int], Dict],
        n_steps: int,
        start_step: int = 0,
        on_metrics: Optional[Callable[[int, Dict], None]] = None,
        fail_at: Optional[int] = None,  # test hook: simulate a node failure
    ) -> tuple:
        step = start_step
        while step < n_steps:
            if fail_at is not None and step == fail_at:
                raise RuntimeError(f"simulated node failure at step {step}")
            t0 = time.perf_counter()
            batch = batch_fn(step)
            state, metrics = step_fn(state, batch)
            dt = time.perf_counter() - t0
            if self.watchdog.observe(step, dt):
                metrics = dict(metrics)
                metrics["straggler_flag"] = True
            if on_metrics:
                on_metrics(step, metrics)
            step += 1
            if step % self.save_every == 0:
                # save() joins the previous async save first, so a save
                # that died on its thread raises HERE, on the loop
                self.ckpt.save(step, state, blocking=not self.async_save)
        self.ckpt.wait()
        self.ckpt.save(step, state, blocking=True)
        return state, step

    def resume_or_init(self, init_state: PyTree) -> tuple:
        latest = self.ckpt.latest_step()
        if latest is None:
            return init_state, 0
        step, state = self.ckpt.restore(latest, template=init_state)
        return state, step


def reshard_to_mesh(tree: PyTree, shardings) -> PyTree:
    """Place a host or device tree onto a (possibly new) mesh — the
    elastic-restart path after a failure changes the rank count.

    ``shardings`` is a tree of ``(mesh, placements)`` pairs shaped like
    ``tree`` (``sharding.tree_shardings``): each leaf (a tensor or a
    numpy array) becomes a DTensor by ``distribute_tensor``, which every
    rank of the mesh calls in step.  A device (``"cuda"``, ``"cpu"``)
    instead moves every leaf there."""
    if isinstance(shardings, (str, torch.device)):
        dev = torch.device(shardings)
        return T.map_leaves(lambda t: torch.as_tensor(t).to(dev), tree)
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.collectives import mesh_device
    from repro_torch.sharding import is_sharding

    pairs = T.leaves(shardings, is_leaf=is_sharding)
    leaves = T.leaves(tree)
    if len(pairs) != len(leaves):
        raise ValueError(f"{len(leaves)} leaves but {len(pairs)} shardings")
    return T.unflatten(tree, [
        distribute_tensor(torch.as_tensor(x).to(mesh_device(mesh)), mesh, list(placements))
        for x, (mesh, placements) in zip(leaves, pairs)
    ])
