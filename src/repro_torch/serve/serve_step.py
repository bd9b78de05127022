"""Batched LM serving: prefill + decode loop with continuous batching slots.

Port of ``repro.serve.serve_step``.  The engine keeps a fixed pool of
batch slots; finished sequences free their slot, pending requests claim
one and are prefilled alone (batch 1, one prefill length per engine) and
merged into it; every step decodes all slots in lockstep.  Everything
runs where the parameters live (``device``, the card by default); the
only data a step brings to the host is the sampled token ids.

Reference behaviours the port keeps (ROADMAP.md, Queue 3):

* the caches share one ``len``, which an admission resets to
  ``prefill_len`` and every step advances, so a long request writes past
  the dense caches' capacity (``prefill_len + DECODE_CACHE_MARGIN``);
  the write lands in the last entry (``attention.write_slot`` clamps as
  ``jax.lax.dynamic_update_slice`` does);
* ``merge`` picks a cache leaf's batch axis by its size: axis 1 if it
  equals ``batch_slots``, else axis 0.  The hybrid family's ``h`` and
  ``conv`` are ``(n_super, 2, B, ...)``, so with ``batch_slots=2`` an
  admission writes the new request's state over the second axis, into
  both slots (its state is zero: ``prefill`` returns zero recurrent
  states for ``ssm`` and ``hybrid``).

Greedy decoding takes the first maximum, as ``jnp.argmax``.  Temperature
sampling draws Gumbel noise from a ``torch.Generator`` seeded by
``seed``: deterministic per seed, not ``jax.random``'s stream.

The wavelet transform engine is re-exported here, as the reference does.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Any, List, Optional

import numpy as np
import torch
from torch import Tensor

from repro_torch import tree as T
from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.backend import resolve_device
from repro_torch.models import transformer as TF
from repro_torch.serve.engine import (  # noqa: F401  re-exports, as the reference's
    TransformRequest,
    WaveletServeEngine,
    crop_result,
)

PyTree = Any


@dataclass
class Request:
    uid: int
    prompt: np.ndarray  # (prompt_len,) int32
    max_new: int
    out_tokens: List[int] = field(default_factory=list)
    done: bool = False


@dataclass
class ServeEngine:
    cfg: ArchConfig
    params: PyTree
    batch_slots: int
    prefill_len: int
    temperature: float = 0.0
    seed: int = 0
    device: Any = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)
        placed = {leaf.device.type for leaf in T.leaves(self.params)}
        if placed != {self.device.type}:
            raise ValueError(f"params live on {sorted(placed)}, the engine on {self.device}")
        self.caches = TF.init_caches(self.cfg, self.batch_slots, self.prefill_len,
                                     device=self.device)
        self.slot_req: List[Optional[Request]] = [None] * self.batch_slots
        self._gen = torch.Generator(device=self.device).manual_seed(self.seed)

    def _sample(self, logits: Tensor) -> np.ndarray:
        last = logits[:, -1].float()
        if self.temperature <= 0.0:
            ids = torch.argmax(last, dim=-1)
        else:
            u = torch.rand(last.shape, generator=self._gen, device=last.device)
            gumbel = -torch.log(-torch.log(u.clamp(min=torch.finfo(u.dtype).tiny)))
            ids = torch.argmax(last / self.temperature + gumbel, dim=-1)
        return ids.to(torch.int32).cpu().numpy()

    def _tokens(self, host: np.ndarray) -> Tensor:
        return torch.from_numpy(host).to(self.device)

    def admit(self, req: Request) -> bool:
        """Prefill a request into a free slot; False if engine is full."""
        try:
            slot = self.slot_req.index(None)
        except ValueError:
            return False
        prompt = np.zeros((self.prefill_len,), np.int32)
        plen = min(len(req.prompt), self.prefill_len)
        prompt[:plen] = req.prompt[:plen]
        # single-row prefill, merged into this slot only
        logits, caches = TF.prefill(self.params, self.cfg, tokens=self._tokens(prompt[None]))

        def merge(dst: Tensor, src: Tensor) -> Tensor:
            if dst.ndim >= 2 and dst.shape[1] == self.batch_slots:  # (L,B,...)
                dst[:, slot] = src[:, 0]
                return dst
            if dst.ndim >= 1 and dst.shape[0] == self.batch_slots:  # (B,...)
                dst[slot] = src[0]
                return dst
            return src  # scalars ("len") — lockstep by construction

        self.caches = {k: merge(self.caches[k], caches[k]) for k in self.caches}
        req.out_tokens = [int(self._sample(logits)[0])]
        self.slot_req[slot] = req
        return True

    def step(self) -> List[Request]:
        """One decode step for all active slots; returns finished requests."""
        active = [r for r in self.slot_req if r is not None]
        if not active:
            return []
        last = np.zeros((self.batch_slots, 1), np.int32)
        for i, r in enumerate(self.slot_req):
            if r is not None and r.out_tokens:
                last[i, 0] = r.out_tokens[-1]
        logits, self.caches = TF.decode_step(self.params, self.cfg, self.caches,
                                             tokens=self._tokens(last))
        nxt = self._sample(logits)
        finished = []
        for i, r in enumerate(self.slot_req):
            if r is None:
                continue
            r.out_tokens.append(int(nxt[i]))
            if len(r.out_tokens) >= r.max_new:
                r.done = True
                finished.append(r)
                self.slot_req[i] = None
        return finished

    def run(self, requests: List[Request], max_steps: int = 10_000) -> List[Request]:
        pending = deque(requests)
        done: List[Request] = []
        steps = 0
        while (pending or any(self.slot_req)) and steps < max_steps:
            while pending and self.admit(pending[0]):
                pending.popleft()
            done.extend(self.step())
            steps += 1
        return done
