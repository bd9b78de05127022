"""Deterministic, shardable data pipelines (port of ``repro.data.pipeline``).

Two sources behind one interface:
  * SyntheticLM   — seeded Zipf-ish token stream (self-contained runs/tests)
  * FileTokens    — memory-mapped token files (one .npy of uint16/uint32)

Both produce per-host batches deterministically from (seed, step, host_id):
restart-safe (a resumed step re-reads the same batch — required for exact
checkpoint/restart) and elastic-safe (host count is an explicit parameter
of the index math, not ambient state).

The wavelet band-split transform (the paper's application domain) is
available as a pipeline stage for the audio examples.  It runs where its
``device`` says: on the card through ``repro_torch.kernels.dwt_fwd``
(the ``lift1d`` kernel's runs), on the CPU through its plain version;
both give the reference's integers.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch

from repro_torch import kernels as K
from repro_torch.kernels.backend import resolve_device


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    n_hosts: int = 1
    host_id: int = 0
    seed: int = 1234

    @property
    def host_batch(self) -> int:
        assert self.global_batch % self.n_hosts == 0
        return self.global_batch // self.n_hosts


def _rng_for(cfg: DataConfig, step: int, row: int) -> np.random.Generator:
    key = f"{cfg.seed}|{step}|{row}".encode()
    digest = hashlib.sha256(key).digest()
    return np.random.default_rng(int.from_bytes(digest[:8], "little"))


class SyntheticLM:
    """Zipf-distributed tokens with local repetition structure (so models
    can actually reduce loss on it) — deterministic per (seed, step, row)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rows = []
        base = cfg.host_id * cfg.host_batch
        for r in range(cfg.host_batch):
            rng = _rng_for(cfg, step, base + r)
            n = cfg.seq_len + 1
            toks = rng.zipf(1.3, size=n).astype(np.int64) % (cfg.vocab_size - 2) + 2
            # inject repetition: copy a random span forward
            span = max(4, cfg.seq_len // 16)
            src = int(rng.integers(0, n - 2 * span))
            dst = int(rng.integers(src + span, n - span))
            toks[dst : dst + span] = toks[src : src + span]
            rows.append(toks)
        arr = np.stack(rows).astype(np.int32)
        return {"tokens": arr[:, :-1], "labels": arr[:, 1:]}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


class FileTokens:
    """Token file source: one flat .npy array; batches are deterministic
    strided windows (step, row) -> offset, so any host/step is addressable."""

    def __init__(self, cfg: DataConfig, path: str | Path):
        self.cfg = cfg
        self.tokens = np.load(path, mmap_mode="r")
        assert self.tokens.ndim == 1
        self.n_windows = (len(self.tokens) - 1) // cfg.seq_len

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        idx0 = step * cfg.global_batch + cfg.host_id * cfg.host_batch
        rows = []
        for r in range(cfg.host_batch):
            w = (idx0 + r) % self.n_windows
            off = w * cfg.seq_len
            rows.append(np.asarray(self.tokens[off : off + cfg.seq_len + 1]))
        arr = np.stack(rows).astype(np.int32)
        return {"tokens": arr[:, :-1], "labels": arr[:, 1:]}


class WaveletBandSplit:
    """Pipeline stage: integer DWT band-split of int samples (the paper's
    own application: line-by-line signal decomposition before coding).
    Samples (a numpy array or a tensor) are taken as int32 and moved to
    ``device``; the bands come back as host arrays."""

    def __init__(self, levels: int = 2, mode: str = "paper", scheme: str = "cdf53",
                 device: Any = "cuda"):
        self.levels = levels
        self.mode = mode
        self.scheme = scheme
        self.device = resolve_device(device)

    def __call__(self, samples) -> Dict[str, np.ndarray]:
        x = torch.as_tensor(samples).to(device=self.device, dtype=torch.int32)
        pyr = K.dwt_fwd(
            x,
            levels=self.levels,
            mode=self.mode,
            scheme=self.scheme,
        )
        out = {"approx": pyr.approx.cpu().numpy()}
        for i, d in enumerate(pyr.details):
            out[f"detail_{i}"] = d.cpu().numpy()
        return out


class Prefetcher:
    """Single-slot lookahead prefetcher (thread) around any `.batch(step)`
    source — overlaps host data prep with device compute."""

    def __init__(self, source, start_step: int = 0):
        import queue
        import threading

        self.source = source
        self._q: "queue.Queue" = queue.Queue(maxsize=2)
        self._stop = threading.Event()

        def worker():
            step = start_step
            while not self._stop.is_set():
                try:
                    self._q.put((step, source.batch(step)), timeout=0.5)
                    step += 1
                except Exception:
                    continue

        self._t = threading.Thread(target=worker, daemon=True)
        self._t.start()

    def next(self) -> Tuple[int, Dict[str, np.ndarray]]:
        return self._q.get()

    def close(self) -> None:
        self._stop.set()
