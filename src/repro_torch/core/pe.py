"""Register-transfer-level model of the paper's processing element (Fig. 2)
and of the analysis / reconstruction module schedules (Fig. 3 / Fig. 4).

The paper's "new basic structure" is:

    two programmable delays (D^m, D^n)  +  three registers (R)  +  one adder

Samples stream in serially (one per clock); the module state chart steers
the delays/registers so that the predict and update lifting steps are
evaluated with adds and shifts only.  This module is a *hardware model*,
not tensor code (pure Python on ints, a copy of ``repro.core.pe``): it
exists to (a) document the architecture faithfully and (b) be asserted
bit-exact against `core.lifting`, and it keeps an operation ledger so the
Table 1/2 hardware counts can be cross-checked.

Division semantics: an arithmetic right shift of a two's-complement value
is floor division — this IS the paper's "if the sum is negative ... one bit
correction" mechanism, stated in shift form.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Deque, List, Sequence, Tuple


def _floor_shift(value: int, bits: int) -> int:
    """Arithmetic right shift on a Python int == floor(value / 2**bits)."""
    return value >> bits


@dataclass
class OpLedger:
    """Counts of hardware-level events, for Table 1/2 cross-checks."""

    adds: int = 0  # adder activations (add or subtract)
    shifts: int = 0  # barrel/wired shifts
    register_writes: int = 0
    cycles: int = 0

    def as_dict(self) -> dict:
        return {
            "adds": self.adds,
            "shifts": self.shifts,
            "register_writes": self.register_writes,
            "cycles": self.cycles,
        }


@dataclass
class ProcessingElement:
    """Fig. 2: two programmable delays D^m / D^n, three registers, one adder.

    ``step(a, b)`` models one adder activation (the single shared adder);
    the delays are modelled as FIFOs of programmable depth.
    """

    delay_m: int
    delay_n: int
    ledger: OpLedger = field(default_factory=OpLedger)

    def __post_init__(self) -> None:
        self._dm: Deque[int] = deque([0] * self.delay_m, maxlen=max(self.delay_m, 1))
        self._dn: Deque[int] = deque([0] * self.delay_n, maxlen=max(self.delay_n, 1))
        # the three registers of the basic structure
        self.r0 = 0
        self.r1 = 0
        self.r2 = 0

    # -- primitive hardware actions ----------------------------------------
    def add(self, a: int, b: int) -> int:
        self.ledger.adds += 1
        return a + b

    def sub(self, a: int, b: int) -> int:
        # two's-complement subtract uses the same adder
        self.ledger.adds += 1
        return a - b

    def shift(self, a: int, bits: int) -> int:
        self.ledger.shifts += 1
        return _floor_shift(a, bits)

    def write(self, name: str, value: int) -> int:
        setattr(self, name, value)
        self.ledger.register_writes += 1
        return value

    def push_m(self, v: int) -> int:
        if self.delay_m == 0:
            return v
        out = self._dm[0]
        self._dm.append(v)
        return out

    def push_n(self, v: int) -> int:
        if self.delay_n == 0:
            return v
        out = self._dn[0]
        self._dn.append(v)
        return out


class AnalysisModule:
    """Fig. 3: forward integer DWT module built from the basic structure.

    Streaming schedule (one input sample per cycle, two cycles per output
    pair).  For output index n:

      cycle 2n   : latch even sample  x[2n]            (register R0)
      cycle 2n+1 : latch odd  sample  x[2n+1]          (register R1)
      cycle 2n+2 : t  = (R0 + x[2n+2]) >> 1            (adder + shift)
                   d  = R1 - t                          (adder, 2's compl.)
                   u  = (d + R2) >> 2                   (adder + shift; R2
                                                         holds d[n-1])
                   s  = R0 + u                          (adder)
                   R2 <- d ; R0 <- x[2n+2]
      per output pair: 4 adder activations + 2 shifts   == paper Table 2.

    Boundary policy matches `core.lifting` (symmetric extension; d[-1] is
    primed with d[0], which hardware realises by a one-pair pipeline
    warm-up pass — the paper's "state chart").
    """

    def __init__(self, mode: str = "paper") -> None:
        if mode not in ("paper", "jpeg2000"):
            raise ValueError(mode)
        self.mode = mode
        self.pe = ProcessingElement(delay_m=1, delay_n=2)

    def _pair(self, x_even: int, x_odd: int, x_even_next: int, d_prev: int) -> Tuple[int, int]:
        pe = self.pe
        t = pe.shift(pe.add(x_even, x_even_next), 1)
        d = pe.sub(x_odd, t)
        acc = pe.add(d, d_prev)
        if self.mode == "jpeg2000":
            acc += 2  # wired constant, no adder activation counted
        u = pe.shift(acc, 2)
        s = pe.add(x_even, u)
        return s, d

    def process(self, samples: Sequence[int]) -> Tuple[List[int], List[int]]:
        """Transform a finite frame; returns (s, d) streams."""
        x = [int(v) for v in samples]
        n = len(x)
        if n < 2:
            raise ValueError("need at least 2 samples")
        even = x[0::2]
        odd = x[1::2]
        n_o = len(odd)
        pe = self.pe
        # predict pass (serial, as the samples arrive)
        d: List[int] = []
        for i in range(n_o):
            e_next = even[i + 1] if i + 1 < len(even) else even[-1]
            t = pe.shift(pe.add(even[i], e_next), 1)
            d.append(pe.sub(odd[i], t))
            pe.ledger.cycles += 2
        # update pass (interleaved in hardware; serialized here for clarity —
        # the adder activations/cycle counts are what the ledger tracks)
        s: List[int] = []
        for i in range(len(even)):
            d_cur = d[i] if i < n_o else d[-1]
            d_prev = d[i - 1] if i >= 1 else d[0]
            acc = pe.add(d_cur, d_prev)
            if self.mode == "jpeg2000":
                acc += 2
            u = pe.shift(acc, 2)
            s.append(pe.add(even[i], u))
        return s, d


class ReconstructionModule:
    """Fig. 4: backward integer DWT module (inverse update then predict).

    Same basic structure; the paper notes forward and backward have the
    same computational complexity — the ledger proves it.
    """

    def __init__(self, mode: str = "paper") -> None:
        if mode not in ("paper", "jpeg2000"):
            raise ValueError(mode)
        self.mode = mode
        self.pe = ProcessingElement(delay_m=1, delay_n=2)

    def process(self, s: Sequence[int], d: Sequence[int]) -> List[int]:
        s = [int(v) for v in s]
        d = [int(v) for v in d]
        n_e, n_o = len(s), len(d)
        if n_e - n_o not in (0, 1):
            raise ValueError("band length mismatch")
        pe = self.pe
        even: List[int] = []
        for i in range(n_e):
            d_cur = d[i] if i < n_o else d[-1]
            d_prev = d[i - 1] if i >= 1 else d[0]
            acc = pe.add(d_cur, d_prev)
            if self.mode == "jpeg2000":
                acc += 2
            u = pe.shift(acc, 2)
            even.append(pe.sub(s[i], u))  # eq. (8)
            pe.ledger.cycles += 2
        odd: List[int] = []
        for i in range(n_o):
            e_next = even[i + 1] if i + 1 < n_e else even[-1]
            t = pe.shift(pe.add(even[i], e_next), 1)
            odd.append(pe.add(d[i], t))  # eq. (9)
        out: List[int] = []
        for i in range(n_e + n_o):  # eq. (10) Merge
            out.append(even[i // 2] if i % 2 == 0 else odd[i // 2])
        return out
