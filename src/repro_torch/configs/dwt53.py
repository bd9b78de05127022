"""The paper's own 'architecture': the integer lifting DWT module
configs (signal lengths / dtypes from the paper's tests).

The port's copy of ``repro.configs.dwt53``: the same names and values,
kept here so the port imports nothing of the reference.  ``scheme``
names a lifting scheme from the registry
(``repro_torch.core.schemes.available_schemes()``); the paper's worked
example is ``cdf53`` and stays the default everywhere."""
from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class DWTConfig:
    name: str
    signal_len: int
    batch: int
    dtype: str
    levels: int
    mode: str = "paper"
    scheme: str = "cdf53"


# Fig.5: 64 samples, 8-bit positive, normal distribution
FIG5 = DWTConfig("fig5", 64, 1, "int16", 1)
# Table 3: line of 256 samples, 8-bit accuracy
TABLE3 = DWTConfig("table3", 256, 1, "int16", 1)
# throughput-scale config: 64 lines of 65,536 int32 samples, 4 levels
LARGE = DWTConfig("large", 65536, 64, "int32", 4)
# filter-bank variants: same large workload through the other schemes
LARGE_HAAR = DWTConfig("large_haar", 65536, 64, "int32", 4, scheme="haar")
LARGE_97M = DWTConfig("large_97m", 65536, 64, "int32", 4, scheme="97m")

ALL: Tuple[DWTConfig, ...] = (FIG5, TABLE3, LARGE, LARGE_HAAR, LARGE_97M)
