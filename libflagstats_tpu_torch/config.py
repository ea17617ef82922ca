"""Live dispatch knobs of the port, read at their point of use
(ops/dispatch.py), so editing CONFIG at run time takes effect on the
next call."""
from __future__ import annotations

from dataclasses import dataclass


@dataclass
class Config:
    #: words from which auto dispatch counts on the CUDA device when one
    #: is present (below it, the host numpy oracle). Not yet measured on
    #: the H100: a placeholder until a crossover sweep on the card
    #: replaces it.
    cuda_min: int = 1 << 20


CONFIG = Config()
