"""The one traffic generator. A traffic mix (``traffic/<name>.json``) is
data: the entry point that makes one report (``entry``, a module of
``entries/``) and that entry's parameters. Reports go in a closed loop
from one caller, the next sent when the last returns (``run.window``).

``prepare`` makes the configuration's data by its column kind
(``columns/<kind>.py``) on the benchmark's device from the seed and
hands it to the entry, which builds the form the caller holds it in and
the report call. The entry names the reference its reports are held to
(``references/<name>.py``), which reads the benchmark's own data in that
form, never what the program made of it."""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass

import torch

from . import spec


class Sections:
    """Named host-clock sections, the interface of the program's
    ``timer=`` argument (``section(name)`` and ``add(name, seconds)``)."""

    def __init__(self):
        self.totals: dict[str, float] = {}

    @contextlib.contextmanager
    def section(self, name: str):
        t = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, time.perf_counter() - t)

    def add(self, name: str, seconds: float) -> None:
        self.totals[name] = self.totals.get(name, 0.0) + seconds


class Probe:
    """What the benchmark's own code records around its calls into the
    program: the section timer it passes as ``timer=`` and host-clock
    spans by name."""

    def __init__(self):
        self.timer = Sections()
        self.spans: dict[str, list[float]] = {}

    def reset(self) -> None:
        self.timer.totals.clear()
        for values in self.spans.values():
            values.clear()


@dataclass
class Setup:
    """What an entry's ``make(data, setup)`` gets besides the data: the
    configuration, the traffic's parameters, the probe, the program's
    ``device=`` (None: its default card), a stack for what the entry
    opens (closed after the reference has run) and the log."""

    config: dict
    traffic: dict
    probe: Probe
    program_device: str | None
    stack: contextlib.ExitStack
    log: object


@dataclass
class Prepared:
    report: object      # makes one report
    held: object        # the data in the form the caller holds it, for the reference
    reference: object   # the reference module
    words: int          # words a report counts


def prepare(setup: Setup, seed: int, device: torch.device, scale_divisor: int = 1) -> Prepared:
    """The cell's data, made from ``seed``, and its report call. When the
    caller holds the data off the card, the card's copy is freed: only
    the program's state stays there."""
    column = setup.config["column"]
    data = spec.module("columns", column["kind"]).make(column, seed, device, scale_divisor)
    words = int(data.shape[0])
    entry = spec.module("entries", setup.traffic["entry"])
    report, held = entry.make(data, setup)
    if held is not data:
        del data
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return Prepared(report, held, spec.module("references", entry.REFERENCE), words)
