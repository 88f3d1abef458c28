"""The traffic drivers, one file per ``kind`` of traffic file, found by
name: ``drivers/<kind>.py`` (files whose names start with ``_`` hold code
that drivers share, and are no kind).

A kind's file holds a class ``Driver(run, seed, device, torch)`` with
``setup()``, ``window(seconds, t0) -> t1``, ``end_to_end(t0) -> dict``,
``attempted() -> int``, ``release()``, ``judge(limits) -> (numbers,
failed)`` and ``control() -> numbers`` (the numbers of the reference in
float8 put in the program's place), and ``FAULTS``: name → a function
that returns the context manager planting that fault in the program.

Every driver builds the program from the configuration, fills it with the
seed's weights (:mod:`portbench.weights`), warms up the shapes its traffic
uses, runs the window, and then, with the program's state freed, hands
the numbers that decide ``correct`` (:mod:`portbench.check`).  It records
in ``run.counters["model_flops"]`` the model FLOPs of the window's work
by the frozen count of the configuration's family.  The program's modules
are reached through their module objects, so a fault can put a broken
function in the program's place.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
from pathlib import Path

import numpy as np

from portbench import weights
from portbench.devtrace import Spans

HERE = Path(__file__).resolve().parent

# keys of a configuration's ``model`` that are no field of the program's
# ModelConfig
NOT_PROGRAM_FIELDS = ("vocab_pad",)


def load(kind: str):
    """The module ``drivers/<kind>.py``."""
    if kind.startswith("_") or not (HERE / f"{kind}.py").is_file():
        raise KeyError(f"no driver file portbench/drivers/{kind}.py")
    return importlib.import_module(f"portbench.drivers.{kind}")


def kinds() -> list[str]:
    """Every kind that has a driver file."""
    return sorted(p.stem for p in HERE.glob("*.py")
                  if not p.stem.startswith("_"))


@dataclasses.dataclass
class Run:
    """What a run hands the per-layer readers: the cell, its configuration
    and traffic, the host spans, the driver's counters, the window [t0, t1]
    on the host clock and, with ``--trace 1``, the device trace."""

    cell: str
    config: dict
    traffic: dict
    spans: Spans
    counters: dict
    window: tuple = (0.0, 0.0)
    trace: object = None

    @property
    def model(self) -> dict:
        return self.config["model"]

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]


def program_config(config: dict, **kw):
    """The program's ModelConfig: its registry entry with every size of the
    configuration file's ``model`` set, and ``kw``."""
    from repro_torch.configs.registry import get_config
    fields = {k: v for k, v in config["model"].items()
              if k not in NOT_PROGRAM_FIELDS}
    cfg = get_config(config["registry"]).replace(**fields, **kw)
    if cfg.vocab_padded != weights.padded_vocab(config["model"]):
        raise ValueError(f"{config['name']}: the program pads the "
                         f"vocabulary to {cfg.vocab_padded}")
    return cfg


def synchronize(torch, device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def seeded(seed: int, *path: int) -> np.random.Generator:
    return np.random.default_rng([seed & ((1 << 63) - 1), *path])


def make_records(rng: np.random.Generator, n: int, seq: int, vocab: int,
                 dropout: float) -> np.ndarray:
    """(n, seq) float token rows, a ``dropout`` share of them all −1
    (a sensor that sent nothing), as the example's job makes them."""
    rows = rng.integers(0, vocab, (n, seq)).astype(float)
    rows[rng.random(n) < dropout] = -1
    return rows


@contextlib.contextmanager
def swapped(module, name: str, fn):
    """``module.name`` replaced by ``fn(module.name)`` inside the block."""
    saved = getattr(module, name)
    setattr(module, name, fn(saved))
    try:
        yield
    finally:
        setattr(module, name, saved)
