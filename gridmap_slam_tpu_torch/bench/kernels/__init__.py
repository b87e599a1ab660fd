"""The kernels the benchmark measures, one module each in this package.

Each module declares `KERNEL`, a `Kernel`: its name (the group its
launches count in), a pattern of its function names (mangled, as a graph
node holds them, or demangled, as the profiler reports them), its entry
points in ops/cuda, each with its bound function, and its agreement with
its plain version (the share of its output beyond the tolerance, and the
most that may be).  `load()` finds every module here, so a kernel is added
by adding a module.  The bound functions are the benchmark's own counts,
never the kernels' code; chip_smoke.py uses them too.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import inspect
import pkgutil
import re
from typing import Callable, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class Entry:
    """An entry point `ops/cuda/<module>.<name>_cuda` (the kernel) beside
    `<name>_plain` (its plain version); bound(args, kw) -> (ms, "operations"
    or "bytes") on the entry's arguments.  Where `parts` is given, parts(
    args) -> [(first row, rows, the arguments of those rows alone)] of the
    output held against the plain version, each part's plain version run
    on its own arguments (a call too large for its plain version); else
    the whole call."""
    module: str
    name: str
    bound: Callable
    parts: Optional[Callable] = None

    def ops(self):
        return importlib.import_module(
            f"gridmap_slam_tpu_torch.ops.cuda.{self.module}")


@dataclasses.dataclass(frozen=True)
class Kernel:
    name: str
    pattern: re.Pattern
    entries: Tuple[Entry, ...]
    agreement: Callable     # (out, plain's out, kw) -> (share, limit)


def load() -> dict:
    """Every kernel declared in this package, by name."""
    out = {}
    for info in pkgutil.iter_modules(__path__):
        mod = importlib.import_module(f"{__name__}.{info.name}")
        out[mod.KERNEL.name] = mod.KERNEL
    return out


def kernel_of(kernels: dict, name: str) -> Optional[str]:
    """The kernel a function name belongs to, or None."""
    return next((k for k, kern in kernels.items()
                 if kern.pattern.search(name)), None)


def _plain_kw(plain: Callable, kw: dict) -> dict:
    """The keywords of an entry point's call that its plain version takes
    (not `out=`, which the plain version of K2 lacks, nor a path counter)."""
    params = inspect.signature(plain).parameters
    return {k: v for k, v in kw.items() if k in params and k != "out"}


@contextlib.contextmanager
def patched(kernels, wrap: Callable, suffix: str = "cuda"):
    """Every entry's `<name>_<suffix>` replaced, while the context lasts, by
    wrap(kernel name, entry, the function it replaces)."""
    saved = []
    try:
        for kern in kernels:
            for entry in kern.entries:
                mod, attr = entry.ops(), f"{entry.name}_{suffix}"
                real = getattr(mod, attr)
                saved.append((mod, attr, real))
                setattr(mod, attr, wrap(kern.name, entry, real))
        yield
    finally:
        for mod, attr, real in reversed(saved):
            setattr(mod, attr, real)


class Agreement:
    """Each call of a kernel against its plain version on the same
    arguments, or on the parts its entry names (the plain version run
    first: K2 may update its input in place).  Made before anything is
    patched, it keeps the plain versions as they are; wrap() is `patched`'s
    wrap.  `rows` holds, for each kernel called, its calls, the worst share
    of an output beyond the tolerance, the largest absolute error, and
    whether every call kept its limit."""

    def __init__(self, kernels: dict):
        self.kernels = kernels
        self.plain = {(k.name, e.name): getattr(e.ops(), f"{e.name}_plain")
                      for k in kernels.values() for e in k.entries}
        self.rows = {}

    def wrap(self, kernel, entry, real):
        plain = self.plain[(kernel, entry.name)]
        agreement = self.kernels[kernel].agreement

        def call(*args, **kw):
            pkw = _plain_kw(plain, kw)
            parts = entry.parts(args) if entry.parts else None
            if parts is None:
                ref = plain(*args, **pkw)
            else:
                ref = torch.cat([plain(*sub, **pkw) for _, _, sub in parts])
            out = real(*args, **kw)
            got = out if parts is None else torch.cat(
                [out[a:a + n] for a, n, _ in parts])
            share, limit = agreement(got, ref, kw)
            err = float((got - ref).abs().max()) if got.numel() else 0.0
            row = self.rows.setdefault(kernel, dict(
                calls=0, share=0.0, max_abs_err=0.0, ok=True))
            row["calls"] += 1
            row["share"] = max(row["share"], share)
            row["max_abs_err"] = max(row["max_abs_err"], err)
            row["ok"] = row["ok"] and share <= limit
            return out
        return call
