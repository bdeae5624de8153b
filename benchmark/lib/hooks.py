"""Ranges the benchmark opens round calls into the program, in traced runs.

A metric reader's `HOOKS` is a list of
`{"range": name, "targets": [[module, attribute], ...], "record": bool}`:
within `installed`, each target function, where the module has it, runs
inside a `torch.profiler.record_function(name)` range, and with `record`
its call arguments are kept as `(args, kwargs)` (the port's
`chip_smoke.recording`), so a reader can count the work from the operands.
A function imported into several modules is wrapped in each.
"""

from __future__ import annotations

import contextlib
import importlib
from typing import Dict, Iterable, List


def _wrap(fn, name: str, keep):
    from torch.profiler import record_function

    def call(*args, **kw):
        if keep is not None:
            keep.append((args, kw))
        with record_function(name):
            return fn(*args, **kw)

    return call


@contextlib.contextmanager
def installed(hooks: Iterable[dict]):
    """Yields {range name: [(args, kwargs), ...]} of the recording hooks."""
    records: Dict[str, List] = {}
    saved = []
    try:
        for h in hooks:
            keep = records.setdefault(h["range"], []) if h.get("record") else None
            for mod_name, attr in h["targets"]:
                mod = importlib.import_module(mod_name)
                fn = getattr(mod, attr, None)
                if fn is None or any(m is mod and a == attr for m, a, _ in saved):
                    continue
                saved.append((mod, attr, fn))
                setattr(mod, attr, _wrap(fn, h["range"], keep))
        yield records
    finally:
        for mod, attr, fn in reversed(saved):
            setattr(mod, attr, fn)
