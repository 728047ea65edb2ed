"""Faults planted in the program under a run, to see its check fail.

Each entry (`portbench/entries/<entry>.py`) lists the faults its check
has to catch in `FAULTS` and plants one with `plant(fault, patch)`:

* `unchanged`: a step that returns its state unchanged;
* `half`: half of the batch left out and the mean taken over the rest;
* `answer`: an answer altered where it is produced (times 1.01);
* and any of the entry's own.

A cell on one chip has no exchange between chips to leave out.
"""

from __future__ import annotations

import contextlib

from portbench.lib import traffic


def drop_half(img):
    """`img` [H, W, C] with every other column left out and the rest
    doubled: the same mean over half of the batch."""
    out = img.clone()
    out[:, 0::2] = 0
    out[:, 1::2] = 2 * img[:, 1::2]
    return out


@contextlib.contextmanager
def planted(fault: str, entry: str):
    """The program with `fault` planted for the entry `entry`, for the
    duration of the block."""
    mod = traffic.entry_module(entry)
    if fault not in mod.FAULTS:
        raise ValueError(f"fault {fault!r}: the entry {entry!r} has {mod.FAULTS}")
    saved = []

    def patch(obj, name, new):
        saved.append((obj, name, getattr(obj, name)))
        setattr(obj, name, new)

    try:
        mod.plant(fault, patch)
        yield
    finally:
        for obj, name, old in reversed(saved):
            setattr(obj, name, old)
