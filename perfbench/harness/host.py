"""The host's side of a measured window."""

from __future__ import annotations

import contextlib
import gc


@contextlib.contextmanager
def collector_held():
    """Python's cycle collector kept out of the window: set-up's objects are
    collected and frozen out of later collections before it opens, and no
    collection runs until it has closed.  A collection's pause grows with
    every object alive, and where it falls in a window is chance."""
    gc.collect()
    gc.freeze()
    gc.disable()
    try:
        yield
    finally:
        gc.enable()
        gc.unfreeze()
