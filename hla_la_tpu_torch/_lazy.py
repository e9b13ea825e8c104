"""``torch``, imported on first use.

``import torch`` takes seconds on a card host (``bench_workers.py
--imports``; PERF.md §6), far more than the port's host layers.  The
host-only worker processes of ``--maxThreads`` (``models/parallel_host.py``)
run numpy and the native library alone and send their device calls to the
parent, so the modules they import name ``torch`` through this object,
which imports it when an attribute is first read: in the parent, at its
first tensor; in a worker, never.
"""

from __future__ import annotations


class _Torch:
    def __getattr__(self, name: str):
        import torch
        return getattr(torch, name)

    def __repr__(self) -> str:
        return "<torch, imported on first use>"


torch = _Torch()
