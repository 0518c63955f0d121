"""A process's peak resident set, where ``/proc`` does not keep one.

``VmHWM`` in ``/proc/self/status`` is the high-water mark the JAX
package's harnesses read (reset by execve, unlike ``ru_maxrss``, which a
child spawned from a large parent inherits).  Some kernels' ``/proc``
(some container kernels among them) carry no ``VmHWM``; there
``PeakSampler`` reads the current resident set from ``/proc/self/statm``
every millisecond on a thread and keeps the largest, so a transient peak
longer than a sample interval is seen.  Host code: no torch.
"""

from __future__ import annotations

import os
import threading


def vm_hwm_kb() -> int | None:
    """``VmHWM`` of this process in kB, or None where ``/proc`` has none."""
    try:
        with open("/proc/self/status") as fh:
            for line in fh:
                if line.startswith("VmHWM:"):
                    return int(line.split()[1])
    except OSError:
        pass
    return None


def current_rss_kb() -> int:
    """This process's resident set now, in kB (``/proc/self/statm``)."""
    with open("/proc/self/statm") as fh:
        resident_pages = int(fh.read().split()[1])
    return resident_pages * os.sysconf("SC_PAGE_SIZE") // 1024


class PeakSampler:
    """``with PeakSampler() as s: ...`` then ``s.peak_kb()``: ``VmHWM`` where
    the kernel keeps it, else the largest resident set sampled in the
    block (every ``interval_s``, and once at each end)."""

    def __init__(self, interval_s: float = 0.001):
        self.interval_s = interval_s
        self._max_kb = 0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def _sample(self) -> None:
        self._max_kb = max(self._max_kb, current_rss_kb())

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            self._sample()

    def __enter__(self) -> "PeakSampler":
        self._sample()
        if vm_hwm_kb() is None:
            self._thread = threading.Thread(target=self._run, name="rss-sampler", daemon=True)
            self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        self._sample()

    def peak_kb(self) -> int:
        hwm = vm_hwm_kb()
        return hwm if hwm is not None else self._max_kb
