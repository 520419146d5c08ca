"""Host allocator tuning for virtualized bench hosts.

numpy requests large arrays straight through malloc; glibc serves
anything over ~128 KB with a fresh mmap and munmaps it on free.  On
paravirtualized hosts (this bench box included) first-touch page faults
run at single-digit MB/s, so every big temporary re-pays the fault cost
even when the same buffers were just freed — measured here: a 588k-tri
scene commit is 1.4 s of compute and 20-40 s of page faults, and the
SAME commit repeated in-process drops to 1.4 s once the arena is warm.

Raising the mmap/trim thresholds keeps big buffers in the (already
faulted) heap arena so freed pages are reused instead of returned to
the kernel.  No effect on correctness; costs resident memory equal to
the high-water mark of live big arrays.
"""
from __future__ import annotations

import ctypes

_done = False

_M_TRIM_THRESHOLD = -1
_M_MMAP_THRESHOLD = -3


def tune_malloc(threshold_bytes: int = 1 << 30) -> None:
    """Idempotently raise glibc's mmap + trim thresholds (no-op on
    non-glibc platforms)."""
    global _done
    if _done:
        return
    _done = True
    try:
        libc = ctypes.CDLL(None, use_errno=True)
        libc.mallopt(_M_MMAP_THRESHOLD, threshold_bytes)
        libc.mallopt(_M_TRIM_THRESHOLD, threshold_bytes)
    except Exception:
        pass  # an optimization; never fail an entry point


def prefault_async(n_bytes: int = 384 << 20) -> None:
    """Fault in ~n_bytes of heap arena on a background thread.

    Production cold starts overlap the (hypervisor-slow) page faults
    with work that waits off-CPU anyway — scene file IO and the first
    XLA compile.
    Requires tune_malloc() first so the faulted pages stay in the arena
    for the commit's big temporaries to reuse."""
    tune_malloc()
    try:
        import numpy as np
        # allocate on the CALLER's arena: glibc per-thread arenas are
        # built from mmap'd segments and would munmap on free, defeating
        # the point — only the page-touching runs on the thread
        a = np.empty(n_bytes, np.uint8)
    except Exception:
        return

    def _run(buf=a):
        try:
            buf[::4096] = 1        # one write per page faults it
        except Exception:
            pass

    del a
    import threading
    threading.Thread(target=_run, name="yrt-prefault",
                     daemon=True).start()
