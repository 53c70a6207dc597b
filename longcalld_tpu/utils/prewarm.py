"""Startup shape pre-warming: parallel compiles of device executables.

The pipeline's device kernels run over a bounded set of bucketed shapes.
Each shape's executable is built once and served from the persistent XLA
cache afterwards, but a cold ``call`` still pays every compile or cache
load serially, interleaved with the pipeline.

This module keeps a tiny journal of every (kernel, shape, statics) combo a
run actually dispatched, and on the next process start replays them as
dummy executions on a background thread pool, overlapping the compiles
with the host-side pipeline stages — the analog of the reference
pre-opening its per-thread I/O handle sets up front
(/root/reference/src/call_var_main.c:637-750): pay the per-resource setup
before the hot loop needs it.

Journal entries are JSON lines {"kind": ..., **params} in the compile-cache
directory (utils/device.cache_dir); warmers are registered by the kernel
modules to avoid import cycles.  Entries whose kind has no registered
warmer (written by an older version) are skipped.  A failed warm is
logged and leaves that shape to compile inline.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Callable, Dict

_seen: set = set()
_lock = threading.Lock()
_warmers: Dict[str, Callable[[dict], None]] = {}
_started = False
_device_backend: bool = None


def _on_device_backend() -> bool:
    """True when the default JAX backend is an accelerator; the CPU test
    mesh neither journals nor replays shapes."""
    global _device_backend
    if _device_backend is None:
        from longcalld_tpu.utils.device import init_device
        init_device()
        import jax
        _device_backend = jax.devices()[0].platform != "cpu"
    return _device_backend


def _journal_path() -> str:
    from longcalld_tpu.utils.device import cache_dir
    return os.path.join(cache_dir(), "shape_journal.jsonl")


def register_warmer(kind: str, fn: Callable[[dict], None]) -> None:
    _warmers[kind] = fn


_journal_read = False


def _ensure_seen() -> None:
    """Load existing journal keys into _seen once, so record() appends a
    shape only when it is genuinely new (prewarm_async also loads them,
    but a run with prewarm disabled must not duplicate every line).
    Double-checked under _lock: concurrent pool workers reach record()
    together on a run's first dispatches."""
    global _journal_read
    if _journal_read:
        return
    with _lock:
        if _journal_read:
            return
        keys = set()
        try:
            with open(_journal_path()) as f:
                for line in f:
                    line = line.strip()
                    if line:
                        keys.add(line)
        except OSError:
            pass
        _seen.update(keys)
        _journal_read = True


def record(kind: str, **params) -> None:
    """Note that a (kind, params) shape was dispatched this run."""
    if not _on_device_backend():
        return
    _ensure_seen()
    entry = {"kind": kind, **params}
    key = json.dumps(entry, sort_keys=True)
    with _lock:
        if key in _seen:
            return
        _seen.add(key)
    try:
        path = _journal_path()
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "a") as f:
            f.write(key + "\n")
    except OSError:
        pass


def _load_journal() -> list:
    entries, keys = [], set()
    try:
        with open(_journal_path()) as f:
            for line in f:
                line = line.strip()
                if line and line not in keys:
                    keys.add(line)
                    entries.append(json.loads(line))
    except (OSError, ValueError):
        return []
    with _lock:
        _seen.update(keys)
    return entries


def prewarm_async(n_threads: int = 8) -> None:
    """Replay the journal on background threads (once per process).
    No-op on CPU backends (tests) and under LONGCALLD_NO_PREWARM=1."""
    global _started
    if _started or os.environ.get("LONGCALLD_NO_PREWARM"):
        return
    _started = True
    if not _on_device_backend():
        return
    entries = [e for e in _load_journal() if e.get("kind") in _warmers]
    if not entries:
        return

    import queue

    from longcalld_tpu.utils import log
    q: "queue.Queue" = queue.Queue()
    for e in entries:
        q.put(e)

    def work():
        while True:
            try:
                entry = q.get_nowait()
            except queue.Empty:
                return
            try:
                _warmers[entry["kind"]](entry)
            except Exception as e:  # noqa: BLE001 — compiles inline later
                log.warning("prewarm", f"warming {entry} failed: "
                            f"{type(e).__name__}: {e}")

    # daemon threads: a warm-up still compiling must never block exit
    for _ in range(min(n_threads, len(entries))):
        threading.Thread(target=work, daemon=True, name="prewarm").start()
