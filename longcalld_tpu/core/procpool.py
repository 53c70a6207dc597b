"""Persistent subprocess worker pool for window-range parallelism.

The kt_for analog that actually scales the interpreted host stages: CPython's
GIL serializes them across threads, so run_call hands many-window streams to
worker PROCESSES (core/procworker.py).  Purpose-built instead of
multiprocessing because (a) fork from a process holding a live device client
is unsafe, and (b) spawn/forkserver re-import ``__main__`` in the worker, which
breaks under embedded/REPL parents.  Workers here are plain ``python -m``
subprocesses talking pickles over pipes — no fork, no __main__ re-execution.

Two worker flavors (the reference analog is per-thread handle sets,
/root/reference/src/call_var_main.c:637-750):

* host-only (default): JAX_PLATFORMS=cpu in the worker env as a hard
  device-isolation guarantee.
* per-worker device (``worker_env_fn``): worker k launches with an
  env override set that assigns it its OWN card (e.g.
  ``CUDA_VISIBLE_DEVICES=k`` on a multi-card host): N processes scale the
  host stages past the GIL AND drive N devices, one process per card.
  Pools are keyed by the env signature so the two flavors never share
  workers.

Workers persist across runs (module-level pools), so repeated run_call
invocations in one process pay the worker-import cost once.
"""

from __future__ import annotations

import atexit
import itertools
import os
import pickle
import subprocess
import sys
import threading
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

_CTX_IDS = itertools.count(1)


class _Worker:
    def __init__(self, idx: int = 0,
                 env_overrides: Optional[dict] = None) -> None:
        env = dict(os.environ)
        if env_overrides is None:
            env["JAX_PLATFORMS"] = "cpu"   # host-only by contract
        else:
            for k, v in env_overrides.items():
                if v is None:
                    env.pop(k, None)
                else:
                    env[k] = str(v)
        # the worker imports this package from where the parent did, even
        # when it is not installed and the working directory is elsewhere
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env["PYTHONPATH"] = os.pathsep.join(
            [root] + [p for p in [env.get("PYTHONPATH")] if p])
        self.idx = idx
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "longcalld_tpu.core.procworker"],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, env=env)
        self.ctx_id = -1
        self._send(("warm",))          # import the package in parallel

    def _send(self, msg) -> None:
        pickle.dump(msg, self.proc.stdin, protocol=pickle.HIGHEST_PROTOCOL)
        self.proc.stdin.flush()

    def run(self, ctx_id: int, ctx_msg, first_k: int, count: int):
        if self.ctx_id != ctx_id:
            self._send(ctx_msg)
            self.ctx_id = ctx_id
        self._send(("run", ctx_id, first_k, count))
        res = pickle.load(self.proc.stdout)
        if res[0] == "err":
            raise RuntimeError(f"range worker failed:\n{res[1]}")
        return res[1]

    def alive(self) -> bool:
        return self.proc.poll() is None

    def stop(self) -> None:
        try:
            if self.alive():
                self._send(("exit",))
                self.proc.wait(timeout=5)
        except Exception:
            self.proc.kill()
        for f in (self.proc.stdin, self.proc.stdout):
            try:
                f.close()
            except Exception:
                pass


# pools keyed by the worker-env signature: host-only workers and
# device-owning workers must never be interchanged
_POOLS: Dict[tuple, List[_Worker]] = {}
_LOCK = threading.Lock()


def _get_workers(n: int, worker_env_fn: Optional[Callable[[int, int],
                                                          dict]] = None
                 ) -> List[_Worker]:
    if worker_env_fn is None:
        key: tuple = ("host",)
        env_of = None
    else:
        envs = [worker_env_fn(k, n) for k in range(n)]
        key = ("dev",) + tuple(tuple(sorted(e.items())) for e in envs)
        env_of = envs
    with _LOCK:
        pool = _POOLS.setdefault(key, [])
        pool[:] = [w for w in pool if w.alive()]
        while len(pool) < n:
            k = len(pool)
            pool.append(_Worker(
                idx=k, env_overrides=None if env_of is None else env_of[k]))
        return pool[:n]


def shutdown() -> None:
    with _LOCK:
        for pool in _POOLS.values():
            for w in pool:
                w.stop()
        _POOLS.clear()


atexit.register(shutdown)


def imap_ranges(opt, wins, ranges: Sequence[Tuple[int, int]],
                n_workers: int,
                worker_env_fn: Optional[Callable[[int, int], dict]] = None,
                range_worker_out: Optional[Dict[int, int]] = None,
                order: Optional[Sequence[int]] = None,
                max_backlog: int = 0) -> Iterator[list]:
    """Run each (first_k, count) window range on a pool worker; yield the
    per-range result lists strictly in ``ranges`` order while later ranges
    keep executing (the ordered hand-off of kt_pipeline,
    /root/reference/src/kthread.c:195-226).

    ``worker_env_fn(k, n)`` -> env-override dict switches the pool to
    per-worker-device mode (see module docstring).  ``range_worker_out``,
    when given, is filled with range-index -> worker-index so the caller
    can attribute each range's counter deltas to the worker (and hence
    the card) that produced them.  ``order``, when given, is the EXECUTION
    priority (a permutation of range indices, e.g. heaviest-first for LPT
    scheduling); the yield order is unchanged.

    Backpressure: when the serial consumer falls behind the pool, the
    completed-but-unyielded backlog is BOUNDED at ``max_backlog`` ranges
    (default 2*workers+2) — a parked worker resumes as soon as the
    consumer drains below the cap.  Deadlock-free: the range the consumer
    needs next is always runnable — if it is still queued, a worker takes
    it (smallest-index fallback) regardless of the cap; if it is in
    flight or completed, the consumer is already unblockable.  Without
    the cap a 4-worker whole-genome run buffered the entire output in
    the parent (measured ~7 GB at 100 Mb)."""
    workers = _get_workers(n_workers, worker_env_fn)
    ctx_id = next(_CTX_IDS)
    ctx_msg = ("ctx", ctx_id, opt, wins)
    cap = max_backlog or (2 * n_workers + 2)
    pending: List[int] = list(order if order is not None
                              else range(len(ranges)))
    results: dict = {}
    state = {"yield_ptr": 0, "stop": False}
    cond = threading.Condition()

    def _take_task() -> Optional[tuple]:
        """Next range for a worker under the backlog cap; None = done."""
        with cond:
            while True:
                if state["stop"] or not pending:
                    return None
                backlog = len(results)
                if backlog < cap:
                    i = pending.pop(0)
                    return i, ranges[i]
                need = state["yield_ptr"]
                if need in pending:
                    # the consumer's next range is still queued: run it
                    # now so parking can never deadlock the stream
                    pending.remove(need)
                    return need, ranges[need]
                cond.wait(timeout=0.2)

    def drive(w: _Worker) -> None:
        while True:
            task = _take_task()
            if task is None:
                return
            idx, (first_k, count) = task
            try:
                out = ("ok", w.run(ctx_id, ctx_msg, first_k, count))
            except BaseException as e:     # noqa: BLE001 — relayed to consumer
                out = ("raise", e)
            with cond:
                results[idx] = out
                if range_worker_out is not None:
                    range_worker_out[idx] = w.idx
                cond.notify_all()
            if out[0] == "raise":
                return

    threads = [threading.Thread(target=drive, args=(w,), daemon=True)
               for w in workers]
    for t in threads:
        t.start()
    try:
        for i in range(len(ranges)):
            with cond:
                state["yield_ptr"] = i
                cond.notify_all()
                while i not in results:
                    if not any(t.is_alive() for t in threads):
                        raise RuntimeError(
                            f"all range workers exited before producing "
                            f"range {i}/{len(ranges)}")
                    cond.wait(timeout=0.5)
                status, payload = results.pop(i)
                cond.notify_all()          # backlog shrank: unpark workers
            if status == "raise":
                raise payload
            yield payload
    finally:
        # on early exit, stop handing out new tasks AND wait for in-flight
        # ranges to finish on their workers before returning: a consumer
        # that raises mid-stream (checkpoint kill, write error) would
        # otherwise leave drive threads blocked in pickle.load on worker
        # stdouts while the NEXT run reuses the same pool — two threads
        # reading one pipe desynchronizes the pickle stream
        with cond:
            state["stop"] = True
            pending.clear()
            cond.notify_all()
        for t in threads:
            t.join()
