"""Worker-process main for the window-range pool (core/procpool.py).

Runs as ``python -m longcalld_tpu.core.procworker`` with a pickle
request/response protocol over the stdin/stdout pipes.  Each worker is the
share-nothing analog of one kt_for thread
(/root/reference/src/kthread.c:24-65): it owns its file-handle set and
processes contiguous window ranges: host-only by default (the pool
launches workers with JAX_PLATFORMS=cpu as a hard guarantee that no
worker opens a device), or each owning one card with procs_use_device.

Protocol (one pickled tuple per message):
  ("warm",)                     -> no reply; pre-imports the package so the
                                   first range doesn't pay import latency
  ("ctx", cid, opt, wins)       -> no reply; installs the shared per-run
                                   context (options + full window plan)
  ("run", cid, first_k, count)  -> ("ok", per-window results) or
                                   ("err", traceback string)
  ("exit",)                     -> worker exits
"""

from __future__ import annotations

import os
import pickle
import sys
import traceback


def main() -> None:
    # Claim the protocol channel, then point fd 1 at stderr so any stray
    # print from library code cannot corrupt the pickle stream.
    proto_fd = os.dup(1)
    os.dup2(2, 1)
    sys.stdout = sys.stderr
    inp = os.fdopen(0, "rb")
    outp = os.fdopen(proto_fd, "wb")

    ctxs: dict = {}
    while True:
        try:
            msg = pickle.load(inp)
        except EOFError:
            return
        kind = msg[0]
        if kind == "warm":
            try:
                import longcalld_tpu.core.pipeline  # noqa: F401
            except Exception:
                pass
            continue
        if kind == "ctx":
            _, cid, opt, wins = msg
            ctxs.clear()           # one live run per worker
            ctxs[cid] = (opt, wins)
            continue
        if kind == "run":
            _, cid, first_k, count = msg
            try:
                from longcalld_tpu.core.pipeline import _range_worker
                opt, wins = ctxs[cid]
                res = ("ok", _range_worker((opt, wins, first_k, count)))
            except BaseException:
                res = ("err", traceback.format_exc())
            pickle.dump(res, outp, protocol=pickle.HIGHEST_PROTOCOL)
            outp.flush()
            continue
        if kind == "exit":
            return


if __name__ == "__main__":
    main()
