"""Procs x devices: each pool worker process owns its own accelerator.

The round-3 review's top gap: the scalable kt_for analog (subprocess pool)
was host-only by contract, while the device path was single-process — on a
real multi-chip host the production shape (N worker processes, each driving
one chip) did not exist.  These tests pin that shape: workers launch with
per-worker device env (CallOpts.worker_device_env), run the banded device
aligner inside the worker (use_device=True survives into the pool), and the
parent's audit counters attribute alignment DP cells to the worker (= chip)
that ran them.  VCF byte-equality vs the sequential host path is asserted
throughout.  Reference analog: per-thread handle sets,
/root/reference/src/call_var_main.c:637-750.
"""

import io

from longcalld_tpu.config import CallOpts
from longcalld_tpu.core.pipeline import run_call
from longcalld_tpu.utils import counters


def _body(vcf: str):
    return [l for l in vcf.splitlines() if not l.startswith("##")]


def _call(opt) -> str:
    out = io.StringIO()
    run_call(opt, out, "procs-device-test")
    return out.getvalue()


# the CPU test stand-in for "worker k owns card k": every worker pins the
# CPU platform (so this test runs hermetically without N cards) but keeps
# use_device=True, which drives the same banded device-aligner code path
# the GPU takes.  On a multi-GPU host the default template
# CUDA_VISIBLE_DEVICES={k} gives each worker its own card.
_CPU_DEV_ENV = "JAX_PLATFORMS=cpu"


def test_procs_device_workers_match_and_dispatch(chr11_fa, hifi_bam):
    base = dict(ref_fa_fn=chr11_fa, in_bam_fns=[hifi_bam],
                window_size=50_000)
    seq = _call(CallOpts.hifi(n_threads=1, host_procs=0, use_device=False,
                              **base))

    counters.reset()
    par = _call(CallOpts.hifi(
        n_threads=4, host_procs=4, use_device=True,
        procs_use_device=True, worker_device_env=_CPU_DEV_ENV,
        device_min_cells=1, **base))
    assert _body(seq) == _body(par)
    assert len(_body(seq)) > 100

    snap = counters.snapshot()
    # the workers (not the parent) ran real device-path alignment work...
    assert snap.get("aln_cells_device", 0) > 0
    # ...and the per-worker attribution names more than one worker, i.e.
    # the range stream actually spread over the pool (= over the chips)
    per_worker = {k: v for k, v in snap.items()
                  if k.startswith("aln_cells_device_w") and v > 0}
    assert len(per_worker) >= 2, per_worker


def test_procs_device_pool_isolated_from_host_pool(chr11_fa, hifi_bam):
    """Host-only and device-owning pools must never share workers: a
    host-contract worker has JAX_PLATFORMS=cpu pinned forever, so handing
    it a device-mode range would silently run host-only."""
    from longcalld_tpu.core import procpool

    base = dict(ref_fa_fn=chr11_fa, in_bam_fns=[hifi_bam],
                window_size=50_000)
    counters.reset()
    host = _call(CallOpts.hifi(n_threads=2, host_procs=2, use_device=False,
                               **base))
    assert counters.snapshot().get("aln_cells_device", 0) == 0

    counters.reset()
    dev = _call(CallOpts.hifi(
        n_threads=2, host_procs=2, use_device=True, procs_use_device=True,
        worker_device_env=_CPU_DEV_ENV, device_min_cells=1, **base))
    assert counters.snapshot().get("aln_cells_device", 0) > 0
    assert _body(host) == _body(dev)

    with procpool._LOCK:
        kinds = {key[0] for key in procpool._POOLS}
    assert kinds == {"host", "dev"}


def test_worker_env_template_expansion():
    from longcalld_tpu.core.pipeline import _worker_env_fn

    class O:
        worker_device_env = "CUDA_VISIBLE_DEVICES={k}; POOL_SIZE={n}"

    fn = _worker_env_fn(O())
    assert fn(0, 4) == {"CUDA_VISIBLE_DEVICES": "0", "POOL_SIZE": "4"}
    assert fn(3, 4) == {"CUDA_VISIBLE_DEVICES": "3", "POOL_SIZE": "4"}
    assert CallOpts().worker_device_env == "CUDA_VISIBLE_DEVICES={k}"


def test_more_device_workers_than_cards_refused(monkeypatch):
    import pytest

    from longcalld_tpu.core import pipeline

    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0,1")
    opt = CallOpts.hifi(procs_use_device=True)
    pipeline._check_device_workers(opt, 2)          # one per card: fine
    with pytest.raises(ValueError, match="one process per card"):
        pipeline._check_device_workers(opt, 4)
    # CPU stand-in workers own no card and are not limited
    cpu_opt = CallOpts.hifi(procs_use_device=True,
                            worker_device_env=_CPU_DEV_ENV)
    pipeline._check_device_workers(cpu_opt, 8)
