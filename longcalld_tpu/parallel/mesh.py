"""Multi-device execution: the production phasing kernel over a device mesh.

The reference's parallelism is a work-stealing parallel-for over ~500 kb
genomic windows plus a 3-stage pipeline (SURVEY.md section 2.4; kt_for /
kt_pipeline, /root/reference/src/kthread.c).  The device mapping has two
axes:

* **Window data-parallelism** (the kt_for analog): independent windows
  batched on the leading axis and sharded over ``dp`` —
  ``sharded_window_phase`` vmaps the real fixpoint kernel
  (ops/phase_kernel) over windows and shard_maps the batch across the
  mesh.  Per-window phased-read counters ride a psum, the analog of
  gathering per-window stats for the host stitch reducer.
* **Read model-parallelism** within one window:
  ``ops.phase_kernel.sharded_phase_fixpoint`` shards the READS axis of a
  single window's fixpoint EM over the mesh with psum'd cross-read
  reductions.  ``CallOpts.mesh_devices > 1`` routes the production
  pipeline's phasing through it (tests/test_multichip.py asserts the VCF
  is unchanged vs the single-device run).

There is no tensor-parallel analog beyond these — a window's tensors fit
comfortably in one card's memory — so the mesh is 1-D.  The cards are
joined all to all by NVLink, so the mesh follows the algorithm alone.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from longcalld_tpu.ops.phase_kernel import PhaseKernelOut, _phase_fixpoint


def make_mesh(n_devices: int | None = None) -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        if len(devs) < n_devices:
            raise RuntimeError(
                f"make_mesh({n_devices}): only {len(devs)} devices visible "
                f"on backend {jax.default_backend()!r} — a silently smaller "
                f"mesh would fake-validate sharding (force the cpu platform "
                f"with xla_force_host_platform_device_count for dry runs)")
        devs = devs[:n_devices]
    return Mesh(np.array(devs), axis_names=("dp",))


def window_phase_batch(batch, max_iter: int = 10):
    """vmap of the production fixpoint kernel over a batch of windows
    (leading axis on every input; the host bridge's padded layout)."""
    return jax.vmap(
        lambda a, s, e, c, h, sc, w, cs, v, hh, ho: _phase_fixpoint(
            a, s, e, c, h, sc, w, cs, v, hh, ho, max_iter=max_iter))(*batch)


def sharded_window_phase(mesh: Mesh, batch, max_iter: int = 10):
    """Windows sharded over ``dp``; per-shard vmapped phasing; psum of the
    phased-read counter across the mesh."""

    def step(*local):
        out = window_phase_batch(local, max_iter)
        n_phased = jax.lax.psum(
            jnp.sum((out.haps > 0).astype(jnp.int32)), axis_name="dp")
        return out, n_phased

    fn = jax.shard_map(
        step, mesh=mesh,
        in_specs=tuple(P("dp") for _ in range(11)),
        out_specs=(PhaseKernelOut(*(P("dp"),) * 7), P()),
        check_vma=False)
    return jax.jit(fn)(*batch)


def make_example_window_batch(n_windows: int, n_reads: int = 64,
                              n_vars: int = 128, seed: int = 0):
    """Synthetic padded window batch (two haplotypes + noise) in the
    production kernel's input layout."""
    rng = np.random.default_rng(seed)
    A = np.full((n_windows, n_reads, n_vars), -1, dtype=np.int8)
    cons0 = np.full((n_windows, 2, n_vars), -1, dtype=np.int8)
    haps0 = np.zeros((n_windows, n_reads), dtype=np.int8)
    for wdw in range(n_windows):
        truth = rng.integers(0, 2, n_vars)
        haps = rng.integers(1, 3, n_reads)
        alle = np.where((haps[:, None] == 1), truth[None, :],
                        1 - truth[None, :])
        noise = rng.random((n_reads, n_vars)) < 0.02
        A[wdw] = np.where(noise, 1 - alle, alle)
        cons0[wdw, 0] = truth
        cons0[wdw, 1] = 1 - truth
        haps0[wdw] = haps
    ones_v = np.ones((n_windows, n_vars), dtype=bool)
    return (jnp.asarray(A),
            jnp.zeros((n_windows, n_reads), dtype=jnp.int32),
            jnp.full((n_windows, n_reads), n_vars - 1, dtype=jnp.int32),
            jnp.asarray(cons0), jnp.asarray(haps0),
            jnp.asarray(ones_v),
            jnp.full((n_windows, n_vars), 2, dtype=jnp.int32),
            jnp.asarray(ones_v), jnp.asarray(ones_v),
            jnp.zeros((n_windows, n_vars), dtype=bool),
            jnp.zeros((n_windows, n_vars), dtype=bool))
