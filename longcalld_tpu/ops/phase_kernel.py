"""Device phasing kernel: the fixpoint EM of
assign_hap_based_on_germline_het_vars_kmeans
(/root/reference/src/assign_hap.c:473-547) as ONE jit dispatch.

Split of labor (the same split the reference's own cost profile implies):

* The seeded outward sweep (:496-527) is inherently sequential — each read
  assignment feeds the consensus the next read is scored against — and
  touches each read once.  It stays on host (core.phase.seed_sweep),
  where it is O(reads) cheap vectorized numpy.
* The fixpoint iterations (:530-542) are the O(reads x vars) hot part:
  up to 10 rounds of (a) phase-set segmentation + consensus flipping
  (iter_update_var_hap_cons_phase_set :345-422) and (b) whole-matrix read
  re-assignment + consensus refresh (iter_update_var_hap_to_cons_alle
  :425-467).  Those are masked matmuls over the read x variant allele
  matrix — this kernel runs ALL of them on device under one counted
  lax.scan (updates select-masked after convergence), so phasing costs a
  single dispatch per window with a fully static trip count.

Outputs: consensus alleles, read haps, per-var phase-set START INDEX (the
host maps indices to the reference's position-based PS ids), per-read
clean-SNP agree/conflict counters, per-var/hap profiles.

Bit-exact against the host oracle longcalld_tpu.core.phase — asserted on
every window of the real HiFi BAM in tests/test_phase_kernel.py.  All
counts are small integers (< 2^24); the dots run at Precision.HIGHEST so
the float32 products are exact (a TF32 product keeps integers exact only
up to 2048, and read counts per variant exceed that at R = 8192).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np

from longcalld_tpu.utils import counters, prewarm
from longcalld_tpu.utils.device import init_device

init_device()

import jax
import jax.numpy as jnp

_PREC = jax.lax.Precision.HIGHEST


class PhaseKernelOut(NamedTuple):
    cons: jax.Array        # int8 (2, V)
    haps: jax.Array        # int8 (R,)
    ps_start: jax.Array    # int32 (V,): index of the var that starts this
                           # var's phase set; -1 outside the valid set
    agree: jax.Array       # int32 (R,)
    conflict: jax.Array    # int32 (R,)
    profile: jax.Array     # int32 (2, V, 2)
    n_iter: jax.Array      # int32


def _complement_fill(c1, c2, mask):
    """read_to_cons_allele_score's one-sided fill (assign_hap.c:139-143)."""
    f1 = jnp.where(mask & (c1 == -1) & (c2 != -1), 1 - c2, c1)
    f2 = jnp.where(mask & (c2 == -1) & (c1 != -1), 1 - c1, c2)
    return f1, f2


def _cons_update(p0, p1, hp_ont):
    """update_var_hap_to_cons_alle core (assign_hap.c:244-268): majority,
    ref preferred on ties, -1 uncovered; ONT homopolymer indels need a 67%
    majority."""
    max_i = jnp.where(p1 > p0, 1, jnp.where(p0 > 0, 0, -1))
    max_cov = jnp.where(max_i == 1, p1, jnp.where(max_i == 0, p0, 0))
    weak = hp_ont & (max_cov.astype(jnp.float32)
                     < (p0 + p1).astype(jnp.float32) * 0.67)
    return jnp.where(weak, -1, max_i).astype(jnp.int32)


def _dotp(m, v):
    return jnp.dot(m, v, precision=_PREC,
                   preferred_element_type=jnp.float32)


def _ps_scan(valid, het, n_agree, n_conflict, first_valid):
    """The sequential per-variant sweep of iter_update_var_hap_cons_phase_set
    (assign_hap.c:345-422): phase-set starts and the running flip parity,
    one lax.scan step per variant.  Returns (ps_start (V,), flip_mask (V,))."""
    def step(carry, v):
        start, flip = carry
        is_first = v == first_valid
        vv = valid[v]
        new_seg = het[v] & (n_agree[v] < 2) & (n_conflict[v] < 2)
        do_flip = het[v] & ~new_seg & (n_conflict[v] > n_agree[v])
        start = jnp.where(vv & (is_first | (~is_first & new_seg)), v, start)
        flip = jnp.where(vv & ~is_first & do_flip, flip ^ 1, flip)
        flip_here = vv & ~is_first & het[v] & (flip == 1)
        out_start = jnp.where(vv, start, -1)
        return (start, flip), (out_start, flip_here)

    (_, _), (ps_start, flip_mask) = jax.lax.scan(
        step, (jnp.array(-1, jnp.int32), jnp.array(0, jnp.int32)),
        jnp.arange(valid.shape[0], dtype=jnp.int32))
    return ps_start, flip_mask


def _phase_fixpoint(alleles, starts, ends, cons0, haps0,
                    scoreable, w_score, clean_snp, valid,
                    hp_het, hp_ont,
                    max_iter: int = 10,
                    axis_name: str | None = None) -> PhaseKernelOut:
    """Fixpoint phasing iterations, all on device.

    alleles: int8 (R, V) profile matrix (-2/-1/0/1)
    starts/ends: int32 (R,) profile spans (-1/-2 when none; digar-less
        reads pre-masked to -1/-2 by the host bridge)
    cons0: int8 (2, V) post-sweep consensus
    haps0: int8 (R,) post-sweep read haps (0/1/2)
    scoreable/w_score/clean_snp: per-var scoring masks, exactly
        core.phase._score_masks
    valid: (V,) the target-category mask (assign_haplotypes' valid_mask)
    hp_het: (V,) homopolymer-indel flags (UNgated — used by the het test)
    hp_ont: (V,) is_ont & homopolymer flags (gates the 67% consensus rule)
    axis_name: when run under shard_map with the READS axis sharded over a
        mesh axis, every reduction over reads crosses the mesh via psum;
        var-axis state (consensus, phase sets) stays replicated.  All
        psum'd quantities are identical on every device, so the
        convergence mask is replicated and devices stay in lockstep.
    """
    R, V = alleles.shape

    def rsum(x, dtype=jnp.int32):
        """Reduction over the (possibly mesh-sharded) reads axis."""
        s = jnp.sum(x.astype(dtype), axis=0)
        if axis_name is not None:
            s = jax.lax.psum(s, axis_name=axis_name)
        return s

    def rdot(v, m):
        """(R,) x (R, V) -> (V,) dot over the reads axis, exact."""
        s = _dotp(v, m)
        if axis_name is not None:
            s = jax.lax.psum(s, axis_name=axis_name)
        return s
    A = alleles.astype(jnp.int32)
    A0 = (A == 0)
    A1 = (A == 1)
    Af0 = A0.astype(jnp.float32)
    Af1 = A1.astype(jnp.float32)
    w = w_score.astype(jnp.int32)
    iota_v = jnp.arange(V, dtype=jnp.int32)
    read_valid = starts >= 0
    first_valid = jnp.argmax(valid)

    def ps_flip(c1, c2, haps):
        """iter_update_var_hap_cons_phase_set (assign_hap.c:345-422)."""
        het = valid & (c1 != -1) & (c2 != -1) & (c1 != c2) & ~hp_het
        idx_or_neg = jnp.where(het, iota_v, -1)
        prev_incl = jax.lax.cummax(idx_or_neg)
        prev_het = jnp.concatenate(
            [jnp.full((1,), -1, prev_incl.dtype), prev_incl[:-1]])
        own_c = jnp.where((haps == 1)[:, None], c1[None, :], c2[None, :])
        oth_c = jnp.where((haps == 1)[:, None], c2[None, :], c1[None, :])
        own_m = (A == own_c) & (A >= 0)
        oth_m = (A == oth_c) & (A >= 0)
        prev_own = jnp.take(own_m, jnp.maximum(prev_het, 0), axis=1)
        cover = ((starts[:, None] <= prev_het[None, :])
                 & (ends[:, None] >= iota_v[None, :]))
        act = (haps != 0)[:, None] & cover & (prev_het >= 0)[None, :]
        n_agree = rsum(act & prev_own & own_m)
        n_conflict = rsum(act & prev_own & ~own_m & oth_m)
        ps_start, flip_mask = _ps_scan(valid, het, n_agree, n_conflict,
                                       first_valid)
        nc1 = jnp.where(flip_mask, c2, c1)
        nc2 = jnp.where(flip_mask, c1, c2)
        return nc1, nc2, ps_start.astype(jnp.int32), jnp.any(flip_mask)

    def reassign(c1, c2):
        """iter_update_var_hap_to_cons_alle (assign_hap.c:425-467)."""
        scored_any = scoreable & (rsum((A0 | A1)
                                       & read_valid[:, None]) > 0)
        f1, f2 = _complement_fill(c1, c2, scored_any)
        cons_set = scoreable & (f1 != -1)
        wf = jnp.where(cons_set, w, 0).astype(jnp.float32)
        sv1 = wf * (1 - 2 * f1).astype(jnp.float32)
        sv2 = wf * (1 - 2 * f2).astype(jnp.float32)
        Df = Af0 - Af1
        s1 = _dotp(Df, sv1)
        s2 = _dotp(Df, sv2)
        n_used = _dotp((A0 | A1).astype(jnp.float32),
                       (cons_set & (w > 0)).astype(jnp.float32))
        max_s = jnp.maximum(s1, s2)
        min_s = jnp.minimum(s1, s2)
        max_hap = jnp.where(s1 >= s2, 1, 2)
        min_hap = jnp.where(s1 <= s2, 1, 2)
        hap = jnp.where(max_s > 0, max_hap,
                        jnp.where(min_s < 0, 3 - min_hap, 0))
        hap = jnp.where(n_used == 0, 0, hap)   # iter path maps -1 -> 0
        hap = jnp.where(read_valid, hap, 0).astype(jnp.int32)
        cs = clean_snp & cons_set
        ag1 = _dotp(Af0, (cs & (f1 == 0)).astype(jnp.float32)) \
            + _dotp(Af1, (cs & (f1 == 1)).astype(jnp.float32))
        cf1 = _dotp(Af0, (cs & (f1 == 1)).astype(jnp.float32)) \
            + _dotp(Af1, (cs & (f1 == 0)).astype(jnp.float32))
        ag2 = _dotp(Af0, (cs & (f2 == 0)).astype(jnp.float32)) \
            + _dotp(Af1, (cs & (f2 == 1)).astype(jnp.float32))
        cf2 = _dotp(Af0, (cs & (f2 == 1)).astype(jnp.float32)) \
            + _dotp(Af1, (cs & (f2 == 0)).astype(jnp.float32))
        pos = max_s > 0
        ag = jnp.where(pos & read_valid,
                       jnp.where(max_hap == 1, ag1, ag2), 0)
        cf = jnp.where(pos & read_valid,
                       jnp.where(max_hap == 1, cf1, cf2), 0)
        h1 = (((hap == 1) | (hap == 0)) & read_valid).astype(jnp.float32)
        h2 = (((hap == 2) | (hap == 0)) & read_valid).astype(jnp.float32)
        tgt = valid.astype(jnp.float32)[None, :]
        p10 = rdot(h1, Af0 * tgt).astype(jnp.int32)
        p11 = rdot(h1, Af1 * tgt).astype(jnp.int32)
        p20 = rdot(h2, Af0 * tgt).astype(jnp.int32)
        p21 = rdot(h2, Af1 * tgt).astype(jnp.int32)
        nc1 = jnp.where(valid, _cons_update(p10, p11, hp_ont), f1)
        nc2 = jnp.where(valid, _cons_update(p20, p21, hp_ont), f2)
        prof = jnp.stack([jnp.stack([p10, p11], axis=-1),
                          jnp.stack([p20, p21], axis=-1)])
        # changed vs the PRE-fill consensus (host copies prev before the
        # fill; filled valid vars are overwritten by the argmax anyway)
        changed = jnp.any(((nc1 != c1) | (nc2 != c2)) & valid)
        return (nc1, nc2, hap, ag.astype(jnp.int32), cf.astype(jnp.int32),
                prof, changed)

    def body(state, _):
        # Counted-trip fixpoint: the EM converges in <= max_iter rounds
        # (assign_hap.c caps the same way); a lax.scan of max_iter steps
        # with select-masked updates after convergence is semantically
        # identical to the dynamic while_loop but keeps the compiled
        # program's trip count static.
        c1, c2, haps, prof, agree, conflict, ps_start, it, changed = state
        nc1, nc2, nps, ch1 = ps_flip(c1, c2, haps)
        nc1, nc2, nhaps, nagree, nconflict, nprof, ch2 = reassign(nc1, nc2)

        def sel(new, old):
            return jnp.where(changed, new, old)
        state = (sel(nc1, c1), sel(nc2, c2), sel(nhaps, haps),
                 sel(nprof, prof), sel(nagree, agree),
                 sel(nconflict, conflict), sel(nps, ps_start),
                 jnp.where(changed, it + 1, it),
                 jnp.where(changed, ch1 | ch2, changed))
        return state, ()

    zR = jnp.zeros(R, dtype=jnp.int32)
    init = (cons0[0].astype(jnp.int32), cons0[1].astype(jnp.int32),
            haps0.astype(jnp.int32), jnp.zeros((2, V, 2), dtype=jnp.int32),
            zR, zR, jnp.full(V, -1, dtype=jnp.int32),
            jnp.array(0, jnp.int32), jnp.array(True))
    (c1, c2, haps, prof, agree, conflict, ps_start, it, _), _ = \
        jax.lax.scan(body, init, None, length=max_iter)

    return PhaseKernelOut(
        cons=jnp.stack([c1, c2]).astype(jnp.int8),
        haps=haps.astype(jnp.int8),
        ps_start=ps_start,
        agree=agree, conflict=conflict, profile=prof, n_iter=it)


phase_fixpoint_kernel = jax.jit(_phase_fixpoint,
                                static_argnames=("max_iter", "axis_name"))


def _warm_phase(e: dict) -> None:
    """Prewarm callback: compile/load the phasing fixpoint executable for a
    journaled (R, V) bucket with dummy (all-invalid) inputs."""
    R, V = int(e["R"]), int(e["V"])
    out = phase_fixpoint_kernel(
        jnp.full((R, V), -1, jnp.int8), jnp.full((R,), -1, jnp.int32),
        jnp.full((R,), -2, jnp.int32), jnp.full((2, V), -1, jnp.int8),
        jnp.zeros((R,), jnp.int8), jnp.zeros((V,), bool),
        jnp.zeros((V,), jnp.int32), jnp.zeros((V,), bool),
        jnp.zeros((V,), bool), jnp.zeros((V,), bool), jnp.zeros((V,), bool))
    jax.block_until_ready(out)


prewarm.register_warmer("phase", _warm_phase)


@functools.lru_cache(maxsize=8)
def sharded_phase_fixpoint(mesh_devices: int, max_iter: int = 10):
    """The multi-device phasing step: READS sharded over a 1-D ``dp`` mesh,
    var-axis state replicated, cross-read reductions via psum (SURVEY.md
    section 2.4's collective mapping).  Returns a jitted callable with
    the same signature as phase_fixpoint_kernel; R must divide evenly by
    the mesh size (the host bridge pads to bucket sizes that do)."""
    from jax.sharding import Mesh, PartitionSpec as P

    mesh = Mesh(np.array(jax.devices()[:mesh_devices]), axis_names=("dp",))
    step = functools.partial(_phase_fixpoint, max_iter=max_iter,
                             axis_name="dp")
    rd = P("dp")            # per-read vectors
    rd2 = P("dp", None)     # (R, V) matrices
    rep = P()               # replicated var-axis state
    fn = jax.shard_map(
        step, mesh=mesh,
        in_specs=(rd2, rd, rd, rep, rd, rep, rep, rep, rep, rep, rep),
        out_specs=PhaseKernelOut(
            cons=rep, haps=rd, ps_start=rep, agree=rd, conflict=rd,
            profile=rep, n_iter=rep),
        check_vma=False)
    return jax.jit(fn)


# ---------------- host bridge ----------------

_R_BUCKETS = (128, 512, 2048, 8192)
_V_BUCKETS = (128, 512, 2048, 8192)


def _bucket(n: int, opts) -> int:
    for o in opts:
        if n <= o:
            return o
    return n


def run_phase_kernel(opt, chunk, target_cate: int,
                     valid_idx: np.ndarray) -> bool:
    """Build padded inputs from the post-sweep chunk, run the fixpoint
    kernel, write results back.  Returns False (caller falls back to the
    host oracle loop) when the window shape is degenerate.  Call AFTER
    init_var_hap_state, _prepare_read_var_order and seed_sweep, exactly
    where the host fixpoint loop would start; the caller still runs
    _update_read_phase_sets afterwards."""
    from longcalld_tpu.core.phase import _score_masks
    from longcalld_tpu.io.bam import CDIFF

    cand = chunk.cand_vars
    n_reads = chunk.n_reads
    n_vars = len(cand)
    if n_reads == 0 or n_vars == 0:
        return False
    mesh_devices = int(getattr(opt, "mesh_devices", 0) or 0)
    R = _bucket(n_reads, _R_BUCKETS)
    V = _bucket(n_vars, _V_BUCKETS)
    if mesh_devices > 1:
        R += (-R) % mesh_devices   # reads axis shards evenly over the mesh

    valid_mask = np.zeros(V, dtype=bool)
    valid_mask[:n_vars] = (chunk.var_cate & target_cate) != 0
    scoreable_s, w_score_s, clean_snp_s = _score_masks(chunk, target_cate)
    scoreable = np.zeros(V, dtype=bool)
    scoreable[:n_vars] = scoreable_s
    w_score = np.zeros(V, dtype=np.int32)
    w_score[:n_vars] = w_score_s
    clean_snp = np.zeros(V, dtype=bool)
    clean_snp[:n_vars] = clean_snp_s
    hp = (cand.is_homopolymer_indel
          if cand.is_homopolymer_indel is not None
          else np.zeros(n_vars, dtype=bool))
    hp_het = np.zeros(V, dtype=bool)
    hp_het[:n_vars] = hp
    hp_ont = np.zeros(V, dtype=bool)
    if opt.is_ont:
        hp_ont[:n_vars] = hp

    alleles = np.full((R, V), -1, dtype=np.int8)
    alleles[:n_reads, :n_vars] = chunk.alleles
    starts = np.full(R, -1, dtype=np.int32)
    ends = np.full(R, -2, dtype=np.int32)
    starts[:n_reads] = chunk.read_start_var
    ends[:n_reads] = chunk.read_end_var
    # digar-less (skipped) reads never join scoring or profile updates
    has_digar = np.array([chunk.digars[ri] is not None
                          for ri in range(n_reads)], dtype=bool)
    starts[:n_reads][~has_digar] = -1
    ends[:n_reads][~has_digar] = -2

    cons0 = np.full((2, V), -1, dtype=np.int8)
    cons0[:, :n_vars] = cand.hap_cons_alle[:, 1:].T  # post seed_sweep
    haps0 = np.zeros(R, dtype=np.int8)
    haps0[:n_reads] = chunk.haps

    if mesh_devices <= 1:
        prewarm.record("phase", R=R, V=V)
    kern = (sharded_phase_fixpoint(mesh_devices) if mesh_devices > 1
            else phase_fixpoint_kernel)
    dev = getattr(chunk, "_device", None) if mesh_devices <= 1 else None

    def _put(a):
        # window data-parallelism: commit this window's phasing to its
        # assigned mesh device (SURVEY.md section 2.4's kt_for analog)
        return jax.device_put(a, dev) if dev is not None else jnp.asarray(a)
    out = kern(
        _put(alleles), _put(starts), _put(ends),
        _put(cons0), _put(haps0), _put(scoreable),
        _put(w_score), _put(clean_snp),
        _put(valid_mask), _put(hp_het), _put(hp_ont))

    counters.inc("phase_kernel_dispatch")
    # start all device->host copies before blocking on any
    for a in (out.cons, out.haps, out.ps_start, out.agree, out.conflict,
              out.profile):
        a.copy_to_host_async()
    cons = np.asarray(out.cons)
    haps = np.asarray(out.haps)
    ps_start = np.asarray(out.ps_start)[:n_vars]
    agree = np.asarray(out.agree)
    conflict = np.asarray(out.conflict)
    profile = np.asarray(out.profile)

    cand.hap_cons_alle[:, 1] = cons[0, :n_vars]
    cand.hap_cons_alle[:, 2] = cons[1, :n_vars]
    cand.hap_profile[:, 1, :] = profile[0, :n_vars]
    cand.hap_profile[:, 2, :] = profile[1, :n_vars]
    chunk.haps[:] = haps[:n_reads]
    chunk.n_clean_agree_snps[:] = agree[:n_reads]
    chunk.n_clean_conflict_snps[:] = conflict[:n_reads]
    # phase-set ids: the reference uses the segment-starting var's position
    # (SNP: pos; indel: pos-1) (assign_hap.c:392-397)
    ok = (ps_start >= 0) & (ps_start < n_vars)
    si = ps_start[ok]
    cand.phase_set[np.nonzero(ok)[0]] = np.where(
        cand.type[si] == CDIFF, cand.pos[si], cand.pos[si] - 1)
    return True
