"""Read x variant allele profile.

Dense replacement for read_var_profile_t (/root/reference/src/collect_var.h:
98-104): ``chunk.alleles[read_id, var_id]`` in {-1 none, -2 low-qual alt,
0 ref, 1 alt}, plus per-read [start_var, end_var] spans.  The dense int8
matrix is exactly the tensor the device phasing kernel consumes.

Mirrors update_read_vs_all_var_profile_from_digar
(/root/reference/src/bam_utils.c:446-551).

Device-placement rationale: as in core/sites.py — the warm C merge-join
fills the whole window's profile in ~15-40 ms on the host, and byte-keyed
comparators force host-side key hashing for any device formulation; the
profile's CONSUMER (the phasing fixpoint over the dense int8 matrix this
module produces) is where the device earns its keep.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from longcalld_tpu import config
from longcalld_tpu.config import CallOpts
from longcalld_tpu.core.chunk import WindowChunk
from longcalld_tpu.core.digar import ReadDigar
from longcalld_tpu.core.sites import (_ave_quals,
                                      comp_sites_ins, event_site_tuple,
                                      event_site_tuples_cached,
                                      get_site_start)
from longcalld_tpu.io.bam import CDEL, CEQUAL, CINS


def _ovlp_sites(a, b) -> bool:
    """ovlp_var_site (collect_var.c:79-95): ref-span overlap with INS
    special-casing."""
    beg1, end1 = a[0], a[0] + a[2]
    beg2, end2 = b[0], b[0] + b[2]
    if a[2] == 0 and b[2] == 0:
        return beg1 == beg2
    if a[2] == 0:
        return beg2 < beg1 < end2 and end1 < end2
    if b[2] == 0:
        return beg1 < beg2 < end1 and end2 < end1
    return not (beg1 >= end2 or beg2 >= end1)


def _fuzzy_ovlp_sites(a, b) -> bool:
    """fuzzy_ovlp_var_site (collect_var.c:97-109)."""
    if a[1] == CINS and b[1] == CINS:
        return min(a[3], b[3]) >= abs(a[0] - b[0])
    if a[1] == CDEL and b[1] == CDEL:
        end1, end2 = a[0] + a[2], b[0] + b[2]
        return min(end1, end2) >= max(a[0], b[0])
    return False


def _fuzzy_comp_sites(opt: CallOpts, a, b) -> int:
    """fuzzy_comp_var_site (collect_var.c:154-165)."""
    from longcalld_tpu.core.align_screen import vntr_fuzzy_comp_seq
    if a[1] == CDEL and b[1] == CDEL:
        if min(a[2], b[2]) >= max(a[2], b[2]) * 0.8:
            return 0
    elif a[1] == CINS and b[1] == CINS:
        if (min(a[3], b[3]) >= max(a[3], b[3]) * 0.8
                and vntr_fuzzy_comp_seq(
                    np.frombuffer(a[4], dtype=np.uint8),
                    np.frombuffer(b[4], dtype=np.uint8)) == 0):
            return 0
    # exact fallback
    r = comp_sites_ins(1 << 30, a, b)  # strict (min_sv_len huge -> exact)
    return r


def fuzzy_comp_ovlp(opt: CallOpts, a, b):
    """fuzzy_comp_ovlp_var_site (collect_var.c:167-183) ->
    (cmp, is_ovlp)."""
    if ((a[1] == CINS and b[1] == CINS and a[3] >= opt.min_sv_len
         and b[3] >= opt.min_sv_len)
            or (a[1] == CDEL and b[1] == CDEL and a[2] >= opt.min_sv_len
                and b[2] >= opt.min_sv_len)):
        if _fuzzy_ovlp_sites(a, b):
            return _fuzzy_comp_sites(opt, a, b), True
        return comp_sites_ins(1 << 30, a, b), False
    return comp_sites_ins(1 << 30, a, b), _ovlp_sites(a, b)


# ---------------- native fast path (germline windows) ----------------

def _load_native():
    from longcalld_tpu.core.sites import load_join_native
    return load_join_native()


def _cate_c_array(chunk: WindowChunk) -> np.ndarray:
    """Contiguous int32 category column, cached per var_cate identity."""
    cached = getattr(chunk, "_ccate", None)
    if cached is not None and cached[0] is chunk.var_cate:
        return cached[1]
    arr = np.ascontiguousarray(chunk.var_cate, dtype=np.int32)
    chunk._ccate = (chunk.var_cate, arr)
    return arr


def _update_read_profile_native(opt: CallOpts, chunk: WindowChunk,
                                read_i: int, digar: ReadDigar, lib) -> None:
    import ctypes
    from longcalld_tpu.core.sites import digar_c_ptrs, site_c_ptrs
    n_vars = len(chunk.cand_vars)
    sp_vpos, sp_pos, sp_type, sp_ref, sp_alt, sp_blob, sp_off = \
        site_c_ptrs(chunk.cand_vars)
    scate = _cate_c_array(chunk)
    (dp_type, dp_pos, dp_len, dp_qi, dp_ave, _dp_low, dp_seq, dp_nst,
     dp_nen) = digar_c_ptrs(digar)
    nst_len = len(digar.noisy_regs.starts)
    alleles = np.ascontiguousarray(chunk.alleles[read_i])
    alt_qi = np.ascontiguousarray(chunk.alt_qi[read_i])
    span = np.zeros(2, dtype=np.int64)

    def p(a, t):
        return a.ctypes.data_as(ctypes.POINTER(t))
    i64, i32, i8 = ctypes.c_int64, ctypes.c_int32, ctypes.c_int8
    lib.profile_join_read(
        i64(n_vars), sp_vpos, sp_pos, sp_type, sp_ref, sp_alt, sp_blob,
        sp_off,
        p(scate, i32), i32(config.NON_VAR),
        i64(len(digar.pos)), dp_type, dp_pos, dp_len,
        dp_qi, dp_ave, dp_seq,
        i64(digar.beg), i64(digar.end),
        i64(nst_len), dp_nst, dp_nen,
        i64(opt.min_bq),
        p(alleles, i8), p(alt_qi, i32), p(span, i64))
    chunk.alleles[read_i] = alleles
    chunk.alt_qi[read_i] = alt_qi
    chunk.read_start_var[read_i] = span[0]
    chunk.read_end_var[read_i] = span[1]


def _has_somatic_vars(chunk: WindowChunk) -> bool:
    # identity-cached per var_cate array.  The one in-place promotion to
    # CAND_SOMATIC_VAR (somatic_call.py's noisy-SV adoption) runs after the
    # last update_read_profile call of the window, so a cached False can
    # never mask a somatic var this join needs to fuzzy-match.
    cached = getattr(chunk, "_has_som", None)
    if cached is not None and cached[0] is chunk.var_cate:
        return cached[1]
    v = bool((chunk.var_cate == config.CAND_SOMATIC_VAR).any())
    chunk._has_som = (chunk.var_cate, v)
    return v


def update_read_profile(opt: CallOpts, chunk: WindowChunk, read_i: int,
                        digar: ReadDigar, somatic_counts: bool = True) -> None:
    """One read's merge-join against the classified variant list."""
    if len(chunk.cand_vars) and not _has_somatic_vars(chunk):
        lib = _load_native()
        if lib:
            _update_read_profile_native(opt, chunk, read_i, digar, lib)
            return
    _update_read_profile_py(opt, chunk, read_i, digar, somatic_counts)


def _update_read_profile_py(opt: CallOpts, chunk: WindowChunk, read_i: int,
                            digar: ReadDigar,
                            somatic_counts: bool = True) -> None:
    """The sequential oracle (kept as the somatic-window path and the
    fuzz-test reference for the C join)."""
    cand = chunk.cand_vars
    cate = chunk.var_cate
    n_vars = len(cand)
    alleles = chunk.alleles[read_i]
    alt_qi = chunk.alt_qi[read_i]
    sort_pos = cand.sort_pos()
    var_i = get_site_start(sort_pos, cand.pos, digar.beg)
    digar_i = 0
    n_digar = len(digar.pos)
    start_var = -1
    end_var = -2
    # per-event average quals in one vectorized pass (== _digar_ave_qual
    # wherever the value is consumed: ret==0 only matches var-type events)
    ave_all = _ave_quals(digar, np.arange(n_digar, dtype=np.int64))
    # site tuples are read-invariant: build once per CandVars object
    # (noisy-region merges REPLACE chunk.cand_vars, consensus.py:951, so
    # identity keying is sound)
    cached = getattr(chunk, "_site_tuples", None)
    if cached is not None and cached[0] is cand:
        site_tuples = cached[1]
    else:
        site_tuples = [cand.site_tuple(i) for i in range(n_vars)]
        chunk._site_tuples = (cand, site_tuples)
    ev_tuples = event_site_tuples_cached(digar)

    def set_allele(vi: int, allele: int, qi: int) -> None:
        nonlocal start_var, end_var
        if start_var == -1:
            start_var = vi
        end_var = vi
        alleles[vi] = allele
        alt_qi[vi] = qi

    while var_i < n_vars and digar_i < n_digar:
        if cate[var_i] == config.NON_VAR:
            var_i += 1
            continue
        if digar.type[digar_i] == CEQUAL:
            digar_i += 1
            continue
        vsite = site_tuples[var_i]
        dsite = ev_tuples[digar_i]
        if dsite is None:
            dsite = ev_tuples[digar_i] = event_site_tuple(digar, digar_i)
        ave_q = int(ave_all[digar_i])
        var_read_pos = int(digar.qi[digar_i])
        is_somatic = cate[var_i] == config.CAND_SOMATIC_VAR
        if is_somatic:
            ret, is_ovlp = fuzzy_comp_ovlp(opt, vsite, dsite)
            if vsite[1] == CINS and vsite[3] >= opt.min_sv_len and (
                    not is_ovlp or ret != 0):
                # rescue: scan nearby large INS events on both sides
                for di in range(digar_i - 1, -1, -1):
                    if digar.type[di] != CINS or digar.len[di] < opt.min_sv_len:
                        continue
                    if digar.pos[di] < vsite[0] - vsite[3]:
                        break
                    r2, o2 = fuzzy_comp_ovlp(opt, vsite,
                                             event_site_tuple(digar, di))
                    if o2 and r2 == 0:
                        ret, is_ovlp = 0, True
                        var_read_pos = int(digar.qi[di])
                        break
                if not is_ovlp or ret != 0:
                    for di in range(digar_i + 1, n_digar):
                        if (digar.type[di] != CINS
                                or digar.len[di] < opt.min_sv_len):
                            continue
                        if digar.pos[di] > vsite[0] + vsite[3]:
                            break
                        r2, o2 = fuzzy_comp_ovlp(opt, vsite,
                                                 event_site_tuple(digar, di))
                        if o2 and r2 == 0:
                            ret, is_ovlp = 0, True
                            var_read_pos = int(digar.qi[di])
                            break
        else:
            # germline: STRICT exact compare (comp_ovlp_var_site,
            # collect_var.c:1147-1150) — unlike the pileup pass
            ret = comp_sites_ins(1 << 30, vsite, dsite)
            is_ovlp = _ovlp_sites(vsite, dsite)
        if not is_ovlp:
            if ret < 0:
                if is_somatic and somatic_counts:
                    cand.total_cov[var_i] += 1
                    cand.alle_covs[var_i, 0] += 1
                set_allele(var_i, 0, -1)
                var_i += 1
            elif ret > 0:
                digar_i += 1
            else:
                var_i += 1
                digar_i += 1
        else:
            if ret == 0:
                allele = 1 if ave_q >= opt.min_bq else -2
                set_allele(var_i, allele, var_read_pos)
                if is_somatic and somatic_counts:
                    cand.total_cov[var_i] += 1
                    if allele >= 0:
                        cand.alle_covs[var_i, allele] += 1
                var_i += 1
            else:
                if is_somatic and somatic_counts:
                    v_beg, v_end = vsite[0], vsite[0] + vsite[2] - 1
                    if v_beg >= digar.beg and v_end <= digar.end:
                        cand.alle_covs[var_i, 0] += 1
                        cand.total_cov[var_i] += 1
                set_allele(var_i, -1, -1)
                var_i += 1
    while var_i < n_vars and cand.pos[var_i] <= digar.end:
        if digar.noisy_regs.overlap_mask_points(
                np.array([cand.pos[var_i] - 1]))[0]:
            var_i += 1
            continue
        if cate[var_i] == config.CAND_SOMATIC_VAR and somatic_counts:
            cand.total_cov[var_i] += 1
            cand.alle_covs[var_i, 0] += 1
        set_allele(var_i, 0, -1)
        var_i += 1

    chunk.read_start_var[read_i] = start_var
    chunk.read_end_var[read_i] = end_var


def collect_read_var_profile(opt: CallOpts, chunk: WindowChunk) -> None:
    """collect_read_var_profile (collect_var.c:1389-1432)."""
    n_reads = chunk.n_reads
    n_vars = len(chunk.cand_vars)
    chunk.alleles = np.full((n_reads, n_vars), -1, dtype=np.int8)
    chunk.alt_qi = np.full((n_reads, n_vars), -1, dtype=np.int32)
    chunk.read_start_var = np.full(n_reads, -1, dtype=np.int32)
    chunk.read_end_var = np.full(n_reads, -2, dtype=np.int32)
    if opt.out_somatic:
        somatic = chunk.var_cate == config.CAND_SOMATIC_VAR
        chunk.cand_vars.alle_covs[somatic] = 0
        chunk.cand_vars.total_cov[somatic] = 0
    for ri in chunk.order:
        d = chunk.digars[ri]
        if d is None:
            continue
        update_read_profile(opt, chunk, ri, d)
