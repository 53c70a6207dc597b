"""Candidate variant sites: collection, ordering, dedup, pileup counts.

Re-implements collect_all_cand_var_sites (/root/reference/src/collect_var.c:
1209-1253), the site comparators (exact_comp_var_site{,_ins}, :1878-1933) and
the per-read pileup merge-join (update_cand_vars_from_digar,
/root/reference/src/bam_utils.c:287-327).

Sites are stored struct-of-arrays; a site's identity is
(pos, var_type, ref_len, alt_len, alt_seq) with var_type in BAM codes
(INS=1 < DEL=2 < DIFF=8 — the C comparator orders by the raw code).  For
ordering, indels compare at pos-1 (the anchor-base convention).

Device-placement rationale (measured on the host, HG002 chr11 500 kb
window, 356 reads / 42,216 digar events / 8,771 sites): the warm
sequential C join (native/profilejoin.c pileup entry) runs in 25 ms; the
vectorized numpy form of the same semantics (collect_cand_vars_fast — the
shape a jnp/device port would take) runs in 83 ms, because the
two-pointer's constants beat vectorization at this problem size.  A device
version would also keep the irreducible host work: the exact comparator
keys on variable-length alt-seq BYTES (fuzzy large-INS matching included),
which must be hashed host-side into fixed keys at a cost comparable to the
join itself.  The join stays on the host C path; the device budget goes to
the stages where dense arithmetic dominates (phase-EM matmuls, banded
alignment DP — ops/phase_kernel.py, ops/wfa.py).  The GPU time of a device
formulation is not measured.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from longcalld_tpu.config import CallOpts
from longcalld_tpu.core.digar import ReadDigar
from longcalld_tpu.io.bam import CDEL, CDIFF, CEQUAL, CINS


@dataclasses.dataclass
class CandVars:
    """Window candidate variants + pileup counts (cand_var_t analog)."""
    pos: np.ndarray           # int64, 1-based
    type: np.ndarray          # uint8 BAM op
    ref_len: np.ndarray       # int32
    alt_len: np.ndarray       # int32
    alt_seqs: List[bytes]     # nt4 bytes; b"" for DEL
    total_cov: np.ndarray     # int32, excludes low-qual
    low_qual_cov: np.ndarray  # int32
    alle_covs: np.ndarray     # int32 (n, 2): ref / alt
    strand_covs: np.ndarray   # int32 (n, 2, 2): strand x allele
    # set later:
    phase_set: Optional[np.ndarray] = None      # int64
    hap_cons_alle: Optional[np.ndarray] = None  # int8 (n, 3): hom/h1/h2
    hap_profile: Optional[np.ndarray] = None    # int32 (n, 3, 2)
    is_homopolymer_indel: Optional[np.ndarray] = None

    def __len__(self) -> int:
        return len(self.pos)

    def sort_pos(self) -> np.ndarray:
        """Comparator position: pos for X, pos-1 for indels."""
        return np.where(self.type == CDIFF, self.pos, self.pos - 1)

    def site_tuple(self, i: int) -> Tuple[int, int, int, int, bytes]:
        return (int(self.pos[i]), int(self.type[i]), int(self.ref_len[i]),
                int(self.alt_len[i]), self.alt_seqs[i])

    def take(self, idx: np.ndarray) -> "CandVars":
        return CandVars(
            pos=self.pos[idx], type=self.type[idx], ref_len=self.ref_len[idx],
            alt_len=self.alt_len[idx],
            alt_seqs=[self.alt_seqs[i] for i in idx],
            total_cov=self.total_cov[idx], low_qual_cov=self.low_qual_cov[idx],
            alle_covs=self.alle_covs[idx], strand_covs=self.strand_covs[idx],
            phase_set=None if self.phase_set is None else self.phase_set[idx],
            hap_cons_alle=(None if self.hap_cons_alle is None
                           else self.hap_cons_alle[idx]),
            hap_profile=(None if self.hap_profile is None
                         else self.hap_profile[idx]),
            is_homopolymer_indel=(None if self.is_homopolymer_indel is None
                                  else self.is_homopolymer_indel[idx]))


def site_key(pos: int, typ: int, ref_len: int, alt_len: int,
             alt_seq: bytes) -> Tuple:
    """Strict total order == exact_comp_var_site (collect_var.c:1878-1897)."""
    p = pos if typ == CDIFF else pos - 1
    return (p, typ, ref_len, alt_len, alt_seq)


def comp_sites_ins(opt_min_sv_len: int, a: Tuple[int, int, int, int, bytes],
                   b: Tuple[int, int, int, int, bytes]) -> int:
    """exact_comp_var_site_ins (collect_var.c:1901-1933): exact compare with
    fuzzy (>=80% length) equality for large INSs."""
    pa = a[0] if a[1] == CDIFF else a[0] - 1
    pb = b[0] if b[1] == CDIFF else b[0] - 1
    if pa != pb:
        return -1 if pa < pb else 1
    if a[1] != b[1]:
        return -1 if a[1] < b[1] else 1
    if a[2] != b[2]:
        return -1 if a[2] < b[2] else 1
    if a[1] == CDIFF or (a[1] == CINS and a[3] < opt_min_sv_len):
        if a[3] != b[3]:
            return -1 if a[3] < b[3] else 1
        if a[4] != b[4]:
            return -1 if a[4] < b[4] else 1
        return 0
    if a[1] == CINS:  # large INS: similar length == match
        mn, mx = min(a[3], b[3]), max(a[3], b[3])
        if mn >= mx * 0.8:
            return 0
        return a[3] - b[3]
    return 0  # DEL with equal ref_len


def digar_site_events(digar: ReadDigar, reg_beg: int, reg_end: int,
                      include_low_qual: bool = False) -> np.ndarray:
    """Indices of digar events usable as candidate sites
    (is_collectible_var_digar, collect_var.c:1152-1159)."""
    m = digar.var_mask()
    m &= (digar.pos >= reg_beg) & (digar.pos <= reg_end)
    if not include_low_qual:
        m &= ~digar.low_qual
    return np.nonzero(m)[0]


def event_site_tuples_cached(digar: ReadDigar) -> list:
    """Per-event site tuples, built lazily and cached on the (immutable)
    digar — the merge-joins re-visit the same events across waves."""
    cached = getattr(digar, "_ev_tuples", None)
    if cached is None:
        cached = [None] * len(digar.pos)
        digar._ev_tuples = cached
    return cached


def event_site_tuple(digar: ReadDigar, i: int) -> Tuple[int, int, int, int, bytes]:
    t = int(digar.type[i])
    ln = int(digar.len[i])
    if t == CINS:
        ref_len, alt_len = 0, ln
        alt = digar.alt_seq(i).tobytes()
    elif t == CDEL:
        ref_len, alt_len = ln, 0
        alt = b""
    elif t == CDIFF:
        ref_len, alt_len = 1, ln
        alt = digar.alt_seq(i).tobytes()
    else:  # clips participate in the merge-join with their raw type, like
           # make_var_site_from_digar does (alt_seq never compared)
        ref_len, alt_len = 1, ln
        alt = b""
    return (int(digar.pos[i]), t, ref_len, alt_len, alt)


def collect_all_cand_var_sites(opt: CallOpts, digars: Sequence[Optional[ReadDigar]],
                               order: Sequence[int], reg_beg: int,
                               reg_end: int) -> List[Tuple[int, int, int, int, bytes]]:
    """Union of all reads' collectible events, sorted (strict comparator) then
    deduped with the fuzzy-INS comparator (collect_var.c:1209-1253)."""
    blocks: List[Tuple[ReadDigar, np.ndarray]] = []
    offs: List[int] = [0]
    col_parts: List[List[np.ndarray]] = [[] for _ in range(6)]
    for ri in order:
        d = digars[ri]
        if d is None:
            continue
        sel = digar_site_events(d, reg_beg, reg_end)
        if not len(sel):
            continue
        for c, part in zip(_event_keys_all(d), col_parts):
            part.append(c[sel])
        blocks.append((d, sel))
        offs.append(offs[-1] + len(sel))
    if not blocks:
        return []
    import bisect

    def ref_at(g: int) -> Tuple[ReadDigar, int]:
        b = bisect.bisect_right(offs, g) - 1
        d, sel = blocks[b]
        return d, int(sel[g - offs[b]])
    # sort on the cached key columns (column order == site_key order except
    # alt bytes past the 16-byte prefix); most events dedupe to one
    # representative per equal-key run, so site tuples are built only for
    # representatives instead of for every event on every read.  All
    # columns go uint64 (non-negative): a mixed int64/uint64 stack would
    # promote to float64 and round the alt hashes (> 2^53) together.
    cols = [np.concatenate(p).astype(np.uint64) for p in col_parts]
    idx = np.lexsort((cols[5], cols[4], cols[3], cols[2], cols[1], cols[0]))
    sc = np.stack([c[idx] for c in cols], axis=1)
    bounds = np.concatenate([np.nonzero(np.concatenate(
        [[True], (sc[1:] != sc[:-1]).any(axis=1)]))[0], [len(idx)]])
    alt_lens = cols[3]
    reps: List[Tuple[int, int, int, int, bytes]] = []
    for a, b in zip(bounds[:-1], bounds[1:]):
        first = int(idx[a])
        if b - a == 1 or alt_lens[first] <= 16:
            # the 16-byte prefix is exact: the whole run is one site
            d, i = ref_at(first)
            reps.append(event_site_tuple(d, i))
            continue
        # long alts may differ past the key prefix: materialize, order by
        # full alt (the pre-grouping sort's tie-break), keep distinct
        grp = sorted((event_site_tuple(*ref_at(int(k))) for k in idx[a:b]),
                     key=lambda t: t[4])
        reps.append(grp[0])
        for t in grp[1:]:
            if t[4] != reps[-1][4]:
                reps.append(t)

    out = [reps[0]]
    for t in reps[1:]:
        if comp_sites_ins(opt.min_sv_len, out[-1], t) == 0:
            continue
        out.append(t)
    return out


def make_cand_vars(sites: List[Tuple[int, int, int, int, bytes]]) -> CandVars:
    n = len(sites)
    return CandVars(
        pos=np.array([s[0] for s in sites], dtype=np.int64),
        type=np.array([s[1] for s in sites], dtype=np.uint8),
        ref_len=np.array([s[2] for s in sites], dtype=np.int32),
        alt_len=np.array([s[3] for s in sites], dtype=np.int32),
        alt_seqs=[s[4] for s in sites],
        total_cov=np.zeros(n, dtype=np.int32),
        low_qual_cov=np.zeros(n, dtype=np.int32),
        alle_covs=np.zeros((n, 2), dtype=np.int32),
        strand_covs=np.zeros((n, 2, 2), dtype=np.int32))


def _digar_ave_qual(digar: ReadDigar, i: int) -> int:
    """get_digar_ave_qual (src/bam_utils.c:258-279)."""
    if digar.low_qual[i]:
        return 0
    qi = int(digar.qi[i])
    if qi < 0:
        return 0
    if digar.type[i] == CDEL:
        q_start, q_end = (0, 0) if qi == 0 else (qi - 1, qi)
    else:
        q_start, q_end = qi, qi + int(digar.len[i]) - 1
    q = digar.qual[q_start:q_end + 1]
    return int(q.sum()) // len(q)


def get_site_start(sort_pos: np.ndarray, pos_list: np.ndarray,
                   start: int) -> int:
    """get_var_site_start (src/bam_utils.c:215-226): first site whose
    comparator-pos >= start-1, then advance while raw pos < start."""
    target = start - 1 if start > 0 else start
    left = int(np.searchsorted(sort_pos, target, side="left"))
    n = len(pos_list)
    while left < n and pos_list[left] < start:
        left += 1
    return left


def update_cand_vars_from_digar(opt: CallOpts, cand: CandVars,
                                cand_sort_pos: np.ndarray,
                                digar: ReadDigar) -> None:
    """Pileup pass: merge-join one read's events against the site list,
    crediting ref / alt / low-qual counts (src/bam_utils.c:287-327)."""
    n_sites = len(cand)
    strand = 1 if digar.is_rev else 0
    site_i = get_site_start(cand_sort_pos, cand.pos, digar.beg)
    digar_i = 0
    n_digar = len(digar.pos)
    types = digar.type
    while site_i < n_sites and digar_i < n_digar:
        t = int(types[digar_i])
        if t == CEQUAL:  # only '=' is skipped; clips join like the C does
            digar_i += 1
            continue
        dsite = event_site_tuple(digar, digar_i)
        ssite = cand.site_tuple(site_i)
        ret = comp_sites_ins(opt.min_sv_len, ssite, dsite)
        if ret < 0:
            cand.total_cov[site_i] += 1
            cand.alle_covs[site_i, 0] += 1
            cand.strand_covs[site_i, strand, 0] += 1
            site_i += 1
        elif ret == 0:
            ave_q = _digar_ave_qual(digar, digar_i)
            if digar.low_qual[digar_i] or ave_q < opt.min_bq:
                cand.low_qual_cov[site_i] += 1
            else:
                cand.total_cov[site_i] += 1
                cand.alle_covs[site_i, 1] += 1
                cand.strand_covs[site_i, strand, 1] += 1
            site_i += 1
        else:
            digar_i += 1
    # trailing sites inside the read span are ref
    while site_i < n_sites and cand.pos[site_i] <= digar.end:
        cand.total_cov[site_i] += 1
        cand.alle_covs[site_i, 0] += 1
        cand.strand_covs[site_i, strand, 0] += 1
        site_i += 1


def collect_cand_vars(opt: CallOpts, sites: List[Tuple[int, int, int, int, bytes]],
                      digars: Sequence[Optional[ReadDigar]],
                      order: Sequence[int]) -> CandVars:
    cand = make_cand_vars(sites)
    sort_pos = cand.sort_pos()
    for ri in order:
        d = digars[ri]
        if d is None:
            continue
        update_cand_vars_from_digar(opt, cand, sort_pos, d)
    return cand


# ---------------- vectorized pileup (numpy fast path) ----------------

def _site_key_arrays(cand: CandVars):
    """Sortable key columns (sort_pos, type, ref_len, alt_len, h1, h2) where
    h1/h2 are the first 16 alt bytes big-endian — exact for alt_len <= 16;
    longer alts fall back to a byte-compare on candidate hits."""
    n = len(cand)
    h1 = np.zeros(n, dtype=np.uint64)
    h2 = np.zeros(n, dtype=np.uint64)
    for i, s in enumerate(cand.alt_seqs):
        b = s[:16]
        v = int.from_bytes(b.ljust(16, b"\0"), "big")
        h1[i] = (v >> 64) & 0xFFFFFFFFFFFFFFFF
        h2[i] = v & 0xFFFFFFFFFFFFFFFF
    return (cand.sort_pos().astype(np.int64), cand.type.astype(np.int64),
            cand.ref_len.astype(np.int64), cand.alt_len.astype(np.int64),
            h1, h2)


def cand_packed_keys(cand: CandVars) -> list:
    """48-byte packed site keys for a CandVars, cached on the instance
    (identity fields never change after construction; count updates don't
    invalidate).  Byte order == site_key order except alt bytes past the
    16-byte prefix — callers tie-break long alts themselves."""
    cached = getattr(cand, "_pk", None)
    if cached is not None and len(cached) == len(cand):
        return cached
    cached = _pack_keys(_site_key_arrays(cand))
    cand._pk = cached
    return cached


def _event_keys_all(digar: ReadDigar):
    """Key columns for ALL events of a digar, computed once and cached on
    the (immutable) digar; callers slice by event index."""
    cached = getattr(digar, "_ev_keys", None)
    if cached is not None:
        return cached
    t = digar.type.astype(np.int64)
    ln = digar.len.astype(np.int64)
    pos = digar.pos.astype(np.int64)
    sort_pos = np.where(t == CDIFF, pos, pos - 1)
    ref_len = np.where(t == CDEL, ln, np.where(t == CINS, 0, 1))
    alt_len = np.where(t == CDEL, 0, ln)
    h1 = np.zeros(len(t), dtype=np.uint64)
    h2 = np.zeros(len(t), dtype=np.uint64)
    sel = np.nonzero((t != CDEL) & (t != CEQUAL))[0]
    if sel.size:
        # gather the first 16 alt bytes of every event at once, zero-pad
        # past alt_len, and view the big-endian rows as two uint64 halves
        qi = digar.qi.astype(np.int64)[sel]
        lens16 = np.where(qi < 0, 0, np.minimum(ln[sel], 16))
        cols16 = np.arange(16, dtype=np.int64)
        idx = np.clip(qi[:, None] + cols16, 0, len(digar.seq) - 1)
        mat = digar.seq[idx].astype(np.uint8)
        mat[cols16[None, :] >= lens16[:, None]] = 0
        halves = np.ascontiguousarray(mat).view(">u8").astype(np.uint64)
        h1[sel] = halves[:, 0]
        h2[sel] = halves[:, 1]
    cols = (sort_pos, t, ref_len, alt_len, h1, h2)
    digar._ev_keys = cols
    return cols


def _event_keys(digar: ReadDigar, idx: np.ndarray):
    """Key columns for digar events (same convention as sites)."""
    return tuple(c[idx] for c in _event_keys_all(digar))


def _packed_event_keys_all(digar: ReadDigar) -> list:
    """48-byte packed keys for ALL events, cached on the digar."""
    cached = getattr(digar, "_kb_all", None)
    if cached is None:
        cached = _pack_keys(_event_keys_all(digar))
        digar._kb_all = cached
    return cached


def _pack_keys(cols) -> list:
    """Pack key columns into per-row 48-byte big-endian keys whose bytes
    order equals the tuple order (columns are non-negative).

    Each column is cast to uint64 BEFORE stacking: np.stack over mixed
    int64/uint64 inputs promotes to float64, which would round away the
    low bits of the 16-byte alt hashes (values exceed 2^53) and collapse
    distinct alts to one key."""
    arr = np.ascontiguousarray(
        np.stack([np.asarray(c).astype(np.uint64) for c in cols],
                 axis=1).astype(">u8"))
    buf = arr.tobytes()
    return [buf[i * 48:(i + 1) * 48] for i in range(arr.shape[0])]


def _ave_quals(digar: ReadDigar, idx: np.ndarray) -> np.ndarray:
    """Vectorized get_digar_ave_qual for the selected events (computed for
    ALL events once per immutable digar, then sliced)."""
    full = getattr(digar, "_ave_q", None)
    if full is not None:
        return full[idx]
    q = digar.qual.astype(np.int64)
    cq = np.empty(len(q) + 1, dtype=np.int64)
    cq[0] = 0
    np.cumsum(q, out=cq[1:])
    qi = digar.qi.astype(np.int64)
    ln = digar.len.astype(np.int64)
    t = digar.type
    out = np.zeros(len(t), dtype=np.int64)
    ins_x = (t == CDIFF) | (t == CINS)
    if ins_x.any():
        s = qi[ins_x]
        e = np.minimum(s + ln[ins_x], len(q))
        out[ins_x] = (cq[e] - cq[s]) // np.maximum(e - s, 1)
    dl = t == CDEL
    if dl.any():
        s = np.where(qi[dl] == 0, 0, qi[dl] - 1)
        e = np.where(qi[dl] == 0, 1, np.minimum(qi[dl] + 1, len(q)))
        out[dl] = (cq[e] - cq[s]) // np.maximum(e - s, 1)
    out[digar.low_qual] = 0
    out[qi < 0] = 0
    digar._ave_q = out
    return out[idx]


# ---------------- native merge-join paths ----------------

_NATIVE = None


def load_join_native():
    """ctypes binding to native/profilejoin.c (pileup + profile joins)."""
    global _NATIVE
    if _NATIVE is not None:
        return _NATIVE
    import ctypes
    import os
    from longcalld_tpu.utils.cbuild import build_so
    d = os.path.join(os.path.dirname(os.path.dirname(__file__)), "native")
    so = os.path.join(d, "_profilejoin.so")
    src = os.path.join(d, "profilejoin.c")
    if not build_so(src, so):
        _NATIVE = False
        return False
    try:
        lib = ctypes.CDLL(so)
        lib.profile_join_read.restype = None
        lib.pileup_join_read.restype = None
        try:
            lib.u8_hist.restype = None
        except AttributeError:
            pass
        _NATIVE = lib
    except OSError:
        _NATIVE = False
    return _NATIVE


def u8_hist(arr: np.ndarray) -> np.ndarray:
    """Counts of each byte value in ``arr`` (length-256 int64) — the
    window base-quality histogram (collect_var.c:1083-1105).  C fast path
    with a numpy bincount fallback."""
    arr = np.ascontiguousarray(arr, dtype=np.uint8)
    lib = load_join_native()
    if lib and hasattr(lib, "u8_hist"):
        import ctypes
        out = np.zeros(256, dtype=np.int64)
        lib.u8_hist(arr.ctypes.data_as(ctypes.c_void_p),
                    ctypes.c_int64(arr.size),
                    out.ctypes.data_as(ctypes.c_void_p))
        return out
    return np.bincount(arr, minlength=256).astype(np.int64)


def site_c_arrays(cand: CandVars):
    """Contiguous site identity columns + alt blob for the C joins, cached
    on the CandVars (identity fields are immutable after construction)."""
    cached = getattr(cand, "_csite", None)
    if cached is not None:
        return cached
    off = np.zeros(len(cand) + 1, dtype=np.int64)
    np.cumsum([len(s) for s in cand.alt_seqs], out=off[1:])
    blob = np.frombuffer(b"".join(cand.alt_seqs) + b"\0", dtype=np.uint8)
    arrs = (np.ascontiguousarray(cand.sort_pos(), dtype=np.int64),
            np.ascontiguousarray(cand.pos, dtype=np.int64),
            np.ascontiguousarray(cand.type, dtype=np.uint8),
            np.ascontiguousarray(cand.ref_len, dtype=np.int64),
            np.ascontiguousarray(cand.alt_len, dtype=np.int64),
            blob, off)
    cand._csite = arrs
    return arrs


def digar_c_arrays(digar: ReadDigar):
    """Contiguous event columns for the C joins, cached on the digar."""
    cached = getattr(digar, "_cjoin", None)
    if cached is not None:
        return cached
    ave = _ave_quals(digar, np.arange(len(digar.pos), dtype=np.int64))
    nst = np.ascontiguousarray(digar.noisy_regs.starts, dtype=np.int64)
    nen = (np.maximum.accumulate(digar.noisy_regs.ends).astype(np.int64)
           if len(nst) else np.empty(0, dtype=np.int64))
    arrs = (np.ascontiguousarray(digar.type, dtype=np.uint8),
            np.ascontiguousarray(digar.pos, dtype=np.int64),
            np.ascontiguousarray(digar.len, dtype=np.int32),
            np.ascontiguousarray(digar.qi, dtype=np.int32),
            np.ascontiguousarray(ave, dtype=np.int64),
            np.ascontiguousarray(digar.low_qual, dtype=np.uint8),
            np.ascontiguousarray(digar.seq, dtype=np.uint8),
            nst, np.ascontiguousarray(nen))
    digar._cjoin = arrs
    return arrs


def site_c_ptrs(cand: CandVars):
    """Cached ctypes POINTERs over site_c_arrays: the two C joins are
    called once per READ with window-constant site columns, and the
    per-call data_as casts were the second-largest host cost in the
    1-thread profile (17k casts, ~0.07 s over a 6 Mbp run).  numpy's
    data_as keeps a reference to the array, so the cache cannot outlive
    its buffers."""
    cached = getattr(cand, "_cptrs", None)
    if cached is not None:
        return cached
    import ctypes
    svpos, spos, stype, sref, salt, blob, soff = site_c_arrays(cand)
    i64, u8 = ctypes.c_int64, ctypes.c_uint8

    def p(a, t):
        return a.ctypes.data_as(ctypes.POINTER(t))
    ptrs = (p(svpos, i64), p(spos, i64), p(stype, u8), p(sref, i64),
            p(salt, i64), p(blob, u8), p(soff, i64))
    cand._cptrs = ptrs
    return ptrs


def digar_c_ptrs(digar: ReadDigar):
    """Cached ctypes POINTERs over digar_c_arrays (used by BOTH C joins,
    so each digar was cast twice per pipeline stage)."""
    cached = getattr(digar, "_cjoin_ptrs", None)
    if cached is not None:
        return cached
    import ctypes
    etype, epos, elen, eqi, eave, elow, rseq, nst, nen = digar_c_arrays(digar)
    i64, i32, u8 = ctypes.c_int64, ctypes.c_int32, ctypes.c_uint8

    def p(a, t):
        return a.ctypes.data_as(ctypes.POINTER(t))
    ptrs = (p(etype, u8), p(epos, i64), p(elen, i32), p(eqi, i32),
            p(eave, i64), p(elow, u8), p(rseq, u8), p(nst, i64),
            p(nen, i64))
    digar._cjoin_ptrs = ptrs
    return ptrs


def collect_cand_vars_native(opt: CallOpts,
                             sites: List[Tuple[int, int, int, int, bytes]],
                             digars: Sequence[Optional[ReadDigar]],
                             order: Sequence[int]) -> Optional[CandVars]:
    """C implementation of the sequential pileup two-pointer
    (update_cand_vars_from_digar, src/bam_utils.c:287-327) — exact by
    construction; parity with the Python oracle is fuzz-tested in
    tests/test_sites_fast.py.  Returns None when the native library is
    unavailable (caller falls back to the vectorized numpy path)."""
    import ctypes
    lib = load_join_native()
    if not lib:
        return None
    cand = make_cand_vars(sites)
    n_sites = len(cand)
    if n_sites == 0:
        return cand
    sp_vpos, sp_pos, sp_type, sp_ref, sp_alt, sp_blob, sp_off = \
        site_c_ptrs(cand)
    total = np.ascontiguousarray(cand.total_cov)
    lowq = np.ascontiguousarray(cand.low_qual_cov)
    alle = np.ascontiguousarray(cand.alle_covs)
    strandc = np.ascontiguousarray(cand.strand_covs)

    def p(a, t):
        return a.ctypes.data_as(ctypes.POINTER(t))
    i64, i32 = ctypes.c_int64, ctypes.c_int32
    # window-constant pointers hoisted out of the per-read loop
    c_nsites = i64(n_sites)
    c_minsv = i64(opt.min_sv_len)
    c_minbq = i64(opt.min_bq)
    p_total, p_lowq = p(total, i32), p(lowq, i32)
    p_alle, p_strand = p(alle, i32), p(strandc, i32)
    for ri in order:
        d = digars[ri]
        if d is None:
            continue
        (dp_type, dp_pos, dp_len, dp_qi, dp_ave, dp_low, dp_seq,
         _dp_nst, _dp_nen) = digar_c_ptrs(d)
        lib.pileup_join_read(
            c_nsites, sp_vpos, sp_pos, sp_type, sp_ref, sp_alt, sp_blob,
            sp_off,
            i64(len(d.pos)), dp_type, dp_pos, dp_len,
            dp_qi, dp_ave, dp_low, dp_seq,
            i64(d.beg), i64(d.end), i64(1 if d.is_rev else 0),
            c_minsv, c_minbq,
            p_total, p_lowq, p_alle, p_strand)
    cand.total_cov = total
    cand.low_qual_cov = lowq
    cand.alle_covs = alle
    cand.strand_covs = strandc
    return cand


def collect_cand_vars_fast(opt: CallOpts,
                           sites: List[Tuple[int, int, int, int, bytes]],
                           digars: Sequence[Optional[ReadDigar]],
                           order: Sequence[int]) -> CandVars:
    """Vectorized equivalent of collect_cand_vars.

    The sequential merge-join reduces to key membership plus three quirks it
    inherits from the reference two-pointer (update_cand_vars_from_digar,
    src/bam_utils.c:287-327), all reproduced here:

    * shadowing: an INS/DEL site at pos P loses its alt to a ref credit when
      the read also has an X event at P-1 (or starts with a clip exactly at
      P) — the earlier event's larger key consumes the site first;
    * the ref span ends at the FIRST site (key order) whose raw pos exceeds
      the read end (the trailing loop breaks there), yet sites beyond that
      with keys below the read's maximum event key still get ref credits
      from the main loop;
    * large-INS sites (>= min_sv_len) fuzzy-match any same-anchor INS event
      within the 80% length ratio.

    Validated against the sequential implementation in
    tests/test_sites_fast.py.
    """
    cand = make_cand_vars(sites)
    n_sites = len(cand)
    if n_sites == 0:
        return cand
    sort_pos = cand.sort_pos()
    pos_arr = cand.pos
    sk = _site_key_arrays(cand)
    # big-endian packed 48-byte keys: bytes comparison == tuple comparison
    # (all columns are non-negative), so exact matches become dict lookups
    # and the kmax walk becomes a bisect
    site_kb = _pack_keys(sk)
    site_dict = {kb: i for i, kb in enumerate(site_kb)}
    large_ins_sites = np.nonzero((cand.type == CINS)
                                 & (cand.alt_len >= opt.min_sv_len))[0]
    li_pos = cand.pos[large_ins_sites]

    ref_diff = np.zeros((2, n_sites + 1), dtype=np.int64)
    alt_add = np.zeros((2, n_sites), dtype=np.int64)
    low_add = np.zeros(n_sites, dtype=np.int64)

    for ri in order:
        d = digars[ri]
        if d is None:
            continue
        strand = 1 if d.is_rev else 0
        start_i = get_site_start(sort_pos, pos_arr, d.beg)
        if start_i >= n_sites:
            continue
        # trailing break: first site (key order) with raw pos > read end
        over = pos_arr[start_i:] > d.end
        end_i = int(start_i + np.argmax(over)) if over.any() else n_sites

        kb_all = _packed_event_keys_all(d)
        ev_all = np.nonzero(d.type != CEQUAL)[0]
        # extra ref run past end_i: sites with key < the max event key
        end2_i = end_i
        if len(ev_all) and end_i < n_sites:
            import bisect
            kmax = getattr(d, "_kmax", None)
            if kmax is None:
                kmax = d._kmax = max(kb_all[i] for i in ev_all)
            end2_i = bisect.bisect_left(site_kb, kmax, end_i)

        hit_sites: List[int] = []
        low_flags: List[bool] = []
        ev_idx = np.nonzero(d.var_mask())[0]
        if len(ev_idx):
            ave_q = _ave_quals(d, ev_idx)
            is_low = d.low_qual[ev_idx] | (ave_q < opt.min_bq)
            ev_kb = [kb_all[i] for i in ev_idx]
            # shadow preconditions for this read (cached: digar-invariant)
            pre = getattr(d, "_shadow_pre", None)
            if pre is None:
                pre = d._shadow_pre = (
                    set(d.pos[(d.type == CDIFF)].tolist()),
                    len(d.type) > 0 and d.type[0] in (4, 5))
            x_pos, has_left_clip = pre

            def shadowed(si: int) -> bool:
                t = int(cand.type[si])
                if t == CDIFF:
                    return False
                P = int(cand.pos[si])
                if (P - 1) in x_pos:
                    return True
                return has_left_clip and P == d.beg

            for k, kb in enumerate(ev_kb):
                si = site_dict.get(kb)
                if si is None:
                    continue
                if len(cand.alt_seqs[si]) > 16:
                    ei = int(ev_idx[k])
                    alt = (d.alt_seq(ei).tobytes()
                           if d.type[ei] != CDEL else b"")
                    if alt != cand.alt_seqs[si]:
                        continue
                if not shadowed(si):
                    hit_sites.append(si)
                    low_flags.append(bool(is_low[k]))
            if len(large_ins_sites):
                for k in np.nonzero(d.type[ev_idx] == CINS)[0]:
                    ei = int(ev_idx[k])
                    epos = int(d.pos[ei])
                    elen = int(d.len[ei])
                    lo = int(np.searchsorted(li_pos, epos, side="left"))
                    hi = int(np.searchsorted(li_pos, epos, side="right"))
                    for si in large_ins_sites[lo:hi]:
                        salen = int(cand.alt_len[si])
                        mn, mx = min(salen, elen), max(salen, elen)
                        if mn >= mx * 0.8 and not shadowed(int(si)):
                            hit_sites.append(int(si))
                            low_flags.append(bool(is_low[k]))

        ref_diff[strand, start_i] += 1
        ref_diff[strand, end2_i] -= 1
        seen = set()
        for si, lowf in zip(hit_sites, low_flags):
            if si in seen or not (start_i <= si < end2_i):
                continue
            seen.add(si)
            ref_diff[strand, si] -= 1
            ref_diff[strand, si + 1] += 1
            if lowf:
                low_add[si] += 1
            else:
                alt_add[strand, si] += 1

    ref_counts = np.cumsum(ref_diff[:, :-1], axis=1)
    cand.low_qual_cov[:] = low_add
    cand.alle_covs[:, 0] = ref_counts.sum(axis=0)
    cand.alle_covs[:, 1] = alt_add.sum(axis=0)
    cand.total_cov[:] = cand.alle_covs.sum(axis=1)
    cand.strand_covs[:, 0, 0] = ref_counts[0]
    cand.strand_covs[:, 1, 0] = ref_counts[1]
    cand.strand_covs[:, 0, 1] = alt_add[0]
    cand.strand_covs[:, 1, 1] = alt_add[1]
    return cand
