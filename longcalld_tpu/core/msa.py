"""Star-MSA consensus: the batch-friendly replacement for abPOA.

The reference uses abPOA's adaptive-band partial-order alignment for noisy
regions (abpoa_partial_aln_msa_cons / abpoa_aln_msa_cons,
/root/reference/src/align.c:762-943).  Its *output contract* — n_cons (1-2),
per-cluster read ids, per-read MSA rows and consensus rows — is what the
caller consumes; this module reproduces that contract with a star MSA:

1. backbone = first read (sorted best-cover/longest, like abPOA's seeding);
2. every other read is aligned pairwise to the backbone with the
   gap-affine-2p aligner (partial-cover reads get prefix/suffix alignment
   with the reference's 1.1 length-ratio trim);
3. alignments are projected onto shared columns (backbone base columns +
   per-position insertion slots, insertions left-aligned);
4. consensus = column-majority over covering reads (ABPOA_MF analog);
5. optional 2-cluster mode: reads are bipartitioned over "informative"
   columns (minor allele count >= 2 and frequency >= min_freq) with a small
   k-means, then per-cluster consensus columns are re-voted.

Device-placement rationale: the FLOPs of this stage are the pairwise
alignments of step 2, and those already ride the batched device/host
aligner (ops/wfa.py routing).  The remaining column projection + majority
vote is O(reads x columns) on ragged, window-sized data — small next to
a device dispatch — so it stays in numpy.

Measured refutation of an iterate-once re-vote pass (round-4 review item
6 asked for a heaviest-bundle-style re-vote): on the 74 real HG002 per-hap
consensus calls of tests/test_poa_oracle_real.py, re-aligning every read
to the first-pass consensus and re-voting is a NO-OP on 73/74 calls (the
star consensus is already a fixpoint of realign+majority), and on the one
call it changes (region 66) it converges to the exact-POA oracle's answer
whose mean read distance is 8x WORSE (66.2 -> 521.2).  The oracle-vs-star
divergences are all on the oracle's side: in every one of the 8 divergent
calls the star consensus is byte-equal to the MODAL read string (a strict
>=60% byte-identical majority in 6/8) while the oracle's column-majority
over exact-POA rows never is — asserted as the oracle test's contract.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np

from longcalld_tpu.config import CallOpts
from longcalld_tpu.core.align_screen import edit_xgaps_nw
from longcalld_tpu.ops.affine_align import align_affine2p

GAP = 5
NOCOV = 6  # column not covered by the read (outside its span)

# cover flags (src/align.h:6-18)
LEFT_COVER = 0x1
RIGHT_COVER = 0x2
LEFT_GAP = 0x4
RIGHT_GAP = 0x8
BOTH_COVER = LEFT_COVER | RIGHT_COVER


def is_both_cover(c: int) -> bool:
    return (c & BOTH_COVER) == BOTH_COVER


def is_left_cover(c: int) -> bool:
    return bool(c & LEFT_COVER)


def is_right_cover(c: int) -> bool:
    return bool(c & RIGHT_COVER)


class MsaResult(NamedTuple):
    n_cons: int
    cons_seqs: List[np.ndarray]        # nt4, per cluster
    clu_read_idx: List[np.ndarray]     # indices into the input read list
    msa_rows: np.ndarray               # (n_reads, n_cols) uint8 incl. NOCOV
    cons_rows: List[np.ndarray]        # per-cluster consensus row (n_cols)
    included: np.ndarray               # bool, reads that made it into the MSA


def _trim_request(opt: CallOpts, backbone: np.ndarray, read: np.ndarray,
                  left_to_right: bool):
    """Build the trimmed (t, q) pair for a partial read's anchor alignment
    (cal_wfa_partial_aln_beg_end head, align.c:667-689).  Returns
    (t, q, t_off, q_off) or None if the equal-length screen fails."""
    ratio = opt.partial_aln_ratio
    tlen, qlen = len(backbone), len(read)
    t_off = q_off = 0
    t = backbone
    q = read
    if left_to_right:
        if tlen > qlen * ratio:
            t = backbone[:int(qlen * ratio)]
        elif qlen > tlen * ratio:
            q = read[:int(tlen * ratio)]
    else:
        if tlen > qlen * ratio:
            t_off = tlen - int(qlen * ratio)
            t = backbone[t_off:]
        elif qlen > tlen * ratio:
            q_off = qlen - int(tlen * ratio)
            q = read[q_off:]
    if min(len(t), len(q)) == 0:
        return None
    return t, q, t_off, q_off


def _span_from_trim_aln(cigar: np.ndarray, t_off: int, q_off: int,
                        t_total: int, q_total: int, left_to_right: bool
                        ) -> Tuple[int, int, int, int]:
    """Aligned span bounded by the last/first run of matches
    (collect_aln_beg_end, align.c:630-663)."""
    if left_to_right:
        tpos = qpos = 0
        b_end = r_end = 0
        for op, ln in cigar:
            if op == 7:
                b_end = tpos + ln
                r_end = qpos + ln
            if op in (7, 8, 2):
                tpos += ln
            if op in (7, 8, 1):
                qpos += ln
        return (0, int(b_end), 0, int(r_end))
    tpos, qpos = t_total, q_total
    b_beg, r_beg = 0, 0
    for op, ln in cigar[::-1]:
        if op == 7:
            b_beg = tpos - ln
            r_beg = qpos - ln
        if op in (7, 8, 2):
            tpos -= ln
        if op in (7, 8, 1):
            qpos -= ln
    return (t_off + int(b_beg), t_off + t_total, q_off + int(r_beg),
            q_off + q_total)


def _compute_backbone_alignments(opt: CallOpts, seqs, covers, sampling: bool):
    """Batched read->backbone alignments (collect_partial_aln_beg_end
    semantics, align.c:709-745), as a coroutine.

    Yields (pairs, left_align) requests and receives result lists via
    .send(); the driver (core.noisy) batches requests across all regions of
    a window into a handful of device calls.  Returns per-read
    (b_beg, b_end, r_beg, r_end, cigar) or None.  Screens use the affine
    path's xgaps instead of a separate edit-distance pass.
    """
    n = len(seqs)
    backbone = seqs[0]
    results = [None] * n
    full_pairs = []     # (idx)
    part_req = []       # (idx, left_to_right, t, q, t_off, q_off)
    for i in range(1, n):
        rc = int(covers[i])
        full_like = (is_both_cover(rc)
                     or (is_left_cover(rc) and (rc & RIGHT_GAP))
                     or (is_right_cover(rc) and (rc & LEFT_GAP)))
        if is_both_cover(int(covers[0])) and full_like:
            # sampling mode screens full-cover reads at 10% edit xgaps
            # before any alignment (collect_partial_aln_beg_end,
            # align.c:721-731)
            if sampling and edit_xgaps_nw(backbone, seqs[i]) > min(
                    len(backbone), len(seqs[i])) * 0.10:
                continue
            full_pairs.append(i)
        elif is_left_cover(rc) or is_right_cover(rc):
            ltr = is_left_cover(rc)
            req = _trim_request(opt, backbone, seqs[i], ltr)
            if req is None:
                continue
            t, q = req[0], req[1]
            # equal-length anchored-end screen at 10% edit xgaps
            # (cal_wfa_partial_aln_beg_end, align.c:693-700)
            k = min(len(t), len(q))
            ts, qs = (t[:k], q[:k]) if ltr else (t[-k:], q[-k:])
            if edit_xgaps_nw(ts, qs) > k * 0.10:
                continue
            part_req.append((i, ltr, *req))
    # round 1, fused: full alignments + partial anchor alignments of BOTH
    # gap conventions in ONE submit with per-pair flags (left-to-right
    # extension flips the convention, align.c:687-689): one device round
    # trip instead of three.
    part_left_align = [(not ltr) for (_, ltr, *_r) in part_req]
    pairs_part = [(t, q) for (_, _, t, q, _, _) in part_req]
    pairs_all = [(backbone, seqs[i]) for i in full_pairs] + pairs_part
    flags_all = [opt.gap_aln == 1] * len(full_pairs) + part_left_align
    res_all = yield (pairs_all, flags_all)
    full_res = res_all[:len(full_pairs)]
    res_part = res_all[len(full_pairs):]
    for i, res in zip(full_pairs, full_res):
        results[i] = (0, len(backbone), 0, len(seqs[i]), res.cigar)
    # round 2: re-align partial reads on their anchored spans
    span_req = []
    for (idx, ltr, t, q, t_off, q_off), res in zip(part_req, res_part):
        b_beg, b_end, r_beg, r_end = _span_from_trim_aln(
            res.cigar, t_off, q_off, len(t), len(q), ltr)
        if b_end <= b_beg or r_end <= r_beg:
            continue
        span_req.append((idx, b_beg, b_end, r_beg, r_end))
    sub = yield ([(backbone[b0:b1], seqs[idx][r0:r1])
                  for idx, b0, b1, r0, r1 in span_req], opt.gap_aln == 1)
    for (idx, b0, b1, r0, r1), res in zip(span_req, sub):
        results[idx] = (b0, b1, r0, r1, res.cigar)
    return results


def star_msa(opt: CallOpts, seqs: List[np.ndarray], covers: List[int],
             max_n_cons: int, sampling: bool = False,
             min_freq: Optional[float] = None):
    """Build the MSA + consensus for one noisy region (read 0 = backbone).

    Coroutine: yields alignment requests (see _compute_backbone_alignments),
    returns Optional[MsaResult].
    """
    n = len(seqs)
    if n == 0:
        return None
    min_freq = opt.min_af if min_freq is None else min_freq
    backbone = seqs[0]
    blen = len(backbone)
    if blen == 0:
        return None

    # per-read backbone-projected rows: base at backbone pos (or GAP) and
    # insertions after each backbone pos (index 0 = before backbone pos 0)
    base_rows = np.full((n, blen), NOCOV, dtype=np.uint8)
    # sparse: {backbone_pos: inserted bases}; index 0 = before pos 0
    ins_after: List[dict] = [{} for _ in range(n)]
    included = np.zeros(n, dtype=bool)
    spans = np.zeros((n, 2), dtype=np.int64)

    base_rows[0] = backbone
    included[0] = True
    spans[0] = (0, blen)

    alns = yield from _compute_backbone_alignments(opt, seqs, covers,
                                                   sampling)
    for i in range(1, n):
        aln = alns[i]
        if aln is None:
            continue
        b_beg, b_end, r_beg, r_end, cigar = aln
        included[i] = True
        spans[i] = (b_beg, b_end)
        bp, rp = b_beg, r_beg
        read = seqs[i]
        for op, ln in cigar:
            ln = int(ln)
            if op in (7, 8):
                base_rows[i, bp:bp + ln] = read[rp:rp + ln]
                bp += ln
                rp += ln
            elif op == 2:  # deletion: gap in read over backbone bases
                base_rows[i, bp:bp + ln] = GAP
                bp += ln
            elif op == 1:  # insertion before backbone position bp
                ins_after[i][bp] = read[rp:rp + ln]
                rp += ln

    inc_idx = np.nonzero(included)[0]
    if len(inc_idx) == 0:
        return None

    # column layout: for each backbone slot 0..blen: ins columns then base
    max_ins = np.zeros(blen + 1, dtype=np.int64)
    for i in inc_idx:
        for b, v in ins_after[i].items():
            if len(v) > max_ins[b]:
                max_ins[b] = len(v)
    n_cols = int(max_ins.sum()) + blen
    # col_of_base[b] = sum(max_ins[:b+1]) + b (ins block sits before base)
    col_of_base = np.cumsum(max_ins[:blen]) + np.arange(blen, dtype=np.int64)
    ins_col_start = col_of_base - max_ins[:blen]  # ins block before base b

    rows = np.full((n, n_cols), NOCOV, dtype=np.uint8)
    for i in inc_idx:
        s, e = spans[i]
        cs = int(ins_col_start[s]) if s < blen else n_cols
        ce = int(col_of_base[e - 1]) + 1 if e > 0 else 0
        rows[i, cs:ce] = GAP
        rows[i, col_of_base[s:e]] = base_rows[i, s:e]
        for b, v in ins_after[i].items():
            start = (int(ins_col_start[b]) if b < blen
                     else n_cols - int(max_ins[blen]))
            rows[i, start:start + len(v)] = v

    def column_consensus(sub_rows: np.ndarray) -> np.ndarray:
        """Majority symbol per column over covering reads (ABPOA_MF
        analog); ties prefer the smaller symbol, gap-only -> GAP."""
        counts = np.zeros((7, n_cols), dtype=np.int32)
        for sym in range(6):
            counts[sym] = (sub_rows == sym).sum(axis=0)
        best = counts[:6].argmax(axis=0).astype(np.uint8)
        covered = counts[:6].sum(axis=0) > 0
        return np.where(covered, best, GAP).astype(np.uint8)

    if max_n_cons >= 2 and len(inc_idx) >= 2 * opt.min_hap_reads:
        clusters = _bipartition(rows[inc_idx], min_freq)
    else:
        clusters = None

    if clusters is None:
        cons_row = column_consensus(rows[inc_idx])
        cons_seq = cons_row[cons_row != GAP]
        return MsaResult(1, [cons_seq], [inc_idx], rows, [cons_row], included)

    c1, c2 = clusters
    groups = [inc_idx[c1], inc_idx[c2]]
    cons_rows = [column_consensus(rows[g]) for g in groups]
    cons_seqs = [r[r != GAP] for r in cons_rows]
    return MsaResult(2, cons_seqs, groups, rows, cons_rows, included)


def _bipartition(rows: np.ndarray, min_freq: float
                 ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """2-cluster split over informative columns; None if no diploid signal
    (abPOA max_n_cons=2 min_freq analog)."""
    n, n_cols = rows.shape
    counts = np.zeros((6, n_cols), dtype=np.int32)
    for sym in range(6):
        counts[sym] = (rows == sym).sum(axis=0)
    cov = counts.sum(axis=0)
    order = np.argsort(-counts, axis=0, kind="stable")
    top = np.take_along_axis(counts, order[:2], axis=0)
    minor = top[1]
    informative = (minor >= 2) & (cov > 0) & (minor >= min_freq * cov)
    info_cols = np.nonzero(informative)[0]
    if len(info_cols) == 0:
        return None
    sub = rows[:, info_cols]
    maj = order[0][info_cols].astype(np.uint8)
    mnr = order[1][info_cols].astype(np.uint8)
    # reads vote per column: +1 major, -1 minor
    votes = np.where(sub == maj[None, :], 1,
                     np.where(sub == mnr[None, :], -1, 0))
    # seed: split on the column with the strongest minor count
    seed_col = int(np.argmax(minor[info_cols]))
    assign = votes[:, seed_col] < 0  # True -> cluster 2
    for _ in range(10):
        c1 = ~assign
        if c1.sum() == 0 or assign.sum() == 0:
            break
        prof1 = np.sign(votes[c1].sum(axis=0))
        prof2 = np.sign(votes[assign].sum(axis=0))
        s1 = votes @ prof1
        s2 = votes @ prof2
        new_assign = s2 > s1
        if (new_assign == assign).all():
            break
        assign = new_assign
    n2 = int(assign.sum())
    n1 = n - n2
    if n1 == 0 or n2 == 0 or min(n1, n2) < max(2, int(min_freq * n)):
        return None
    return ~assign, assign
