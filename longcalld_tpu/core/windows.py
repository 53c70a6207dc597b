"""Genomic window planning.

Mirrors collect_regions (/root/reference/src/call_var_main.c:561-634): the
genome (or explicit regions / BED) is cut into <=500 kb windows, grouped into
"region chunks" (one per chromosome for whole-genome runs).  Windows are the
unit of data parallelism — they round-robin over the local devices.
"""

from __future__ import annotations

import dataclasses
import re
from typing import List, Optional, Sequence, Tuple

from longcalld_tpu.config import BAM_CHUNK_REG_SIZE, CallOpts


@dataclasses.dataclass(frozen=True)
class Window:
    tid: int
    tname: str
    beg: int  # 1-based inclusive
    end: int  # 1-based inclusive
    chunk_i: int  # region-chunk index
    reg_i: int    # index within the chunk (stitch neighbours: reg_i-1/reg_i+1)


def classify_chromosome(chrom: str) -> str:
    """'autosome' | 'sex' | 'other' (src/call_var_main.c:411-446)."""
    name = chrom.split(":")[0]
    if name.startswith("chr"):
        name = name[3:]
    if name in ("X", "Y"):
        return "sex"
    if name in ("MT", "M"):
        return "other"
    if re.fullmatch(r"\d+", name) and int(name) >= 1:
        return "autosome"
    return "other"


def skip_target(opt: CallOpts, tname: str) -> bool:
    t = classify_chromosome(tname)
    if opt.only_autosome and t != "autosome":
        return True
    if opt.only_autosome_XY and t not in ("autosome", "sex"):
        return True
    if tname in opt.exc_tnames:
        return True
    return False


def _parse_region(reg: str, references: Sequence[str],
                  lengths: Sequence[int]) -> Optional[Tuple[int, int, int]]:
    """'chr:beg-end' / 'chr:beg' / 'chr' -> (tid, beg1, end1)."""
    m = re.fullmatch(r"([^:]+)(?::([\d,]+)(?:-([\d,]+))?)?", reg)
    if not m:
        return None
    name = m.group(1)
    if name not in references:
        return None
    tid = references.index(name)
    beg = int(m.group(2).replace(",", "")) if m.group(2) else 1
    end = int(m.group(3).replace(",", "")) if m.group(3) else lengths[tid]
    return tid, max(1, beg), min(end, lengths[tid])


def plan_windows(opt: CallOpts, references: Sequence[str],
                 lengths: Sequence[int],
                 min_reg_chunks_per_run: int = 32,
                 max_reg_len: int = BAM_CHUNK_REG_SIZE,
                 busy_fn=None, chunk_filter=None,
                 stats: Optional[dict] = None) -> List[Window]:
    """Produce the ordered window list.

    Whole-genome mode filters contigs by autosome/XY policy; explicit regions
    or a BED file disable that filter, exactly like the reference
    (src/call_var_main.c:574-596).

    ``busy_fn(tid, begs0, ends) -> bool mask``, when given, drops windows it
    proves read-free BEFORE any Window object is built — whole-genome plans
    are millions of windows of which almost all are empty, and materializing
    them only to filter dominated run_call startup.  ``reg_i`` keeps the
    unfiltered numbering so stitch identity is unchanged.

    ``chunk_filter(chunk_i) -> bool``, when given, keeps only the selected
    region chunks (multi-host sharding): the chunk numbering is preserved,
    and the busy scan is skipped entirely for foreign chunks so each shard
    only pays for its own slice of the genome.

    ``stats``, when given, is filled with ``n_planned`` (pre-busy-filter
    window count over kept chunks), ``n_dropped`` (windows the index proved
    read-free) and ``busy_errors`` (chunks whose busy_fn raised) so the
    caller can log the accounting.
    """
    regions: List[Tuple[int, int, int]] = []
    if opt.regions:
        for reg in opt.regions:
            parsed = _parse_region(reg, references, lengths)
            if parsed is not None and not skip_target(
                    dataclasses.replace(opt, only_autosome=False,
                                        only_autosome_XY=False),
                    references[parsed[0]]):
                regions.append(parsed)
    elif opt.reg_bed_fn:
        with open(opt.reg_bed_fn) as f:
            for line in f:
                if line.startswith("#"):
                    continue
                parts = line.rstrip("\n").split("\t")
                if not parts or parts[0] not in references:
                    continue
                tid = references.index(parts[0])
                beg = int(parts[1]) + 1 if len(parts) > 1 else 1
                end = int(parts[2]) if len(parts) > 2 else lengths[tid]
                if beg > end or beg <= 0 or end <= 0:
                    continue
                regions.append((tid, beg, min(end, lengths[tid])))
    else:
        for tid, (tname, tlen) in enumerate(zip(references, lengths)):
            if skip_target(opt, tname):
                continue
            regions.append((tid, 1, tlen))

    import numpy as np
    windows: List[Window] = []
    n_planned = n_dropped = busy_errors = 0
    busy_warned = False
    for chunk_i, (tid, beg, end) in enumerate(regions):
        # one region chunk per requested region/contig: stitching (and
        # therefore shard boundaries, see run_call) never crosses chunks
        if chunk_filter is not None and not chunk_filter(chunk_i):
            continue
        n_regs = (end - beg + max_reg_len) // max_reg_len
        ks = np.arange(n_regs, dtype=np.int64)
        wbegs = beg + ks * max_reg_len
        wends = np.minimum(wbegs + max_reg_len - 1, end)
        n_planned += len(ks)
        if busy_fn is not None:
            try:
                mask = np.asarray(busy_fn(tid, wbegs - 1, wends), dtype=bool)
                n_dropped += int((~mask).sum())
                ks, wbegs, wends = ks[mask], wbegs[mask], wends[mask]
            except Exception as e:
                # keep every window of this chunk (correct fallback), but
                # surface the degradation: a broken index otherwise turns
                # into a silent whole-genome scan
                busy_errors += 1
                if not busy_warned:
                    busy_warned = True
                    from longcalld_tpu.utils import log
                    log.warning("plan_windows",
                                f"window-emptiness index scan failed for "
                                f"{references[tid]} ({type(e).__name__}: "
                                f"{e}); processing every window of the "
                                "affected chunks")
        tname = references[tid]
        windows.extend(Window(tid, tname, int(b), int(e), chunk_i, int(k))
                       for k, b, e in zip(ks, wbegs, wends))
    if stats is not None:
        stats["n_planned"] = n_planned
        stats["n_dropped"] = n_dropped
        stats["busy_errors"] = busy_errors
    return windows
