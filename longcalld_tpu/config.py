"""Option schema for variant calling.

Mirrors the reference option surface (``call_var_opt_t``,
/root/reference/src/call_var_main.h:128-180) and its default values
(``call_var_init_para``, /root/reference/src/call_var_main.c:140-224) so that
output parity is achievable.  All tunables from the reference's
``LONGCALLD_*`` constant table (src/call_var_main.h:15-87) appear here.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

# --- constants (src/call_var_main.h:15-87) ---
MIN_CAND_MQ = 30
MIN_CAND_BQ = 10
MIN_CAND_DP = 5
MIN_ALT_DP = 2
MIN_CAND_AF = 0.20
MAX_CAND_AF = 0.80
DEF_PLOID = 2

NOISY_REG_MAX_XGAPS = 5
NOISY_REG_HIFI_SLIDE_WIN = 100
NOISY_REG_ONT_SLIDE_WIN = 25
MAX_NOISY_FRAC_PER_READ = 0.5
MAX_VAR_RATIO_PER_READ = 0.05
MAX_READ_DEPTH = 500
MAX_NOISY_REG_COV = 1000
NOISY_END_CLIP = 30
NOISY_END_CLIP_WIN = 100
NOISY_REG_MERGE_DIS = 500
NOISY_REG_FLANK_LEN = 10
MAX_NOISY_REG_LEN = 50000
MIN_NOISY_REG_SIZE_TO_SAMPLE_READS = 10000
PARTIAL_ALN_RATIO = 1.1
MIN_HAP_FULL_READS = 1
MIN_HAP_READS = 2
MIN_READ_TO_HAP_CONS_SIM = 0.9
MIN_SV_LEN = 30
MIN_TSD_LEN = 2
MAX_TSD_LEN = 100
MIN_POLYA_LEN = 10
MIN_POLYA_RATIO = 0.8
SOMATIC_WIN = 1000
SOMATIC_WIN_MAX_VARS = 5
MIN_SOMATIC_HAP_READS = 5
MIN_SOMATIC_ALT_DP = 2
MIN_SOMATIC_TE_ALT_DP = 1
MIN_SOMATIC_DIS_TO_VAR = 5
MIN_SOMATIC_DIS_TO_HP_INDEL_ERROR = 3
MIN_SOMATIC_DIS_TO_SEQ_ERROR = 5
MIN_SOMATIC_FISHER_PVAL = 0.05
STRAND_BIAS_PVAL_ONT = 0.01
SDUST_T = 5
SDUST_W = 20

# alignment scores (src/align.h:21-29)
MATCH_SCORE = 2
MISMATCH_SCORE = 6
GAP_OPEN1_SCORE = 6
GAP_EXT1_SCORE = 2
GAP_OPEN2_SCORE = 24
GAP_EXT2_SCORE = 1
GAP_LEFT_ALN = 1   # left-align gaps (minimap2/abPOA convention)
GAP_RIGHT_ALN = 2  # right-align (natural WFA2 output)

# window planning (src/bam_utils.h:9-10, src/call_var_main.c:1013)
BAM_CHUNK_REG_SIZE = 500000
REF_FLANK_LEN = 50000

# variant categories (src/collect_var.h:11-29)
NON_VAR = 0x800
LOW_COV_VAR = 0x001
STRAND_BIAS_VAR = 0x002
LOW_AF_VAR = 0x400
CLEAN_HET_SNP = 0x004
CLEAN_HET_INDEL = 0x008
REP_HET_VAR = 0x010
CAND_SOMATIC_VAR = 0x040
CLEAN_HOM_VAR = 0x080
NOISY_CAND_HET_VAR = 0x100
NOISY_CAND_HOM_VAR = 0x200

CAND_GERMLINE_VAR_CATE = (CLEAN_HET_SNP | CLEAN_HET_INDEL | CLEAN_HOM_VAR
                          | NOISY_CAND_HET_VAR | NOISY_CAND_HOM_VAR)
CAND_GERMLINE_CLEAN_VAR_CATE = CLEAN_HET_SNP | CLEAN_HET_INDEL | CLEAN_HOM_VAR
CAND_HET_VAR_CATE = CLEAN_HET_SNP | CLEAN_HET_INDEL | NOISY_CAND_HET_VAR
NOT_CAND_VAR_CATE = NON_VAR | LOW_COV_VAR | STRAND_BIAS_VAR

VAR_CATE_STR = "LBNIRXSHehl0"


def var_cate_char(cate: int) -> str:
    return VAR_CATE_STR[int(math.log2(cate))]


@dataclasses.dataclass
class CallOpts:
    """Full calling configuration; defaults == reference defaults (HiFi)."""

    # input
    ref_fa_fn: Optional[str] = None
    in_bam_fns: Sequence[str] = ()
    reg_bed_fn: Optional[str] = None
    sample_name: Optional[str] = None
    regions: Sequence[str] = ()

    is_pb_hifi: bool = True
    is_ont: bool = False
    strand_bias_pval: float = STRAND_BIAS_PVAL_ONT

    only_autosome: bool = False
    only_autosome_XY: bool = True
    exc_tnames: Sequence[str] = ()

    # filters
    max_ploid: int = DEF_PLOID
    min_mq: int = MIN_CAND_MQ
    min_bq: int = MIN_CAND_BQ
    min_dp: int = MIN_CAND_DP
    min_alt_dp: int = MIN_ALT_DP
    min_af: float = MIN_CAND_AF
    max_af: float = MAX_CAND_AF

    # somatic / mosaic
    min_somatic_dis_to_var: int = MIN_SOMATIC_DIS_TO_VAR
    min_somatic_dis_to_homopolymer_indel_error: int = MIN_SOMATIC_DIS_TO_HP_INDEL_ERROR
    min_somatic_dis_to_seq_error: int = MIN_SOMATIC_DIS_TO_SEQ_ERROR
    min_somatic_fisher_pval: float = MIN_SOMATIC_FISHER_PVAL
    min_somatic_alt_dp: int = MIN_SOMATIC_ALT_DP
    min_somatic_hap_dp: int = MIN_SOMATIC_HAP_READS
    min_somatic_te_dp: int = MIN_SOMATIC_TE_ALT_DP
    somatic_win: int = SOMATIC_WIN
    somatic_win_max_vars: int = SOMATIC_WIN_MAX_VARS

    # noisy-region parameters
    noisy_reg_max_xgaps: int = NOISY_REG_MAX_XGAPS
    noisy_reg_slide_win: int = NOISY_REG_HIFI_SLIDE_WIN
    end_clip_reg: int = NOISY_END_CLIP
    end_clip_reg_flank_win: int = NOISY_END_CLIP_WIN
    noisy_reg_merge_dis: int = NOISY_REG_MERGE_DIS
    noisy_reg_flank_len: int = NOISY_REG_FLANK_LEN
    max_noisy_reg_len: int = MAX_NOISY_REG_LEN
    max_noisy_reg_cov: int = MAX_NOISY_REG_COV
    max_var_ratio_per_read: float = MAX_VAR_RATIO_PER_READ
    max_noisy_frac_per_read: float = MAX_NOISY_FRAC_PER_READ
    min_hap_full_reads: int = MIN_HAP_FULL_READS
    min_hap_reads: int = MIN_HAP_READS

    # alignment scores
    match: int = MATCH_SCORE
    mismatch: int = MISMATCH_SCORE
    gap_open1: int = GAP_OPEN1_SCORE
    gap_ext1: int = GAP_EXT1_SCORE
    gap_open2: int = GAP_OPEN2_SCORE
    gap_ext2: int = GAP_EXT2_SCORE
    gap_aln: int = GAP_LEFT_ALN
    min_read_to_hap_cons_sim: float = MIN_READ_TO_HAP_CONS_SIM
    partial_aln_ratio: float = PARTIAL_ALN_RATIO
    min_noisy_reg_size_to_sample_reads: int = MIN_NOISY_REG_SIZE_TO_SAMPLE_READS

    # TSD / TE annotation
    min_tsd_len: int = MIN_TSD_LEN
    max_tsd_len: int = MAX_TSD_LEN
    min_polya_len: int = MIN_POLYA_LEN
    min_polya_ratio: float = MIN_POLYA_RATIO
    te_seq_fn: Optional[str] = None
    te_kmer_len: int = 15

    output_var_rnames: bool = False
    output_sv_rnames: bool = False
    output_somatic_var_rnames: bool = False

    # parallelism
    pl_threads: int = 2
    n_threads: int = 8
    host_procs: int = -1   # window-range worker PROCESSES (the kt_for
                           # analog that scales the interpreted host
                           # stages past the GIL): -1 = auto (follow -t
                           # when the stream has enough windows), 0 = off,
                           # N = exactly N workers

    # output
    min_sv_len: int = MIN_SV_LEN
    out_vcf_fn: Optional[str] = None
    out_bam_fn: Optional[str] = None
    out_is_cram: bool = False     # --out-cram: phased output as CRAM 3.0
    out_is_sam: bool = False      # -S/--out-sam: phased output as SAM text
    ref_fai_fn: Optional[str] = None  # -r/--ref-idx in the reference CLI
    # multi-host scale-out: "i/n" processes region chunks with
    # chunk_i % n == i; "auto" uses jax.process_index()/process_count().
    # Shard outputs are disjoint by region and merge losslessly
    # (`longcalld-tpu merge`).
    shard: Optional[str] = None
    # --checkpoint DIR: persist per-window VCF records + stitch-carry state;
    # a re-run with the same configuration resumes from completed windows
    # (utils/checkpoint.py; the reference has no analog — README.md:154-161
    # suggests manual --region-file sharding instead)
    checkpoint_dir: Optional[str] = None
    refine_bam: bool = False
    no_vcf_header: bool = False
    out_amb_base: bool = False
    out_somatic: bool = False

    # genotype-quality model (src/call_var_main.c:217-218).  log_2 keeps the
    # reference's hand-rounded constant 0.301023 (NOT log10(2)) for parity.
    p_error: float = 0.001
    log_p: float = -3.0
    log_1p: float = math.log10(1 - 0.001)
    log_2: float = 0.301023
    max_gq: int = 60
    max_qual: int = 60

    # window planning (LONGCALLD_BAM_CHUNK_REG_SIZE, src/bam_utils.h:10)
    window_size: int = BAM_CHUNK_REG_SIZE

    # device execution
    use_device: bool = True          # run hot kernels on the GPU via JAX
    use_device_phase: bool = True    # phasing EM as one device dispatch
                                     # (ops/phase_kernel; host oracle off)
    mesh_devices: int = 0            # >1: shard the phasing kernel's reads
                                     # axis over a dp mesh of this size
    window_devices: int = 0          # windows round-robin over this many
                                     # local devices (0 = all visible); the
                                     # kt_for-over-devices analog — each
                                     # busy window's alignment batches +
                                     # phase kernel run on its device
    device_min_cells: int | None = None  # host/device alignment routing
                                     # threshold in DP cells; None = derive
                                     # from the measured device round trip
                                     # + host aligner throughput at first
                                     # use
    stage0_workers: int = 0          # in-process stage-0 thread count
                                     # (0 = auto: min(n_threads, cpus/2))
    procs_use_device: bool = False   # per-worker device ownership: each
                                     # pool worker process keeps use_device
                                     # and launches with worker_device_env
                                     # so worker k drives card k — N
                                     # processes scale the host stages past
                                     # the GIL AND drive N cards (analog
                                     # of the reference's per-thread handle
                                     # sets, call_var_main.c:637-750); at
                                     # most one worker per visible card
    worker_device_env: str = "CUDA_VISIBLE_DEVICES={k}"
                                     # ;-separated NAME=VALUE templates
                                     # ({k} worker index, {n} pool size)
                                     # applied to each device-owning
                                     # worker's environment (the CPU test
                                     # stand-in pins JAX_PLATFORMS=cpu)

    @classmethod
    def hifi(cls, **kw) -> "CallOpts":
        """--hifi preset (src/call_var_main.c:113-118)."""
        kw.setdefault("is_pb_hifi", True)
        kw.setdefault("is_ont", False)
        kw.setdefault("noisy_reg_max_xgaps", NOISY_REG_MAX_XGAPS)
        kw.setdefault("noisy_reg_slide_win", NOISY_REG_HIFI_SLIDE_WIN)
        return cls(**kw)

    @classmethod
    def ont(cls, **kw) -> "CallOpts":
        """--ont preset (src/call_var_main.c:120-126)."""
        kw.setdefault("is_pb_hifi", False)
        kw.setdefault("is_ont", True)
        kw.setdefault("strand_bias_pval", STRAND_BIAS_PVAL_ONT)
        kw.setdefault("noisy_reg_max_xgaps", NOISY_REG_MAX_XGAPS)
        kw.setdefault("noisy_reg_slide_win", NOISY_REG_ONT_SLIDE_WIN)
        return cls(**kw)
