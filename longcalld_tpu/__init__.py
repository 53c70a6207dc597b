"""longcalld_tpu: a JAX long-read small + structural variant caller.

A from-scratch re-design of the capabilities of longcallD (local-haplotagging
based small/structural variant calling for PacBio HiFi and ONT long reads) for
an NVIDIA GPU driven from JAX: the hot compute (phasing EM fixpoint, banded
affine alignment) runs on the device as jitted JAX/XLA (jnp + lax control
flow) over batched fixed-shape windows, while host code (Python + C
extensions) handles BAM/FASTA/VCF I/O, window planning and the
deterministic cross-window stitch reduction.  On the CPU the same device
stages run through XLA's CPU backend.

Reference behavior parity target: longcallD v0.0.11 (see SURVEY.md).
"""

__version__ = "0.1.0"

from longcalld_tpu.config import CallOpts  # noqa: F401
