"""mchap_tpu_torch — the PyTorch/CUDA port of ``mchap_tpu``.

Micro-haplotype assembly and genotype calling in autopolyploids (MCHap),
with each sampler step in a hand-written CUDA kernel for NVIDIA Hopper
(``csrc/``).  The package never imports JAX or ``mchap_tpu``; the host IO
and encoding modules are copies of ``mchap_tpu``'s
(tests/test_torch_port_hygiene.py keeps them in sync).

Public API as ``mchap_tpu/__init__.py``'s (reference ``mchap/__init__.py``):
``DenovoMCMC``, ``CallingMCMC``, ``PedigreeCallingMCMC``,
``Locus``/``LocusPrior``/``SNP``, ``read_bed4``, the read extraction and
encoding helpers, ``combinatorics`` and ``mset``; the ``mchap`` CLI is
``python -m mchap_tpu_torch``.
"""

__version__ = "0.1.0"

from mchap_tpu_torch import mset  # noqa: E402,F401
from mchap_tpu_torch.encoding.integer import (  # noqa: E402,F401
    kmer_representation,
    minimum_error_correction,
)
from mchap_tpu_torch.io.bam import (  # noqa: E402,F401
    encode_read_alleles,
    encode_read_distributions,
    extract_read_variants,
    extract_sample_ids,
)
from mchap_tpu_torch.io.bed import read_bed4  # noqa: E402,F401
from mchap_tpu_torch.io.loci import SNP, Locus, LocusPrior  # noqa: E402,F401
from mchap_tpu_torch.models.assemble import DenovoMCMC  # noqa: E402,F401
from mchap_tpu_torch.models.calling import CallingMCMC  # noqa: E402,F401
from mchap_tpu_torch.models.pedigree import PedigreeCallingMCMC  # noqa: E402,F401
from mchap_tpu_torch.numerics import combinadics as combinatorics  # noqa: E402,F401

__all__ = [
    "DenovoMCMC",
    "CallingMCMC",
    "PedigreeCallingMCMC",
    "Locus",
    "LocusPrior",
    "SNP",
    "combinatorics",
    "read_bed4",
    "extract_sample_ids",
    "extract_read_variants",
    "encode_read_alleles",
    "encode_read_distributions",
    "minimum_error_correction",
    "kmer_representation",
    "mset",
    "__version__",
]
