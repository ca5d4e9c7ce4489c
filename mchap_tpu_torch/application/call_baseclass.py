"""Loci stream for known-haplotype callers; reference call_baseclass.py.

Port of ``mchap_tpu/application/call_baseclass.py``.
"""

from dataclasses import dataclass

from mchap_tpu_torch.application import baseclass
from mchap_tpu_torch.io.loci import LocusPrior
from mchap_tpu_torch.io.vcflite import VariantFile


@dataclass
class program(baseclass.program):
    prior_frequencies_tag: str = None
    filter_input_haplotypes: str = None

    def loci(self):
        with VariantFile(self.vcf) as f:
            for record in f.fetch():
                yield LocusPrior.from_variant_record(
                    record,
                    frequency_tag=self.prior_frequencies_tag,
                    allele_filter=self.filter_input_haplotypes,
                )
