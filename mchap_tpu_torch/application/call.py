"""``mchap call``: MCMC genotype calling over known haplotypes.

Reference: mchap/application/call.py; port of
``mchap_tpu/application/call.py``.  At the defaults (flat prior, Gibbs)
every (locus, sample) problem of a block runs through one launch of the
calling sampler (K2, ``ops/cuda_calling.py``); ``--use-dirmul-prior``
runs the batched torch sampler (``ops/calling_mcmc.py``).  A failed block
fails the run: nothing falls back.
"""

import argparse
import sys
from dataclasses import dataclass

from mchap_tpu_torch.application import call_baseclass
from mchap_tpu_torch.application.arguments import (
    CALL_MCMC_PARSER_ARGUMENTS,
    collect_call_mcmc_program_arguments,
)
from mchap_tpu_torch.application.baseclass import sample_errors
from mchap_tpu_torch.models.calling import fit_calling_multi, zero_variant_trace
from mchap_tpu_torch.utils import timing
from mchap_tpu_torch.utils.device import resolve_device


@dataclass
class program(call_baseclass.program):
    mcmc_chains: int = 1
    mcmc_steps: int = 2000
    mcmc_burn: int = 1000
    mcmc_incongruence_threshold: float = 0.60

    @classmethod
    def cli(cls, command):
        parser = argparse.ArgumentParser("MCMC haplotype calling")
        for arg in CALL_MCMC_PARSER_ARGUMENTS:
            arg.add_to(parser)
        if len(command) < 3:
            parser.print_help()
            sys.exit(1)
        args = parser.parse_args(command[2:])
        arguments = collect_call_mcmc_program_arguments(args)
        arguments["device"] = resolve_device(arguments["device"])
        return cls(cli_command=command, **arguments)

    def _fit_block(self, prepared):
        """Every (locus, sample) problem of the block padded into one
        ``fit_calling_multi`` call per ploidy group.  A locus without
        SNVs takes the constant zero-variant trace, with no launch; a
        filtered locus takes nothing.  Returns each locus's unburnt
        traces by sample."""
        traces = {}
        groups = {}
        for idx, (data, setup) in enumerate(prepared):
            if setup is None:
                continue
            if setup["mcmc_haplotypes"].shape[1] == 0:
                traces[idx] = {
                    sample: zero_variant_trace(
                        self.mcmc_chains, self.mcmc_steps, data.sample_ploidy[sample]
                    )
                    for sample in data.samples
                }
                continue
            for sample in data.samples:
                problem = dict(
                    reads=data.read_dists[sample],
                    counts=data.read_counts[sample],
                    haplotypes=setup["mcmc_haplotypes"],
                )
                if data.sample_inbreeding is not None:
                    problem["inbreeding"] = data.sample_inbreeding[sample]
                    problem["frequencies"] = setup["mcmc_prior_frequencies"]
                groups.setdefault(data.sample_ploidy[sample], []).append(
                    (idx, sample, problem)
                )

        for ploidy, items in groups.items():
            fitted = fit_calling_multi(
                [p for _, _, p in items],
                ploidy,
                steps=self.mcmc_steps,
                chains=self.mcmc_chains,
                random_seed=self.random_seed,
                burn=self.mcmc_burn,
                device=self.device,
            )
            timing.count(
                "sampler.steps",
                len(items) * self.mcmc_chains * self.mcmc_steps
            )
            for (idx, sample, _), t in zip(items, fitted):
                traces.setdefault(idx, {})[sample] = t
        return traces

    def _finish_locus(self, data, setup, traces):
        """Each sample's fields from its trace; a filtered locus was
        filled by ``_setup_locus``."""
        if setup is None:
            return
        for sample in data.samples:
            with sample_errors(sample):
                trace = traces[sample].burn(self.mcmc_burn)
                self._finish_sample(data, sample, trace, setup)
