"""CLI flag definitions and argument collectors for the six tools.

Port of ``mchap_tpu/application/arguments.py``, with ``--device``.
Mirrors the flag surface of reference ``mchap/application/arguments.py``
(same flag names, arities, and defaults — see docs/cli-*-help.txt in the
reference), including the recurring convention that every per-sample
scalar parameter accepts either a literal value or a sample<TAB>value
file.
"""

import copy
import os
from dataclasses import dataclass

from mchap_tpu_torch.constant import PFEIFFER_ERROR
from mchap_tpu_torch.io import vcf as VCF
from mchap_tpu_torch.io.bam import extract_sample_ids
from mchap_tpu_torch.io.bamlite import AlignmentFile


@dataclass
class Argument:
    cli: str
    kwargs: dict

    def add_to(self, parser):
        raise NotImplementedError


@dataclass
class Parameter(Argument):
    def add_to(self, parser):
        parser.add_argument(self.cli, **copy.deepcopy(self.kwargs))
        return parser


@dataclass
class BooleanFlag(Argument):
    def add_to(self, parser):
        dest = self.kwargs["dest"]
        action = self.kwargs["action"]
        if action == "store_true":
            default = False
        elif action == "store_false":
            default = True
        else:
            raise ValueError('Action must be "store_true" or "store_false".')
        parser.set_defaults(**{dest: default})
        parser.add_argument(self.cli, **self.kwargs)
        return parser


def _p(cli, **kwargs):
    return Parameter(cli, kwargs)


haplotypes = _p(
    "--haplotypes", type=str, nargs=1, default=[None],
    help="VCF file of known haplotype/MNP/SNP variants to re-call among input samples.",
)
region = _p(
    "--region", type=str, nargs=1, default=[None],
    help="Single target region 'contig:start-stop' (one output variant); "
    "cannot be combined with --targets.",
)
region_id = _p(
    "--region-id", type=str, nargs=1, default=[None],
    help="Identifier reported in the output VCF for the --region locus.",
)
targets = _p(
    "--targets", type=str, nargs=1, default=[None],
    help="BED file of target intervals (contig, start, stop[, id]); "
    "cannot be combined with --region.",
)
variants = _p(
    "--variants", type=str, nargs=1, default=[None],
    help="VCF file of SNP variants used for assembly; haplotypes are built "
    "from the ref/alt alleles in this file.",
)
reference = _p(
    "--reference", type=str, nargs=1, default=[None],
    help="Indexed FASTA file of the reference genome.",
)
bam = _p(
    "--bam", type=str, nargs="+", default=[],
    help="BAM file(s): a list of paths, a text file of paths (one per line), "
    "or a text file of sample<TAB>path pairs.",
)
ploidy = _p(
    "--ploidy", type=str, nargs=1, default=["2"],
    help="Sample ploidy (default = 2): one integer for all samples or a "
    "sample<TAB>ploidy file.",
)
dirmul_prior = _p(
    "--use-dirmul-prior", type=str, nargs=2, default=[None, None],
    help="Dirichlet-multinomial prior: (1) inbreeding coefficient (value in "
    "[0,1] or sample<TAB>value file) and (2) INFO field of length 'R' "
    "holding prior allele frequencies (normalized automatically).",
)
assembly_dirmul_prior = _p(
    "--use-dirmul-prior", type=str, nargs=1, default=[None],
    help="(Not recommended; backwards compatibility.) Replace the flat "
    "genotype prior with a Dirichlet-multinomial prior assuming all "
    "possible haplotypes are equally probable. Takes an inbreeding "
    "coefficient in [0,1] or a sample<TAB>value file.",
)
prior_frequencies = _p(
    "--prior-frequencies", type=str, nargs=1, default=[None],
    help="INFO field of the input VCF to use as prior allele frequencies "
    "(numerical, length 'R'; normalized automatically).",
)
sample_parents = _p(
    "--sample-parents", type=str, nargs=1, default=[None],
    help="Pedigree file: sample<TAB>parent1<TAB>parent2 per line; '.' marks "
    "an unknown parent.",
)
gamete_ploidy = _p(
    "--gamete-ploidy", type=str, nargs=1, default=[None],
    help="Ploidy of gametes contributing to each sample (default: half the "
    "sample ploidy): one integer or a sample<TAB>tau_p<TAB>tau_q file.",
)
gamete_ibd = _p(
    "--gamete-ibd", type=str, nargs=1, default=["0.0"],
    help="Excess IBD of gametes (diploid gametes only), in [0,1]: one value "
    "or a sample<TAB>lambda_p<TAB>lambda_q file (default = 0.0).",
)
gamete_error = _p(
    "--gamete-error", type=str, nargs=1, default=["0.01"],
    help="Probability a gamete was not derived from the specified parent, in "
    "[0,1]: one value or a sample<TAB>err_p<TAB>err_q file (default = 0.01).",
)
sample_pool = _p(
    "--sample-pool", type=str, nargs=1, default=[None],
    help="(Experimental.) Pool samples into combined genotypes: one pool "
    "name for all samples or a sample<TAB>pool file.",
)
base_error_rate = _p(
    "--base-error-rate", nargs=1, type=float, default=[PFEIFFER_ERROR],
    help="Expected base error rate of reads (default = {}, Pfeiffer et al "
    "2018).".format(PFEIFFER_ERROR),
)
ignore_base_phred_scores = BooleanFlag(
    "--use-base-phred-scores",
    dict(
        dest="ignore_base_phred_scores",
        action="store_false",
        help="Flag: combine per-base phred scores with --base-error-rate as "
        "the per-call error rate.",
    ),
)
haplotype_posterior_threshold = _p(
    "--haplotype-posterior-threshold", type=float, nargs=1, default=[0.20],
    help="Posterior probability (of occurring with one or more copies in any "
    "individual) required to report a haplotype as an alternate allele "
    "(default = 0.20).",
)
filter_input_haplotypes = _p(
    "--filter-input-haplotypes", type=str, nargs=1, default=[None],
    help="Filter input haplotypes with '<field><operator><value>' where "
    "<field> is a numerical INFO field of length 'A' or 'R'.",
)
_optional_field_descriptions = [
    "INFO/{} = {}".format(f.id, f.descr) for f in VCF.INFO_OPTIONAL_FIELDS
] + [
    "FORMAT/{}: {}".format(f.id, f.descr) for f in VCF.FORMAT_OPTIONAL_FIELDS
]
report = _p(
    "--report", type=str, nargs="*", default=[],
    help="Extra fields to report in the output VCF (INFO/FORMAT prefix "
    "optional, matching both when omitted). Options: "
    + "; ".join(_optional_field_descriptions),
)
mapping_quality = _p(
    "--mapping-quality", nargs=1, type=int, default=[20],
    help="Minimum mapping quality of reads used in assembly (default = 20).",
)
skip_duplicates = BooleanFlag(
    "--keep-duplicate-reads",
    dict(dest="skip_duplicates", action="store_false",
         help="Flag: keep reads marked as duplicates (skipped by default)."),
)
skip_qcfail = BooleanFlag(
    "--keep-qcfail-reads",
    dict(dest="skip_qcfail", action="store_false",
         help="Flag: keep reads marked as qcfail (skipped by default)."),
)
skip_supplementary = BooleanFlag(
    "--keep-supplementary-reads",
    dict(dest="skip_supplementary", action="store_false",
         help="Flag: keep reads marked as supplementary (skipped by default)."),
)
mcmc_chains = _p(
    "--mcmc-chains", type=int, nargs=1, default=[2],
    help="Number of independent MCMC chains per assembly (default = 2).",
)
mcmc_temperatures = _p(
    "--mcmc-temperatures", type=str, nargs="*", default=["1.0"],
    help="Inverse-temperatures for parallel tempering (default = 1.0, no "
    "tempering): a list of floats or a sample<TAB>temps... file.",
)
mcmc_steps = _p(
    "--mcmc-steps", type=int, nargs=1, default=[2000],
    help="Number of steps per MCMC chain (default = 2000).",
)
mcmc_burn = _p(
    "--mcmc-burn", type=int, nargs=1, default=[1000],
    help="Number of initial steps discarded from each chain (default = 1000).",
)
mcmc_fix_homozygous = _p(
    "--mcmc-fix-homozygous", type=float, nargs=1, default=[0.999],
    help="Fix SNVs whose probability of being homozygous (assessed "
    "independently per variant before MCMC) is at least this value "
    "(default = 0.999).",
)
mcmc_seed = _p(
    "--mcmc-seed", type=int, nargs=1, default=[42],
    help="Random seed for MCMC (default = 42).",
)
mcmc_recombination_step_probability = _p(
    "--mcmc-recombination-step-probability", type=float, nargs=1, default=[0.5],
    help="Probability of a recombination sub-step per MCMC step (default = 0.5).",
)
mcmc_partial_dosage_step_probability = _p(
    "--mcmc-partial-dosage-step-probability", type=float, nargs=1, default=[0.5],
    help="Probability of a within-interval dosage sub-step per MCMC step "
    "(default = 0.5).",
)
mcmc_dosage_step_probability = _p(
    "--mcmc-dosage-step-probability", type=float, nargs=1, default=[1.0],
    help="Probability of a dosage sub-step per MCMC step (default = 1.0).",
)
mcmc_chain_incongruence_threshold = _p(
    "--mcmc-chain-incongruence-threshold", type=float, nargs=1, default=[0.60],
    help="Posterior probability threshold for identifying incongruent "
    "posterior modes (default = 0.60).",
)
mcmc_llk_cache_threshold = _p(
    "--mcmc-llk-cache-threshold", type=int, nargs=1, default=[100],
    help="Accepted for reference CLI compatibility; the sampler keeps "
    "per-read likelihoods up to date and does not use a cache.",
)
read_group_field = _p(
    "--read-group-field", nargs=1, type=str, default=["SM"],
    help='Read-group field used as the sample id (default = "SM").',
)
cores = _p(
    "--cores", type=int, nargs=1, default=[1],
    help="Number of compute workers (default = 1). Accepted for "
    "reference CLI compatibility; this implementation supersedes "
    "process parallelism with cross-locus device batching "
    "(see --locus-batch) and will warn if a value > 1 is given.",
)
locus_batch = _p(
    "--locus-batch", type=str, nargs=1, default=["auto"],
    help="Number of loci run together as one block, each block's "
    "problems fitted in one sampler launch per group "
    '(default = "auto": 32, on any device). Larger '
    "batches amortise launches and fill the GPU.",
)
basis_targets = _p(
    "--targets", type=str, nargs=1, default=[None],
    help="BED file of intervals within which basis SNVs are identified "
    "(contig, start, stop mandatory).",
)
find_snvs_maf = _p(
    "--maf", type=float, nargs=1, default=[0.0],
    help="Minimum sample-population allele frequency to include an allele "
    "(default = 0.0).",
)
find_snvs_mad = _p(
    "--mad", type=int, nargs=1, default=[0],
    help="Minimum sample-population allele depth to include an allele "
    "(default = 0).",
)
find_snvs_ind_maf = _p(
    "--ind-maf", type=float, nargs=1, default=[0.1],
    help="Minimum within-individual allele frequency to include an allele "
    "(default = 0.1).",
)
find_snvs_ind_mad = _p(
    "--ind-mad", type=int, nargs=1, default=[3],
    help="Minimum within-individual allele depth to include an allele "
    "(default = 3).",
)
find_snvs_min_ind = _p(
    "--min-ind", type=int, nargs=1, default=[1],
    help="Minimum number of individuals meeting the --ind-maf and --ind-mad "
    "thresholds (default = 1).",
)
device = _p(
    "--device", type=str, nargs=1, default=["cuda"],
    choices=["cuda", "cpu"],
    help='Where the sampler runs (default = "cuda": the GPU; the run fails '
    "when no CUDA device is visible). On the GPU the CUDA kernels run or "
    'the run fails; "cpu" runs the kernels\' plain PyTorch versions.',
)

SAMPLE_FLATPRIOR_ARGUMENTS = [bam, ploidy, sample_pool]
SAMPLE_DIRMUL_ARGUMENTS = [bam, ploidy, dirmul_prior, sample_pool]
LOCI_DENOVO_ARGUMENTS = [reference, region, region_id, targets, variants]
LOCI_KNOWN_ARGUMENTS = [reference, haplotypes, filter_input_haplotypes]
READ_ENCODING_ARGUMENTS = [
    base_error_rate,
    ignore_base_phred_scores,
    mapping_quality,
    skip_duplicates,
    skip_qcfail,
    skip_supplementary,
    read_group_field,
]
MCMC_ARGUMENTS = [
    mcmc_chains,
    mcmc_steps,
    mcmc_burn,
    mcmc_seed,
    mcmc_chain_incongruence_threshold,
]
OUTPUT_ARGUMENTS = [report]
CORES_ARGUMENTS = [cores, locus_batch, device]

ASSEMBLE_MCMC_PARSER_ARGUMENTS = (
    SAMPLE_FLATPRIOR_ARGUMENTS
    + [assembly_dirmul_prior]
    + LOCI_DENOVO_ARGUMENTS
    + READ_ENCODING_ARGUMENTS
    + MCMC_ARGUMENTS
    + [
        mcmc_fix_homozygous,
        mcmc_llk_cache_threshold,
        mcmc_recombination_step_probability,
        mcmc_dosage_step_probability,
        mcmc_partial_dosage_step_probability,
        mcmc_temperatures,
        haplotype_posterior_threshold,
    ]
    + OUTPUT_ARGUMENTS
    + CORES_ARGUMENTS
)
CALL_EXACT_PARSER_ARGUMENTS = (
    SAMPLE_DIRMUL_ARGUMENTS
    + LOCI_KNOWN_ARGUMENTS
    + READ_ENCODING_ARGUMENTS
    + OUTPUT_ARGUMENTS
    + CORES_ARGUMENTS
)
CALL_MCMC_PARSER_ARGUMENTS = (
    SAMPLE_DIRMUL_ARGUMENTS
    + LOCI_KNOWN_ARGUMENTS
    + READ_ENCODING_ARGUMENTS
    + MCMC_ARGUMENTS
    + OUTPUT_ARGUMENTS
    + CORES_ARGUMENTS
)

CALL_PEDIGREE_MCMC_PARSER_ARGUMENTS = (
    SAMPLE_FLATPRIOR_ARGUMENTS
    + [prior_frequencies, sample_parents, gamete_ploidy, gamete_ibd, gamete_error]
    + LOCI_KNOWN_ARGUMENTS
    + READ_ENCODING_ARGUMENTS
    + MCMC_ARGUMENTS
    + OUTPUT_ARGUMENTS
    + CORES_ARGUMENTS
)


def parse_sample_pools(samples, sample_bams, sample_pool_argument):
    """Pooling: None -> singleton pools; name -> one pool; file -> custom.

    Reference: arguments.py:848-887.
    """
    if sample_pool_argument is None:
        sample_bams = {k: [(k, v)] for k, v in sample_bams.items()}
        return samples, sample_bams
    if not os.path.isfile(sample_pool_argument):
        samples = [sample_pool_argument]
        sample_bams = {sample_pool_argument: [(k, v) for k, v in sample_bams.items()]}
        return samples, sample_bams
    with open(sample_pool_argument) as f:
        lines = [line.strip().split("\t") for line in f.readlines()]
    pools = []
    pool_bams = {}
    samples_in_pools = set()
    for sample, pool in lines:
        samples_in_pools.add(sample)
        path = sample_bams[sample]
        if pool not in pools:
            pools.append(pool)
            pool_bams[pool] = [(sample, path)]
        else:
            pool_bams[pool].append((sample, path))
    sample_with_bams = set(samples)
    diff = sample_with_bams - samples_in_pools
    if diff:
        raise ValueError(f"The following samples have not been assigned to a pool: {diff}")
    diff = samples_in_pools - sample_with_bams
    if diff:
        raise ValueError(
            f"The following names in the sample-pool file do not match a known sample : {diff}"
        )
    return pools, pool_bams


def _is_alignment_file(path):
    try:
        AlignmentFile(path)
        return True
    except (ValueError, NotImplementedError):
        return False
    except Exception:
        return False


def parse_sample_bam_paths(
    bam_argument, sample_pool_argument, read_group_field, reference_path=None
):
    """Resolve the three --bam input styles into samples + path maps.

    Reference: arguments.py:890-954.
    """
    textfile = False
    if len(bam_argument) == 1 and not _is_alignment_file(bam_argument[0]):
        textfile = True
    bams = bam_argument
    if not textfile:
        sample_bams = extract_sample_ids(
            bams, id=read_group_field, reference_path=reference_path
        )
        samples = list(sample_bams)
    else:
        with open(bam_argument[0]) as f:
            lines = [line.strip().split("\t") for line in f.readlines()]
        n_fields = len(lines[0])
        for line in lines:
            if len(line) != n_fields:
                raise ValueError("Inconsistent number of fields")
        if n_fields == 1:
            bams = [line[0] for line in lines]
            sample_bams = extract_sample_ids(
                bams, id=read_group_field, reference_path=reference_path
            )
            samples = list(sample_bams)
        elif n_fields == 2:
            samples = [line[0] for line in lines]
            sample_bams = dict(lines)
        else:
            raise ValueError("Too many fields")

    samples, sample_bams = parse_sample_pools(samples, sample_bams, sample_pool_argument)
    return samples, sample_bams


def parse_sample_value_map(argument, samples, type):
    """Literal value or sample<TAB>value file -> dict; arguments.py:957-988."""
    if (type is int) and argument.isdigit():
        return {s: int(argument) for s in samples}
    if (type is float) and argument.replace(".", "", 1).isdigit():
        return {s: float(argument) for s in samples}
    data = {}
    with open(argument) as f:
        for line in f.readlines():
            sample, value = line.strip().split("\t")
            data[sample] = type(value)
    for s in samples:
        if s not in data:
            raise ValueError("Sample '{}' not found in file '{}'".format(s, argument))
    return data


def parse_pedigree_arguments(
    samples,
    sample_bams,
    ploidy_argument,
    sample_parents_argument,
    gamete_ploidy_argument,
    gamete_ibd_argument,
    gamete_error_argument,
):
    """Pedigree tables -> per-sample parent/gamete maps; arguments.py:991-1119."""
    known_samples = set(samples)
    sample_parents = {}
    with open(sample_parents_argument) as f:
        for line in f.readlines():
            sample, p, q = line.strip().split("\t")
            if sample not in known_samples:
                samples.append(sample)
                sample_bams[sample] = []
                known_samples.add(sample)
            sample_parents[sample] = (
                None if p == "." else p,
                None if q == "." else q,
            )

    sample_ploidy = parse_sample_value_map(ploidy_argument, samples, type=int)

    gamete_ploidy = {}
    if gamete_ploidy_argument is None:
        for sample in samples:
            p = sample_ploidy[sample]
            if p % 2:
                raise ValueError(
                    "Gamete ploidy must be specified for individuals with odd ploidy"
                )
            gamete_ploidy[sample] = (p // 2, p // 2)
    elif gamete_ploidy_argument.isdigit():
        tau = int(gamete_ploidy_argument)
        gamete_ploidy = {s: (tau, tau) for s in samples}
    else:
        with open(gamete_ploidy_argument) as f:
            for line in f.readlines():
                sample, tau_p, tau_q = line.strip().split("\t")
                gamete_ploidy[sample] = (int(tau_p), int(tau_q))

    gamete_ibd = {}
    if gamete_ibd_argument.replace(".", "", 1).isdigit():
        lam = float(gamete_ibd_argument)
        gamete_ibd = {s: (lam, lam) for s in samples}
    else:
        with open(gamete_ibd_argument) as f:
            for line in f.readlines():
                sample, lam_p, lam_q = line.strip().split("\t")
                gamete_ibd[sample] = (float(lam_p), float(lam_q))

    gamete_error = {}
    if gamete_error_argument.replace(".", "", 1).isdigit():
        err = float(gamete_error_argument)
        gamete_error = {s: (err, err) for s in samples}
    else:
        with open(gamete_error_argument) as f:
            for line in f.readlines():
                sample, err_p, err_q = line.strip().split("\t")
                gamete_error[sample] = (float(err_p), float(err_q))

    return dict(
        samples=samples,
        sample_bams=sample_bams,
        sample_ploidy=sample_ploidy,
        sample_parents=sample_parents,
        gamete_ploidy=gamete_ploidy,
        gamete_ibd=gamete_ibd,
        gamete_error=gamete_error,
    )


def parse_sample_temperatures(mcmc_temperatures_argument, samples):
    """Inverse-temperature ladders per sample; arguments.py:1122-1166."""
    if len(mcmc_temperatures_argument) > 1:
        floats = True
    elif mcmc_temperatures_argument[0].replace(".", "", 1).isdigit():
        floats = True
    else:
        floats = False
    if floats:
        temps = sorted(float(s) for s in mcmc_temperatures_argument)
        assert temps[0] > 0.0
        assert temps[-1] <= 1.0
        if temps[-1] != 1.0:
            temps.append(1.0)
        return {s: temps for s in samples}
    data = {s: [1.0] for s in samples}
    with open(mcmc_temperatures_argument[0]) as f:
        for line in f.readlines():
            values = line.strip().split("\t")
            temps = sorted(float(v) for v in values[1:])
            assert temps[0] > 0.0
            assert temps[-1] <= 1.0
            if temps[-1] != 1.0:
                temps.append(1.0)
            data[values[0]] = temps
    assert len(samples) == len(data)
    return data


def parse_report_fields(report_argument):
    """--report names -> (info_fields, format_fields); arguments.py:1169-1185."""
    report_argument = set(report_argument or ())
    info_fields = VCF.INFO_DEFAULT_FIELDS.copy()
    for f in VCF.INFO_OPTIONAL_FIELDS:
        if (f.id in report_argument) or (f"INFO/{f.id}" in report_argument):
            info_fields.append(f)
    format_fields = VCF.FORMAT_DEFAULT_FIELDS.copy()
    for f in VCF.FORMAT_OPTIONAL_FIELDS:
        if (f.id in report_argument) or (f"FORMAT/{f.id}" in report_argument):
            format_fields.append(f)
    return info_fields, format_fields


def collect_default_program_arguments(arguments, skip_inbreeding=False):
    if arguments.ignore_base_phred_scores and arguments.base_error_rate[0] == 0.0:
        raise ValueError("Cannot ignore base phred scores if --base-error-rate is 0")
    samples, sample_bams = parse_sample_bam_paths(
        arguments.bam,
        arguments.sample_pool[0],
        arguments.read_group_field[0],
        reference_path=arguments.reference[0],
    )
    sample_ploidy = parse_sample_value_map(arguments.ploidy[0], samples, type=int)
    if skip_inbreeding or arguments.use_dirmul_prior[0] is None:
        sample_inbreeding = None
    else:
        sample_inbreeding = parse_sample_value_map(
            arguments.use_dirmul_prior[0], samples, type=float
        )
    info_fields, format_fields = parse_report_fields(arguments.report)
    return dict(
        samples=samples,
        sample_bams=sample_bams,
        sample_ploidy=sample_ploidy,
        sample_inbreeding=sample_inbreeding,
        ref=arguments.reference[0],
        read_group_field=arguments.read_group_field[0],
        base_error_rate=arguments.base_error_rate[0],
        ignore_base_phred_scores=arguments.ignore_base_phred_scores,
        mapping_quality=arguments.mapping_quality[0],
        skip_duplicates=arguments.skip_duplicates,
        skip_qcfail=arguments.skip_qcfail,
        skip_supplementary=arguments.skip_supplementary,
        info_fields=info_fields,
        format_fields=format_fields,
        n_cores=arguments.cores[0],
        locus_batch=arguments.locus_batch[0],
        device=arguments.device[0],
    )


def collect_call_exact_program_arguments(arguments):
    data = collect_default_program_arguments(arguments)
    data["vcf"] = arguments.haplotypes[0]
    data["random_seed"] = None
    data["prior_frequencies_tag"] = arguments.use_dirmul_prior[1]
    data["filter_input_haplotypes"] = arguments.filter_input_haplotypes[0]
    return data


def collect_default_mcmc_program_arguments(arguments):
    return dict(
        mcmc_chains=arguments.mcmc_chains[0],
        mcmc_steps=arguments.mcmc_steps[0],
        mcmc_burn=arguments.mcmc_burn[0],
        mcmc_incongruence_threshold=arguments.mcmc_chain_incongruence_threshold[0],
        random_seed=arguments.mcmc_seed[0],
    )


def collect_call_mcmc_program_arguments(arguments):
    data = collect_default_program_arguments(arguments)
    data.update(collect_default_mcmc_program_arguments(arguments))
    data["vcf"] = arguments.haplotypes[0]
    data["prior_frequencies_tag"] = arguments.use_dirmul_prior[1]
    data["filter_input_haplotypes"] = arguments.filter_input_haplotypes[0]
    return data


def collect_call_pedigree_mcmc_program_arguments(arguments):
    data = collect_default_program_arguments(arguments, skip_inbreeding=True)
    data["format_fields"] = data["format_fields"] + VCF.FORMAT_PEDIGREE_FIELDS
    data.update(collect_default_mcmc_program_arguments(arguments))
    data["vcf"] = arguments.haplotypes[0]
    data["prior_frequencies_tag"] = arguments.prior_frequencies[0]
    data["filter_input_haplotypes"] = arguments.filter_input_haplotypes[0]
    data.update(
        parse_pedigree_arguments(
            samples=data["samples"],
            sample_bams=data["sample_bams"],
            ploidy_argument=arguments.ploidy[0],
            sample_parents_argument=arguments.sample_parents[0],
            gamete_ploidy_argument=arguments.gamete_ploidy[0],
            gamete_ibd_argument=arguments.gamete_ibd[0],
            gamete_error_argument=arguments.gamete_error[0],
        )
    )
    return data


def collect_assemble_mcmc_program_arguments(arguments):
    if (arguments.targets[0] is not None) and (arguments.region[0] is not None):
        raise ValueError("Cannot combine --targets and --region arguments.")
    data = collect_default_program_arguments(arguments)
    data.update(collect_default_mcmc_program_arguments(arguments))
    sample_mcmc_temperatures = parse_sample_temperatures(
        arguments.mcmc_temperatures, samples=data["samples"]
    )
    data.update(
        dict(
            bed=arguments.targets[0],
            vcf=arguments.variants[0],
            sample_mcmc_temperatures=sample_mcmc_temperatures,
            region=arguments.region[0],
            region_id=arguments.region_id,
            mcmc_fix_homozygous=arguments.mcmc_fix_homozygous[0],
            mcmc_recombination_step_probability=arguments.mcmc_recombination_step_probability[0],
            mcmc_partial_dosage_step_probability=arguments.mcmc_partial_dosage_step_probability[0],
            mcmc_dosage_step_probability=arguments.mcmc_dosage_step_probability[0],
            mcmc_llk_cache_threshold=arguments.mcmc_llk_cache_threshold[0],
            haplotype_posterior_threshold=arguments.haplotype_posterior_threshold[0],
        )
    )
    return data
