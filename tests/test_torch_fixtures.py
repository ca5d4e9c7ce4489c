"""Synthetic inputs for the port's tests and chip_smoke.py (no tests here).

Writes a dataset with known haplotypes for tests of ``mchap assemble``
(and for chip_smoke.py's end-to-end phase).  One contig; each locus is
an amplicon whose reads span it; SNVs sit inside the locus; samples'
haplotypes are drawn from a small pool of founder haplotypes per locus.
Reads carry MD tags, so the SAM readers see the reference base at each
SNV.  Imports only numpy.
"""

import numpy as np

BASES = "ACGT"


def _md_tag(read, ref):
    """MD string of an ungapped alignment of ``read`` to ``ref``."""
    out, run = [], 0
    for a, b in zip(read, ref):
        if a == b:
            run += 1
        else:
            out.append(f"{run}{b}")
            run = 0
    out.append(str(run))
    return "".join(out)


def write_dataset(directory, n_samples=3, n_loci=3, snvs_per_locus=8,
                  ploidy=4, reads_per_sample=40, n_triallelic=1,
                  error_rate=0.0, n_founders=4, locus_length=120,
                  founder_snvs=None, pedigree=False, seed=0):
    """Write ``ref.fa``, ``variants.vcf``, ``targets.bed`` and one
    ``<sample>.sam`` per sample into ``directory``.

    With ``pedigree``, the first two samples are parents and every other
    sample their Mendelian progeny: at each locus a child takes ploidy/2
    of each parent's haplotypes (distinct slots).  ``pedigree.txt`` then
    lists each sample with its parents ('.' for unknown) and the result
    holds its path under ``pedigree``.

    ``snvs_per_locus`` is one count for every locus or a list of counts.
    Founder 0 is the reference haplotype; the others draw an allele at
    every SNV, or, with ``founder_snvs``, carry alternate alleles at that
    many random SNVs only (low haplotype diversity, as at real loci).
    Returns a dict with the file paths, the sample names, and the truth:
    ``truth[locus][sample]`` is the sorted tuple of the sample's
    haplotype sequences over the locus interval.
    """
    import pathlib

    rng = np.random.default_rng(seed)
    directory = pathlib.Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    gap = 50
    length = gap + n_loci * (locus_length + gap)
    ref = rng.choice(list(BASES), size=length)
    samples = [f"sample{i + 1}" for i in range(n_samples)]

    vcf_lines = [
        "##fileformat=VCFv4.2",
        f"##contig=<ID=chr1,length={length}>",
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO",
    ]
    bed_lines = []
    sam_reads = {s: [] for s in samples}
    truth = {}
    panels = {}
    n_tri_left = n_triallelic
    if np.ndim(snvs_per_locus) == 0:
        snvs_per_locus = [snvs_per_locus] * n_loci
    for li in range(n_loci):
        n_snv = snvs_per_locus[li]
        start = gap + li * (locus_length + gap)
        stop = start + locus_length
        name = f"locus{li + 1}"
        bed_lines.append(f"chr1\t{start}\t{stop}\t{name}")
        offsets = np.sort(
            rng.choice(np.arange(5, locus_length - 5), n_snv, replace=False)
        )
        alleles = []
        for k, off in enumerate(offsets):
            pos = start + off
            others = [b for b in BASES if b != ref[pos]]
            n_alt = 2 if (n_tri_left > 0 and k == n_snv // 2) else 1
            if n_alt == 2:
                n_tri_left -= 1
            alts = list(rng.choice(others, n_alt, replace=False))
            alleles.append([ref[pos]] + alts)
            vcf_lines.append(
                f"chr1\t{pos + 1}\t.\t{ref[pos]}\t{','.join(alts)}\t.\t.\t."
            )
        n_all = np.array([len(a) for a in alleles])
        if founder_snvs is None:
            founders = np.stack([rng.integers(0, n_all) for _ in range(n_founders)])
        else:
            founders = np.zeros((n_founders, n_snv), int)
            for f in range(1, n_founders):
                sites = rng.choice(n_snv, founder_snvs, replace=False)
                founders[f, sites] = rng.integers(1, n_all[sites])
        founders[0] = 0  # the reference haplotype is in the pool
        founder_seqs = []
        for h in founders:
            hs = ref[start:stop].copy()
            for k, off in enumerate(offsets):
                hs[off] = alleles[k][h[k]]
            founder_seqs.append("".join(hs))
        panels[name] = dict(
            contig="chr1", start=start, sequences=list(dict.fromkeys(founder_seqs))
        )
        truth[name] = {}
        picked = []
        for si, s in enumerate(samples):
            if pedigree and si >= 2:
                picks = np.concatenate([
                    rng.choice(picked[0], ploidy // 2, replace=False),
                    rng.choice(picked[1], ploidy // 2, replace=False),
                ])
            else:
                picks = rng.integers(0, n_founders, ploidy)
            picked.append(picks)
            haps = founders[picks]
            truth[name][s] = tuple(sorted(founder_seqs[i] for i in picks))
            for r in range(reads_per_sample):
                hap = haps[r % ploidy] if r < ploidy else haps[rng.integers(ploidy)]
                seq = ref[start:stop].copy()
                for k, off in enumerate(offsets):
                    seq[off] = alleles[k][hap[k]]
                if error_rate > 0:
                    err = rng.random(locus_length) < error_rate
                    for i in np.flatnonzero(err):
                        seq[i] = rng.choice([b for b in BASES if b != seq[i]])
                seq = "".join(seq)
                md = _md_tag(seq, "".join(ref[start:stop]))
                sam_reads[s].append(
                    f"{name}_{s}_{r}\t0\tchr1\t{start + 1}\t60\t{locus_length}M"
                    f"\t*\t0\t0\t{seq}\t{'I' * locus_length}\tRG:Z:{s}\tMD:Z:{md}"
                )

    ref_path = directory / "ref.fa"
    seq = "".join(ref)
    ref_path.write_text(
        ">chr1\n" + "\n".join(seq[i : i + 60] for i in range(0, len(seq), 60)) + "\n"
    )
    vcf_path = directory / "variants.vcf"
    vcf_path.write_text("\n".join(vcf_lines) + "\n")
    bed_path = directory / "targets.bed"
    bed_path.write_text("\n".join(bed_lines) + "\n")
    sam_paths = []
    for s in samples:
        path = directory / f"{s}.sam"
        header = [
            "@HD\tVN:1.6\tSO:coordinate",
            f"@SQ\tSN:chr1\tLN:{length}",
            f"@RG\tID:{s}\tSM:{s}",
        ]
        path.write_text("\n".join(header + sam_reads[s]) + "\n")
        sam_paths.append(str(path))
    out = dict(
        reference=str(ref_path), variants=str(vcf_path), targets=str(bed_path),
        bams=sam_paths, samples=samples, truth=truth, ploidy=ploidy,
        panels=panels, length=length,
    )
    if pedigree:
        lines = [f"{s}\t.\t." for s in samples[:2]] + [
            f"{s}\t{samples[0]}\t{samples[1]}" for s in samples[2:]
        ]
        out["pedigree"] = str(directory / "pedigree.txt")
        (directory / "pedigree.txt").write_text("\n".join(lines) + "\n")
    return out


def write_haplotype_vcf(path, data, frequency_tag=None):
    """Write the founder pool of each locus of ``data`` (from
    ``write_dataset``) as a haplotype VCF in ``mchap assemble``'s output
    form: one record per locus, REF and ALT haplotype sequences over the
    locus interval, ``INFO/END`` and ``INFO/SNVPOS``.  With
    ``frequency_tag``, an INFO field of that name (Number=R) holds each
    haplotype's frequency among the samples' true haplotypes, so a
    founder that no sample carries gets 0.  Returns ``path`` as a str.
    """
    lines = [
        "##fileformat=VCFv4.3",
        f"##contig=<ID=chr1,length={data['length']}>",
        '##INFO=<ID=END,Number=1,Type=Integer,Description="End position">',
        '##INFO=<ID=SNVPOS,Number=.,Type=Integer,Description="SNV positions">',
    ]
    if frequency_tag:
        lines.append(
            f'##INFO=<ID={frequency_tag},Number=R,Type=Float,'
            'Description="Prior allele frequencies">'
        )
    lines.append("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO")
    for name, panel in data["panels"].items():
        seqs = panel["sequences"]
        chars = np.array([list(s) for s in seqs])
        snvpos = np.flatnonzero((chars != chars[:1]).any(axis=0)) + 1
        stop = panel["start"] + len(seqs[0])
        info = f"END={stop};SNVPOS={','.join(map(str, snvpos)) or '.'}"
        if frequency_tag:
            copies = np.zeros(len(seqs))
            for haps in data["truth"][name].values():
                for h in haps:
                    copies[seqs.index(h)] += 1
            freqs = copies / copies.sum()
            info += f";{frequency_tag}=" + ",".join(f"{f:.4f}" for f in freqs)
        alt = ",".join(seqs[1:]) or "."
        lines.append(
            f"{panel['contig']}\t{panel['start'] + 1}\t{name}\t{seqs[0]}\t{alt}"
            f"\t.\tPASS\t{info}"
        )
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return str(path)


def parse_vcf_records(text):
    """Body records of a VCF as dicts (CHROM, POS, REF, ALT, FILTER,
    INFO dict, per-sample FORMAT dicts)."""
    samples = None
    out = []
    for line in text.splitlines():
        if line.startswith("##"):
            continue
        fields = line.split("\t")
        if line.startswith("#"):
            samples = fields[9:]
            continue
        info = dict(
            kv.split("=", 1) if "=" in kv else (kv, True)
            for kv in fields[7].split(";")
        )
        keys = fields[8].split(":")
        calls = {
            s: dict(zip(keys, v.split(":"))) for s, v in zip(samples, fields[9:])
        }
        out.append(dict(
            CHROM=fields[0], POS=fields[1], ID=fields[2], REF=fields[3],
            ALT=fields[4], FILTER=fields[6], INFO=info, calls=calls,
        ))
    return out


def called_haplotypes(record):
    """Per sample, the sorted tuple of called haplotype sequences."""
    alleles = [record["REF"]] + (
        record["ALT"].split(",") if record["ALT"] != "." else []
    )
    out = {}
    for s, call in record["calls"].items():
        gt = call["GT"].replace("|", "/").split("/")
        out[s] = tuple(sorted(alleles[int(a)] if a != "." else "." for a in gt))
    return out


K1_NB, K1_R, K1_C, K1_STEPS = 8, 16, 128, 4


def k1_case(P, A, seed):
    """Inputs of the de novo sampler (K1) for pinned-noise tests: four
    problems spread over 128 chains, two fixed sites (one at a non-zero
    allele), per-problem read counts and break rates."""
    NB, R, C = K1_NB, K1_R, K1_C
    rng = np.random.default_rng(seed)
    S = 4
    lr = np.log(rng.dirichlet(np.ones(A), size=(S, NB, R)).astype(np.float32))
    lr = np.ascontiguousarray(lr.transpose(0, 1, 3, 2))  # [S, NB, A, R]
    prob = (np.arange(C) % S).astype(np.int32)
    g0 = rng.integers(0, A, size=(P, NB, C)).astype(np.int32)
    nall = np.full((S, NB), A, np.int32)
    nall[:, 2] = 1
    nall[:, 5] = 1
    g0[:, 2, :] = A - 1
    g0[:, 5, :] = 1
    pbreak = np.array([0.25, 0.1, 0.4, 0.3], np.float32)
    counts = rng.integers(1, 3, size=(S, R)).astype(np.float32)
    return lr, counts, g0, nall, pbreak, prob


def k1_compare_with_pallas(P, A, stage, temps=None, alpha=None, n_steps=K1_STEPS):
    """Run the JAX kernel in interpret mode (PRNG inert: every draw is
    1e-12) and the port's plain K1 with noise pinned at 1e-12; assert
    identical packed traces and llks within 1e-4.  ``temps`` (a ladder)
    and ``alpha`` (f32[4], one dispersion per problem) select the
    tempered and Dirichlet-multinomial modes."""
    import jax.numpy as jnp
    import torch

    from mchap_tpu.ops.pallas_denovo import pallas_denovo_sampler
    from mchap_tpu_torch.ops import cuda_denovo as K

    lr, counts, g0, nall, pbreak, prob = k1_case(P, A, seed=10 * P + A + stage)
    want_trace, want_llks = pallas_denovo_sampler(
        jnp.int32(3),
        np.ascontiguousarray(lr.transpose(3, 1, 2, 0)[..., prob]),  # [R, NB, A, C]
        np.ascontiguousarray(counts[prob].T),
        g0,
        np.ascontiguousarray(nall[prob].T),
        pbreak[prob][None],
        None if temps is None else np.asarray(temps, np.float32),
        None if alpha is None else np.asarray(alpha, np.float32)[prob],
        n_steps=n_steps, ploidy=P, stage=stage, refresh=2, packed=True,
        interpret=True,
    )
    T = 1 if temps is None else len(temps)
    D = K.draw_layout(P, K1_NB, T)["D"]
    trace, llks = K.denovo_sampler(
        *(torch.from_numpy(x) for x in (lr, counts, g0, nall, pbreak, prob)),
        n_steps=n_steps, stage=stage, refresh=2,
        noise=torch.full((n_steps, D, K1_C), 1e-12), temps=temps,
        alpha=None if alpha is None else torch.tensor(alpha, dtype=torch.float32),
    )
    want_trace = np.asarray(want_trace).astype(np.int64)
    np.testing.assert_array_equal(trace.numpy().astype(np.int64), want_trace)
    np.testing.assert_allclose(llks.numpy(), np.asarray(want_llks), rtol=0, atol=1e-4)
    # the pinned chains do move, so the comparison is not vacuous
    assert (want_trace[1:] != want_trace[:-1]).any()
