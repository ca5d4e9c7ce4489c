"""``find-snvs`` and ``atomize``: the port's copies (``application/
find_snvs.py`` and ``atomize.py``) byte-equal to ``mchap_tpu``'s output
on ``write_dataset`` data, the header lines naming the program, the date
and the command excepted.  ``atomize`` reads ``mchap_tpu call-exact``'s
VCF of the same data."""

import contextlib
import io
import warnings

import pytest
import torch

from mchap_tpu.application.cli import main as jax_main
from mchap_tpu_torch.application.cli import main as torch_main
from test_torch_fixtures import write_dataset, write_haplotype_vcf

torch.set_num_threads(1)

VOLATILE = ("##fileDate", "##source", "##commandline")


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out), warnings.catch_warnings():
        warnings.simplefilter("ignore")  # atomize's experimental-feature warning
        rc = main(argv)
    return rc, [x for x in out.getvalue().splitlines() if not x.startswith(VOLATILE)]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("find_snvs")
    d = write_dataset(root / "reads", reads_per_sample=60, error_rate=0.01, seed=8)
    panel = write_haplotype_vcf(root / "panel.vcf", d)
    rc, lines = _run(jax_main, ["mchap", "call-exact", "--bam", *d["bams"],
                                "--ploidy", "4", "--haplotypes", panel])
    assert rc == 0
    d["called"] = str(root / "called.vcf")
    open(d["called"], "w").write("\n".join(lines) + "\n")
    return d


@pytest.mark.parametrize(
    "extra", [[], ["--ind-maf", "0.3"], ["--ind-mad", "2", "--min-ind", "2"],
              ["--maf", "0.2", "--mad", "5"]],
    ids=["defaults", "ind-maf", "ind-mad-min-ind", "maf-mad"],
)
def test_find_snvs_byte_equal(data, extra):
    argv = ["mchap", "find-snvs", "--targets", data["targets"], "--reference",
            data["reference"], "--bam", *data["bams"], *extra]
    rc_t, got = _run(torch_main, argv)
    rc_j, want = _run(jax_main, argv)
    assert rc_t == rc_j == 0
    assert sum(not x.startswith("#") for x in want) > 10
    assert got == want


def test_atomize_byte_equal(data):
    argv = ["mchap", "atomize", data["called"]]
    rc_t, got = _run(torch_main, argv)
    rc_j, want = _run(jax_main, argv)
    assert rc_t == rc_j == 0
    assert sum(not x.startswith("#") for x in want) > 10
    assert got == want


def test_atomize_raises_where_mchap_tpu_raises(data, tmp_path):
    """A record whose SNVPOS lists a position where no haplotype varies
    (``assemble`` writes one for every input SNV that the called
    haplotypes leave monomorphic) makes ``mchap_tpu``'s atomize raise
    IndexError; the port's copy raises the same (ROADMAP, reference
    faults)."""
    lines = open(data["called"]).read().splitlines()
    i = next(k for k, x in enumerate(lines) if not x.startswith("#"))
    fields = lines[i].split("\t")
    info = dict(kv.split("=", 1) for kv in fields[7].split(";") if "=" in kv)
    snvpos = [int(p) for p in info["SNVPOS"].split(",")]
    mono = next(p for p in range(1, 100) if p not in snvpos)
    fields[7] = fields[7].replace(
        "SNVPOS=" + info["SNVPOS"], "SNVPOS=" + ",".join(map(str, sorted(snvpos + [mono])))
    )
    lines[i] = "\t".join(fields)
    path = tmp_path / "monomorphic.vcf"
    path.write_text("\n".join(lines) + "\n")
    for main in (jax_main, torch_main):
        with pytest.raises(IndexError):
            _run(main, ["mchap", "atomize", str(path)])
