"""Read sets (fastq inputs) through the port's CLI against the JAX CLI, on
the CPU.

Both packages run the same host front end: QC of the raw reads, a
fastp-default trim, QC of the trimmed reads, and fq2fa (MerCat2's
bin/mercat2.py fastq branch), the JAX package's ``mercat2_tpu.io.fastq``
and the port's copy of it, ``mercat2_tpu_torch/io/fastq.py``. The
reads carry a TruSeq adapter tail (10%), low-quality 3' tails, N bases,
and some are, or become after trimming, shorter than k. The whole output
trees must be equal (see tests/test_torch_report.py for how each kind of
file is compared; the gzipped FASTA of ``clean/`` decompressed, since its
header carries a time). The QC JSON and HTML hold neither a path nor a
time (the report names the file by its base name), so they are compared
byte for byte.
"""

import gzip
from pathlib import Path

import numpy as np
import pytest

from test_torch_report import assert_rows, run_both, same_tree, write_contigs

TRUSEQ = "AGATCGGAAGAGCACACGTCTGAACTCCAGTCA"


def fastq_text(rng, genome: np.ndarray, n_reads: int, name: str) -> str:
    """Reads of 150 bp drawn from ``genome`` with 0.5% substitutions:
    every 10th ends in the TruSeq adapter, every 7th has a low-quality 3'
    tail (long enough on every 14th to drop the read), every 9th holds
    an N, and every 11th is cut to 10-30 bp. Every 20th read ends in the
    adapter after 16-20 bases, shorter than k=21 once trimmed."""
    acgt = np.frombuffer(b"ACGT", np.uint8)
    lines = []
    for r in range(n_reads):
        at = int(rng.integers(0, genome.size - 150))
        seq = genome[at : at + 150].copy()
        hit = rng.random(150) < 0.005
        seq[hit] = acgt[rng.integers(0, 4, size=int(hit.sum()))]
        s = seq.tobytes().decode()
        if r % 20 == 0:
            s = s[: int(rng.integers(16, 21))] + TRUSEQ + s[:40]
        elif r % 10 == 0:
            s = s[:110] + TRUSEQ[:40]
        if r % 9 == 0:
            s = s[:50] + "N" + s[51:]
        if r % 11 == 0:
            s = s[: int(rng.integers(10, 31))]
        qual = "".join(chr(33 + int(q)) for q in rng.integers(25, 41, size=len(s)))
        if r % 7 == 0:
            tail = 90 if r % 14 == 0 else 25
            qual = qual[: max(0, len(s) - tail)] + "#" * min(tail, len(s))
        lines += [f"@{name}.{r} read {r}", s, "+", qual]
    return "\n".join(lines) + "\n"


def write_reads(folder: Path, seed: int, n_reads=240, genome_bp=20_000) -> Path:
    """Two read sets, one gzipped, each from its own genome, and one
    contig file beside them."""
    folder.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    for name, gz in (("s1", False), ("s2", True)):
        genome = acgt[rng.integers(0, 4, size=genome_bp)]
        text = fastq_text(rng, genome, n_reads, name)
        if gz:
            (folder / f"{name}.fastq.gz").write_bytes(gzip.compress(text.encode()))
        else:
            (folder / f"{name}.fastq").write_text(text)
    contig = write_contigs(folder / "contig", 1, seed=seed, n_orf=2)
    (contig / "s0.fna").rename(folder / "ctg.fna")
    contig.rmdir()
    return folder


@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    return write_reads(tmp_path_factory.mktemp("reads"), seed=31)


@pytest.mark.parametrize("skipclean", [False, True], ids=["clean", "skipclean"])
@pytest.mark.parametrize("k", [5, 21])
def test_cli_matches_jax_cli(monkeypatch, tmp_path, reads, k, skipclean):
    """``-k 5`` goes dense in both packages; ``-k 21`` sorts."""
    extra = ["-skipclean"] if skipclean else []
    jax_tree, torch_tree = run_both(
        monkeypatch, tmp_path, ["-k", k, "-f", reads, "-c", 2, *extra])
    files = same_tree(jax_tree, torch_tree)
    assert_rows(torch_tree, "tsv_nucleotide", 3)
    clean = sorted(f.removeprefix("clean/") for f in files if f.startswith("clean/"))
    want = ["s1.fastq_qc.html", "s1.fastq_qc.json", "s1.fna.gz",
            "s2.fastq.gz_qc.html", "s2.fastq.gz_qc.json", "s2.fna.gz"]
    if not skipclean:
        want += ["ctg_clean.fna.gz", "s1-trim.json", "s1_trim.fastq", "s1_trim.fastq_qc.html",
                 "s1_trim.fastq_qc.json", "s2-trim.json", "s2_trim.fastq",
                 "s2_trim.fastq_qc.html", "s2_trim.fastq_qc.json"]
    assert clean == sorted(want)
    # reads get neither assembly stats nor a GC entry; the contig does
    assert [f for f in files if f.startswith("stats/")] == ["stats/ctg.txt"]
    if not skipclean:
        trimmed = (torch_tree / "clean" / "s1_trim.fastq").read_text().splitlines()
        assert 0 < len(trimmed) // 4 < 240  # the trim dropped reads
        assert min(len(s) for s in trimmed[1::4]) < 21  # some shorter than k
        assert not any(TRUSEQ[:20] in s for s in trimmed[1::4])  # adapters clipped
