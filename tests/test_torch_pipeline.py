"""The port's CLI against the JAX package's CLI, and what it refuses.

Both CLIs count the same FASTA folders (records with N runs and planted
repeats, so the k=21 and k=31 tables are not empty); the count TSVs and
assembly stats must be byte-identical. The JAX CLI runs with ``-mesh
off`` (the tests see 8 virtual devices) and with its uniform launch shape
shrunk, so that it does not compile a 12M-row program on the CPU.
"""

import gzip
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mercat2_tpu import cli as jax_cli
from mercat2_tpu.engine.counter import KmerCounter as JaxCounter
from mercat2_tpu_torch import cli
from mercat2_tpu_torch.engine.counter import KmerCounter

REPO = Path(__file__).resolve().parent.parent


def _write_fasta(path: Path, rng, n_rec: int, alphabet="ACGT", gz=False):
    rep = "".join(rng.choice(list(alphabet), size=150))
    lines = []
    for r in range(n_rec):
        seq = "".join(rng.choice(list(alphabet), size=int(rng.integers(80, 500))))
        if r % 3 == 0:  # an N run: the clean stage splits the record here
            seq = seq[:40] + "N" * int(rng.integers(1, 9)) + seq[40:]
        seq += rep * 3
        lines.append(f">{path.name.split('.')[0]}_{r} some description")
        lines += [seq[i : i + 70] for i in range(0, len(seq), 70)]
    text = "\n".join(lines) + "\n"
    if gz:
        with gzip.open(path, "wt") as f:
            f.write(text)
    else:
        path.write_text(text)


@pytest.fixture(scope="module")
def fasta_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("fasta")
    rng = np.random.default_rng(2024)
    _write_fasta(d / "alpha.fna", rng, 12)
    _write_fasta(d / "beta.fasta", rng, 7)
    _write_fasta(d / "gamma.fa.gz", rng, 9, gz=True)
    return d


def _same_tree(a: Path, b: Path, sub: str) -> list[str]:
    names = sorted(p.name for p in (a / sub).iterdir())
    assert names == sorted(p.name for p in (b / sub).iterdir())
    for n in names:
        assert (a / sub / n).read_bytes() == (b / sub / n).read_bytes(), n
    return names


@pytest.mark.parametrize("k", [4, 21, 31])
def test_cli_matches_jax_cli(monkeypatch, tmp_path, fasta_dir, k):
    monkeypatch.setattr(JaxCounter, "_UNIFORM_SYMS", 1 << 16)
    monkeypatch.setattr(JaxCounter, "_UNIFORM_GAPS", 1 << 10)
    common = ["-k", str(k), "-f", str(fasta_dir), "-c", "2", "-replace", "-n", "2"]
    jax_cli.main(common + ["-o", str(tmp_path / "jax"), "-mesh", "off"])
    cli.main(common + ["-o", str(tmp_path / "torch"), "-device", "cpu"])
    tsvs = _same_tree(tmp_path / "jax", tmp_path / "torch", "tsv_nucleotide")
    assert tsvs == ["alpha_counts.tsv", "beta_counts.tsv", "gamma_counts.tsv"]
    for t in tsvs:  # each table holds rows, not just a header
        assert (tmp_path / "torch" / "tsv_nucleotide" / t).read_text().count("\n") > 50
    assert _same_tree(tmp_path / "jax", tmp_path / "torch", "stats") == [
        "alpha.txt", "beta.txt", "gamma.txt"]


def test_cli_imports_no_jax(tmp_path, fasta_dir):
    """Nucleotide, .faa and ``-prod -fgs -pca -device-metrics`` runs in
    one process that never imports jax."""
    faa = tmp_path / "faa"
    faa.mkdir()
    (faa / "prot.faa").write_text(">p1\nMKLVVAGMKLVVAGMKLVVAG\n>p2\nMKLVVAGQQ\n")
    four = tmp_path / "four"  # PCA runs above 3 samples
    four.mkdir()
    rng = np.random.default_rng(4)
    for name in ("a", "b", "c", "d"):
        _write_fasta(four / f"{name}.fna", rng, 6)
    runs = [
        ["-k", "21", "-f", str(fasta_dir), "-o", str(tmp_path / "o")],
        ["-k", "3", "-f", str(faa), "-o", str(tmp_path / "faa_o")],
        ["-k", "5", "-f", str(four), "-o", str(tmp_path / "orf_o"),
         "-prod", "-fgs", "-pca", "-device-metrics"],
    ]
    code = (
        "import sys\n"
        "from mercat2_tpu_torch.cli import main\n"
        f"for argv in {runs!r}:\n"
        "    main(argv + ['-c', '2', '-device', 'cpu'])\n"
        "assert 'jax' not in sys.modules, 'the port imported jax'\n"
        "print('no jax')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "no jax" in out.stdout
    assert (tmp_path / "o" / "tsv_nucleotide" / "alpha_counts.tsv").exists()
    assert (tmp_path / "faa_o" / "tsv_protein" / "prot_counts.tsv").exists()
    assert (tmp_path / "orf_o" / "pca_Nucleotide" / "pca.tsv").exists()
    assert (tmp_path / "orf_o" / "report" / "metrics-prodigal.tsv").exists()
    assert (tmp_path / "orf_o" / "report" / "metrics-fgs.tsv").exists()


@pytest.mark.parametrize("extra", [["-debug"], ["-mesh", "2"], ["-k", "257"]])
def test_flags_not_ported_raise(tmp_path, fasta_dir, extra):
    argv = ["-k", "5", "-f", str(fasta_dir), "-o", str(tmp_path / "o"),
            "-device", "cpu", *extra]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        cli.main(argv)


@pytest.mark.parametrize("name,text", [
    ("reads.fastq", "@r1\nACGTACGT\n+\nIIIIIIII\n"),
    # 65 distinct bytes: a 7-bit codec, which the packed transport cannot take
    ("wide.faa", ">p1\n" + "".join(map(chr, range(58, 123))) + "\n"),
], ids=["fastq", "7-bit"])
def test_inputs_not_ported_raise(tmp_path, name, text):
    (tmp_path / name).write_text(text)
    argv = ["-k", "3", "-i", str(tmp_path / name), "-o", str(tmp_path / "o"),
            "-device", "cpu"]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        cli.main(argv)


def test_cli_min_count_1_matches_jax_cli(monkeypatch, tmp_path, fasta_dir):
    """At ``-c 1`` the JAX CLI takes its adaptive path
    (mercat2_tpu/pipeline.py:404) and the port its uniform launches, with
    the overflow rerun (the cap is shrunk so that it runs); the tables are
    the same."""
    monkeypatch.setattr(JaxCounter, "_UNIFORM_SYMS", 1 << 16)
    monkeypatch.setattr(JaxCounter, "_UNIFORM_GAPS", 1 << 10)
    monkeypatch.setattr(KmerCounter, "_UNIFORM_CAP", 512)
    common = ["-k", "11", "-f", str(fasta_dir), "-c", "1", "-replace", "-n", "2"]
    jax_cli.main(common + ["-o", str(tmp_path / "jax"), "-mesh", "off"])
    cli.main(common + ["-o", str(tmp_path / "torch"), "-device", "cpu"])
    tsvs = _same_tree(tmp_path / "jax", tmp_path / "torch", "tsv_nucleotide")
    assert (tmp_path / "torch" / "tsv_nucleotide" / tsvs[0]).read_text().count("\n") > 512


def test_cli_without_cuda_exits_nonzero(tmp_path, fasta_dir, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(SystemExit) as exc:
        cli.main(["-k", "21", "-f", str(fasta_dir), "-o", str(tmp_path / "o")])
    assert exc.value.code != 0
    assert "CUDA" in capsys.readouterr().err
    assert not (tmp_path / "o").exists()


def test_chip_smoke_without_cuda_fails_without_a_result(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    alone = tmp_path / "alone"
    alone.mkdir()
    shutil.copy(REPO / "chip_smoke.py", alone)
    for where in (REPO, alone):  # in the repo, and with the script alone
        out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=where,
                             capture_output=True, text=True, timeout=300)
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout
