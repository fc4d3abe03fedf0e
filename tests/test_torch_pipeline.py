"""The port's CLI against the JAX package's CLI, its ``-mesh`` policy,
and its packaging.

Both CLIs count the same FASTA folders (records with N runs and planted
repeats, so the k=21 and k=31 tables are not empty); the count TSVs and
assembly stats must be byte-identical. The JAX CLI runs with ``-mesh
off`` (the tests see 8 virtual devices) and with its uniform launch shape
shrunk, so that it does not compile a 12M-row program on the CPU.
"""

import gzip
import json
import shutil
import subprocess
import sys
import tomllib
from pathlib import Path

import numpy as np
import pytest
import torch

from mercat2_tpu import cli as jax_cli
from mercat2_tpu.engine.counter import KmerCounter as JaxCounter
from mercat2_tpu_torch import cli, pipeline
from mercat2_tpu_torch.engine.counter import KmerCounter
from mercat2_tpu_torch.utils import StageTimer
from test_torch_fastq import write_reads
from test_torch_report import run_both, same_tree

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
    """Nucleotide, .faa, ``-prod -fgs -pca -device-metrics`` and fastq
    ``-debug`` runs in one process that never imports jax."""
    faa = tmp_path / "faa"
    faa.mkdir()
    (faa / "prot.faa").write_text(">p1\nMKLVVAGMKLVVAGMKLVVAG\n>p2\nMKLVVAGQQ\n")
    four = tmp_path / "four"  # PCA runs above 3 samples
    four.mkdir()
    rng = np.random.default_rng(4)
    for name in ("a", "b", "c", "d"):
        _write_fasta(four / f"{name}.fna", rng, 6)
    reads = write_reads(tmp_path / "reads", seed=5, n_reads=60)
    runs = [
        ["-k", "21", "-f", str(fasta_dir), "-o", str(tmp_path / "o")],
        ["-k", "3", "-f", str(faa), "-o", str(tmp_path / "faa_o")],
        ["-k", "5", "-f", str(four), "-o", str(tmp_path / "orf_o"),
         "-prod", "-fgs", "-pca", "-device-metrics"],
        ["-k", "21", "-f", str(reads), "-o", str(tmp_path / "fq_o"), "-debug"],
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
    assert (tmp_path / "fq_o" / "clean" / "s2.fastq.gz_qc.html").exists()
    assert (tmp_path / "fq_o" / "tsv_nucleotide" / "s1_counts.tsv").exists()


@pytest.mark.parametrize("cards", [1, 2, 4])
@pytest.mark.parametrize("policy", ["auto", "off", "1", "2", "8"])
def test_resolve_mesh(monkeypatch, policy, cards):
    """``-mesh`` as the JAX package's ``_resolve_mesh`` reads it
    (mercat2_tpu/pipeline.py:248-269): ``auto`` takes every card, N the
    first min(N, cards), one device or ``off`` none; the CPU is one
    device. The count of cards is patched, so no card is needed."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    want = cards if policy == "auto" else 0 if policy == "off" else min(int(policy), cards)
    mesh = pipeline._resolve_mesh(policy, torch.device("cuda"))
    if want <= 1:
        assert mesh is None
    else:
        assert mesh == [torch.device("cuda", i) for i in range(want)]
    assert pipeline._resolve_mesh(policy, torch.device("cpu")) is None


def test_resolve_mesh_refuses_a_bad_policy():
    with pytest.raises(ValueError):
        pipeline._resolve_mesh("two", torch.device("cpu"))


@pytest.mark.parametrize("mesh", ["2", "1", "off"])
def test_mesh_on_one_device_matches_jax_cli(monkeypatch, tmp_path, fasta_dir, mesh):
    """With one device visible (``-device cpu`` is one) ``-mesh N`` counts
    on it, as the JAX package does (``_resolve_mesh`` takes min(N, devices)
    and no mesh at 1)."""
    monkeypatch.setattr(JaxCounter, "_UNIFORM_SYMS", 1 << 16)
    monkeypatch.setattr(JaxCounter, "_UNIFORM_GAPS", 1 << 10)
    common = ["-k", "21", "-f", str(fasta_dir), "-c", "2", "-replace", "-n", "2"]
    jax_cli.main(common + ["-o", str(tmp_path / "jax"), "-mesh", "off"])
    cli.main(common + ["-o", str(tmp_path / "torch"), "-device", "cpu", "-mesh", mesh])
    _same_tree(tmp_path / "jax", tmp_path / "torch", "tsv_nucleotide")


def test_debug_matches_jax_cli(monkeypatch, tmp_path, fasta_dir, capsys):
    """``-debug``: host RAM at the JAX pipeline's stages and a
    ``torch.profiler`` Chrome trace in ``torch_trace/``; without the two
    trace folders the output trees are the same."""
    jax_tree, torch_tree = run_both(
        monkeypatch, tmp_path, ["-k", 21, "-f", fasta_dir, "-c", 2, "-debug"])
    log = capsys.readouterr().out
    stages = ["load", "count Nucleotide", "finish"]
    for stage in stages:
        assert log.count(f"[debug] {stage}: host RAM") == 2, stage  # both CLIs
    trace = json.loads((torch_tree / "torch_trace" / "trace.json").read_text())
    assert any(e.get("name", "").startswith("aten::") for e in trace["traceEvents"])
    assert (jax_tree / "jax_trace").is_dir()
    shutil.rmtree(jax_tree / "jax_trace")
    shutil.rmtree(torch_tree / "torch_trace")
    same_tree(jax_tree, torch_tree)


def test_stage_timer(capsys):
    timer = StageTimer()
    with timer:
        timer.start("load")
        timer.start("count")
    assert [name for name, _ in timer.stages] == ["load", "count"]
    assert all(dt >= 0 for _, dt in timer.stages)
    assert capsys.readouterr().out.count("Time to ") == 2


def test_pyproject_lists_every_subpackage():
    """An installed ``mercat2-tpu-torch`` holds every subpackage of the
    port (a missing one fails at import, before any flag is parsed)."""
    with open(REPO / "pyproject.toml", "rb") as f:
        listed = set(tomllib.load(f)["tool"]["setuptools"]["packages"])
    pkg = REPO / "mercat2_tpu_torch"
    found = {".".join(p.parent.relative_to(REPO).parts)
             for p in pkg.rglob("__init__.py")}
    assert "mercat2_tpu_torch.metrics" in found
    assert found <= listed, sorted(found - listed)


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
