"""The port stands alone: it imports nothing of the JAX package, and its
copies of the JAX package's host code (``io/``, ``metrics/``, ``orf/``,
``version.py``) give the originals' results, on the CPU.

- An AST scan of every module of ``mercat2_tpu_torch/``, of
  ``chip_smoke.py`` and of ``scripts/{launch,mesh}_times.py`` finds no import of
  ``mercat2_tpu`` or ``jax``.
- The port's CLI runs in a subprocess whose ``sys.meta_path`` refuses to
  import ``mercat2_tpu`` and ``jax``, and writes the same output tree as
  in a subprocess that imports freely.
- Each copied host module is held against its JAX-package original on the
  same seeded inputs. The JAX package's parser is kept on its numpy path
  here (its native library is built by ``make`` at first use, which other
  tests own), and the port's copy is run through both of its parsers.
"""

import ast
import gzip
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from mercat2_tpu import version as jversion
from mercat2_tpu.io import chunker as jchunker
from mercat2_tpu.io import clean as jclean
from mercat2_tpu.io import fasta as jfasta
from mercat2_tpu.io import fastq as jfastq
from mercat2_tpu.io import native as jnative
from mercat2_tpu.metrics import alpha as jalpha
from mercat2_tpu.metrics import assembly as jassembly
from mercat2_tpu.metrics import beta as jbeta
from mercat2_tpu.metrics import protein as jprotein
from mercat2_tpu.orf import caller as jcaller
from mercat2_tpu_torch import version as tversion
from mercat2_tpu_torch.io import chunker as tchunker
from mercat2_tpu_torch.io import clean as tclean
from mercat2_tpu_torch.io import fasta as tfasta
from mercat2_tpu_torch.io import fastq as tfastq
from mercat2_tpu_torch.io import native as tnative
from mercat2_tpu_torch.metrics import alpha as talpha
from mercat2_tpu_torch.metrics import assembly as tassembly
from mercat2_tpu_torch.metrics import beta as tbeta
from mercat2_tpu_torch.metrics import protein as tprotein
from mercat2_tpu_torch.orf import caller as tcaller
from test_torch_fastq import write_reads
from test_torch_report import same_tree, write_contigs, write_proteins

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = ("mercat2_tpu", "jax", "jaxlib")
PORT_FILES = sorted(str(p.relative_to(REPO)) for p in (REPO / "mercat2_tpu_torch").rglob("*.py"))
SCANNED = PORT_FILES + ["chip_smoke.py", "scripts/launch_times.py", "scripts/mesh_times.py"]


# -- no import of the JAX package ----------------------------------------------


def imported_modules(tree: ast.AST) -> list[str]:
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.append(node.module)
        elif (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
              and node.func.attr == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            names.append(str(node.args[0].value))
    return names


@pytest.mark.parametrize("rel", SCANNED)
def test_module_imports_nothing_of_jax(rel):
    tree = ast.parse((REPO / rel).read_text(), filename=rel)
    bad = [m for m in imported_modules(tree) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{rel} imports {bad}"


def test_scan_covers_the_port():
    assert len(PORT_FILES) > 30 and "mercat2_tpu_torch/orf/caller.py" in PORT_FILES


# -- the CLI with the JAX package's import refused ----------------------------------

BLOCKER = """
import sys

class _Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in {forbidden!r}:
            raise ImportError("refused: " + name)
        return None

sys.meta_path.insert(0, _Refuse())
"""
RUN_CLI = """
import sys
sys.path.insert(0, {repo!r})
from mercat2_tpu_torch import cli
code = cli.main({argv!r})
assert not any(m.split(".")[0] in {forbidden!r} for m in sys.modules), "imported"
sys.exit(code)
"""


def run_cli_subprocess(argv: list[str], blocked: bool) -> None:
    code = (BLOCKER.format(forbidden=FORBIDDEN) if blocked else "") + RUN_CLI.format(
        repo=str(REPO), argv=argv, forbidden=FORBIDDEN if blocked else ())
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=REPO, timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]


@pytest.mark.parametrize("flags", [[], ["-prod", "-fgs"]], ids=["plain", "prod-fgs"])
def test_cli_runs_with_the_jax_package_refused(tmp_path, flags):
    folder = write_contigs(tmp_path / "in", 3, seed=11, n_rec=2, n_orf=4)
    trees = {}
    for blocked in (True, False):
        out = tmp_path / ("blocked" if blocked else "free")
        run_cli_subprocess(["-k", "5", "-c", "2", "-f", str(folder), "-o", str(out),
                            "-replace", "-device", "cpu", *flags], blocked)
        trees[blocked] = out
    files = same_tree(trees[True], trees[False])
    assert "tsv_nucleotide/s0_counts.tsv" in files
    if flags:
        assert any(f.startswith("tsv_prodigal/") for f in files)
        assert any(f.startswith("tsv_fgs/") for f in files)


# -- the copies of the host modules against their originals -------------------------


@pytest.fixture
def jax_numpy_parser(monkeypatch):
    """The JAX package's FASTA parser on its numpy path."""
    monkeypatch.setattr(jnative, "_lib", None)
    monkeypatch.setattr(jnative, "_lib_tried", True)


def fasta_inputs(folder: Path) -> list[Path]:
    """Contigs (one gzipped), a protein file, and a FASTA with whitespace
    inside lines, pre-header bytes and '*' (the exact line-loop path)."""
    contigs = write_contigs(folder / "c", 2, seed=5, n_rec=3, n_orf=3)
    gz = contigs / "s1.fna.gz"
    gz.write_bytes(gzip.compress((contigs / "s1.fna").read_bytes()))
    prot = write_proteins(folder / "p", 1, seed=9, n_prot=12) / "prot0.faa"
    odd = folder / "odd.fa"
    odd.write_bytes(b"ACGT\n>r1 x\nAC GT*\r\nTT\n\n>r2\n*NNA\n>r3\n")
    return [contigs / "s0.fna", gz, prot, odd]


def test_version_string_matches():
    assert tversion.__version__ == jversion.__version__


@pytest.mark.parametrize("parser", ["native", "numpy"])
def test_parse_fasta_seq_matches(tmp_path, jax_numpy_parser, monkeypatch, parser):
    if parser == "numpy":
        monkeypatch.setattr(tnative, "_lib", None)
        monkeypatch.setattr(tnative, "_lib_tried", True)
    elif tnative.native_lib() is None:
        pytest.fail("the port's native parser did not build (g++ and zlib are needed)")
    for path in fasta_inputs(tmp_path):
        (ws, wr), (gs, gr) = jfasta.parse_fasta_seq(path), tfasta.parse_fasta_seq(path)
        np.testing.assert_array_equal(ws, gs, err_msg=str(path))
        np.testing.assert_array_equal(wr, gr, err_msg=str(path))
        assert list(jfasta.iter_fasta_records(path)) == list(tfasta.iter_fasta_records(path))


@pytest.mark.parametrize("toupper", [False, True])
def test_remove_n_matches(tmp_path, toupper):
    for path in fasta_inputs(tmp_path)[:2]:
        (jp, js), (tp, ts) = (jclean.remove_n(path, tmp_path / "j", toupper),
                              tclean.remove_n(path, tmp_path / "t", toupper))
        assert js == ts and jp.name == tp.name
        assert gzip.decompress(jp.read_bytes()) == gzip.decompress(tp.read_bytes())


def test_chunking_matches(tmp_path):
    rng = np.random.default_rng(3)
    big = tmp_path / "big.fna"
    big.write_text("".join(f">r{r}\n{''.join(rng.choice(list('ACGT'), size=7000))}\n"
                           for r in range(170)))  # ~1.2 MB
    for size_mb in (0, 1, 2):
        (jn, jf), (tn, tf) = (jchunker.maybe_chunk("big", big, size_mb, tmp_path / f"j{size_mb}"),
                              tchunker.maybe_chunk("big", big, size_mb, tmp_path / f"t{size_mb}"))
        assert jn == tn and [f.name for f in jf] == [f.name for f in tf]
        assert [f.read_bytes() for f in jf] == [f.read_bytes() for f in tf]
    for delim, lines in ((">", None), (None, 4)):
        jf = jchunker.chunk_file(big, tmp_path / "jc", 5000, delim, lines)
        tf = tchunker.chunk_file(big, tmp_path / "tc", 5000, delim, lines)
        assert len(jf) > 10 and [f.read_bytes() for f in jf] == [f.read_bytes() for f in tf]
    for s in ("1 M", "0.5kilo", "2Gi", "7", "3k"):
        assert jchunker.human2bytes(s) == tchunker.human2bytes(s)


def test_fastq_front_end_matches(tmp_path):
    reads = write_reads(tmp_path / "reads", seed=17, n_reads=120)
    for fq, name in ((reads / "s1.fastq", "s1"), (reads / "s2.fastq.gz", "s2")):
        outs = {}
        for tag, mod in (("j", jfastq), ("t", tfastq)):
            d = tmp_path / tag
            qc_html = mod.qc(fq, d, name)
            trimmed = mod.trim(fq, d, name)
            fasta = mod.fq2fa(trimmed, d, name)
            outs[tag] = (qc_html, trimmed, fasta, d)
        (jh, jt, jf, jd), (th, tt, tf, td) = outs["j"], outs["t"]
        assert jh.read_bytes() == th.read_bytes()
        assert (jd / f"{fq.name}_qc.json").read_bytes() == (td / f"{fq.name}_qc.json").read_bytes()
        assert jt.read_bytes() == tt.read_bytes()
        assert (jd / f"{name}-trim.json").read_bytes() == (td / f"{name}-trim.json").read_bytes()
        assert gzip.decompress(jf.read_bytes()) == gzip.decompress(tf.read_bytes())


def test_assembly_stats_match(tmp_path, jax_numpy_parser):
    for path in fasta_inputs(tmp_path)[:2]:
        j = jassembly.write_assembly_stats(path, tmp_path / "j" / f"{path.name}.txt")
        t = tassembly.write_assembly_stats(path, tmp_path / "t" / f"{path.name}.txt")
        assert j.read_bytes() == t.read_bytes()


def counts_tsv(path: Path, rng, n: int) -> Path:
    counts = np.concatenate([rng.integers(1, 4, size=n), rng.integers(10, 500, size=n // 3)])
    path.write_text("k-mer\tcount\n" + "".join(f"K{i}\t{c}\n" for i, c in enumerate(counts)))
    return path


def test_alpha_diversity_matches(tmp_path):
    rng = np.random.default_rng(4)
    for s in range(3):
        tsv = counts_tsv(tmp_path / f"s{s}.tsv", rng, 40 + 60 * s)
        j = jalpha.compute_alpha_diversity(f"s{s}", tsv, tmp_path / "j" / f"s{s}.tsv")
        t = talpha.compute_alpha_diversity(f"s{s}", tsv, tmp_path / "t" / f"s{s}.tsv")
        assert j.read_bytes() == t.read_bytes()


def test_beta_diversity_matches(tmp_path):
    rng = np.random.default_rng(6)
    samples = [f"s{i}" for i in range(5)]
    rows = ["\t".join(["sample"] + [f"K{k}" for k in range(30)])]
    for s in samples:
        rows.append("\t".join([s] + [str(int(v)) for v in rng.integers(0, 20, size=30)]))
    combined = tmp_path / "combined_T.tsv"
    combined.write_text("\n".join(rows) + "\n")
    jbeta.compute_beta_diversity("Nucleotide", combined, tmp_path / "j")
    tbeta.compute_beta_diversity("Nucleotide", combined, tmp_path / "t")
    jtsv = sorted(p.name for p in (tmp_path / "j").glob("*.tsv"))
    assert jtsv and jtsv == sorted(p.name for p in (tmp_path / "t").glob("*.tsv"))
    for name in jtsv:
        assert (tmp_path / "j" / name).read_bytes() == (tmp_path / "t" / name).read_bytes()


def test_protein_metrics_match(tmp_path):
    folder = write_proteins(tmp_path, 2, seed=12, alphabet="ACDEFGHIKLMNPQRSTVWYXBZ")
    for path in sorted(folder.glob("*.faa")):
        want, got = jprotein.protein_metrics_table(path), tprotein.protein_metrics_table(path)
        assert list(want) == list(got) and len(want["name"]) == 30
        for key in want:
            np.testing.assert_array_equal(np.asarray(want[key], object),
                                          np.asarray(got[key], object), err_msg=key)


@pytest.mark.parametrize("engine", ["prodigal", "fgs"])
def test_orf_call_matches(tmp_path, engine):
    folder = write_contigs(tmp_path / "in", 2, seed=21, n_rec=2, n_orf=4)
    if engine == "fgs":  # the binary the JAX package vendors, found by path
        assert tcaller.fgs_executable() == jcaller.fgs_executable() is not None
    for fna in sorted(folder.glob("*.fna")):
        jname, jfaa = jcaller.orf_call(fna.stem, fna, tmp_path / "j", engine=engine)
        tname, tfaa = tcaller.orf_call(fna.stem, fna, tmp_path / "t", engine=engine)
        assert jname == tname and jfaa.name == tfaa.name
        read = gzip.decompress if jfaa.suffix == ".gz" else (lambda b: b)
        want = read(jfaa.read_bytes())
        assert want.count(b">") > 0 and want == read(tfaa.read_bytes())
    same_tree(tmp_path / "j", tmp_path / "t")
