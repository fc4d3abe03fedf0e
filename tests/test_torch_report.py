"""The port's whole output tree against the JAX CLI's, and the report
modules and device metrics it carries, on the CPU.

Both CLIs run on the same small inputs (contigs with planted ORFs and N
runs, protein FASTA files with shared families) and must write the same
files. TSVs and FASTA files must be byte-identical (gzip files compared
after decompression, since gzip headers carry a time stamp). HTML is
compared after removing what differs between any two runs: the date
(report/html.py) and the random div ids (report/plotlyjson.py). PNGs
must exist.

PCA is the one numeric exception: sklearn's PCA goes through LAPACK in
OpenBLAS, which does not give bit-identical results from one run of the
same program to the next (the first component of the same matrix varied
in its 14th digit over four runs, JAX package alone). So ``pca.tsv`` is
compared to rtol 1e-9, and PCA coordinates inside HTML to 9 significant
digits.

The JAX CLI runs with ``-mesh off`` and its uniform launch shape shrunk,
as in tests/test_torch_pipeline.py. The helpers here are shared with
tests/test_torch_protein.py.
"""

import gzip
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from mercat2_tpu import cli as jax_cli
from mercat2_tpu.engine.counter import KmerCounter as JaxCounter
from mercat2_tpu.metrics import alpha as jalpha
from mercat2_tpu.metrics import device as jdevice
from mercat2_tpu.metrics import protein as jprotein
from mercat2_tpu.report import figures as jfigs
from mercat2_tpu.report import tsv as jtsv
from mercat2_tpu_torch import cli
from mercat2_tpu_torch.metrics import device as tdevice
from mercat2_tpu_torch.metrics.alpha import compute_alpha_diversity
from mercat2_tpu_torch.metrics.protein import protein_metrics_table
from mercat2_tpu_torch.report import figures as tfigs
from mercat2_tpu_torch.report import tsv as ttsv

CPU = torch.device("cpu")
SENSE = [a + b + c for a in "ACGT" for b in "ACGT" for c in "ACGT"
         if a + b + c not in ("TAA", "TAG", "TGA")]
AMINO = "ACDEFGHIKLMNPQRSTVWY"


# -- inputs ------------------------------------------------------------------


def _write_fasta(path: Path, records, width=70):
    lines = []
    for name, seq in records:
        lines.append(f">{name}")
        lines += [seq[i : i + width] for i in range(0, len(seq), width)]
    path.write_text("\n".join(lines) + "\n")


def write_contigs(folder: Path, n_files: int, seed: int, n_rec=3, n_orf=6):
    """Contigs of random spacers and planted ORFs (ATG, 100-300 sense
    codons, TAA); every third ORF comes from a few shared genes, so that
    proteins repeat across samples. One record per file has an N run."""
    folder.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    shared = ["".join(rng.choice(SENSE, size=150)) for _ in range(4)]
    for f in range(n_files):
        records = []
        for r in range(n_rec):
            parts = []
            for j in range(n_orf):
                parts.append("".join(rng.choice(list("ACGT"), size=int(rng.integers(50, 200)))))
                body = (shared[j % 4] if j % 3 == 0
                        else "".join(rng.choice(SENSE, size=int(rng.integers(100, 300)))))
                parts.append("ATG" + body + "TAA")
            seq = "".join(parts)
            if r == 1:
                seq = seq[:100] + "NNNN" + seq[100:]
            records.append((f"ctg{f}_{r} contig {r}", seq))
        _write_fasta(folder / f"s{f}.fna", records)
    return folder


def write_proteins(folder: Path, n_files: int, seed: int, alphabet=AMINO,
                   n_prot=30):
    """Protein FASTA files: ``n_prot`` proteins each, a quarter of them led
    by one of 3 shared 80-residue families."""
    folder.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    fams = ["".join(rng.choice(list(alphabet), size=80)) for _ in range(3)]
    for f in range(n_files):
        records = []
        for r in range(n_prot):
            s = "".join(rng.choice(list(alphabet), size=int(rng.integers(40, 200))))
            if r % 4 == 0:
                s = fams[r % 3] + s
            records.append((f"p{f}_{r} protein {r}", s))
        _write_fasta(folder / f"prot{f}.faa", records, width=60)
    return folder


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    root = tmp_path_factory.mktemp("report_inputs")
    return {
        "orf": write_contigs(root / "orf", 4, seed=7),
        "faa": write_proteins(root / "faa", 3, seed=3),
    }


# -- running both CLIs and comparing what they write -----------------------


def run_both(monkeypatch, out: Path, args: list, jax_extra=(), torch_extra=()):
    """Run the JAX CLI and the port's CLI (plain path) on the same args."""
    monkeypatch.setattr(JaxCounter, "_UNIFORM_SYMS", 1 << 16)
    monkeypatch.setattr(JaxCounter, "_UNIFORM_GAPS", 1 << 10)
    common = [*map(str, args), "-replace", "-n", "2"]
    jax_cli.main(common + ["-o", str(out / "jax"), "-mesh", "off", *jax_extra])
    cli.main(common + ["-o", str(out / "torch"), "-device", "cpu", *torch_extra])
    return out / "jax", out / "torch"


_DATE = re.compile(rb'<div id="metadata">\d{4}-\d{2}-\d{2}</div>')
_DIV_ID = re.compile(rb"mercat2tpu-[0-9a-f]{32}")
_LONG_FLOAT = re.compile(rb"-?\d+\.\d{10,}(?:e-?\d+)?")


def _normalized_html(data: bytes) -> bytes:
    data = _DIV_ID.sub(b"DIV", _DATE.sub(b"DATE", data))
    return _LONG_FLOAT.sub(lambda m: b"%.9g" % float(m.group()), data)


def _pca_values(path: Path) -> tuple[list, np.ndarray]:
    rows = [ln.split("\t") for ln in path.read_text().splitlines()]
    return rows[0] + [r[0] for r in rows[1:]], np.array(
        [[float(x) for x in r[1:]] for r in rows[1:]])


def same_tree(a: Path, b: Path) -> list[str]:
    """Assert that two output trees hold the same files with the same
    contents (see the module docstring); returns the relative paths."""
    files = sorted(str(p.relative_to(a)) for p in a.rglob("*") if p.is_file())
    assert files == sorted(str(p.relative_to(b)) for p in b.rglob("*") if p.is_file())
    for rel in files:
        x, y = (a / rel).read_bytes(), (b / rel).read_bytes()
        if rel.endswith(".png"):
            assert x and y, rel
        elif rel.endswith(".gz"):
            assert gzip.decompress(x) == gzip.decompress(y), rel
        elif rel.endswith(".html"):
            assert _normalized_html(x) == _normalized_html(y), rel
        elif rel.endswith("pca.tsv"):
            (na, va), (nb, vb) = _pca_values(a / rel), _pca_values(b / rel)
            assert na == nb, rel
            np.testing.assert_allclose(vb, va, rtol=1e-9,
                                       atol=1e-9 * np.abs(va).max(), err_msg=rel)
        else:
            assert x == y, rel
    return files


def assert_rows(tree: Path, sub: str, n_files: int):
    tsvs = sorted((tree / sub).glob("*_counts.tsv"))
    assert len(tsvs) == n_files, (sub, tsvs)
    for t in tsvs:  # each table holds rows, not just a header
        assert t.read_text().count("\n") > 1, t


# -- the output tree ---------------------------------------------------------


def test_nucleotide_no_flags_writes_the_whole_tree(monkeypatch, tmp_path):
    """The fault repaired first: with no flag the port now writes the
    combined TSVs, diversity, GC plot and report as the JAX CLI does."""
    folder = write_contigs(tmp_path / "in", 3, seed=11, n_orf=4)
    for f in range(3):  # a repeat, so that 21-mers reach min-count 2
        p = folder / f"s{f}.fna"
        p.write_text(p.read_text() + f">rep{f}\n" + "ACGTTGCAAGGCTTAC" * 12 + "\n")
    jax_tree, torch_tree = run_both(monkeypatch, tmp_path, ["-k", 21, "-f", folder, "-c", 2])
    files = same_tree(jax_tree, torch_tree)
    assert_rows(torch_tree, "tsv_nucleotide", 3)
    for want in ["combined_Nucleotide.tsv", "combined_Nucleotide_T.tsv",
                 "report/report.html", "report/diversity-Nucleotide.tsv",
                 "report/diversity/nucleotide-s0.tsv",
                 "report/diversity/braycurtis-Nucleotide.tsv", "stats/s0.txt"]:
        assert want in files, want
    assert "Sample GC Summary" in (torch_tree / "report/report.html").read_text()


def test_orf_rounds_with_pca_write_the_whole_tree(monkeypatch, tmp_path, inputs):
    """MerCat2's documented run, ``-k 5 -prod -fgs -pca``, on 4 samples
    (PCA runs above 3)."""
    jax_tree, torch_tree = run_both(
        monkeypatch, tmp_path, ["-k", 5, "-f", inputs["orf"], "-c", 2,
                                "-prod", "-fgs", "-pca"])
    files = same_tree(jax_tree, torch_tree)
    for sub in ("tsv_nucleotide", "tsv_prodigal", "tsv_fgs"):
        assert_rows(torch_tree, sub, 4)
    for want in ["pca_Nucleotide/pca.tsv", "pca_prodigal/pca.tsv", "pca_fgs/pca.tsv",
                 "report/metrics-prodigal.tsv", "report/metrics-fgs.html",
                 "report/diversity-prodigal.tsv", "report/diversity-fgs.tsv",
                 "report/beta_diversity/cosine-fgs.tsv", "fgs/s0.faa.gz",
                 "pyrodigal/s0.faa"]:
        assert want in files, want


def test_device_metrics_tree_matches_jax_host_path(monkeypatch, tmp_path, inputs):
    """``-device-metrics`` in the port (torch, float64) writes what the
    JAX CLI's default host path writes, byte for byte."""
    folder = tmp_path / "in"
    folder.mkdir()
    for src in [*inputs["faa"].iterdir(), inputs["orf"] / "s0.fna", inputs["orf"] / "s1.fna"]:
        (folder / src.name).write_bytes(src.read_bytes())
    jax_tree, torch_tree = run_both(
        monkeypatch, tmp_path, ["-k", 5, "-f", folder, "-c", 2],
        torch_extra=["-device-metrics"])
    files = same_tree(jax_tree, torch_tree)
    assert "report/metrics-protein.tsv" in files
    assert "report/diversity-protein.tsv" in files
    assert_rows(torch_tree, "tsv_protein", 3)


# -- the report modules ------------------------------------------------------


def test_merge_tsv_matches_jax_copy(tmp_path, inputs):
    """merge_tsv / merge_tsv_T byte-identical to the JAX package's, on
    sorted count tables (the union path) and on unsorted diversity tables
    (the heads-min path)."""
    counts = {}
    for f in range(3):
        rng = np.random.default_rng(f)
        keys = sorted({"".join(rng.choice(list("ACGT"), size=4)) for _ in range(60)})
        p = tmp_path / f"c{f}.tsv"
        p.write_text(f"k-mer\tc{f}_Count\n" + "".join(
            f"{k}\t{int(rng.integers(1, 99))}\n" for k in keys))
        counts[f"c{f}"] = p
    div = {}
    for f in range(2):
        p = tmp_path / f"d{f}.tsv"
        p.write_text(f"Metric\td{f}\nshannon\t{f}.5\nsimpson\t0.9{f}\nchao1_ci\t[1, 2.5]\n")
        div[f"d{f}"] = p
    for tables in (counts, div):
        for name in ("merge_tsv", "merge_tsv_T"):
            if tables is div and name == "merge_tsv_T":
                continue  # diversity tables are merged one way only
            a = getattr(jtsv, name)(tables, tmp_path / f"jax_{name}.tsv")
            b = getattr(ttsv, name)(tables, tmp_path / f"torch_{name}.tsv")
            assert a.read_bytes() == b.read_bytes(), name


def test_figure_copies_match_jax(tmp_path):
    """The port's copies of report/figures.py and plotlyjson.py give the
    JAX package's figure JSON."""
    p = tmp_path / "combined.tsv"
    p.write_text("k-mer\ta\tb\n" + "".join(
        f"{k}\t{i}\t{(7 * i) % 11}\n" for i, k in enumerate(["AAA", "AAC", "AAG", "ACA",
                                                              "CCC", "GGG", "TTT"])))
    for jf, tf in zip(jfigs.kmer_summary(p), tfigs.kmer_summary(p)):
        assert jf.to_json() == tf.to_json()
    gc = {"x": 40.5, "y": 51.25}
    assert jfigs.gc_plot_sample(gc).to_json() == tfigs.gc_plot_sample(gc).to_json()


# -- device metrics ----------------------------------------------------------


def _protein_batch(rng, n):
    aa = np.frombuffer(AMINO.encode() + b"X*BZUO", np.uint8)
    seqs = [aa[rng.integers(0, 20 if i % 5 else aa.size, size=int(rng.integers(1, 700)))]
            for i in range(n)]
    return np.concatenate(seqs), np.concatenate([[0], np.cumsum([s.size for s in seqs])])


def test_protein_metrics_device_matches_jax(tmp_path, inputs):
    """pI bit-identical to the JAX host path, MW and hydropathy to the
    last bits (another order of summation), the rounded table identical;
    against the JAX device path (float32) within rtol 1e-5."""
    flat, off = _protein_batch(np.random.default_rng(0), 400)
    pi, mw, hyd = tdevice.protein_metrics_device(flat, off, CPU)
    np.testing.assert_array_equal(pi, jprotein.isoelectric_point_batch(flat, off))
    np.testing.assert_allclose(mw, jprotein.molecular_weight_batch(flat, off), rtol=1e-13)
    # |hydropathy| can be near 0 after cancellation: bound by the sum of
    # |terms| (<= 4.5 a residue), here and against float32 below
    scale = 4.5 * np.diff(off)
    host_hyd = jprotein.hydropathy_batch(flat, off)
    np.testing.assert_array_less(np.abs(hyd - host_hyd), 1e-13 * scale + 1e-300)

    jpi, jmw, jhyd = jdevice.protein_metrics_device(flat, off)
    np.testing.assert_allclose(pi, jpi, rtol=1e-5)
    np.testing.assert_allclose(mw, jmw, rtol=1e-5)
    np.testing.assert_array_less(np.abs(hyd - jhyd), 1e-5 * scale)

    for faa in sorted(inputs["faa"].iterdir()):
        got, want = protein_metrics_table(faa, CPU), jprotein.protein_metrics_table(faa)
        assert got.keys() == want.keys()
        for key in want:
            assert list(got[key]) == list(want[key]), key


def _fmt(v):
    if isinstance(v, str):
        return v
    try:
        return repr(round(v, 2))
    except TypeError:
        return repr([round(x, 2) for x in v])


@pytest.mark.parametrize("case", ["singletons", "min_count_10", "one_singleton"])
def test_alpha_metrics_device_matches_jax(tmp_path, case):
    """Every metric as the JAX host path prints it (value and type), the
    raw values to rtol 1e-12, and the JAX device path (float32) within
    rtol 1e-5; the written table byte-identical to the host path's."""
    rng = np.random.default_rng(len(case))
    counts = rng.integers(1, 40, size=900)
    if case == "min_count_10":
        counts = counts + 9
    elif case == "one_singleton":
        counts = np.concatenate([rng.integers(2, 40, size=500), [1]])
    got = tdevice.alpha_metrics_device(counts, CPU)
    host = {m: jalpha.alpha_metric(m, counts) for m in jalpha.ALPHA_METRICS}
    jdev = jdevice.alpha_metrics_device(counts)
    for m in jalpha.ALPHA_METRICS:
        assert _fmt(got[m]) == _fmt(host[m]), m
        assert type(got[m]) is type(host[m]), m
        if isinstance(host[m], str):
            continue
        np.testing.assert_allclose(got[m], host[m], rtol=1e-12, err_msg=m)
        np.testing.assert_allclose(got[m], jdev[m], rtol=1e-5, err_msg=m)

    tsv = tmp_path / "c.tsv"
    tsv.write_text("k-mer\tc_Count\n" + "".join(f"K{i:04d}\t{c}\n" for i, c in enumerate(counts)))
    a = jalpha.compute_alpha_diversity("c", tsv, tmp_path / "host.tsv")
    b = compute_alpha_diversity("c", tsv, tmp_path / "dev.tsv", CPU)
    assert a.read_bytes() == b.read_bytes()
