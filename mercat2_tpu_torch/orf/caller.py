"""ORF-calling entry point with external-tool parity and native fallback.

Mirrors the reference's two callers (MerCat2's lib/mercat2_fasta.py):

- engine='prodigal': uses pyrodigal when importable (same outputs as the
  reference: .faa/.fna/.gff/.gbk, lines 202-244); otherwise the native
  finder writes .faa/.fna/.gff with prodigal-style headers.
- engine='fgs': pipes through the vendored FragGeneScanRs binary (the
  reference bundles the same upstream release and extracts it on first
  use, lines 248-290; the JAX package ships it pre-extracted under
  ``mercat2_tpu/orf/vendor/``, and the port runs that file),
  falling back to a PATH binary and then to the native finder (gzipped
  .faa with FGS-style headers ``>{seqid}_{start}_{end}_{strand}``).
"""

from __future__ import annotations

import gzip
import shutil
import subprocess
from pathlib import Path

import numpy as np

from mercat2_tpu_torch.io.fasta import iter_fasta_records
from mercat2_tpu_torch.orf.native import find_orfs

__all__ = ["orf_call", "fgs_executable"]

#: FragGeneScanRs as the JAX package vendors it (upstream release 1.1.0,
#: training data embedded; the binary the reference extracts from
#: lib/FGS/FragGeneScanRS-linux.tar.gz), found by its file path beside this
#: package, never by import, and not copied into the port
_VENDOR_FGS = (Path(__file__).resolve().parents[2] / "mercat2_tpu" / "orf"
               / "vendor" / "FragGeneScanRs")


def fgs_executable() -> str | None:
    """Path to a usable FragGeneScanRs binary, vendored copy first."""
    if _VENDOR_FGS.is_file():
        return str(_VENDOR_FGS)
    return shutil.which("FragGeneScanRs")


def orf_call(basename: str, fna_in, outpath, engine: str = "prodigal"):
    outpath = Path(outpath)
    outpath.mkdir(parents=True, exist_ok=True)
    if engine == "prodigal":
        try:
            import pyrodigal  # noqa: F401

            return _pyrodigal_call(basename, fna_in, outpath)
        except ImportError:
            return _native_prodigal_style(basename, fna_in, outpath)
    if engine == "fgs":
        exe = fgs_executable()
        if exe:
            return _fgs_call(basename, fna_in, outpath, exe)
        return _native_fgs_style(basename, fna_in, outpath)
    raise ValueError(f"unknown ORF engine {engine!r}")


def _pyrodigal_call(basename, fna_in, outpath):
    import pyrodigal

    faa = Path(outpath, f"{basename}.faa")
    fna = faa.with_suffix(".fna")
    gff = faa.with_suffix(".gff")
    gbk = faa.with_suffix(".gbk")
    finder = pyrodigal.GeneFinder(meta=True)
    with open(faa, "w") as w_faa, open(fna, "w") as w_fna, \
            open(gff, "w") as w_gff, open(gbk, "w") as w_gbk:
        for header, seq in iter_fasta_records(fna_in):
            seq_id = header.split()[0] if header.split() else header
            genes = finder.find_genes(seq)
            genes.write_translations(w_faa, seq_id)
            genes.write_genes(w_fna, seq_id)
            genes.write_gff(w_gff, seq_id)
            genes.write_genbank(w_gbk, seq_id)
    return basename, faa


def _fgs_call(basename, fna_in, outpath, exe="FragGeneScanRs"):
    """Same invocation as the reference (mercat2_fasta.py:279-288):
    ``zcat in | FragGeneScanRs --complete -t complete | gzip > out``."""
    faa_out = Path(outpath, f"{basename}.faa.gz")
    cat = ["zcat"] if str(fna_in).endswith(".gz") else ["cat"]
    pcat = subprocess.Popen(cat + [str(fna_in)], stdout=subprocess.PIPE)
    proc = subprocess.Popen(
        [exe, "--complete", "-t", "complete"],
        stdin=pcat.stdout, stdout=subprocess.PIPE, text=True,
    )
    with gzip.open(faa_out, "wt") as writer:
        for line in proc.stdout:
            writer.write(line)
    return basename, faa_out


def _wrap70(s: str) -> str:
    return "\n".join(s[i : i + 70] for i in range(0, len(s), 70))


def _native_prodigal_style(basename, fna_in, outpath):
    """Prodigal-style gene calls from the native self-training gene model
    (orf/genemodel.py): trained dicodon scoring + start/RBS scoring + DP
    selection, with pyrodigal-style headers and partial/Edge annotation."""
    from mercat2_tpu_torch.orf.genemodel import call_genome
    from mercat2_tpu_torch.orf.native import _BASE_LUT

    faa = Path(outpath, f"{basename}.faa")
    fna = faa.with_suffix(".fna")
    gff = faa.with_suffix(".gff")
    records = [
        (header.split()[0] if header.split() else header, seq)
        for header, seq in iter_fasta_records(fna_in)
    ]
    codes = [
        _BASE_LUT[np.frombuffer(seq.encode("latin-1"), dtype=np.uint8)]
        for _, seq in records
    ]
    called = call_genome(codes)
    with open(faa, "w") as w_faa, open(fna, "w") as w_fna, open(gff, "w") as w_gff:
        print("##gff-version  3", file=w_gff)
        for (seq_id, seq), genes in zip(records, called):
            for n, g in enumerate(genes, 1):
                strand = "+" if g.strand > 0 else "-"
                attrs = (
                    f"ID={seq_id}_{n};partial={g.partial};"
                    f"start_type={g.start_type};rbs_score={g.rbs_score:.1f}"
                )
                hdr = (
                    f"{seq_id}_{n} # {g.start} # {g.end} # {g.strand} # {attrs}"
                )
                print(f">{hdr}", file=w_faa)
                print(_wrap70(g.protein.decode("latin-1")), file=w_faa)
                print(f">{hdr}", file=w_fna)
                print(_wrap70(seq[g.start - 1 : g.end]), file=w_fna)
                print(
                    seq_id, "mercat2_tpu", "CDS", g.start, g.end,
                    f"{g.score:.1f}", strand, "0", attrs,
                    sep="\t", file=w_gff,
                )
    return basename, faa


def _native_fgs_style(basename, fna_in, outpath):
    faa_out = Path(outpath, f"{basename}.faa.gz")
    with gzip.open(faa_out, "wt") as writer:
        for header, seq in iter_fasta_records(fna_in):
            seq_id = header.split()[0] if header.split() else header
            sb = np.frombuffer(seq.encode("latin-1"), dtype=np.uint8)
            for orf in find_orfs(sb):
                strand = "+" if orf["strand"] > 0 else "-"
                print(f">{seq_id}_{orf['start']}_{orf['end']}_{strand}", file=writer)
                print(orf["protein"].decode("latin-1"), file=writer)
    return basename, faa_out
