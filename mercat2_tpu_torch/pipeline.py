"""Pipeline of the port: the nucleotide round up to the count TSVs.

Port of the nucleotide round of ``mercat2_tpu.pipeline.run_pipeline``
(which follows MerCat2's ``mercat_main``, bin/mercat2.py:186-503)::

    discover inputs (by extension)
      fna -> clean (split at N runs) + assembly stats    host, reused
    chunk large files                                    host, reused
    one codec per round                                  _group_plan
    count: launch groups on the device, fetched in waves _count_group
      -> tsv_nucleotide/{sample}_counts.tsv, stats/{sample}.txt

Stages not ported yet raise ``NotImplementedError`` naming their ROADMAP
item (see :func:`check_supported`); nothing is silently skipped.
"""

from __future__ import annotations

import dataclasses
import shutil
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from mercat2_tpu.io.chunker import maybe_chunk
from mercat2_tpu.io.clean import remove_n
from mercat2_tpu.io.fasta import parse_fasta_seq
from mercat2_tpu.io.native import open_fasta_native
from mercat2_tpu.metrics.assembly import write_assembly_stats
from mercat2_tpu_torch.device import resolve_device
from mercat2_tpu_torch.engine.codec import (
    alphabet_of, canonical_codec, codec_for_alphabet,
)
from mercat2_tpu_torch.engine.counter import KmerCounter, fetch_tables
from mercat2_tpu_torch.engine.host import _REC_GAP, merge_tables, source_for
from mercat2_tpu_torch.ops.build_keys import KERNEL_BITS, KERNEL_K
from mercat2_tpu_torch.report.tsv import write_counts_tsv

__all__ = ["PipelineConfig", "check_supported", "run_pipeline"]

FILE_EXT_FASTQ = [".fq", ".fastq", ".fq.gz", ".fastq.gz"]
FILE_EXT_NUCLEOTIDE = [
    ".fasta", ".fa", ".fna", ".ffn",
    ".fasta.gz", ".fa.gz", ".fna.gz", ".ffn.gz",
]
FILE_EXT_PROTEIN = [".faa", ".faa.gz"]


@dataclasses.dataclass
class PipelineConfig:
    """The JAX pipeline's configuration, less the PCA plot's ``lowmem``
    and ``category_file``, plus the device to count on."""

    kmer: int
    input_files: list = dataclasses.field(default_factory=list)
    input_folder: str | None = None
    min_count: int = 10
    num_cores: int = 0  # 0 = auto
    chunk_size_mb: int = 100
    output: str = "mercat_results"
    replace: bool = False
    skipclean: bool = False
    toupper: bool = False
    pca: bool = False
    prodigal: bool = False
    fgs: bool = False
    debug: bool = False
    device_metrics: bool = False
    mesh: str = "auto"
    #: "cuda" (the kernels) or "cpu" (the plain twins); never chosen for you
    device: str = "cuda"


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to mercat2_tpu_torch yet "
        f"(ROADMAP.md, Queue 1 {item}); run it with mercat2_tpu"
    )


def check_supported(cfg: PipelineConfig) -> None:
    """Raise for any option whose stage the port does not have yet."""
    if cfg.pca:
        raise _not_ported("-pca", "item 1, combined TSVs, diversity and figures")
    if cfg.prodigal or cfg.fgs:
        raise _not_ported("-prod / -fgs", "item 3, the ORF rounds")
    if cfg.device_metrics:
        raise _not_ported("-device-metrics", "item 6, metrics/device.py")
    if cfg.debug:
        raise _not_ported("-debug", "item 10, utils/runtime.py tracing")
    if cfg.mesh not in ("off", "auto", "1"):
        raise _not_ported(f"-mesh {cfg.mesh}", "item 7, parallel/")
    if not KERNEL_K[0] <= cfg.kmer <= KERNEL_K[1]:
        raise _not_ported(
            f"k={cfg.kmer} (the key-build kernel covers "
            f"{KERNEL_K[0]} <= k <= {KERNEL_K[1]})",
            "item 2, the protein and bits=5 key build",
        )


def _file_ext(path: Path) -> str:
    suffixes = path.suffixes
    for i in range(len(suffixes)):
        ext = "".join(suffixes[i:])
        if ext in FILE_EXT_FASTQ + FILE_EXT_NUCLEOTIDE + FILE_EXT_PROTEIN:
            return ext
    return ""


def _discover_inputs(cfg: PipelineConfig) -> list[Path]:
    files = [Path(f) for f in cfg.input_files]
    if cfg.input_folder:
        folder = Path(cfg.input_folder).expanduser().absolute()
        for fname in sorted(p.name for p in folder.iterdir()):
            p = folder / fname
            if p.is_file() and _file_ext(p):
                files.append(p)
    return files


#: total decompressed bytes of parse handles kept open between the codec
#: pre-pass and the transport build (beyond this, files are re-parsed)
_HOLD_CAP = 1 << 30


def _group_plan(group: dict, workers: int | None = None):
    """One codec for a round: the union of every file's alphabet.

    Chunks of a sample must share a codec so that their keys merge. Parse
    handles are kept open (up to ``_HOLD_CAP`` decompressed bytes) and
    returned, so the transport build does not parse a file twice.

    Returns (codec, handles) where handles maps path -> NativeFasta.
    """
    paths = [f for files in group.values() for f in files]

    def scan(f):
        try:
            nf = open_fasta_native(f)
        except OSError:
            nf = None
        if nf is not None:
            return f, nf, nf.alphabet()
        seq, _rec = parse_fasta_seq(f)
        return f, None, alphabet_of(seq)

    alpha = np.zeros(0, np.uint8)
    handles: dict = {}
    held = 0
    with ThreadPoolExecutor(max_workers=workers) as pool:
        for f, nf, present in pool.map(scan, paths):
            alpha = np.union1d(alpha, present)
            if nf is not None:
                if held + nf.seq_len <= _HOLD_CAP:
                    handles[f] = nf
                    held += nf.seq_len
                else:
                    nf.close()
    if alpha.size == 0:
        for nf in handles.values():
            nf.close()
        return None, {}
    alpha = alpha.astype(np.uint8)
    codec = canonical_codec(alpha)
    return (codec if codec is not None else codec_for_alphabet(alpha)), handles


def _count_group(group: dict, counter: KmerCounter, min_count: int,
                 out_tsv_dir: Path, workers: int | None,
                 handles: dict) -> dict:
    """Count every sample of a round and write its TSV.

    Three overlapping stages: threads open and parse the files ahead; the
    host packs a wave of files into launch groups and enqueues them on
    the device without waiting; the wave before is fetched only once the
    next one is enqueued, so the device works while the host packs. Every
    source is closed once its wave is packed. The min-count filter stays
    per file before chunks of one sample merge, as in MerCat2
    (lib/mercat2_kmers.py:73-76).
    """
    jobs = [(basename, f) for basename, files in group.items() for f in files]
    tables: dict[str, list] = {basename: [] for basename in group}
    inflight: deque = deque()  # (names, pendings)
    wave: list[tuple] = []     # (basename, source)
    wave_syms = 0
    wave_cap_syms = 2 * counter._UNIFORM_SYMS
    wave_cap_files = 2 * counter._UNIFORM_FILES

    def fetch_wave() -> None:
        names, pendings = inflight.popleft()
        for name, tbl in zip(names, fetch_tables(pendings)):
            tables[name].append(tbl)

    def dispatch_wave() -> None:
        nonlocal wave, wave_syms
        if not wave:
            return
        try:
            pendings = counter.dispatch_packed_uniform(
                [s for _, s in wave], min_count, workers
            )
        finally:
            for _, s in wave:
                s.close()
        inflight.append(([n for n, _ in wave], pendings))
        wave, wave_syms = [], 0
        while len(inflight) > 2:
            fetch_wave()

    with ThreadPoolExecutor(max_workers=workers) as pool:
        build_ahead = max(8, 2 * (workers or 4))
        pend = deque(jobs)
        building: deque = deque()
        try:
            while pend or building:
                while pend and len(building) < build_ahead:
                    bname, f = pend.popleft()
                    building.append((bname, pool.submit(
                        source_for, f, counter.codec, handles.pop(f, None))))
                bname, fut = building.popleft()
                source = fut.result()
                wave.append((bname, source))
                wave_syms += source.packed_len(_REC_GAP)
                if len(wave) >= wave_cap_files or wave_syms > wave_cap_syms:
                    dispatch_wave()
            dispatch_wave()
        finally:  # on an error, close what is open
            for _, s in wave:
                s.close()
            for _, fut in building:
                fut.result().close()
    while inflight:
        fetch_wave()

    tsv_list: dict[str, Path] = {}
    for basename in group:
        merged = merge_tables(tables[basename], counter.k)
        if len(merged):
            print(f"Significant k-mers: {len(merged)}")
            tsv_list[basename] = write_counts_tsv(
                merged, basename, out_tsv_dir / f"{basename}_counts.tsv"
            )
        else:
            print("No significant k-mers found")
    return tsv_list


def run_pipeline(cfg: PipelineConfig) -> Path:
    """Run the nucleotide round; returns the output folder."""
    check_supported(cfg)
    device = resolve_device(cfg.device)
    out = Path(cfg.output)
    if out.exists():
        if cfg.replace:
            shutil.rmtree(out)
        else:
            raise SystemExit(
                f"Output folder exists, please specify another folder or use "
                f"'-replace' to override the files. '{out}'"
            )
    out.mkdir(parents=True, exist_ok=True)
    workers = cfg.num_cores or None
    cleanpath = out / "clean"

    print(f"\nStarting MerCat2-TPU (PyTorch, {device}) with k-mer {cfg.kmer}\n")
    print("Loading files")
    t_start = time.perf_counter()
    inputs = _discover_inputs(cfg)
    for path in inputs:
        ext = _file_ext(Path(path))
        if ext in FILE_EXT_FASTQ:
            raise _not_ported(f"fastq input {path}", "item 9, fastq inputs")
        if ext in FILE_EXT_PROTEIN:
            raise _not_ported(f"protein input {path}",
                              "item 2, the protein and bits=5 key build")

    def load_contig(path: Path, basename: str):
        if cfg.skipclean:
            return basename, path
        cleaned, _stat = remove_n(path, cleanpath, cfg.toupper)
        return basename, cleaned

    group: dict[str, list[Path]] = {}
    with ThreadPoolExecutor(max_workers=workers) as pool:
        futures = []
        for path in inputs:
            path = Path(path).expanduser().absolute()
            basename = path.name.removesuffix(_file_ext(path))
            futures.append(pool.submit(load_contig, path, basename))
            futures.append(pool.submit(
                write_assembly_stats, path, out / "stats" / f"{basename}.txt"))
        for fut in futures:
            res = fut.result()
            if isinstance(res, tuple):
                group[res[0]] = [res[1]]
    print(f"Time to load {len(group)} files: "
          f"{round(time.perf_counter() - t_start, 2)} seconds")
    if not group:
        return out

    if cfg.chunk_size_mb > 0:
        dir_chunks = out / "chunks_nucleotide"
        for basename, files in group.items():
            _, group[basename] = maybe_chunk(
                basename, files[0], cfg.chunk_size_mb, dir_chunks / basename)

    print("Processing Nucleotide")
    out_tsv = out / "tsv_nucleotide"
    out_tsv.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    codec, handles = _group_plan(group, workers)
    try:
        if codec is not None:
            if codec.bits not in KERNEL_BITS:
                raise _not_ported(
                    f"a {codec.bits}-bit codec (alphabet "
                    f"{codec.symbols.tobytes()!r})",
                    "item 2, the protein and bits=5 key build",
                )
            counter = KmerCounter(cfg.kmer, codec, device)
            _count_group(group, counter, cfg.min_count, out_tsv, workers, handles)
    finally:
        for nf in handles.values():  # any not consumed by the count
            nf.close()
    print(f"Time to count {cfg.kmer}-mers: "
          f"{round(time.perf_counter() - t0, 2)} seconds")
    print("\nFinished MerCat2-TPU Pipeline")
    return out
