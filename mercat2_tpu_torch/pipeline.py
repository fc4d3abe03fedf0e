"""Pipeline of the port: MerCat2's whole run.

Port of ``mercat2_tpu.pipeline.run_pipeline`` (which follows MerCat2's
``mercat_main``, bin/mercat2.py:186-503)::

    discover inputs (by extension)
      fastq -> QC, trim, QC, fq2fa (fastp defaults)           host, io/fastq.py
      fna -> clean (split at N runs) + GC + assembly stats   host, io/clean.py
      faa -> registered as protein samples
    per round (nucleotide, then protein, prodigal, fgs):      process_round
      chunk large files                                        host, io/chunker.py
      one codec per round                                      _group_plan
      count: launch groups on the device, fetched in waves     _count_group
        (several cards: batches sorted across them)            _count_group_mesh
        (k > 256: the exact host path, per file)              _count_group_host
        -> tsv_{type}/{sample}_counts.tsv
      combined TSVs + k-mer summary (+ PCA with -pca)          _create_figures
      beta diversity (report/diversity or report/beta_diversity)
      alpha diversity per sample  -> report/diversity/{type}-{sample}.tsv
    GC plot; ORF calling (-prod, -fgs) feeds the prodigal/fgs rounds
    report/report.html, metrics-{type}.tsv/.html, diversity-{type}.tsv

``-device-metrics`` computes the protein metrics and alpha diversity with
the port's torch functions on the count device; ``-debug`` prints host RAM
at each stage and writes a ``torch.profiler`` trace to ``torch_trace/``.
``-mesh N`` (and ``auto``, the default) count over ``min(N, cards)`` of
the host's CUDA cards with the sharded sort-count of ``parallel.count``
when that is more than one (:func:`_resolve_mesh`). A multi-process run
(torchrun's ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``)
joins a gloo process group: each process counts its share of the input
files (``parallel.dist.host_shard``) and writes its samples' outputs, and
rank 0 writes the combined ones, as the JAX package's multi-host branches
do. Nothing is silently skipped.
"""

from __future__ import annotations

import contextlib
import dataclasses
import shutil
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from mercat2_tpu_torch.device import resolve_device
from mercat2_tpu_torch.engine.codec import (
    alphabet_of, canonical_codec, codec_for_alphabet,
)
from mercat2_tpu_torch.engine.counter import KmerCounter, fetch_tables
from mercat2_tpu_torch.engine.host import (
    _REC_GAP, count_file_host, merge_tables, source_for,
)
from mercat2_tpu_torch.io import fastq as fq_mod
from mercat2_tpu_torch.io.chunker import maybe_chunk
from mercat2_tpu_torch.io.clean import remove_n
from mercat2_tpu_torch.io.fasta import parse_fasta_seq
from mercat2_tpu_torch.io.native import open_fasta_native
from mercat2_tpu_torch.metrics.alpha import compute_alpha_diversity
from mercat2_tpu_torch.metrics.assembly import write_assembly_stats
from mercat2_tpu_torch.metrics.beta import compute_beta_diversity
from mercat2_tpu_torch.ops.build_keys import KERNEL_K
from mercat2_tpu_torch.parallel import flat_mesh, sharded_count_sources
from mercat2_tpu_torch.parallel.dist import (
    barrier, host_shard, init_distributed, is_coordinator,
)
from mercat2_tpu_torch.report import figures as figs
from mercat2_tpu_torch.report.html import write_html
from mercat2_tpu_torch.report.tsv import merge_tsv, merge_tsv_T, write_counts_tsv
from mercat2_tpu_torch.utils.runtime import DebugTrace

__all__ = ["PipelineConfig", "run_pipeline"]

FILE_EXT_FASTQ = [".fq", ".fastq", ".fq.gz", ".fastq.gz"]
FILE_EXT_NUCLEOTIDE = [
    ".fasta", ".fa", ".fna", ".ffn",
    ".fasta.gz", ".fa.gz", ".fna.gz", ".ffn.gz",
]
FILE_EXT_PROTEIN = [".faa", ".faa.gz"]


@dataclasses.dataclass
class PipelineConfig:
    """The JAX pipeline's configuration, plus the device to count on."""

    kmer: int
    input_files: list = dataclasses.field(default_factory=list)
    input_folder: str | None = None
    min_count: int = 10
    num_cores: int = 0  # 0 = auto
    chunk_size_mb: int = 100
    output: str = "mercat_results"
    replace: bool = False
    lowmem: bool | None = None  # incremental PCA; None = by sample count
    skipclean: bool = False
    toupper: bool = False
    pca: bool = False
    prodigal: bool = False  # -prod: ORF call (pyrodigal if present, else native)
    fgs: bool = False  # -fgs: second ORF round (FragGeneScanRs, else native)
    category_file: str | None = None  # sample classes for the PCA plot
    debug: bool = False
    #: protein metrics and alpha diversity with the port's torch functions
    #: on ``device`` (float64); off, the JAX package's host path
    device_metrics: bool = False
    mesh: str = "auto"
    #: "cuda" (the kernels) or "cpu" (the plain twins); never chosen for you
    device: str = "cuda"


def _resolve_mesh(policy: str, device: torch.device) -> list | None:
    """PipelineConfig.mesh -> the cards to shard the count over, or None
    (one device). ``auto`` takes every CUDA card of this host, ``N`` the
    first ``min(N, cards)``; one card, ``off`` and the CPU (one device)
    give None. Each process of a multi-host run meshes over its own
    host's cards: hosts own disjoint files, so counting never crosses
    hosts (``mercat2_tpu/pipeline.py:248-269``)."""
    if policy == "off":
        return None
    want = None if policy == "auto" else int(policy)
    if device.type != "cuda":
        return None
    n = torch.cuda.device_count()
    want = n if want is None else min(want, n)
    return flat_mesh(want) if want > 1 else None


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
    tables: dict[str, list] = {basename: [] for basename in group}
    inflight: deque = deque()  # (names, pendings)

    def fetch_wave() -> None:
        names, pendings = inflight.popleft()
        for name, tbl in zip(names, fetch_tables(pendings)):
            tables[name].append(tbl)

    with contextlib.closing(_batches(
            group, counter.codec, workers, handles, 2 * counter._UNIFORM_FILES,
            2 * counter._UNIFORM_SYMS)) as waves:
        for wave in waves:
            try:
                pendings = counter.dispatch_packed_uniform(
                    [s for _, s in wave], min_count, workers
                )
            finally:
                for _, s in wave:
                    s.close()
            inflight.append(([n for n, _ in wave], pendings))
            while len(inflight) > 2:
                fetch_wave()
    while inflight:
        fetch_wave()
    return _write_tables(tables, counter.k, out_tsv_dir)


def _batches(group: dict, codec, workers: int | None, handles: dict,
             max_files: int, max_syms: int):
    """The round's files as lists of (basename, source), cut at
    ``max_files`` files or once past ``max_syms`` symbols. Threads open
    and parse the files ahead; the caller closes the sources of every
    list it takes, and closing the generator closes those not handed out.
    """
    jobs = [(basename, f) for basename, files in group.items() for f in files]
    batch: list[tuple] = []
    syms = 0
    with ThreadPoolExecutor(max_workers=workers) as pool:
        build_ahead = max(8, 2 * (workers or 4))
        pend = deque(jobs)
        building: deque = deque()
        try:
            while pend or building:
                while pend and len(building) < build_ahead:
                    bname, f = pend.popleft()
                    building.append((bname, pool.submit(
                        source_for, f, codec, handles.pop(f, None))))
                bname, fut = building.popleft()
                source = fut.result()
                batch.append((bname, source))
                syms += source.packed_len(_REC_GAP)
                if len(batch) >= max_files or syms > max_syms:
                    full, batch, syms = batch, [], 0
                    yield full
            if batch:
                full, batch = batch, []
                yield full
        finally:  # on an error, close what is open
            for _, s in batch:
                s.close()
            for _, fut in building:
                fut.result().close()


def _write_tables(tables: dict, k: int, out_tsv_dir: Path) -> dict:
    """Merge each sample's per-file tables and write its count TSV."""
    tsv_list: dict[str, Path] = {}
    for basename, tbls in tables.items():
        merged = merge_tables(tbls, k)
        if len(merged):
            print(f"Significant k-mers: {len(merged)}")
            tsv_list[basename] = write_counts_tsv(
                merged, basename, out_tsv_dir / f"{basename}_counts.tsv"
            )
        else:
            print("No significant k-mers found")
    return tsv_list


#: a mesh batch is cut at this many files or symbols
#: (mercat2_tpu/pipeline.py:292, 344)
_MESH_FILES = 32
_MESH_SYMS = 256 << 20


def _count_group_mesh(group: dict, counter: KmerCounter, min_count: int,
                      out_tsv_dir: Path, workers: int | None, handles: dict,
                      devices: list) -> dict:
    """Count every sample of a round across ``devices`` and write its TSV.

    Threads open and parse the files ahead; every ``_MESH_FILES`` files or
    ``_MESH_SYMS`` symbols, the batch is counted in one sharded
    sort-count (``parallel.count.sharded_count_sources``), which returns
    exact per-file filtered tables. Every source is closed once its batch
    is counted. Port of ``mercat2_tpu.pipeline._count_group_mesh``; the
    dense route is not taken under a mesh, as there.
    """
    tables: dict[str, list] = {basename: [] for basename in group}
    with contextlib.closing(_batches(group, counter.codec, workers, handles,
                                     _MESH_FILES, _MESH_SYMS)) as batches:
        for batch in batches:
            try:
                counted = sharded_count_sources(counter, [s for _, s in batch],
                                                min_count, devices)
            finally:
                for _, s in batch:
                    s.close()
            for (name, _), tbl in zip(batch, counted):
                tables[name].append(tbl)
    return _write_tables(tables, counter.k, out_tsv_dir)


def _count_group_host(group: dict, k: int, min_count: int,
                      out_tsv_dir: Path) -> dict:
    """k above the key-build kernel's bound: the JAX package's exact host
    path (mercat2_tpu/pipeline.py:386-397), per file, merged per sample.
    Chosen by k alone, before any launch; never a fallback."""
    print(f"k={k} > {KERNEL_K[1]}: counting on the host (exact numpy path)")
    tsv_list: dict[str, Path] = {}
    for basename, files in group.items():
        merged = merge_tables([count_file_host(f, k, min_count) for f in files], k)
        if len(merged):
            tsv_list[basename] = write_counts_tsv(
                merged, basename, out_tsv_dir / f"{basename}_counts.tsv"
            )
    return tsv_list


def _create_figures(tsv_list: dict, type_string: str, out_path: Path,
                    cfg: PipelineConfig) -> dict:
    """Combined TSVs, the k-mer summary and, with ``-pca`` and more than
    3 samples, the PCA plot (MerCat2's bin/mercat2.py:141-181)."""
    print(f"\nCreating {type_string} Graphs")
    fig_plots = {}
    combined = out_path / f"combined_{type_string}.tsv"
    if not combined.exists():
        merge_tsv(tsv_list, combined)
    combined_t = out_path / f"combined_{type_string}_T.tsv"
    if not combined_t.exists():
        merge_tsv_T(tsv_list, combined_t)
    fig_plots[f"Combined {type_string} kmer Summary"] = figs.kmer_summary(combined)
    if cfg.pca and len(tsv_list) > 3:
        print("\nRunning PCA")
        out_pca = out_path / f"pca_{type_string}"
        pca3d, pca2d = figs.plot_pca(combined_t, out_pca, cfg.lowmem,
                                     cfg.category_file, cfg.debug)
        if pca3d:
            fig_plots[f"{type_string} PCA 3D"] = pca3d
        if pca2d:
            fig_plots[f"{type_string} PCA 2D"] = pca2d
    return fig_plots


def _prepare_output(cfg: PipelineConfig) -> Path:
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
    return out


def run_pipeline(cfg: PipelineConfig) -> Path:
    """Run every round and the report; returns the output folder.

    In a multi-process run (see the module docstring) only rank 0 makes
    the output folder, and every process waits for it before it starts.
    """
    device = resolve_device(cfg.device)
    multi = init_distributed()
    coordinator = (not multi) or is_coordinator()
    out = _prepare_output(cfg) if coordinator else Path(cfg.output)
    if multi:
        barrier("outdir")
    debug = DebugTrace(cfg.debug, out / "torch_trace" if cfg.debug else None,
                       device)
    with debug:  # the trace is written even when a stage raises
        _run(cfg, device, out, debug, multi, coordinator)
    print("\nFinished MerCat2-TPU Pipeline")
    return out


def _run(cfg: PipelineConfig, device: torch.device, out: Path,
         debug: DebugTrace, multi: bool, coordinator: bool) -> None:
    """Load, every round, the report (the body of :func:`run_pipeline`)."""
    workers = cfg.num_cores or None
    cleanpath = out / "clean"
    report_dir = out / "report"
    report_dir.mkdir(parents=True, exist_ok=True)
    metrics_device = device if cfg.device_metrics else None

    print(f"\nStarting MerCat2-TPU (PyTorch, {device}) with k-mer {cfg.kmer}\n")
    print("Loading files")
    t_start = time.perf_counter()
    samples: dict[str, dict[str, list[Path]]] = {
        "nucleotide": {}, "protein": {}, "prodigal": {}, "fgs": {}
    }
    gc_content: dict[str, float] = {}

    def load_fastq(path: Path, basename: str):
        fq_mod.qc(path, cleanpath, basename)
        f = path
        if not cfg.skipclean:
            f = fq_mod.trim(f, cleanpath, basename)
            fq_mod.qc(f, cleanpath, basename)
        return basename, fq_mod.fq2fa(f, cleanpath, basename)

    def load_contig(path: Path, basename: str):
        if cfg.skipclean:
            return basename, path, None
        cleaned, stat = remove_n(path, cleanpath, cfg.toupper)
        return basename, cleaned, stat

    inputs = _discover_inputs(cfg)
    if multi:  # deterministic per-host file ownership (no task queue)
        inputs = host_shard(inputs)
    with ThreadPoolExecutor(max_workers=workers) as pool:
        futures = []
        for path in inputs:
            path = Path(path).expanduser().absolute()
            ext = _file_ext(path)
            basename = path.name.removesuffix(ext)
            if ext in FILE_EXT_FASTQ:  # reads: no stats, no GC entry
                futures.append(("fastq", pool.submit(load_fastq, path, basename)))
            elif ext in FILE_EXT_NUCLEOTIDE:
                futures.append(("fna", pool.submit(load_contig, path, basename)))
                futures.append(("stats", pool.submit(
                    write_assembly_stats, path, out / "stats" / f"{basename}.txt")))
            elif ext in FILE_EXT_PROTEIN:
                samples["protein"][basename] = [path]
        for kind, fut in futures:
            res = fut.result()
            if kind == "fastq":
                basename, fasta = res
                samples["nucleotide"][basename] = [fasta]
            elif kind == "fna":
                basename, cleaned, stat = res
                samples["nucleotide"][basename] = [cleaned]
                if stat:
                    gc_content[basename] = stat["GC Content"]
    n_files = len(samples["nucleotide"]) + len(samples["protein"])
    print(f"Time to load {n_files} files: "
          f"{round(time.perf_counter() - t_start, 2)} seconds")
    debug.stage("load")

    fig_plots: dict = {}
    diversity_outputs: dict[str, list[Path]] = {}
    mesh = _resolve_mesh(cfg.mesh, device)

    def count_round(sample_type: str, type_string: str, group: dict) -> dict:
        """chunk -> count for one sample family; its count TSVs."""
        if cfg.chunk_size_mb > 0:
            dir_chunks = out / f"chunks_{sample_type}"
            for basename, files in group.items():
                _, group[basename] = maybe_chunk(
                    basename, files[0], cfg.chunk_size_mb, dir_chunks / basename)

        print(f"Processing {type_string}")
        out_tsv = out / f"tsv_{sample_type}"
        out_tsv.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        codec, handles = _group_plan(group, workers)
        tsv_list: dict[str, Path] = {}
        try:
            if codec is not None and cfg.kmer > KERNEL_K[1]:
                tsv_list = _count_group_host(group, cfg.kmer, cfg.min_count,
                                             out_tsv)
            elif codec is not None and mesh is not None:
                counter = KmerCounter(cfg.kmer, codec, device)
                tsv_list = _count_group_mesh(group, counter, cfg.min_count,
                                             out_tsv, workers, handles, mesh)
            elif codec is not None:
                counter = KmerCounter(cfg.kmer, codec, device)
                tsv_list = _count_group(group, counter, cfg.min_count,
                                        out_tsv, workers, handles)
        finally:
            for nf in handles.values():  # any not consumed by the count
                nf.close()
        print(f"Time to count {cfg.kmer}-mers: "
              f"{round(time.perf_counter() - t0, 2)} seconds")
        debug.stage(f"count {type_string}")
        return tsv_list

    def process_round(sample_type: str, type_string: str) -> None:
        """count -> figures -> diversity for one sample family. In a
        multi-host run every host takes part, samples or none: alpha
        diversity of its own samples, a barrier, then rank 0 alone reads
        every host's count TSVs back from the shared tree for the
        combined TSVs and beta diversity (mercat2_tpu/pipeline.py:819-851)."""
        group = samples[sample_type]
        if not group and not multi:
            return
        tsv_list = count_round(sample_type, type_string, group) if group else {}

        def alpha(own: dict) -> None:
            div_dir = report_dir / "diversity"
            div_dir.mkdir(parents=True, exist_ok=True)
            for basename, tsv in own.items():
                outfile = div_dir / f"{sample_type}-{basename}.tsv"
                compute_alpha_diversity(basename, tsv, outfile, metrics_device)
                diversity_outputs.setdefault(basename, []).append(outfile)

        t0 = time.perf_counter()
        if multi:
            alpha(tsv_list)
            barrier(f"count-{type_string}")
            if not coordinator:
                return
            tsv_list = {f.name.removesuffix("_counts.tsv"): f
                        for f in sorted((out / f"tsv_{sample_type}").glob("*_counts.tsv"))}
        if tsv_list:
            fig_plots.update(_create_figures(tsv_list, type_string, out, cfg))
            beta_dir = report_dir / (
                "diversity" if sample_type == "nucleotide" else "beta_diversity")
            compute_beta_diversity(
                type_string, out / f"combined_{type_string}_T.tsv", beta_dir)
        if not multi:
            alpha(tsv_list)
        print(f"Time for {type_string} figures and diversity: "
              f"{round(time.perf_counter() - t0, 2)} seconds")

    process_round("nucleotide", "Nucleotide")
    if gc_content:
        fig_plots["Sample GC Summary"] = figs.gc_plot_sample(gc_content)

    def orf_round(engine: str, outdir: Path, target: str) -> None:
        """ORF calls of every nucleotide sample, file-parallel. The fan-out
        is capped: a FragGeneScanRs process peaks above 1 GB on a
        multi-Mbp genome, and the gene model gains little past 4 threads."""
        from mercat2_tpu_torch.orf import orf_call

        items = list(samples["nucleotide"].items())
        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=min(workers or 4, 4)) as pool:
            rets = pool.map(
                lambda bf: orf_call(bf[0], bf[1][0], outdir, engine=engine),
                items)
            for ret in rets:
                if ret:
                    samples[target][ret[0]] = [ret[1]]
        print(f"Time to call ORFs ({engine}): "
              f"{round(time.perf_counter() - t0, 2)} seconds")

    if cfg.prodigal and samples["nucleotide"]:
        print(f"\nRunning ORF caller on {len(samples['nucleotide'])} files")
        orf_round("prodigal", out / "pyrodigal", "prodigal")
    if cfg.fgs and samples["nucleotide"]:
        print(f"\nRunning FGS-style ORF caller on "
              f"{len(samples['nucleotide'])} files")
        orf_round("fgs", out / "fgs", "fgs")

    for sample_type in ("protein", "prodigal", "fgs"):
        process_round(sample_type, sample_type)

    if multi:
        barrier("rounds")
    if coordinator:
        _write_report(report_dir, fig_plots, samples, metrics_device,
                      diversity_outputs, multi)
    if multi:
        barrier("finish")
    debug.stage("finish")


def _write_report(report_dir: Path, fig_plots: dict, samples: dict,
                  metrics_device, diversity_outputs: dict, multi: bool) -> None:
    """report.html, the protein metrics and the merged diversity; rank 0
    alone writes them in a multi-host run, from every host's per-sample
    diversity files in the shared tree."""
    t0 = time.perf_counter()
    write_html(report_dir / "report.html", fig_plots, {})
    for sample_type in ("protein", "fgs", "prodigal"):
        if samples[sample_type]:
            metric_figs = figs.plot_sample_metrics(
                samples[sample_type], report_dir / f"metrics-{sample_type}.tsv",
                device=metrics_device)
            write_html(report_dir / f"metrics-{sample_type}.html", metric_figs, {})

    # per-type merge of the per-sample diversity (bin/mercat2.py:479-499)
    print("Gathering Diversity Metrics")
    if multi:  # every host wrote {type}-{sample}.tsv to the shared tree
        div_files = sorted((report_dir / "diversity").glob("*-*.tsv"))
    else:
        div_files = [f for files in diversity_outputs.values() for f in files]
    by_type: dict[str, dict[str, Path]] = {}
    for f in div_files:
        typ, _, sample = f.stem.partition("-")  # "{type}-{sample}"
        by_type.setdefault(typ, {})[sample] = f
    for typ, tomerge in by_type.items():
        if len(tomerge) >= 2:
            key = "Nucleotide" if typ == "nucleotide" else typ
            merge_tsv(tomerge, report_dir / f"diversity-{key}.tsv")
    print(f"Time to write the report: {round(time.perf_counter() - t0, 2)} seconds")
