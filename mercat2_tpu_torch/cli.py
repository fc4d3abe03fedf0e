"""Command-line interface of the port: the flags of ``mercat2_tpu.cli``
(MerCat2's bin/mercat2.py:37-81), plus ``-device``.

    python -m mercat2_tpu_torch.cli -k 21 -f <folder> -o <out> -c 10 -replace

Counts on the CUDA card unless ``-device cpu`` asks for the plain PyTorch
path; with no card it exits non-zero. ``-device-metrics`` computes the
protein metrics and alpha diversity on the same device. ``-mesh auto``
(the default) and ``-mesh N`` shard the count over ``min(N, cards)`` of
the host's CUDA cards when that is more than one. Started by torchrun (or
with ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK`` set),
each process counts its share of the input files and rank 0 writes the
combined outputs (see ``pipeline``).
"""

from __future__ import annotations

import argparse
import os
import sys

from mercat2_tpu_torch.version import __version__
from mercat2_tpu_torch.device import NoCudaError


def strtobool(v: str) -> bool:
    v = v.lower()
    if v in ("y", "yes", "t", "true", "on", "1"):
        return True
    if v in ("n", "no", "f", "false", "off", "0"):
        return False
    raise ValueError(f"invalid truth value {v!r}")


def parseargs(argv=None):
    num_cores = os.cpu_count() or 1
    parser = argparse.ArgumentParser(
        prog="mercat2-tpu-torch",
        formatter_class=argparse.RawDescriptionHelpFormatter,
        description="k-mer counter (MerCat2-compatible) in PyTorch with "
        "CUDA kernels for NVIDIA Hopper",
    )
    parser.add_argument("-i", required=False, default=list(),
                        help="path to input file", nargs="+")
    parser.add_argument("-f", type=str, required=False,
                        help="path to folder containing input files")
    parser.add_argument("-k", type=int, required=True, help="kmer length")
    parser.add_argument("-n", type=int, default=num_cores,
                        help="no of host worker threads [auto detect]")
    parser.add_argument("-c", type=int, default=10, help="minimum kmer count [10]")
    parser.add_argument("-prod", action="store_true",
                        help="run ORF calling on fasta files")
    parser.add_argument("-fgs", action="store_true",
                        help="run a second ORF annotation round (FragGeneScanRs)")
    parser.add_argument("-s", type=int, default=100, required=False,
                        help="Split into x MB files. [100]")
    parser.add_argument("-o", type=str, default="mercat_results", required=False,
                        help="Output folder, default = 'mercat_results' in current directory")
    parser.add_argument("-replace", action="store_true",
                        help="Replace existing output directory [False]")
    parser.add_argument("-lowmem", type=strtobool, default=None,
                        help="Flag to use incremental PCA when low memory is available. [auto]")
    parser.add_argument("-skipclean", action="store_true",
                        help="skip trimming of fastq files")
    parser.add_argument("-toupper", action="store_true",
                        help="convert all input sequences to uppercase")
    parser.add_argument("-category_file", type=str, default=None, help=argparse.SUPPRESS)
    parser.add_argument("-debug", action="store_true", help=argparse.SUPPRESS)
    parser.add_argument("-mesh", type=str, default="auto",
                        help="count-engine device mesh: 'auto' (every CUDA "
                        "card of the host), 'off' or N (the first N cards)")
    parser.add_argument("-device-metrics", dest="device_metrics",
                        action="store_true",
                        help="protein metrics and alpha diversity on the "
                        "count device (float64)")
    parser.add_argument("-pca", action="store_true",
                        help="create interactive PCA plot of the samples")
    parser.add_argument("-device", type=str, default="cuda",
                        choices=("cuda", "cpu"),
                        help="count on the CUDA card (the kernels) or on the "
                        "CPU (their plain PyTorch twins) [cuda]")
    parser.add_argument("--version", "-v", action="version",
                        version=f"MerCat2-TPU (PyTorch):\n version: {__version__}")

    args = parser.parse_args(argv)

    if not args.i and not args.f:
        parser.error("Please provide either an input file (-i) or an input folder (-f)")
    for filename in args.i:
        if not os.path.isfile(filename):
            parser.error(f"file '{filename}' is not valid.\n")
    if args.f and not os.path.isdir(args.f):
        parser.error(f"folder {args.f} is not valid.\n")
    return args, parser


def main(argv=None):
    args, parser = parseargs(argv)
    from mercat2_tpu_torch.pipeline import PipelineConfig, run_pipeline

    cfg = PipelineConfig(
        kmer=args.k,
        input_files=list(args.i),
        input_folder=args.f,
        min_count=args.c,
        num_cores=args.n,
        chunk_size_mb=args.s,
        output=args.o,
        replace=args.replace,
        lowmem=args.lowmem,
        skipclean=args.skipclean,
        toupper=args.toupper,
        pca=args.pca,
        prodigal=args.prod,
        fgs=args.fgs,
        category_file=args.category_file,
        debug=args.debug,
        mesh=args.mesh,
        device_metrics=args.device_metrics,
        device=args.device,
    )
    try:
        run_pipeline(cfg)
    except NoCudaError as e:
        parser.exit(2, f"{parser.prog}: error: {e}\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
