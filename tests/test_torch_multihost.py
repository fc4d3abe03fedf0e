"""The port's multi-host run and its mesh pipeline, on the CPU.

- ``host_shard`` against the JAX package's.
- Two port processes joined by a gloo process group on 127.0.0.1 (the
  variables torchrun sets: ``MASTER_ADDR``, ``MASTER_PORT``,
  ``WORLD_SIZE``, ``RANK``), each ``-device cpu``, write one output tree:
  it must equal a one-process port run and the JAX CLI's tree. The one
  file that differs by design is ``report/report.html``: as in the JAX
  package (mercat2_tpu/pipeline.py:908-940), rank 0 writes it with the GC
  plot of its own samples only, so it is left out of the comparison.
- The mesh pipeline (``_count_group_mesh``) with ``_resolve_mesh`` patched
  to four CPU shards: its tree must equal the JAX CLI's ``-mesh 4`` tree.
"""

import os
import shutil
import socket
import subprocess
import sys
from pathlib import Path

import torch

from mercat2_tpu import cli as jax_cli
from mercat2_tpu.parallel.dist import host_shard as jax_host_shard
from mercat2_tpu_torch import cli, pipeline
from mercat2_tpu_torch.parallel.dist import host_shard
from test_torch_report import run_both, same_tree, write_contigs

REPO = Path(__file__).resolve().parent.parent


def test_host_shard_matches_jax():
    for n_items in (0, 1, 5, 7, 12):
        items = [f"s{i}" for i in range(n_items)][::-1]
        for n in (1, 2, 3):
            parts = [host_shard(items, p, n) for p in range(n)]
            assert parts == [jax_host_shard(items, p, n) for p in range(n)]
            assert sorted(x for part in parts for x in part) == sorted(items)
    assert host_shard([Path("b"), Path("a")]) == [Path("a"), Path("b")]  # no group: all


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


ARGS = ["-k", 21, "-c", 2]


def test_two_processes_write_the_one_process_tree(monkeypatch, tmp_path):
    folder = write_contigs(tmp_path / "in", 5, seed=23, n_rec=3, n_orf=4)
    jax_tree, one = run_both(monkeypatch, tmp_path, [*ARGS, "-f", folder])
    same_tree(jax_tree, one)

    two = tmp_path / "two"
    env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
               WORLD_SIZE="2")
    code = ("import sys\n"
            f"sys.path.insert(0, {str(REPO)!r})\n"
            "from mercat2_tpu_torch.cli import main\n"
            f"main({[str(a) for a in ARGS] + ['-f', str(folder), '-o', str(two), '-replace', '-n', '2', '-device', 'cpu']!r})\n")
    procs = [subprocess.Popen([sys.executable, "-c", code], env=dict(env, RANK=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in (0, 1)]
    try:
        outs = [p.communicate(timeout=50)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, text in zip(procs, outs):
        assert p.returncode == 0, text[-3000:]
    # each process counted its own share of the samples
    assert "Significant k-mers" in outs[0] and "Significant k-mers" in outs[1]

    html = "report/report.html"
    assert "Sample GC Summary" in (two / html).read_text()
    for tree in (one, two):
        (tree / html).unlink()
    files = same_tree(one, two)
    assert "combined_Nucleotide.tsv" in files
    assert "report/diversity-Nucleotide.tsv" in files
    assert sum(f.startswith("tsv_nucleotide/") for f in files) == 5


def test_mesh_pipeline_matches_jax_mesh(monkeypatch, tmp_path):
    """The port's mesh route over four CPU shards writes the JAX CLI's
    ``-mesh 4`` tree (its mesh route on four virtual devices)."""
    folder = write_contigs(tmp_path / "in", 4, seed=29, n_rec=3, n_orf=4)
    faa = write_contigs(tmp_path / "p", 1, seed=30, n_rec=2, n_orf=4)
    shutil.copy(faa / "s0.fna", folder / "t0.fna")
    common = [*map(str, ARGS), "-f", str(folder), "-replace", "-n", "2"]
    jax_cli.main(common + ["-o", str(tmp_path / "jax"), "-mesh", "4"])

    seen = []

    def four_cpu_shards(policy, device):
        seen.append(policy)
        return [torch.device("cpu")] * 4

    monkeypatch.setattr(pipeline, "_resolve_mesh", four_cpu_shards)
    calls = []
    inner = pipeline.sharded_count_sources
    monkeypatch.setattr(pipeline, "sharded_count_sources",
                        lambda *a, **kw: calls.append(len(a[1])) or inner(*a, **kw))
    cli.main(common + ["-o", str(tmp_path / "torch"), "-device", "cpu", "-mesh", "4"])
    assert seen == ["4"] and calls == [5]
    files = same_tree(tmp_path / "jax", tmp_path / "torch")
    assert sum(f.startswith("tsv_nucleotide/") for f in files) == 5
