"""Device half of the count engine: launch groups, pending counts, fetch.

Port of the uniform count path of ``mercat2_tpu.engine.counter``
(``dispatch_packed_uniform``, ``dispatch_packed_fixed``,
``_PendingPacked``, ``fetch_tables``). Files are greedy-packed into
fid-tagged launches of at most 32 files and ``_UNIFORM_SYMS`` symbols; a
file above that bound gets a launch of its own at its own size (in the
JAX package it took the adaptive per-file-segment path; the tables are
the same). Gone, because they existed only for XLA compile cost or the
TPU link: the size and gap-slot families, the fixed padding of every
launch to one shape, the speculative fetch prefix and prewarm. A round
whose keyspace ``S**k`` is at most ``ops.dense_hist.MAX_BINS`` bins its
windows in the same launches instead of sorting them (the JAX package's
dense sibling; its fixed two-file slots existed for XLA compile cost).

Host-to-device copies go through pinned buffers with ``non_blocking``;
nothing waits for the device until :func:`fetch_tables`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mercat2_tpu_torch.engine.codec import Codec
from mercat2_tpu_torch.engine.host import (
    _REC_GAP, KmerTable, PackedGroup, _bucket_size, _split_dense_tables,
    _split_fid_tables, build_packed_group,
)
from mercat2_tpu_torch.ops.dense_hist import MAX_BINS, count_kmers_dense, keyspace
from mercat2_tpu_torch.ops.finalize import count_kmers_packed, fid_layout

__all__ = ["KmerCounter", "TorchGroup", "fetch_tables", "to_torch_group"]


@dataclasses.dataclass
class TorchGroup:
    """A :class:`PackedGroup` on a torch device (uint32 as int32 bits)."""

    words: torch.Tensor        # int32[n_sym // per]
    n_sym: int
    file_starts: torch.Tensor  # int32[n_files]
    gap_begin: torch.Tensor    # int32[G]
    gap_end: torch.Tensor      # int32[G]


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        # pinned staging: the copy runs asynchronously on the current stream
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def to_torch_group(group: PackedGroup, device) -> TorchGroup:
    """A host transport buffer (built by either package) on ``device``."""
    device = torch.device(device)
    return TorchGroup(
        words=_to_device(group.words.view(np.int32), device),
        n_sym=int(group.n_sym),
        file_starts=_to_device(group.file_starts.astype(np.int32), device),
        gap_begin=_to_device(group.gap_begin.astype(np.int32), device),
        gap_end=_to_device(group.gap_end.astype(np.int32), device),
    )


class _EmptyPending:
    def __init__(self, k: int):
        self._k = k

    def table(self) -> KmerTable:
        return KmerTable.empty(self._k)


class _PendingPacked:
    """Result of one fid-tagged launch; split per file at fetch time.

    ``n_out > cap`` (more survivors than rows) reruns the launch with a
    cap that holds them, as the JAX package does.
    """

    def __init__(self, counter: "KmerCounter", dev: TorchGroup,
                 min_count: int, cap: int, mode: str, shift: int,
                 n_files: int, out):
        self._c = counter
        self._dev = dev  # kept for the overflow rerun
        self._min_count = min_count
        self._cap = cap
        self._mode = mode
        self._shift = shift
        self._n_files = n_files
        self._out = out  # (words, counts, n_out) on the device
        self._tables: list[KmerTable] | None = None

    def _resolve(self, n_out: int) -> None:
        c = self._c
        words, counts, _ = self._out
        while n_out > self._cap:  # overflow: rerun with room (rare)
            self._cap = _bucket_size(n_out)
            words, counts, n = c._count(self._dev, self._min_count, self._cap,
                                        self._n_files)
            n_out = int(n)
        self._out = self._dev = None
        if n_out == 0:
            self._tables = [KmerTable.empty(c.k)] * self._n_files
            return
        host = torch.stack([w[:n_out] for w in words] + [counts[:n_out]]).cpu()
        small = list(host.numpy().view(np.uint32))
        small[-1] = small[-1].view(np.int32)
        self._tables = _split_fid_tables(
            c.k, c.codec, small, n_out, self._mode, self._shift, self._n_files
        )

    def row_table(self, row: int) -> KmerTable:
        if self._tables is None:
            self._resolve(int(self._out[2]))
        return self._tables[row]


class _PendingDense:
    """Result of one dense launch; split per file at fetch time. Every
    surviving bin has a row, so there is no overflow rerun."""

    def __init__(self, counter: "KmerCounter", n_files: int, out):
        self._c = counter
        self._n_files = n_files
        self._out = out  # (bins, counts, n_out) on the device
        self._tables: list[KmerTable] | None = None

    def _resolve(self, n_out: int) -> None:
        bins, counts, _ = self._out
        self._out = None
        host = torch.stack([bins[:n_out], counts[:n_out]]).cpu().numpy()
        self._tables = _split_dense_tables(self._c.k, self._c.codec, host[0],
                                           host[1], self._n_files)

    def row_table(self, row: int) -> KmerTable:
        if self._tables is None:
            self._resolve(int(self._out[2]))
        return self._tables[row]


class _MultiView:
    """One file's slice of a combined launch."""

    def __init__(self, multi: _PendingPacked, row: int):
        self._multi = multi
        self._row = row

    def table(self) -> KmerTable:
        return self._multi.row_table(self._row)


def fetch_tables(pendings: list) -> list[KmerTable]:
    """Fetch every pending count: one sync reads all launches' ``n_out``,
    then each launch copies its survivor prefix to the host."""
    multis: list[_PendingPacked] = []
    for p in pendings:
        m = getattr(p, "_multi", None)
        if m is not None and m._tables is None and all(m is not x for x in multis):
            multis.append(m)
    if multis:
        n_outs = torch.stack([m._out[2].reshape(()) for m in multis]).tolist()
        for m, n in zip(multis, n_outs):
            m._resolve(int(n))
    return [p.table() for p in pendings]


class KmerCounter:
    """Counter for one (k, codec) on one device."""

    #: symbols per launch (the JAX package's largest uniform shape)
    _UNIFORM_SYMS = 12 << 20
    #: files per fid-tagged launch; the fid layout is always chosen for
    #: this many, as in the JAX package
    _UNIFORM_FILES = 32
    #: output rows per launch before the overflow rerun
    _UNIFORM_CAP = 1 << 19

    def __init__(self, k: int, codec: Codec, device):
        if k < 1:
            raise ValueError("k must be >= 1")
        self.k = k
        self.codec = codec
        self.device = torch.device(device)
        #: the dense route: bins instead of a sort (keyspace <= MAX_BINS)
        self.dense = keyspace(k, codec.bits, codec.size) <= MAX_BINS

    def fits_uniform(self, source) -> bool:
        """True when ``source`` fits one shared launch of _UNIFORM_SYMS
        symbols; a file that does not gets a launch of its own."""
        per = 32 // self.codec.bits
        return source.packed_len(_REC_GAP) + per <= self._UNIFORM_SYMS

    def dispatch_packed_uniform(self, sources: list, min_count: int = 1,
                                workers: int | None = None) -> list:
        """Enqueue the counts of all sources; one pending per source.

        Greedy in input order: a launch takes files while their
        word-aligned segments fit ``_UNIFORM_SYMS`` symbols and it has
        fewer than ``_UNIFORM_FILES`` files. Each launch's buffer is sized
        to its content, with no padding to a fixed shape.
        """
        per = 32 // self.codec.bits
        segs = [-(-(s.packed_len(_REC_GAP) + 1) // per) * per for s in sources]
        groups: list[list[int]] = []
        cur: list[int] = []
        cur_sym = 0
        for i, (s, seg) in enumerate(zip(sources, segs)):
            if not self.fits_uniform(s):
                groups.append([i])
                continue
            if cur and (cur_sym + seg > self._UNIFORM_SYMS
                        or len(cur) >= self._UNIFORM_FILES):
                groups.append(cur)
                cur, cur_sym = [], 0
            cur.append(i)
            cur_sym += seg
        if cur:
            groups.append(cur)

        results: list = [None] * len(sources)
        for g in groups:
            subset = [sources[i] for i in g]
            built = build_packed_group(self.k, self.codec, subset, workers)
            if built is None:
                for i in g:
                    results[i] = _EmptyPending(self.k)
                continue
            pending = self.dispatch_packed_fixed(built, min_count, len(g))
            for r, i in enumerate(g):
                results[i] = _MultiView(pending, r)
        return results

    def dispatch_packed_fixed(self, group: PackedGroup, min_count: int,
                              n_real_files: int):
        """Enqueue one fid-tagged launch of ``group`` (non-blocking),
        dense or sorted. ``file_starts`` is padded here to
        ``_UNIFORM_FILES`` entries."""
        n_files = self._UNIFORM_FILES
        starts = np.full(n_files, group.n_sym, np.int32)
        starts[:n_real_files] = group.file_starts
        dev = to_torch_group(
            dataclasses.replace(group, file_starts=starts), self.device
        )
        if self.dense:
            return _PendingDense(self, n_files, count_kmers_dense(
                dev.words, dev.gap_begin, dev.gap_end, dev.file_starts,
                min_count, k=self.k, bits=self.codec.bits,
                alphabet_size=self.codec.size, n_files=n_files,
                n_sym=dev.n_sym,
            ))
        mode, shift = fid_layout(self.k, self.codec.bits, n_files)
        cap = self._UNIFORM_CAP
        out = self._count(dev, min_count, cap, n_files)
        return _PendingPacked(self, dev, min_count, cap, mode, shift,
                              n_files, out)

    def _count(self, dev: TorchGroup, min_count: int, cap: int, n_files: int):
        return count_kmers_packed(
            dev.words, dev.gap_begin, dev.gap_end, dev.file_starts,
            min_count, k=self.k, bits=self.codec.bits, cap=cap,
            n_files=n_files, n_sym=dev.n_sym,
        )
