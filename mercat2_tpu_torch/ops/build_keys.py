"""Key build: packed transport words + validity -> the sort-key column(s).

The port of the Pallas kernel ``build_keys_pallas``
(``mercat2_tpu/ops/pallas_finalize.py:420-493``, bits in {1, 2, 4}) and of
the JAX package's key build for every other codec width, bits in
{3, 5, 6, 7, 8} (``unpack_codes`` + the serial chain of
``ops/kmer_pack.py`` + ``build_keyed_words`` for 3-6, and the uint8
stream path's ``count_kmers_device`` for 7 and 8), which has no Pallas
kernel. The port packs every width, 7 and 8 bits four symbols a word.
The key build also does what the JAX ``count_kmers_packed`` runs after it
before the sort: the file-id tag of a launch of several files (embedded
in word 0, or a leading fid word, as :func:`~mercat2_tpu_torch.ops.finalize.fid_layout`
says), the fuse of a 2-word key into one sign-flipped int64 column
(:func:`~mercat2_tpu_torch.ops.finalize.fuse_u64`), and the count of valid
windows. ``build_keys`` launches the CUDA kernel in ``csrc/build_keys.cu``
for a CUDA tensor and takes the plain twin :func:`build_keys_plain` for a
CPU tensor; a CUDA tensor the kernel does not take raises, it never falls
back to the twin.
"""

from __future__ import annotations

import torch

from mercat2_tpu_torch.ops import _build
from mercat2_tpu_torch.ops.finalize import (
    build_keyed_words, fid_layout, fuse_u64, unpack_codes,
)
from mercat2_tpu_torch.ops.kmer_pack import key_words_for, pack_kmer_words

__all__ = ["build_keys", "build_keys_plain", "KERNEL_BITS", "KERNEL_K", "MAX_FILES"]

#: symbol widths and k the kernel covers: every codec width (a codec has
#: at most 255 symbols) up to the JAX device bound on k (``_MAX_DEVICE_K``,
#: ``counter.py:49``); larger k takes the host path
KERNEL_BITS = (1, 2, 3, 4, 5, 6, 7, 8)
KERNEL_K = (1, 256)
#: file starts the kernel holds in shared memory (a launch has 32)
MAX_FILES = 256

_ONES32 = -1


def build_keys_plain(packed: torch.Tensor, valid: torch.Tensor,
                     file_starts: torch.Tensor | None = None, *, k: int,
                     bits: int, p: int, n_files: int = 1):
    """Plain-torch twin: unpack, rolling pack, mask; the fid tag; the fuse
    of two columns; the count of valid windows (any k and bits)."""
    ok = valid[:p] if valid.dtype == torch.bool else valid[:p] != 0
    codes = unpack_codes(packed, bits, packed.shape[0] * (32 // bits))
    payload = [w[:p] for w in pack_kmer_words(codes, k, bits)]
    keyed, _ = build_keyed_words(payload, ok, None, k, bits, 1)
    if n_files > 1:
        total, tiebreak = key_words_for(k, bits)
        mode, shift = fid_layout(k, bits, n_files)
        pos = torch.arange(p, device=packed.device)
        fid = torch.searchsorted(file_starts.to(torch.int64), pos, right=True) - 1
        if mode == "embedded":
            # invalid rows are all-ones already, and ONES | x == ONES
            keyed[0] = keyed[0] | (fid << shift).to(torch.int32)
        else:  # the fid word takes the tie-break word's place
            keyed = ([torch.where(ok, fid.to(torch.int32), _ONES32)]
                     + keyed[: total - int(tiebreak)])
    if len(keyed) == 2:
        keyed = [fuse_u64(keyed)]
    return tuple(keyed), ok.sum()


def build_keys(packed: torch.Tensor, valid: torch.Tensor,
               file_starts: torch.Tensor | None = None, *, k: int, bits: int,
               p: int, n_files: int = 1):
    """The sort-key column(s) of the first ``p`` windows, and their count
    of valid windows.

    Args:
        packed: int32[W] big-endian packed symbols (host transport layout,
            uint32 bit patterns), W * (32 // bits) >= p + k - 1.
        valid: bool or uint8[>= p] window validity.
        file_starts: int32 or int64 [n_files] sorted first window of each
            file (read when ``n_files > 1``); window i belongs to the last
            file whose start is <= i.
        n_files: files sharing the launch; the fid layout is chosen for it.

    Returns:
        (cols, n_valid). ``cols`` holds the payload words (first symbol
        most significant, all-ones where invalid) with the fid tag: for
        ``n_files == 1`` plus the tie-break word (0 valid, all-ones
        invalid) when k * bits fills the words exactly; for ``n_files >
        1`` with the fid OR-ed into word 0, or as a leading word (fid,
        all-ones invalid) that replaces the tie-break word. Two such
        columns come as ONE int64 column, fused and sign-flipped
        (:func:`~mercat2_tpu_torch.ops.finalize.fuse_u64`); other counts
        as int32 columns. ``n_valid`` is an int64 scalar on the device.
    """
    if packed.device.type == "cpu":
        return build_keys_plain(packed, valid, file_starts, k=k, bits=bits, p=p,
                                n_files=n_files)
    if bits not in KERNEL_BITS or not KERNEL_K[0] <= k <= KERNEL_K[1]:
        raise ValueError(
            f"build_keys kernel covers bits in {KERNEL_BITS} and "
            f"{KERNEL_K[0]} <= k <= {KERNEL_K[1]}; got bits={bits}, k={k}"
        )
    per = 32 // bits
    dev = packed.device
    if packed.dtype != torch.int32 or packed.dim() != 1:
        raise ValueError(f"packed must be 1-D int32, got {packed.dtype}")
    if packed.shape[0] * per < p + k - 1:
        raise ValueError(f"{packed.shape[0]} words hold too few symbols for p={p}")
    if valid.dtype == torch.bool:
        valid = valid.view(torch.uint8)
    if valid.dtype != torch.uint8 or valid.shape[0] < p or valid.device != dev:
        raise ValueError("valid must be bool/uint8[>= p] on the packed words' device")
    total, tiebreak = key_words_for(k, bits)
    payload = total - int(tiebreak)
    kb0 = k * bits - 32 * (payload - 1)
    fid_mode, fid_shift, n_cols = 0, 0, total
    starts = packed  # unread when fid_mode is 0
    if n_files > 1:
        if (file_starts is None or file_starts.dim() != 1
                or not 1 <= file_starts.shape[0] <= MAX_FILES
                or file_starts.device != dev):
            raise ValueError(f"file_starts must be 1-D, of 1 to {MAX_FILES} "
                             "entries, on the packed words' device")
        starts = file_starts.to(torch.int32).contiguous()
        mode, fid_shift = fid_layout(k, bits, n_files)
        fid_mode, n_cols = (1, payload) if mode == "embedded" else (2, 1 + payload)
    packed = packed.contiguous()
    valid = valid.contiguous()
    if valid.data_ptr() % 16:  # the kernel reads validity in 16-byte vectors
        valid = valid.clone()
    fused = n_cols == 2
    if fused:
        ld = p
        out = torch.empty(p, dtype=torch.int64, device=dev)
    else:  # column stride a multiple of 4: every column 16-byte aligned
        ld = -(-p // 4) * 4
        out = torch.empty((n_cols, ld), dtype=torch.int32, device=dev)
    n_valid = torch.zeros(1, dtype=torch.int64, device=dev)
    lib = _build.load_library()
    with torch.cuda.device(dev):  # the launch goes to the tensors' card
        rc = lib.m2t_build_keys(
            packed.data_ptr(), packed.shape[0], valid.data_ptr(), starts.data_ptr(),
            starts.shape[0] if fid_mode else 0, out.data_ptr(), ld, n_valid.data_ptr(),
            p, k, bits, payload, kb0, int(tiebreak), fid_mode, fid_shift, n_cols,
            int(fused), _build.stream_of(dev),
        )
    _build.check(rc, "build_keys")
    build_keys.launches += 1
    cols = (out,) if fused else tuple(out[c, :p] for c in range(n_cols))
    return cols, n_valid.reshape(())


#: kernel launches since the last reset (CPU tensors never count)
build_keys.launches = 0
