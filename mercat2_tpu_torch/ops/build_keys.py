"""Key build: packed transport words + validity -> masked sort-key columns.

The port of the Pallas kernel ``build_keys_pallas``
(``mercat2_tpu/ops/pallas_finalize.py:420-493``, bits in {1, 2, 4}) and of
the JAX package's key build for the other packable widths, bits in
{3, 5, 6} (``unpack_codes`` + the serial chain of ``ops/kmer_pack.py`` +
``build_keyed_words``), which has no Pallas kernel. ``build_keys`` launches
the CUDA kernel in ``csrc/build_keys.cu`` for a CUDA tensor and takes the
plain twin :func:`build_keys_plain` for a CPU tensor; a CUDA tensor the
kernel does not take raises, it never falls back to the twin.
"""

from __future__ import annotations

import torch

from mercat2_tpu_torch.ops import _build
from mercat2_tpu_torch.ops.finalize import build_keyed_words, unpack_codes
from mercat2_tpu_torch.ops.kmer_pack import key_words_for, pack_kmer_words

__all__ = ["build_keys", "build_keys_plain", "KERNEL_BITS", "KERNEL_K"]

#: symbol widths and k the kernel covers: every width of the packed
#: transport (``counter.py:959``) up to the JAX device bound on k
#: (``_MAX_DEVICE_K``, ``counter.py:49``)
KERNEL_BITS = (1, 2, 3, 4, 5, 6)
KERNEL_K = (1, 256)


def build_keys_plain(packed: torch.Tensor, valid: torch.Tensor, *, k: int,
                     bits: int, p: int) -> tuple[torch.Tensor, ...]:
    """Plain-torch twin: unpack, rolling pack, mask (any k and bits)."""
    codes = unpack_codes(packed, bits, packed.shape[0] * (32 // bits))
    payload = [w[:p] for w in pack_kmer_words(codes, k, bits)]
    keyed, _ = build_keyed_words(payload, valid[:p] != 0, None, k, bits, 1)
    return tuple(keyed)


def build_keys(packed: torch.Tensor, valid: torch.Tensor, *, k: int,
               bits: int, p: int) -> tuple[torch.Tensor, ...]:
    """Masked sort-key columns of the first ``p`` windows.

    Args:
        packed: int32[W] big-endian packed symbols (host transport layout,
            uint32 bit patterns), W * (32 // bits) >= p + k - 1.
        valid: bool or uint8[>= p] window validity.

    Returns:
        ``total_words`` int32[p] columns: the payload words (first symbol
        most significant, all-ones where invalid), plus the tie-break word
        (0 valid, all-ones invalid) when k * bits fills the words exactly.
    """
    if packed.device.type == "cpu":
        return build_keys_plain(packed, valid, k=k, bits=bits, p=p)
    if bits not in KERNEL_BITS or not KERNEL_K[0] <= k <= KERNEL_K[1]:
        raise ValueError(
            f"build_keys kernel covers bits in {KERNEL_BITS} and "
            f"{KERNEL_K[0]} <= k <= {KERNEL_K[1]}; got bits={bits}, k={k}"
        )
    per = 32 // bits
    if packed.dtype != torch.int32 or packed.dim() != 1:
        raise ValueError(f"packed must be 1-D int32, got {packed.dtype}")
    if packed.shape[0] * per < p + k - 1:
        raise ValueError(f"{packed.shape[0]} words hold too few symbols for p={p}")
    if valid.dtype == torch.bool:
        valid = valid.view(torch.uint8)
    if valid.dtype != torch.uint8 or valid.shape[0] < p or valid.device != packed.device:
        raise ValueError("valid must be bool/uint8[>= p] on the packed words' device")
    packed = packed.contiguous()
    valid = valid.contiguous()
    total, tiebreak = key_words_for(k, bits)
    payload = total - int(tiebreak)
    kb0 = k * bits - 32 * (payload - 1)
    out = torch.empty((total, p), dtype=torch.int32, device=packed.device)
    lib = _build.load_library()
    rc = lib.m2t_build_keys(
        packed.data_ptr(), packed.shape[0], valid.data_ptr(), out.data_ptr(),
        p, bits, payload, kb0, int(tiebreak), _build.stream_of(packed.device),
    )
    _build.check(rc, "build_keys")
    build_keys.launches += 1
    return tuple(out.unbind(0))


#: kernel launches since the last reset (CPU tensors never count)
build_keys.launches = 0
