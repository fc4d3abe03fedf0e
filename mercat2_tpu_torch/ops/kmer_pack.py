"""Rolling multiword k-mer pack in plain PyTorch.

Port of ``mercat2_tpu.ops.kmer_pack`` (``key_words_for`` and both forms of
``pack_kmer_words``). Key words are carried as int32 bit patterns of the
JAX package's uint32 words: PyTorch on the CPU has no logical right shift
for unsigned types, so every ``>>`` here is an arithmetic shift followed by
a mask.
"""

from __future__ import annotations

import torch

__all__ = ["key_words_for", "pack_kmer_words"]


def key_words_for(k: int, bits: int) -> tuple[int, bool]:
    """(total sort-key words, has_tiebreak_word).

    The payload is ``ceil(k*bits/32)`` words. When ``k*bits`` exactly fills
    the payload, an extra tie-break word (0 = valid, ~0 = invalid) is
    appended so the all-ones invalid marker cannot collide with a real key
    (e.g. ``T``*16 under 2-bit DNA).
    """
    payload = max(1, -(-(k * bits) // 32))
    tiebreak = k * bits == 32 * payload
    return payload + int(tiebreak), tiebreak


def pack_kmer_words(codes: torch.Tensor, k: int, bits: int) -> list[torch.Tensor]:
    """For each window start i, big-endian pack ``codes[i:i+k]``.

    Args:
        codes: int32[N] symbol codes (only the low ``bits`` bits are used).

    Returns:
        ``ceil(k*bits/32)`` int32[N-k+1] words, most significant first;
        symbol 0 of the window sits in the most significant bits, so the
        unsigned order of the word tuple is the lexicographic order of
        windows.
    """
    if 32 % bits == 0:
        return _pack_kmer_words_tree(codes, k, bits)
    return _pack_kmer_words_serial(codes, k, bits)


def _pack_kmer_words_serial(codes: torch.Tensor, k: int, bits: int) -> list[torch.Tensor]:
    """k-step shift-OR chain; handles symbols split across word boundaries
    (bits not dividing 32, e.g. 5-bit protein codes)."""
    p = codes.shape[0] - k + 1
    payload = max(1, -(-(k * bits) // 32))
    mask_b = (1 << bits) - 1

    words = [torch.zeros(p, dtype=torch.int32, device=codes.device)
             for _ in range(payload)]
    for j in range(k):
        c = codes[j : j + p] & mask_b
        # the bits that leave word w+1 at the top enter word w at the bottom
        shifted = [
            (words[w] << bits) | ((words[w + 1] >> (32 - bits)) & mask_b)
            for w in range(payload - 1)
        ]
        shifted.append((words[payload - 1] << bits) | c)
        words = shifted
    return words


def _pack_kmer_words_tree(codes: torch.Tensor, k: int, bits: int) -> list[torch.Tensor]:
    """Log-tree pack for word-aligned symbol widths (bits | 32).

    P_m[i] = codes[i:i+m) packed into the low m*bits bits, for m = 1, 2, 4,
    ... while m*bits <= 32; each output word's symbol range is composed
    from its binary decomposition.
    """
    p = codes.shape[0] - k + 1
    payload = max(1, -(-(k * bits) // 32))
    per = 32 // bits

    pows = [codes & ((1 << bits) - 1)]
    m = 1
    while 2 * m <= per:
        pm = pows[-1]
        avail = pm.shape[0] - m  # P_{2m} has this many entries
        pows.append((pm[:avail] << (m * bits)) | pm[m : m + avail])
        m *= 2

    def pack_range(a: int, s: int) -> torch.Tensor:
        """Pack of codes[i+a : i+a+s) (s*bits <= 32) for every window i."""
        acc = None
        off, rem = a, s
        for j in range(len(pows) - 1, -1, -1):
            mj = 1 << j
            if rem >= mj:
                part = pows[j][off : off + p]
                acc = part if acc is None else (acc << (mj * bits)) | part
                off += mj
                rem -= mj
        assert rem == 0
        return acc

    kb0 = k * bits - 32 * (payload - 1)  # bits used in word 0
    s0 = kb0 // bits                     # symbols in word 0
    words = [pack_range(0, s0)]
    a = s0
    for _ in range(payload - 1):
        words.append(pack_range(a, per))
        a += per
    return words
