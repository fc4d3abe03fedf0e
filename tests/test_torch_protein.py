"""The protein path of the port against the JAX package, on the CPU: the
key build for the widths that do not divide 32 (3-bit soft-masked DNA,
5-bit protein, 6-bit mixed-case protein), and the port's CLI against the
JAX CLI on the inputs that take it (``.faa`` files, the ORF rounds, and
the k the key build now covers). Count TSVs must be byte-identical.

The key-build kernel itself (``csrc/build_keys.cu``) is held against
``build_keys_plain`` on the card in tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mercat2_tpu.ops import finalize as jfin
from mercat2_tpu.ops import kmer_pack as jpack
from mercat2_tpu_torch.ops.build_keys import build_keys_plain
from test_torch_cuda import i32, u32
from test_torch_report import (
    assert_rows, run_both, same_tree, write_contigs, write_proteins,
)


# -- key build for bits that do not divide 32 ---------------------------------


@pytest.mark.parametrize("bits", [3, 5, 6])
@pytest.mark.parametrize("k", [1, 5, 6, 7, 21, 130])
def test_build_keys_plain_matches_jax(k, bits):
    """The twin against JAX's unpack_codes + pack_kmer_words (the serial
    chain for these widths) + build_keyed_words, exact, with invalid
    windows and the tie-break word where k * bits fills its words."""
    rng = np.random.default_rng(100 * k + bits)
    per = 32 // bits
    n_sym = 300 * per
    codes = rng.integers(0, 1 << bits, size=n_sym).astype(np.uint32)
    shifts = (32 - bits * (np.arange(per) + 1)).astype(np.uint32)
    words = np.bitwise_or.reduce(codes.reshape(-1, per) << shifts, axis=1)
    p = n_sym - k + 1
    valid = rng.random(p) < 0.9

    jcodes = jfin.unpack_codes(jnp.asarray(words), bits, n_sym)
    payload = [w[:p] for w in jpack.pack_kmer_words(jcodes, k, bits)]
    want, _ = jfin.build_keyed_words(payload, jnp.asarray(valid), None, k, bits, 1)
    got = build_keys_plain(i32(words), torch.from_numpy(valid), k=k, bits=bits, p=p)
    assert len(got) == len(want)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), u32(g))


# -- the CLI on the inputs of the protein path ----------------------------------


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    root = tmp_path_factory.mktemp("protein_inputs")
    faa = write_proteins(root / "faa", 3, seed=5)
    mixed = write_proteins(root / "mixed", 2, seed=6,
                           alphabet="ACDEFGHIKLMNPQRSTVWYacdefghiklmnpqrs")
    soft = write_contigs(root / "soft", 2, seed=9, n_orf=3)
    for p in soft.iterdir():  # soft-masked stretches: an 8-letter alphabet
        text = p.read_text().splitlines()
        text[1] = text[1].lower()
        p.write_text("\n".join(text) + "\n")
    return {"faa": faa, "mixed": mixed, "soft": soft,
            "orf": write_contigs(root / "orf", 2, seed=8),
            "big": write_proteins(root / "big", 2, seed=12, n_prot=7000)}


#: (input, extra arguments, the count folders that must hold tables).
#: Besides .faa at k in {3, 5, 21}: a 6-bit mixed-case protein alphabet,
#: 3-bit soft-masked DNA, k=1 and k=130 (outside the TPU kernel's range),
#: the ORF rounds, and files above ``-s 1`` MB, counted in chunks.
CLI_CASES = {
    "faa-k3": ("faa", ["-k", 3], ["tsv_protein"]),
    "faa-k5": ("faa", ["-k", 5], ["tsv_protein"]),
    "faa-k21": ("faa", ["-k", 21], ["tsv_protein"]),
    "faa-6bit-k6": ("mixed", ["-k", 6], ["tsv_protein"]),
    "soft-3bit-k5": ("soft", ["-k", 5], ["tsv_nucleotide"]),
    "nt-k1": ("orf", ["-k", 1], ["tsv_nucleotide"]),
    "nt-k130": ("orf", ["-k", 130], ["tsv_nucleotide"]),
    "prod-fgs-k5": ("orf", ["-k", 5, "-prod", "-fgs"],
                    ["tsv_nucleotide", "tsv_prodigal", "tsv_fgs"]),
    "faa-chunked-k5": ("big", ["-k", 5, "-s", 1], ["tsv_protein"]),
}


@pytest.mark.parametrize("case", list(CLI_CASES))
def test_cli_matches_jax_cli(monkeypatch, tmp_path, inputs, case):
    src, extra, filled = CLI_CASES[case]
    jax_tree, torch_tree = run_both(
        monkeypatch, tmp_path, ["-f", inputs[src], "-c", 2, *extra])
    files = same_tree(jax_tree, torch_tree)
    if "-s" in extra:
        assert sum(f.startswith("chunks_protein/") for f in files) >= 4
    n_files = len(list(inputs[src].iterdir()))
    for sub in filled:
        assert_rows(torch_tree, sub, n_files)
