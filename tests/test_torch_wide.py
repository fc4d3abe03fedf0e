"""Codecs of 7 and 8 bits, and k above the key-build kernel's bound, in the
port against the JAX package, on the CPU.

The JAX package counts 7- and 8-bit codecs through its uint8 stream path
(``dispatch_streams``, ``count_kmers_device``); the port packs them four
symbols a word into the same transport as every other width. The key
build's twin is held against the JAX ``pack_kmer_words``, the tables
against the JAX ``KmerCounter``, and the CLI's output tree against the
JAX CLI's. An 8-bit codec has more than 128 symbols, so codes of 128 and
above occur and set bit 31 of a transport word: the case that shows a
shift which is not masked.

An 8-bit alphabet cannot be printable ASCII (94 bytes), so such files
hold bytes of 0x80 and above, and both CLIs stop with the same
``UnicodeDecodeError`` in ``kmer_summary``, which reads the combined TSV
as UTF-8 text (a fault of the JAX package that the port shares, not
repaired here); the count TSVs written before it must be identical.

k > 256 takes the JAX package's exact host path in both packages.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mercat2_tpu import cli as jax_cli
from mercat2_tpu.engine.codec import Codec as JaxCodec
from mercat2_tpu.engine.counter import KmerCounter as JaxCounter
from mercat2_tpu.io.fasta import parse_fasta_seq
from mercat2_tpu.ops import finalize as jfin
from mercat2_tpu.ops import kmer_pack as jpack
from mercat2_tpu_torch import cli
from mercat2_tpu_torch.engine.codec import codec_for_bytes
from mercat2_tpu_torch.engine.counter import KmerCounter, fetch_tables
from mercat2_tpu_torch.engine.host import NumpySource
from mercat2_tpu_torch.ops.build_keys import build_keys_plain
from test_torch_cuda import i32, key_columns, u32
from test_torch_report import assert_rows, run_both, same_tree, write_contigs

#: printable ASCII less ">": 93 symbols, a 7-bit codec
PRINTABLE = bytes(b for b in range(33, 127) if b != ord(">"))
#: 132 symbols, some of them >= 0x80: an 8-bit codec
WIDE = PRINTABLE + bytes(range(161, 200))


def write_wide(folder: Path, n_files: int, seed: int, symbols: bytes,
               n_prot=12) -> Path:
    """FASTA files over ``symbols`` written as raw bytes, 60 a line: random
    records, a quarter of them led by one of 2 shared 60-symbol families
    (so that k-mers repeat), and one record of 2 symbols."""
    folder.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(symbols, np.uint8)
    fams = [alpha[rng.integers(0, alpha.size, size=60)] for _ in range(2)]
    for f in range(n_files):
        out = []
        for r in range(n_prot):
            s = alpha[rng.integers(0, alpha.size, size=int(rng.integers(30, 150)))]
            if r % 4 == 0:
                s = np.concatenate([fams[r % 2], s])
            if r == n_prot - 1:
                s = s[:2]
            out.append(f">w{f}_{r} record {r}\n".encode())
            out += [s[i : i + 60].tobytes() + b"\n" for i in range(0, s.size, 60)]
        (folder / f"wide{f}.faa").write_bytes(b"".join(out))
    return folder


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    root = tmp_path_factory.mktemp("wide_inputs")
    return {
        "7bit": write_wide(root / "7bit", 2, seed=1, symbols=PRINTABLE),
        "8bit": write_wide(root / "8bit", 2, seed=2, symbols=WIDE),
        "orf": write_contigs(root / "orf", 2, seed=4, n_orf=3),
    }


# -- the key build at 7 and 8 bits --------------------------------------------


@pytest.mark.parametrize("bits", [7, 8])
@pytest.mark.parametrize("k", [1, 3, 4, 5, 21])
def test_build_keys_plain_matches_jax(k, bits):
    """The twin against JAX's unpack_codes + pack_kmer_words +
    build_keyed_words, exact; codes >= 128 at 8 bits, the tie-break word
    where k * bits fills its words (k=4 at 8 bits)."""
    rng = np.random.default_rng(10 * k + bits)
    n_sym = 300 * 4
    codes = rng.integers(0, 1 << bits, size=n_sym).astype(np.uint32)
    codes[:8] = (1 << bits) - 1  # a slot-0 code with its top bit set
    shifts = (32 - bits * (np.arange(4) + 1)).astype(np.uint32)
    words = np.bitwise_or.reduce(codes.reshape(-1, 4) << shifts, axis=1)
    p = n_sym - k + 1
    valid = rng.random(p) < 0.9

    jcodes = jfin.unpack_codes(jnp.asarray(words), bits, n_sym)
    payload = [w[:p] for w in jpack.pack_kmer_words(jcodes, k, bits)]
    want, _ = jfin.build_keyed_words(payload, jnp.asarray(valid), None, k, bits, 1)
    got, n_valid = build_keys_plain(i32(words), torch.from_numpy(valid), k=k, bits=bits, p=p)
    got = key_columns(got)
    assert int(n_valid) == int(valid.sum())
    assert len(got) == len(want)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), u32(g))


# -- the tables at 8 bits against the JAX counter -------------------------------


@pytest.mark.parametrize("k", [1, 2, 4, 21])
def test_wide_tables_match_jax_counter(inputs, k):
    """One fid-tagged launch of both 8-bit files (dense at k=1, the fid
    word at k=4) against the JAX counter's stream path, file by file."""
    files = [parse_fasta_seq(p) for p in sorted(inputs["8bit"].iterdir())]
    codec = codec_for_bytes(np.concatenate([s for s, _ in files]))
    assert codec.bits == 8 and codec.symbols.max() >= 0x80
    jc = JaxCounter(k, JaxCodec(codec.symbols, codec.bits))
    got = fetch_tables(KmerCounter(k, codec, "cpu").dispatch_packed_uniform(
        [NumpySource(s, r, codec) for s, r in files], 2))
    for (seq, rec), g in zip(files, got):
        w = jc.count(seq, rec, 2)
        assert len(w) > 0
        np.testing.assert_array_equal(g.kmers, w.kmers)
        np.testing.assert_array_equal(g.counts, w.counts)


# -- the CLI --------------------------------------------------------------------


@pytest.mark.parametrize("min_count", [1, 2])
@pytest.mark.parametrize("k", [1, 3, 21])
def test_7bit_cli_matches_jax_cli(monkeypatch, tmp_path, inputs, k, min_count):
    jax_tree, torch_tree = run_both(
        monkeypatch, tmp_path, ["-k", k, "-f", inputs["7bit"], "-c", min_count])
    same_tree(jax_tree, torch_tree)
    assert_rows(torch_tree, "tsv_protein", 2)


@pytest.mark.parametrize("k", [1, 2, 4, 21])
def test_8bit_cli_stops_where_jax_cli_stops(monkeypatch, tmp_path, inputs, k):
    monkeypatch.setattr(JaxCounter, "_UNIFORM_SYMS", 1 << 16)
    common = ["-k", str(k), "-f", str(inputs["8bit"]), "-c", "2", "-n", "2"]
    errors = {}
    for name, main, extra in (("jax", jax_cli.main, ["-mesh", "off"]),
                              ("torch", cli.main, ["-device", "cpu"])):
        with pytest.raises(UnicodeDecodeError) as exc:
            main(common + ["-o", str(tmp_path / name), *extra])
        assert any(e.name == "kmer_summary" for e in exc.traceback), name
        errors[name] = str(exc.value)
    assert errors["jax"] == errors["torch"]
    tsvs = same_tree(tmp_path / "jax" / "tsv_protein", tmp_path / "torch" / "tsv_protein")
    assert tsvs == ["wide0_counts.tsv", "wide1_counts.tsv"]
    for t in tsvs:  # rows, some of them holding bytes >= 0x80
        data = (tmp_path / "torch" / "tsv_protein" / t).read_bytes()
        assert data.count(b"\n") > 1 and max(data) >= 0x80, t


@pytest.mark.parametrize("k", [257, 300])
def test_host_path_cli_matches_jax_cli(monkeypatch, tmp_path, inputs, k, capsys):
    """k above 256: the exact host path, per file, in both CLIs."""
    folder = tmp_path / "in"
    folder.mkdir()
    rng = np.random.default_rng(k)
    for f, src in enumerate(sorted(inputs["orf"].iterdir())):
        rep = "".join(rng.choice(list("ACGT"), size=k + 40))
        text = src.read_text() + f">rep{f}\n{rep * 3}\n>short{f}\n{rep[:k - 1]}\n"
        (folder / src.name).write_text(text)
    jax_tree, torch_tree = run_both(monkeypatch, tmp_path, ["-k", k, "-f", folder, "-c", 2])
    assert f"k={k} > 256: counting on the host" in capsys.readouterr().out
    same_tree(jax_tree, torch_tree)
    assert_rows(torch_tree, "tsv_nucleotide", 2)
