from mercat2_tpu_torch.io.fasta import (
    read_file_bytes,
    parse_fasta_seq,
    iter_fasta_records,
)

__all__ = ["read_file_bytes", "parse_fasta_seq", "iter_fasta_records"]
