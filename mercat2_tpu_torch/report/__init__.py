from mercat2_tpu_torch.report.tsv import write_counts_tsv

__all__ = ["write_counts_tsv"]
