"""Input stages of the port that cannot reuse ``mercat2_tpu.io`` as it is
(``fastq.qc``)."""
