from mercat2_tpu_torch.metrics.alpha import compute_alpha_diversity, ALPHA_METRICS
from mercat2_tpu_torch.metrics.beta import compute_beta_diversity, BETA_METRICS

__all__ = [
    "compute_alpha_diversity",
    "ALPHA_METRICS",
    "compute_beta_diversity",
    "BETA_METRICS",
]
