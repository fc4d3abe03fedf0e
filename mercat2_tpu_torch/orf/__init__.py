from mercat2_tpu_torch.orf.caller import orf_call

__all__ = ["orf_call"]
