from prosper_tpu_torch.models.linear import BSC, DSC, TSC

__all__ = ["BSC", "TSC", "DSC"]
