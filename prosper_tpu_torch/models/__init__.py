from prosper_tpu_torch.models.gsc import GSC
from prosper_tpu_torch.models.linear import BSC, DSC, TSC
from prosper_tpu_torch.models.mca import MCA, MMCA

__all__ = ["BSC", "TSC", "DSC", "MCA", "MMCA", "GSC"]
