from pangulu_tpu_torch.reorder.driver import Reordering, reorder
from pangulu_tpu_torch.reorder.matching import mc64_scale_and_match
from pangulu_tpu_torch.reorder.fill_reducing import fill_reducing_order

__all__ = ["reorder", "Reordering", "mc64_scale_and_match",
           "fill_reducing_order"]
