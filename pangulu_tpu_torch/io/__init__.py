from pangulu_tpu_torch.io.checkpoint import (handle_from_arrays, load_factor,
                                             save_factor)
from pangulu_tpu_torch.io.mmio import read_matrix, read_rhs, write_matrix

__all__ = ["handle_from_arrays", "load_factor", "save_factor",
           "read_matrix", "read_rhs", "write_matrix"]
