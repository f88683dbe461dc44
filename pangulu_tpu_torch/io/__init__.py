from pangulu_tpu_torch.io.checkpoint import (handle_from_arrays, load_factor,
                                             save_factor)

__all__ = ["handle_from_arrays", "load_factor", "save_factor"]
