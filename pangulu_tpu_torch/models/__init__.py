from pangulu_tpu_torch.models.generators import (
    arrowhead,
    circuit,
    poisson2d,
    poisson3d,
    random_unsymmetric,
    smallworld,
    trefethen,
)

__all__ = [
    "trefethen",
    "circuit",
    "poisson2d",
    "poisson3d",
    "random_unsymmetric",
    "arrowhead",
    "smallworld",
]
