"""Examples of the PyTorch port, the counterparts of the JAX package's
examples that are not TPU-specific (``examples/`` at the repository's
root):

    python -m pangulu_tpu_torch.examples.run_trefethen [--device cpu]
    python -m pangulu_tpu_torch.examples.run_refactorize [--device cpu]
    python -m pangulu_tpu_torch.examples.run_circuit_compressed [--device cpu]

Each runs on the card unless ``--device cpu`` asks for the plain
versions, and each has a ``main(argv)`` that returns its numbers.
"""
