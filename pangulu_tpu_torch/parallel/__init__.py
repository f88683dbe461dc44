"""Distributed execution over a p x q grid of ranks (torch.distributed).

Counterpart of ``pangulu_tpu.parallel``, and through it of the
reference's MPI layer (pangulu_communication.c) and 2D block-cyclic
distribution (PANGULU_CALC_RANK, pangulu_common.h:135).

**Execution model: SPMD, one process a rank**, as the C reference runs
under ``mpirun -np P`` (examples/example.c) and as the JAX package runs
a multi-host job (pangulu_tpu/parallel/multihost.py:1-21):

- The caller creates the process group, through
  :func:`multihost.distributed_init` (``backend="nccl"`` for one rank a
  card, ``"gloo"`` otherwise; the default rendezvous is ``env://``, what
  ``torchrun`` sets) or by itself.  With ``strict`` (the default when
  arguments are passed) a failed initialisation raises; it never
  degrades quietly to independent single-process runs.
- ``InitOptions(mesh_shape=(p, q))``, or ``"auto"`` for
  :func:`mesh.grid_shape` of the world size, needs that group with world
  size p·q, else ``init`` raises ``ValueError``.  Rank ``r·q + c`` holds
  grid coordinate (r, c) and owns block (i, j) when (i % p, j % q) =
  (r, c) (:func:`mesh.owner`).  Each rank takes ``cuda:{rank %
  torch.cuda.device_count()}`` unless the caller names a device;
  ``device="cpu"`` runs the plain versions, as everywhere in the port.
  With ``backend="nccl"`` two ranks on one card raise before the group
  carries any data (no switch to gloo).
- Every rank calls ``init``, ``gstrf``, ``gstrs``, ``update_values`` and
  ``finalize`` in the same order, with the same matrix and right-hand
  side.  The host preprocessing (reorder, symbolic, schedule) runs on
  every rank and must come out identical: rank 0 broadcasts a digest
  of the distributed tables and a mismatch raises on every rank.
  ``gstrs`` returns the same x on every rank.  A handle of p·q > 1 holds
  only its rank's shard of the factors: ``save_factor``,
  ``factor_diagnostics``, ``gstrs_device`` and ``gstrs(trans=True)``
  refuse it.

Every collective is a (masked) all-reduce, as the JAX engines' only
collective is ``psum``: gloo takes CUDA tensors for ``all_reduce`` and
``broadcast`` only.  So four ranks on ONE card, joined by gloo (which
stages CUDA tensors through the host), run the whole multi-device path
there; NCCL, one rank a card, makes the same calls.  gloo connects over
the loopback device; where the host name does not resolve, set
``GLOO_SOCKET_IFNAME=lo`` in every rank's environment.

- :mod:`mesh`: ``grid_shape``, ``owner`` and :class:`mesh.Grid` (the
  counterpart of ``jax.sharding.Mesh``: p, q, this rank's (r, c), its
  device and its world, row and column groups);
- :mod:`multihost`: ``distributed_init``, ``is_primary`` and the shard
  helpers;
- :mod:`dist_numeric`: the block-cyclic layout and
  :class:`dist_numeric.DistributedLU` (f32/f64; K1 on every rank);
- :mod:`dist_sptrsv`: :class:`dist_sptrsv.DistributedTriangularSolver`.
"""
