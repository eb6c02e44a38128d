"""Multi-device distribution: a 1-D row-partitioned mesh on ``torch.distributed``.

Port of ``sparse_matrix_math_tpu/parallel/``: ``mesh.py``, ``dist.py``,
``dist_dia.py``, ``dist_stencil.py``, ``dist_wsell.py``, ``dist_rsell.py``,
``dist_df64.py`` and ``dist_multigrid.py``.  One process per
device; every rank runs the same program on its own row block, and a
distributed operand carries the mesh (the process group) it was built on.
The JAX concepts map so:

==============================================  ===============================================
JAX (``sparse_matrix_math_tpu/parallel/``)       Port
==============================================  ===============================================
1-D ``jax.sharding.Mesh`` over one process's     :class:`RowMesh`: a process group, this rank,
devices (``mesh.py:107-122``)                    the world size, this rank's device and the axis
                                                 name; ``make_mesh(n_devices=None, *, axis,
                                                 group=None)`` over the default group, whose
                                                 size ``n_devices`` must equal
``init_distributed(...,                          ``init_distributed(init_method, world_size,
simulate_cpu_devices=k)`` (``mesh.py:44-78``)    rank, *, device=None)``: ``cuda:{LOCAL_RANK}``
                                                 over NCCL by default, gloo only for
                                                 ``device="cpu"``, an error with neither;
                                                 ``spawn_cpu_world(fn, k, *args)`` runs ``k``
                                                 gloo CPU ranks over a ``FileStore``
``put_sharded`` / ``gather_to_host``             each rank copies only its own row block of the
(``mesh.py:79-104``)                             same host array (zero-padded to P·B) to its
                                                 device; gathering is an ``all_gather`` to a
                                                 host array, on every rank
``jax.lax.ppermute`` ring, fwd ``(i, i+1 mod     ``halo_exchange(x_local, mesh) -> (left,
P)`` / bwd (``dist.py:288-292``,                 right)`` with the same wrap (``batch_isend_
``dist_dia.py:138-143``,                         irecv`` in one fixed order); a peer that is
``dist_wsell.py:185-189``); both df words in     the rank itself gets the block with no wire
one payload (``dist_df64.py:154-158``)           traffic (world size 1); ``halo_start`` on a
                                                 ``(2, B)`` stack for the double-word product
non-wrapping ``ppermute`` of edge planes         ``open_halo_exchange(x_local, mesh) ->
(``dist_multigrid.py:196-203``)                  (prev_last, next_first)``: zeros at the edge
                                                 ranks and at world size 1
``shard_map`` of a per-shard routed chain,       each rank builds and runs only its own chain:
passes padded and stacked to one shape           K11 per pass and K7 last over the
(``dist_rsell.py:166-218``)                      all-gathered x, no padding to the shards'
                                                 largest
``all_gather`` of the P (hi, lo) partials and    the same: ``all_gather`` of this rank's pair,
a pairwise double-word tree                      then ``ops/df32.py:_df_pairwise_reduce`` in
(``dist_df64.py:195-201``)                       rank order on every rank
``psum`` of a local partial (``dist.py:309-      ``all_reduce(SUM)`` of the local ``torch.dot``
315``); GMRES's ``paneldot``; pipelined CG's     (a 0-d tensor on the rank's device), of the
fused pair                                       panel vector, or of the stacked pair: one
                                                 collective per JAX ``psum``
``all_gather(..., tiled=True)``                  ``all_gather_into_tensor`` under NCCL, the list
(``dist.py:302``)                                form under gloo
``mesh_of`` / ``resolve_mesh``                   the operand's own mesh; a shard-count mismatch
(``mesh.py:125-161``)                            raises the JAX ``ValueError``, an axis-name
                                                 mismatch a ``ValueError`` naming both axes
==============================================  ===============================================

A solve's host reads (solvers/_loop.py) see only all-reduced values, so
every rank takes the same branch; each group's collectives time out after
:data:`mesh.GROUP_TIMEOUT`.  A solve's ``x`` is the rank's block; ``collect``
gathers it.

On CUDA devices (``python -m torch.distributed.run --nproc_per_node=N``)
the W-SELL shard product is the K7 kernel, the routed one K11 per pass and
K7 last, and nothing moves to the CPU, to gloo or to a plain product when
the card, NCCL or a kernel fails.  The other shard products (CSR, DIA,
stencil, double-word DIA, the multigrid levels) are plain PyTorch, as they
are plain ``jnp`` in the JAX package.
"""

from .dist import (
    DistCSR,
    DistPreconditioner,
    collect,
    dist_solve,
    dist_spmv,
    distribute_csr,
    distribute_preconditioner,
    distribute_vector,
)
from .dist_df64 import (
    DistDfDia,
    dist_bicgstab_ir_df64,
    dist_cg_ir_df64,
    dist_df_dia_spmv,
    distribute_df_dia,
)
from .dist_dia import DistDIA, dist_dia_solve, dist_dia_spmv, distribute_dia
from .dist_multigrid import DistPoissonMG, dist_mg_solve, dist_mg_vcycle, distribute_multigrid
from .dist_rsell import DistRouted, dist_routed_solve, dist_routed_spmv, distribute_routed
from .dist_stencil import (
    DistStencil,
    dist_stencil_solve,
    dist_stencil_spmv,
    distribute_stencil,
)
from .dist_wsell import DistWSell, dist_wsell_solve, dist_wsell_spmv, distribute_wsell
from .mesh import (
    ROW_AXIS,
    RowMesh,
    gather_to_host,
    halo_exchange,
    init_distributed,
    open_halo_exchange,
    make_mesh,
    put_sharded,
    replicated_sharding,
    row_sharding,
    spawn_cpu_world,
)

__all__ = [
    "DistCSR",
    "DistDIA",
    "DistWSell",
    "DistRouted",
    "distribute_routed",
    "dist_routed_spmv",
    "dist_routed_solve",
    "DistDfDia",
    "distribute_df_dia",
    "dist_df_dia_spmv",
    "dist_cg_ir_df64",
    "dist_bicgstab_ir_df64",
    "DistPoissonMG",
    "distribute_multigrid",
    "dist_mg_solve",
    "dist_mg_vcycle",
    "dist_wsell_solve",
    "dist_wsell_spmv",
    "distribute_wsell",
    "dist_dia_solve",
    "dist_dia_spmv",
    "DistStencil",
    "distribute_stencil",
    "dist_stencil_solve",
    "dist_stencil_spmv",
    "distribute_dia",
    "DistPreconditioner",
    "collect",
    "dist_solve",
    "dist_spmv",
    "distribute_csr",
    "distribute_preconditioner",
    "distribute_vector",
    "ROW_AXIS",
    "RowMesh",
    "make_mesh",
    "replicated_sharding",
    "row_sharding",
    "init_distributed",
    "spawn_cpu_world",
    "halo_exchange",
    "open_halo_exchange",
    "put_sharded",
    "gather_to_host",
]
