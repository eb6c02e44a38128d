"""The row mesh over a ``torch.distributed`` process group.

Port of ``sparse_matrix_math_tpu/parallel/mesh.py``.  One process per device:
a :class:`RowMesh` holds the process group, this rank, the world size, this
rank's device and the axis name, and stands where the JAX package's 1-D
``jax.sharding.Mesh`` stands (``mesh.py:107-122``).  Every collective of the
distributed layer goes through this module and is counted in
:data:`collectives`:

* :func:`all_reduce` — one ``all_reduce(SUM)`` per JAX ``psum``;
* :func:`all_gather` — ``all_gather_into_tensor`` under NCCL, the list form
  under gloo (JAX's ``all_gather(..., tiled=True)``);
* :func:`halo_start` / :func:`halo_exchange` — the ``ppermute`` ring, each
  rank's block to its right neighbour (arriving there as ``left``) and to
  its left neighbour (arriving as ``right``), with the same wrap.  A peer
  that is the rank itself gets the block back with no wire traffic (a
  ``ppermute`` to self); at world size 2 both neighbours are one rank, and
  the sends and receives are posted in one fixed order;
* :func:`open_halo_exchange` — the non-wrapping neighbour exchange of
  edge planes (the JAX package's ``dist_multigrid._halo``): the first and
  last ranks, and the only rank of a world of one, receive zeros.

Placement (:func:`put_sharded`) copies only this rank's row block of a host
array onto its device; :func:`gather_to_host` all-gathers a row-sharded
vector to a host array on every rank.
"""

from __future__ import annotations

import dataclasses
import multiprocessing
import os
import queue as _queue
import tempfile
import time
import traceback
from datetime import timedelta
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

__all__ = [
    "ROW_AXIS",
    "RowMesh",
    "Sharding",
    "make_mesh",
    "mesh_of",
    "resolve_mesh",
    "row_sharding",
    "replicated_sharding",
    "init_distributed",
    "spawn_cpu_world",
    "put_sharded",
    "gather_to_host",
    "all_reduce",
    "all_gather",
    "halo_start",
    "halo_exchange",
    "open_halo_exchange",
    "collectives",
    "reset_collective_counts",
]

ROW_AXIS = "rows"

# A collective that waits longer than this fails instead of hanging.
GROUP_TIMEOUT = timedelta(seconds=120)
# A spawned CPU world that runs longer than this (seconds) is stopped.
JOIN_TIMEOUT = 300.0
# The thread pools of a spawned CPU rank: one thread each.
_ONE_THREAD = {"OMP_NUM_THREADS": "1", "OPENBLAS_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}

# Collectives issued since the last reset: all-reduces, all-gathers, and halo
# exchanges (``halo``), of which ``halo_wire`` went over the wire (a world of
# one rank exchanges with itself).
collectives = {"all_reduce": 0, "all_gather": 0, "halo": 0, "halo_wire": 0}


def reset_collective_counts() -> None:
    for name in collectives:
        collectives[name] = 0


@dataclasses.dataclass(frozen=True, eq=False)
class RowMesh:
    """A 1-D row mesh: one rank of a process group and its device."""

    group: object            # torch.distributed ProcessGroup
    rank: int                # this process's rank in ``group``
    size: int                # ranks in ``group``: the shard count
    device: torch.device     # where this rank's shards live
    axis: str = ROW_AXIS

    @property
    def shape(self) -> dict:
        """``{axis: size}``, as ``jax.sharding.Mesh.shape``."""
        return {self.axis: self.size}

    def global_rank(self, rank: int) -> int:
        """The default group's rank of ``rank`` in this mesh's group."""
        return dist.get_global_rank(self.group, rank)

    def __repr__(self) -> str:
        return (f"RowMesh(axis={self.axis!r}, size={self.size}, rank={self.rank}, "
                f"device={self.device}, backend={dist.get_backend(self.group)})")


@dataclasses.dataclass(frozen=True)
class Sharding:
    """How an array lies on a mesh: split in row blocks along ``axis``, or
    replicated (``axis`` None)."""

    mesh: RowMesh
    axis: Optional[str]


def row_sharding(mesh: RowMesh, *, axis: str = ROW_AXIS) -> Sharding:
    """Split an array's leading dimension in row blocks over the mesh."""
    return Sharding(mesh, axis)


def replicated_sharding(mesh: RowMesh) -> Sharding:
    return Sharding(mesh, None)


def _default_device() -> torch.device:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the ranks on "
                           "the CPU over gloo")
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))


def init_distributed(
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    *,
    device=None,
) -> RowMesh:
    """Join this process to the job's default process group; returns the
    row mesh over it.

    With no arguments the group is read from the environment that
    ``python -m torch.distributed.run`` sets (``env://``), and the rank runs
    on ``cuda:{LOCAL_RANK}`` over NCCL; with no CUDA device that raises.
    ``device="cpu"`` runs the rank on the CPU over gloo (the counterpart of
    the JAX package's ``simulate_cpu_devices``; :func:`spawn_cpu_world`
    starts such ranks).  Every collective of the group times out after
    :data:`GROUP_TIMEOUT`.
    """
    dev = _default_device() if device is None else torch.device(device)
    if dev.type == "cuda":
        backend = "nccl"
        torch.cuda.set_device(dev)
    elif dev.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"unsupported device {dev}")
    kw = {}
    if world_size is not None:
        kw["world_size"] = int(world_size)
    if rank is not None:
        kw["rank"] = int(rank)
    dist.init_process_group(backend, init_method=init_method or "env://",
                            timeout=GROUP_TIMEOUT, **kw)
    return make_mesh()


def _rank_main(fn, rank, k, store_path, results, args):
    try:
        torch.set_num_threads(1)
        mesh = init_distributed(f"file://{store_path}", k, rank, device="cpu")
        results.put((rank, True, fn(mesh, *args)))
    except Exception:  # reported to the parent, which raises it
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_cpu_world(fn: Callable, k: int, *args, store_dir: Optional[str] = None) -> list:
    """Run ``fn(mesh, *args)`` on ``k`` gloo CPU ranks, one spawned process
    each, joined over a ``FileStore`` in a fresh directory under
    ``store_dir``; returns the ranks' results in rank order.

    ``fn`` must be importable by the child processes (a module-level
    function) and its results picklable.  Each rank runs one thread, in
    torch and in NumPy's BLAS (k ranks with a pool of a thread per core
    each spin against each other: a 1000 x 1000 inverse took ~5 s at 4
    ranks on 8 cores instead of ~0.05 s).  The first rank to fail, or to
    die without a result, stops the others and raises here; so does a world
    that outlasts :data:`JOIN_TIMEOUT`.
    """
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(dir=store_dir) as tmp:
        results = ctx.Queue()
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(fn, r, k, os.path.join(tmp, "store"), results, args))
                 for r in range(k)]
        saved = {name: os.environ.get(name) for name in _ONE_THREAD}
        os.environ.update(_ONE_THREAD)  # read by the children's BLAS at import
        try:
            for p in procs:
                p.start()
        finally:
            for name, value in saved.items():
                if value is None:
                    os.environ.pop(name, None)
                else:
                    os.environ[name] = value
        out, done = [None] * k, set()
        deadline = time.monotonic() + JOIN_TIMEOUT
        try:
            while len(done) < k:
                try:
                    r, ok, value = results.get(timeout=1.0)
                except _queue.Empty:
                    # a rank that exited with 0 has its result in the pipe
                    dead = [r for r, p in enumerate(procs)
                            if r not in done and p.exitcode not in (None, 0)]
                    if dead:
                        raise RuntimeError(f"rank {dead[0]} of {k} exited with code "
                                           f"{procs[dead[0]].exitcode} and no result") from None
                    if time.monotonic() > deadline:
                        raise TimeoutError(f"{k} CPU ranks did not finish in {JOIN_TIMEOUT} s"
                                           ) from None
                    continue
                if not ok:
                    raise RuntimeError(f"rank {r} of {k} failed:\n{value}")
                out[r] = value
                done.add(r)
            for p in procs:
                p.join(timeout=max(deadline - time.monotonic(), 1.0))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
    return out


def make_mesh(
    n_devices: Optional[int] = None,
    *,
    axis: str = ROW_AXIS,
    group=None,
) -> RowMesh:
    """The row mesh over ``group`` (default: the default process group).

    ``n_devices``, when given, must equal the group's size.  The device is
    this rank's CUDA device under NCCL and the CPU under gloo.
    """
    if not dist.is_initialized():
        raise RuntimeError("no process group: call init_distributed() first "
                           "(or python -m torch.distributed.run)")
    group = dist.group.WORLD if group is None else group
    size = dist.get_world_size(group)
    if n_devices is not None and int(n_devices) != size:
        if n_devices > size:
            raise ValueError(f"requested {n_devices} devices, only {size} available")
        raise ValueError(f"requested {n_devices} devices, but the process group has "
                         f"{size} ranks; make a group of {n_devices} ranks")
    if dist.get_backend(group) == "nccl":
        device = torch.device("cuda", torch.cuda.current_device())
    else:
        device = torch.device("cpu")
    return RowMesh(group=group, rank=dist.get_rank(group), size=size, device=device, axis=axis)


def mesh_of(*operands) -> Optional[RowMesh]:
    """The mesh a distributed operand was built on, or None.

    Solve-time entry points default to the operand's own mesh (its group),
    not to the process's default group.
    """
    for a in operands:
        mesh = getattr(a, "mesh", None)
        if isinstance(mesh, RowMesh):
            return mesh
    return None


def resolve_mesh(
    mesh: Optional[RowMesh],
    *operands,
    n_shards: Optional[int] = None,
    axis: str = ROW_AXIS,
) -> RowMesh:
    """An explicit ``mesh``, else the operands' mesh (:func:`mesh_of`), else
    :func:`make_mesh`, validated against the operand's shard count and axis."""
    if mesh is None:
        mesh = mesh_of(*operands)
        if mesh is None:
            mesh = make_mesh(axis=axis)
    if mesh.axis != axis:
        raise ValueError(f"mesh axis {mesh.axis!r} is not the distributed operand's "
                         f"axis {axis!r}; pass the mesh it was distributed over")
    if n_shards is not None and mesh.size != n_shards:
        raise ValueError(
            f"mesh has {mesh.size} devices on axis {axis!r} but the "
            f"distributed operand was built for {n_shards} shards; pass the "
            "mesh it was distributed over"
        )
    return mesh


def put_sharded(host_array, mesh: RowMesh, spec) -> torch.Tensor:
    """This rank's part of a host array, on the mesh's device.

    ``spec`` is a :class:`Sharding`, an axis name, or None: split in row
    blocks (the leading dimension must divide by the mesh size; this rank
    takes block ``rank``) or, for None, the whole array (replicated).
    ``host_array`` must be the same global array on every rank.
    """
    axis = spec.axis if isinstance(spec, Sharding) else spec
    arr = np.asarray(host_array)
    if axis is not None:
        if arr.shape[0] % mesh.size:
            raise ValueError(f"leading dimension {arr.shape[0]} does not split into "
                             f"{mesh.size} row blocks")
        block = arr.shape[0] // mesh.size
        arr = arr[mesh.rank * block:(mesh.rank + 1) * block]
    return torch.from_numpy(np.ascontiguousarray(arr)).to(mesh.device)


def all_reduce(t: torch.Tensor, mesh: RowMesh) -> torch.Tensor:
    """Sum of ``t`` over the mesh, in place; every rank gets the same bits."""
    collectives["all_reduce"] += 1
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=mesh.group)
    return t


def all_gather(x_local: torch.Tensor, mesh: RowMesh) -> torch.Tensor:
    """The ranks' blocks concatenated in rank order (``tiled=True``)."""
    collectives["all_gather"] += 1
    x_local = x_local.contiguous()
    if dist.get_backend(mesh.group) == "nccl":
        out = torch.empty((mesh.size * x_local.shape[0], *x_local.shape[1:]),
                          dtype=x_local.dtype, device=x_local.device)
        dist.all_gather_into_tensor(out, x_local, group=mesh.group)
        return out
    parts = [torch.empty_like(x_local) for _ in range(mesh.size)]
    dist.all_gather(parts, x_local, group=mesh.group)
    return torch.cat(parts)


def gather_to_host(x_local: torch.Tensor, mesh: RowMesh) -> np.ndarray:
    """A row-sharded array as one host array, on every rank."""
    return all_gather(x_local, mesh).cpu().numpy()


class _Halo:
    """An exchange in flight; :meth:`wait` returns ``(left, right)``."""

    def __init__(self, works, left, right):
        self._works, self._left, self._right = works, left, right

    def wait(self):
        for w in self._works:
            w.wait()
        return self._left, self._right


_FWD, _BWD = 0, 1  # message tags: block d travels to d + 1, and to d - 1


def halo_start(x_local: torch.Tensor, mesh: RowMesh) -> _Halo:
    """Post the neighbour exchange of ``x_local``: block ``d - 1`` arrives
    as ``left`` and block ``d + 1`` as ``right``, wrapping around the ring
    (JAX's two ``ppermute``\\ s, fwd ``(i, i+1 mod P)`` and bwd
    ``(i, i-1 mod P)``)."""
    collectives["halo"] += 1
    if mesh.size == 1:
        return _Halo((), x_local, x_local)
    collectives["halo_wire"] += 1
    x_local = x_local.contiguous()
    lo = mesh.global_rank((mesh.rank - 1) % mesh.size)
    hi = mesh.global_rank((mesh.rank + 1) % mesh.size)
    left, right = torch.empty_like(x_local), torch.empty_like(x_local)
    # one fixed order on every rank: at world size 2 both peers are one rank,
    # and the receiver matches the two messages in the order they were posted
    ops = [dist.P2POp(dist.isend, x_local, hi, mesh.group, _FWD),
           dist.P2POp(dist.isend, x_local, lo, mesh.group, _BWD),
           dist.P2POp(dist.irecv, left, lo, mesh.group, _FWD),
           dist.P2POp(dist.irecv, right, hi, mesh.group, _BWD)]
    return _Halo(dist.batch_isend_irecv(ops), left, right)


def halo_exchange(x_local: torch.Tensor, mesh: RowMesh):
    """``(left, right)``: the neighbour blocks of ``x_local`` (see
    :func:`halo_start`)."""
    return halo_start(x_local, mesh).wait()


def open_halo_exchange(x_local: torch.Tensor, mesh: RowMesh):
    """``(prev_last, next_first)``: the last plane (leading-axis row) of the
    previous rank's block and the first plane of the next rank's, with no
    wrap: rank 0 gets zeros for ``prev_last`` and the last rank zeros for
    ``next_first`` (a Dirichlet boundary), as does the only rank of a world
    of one.  JAX's two non-wrapping ``ppermute``\\ s, fwd
    ``(i, i+1)`` and bwd ``(i+1, i)`` for ``i < P - 1``
    (``dist_multigrid.py:196-203``); the operations are posted in one fixed
    order on every rank."""
    collectives["halo"] += 1
    last = x_local[-1:].contiguous()
    first = x_local[:1].contiguous()
    prev_last, next_first = torch.zeros_like(last), torch.zeros_like(first)
    ops = []
    if mesh.rank + 1 < mesh.size:
        hi = mesh.global_rank(mesh.rank + 1)
        ops += [dist.P2POp(dist.isend, last, hi, mesh.group, _FWD),
                dist.P2POp(dist.irecv, next_first, hi, mesh.group, _BWD)]
    if mesh.rank > 0:
        lo = mesh.global_rank(mesh.rank - 1)
        ops += [dist.P2POp(dist.isend, first, lo, mesh.group, _BWD),
                dist.P2POp(dist.irecv, prev_last, lo, mesh.group, _FWD)]
    if ops:
        collectives["halo_wire"] += 1
        for w in dist.batch_isend_irecv(ops):
            w.wait()
    return prev_last, next_first
