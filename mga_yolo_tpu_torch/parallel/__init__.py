"""Data parallelism over ``torch.distributed`` (counterpart of the JAX
package's data mesh: ``mga_yolo_tpu/train/state.py`` ``data_mesh``,
``host_local_to_global`` and ``host_barrier``).

The caller starts the processes and initialises the default process group
(``torchrun`` and ``init_process_group``, or processes it spawns), as the JAX
package's caller runs ``jax.distributed.initialize``; this module reads the
world size and the rank from that group. N ranks compute one global batch:
each takes an even, strided shard of it (``data/loader.py``), BatchNorm
normalises with the global batch's statistics (``models/layers.py``), each
rank's loss is its share of the global loss (:func:`loss_share`), and the
accumulated gradient is summed over the ranks once an apply
(``train/state.py``). With no group, or a group of one, none of this runs.

Every collective of the port goes through here (the metric gather of
``utils/metrics.py`` excepted) and is counted in :data:`collectives`. Each
has a timeout: the group's (``init_process_group(timeout=...)``; gloo raises
when it passes, NCCL's watchdog aborts the collective), and the barrier's
own. With gloo the tensors may live on the card: gloo copies them through
host memory itself.

A DP x SP mesh (:func:`data_mesh` with ``spatial`` k > 1, the JAX
package's ``data_mesh(spatial=k)``) splits the world into ``data`` groups of
k ranks: the data shards of the batch, and within each the ``space`` ranks,
which hold the same images and each a band of their rows
(``parallel/spatial.py``). The mesh takes effect inside :func:`using`. The
barrier, the broadcasts and the gradient all-reduce stay over the whole
world.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist

# the timeout of the process groups the port's entry points initialise, and of :func:`barrier`
TIMEOUT = datetime.timedelta(seconds=600)

collectives = 0  # collectives launched by this module (all-reduces and broadcasts)


def active() -> bool:
    """A process group of more than one rank is initialised."""
    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1


def world() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def is_main() -> bool:
    return rank() == 0


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A DP x SP mesh of the world: rank ``r`` is data shard ``r // space``
    and space rank ``r % space`` (the JAX mesh ``devices.reshape(data,
    space)``). ``data_group`` holds the ranks of one space rank across the
    data shards, ``space_group`` the ``space`` ranks of one data shard; both
    are None on a mesh of one space rank (pure data parallelism)."""

    data: int
    space: int
    data_rank: int
    space_rank: int
    data_group: object = None
    space_group: object = None
    world_group: object = None  # the default group the mesh was made in


_mesh: Optional[Mesh] = None  # the mesh in effect (:func:`using`)


def data_mesh(spatial: int = 1) -> Mesh:
    """The DP x SP mesh of the world with ``spatial`` space ranks a data
    shard. Every rank must call it (``spatial`` > 1 makes the process groups
    with ``dist.new_group``, which is collective). Raises ``ValueError`` when
    the world size does not divide by ``spatial``, as the JAX package's
    ``data_mesh`` does. It takes effect inside :func:`using`."""
    W, r = world(), rank()
    if spatial < 1 or W % spatial:
        raise ValueError(f"{W} ranks not divisible by spatial={spatial}")
    k, D = spatial, W // spatial
    if k == 1:
        return Mesh(data=D, space=1, data_rank=r, space_rank=0)
    data_group = space_group = None
    for s in range(k):  # every rank makes every group, in the same order
        g = dist.new_group([d * k + s for d in range(D)])
        data_group = g if r % k == s else data_group
    for d in range(D):
        g = dist.new_group([d * k + s for s in range(k)])
        space_group = g if r // k == d else space_group
    return Mesh(data=D, space=k, data_rank=r // k, space_rank=r % k, data_group=data_group,
                space_group=space_group, world_group=dist.group.WORLD)


@contextlib.contextmanager
def using(m: Optional[Mesh]):
    """The mesh ``m`` in effect inside the block (None: none), the one
    before it after."""
    global _mesh
    before, _mesh = _mesh, m
    try:
        yield m
    finally:
        _mesh = before


def mesh() -> Optional[Mesh]:
    """The mesh in effect when it splits rows (``space`` > 1) and belongs
    to the live default group; None otherwise."""
    m = _mesh
    if m is None or m.space == 1 or not (dist.is_available() and dist.is_initialized()):
        return None
    return m if dist.group.WORLD is m.world_group else None


def data_world() -> int:
    """The number of data shards of the batch: the world size without a mesh."""
    m = mesh()
    return world() if m is None else m.data


def data_rank() -> int:
    """This rank's data shard: its rank without a mesh."""
    m = mesh()
    return rank() if m is None else m.data_rank


def _flat_(tensors: Sequence[torch.Tensor], collective) -> None:
    """``collective(buf)`` on one flat buffer per (device, dtype) group of
    the tensors, then each tensor overwritten with its part of the buffer."""
    global collectives
    groups: dict = {}
    for t in tensors:
        groups.setdefault((t.device, t.dtype), []).append(t)
    for ts in groups.values():
        buf = torch.cat([t.reshape(-1) for t in ts])
        collective(buf)
        collectives += 1
        torch._foreach_copy_(list(ts), [b.view_as(t) for b, t in zip(buf.split([t.numel() for t in ts]), ts)])


@torch.no_grad()
def all_reduce_sum_(tensors: Sequence[torch.Tensor], group=None) -> None:
    """Sum each tensor over the ranks (of ``group``, else the world), in
    place. The tensors are flattened into one buffer per (device, dtype), so
    one collective covers them. Every rank ends with the same bits. A no-op
    without a group of two or more."""
    if active() and (group is None or dist.get_world_size(group) > 1):
        _flat_(tensors, lambda buf: dist.all_reduce(buf, group=group))


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of a (detached) tensor over the ranks (of ``group``, else
    the world), as a new tensor."""
    out = t.detach().clone()
    all_reduce_sum_([out], group)
    return out


@torch.no_grad()
def broadcast_state(tensors: Sequence[torch.Tensor], src: int = 0) -> None:
    """Overwrite each tensor with rank ``src``'s, in place (one collective
    per device and dtype). A no-op without a group of two or more."""
    if active():
        _flat_(tensors, lambda buf: dist.broadcast(buf, src))


def broadcast_object(obj, src: int = 0):
    """Rank ``src``'s ``obj`` on every rank (a picklable value such as a
    path); ``obj`` as it is without a group of two or more."""
    if not active():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src)
    return box[0]


def barrier(name: str, timeout: datetime.timedelta = TIMEOUT) -> None:
    """Wait until every rank reaches the barrier ``name`` (the counterpart of
    ``host_barrier``). gloo's ``monitored_barrier`` names the ranks that did
    not arrive within ``timeout``; on NCCL the group's timeout holds."""
    if not active():
        return
    try:
        if dist.get_backend() == "gloo":
            dist.monitored_barrier(timeout=timeout)
        else:
            dist.barrier()
    except RuntimeError as e:
        raise RuntimeError(f"barrier {name!r} (rank {rank()} of {world()}): {e}") from e


def local_device(device: Optional[str]) -> Optional[str]:
    """The device of this rank for a run asked to run on ``device``: with a
    group of two or more, ``cuda`` (or no device) means the card
    ``LOCAL_RANK`` (torchrun's; else the rank); an explicit ``cuda:N`` or
    ``cpu`` is kept."""
    if not active() or (device not in (None, "", "cuda")):
        return device
    return f"cuda:{int(os.environ.get('LOCAL_RANK', rank()))}"


def init_from_env(device: Optional[str]) -> bool:
    """Initialise the default group from torchrun's environment (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``) when ``WORLD_SIZE`` > 1
    and no group exists: NCCL when the run is on the card, gloo when on the
    CPU. Returns whether it initialised one (the caller destroys it)."""
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1 or (dist.is_available() and dist.is_initialized()):
        return False
    cpu = str(device or "cuda").startswith("cpu")
    if not cpu:
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", os.environ.get("RANK", "0"))))
    dist.init_process_group("gloo" if cpu else "nccl", init_method="env://", timeout=TIMEOUT)
    return True


def loss_share():
    """This rank's :class:`~mga_yolo_tpu_torch.losses.GlobalBatch`, or None
    without a group of two or more (the loss then runs its one-process
    arithmetic). Under a mesh the target-score sum is summed over the data
    shards, and the space ranks' sums and factor are the mesh's."""
    if not active():
        return None
    from mga_yolo_tpu_torch.losses import GlobalBatch

    m = mesh()
    if m is None:
        return GlobalBatch(world=world(), sum_ranks=all_reduce_sum)
    from mga_yolo_tpu_torch.parallel import spatial

    return GlobalBatch(world=world(), sum_ranks=lambda t: all_reduce_sum(t, m.data_group), space=m.space,
                       sum_space=spatial.sum_space)
