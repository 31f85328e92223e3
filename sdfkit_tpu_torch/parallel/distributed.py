"""Process groups and the 1-D mesh the sharded paths run over.

Counterpart of ``sdfkit_tpu/parallel/distributed.py``. The JAX package has
one controller over a ``jax.sharding.Mesh`` of devices and lets XLA insert the
collectives; here every rank is a process of its own (PyTorch's SPMD idiom:
``torchrun``, or a launcher such as ``tools/torch_distributed_demo.py``), each
with its device, and the sharded paths call the collectives themselves
through the :class:`Mesh` they are given: an all-gather of image bands, voxel
bricks' halos and marching-cubes cells, an all-reduce of gradients.

Two process-group backends serve:

* ``nccl`` where every rank of a host has a card of its own (rank ``r`` takes
  card ``r`` of its host): the collectives run on the cards.
* ``gloo`` where ranks share a card (NCCL refuses two ranks on one device), or
  on the CPU. Gloo takes CUDA tensors in its all-gather, all-reduce and
  broadcast and moves them through host memory itself.

A mesh of one rank needs no process group: it runs no collective.
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

from sdfkit_tpu_torch.device import resolve

_LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR")


def _cluster_env_present() -> bool:
    """Whether a launcher (``torchrun`` and the like) set this process's rank."""
    return any(v in os.environ for v in _LAUNCHER_ENV)


def _local_ranks(world_size: int) -> int:
    return int(os.environ.get("LOCAL_WORLD_SIZE", world_size))


def _local_rank(rank: int) -> int:
    return int(os.environ.get("LOCAL_RANK", rank))


def default_backend(world_size: int) -> str:
    """``nccl`` when every rank of this host can have a card of its own,
    ``gloo`` otherwise."""
    if torch.cuda.is_available() and torch.cuda.device_count() >= _local_ranks(world_size):
        return "nccl"
    return "gloo"


def require_cards(local_ranks: int) -> None:
    """Raise unless this host has a card for each of its ``local_ranks``
    ranks, as NCCL needs (it refuses two ranks on one card)."""
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < local_ranks:
        raise RuntimeError(
            f"the nccl backend puts each of this host's {local_ranks} ranks on a card of its own "
            f"and the host has {cards}; ranks that share a card take backend='gloo'"
        )


def card_id(device) -> str:
    """``device`` named so that two processes agree: a card's PCI address
    (domain:bus:device), otherwise the device itself (``cpu``)."""
    device = torch.device(device)
    if device.type != "cuda":
        return str(device)
    props = torch.cuda.get_device_properties(device)
    return f"{props.pci_domain_id:04x}:{props.pci_bus_id:02x}:{props.pci_device_id:02x}"


def initialize(init_method: str | None = None, backend: str | None = None, **kwargs) -> None:
    """Join the process group. A no-op when there is neither an address nor
    a launcher's environment (``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR``), so
    the same program runs unchanged as one process; also a no-op when the
    group already exists. ``kwargs`` go to ``init_process_group``
    (``world_size``, ``rank``, ``timeout``); ``backend=None`` takes
    :func:`default_backend`.

    Under NCCL the rank joins bound to card ``LOCAL_RANK`` (its rank where
    no launcher set that), which becomes its current device, so that every
    collective, barrier and new group knows the card. Asking for NCCL with
    fewer cards than the host's ranks raises (:func:`require_cards`)."""
    if dist.is_initialized() or (init_method is None and not _cluster_env_present()):
        return
    world = kwargs.get("world_size", int(os.environ.get("WORLD_SIZE", 1)))
    if backend is None:
        backend = default_backend(world)
    if backend == "nccl":
        require_cards(_local_ranks(world))
        rank = kwargs.get("rank", int(os.environ.get("RANK", 0)))
        card = torch.device("cuda", _local_rank(rank))
        torch.cuda.set_device(card)
        kwargs.setdefault("device_id", card)
    dist.init_process_group(backend=backend, init_method=init_method, **kwargs)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh of ranks: this process's ``rank`` of ``size``, its
    ``device``, the process ``group`` (None for the mesh of this process
    alone, which runs no collective; a group of one still runs them) and its
    ``backend``. The sharded functions split rows and z layers over the ranks
    in rank order."""

    rank: int
    size: int
    device: torch.device
    group: object = None
    backend: str | None = None
    axis_name: str = "rays"

    @property
    def axis_names(self) -> tuple[str]:
        return (self.axis_name,)

    def all_gather(self, t: torch.Tensor) -> list[torch.Tensor]:
        """Every rank's ``t`` (one shape on every rank), in rank order."""
        if self.group is None:
            return [t]
        t = t.contiguous()
        out = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(out, t, group=self.group)
        return out

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's ``t``, in place; returns ``t``."""
        if self.group is not None:
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
        return t

    def barrier(self) -> None:
        if self.group is not None:
            dist.barrier(group=self.group)


def single(device=None, axis_name: str = "rays") -> Mesh:
    """A mesh of this process alone on ``device`` (the package's default
    device when None): the one-rank reference the sharded paths equal."""
    return Mesh(rank=0, size=1, device=resolve(device), axis_name=axis_name)


def make_mesh(axis_name: str = "rays", device=None) -> Mesh:
    """The 1-D mesh of every rank of the process group (after
    :func:`initialize`), or of this process alone when there is no group.

    ``device``: this rank's device. By default, under NCCL the card of the
    rank's local index (which this call makes current), otherwise the
    package's default device: the card (every rank of a ``gloo`` group on one
    card shares it), or the CPU where it was asked for. A rank that finds no
    card and was not asked for the CPU raises."""
    if not dist.is_initialized():
        return single(device, axis_name)
    rank, size = dist.get_rank(), dist.get_world_size()
    backend = str(dist.get_backend())
    if device is None and backend == "nccl":
        device = torch.device("cuda", _local_rank(rank))
    device = resolve(device)
    if device.type == "cuda" and device.index is not None:
        torch.cuda.set_device(device)
    return Mesh(rank=rank, size=size, device=device, group=dist.group.WORLD, backend=backend,
                axis_name=axis_name)
