"""A card for each rank under NCCL, on the CPU: the choices of
``parallel/distributed.py`` and of the launchers with the cards, the rank's
environment and ``init_process_group`` stood in for.

The card's run of these paths (four H100s, one NCCL group) is
``chip_smoke.py`` phase 23; here: NCCL only where the cards cover the
host's ranks, each rank bound to card ``LOCAL_RANK`` when it joins
(``device_id``) and meshed there, and a launcher that asks for NCCL with
fewer cards than ranks refuses before it spawns a process.
"""

import pathlib
import subprocess
import sys
import types

import pytest
import torch
import torch.distributed as dist

import sdfkit_tpu_torch as st
from sdfkit_tpu_torch.parallel import distributed

st.set_default_device("cpu")

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "tools"))
import torch_distributed_demo as demo  # noqa: E402
import torch_scaling  # noqa: E402


@pytest.fixture
def cards(monkeypatch):
    """``cards(n)``: this host has ``n`` cards (0: no CUDA at all);
    ``cards.made_current``: the cards ``torch.cuda.set_device`` was given."""
    made_current = []

    def set_cards(n):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: n > 0)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: n)

    monkeypatch.setattr(torch.cuda, "set_device", made_current.append)
    for name in ("LOCAL_RANK", "LOCAL_WORLD_SIZE", "RANK", "WORLD_SIZE", "MASTER_ADDR"):
        monkeypatch.delenv(name, raising=False)
    set_cards.made_current = made_current
    return set_cards


@pytest.fixture
def joined(monkeypatch):
    """The keyword arguments ``init_process_group`` was called with."""
    calls = []
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "init_process_group", lambda **kw: calls.append(kw))
    return calls


@pytest.mark.parametrize("n_cards, world, local_world, want", [
    (4, 4, None, "nccl"),
    (2, 4, None, "gloo"),
    (1, 1, None, "nccl"),
    (4, 8, 4, "nccl"),
    (4, 8, 8, "gloo"),
    (0, 1, None, "gloo"),
])
def test_default_backend_is_nccl_only_when_the_cards_cover_the_local_ranks(
        cards, monkeypatch, n_cards, world, local_world, want):
    cards(n_cards)
    if local_world is not None:
        monkeypatch.setenv("LOCAL_WORLD_SIZE", str(local_world))
    assert distributed.default_backend(world) == want


@pytest.mark.parametrize("rank, local_rank", [(0, None), (2, None), (3, "1")])
def test_initialize_binds_an_nccl_rank_to_its_card(cards, joined, monkeypatch, rank, local_rank):
    cards(4)
    if local_rank is not None:
        monkeypatch.setenv("LOCAL_RANK", local_rank)
    distributed.initialize("file:///unused", backend="nccl", world_size=4, rank=rank)
    card = torch.device("cuda", rank if local_rank is None else int(local_rank))
    assert joined == [dict(backend="nccl", init_method="file:///unused", world_size=4, rank=rank,
                           device_id=card)]
    assert cards.made_current == [card]


def test_initialize_picks_nccl_with_a_card_per_rank_and_binds_it(cards, joined):
    cards(2)
    distributed.initialize("file:///unused", world_size=2, rank=1)
    assert joined[0]["backend"] == "nccl" and joined[0]["device_id"] == torch.device("cuda", 1)


def test_initialize_under_gloo_binds_no_card(cards, joined):
    cards(1)
    distributed.initialize("file:///unused", world_size=4, rank=3)
    assert joined == [dict(backend="gloo", init_method="file:///unused", world_size=4, rank=3)]
    assert cards.made_current == []


@pytest.mark.parametrize("n_cards", [0, 1, 3])
def test_initialize_refuses_nccl_with_fewer_cards_than_ranks(cards, joined, n_cards):
    cards(n_cards)
    with pytest.raises(RuntimeError, match="nccl backend puts each of this host's 4 ranks"):
        distributed.initialize("file:///unused", backend="nccl", world_size=4, rank=0)
    assert joined == [] and cards.made_current == []


def test_initialize_without_an_address_or_a_launcher_joins_nothing(cards, joined):
    cards(4)
    distributed.initialize(backend="nccl")
    assert joined == []


@pytest.mark.parametrize("rank", range(4))
def test_make_mesh_puts_rank_r_on_card_r_under_nccl(cards, monkeypatch, rank):
    cards(4)
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda: rank)
    monkeypatch.setattr(dist, "get_world_size", lambda: 4)
    monkeypatch.setattr(dist, "get_backend", lambda: "nccl")
    mesh = distributed.make_mesh()
    card = torch.device("cuda", rank)
    assert (mesh.rank, mesh.size, mesh.device, mesh.backend) == (rank, 4, card, "nccl")
    assert cards.made_current == [card]


def test_make_mesh_under_gloo_keeps_the_default_device(cards, monkeypatch):
    cards(4)
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda: 2)
    monkeypatch.setattr(dist, "get_world_size", lambda: 4)
    monkeypatch.setattr(dist, "get_backend", lambda: "gloo")
    mesh = distributed.make_mesh()
    assert mesh.device == torch.device("cpu") and cards.made_current == []


@pytest.fixture
def no_spawn(monkeypatch):
    def popen(*a, **k):
        raise AssertionError("a rank was spawned")

    monkeypatch.setattr(subprocess, "Popen", popen)


@pytest.mark.parametrize("n_cards", [1, 2, 3])
def test_launch_refuses_nccl_with_fewer_cards_than_ranks_before_spawning(cards, no_spawn,
                                                                          n_cards):
    cards(n_cards)
    with pytest.raises(RuntimeError, match="has {}".format(n_cards)):
        demo.launch(4, device="cuda", size="cards", backend="nccl")


def test_the_scaling_tool_refuses_nccl_with_fewer_cards_before_spawning(cards, no_spawn):
    cards(2)
    with pytest.raises(RuntimeError, match="nccl backend puts each of this host's 4 ranks"):
        torch_scaling.main(["--process-group", "nccl", "--devices", "1", "2", "4"])


def test_launch_gives_each_rank_its_local_rank(cards, monkeypatch):
    """Rank r runs with LOCAL_RANK r of LOCAL_WORLD_SIZE ranks, whatever this
    process inherited from a launcher of its own."""
    cards(2)
    monkeypatch.setenv("LOCAL_RANK", "7")
    spawned = []

    class Done:
        returncode = 1

        def __init__(self, cmd, **kw):
            spawned.append((cmd, kw["env"]))

        def poll(self):
            return 1

    monkeypatch.setattr(subprocess, "Popen", Done)
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed"):
        demo.launch(2, device="cuda", size="cards", backend="nccl", timeout=5)
    assert [(env["LOCAL_RANK"], env["LOCAL_WORLD_SIZE"]) for _, env in spawned] == [
        ("0", "2"), ("1", "2")]
    assert [cmd[cmd.index("--rank") + 1] for cmd, _ in spawned] == ["0", "1"]
    assert all(cmd[cmd.index("--backend") + 1] == "nccl" for cmd, _ in spawned)


def test_the_cards_size_is_the_full_size_with_4k_rgb_and_512_cubed():
    cards_size = dict(demo.SIZES["cards"])
    assert cards_size.pop("rgb4k") is True and cards_size.pop("big_grid") == 512
    assert cards_size == demo.SIZES["full"]


def test_a_card_is_named_by_its_pci_address(monkeypatch):
    """Two processes name one card alike (the index is each process's own)."""
    props = {1: types.SimpleNamespace(pci_domain_id=0, pci_bus_id=0x9B, pci_device_id=0)}
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda d: props[d.index])
    assert distributed.card_id("cuda:1") == "0000:9b:00"
    assert distributed.card_id(torch.device("cpu")) == "cpu"
