"""A rank's card (deepvcp_tpu_torch.parallel.multihost.rank_device and
initialize_multihost's binding), checked without a card: torch.cuda's
device count and set_device and dist.init_process_group are monkeypatched,
so each test records what the port would do on a host with that many cards.

NCCL takes one card a rank: initialize_multihost(device="cuda") makes the
rank's card current before the group exists and hands it to NCCL as
device_id; an NCCL group with more ranks on the host than cards is refused.
"""

import os

import pytest
import torch
import torch.distributed as dist

from deepvcp_tpu_torch import graft_entry
from deepvcp_tpu_torch.parallel import initialize_multihost, make_mesh, multihost
from deepvcp_tpu_torch.parallel.launch import free_port, run_ranks
from deepvcp_tpu_torch.parallel.mesh import rank_card

HERE = os.path.dirname(os.path.abspath(__file__))


@pytest.fixture
def cards(monkeypatch):
    """A host with a settable number of cards; records set_device and
    init_process_group calls in order as ("set_device", index) and
    ("init", kwargs). Yields {"count": n, "calls": [...]}."""
    host = {"count": 4, "calls": []}
    monkeypatch.setattr(torch.cuda, "device_count", lambda: host["count"])
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda d: host["calls"].append(("set_device", torch.device(d).index)))

    def init(backend, **kw):
        host["calls"].append(("init", {"backend": backend, **kw}))

    monkeypatch.setattr(dist, "init_process_group", init)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 2)
    monkeypatch.setattr(multihost, "_card", None)
    for k in ("LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    yield host


@pytest.mark.parametrize("local_rank,count,card", [
    (0, 1, 0), (1, 1, 0), (3, 4, 3), (5, 4, 1), (None, 2, 0), (7, 8, 7)])
def test_rank_device_is_local_rank_modulo_cards(cards, local_rank, count, card):
    cards["count"] = count
    assert multihost.rank_device("cuda", local_rank) == torch.device("cuda", card)


def test_rank_device_prefers_local_rank_variable(cards, monkeypatch):
    """torchrun's LOCAL_RANK wins over the argument; an indexed card and the
    CPU are returned as given."""
    monkeypatch.setenv("LOCAL_RANK", "2")
    assert multihost.rank_device("cuda", 1) == torch.device("cuda", 2)
    assert multihost.rank_device("cuda:1", 3) == torch.device("cuda", 1)
    assert multihost.rank_device("cpu", 3) == torch.device("cpu")
    cards["count"] = 0
    with pytest.raises(RuntimeError, match="no CUDA card"):
        multihost.rank_device("cuda", 0)


def test_nccl_rank_sets_its_card_before_the_group(cards):
    """set_device(rank's card) comes first, then init_process_group over
    NCCL with device_id = that card."""
    assert initialize_multihost("localhost:1234", 2, 1, device="cuda") is True
    assert [c[0] for c in cards["calls"]] == ["set_device", "init"]
    assert cards["calls"][0] == ("set_device", 1)
    kw = cards["calls"][1][1]
    assert kw["backend"] == "nccl" and kw["device_id"] == torch.device("cuda", 1)
    assert (kw["world_size"], kw["rank"]) == (2, 1)
    assert multihost.bound_card() == torch.device("cuda", 1)


def test_nccl_refuses_more_ranks_than_cards(cards):
    """Two NCCL ranks of one host on one card: RuntimeError naming the
    cause, before any card is set or any group started."""
    cards["count"] = 1
    with pytest.raises(RuntimeError, match="one card a rank.*2 ranks on this host.*1 card"):
        initialize_multihost("localhost:1234", 2, 1, device="cuda")
    assert cards["calls"] == []


def test_gloo_may_share_a_card(cards):
    """gloo ranks share a card: rank 1 of 2 on a host with one card binds
    cuda:0 and gets no device_id."""
    cards["count"] = 1
    initialize_multihost("localhost:1234", 2, 1, device="cuda", backend="gloo")
    assert cards["calls"][0] == ("set_device", 0)
    kw = cards["calls"][1][1]
    assert kw["backend"] == "gloo" and "device_id" not in kw


@pytest.mark.parametrize("coordinator,local_world,refused", [
    ("localhost:1234", None, True),
    ("127.0.0.1:1234", None, True),
    ("node7:1234", None, False),     # ranks on other hosts: not counted here
    ("node7:1234", "8", True),       # torchrun's count of this host's ranks
    ("localhost:1234", "4", False),
])
def test_ranks_on_this_host(cards, monkeypatch, coordinator, local_world, refused):
    """8 NCCL ranks, 4 cards: refused only when all 8 are on this host."""
    if local_world is not None:
        monkeypatch.setenv("LOCAL_WORLD_SIZE", local_world)
    if refused:
        with pytest.raises(RuntimeError, match="one card a rank"):
            initialize_multihost(coordinator, 8, 5, device="cuda")
    else:
        initialize_multihost(coordinator, 8, 5, device="cuda")
        assert cards["calls"][0] == ("set_device", 1)


def test_launcher_environment_binds_local_rank(cards, monkeypatch):
    """No arguments: the launcher's RANK, WORLD_SIZE and LOCAL_RANK."""
    for k, v in {"MASTER_ADDR": "localhost", "MASTER_PORT": "1234", "WORLD_SIZE": "2",
                 "RANK": "1", "LOCAL_RANK": "1"}.items():
        monkeypatch.setenv(k, v)
    initialize_multihost(device="cuda")
    assert cards["calls"][0] == ("set_device", 1)
    assert cards["calls"][1][1]["init_method"] == "env://"
    assert cards["calls"][1][1]["device_id"] == torch.device("cuda", 1)


def test_mesh_refuses_another_current_card(monkeypatch):
    """A mesh whose rank is bound to cuda:1 while the current card is cuda:0
    raises; rank_card (shard_batch's device) is the bound card."""
    initialize_multihost(f"localhost:{free_port()}", 1, 0, device="cpu")
    try:
        monkeypatch.setattr(multihost, "_card", torch.device("cuda", 1))
        monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
        assert rank_card("cuda") == torch.device("cuda", 1)
        assert rank_card("cpu") == torch.device("cpu")
        with pytest.raises(RuntimeError, match="bound to cuda:1.*current card is cuda:0"):
            make_mesh(1, 1, device="cuda")
    finally:
        dist.destroy_process_group()


def test_dryrun_refuses_more_ranks_than_cards(monkeypatch):
    """dryrun_multichip on "cuda" with 8 ranks and 4 cards raises before any
    rank starts."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)

    def no_ranks(*a, **k):
        raise AssertionError("a rank was started")

    monkeypatch.setattr("deepvcp_tpu_torch.parallel.launch.run_ranks", no_ranks)
    with pytest.raises(RuntimeError, match="8 ranks need 8 cards.*4 visible"):
        graft_entry.dryrun_multichip(8, device="cuda")


def test_run_ranks_sets_local_rank():
    """Each rank of run_ranks sees LOCAL_RANK = its rank (one host)."""
    got = run_ranks("torch_ranks:launch_env", 2, device="cpu", sys_path=[HERE], timeout_s=60)
    assert got == [("0", 0), ("1", 1)]
