"""The port's own profiler ranges (utils/profiling.annotate): the spans a
Registrar call and a stream record under torch.profiler, their nesting,
that nothing is recorded or entered without a profiler, and that recording
leaves the outputs unchanged."""

import collections

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from deepvcp_tpu_torch import pretrained
from deepvcp_tpu_torch.config import DeepVCPConfig
from deepvcp_tpu_torch.data.synthetic import LidarLikeDataset, batch_iterator
from deepvcp_tpu_torch.models import DeepVCP
from deepvcp_tpu_torch.registration import CascadeRegistrar, Registrar
from deepvcp_tpu_torch.utils import profiling
from deepvcp_tpu_torch.utils.profiling import annotate

torch.set_num_threads(2)

N = 128
REFINE = 2


def _spans(prof):
    """The deepvcp.* ranges of a profile, as (start_ns, end_ns, name)."""
    return sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                  for e in prof.profiler.kineto_results.events()
                  if e.is_user_annotation() and e.name().startswith("deepvcp."))


def _count(spans):
    return collections.Counter(name for _, _, name in spans)


def _inside(span, outer):
    return outer[0] <= span[0] and span[1] <= outer[1]


@pytest.fixture(scope="module")
def cfg():
    return DeepVCPConfig.tiny(N, use_normal=False)


@pytest.fixture(scope="module")
def state(cfg):
    torch.manual_seed(0)
    return DeepVCP(cfg).state_dict()


@pytest.fixture(scope="module")
def pairs():
    data = LidarLikeDataset(num_clouds=3, num_points=N, max_range=2.0, max_rotation_deg=5.0,
                            max_translation=0.3, seed=1)
    return [(torch.from_numpy(src), torch.from_numpy(tgt))
            for src, tgt, _, _ in batch_iterator(data, 1, shuffle=False)]


def _registrar(cfg, state, guard=True):
    return Registrar(cfg, state, "cpu", refine_iters=REFINE, guard=guard)


def _profile(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, _spans(prof)


@pytest.mark.parametrize("guard", [True, False])
def test_call_records_each_span_inside_its_register(cfg, state, pairs, guard):
    reg = _registrar(cfg, state, guard)
    reg(*pairs[0])   # the first call runs the slab audit
    _, spans = _profile(lambda: reg(*pairs[1]))
    assert _count(spans) == {
        "deepvcp.register": 1, "deepvcp.extent": 1, "deepvcp.encode": 1,
        "deepvcp.features": 2, "deepvcp.correspond": REFINE,
        "deepvcp.candidate_neighbors": REFINE, "deepvcp.match": REFINE,
        "deepvcp.solve": REFINE, "deepvcp.score": REFINE + 1,
        # the bf16 tile of encode's source k-NN and of each refinement's candidates
        "deepvcp.select_tile": REFINE + 1}
    register = next(s for s in spans if s[2] == "deepvcp.register")
    assert all(_inside(s, register) for s in spans)
    for inner, outer in (("features", "encode"), ("candidate_neighbors", "correspond"),
                         ("match", "correspond")):
        outers = [s for s in spans if s[2] == f"deepvcp.{outer}"]
        assert all(any(_inside(s, o) for o in outers)
                   for s in spans if s[2] == f"deepvcp.{inner}")
    outers = [s for s in spans if s[2] in ("deepvcp.encode", "deepvcp.candidate_neighbors")]
    assert all(any(_inside(s, o) for o in outers)
               for s in spans if s[2] == "deepvcp.select_tile")


def test_stream_drains_outside_every_register(cfg, state, pairs):
    reg = _registrar(cfg, state)
    outs, spans = _profile(lambda: list(reg.stream(pairs, depth=2)))
    assert len(outs) == 3
    counts = _count(spans)
    assert counts["deepvcp.register"] == 3 and counts["deepvcp.drain"] == 3
    registers = [s for s in spans if s[2] == "deepvcp.register"]
    for drain in (s for s in spans if s[2] == "deepvcp.drain"):
        assert not any(drain[0] < r[1] and r[0] < drain[1] for r in registers)


def test_cascade_and_routed_spans_come_from_their_registrars(cfg, state, pairs):
    cascade = CascadeRegistrar([_registrar(cfg, state), _registrar(cfg, state)])
    _, spans = _profile(lambda: cascade(*pairs[0]))
    assert _count(spans)["deepvcp.register"] == 2 and _count(spans)["deepvcp.solve"] == 2 * REFINE
    routed = pretrained.routed_registrar(device="cpu", num_points=N, refine_iters=REFINE)
    _, spans = _profile(lambda: routed(*pairs[0]))
    assert _count(spans)["deepvcp.register"] == 1 and _count(spans)["deepvcp.solve"] == REFINE


def test_no_profiler_enters_no_range(cfg, state, pairs, monkeypatch):
    assert annotate("deepvcp.a") is annotate("deepvcp.b") is profiling._NO_RANGE

    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    reg = _registrar(cfg, state)
    reg(*pairs[0])
    assert len(list(reg.stream(pairs, depth=2))) == 3


def test_annotate_records_while_a_profiler_runs():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        span = annotate("deepvcp.test")
        with span:
            torch.ones(4).sum()
    assert span is not profiling._NO_RANGE
    assert [s[2] for s in _spans(prof)] == ["deepvcp.test"]


def test_outputs_bit_identical_with_and_without_profiler(cfg, state, pairs):
    reg = _registrar(cfg, state)
    reg(*pairs[0])
    plain = reg(*pairs[1])
    traced, _ = _profile(lambda: reg(*pairs[1]))
    for name, a, b in zip(plain._fields, plain, traced):
        assert torch.equal(a, b), name
