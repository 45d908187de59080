"""The route from a configuration file to its system and its reference:
one-stage files build the port's Registrar and load
benchmark/reference/deepvcp.py, a stages file builds a CascadeRegistrar and
loads the reference it names; the registry's kitti-cascade, written as a
stages file and cut to 128 points, runs through the harness on the CPU with
`correct` true, and its plain reference agrees with the port's cascade."""

import json
from pathlib import Path

import pytest
import torch

from benchmark import check, generate, manifest, run, system, trace, work
from benchmark.reference import cascade, deepvcp
from benchmark.tests.helpers import N_POINTS, cut, registry_cascade

CONFIGS = ("kitti25-rot", "kitti25-two-level", "lidar-fine")


def source(cls) -> Path:
    """The file a class was defined in (also for a module loaded by path)."""
    return Path(cls.__init__.__code__.co_filename).resolve()


def pool_pair(traffic: dict, batch: int = 2, seed: int = 2 ** 33 + 9):
    pool = generate.make_pool(seed, dict(traffic, pool=batch), N_POINTS)
    return torch.from_numpy(pool.src), torch.from_numpy(pool.tgt)


@pytest.mark.parametrize("name", CONFIGS)
def test_accepted_configurations_resolve_as_before(name):
    from deepvcp_tpu_torch.registration import Registrar

    config = manifest.config(manifest.load(), name)
    assert manifest.stages(config) == [config]
    cls = manifest.reference(config)
    assert cls.__name__ == "Reference"
    assert source(cls) == Path(deepvcp.__file__).resolve()
    params = system.params(config)
    assert sorted(params) == sorted(deepvcp.load_npz(str(manifest.ROOT / config["weights"])))
    built = system.build(config, params, torch.device("cpu"))
    assert type(built) is Registrar and system.models(built) == [built.model]


def test_a_reference_that_is_no_file_fails_with_its_name():
    config = dict(manifest.config(manifest.load(), "kitti25-rot"),
                  reference="benchmark/reference/nowhere.py")
    with pytest.raises(FileNotFoundError, match="benchmark/reference/nowhere.py"):
        manifest.reference(config)
    assert any("nowhere.py" in p for p in manifest.config_problems(config))
    outside = dict(config, reference="deepvcp_tpu_torch/registration.py")
    assert any("lies outside" in p for p in manifest.config_problems(outside))


def test_stages_are_checked():
    good = registry_cascade(num_points=N_POINTS)
    assert manifest.config_problems(good) == []
    no_weights = json.loads(json.dumps(good))
    del no_weights["stages"][1]["weights"]
    assert any("stage 1 lacks ['weights']" in p for p in manifest.config_problems(no_weights))
    apart = json.loads(json.dumps(good))
    apart["stages"][2]["model"]["num_points"] = 2 * N_POINTS
    assert any("disagree" in p for p in manifest.config_problems(apart))
    both = dict(json.loads(json.dumps(good)), weights="deepvcp_tpu_torch/weights/kitti25.npz")
    assert any("both at the top" in p for p in manifest.config_problems(both))
    assert manifest.config_problems(dict(good, stages=[]))


def test_one_stage_stages_file_counts_as_the_plain_file():
    """A stages file of one stage builds the same Registrar and counts the
    same work as the plain file it was made from."""
    plain = manifest.config(manifest.load(), "kitti25-rot")
    staged = {k: v for k, v in plain.items() if k not in ("weights", "model", "registrar")}
    staged["stages"] = [{k: plain[k] for k in manifest.STAGE_KEYS}]
    assert manifest.config_problems(staged) == []
    src, tgt = pool_pair(manifest.traffic("pair-b1"))
    a, b = work.pool_work(plain, src, tgt), work.pool_work(staged, src, tgt)
    assert a.keys() == b.keys() and all(torch.equal(torch.as_tensor(a[k]), torch.as_tensor(b[k]))
                                        for k in a)


def test_cascade_work_sums_its_stages():
    config = registry_cascade(num_points=N_POINTS)
    src, tgt = pool_pair(manifest.traffic("pair-b1"))
    whole = work.pool_work(config, src, tgt)
    for key in whole:
        parts = sum(work.pool_work(stage, src, tgt)[key] for stage in config["stages"])
        assert torch.allclose(torch.as_tensor(whole[key]), torch.as_tensor(parts), rtol=1e-12)


def test_identity_init_is_the_default_bit_for_bit():
    config, traffic = cut(manifest.config(manifest.load(), "kitti25-rot"),
                          manifest.traffic("stream-b8"))
    ref = deepvcp.Reference(config, system.params(config), torch.device("cpu"))
    src, tgt = pool_pair(traffic)
    torch.set_num_threads(4)
    a = ref.register(src, tgt)
    b = ref.register(src, tgt, torch.eye(3).expand(2, 3, 3), torch.zeros(2, 3))
    for name in a:
        assert torch.equal(a[name], b[name]), name


def test_cascade_reference_equals_the_port():
    """reference/cascade.py against pretrained.cascade('kitti-cascade') on
    the registry weights, bit for bit, and the cascade the builder makes
    from the stages file against the same."""
    from deepvcp_tpu_torch import pretrained
    from deepvcp_tpu_torch.registration import CascadeRegistrar

    config = registry_cascade(num_points=N_POINTS)
    params = system.params(config)
    cpu = torch.device("cpu")
    reference = system.reference(config, params, cpu)
    assert source(type(reference)) == Path(cascade.__file__).resolve()
    assert [type(s).__name__ for s in reference.stages] == ["Reference"] * 3
    built = system.build(config, params, cpu)
    assert isinstance(built, CascadeRegistrar)
    assert [r.refine_iters for r in built.stages] == [2, 1, 2]
    assert len({id(m) for m in system.models(built)}) == 3
    src, tgt = pool_pair(manifest.traffic("pair-b1"))
    torch.set_num_threads(4)
    ref = cascade.Reference(config, params, cpu).register(src, tgt)
    assert ref["scores"].shape == (2, 3 + 2 + 3)
    for port in (pretrained.cascade("kitti-cascade", device=cpu, num_points=N_POINTS), built):
        out = port(src, tgt)
        for name in ("R", "t", "keypoints", "vcps", "saliency", "scores"):
            torch.testing.assert_close(getattr(out, name), ref[name], rtol=0, atol=0)


def test_spans_wrap_every_stage():
    config = registry_cascade(num_points=N_POINTS)
    models = system.models(system.build(config, system.params(config), torch.device("cpu")))
    with trace.spans(*models):
        assert all("encode" in vars(m) and "correspond" in vars(m) for m in models)
    assert not any(set(trace.SPANS) & set(vars(m)) for m in models)


@pytest.mark.parametrize("traffic_name, changes", [("pair-b1", {}),
                                                   ("stream-b8", {"batch": 2, "pool": 4})])
def test_kitti_cascade_runs_correct_through_the_harness(traffic_name, changes):
    """The cut kitti-cascade under a `call` and a `stream` traffic (the
    stream's batch cut to 2): `correct` true, every reading at most 1e-6."""
    config, traffic = cut(registry_cascade(), manifest.traffic(traffic_name))
    traffic.update(changes)
    config["limits"] = {name: 1e-6 for name in check.NUMBERS}
    bench = manifest.load()
    cell = next(w["name"] for w in bench["workloads"] if w["traffic"] == traffic_name)
    torch.set_num_threads(4)
    res = run.execute(config, traffic, 2 ** 33 + 23, 0.2, False, torch.device("cpu"),
                      manifest.reported(bench, cell))
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= traffic["batch"]
    assert all(c["value"] <= 1e-6 for c in res["checks"].values())
