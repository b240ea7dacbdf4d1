"""The port's planning layer (``repro_torch.dataflow``) against the JAX
package's (``tests/test_dataflow.py``): extracted application graphs equal
for all ten configurations (training and decode), the modelled TPU pod
architecture equal, and ``plan_mapping``'s Pareto set equal (periods,
buffers, costs, MRB choices, bindings), each plan's schedule measuring the
same period in the batched simulator (the kernel's plain version on CPU
tensors) as in the event simulator."""
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import list_archs as ref_list_archs
from repro.dataflow import extract_application_graph as ref_extract
from repro.dataflow import plan_mapping as ref_plan_mapping
from repro.dataflow import tpu_pod_architecture as ref_tpu_pod_architecture
from repro.dataflow.extract import ExtractOptions as RefOptions
from repro.dataflow.extract import stage_flops as ref_stage_flops
from repro_torch.configs import get_config, list_archs
from repro_torch.core.graph import multicast_actors
from repro_torch.dataflow import extract_application_graph, plan_mapping, tpu_pod_architecture
from repro_torch.dataflow.extract import ExtractOptions, stage_flops
from repro_torch.sim import SimConfig, batch_simulate_periods, simulate_period

SEQ, BATCH = 4096, 256  # tests/test_dataflow.py's shapes


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_the_same_ten_configurations():
    assert list_archs() == ref_list_archs() and len(list_archs()) == 10


@pytest.mark.parametrize("kind,n_stages", [("train", 8), ("decode", 16)])
@pytest.mark.parametrize("name", ref_list_archs())
def test_extracted_graph_equals_reference(name, kind, n_stages):
    cfg, theirs_cfg = get_config(name).model, ref_get_config(name).model
    mine = extract_application_graph(cfg, SEQ, BATCH, ExtractOptions(n_stages=n_stages, kind=kind))
    theirs = ref_extract(theirs_cfg, SEQ, BATCH, RefOptions(n_stages=n_stages, kind=kind))
    assert mine.to_dict() == theirs.to_dict()
    assert stage_flops(cfg, 1024, 2, SEQ) == ref_stage_flops(theirs_cfg, 1024, 2, SEQ)


@pytest.mark.parametrize("kw", [{}, {"heterogeneous": False}, {"groups": 8, "ici_gbps": 100.0}])
def test_tpu_pod_architecture_equals_reference(kw):
    mine, theirs = tpu_pod_architecture(**kw), ref_tpu_pod_architecture(**kw)
    assert mine.to_dict() == theirs.to_dict()
    assert len(mine.cores) == kw.get("groups", 16)


def _key(plan):
    return (plan.arch, plan.period_us, plan.buffer_bytes, plan.core_cost,
            plan.mrb_choices, plan.stage_binding, plan.channel_binding)


def test_plan_mapping_pareto_set_equals_reference():
    """MusicGen-medium, 6 stages, 3 generations, population 8, no time
    budget: the same plans in the same order; each plan's schedule gives
    the batched simulator's period equal to the event simulator's; the
    reference's share-vs-replicate trade-off."""
    kw = dict(opts=None, generations=3, population=8, seed=0, time_budget_s=None)
    mine = plan_mapping(get_config("musicgen-medium").model, SEQ, BATCH, device="cpu",
                        **{**kw, "opts": ExtractOptions(n_stages=6)})
    theirs = ref_plan_mapping(ref_get_config("musicgen-medium").model, SEQ, BATCH,
                              **{**kw, "opts": RefOptions(n_stages=6)})
    assert mine and [_key(p) for p in mine] == [_key(p) for p in theirs]
    assert [p.summary() for p in mine] == [p.summary() for p in theirs]
    arch = tpu_pod_architecture()
    cfg = SimConfig(trace=False)
    for plan in mine:
        assert plan.period_us > 0 and plan.core_cost > 0 and plan.stage_binding
        assert set(plan.mrb_choices) == set(multicast_actors(
            extract_application_graph(get_config("musicgen-medium").model, SEQ, BATCH,
                                      ExtractOptions(n_stages=6))))
        kernel = batch_simulate_periods(plan.graph, arch, [plan.schedule], cfg,
                                        backend="cuda", device="cpu")
        assert kernel == [simulate_period(plan.graph, arch, plan.schedule, cfg)]
    with_mrb = [p for p in mine if p.mrb_choices and all(p.mrb_choices.values())]
    without = [p for p in mine if not any(p.mrb_choices.values())]
    if with_mrb and without:
        assert min(p.buffer_bytes for p in with_mrb) < min(p.buffer_bytes for p in without)


def test_plan_mapping_runs_on_the_card_by_default():
    """Without ``device`` the exploration's engine runs on the card; on a
    machine without one, asking for it raises (nothing falls back)."""
    cfg = get_config("musicgen-medium").model
    kw = dict(opts=ExtractOptions(n_stages=2), generations=1, population=8, time_budget_s=None)
    if torch.cuda.is_available():
        assert plan_mapping(cfg, 512, 16, **kw)
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        plan_mapping(cfg, 512, 16, **kw)
