"""The port's spans and counters (``utils/profiling.py``) and the prune's
``phase_times`` they fill: nesting, tags and self time; counts; no
profiler range without a profiler; the span names in a ``trace``'s Chrome
trace; and tiny BLIP-2 prunes, Wanda with the MeZO coarse stage and
SparseGPT, whose parts fit inside their wholes, whose lane forwards are
counted, and which synchronise once."""

import json
import sys
import time

import pytest
import torch

from ecoflap_tpu_torch.core import device as core_device
from ecoflap_tpu_torch.models import blip2 as tblip2
from ecoflap_tpu_torch.pruning.loader import load_pruner
from ecoflap_tpu_torch.pruning.pruners import phase_times
from ecoflap_tpu_torch.utils import profiling
from ecoflap_tpu_torch.utils.profiling import count, recording, span, trace
from tests.torch_parity import np_batch, one_torch_thread, to_torch  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

CPU = torch.device("cpu")
STACK_SPECS = {"visual_encoder.blocks": "3-0.5-1.0-1.0",
               "t5_model.encoder.block": "2-0.5-1.0-1.0",
               "t5_model.decoder.block": "2-0.5-1.0-1.0"}
COARSE = dict(stack_specs=STACK_SPECS, sparsity_ratio_granularity="block",
              max_sparsity_per_layer=0.6, score_method="MEZO-GradOnly_sum",
              num_data_first_stage=8, noise_eps=0.2, num_noise=2, verbose=False)
NUM_MICROBATCHES = 2  # of the 8 samples: 2 coarse microbatches of 4


def tiny_wanda_prune():
    model = tblip2.build_model(tblip2.tiny_config(), device="cpu", dtype=torch.float32,
                               seed=3)
    batch = to_torch(np_batch(tblip2.tiny_config(), n=8, seed=3))
    pruner = load_pruner("blipt5_wanda_pruner", tblip2.make_adapter(model), batch,
                         NUM_MICROBATCHES, COARSE)
    _, sdict = pruner.prune()
    return pruner, sdict, model, batch


def _nesting():
    with recording(CPU) as rec:
        with span("a"):
            time.sleep(0.01)
            with span("b", stack="x"):
                time.sleep(0.01)
                with span("c"):
                    time.sleep(0.005)
            with span("b", stack="x"):
                pass
    a, b, c = ("a", ()), ("b", (("stack", "x"),)), ("c", (("stack", "x"),))
    assert list(rec.seconds) == [a, b, c]  # c inherits its parent's stack
    assert rec.seconds[a] >= rec.seconds[b] >= rec.seconds[c] >= 0.005
    assert rec.self_seconds[a] == pytest.approx(rec.seconds[a] - rec.seconds[b])
    assert rec.self_seconds[b] == pytest.approx(rec.seconds[b] - rec.seconds[c])
    assert rec.self_seconds[c] == rec.seconds[c]
    assert rec.self_seconds[a] >= 0.01 and rec.counts == {}


def _counts():
    count("before")  # no recording open: nothing
    with span("outside"):  # the same
        pass
    with recording(CPU) as rec:
        count("n")
        count("n", 3)
        with span("s", stack="y"):
            count("n")
            count("m", 2, kind="k")
    count("after")
    assert rec.counts == {("n", ()): 4, ("n", (("stack", "y"),)): 1,
                          ("m", (("kind", "k"), ("stack", "y"))): 2}
    assert list(rec.seconds) == [("s", (("stack", "y"),))]
    with recording(CPU) as again:
        pass
    assert again.counts == {} and again.seconds == {}


def _no_profiler(monkeypatch):
    entered = []
    monkeypatch.setattr(profiling._autograd_profiler, "record_function",
                        lambda name: entered.append(name))
    with span("bare"):
        pass
    with recording(CPU):
        with span("recorded"):
            pass
    assert entered == []


def _trace(tmp_path):
    with trace(str(tmp_path), name="probe"):
        tiny_wanda_prune()
    events = json.loads((tmp_path / "probe.json").read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"probe", "ecoflap.coarse", "ecoflap.coarse.lanes", "ecoflap.fine",
            "ecoflap.fine.collect", "ecoflap.fine.prune", "ecoflap.fine.reforward"} <= names
    assert {"aten::mm", "aten::add"} & names  # beside the ops
    with trace(None) as none:
        assert none is None


@pytest.mark.parametrize("case", ["nesting", "counts", "no_profiler", "trace"])
def test_recorder(case, monkeypatch, tmp_path):
    if case == "nesting":
        _nesting()
    elif case == "counts":
        _counts()
    elif case == "no_profiler":
        _no_profiler(monkeypatch)
    else:
        _trace(tmp_path)
    assert profiling._open == []


def test_phase_times_keys_the_sweep_kernel_count_by_stack():
    """The sweep kernel's count, made under a stack's fine-stage span, lands
    in ``fine_<stack>_sweep_kernels_n``; a name with no key is left out."""
    with recording(CPU) as rec:
        with span("ecoflap.fine", stack="v"):
            with span("ecoflap.fine.sweep"):
                for _ in range(3):
                    count("ecoflap.fine.sweep_kernel")
            count("ecoflap.fine.unnamed")
        with span("ecoflap.fine", stack="t"):
            count("ecoflap.fine.sweep_kernel")
    pt = phase_times(rec)
    assert pt["fine_v_sweep_kernels_n"] == 3 and pt["fine_t_sweep_kernels_n"] == 1
    assert {"fine_v_s", "fine_v_sweep_s", "fine_t_s"} <= set(pt)
    assert not any("unnamed" in k or "graph" in k for k in pt), pt


@pytest.fixture
def sync_calls(monkeypatch):
    """Every synchronise the port can call, counted: the device module's and
    each package module's import of it, and ``torch.cuda.synchronize``."""
    calls = []
    real = core_device.synchronize

    def counted(device):
        calls.append(device)
        real(device)

    for name, mod in list(sys.modules.items()):
        if name.startswith("ecoflap_tpu_torch") and getattr(mod, "synchronize", None) is real:
            monkeypatch.setattr(mod, "synchronize", counted)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: calls.append("cuda"))
    return calls


def _assert_parts_fit(pt, whole, parts):
    """The parts' seconds add up to at most the whole's (5% slack for the
    host clock)."""
    assert sum(pt[p] for p in parts) <= 1.05 * pt[whole], (whole, parts, pt)


@pytest.mark.parametrize("method", ["wanda", "sparsegpt"])
def test_prune_spans(method, sync_calls):
    pruner, sdict, model, batch = tiny_wanda_prune()
    stacks = {s.name: s for s in pruner.adapter.stacks}
    if method == "sparsegpt":
        del sync_calls[:]
        pruner = load_pruner("blipt5_sparsegpt_pruner", tblip2.make_adapter(model), batch,
                             NUM_MICROBATCHES, dict(stack_specs=STACK_SPECS,
                                                    sparsity_dict=sdict, verbose=False))
        pruner.prune()
    assert len(sync_calls) <= len(STACK_SPECS) + 1, sync_calls
    pt = pruner.phase_times
    fine = ["collect_s", "prune_s", "reforward_s"]
    for s in STACK_SPECS:
        _assert_parts_fit(pt, f"fine_{s}_s", [f"fine_{s}_{p}" for p in fine])
        if method == "sparsegpt":
            _assert_parts_fit(pt, f"fine_{s}_prune_s",
                              [f"fine_{s}_prepare_hinv_s", f"fine_{s}_sweep_s"])
            assert f"fine_{s}_sweep_kernels_n" not in pt  # no kernel on the CPU
        else:
            # one lane group a block, 2 signs, each coarse microbatch and draw
            assert pt[f"coarse_{s}_lanes_n"] == (2 * stacks[s].num_blocks * NUM_MICROBATCHES
                                                 * COARSE["num_noise"])
    if method == "wanda":
        _assert_parts_fit(pt, "coarse_s", [f"coarse_{s}_lanes_s" for s in STACK_SPECS])
