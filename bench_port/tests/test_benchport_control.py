"""The control comes out as ``correct`` false through a whole run: the
reference one step below the stated float32 (TF32, its operands rounded:
``reference/precision.py``) put in the program's place, at a tiny size on
the CPU. On the card the program's own TF32 path serves as the control,
at the cells' own sizes (``test_benchport_card.py``); PERF.md keeps the
readings of ``bench_port/tools/readings.py`` there."""

from __future__ import annotations

import pytest
import torch
from common import CELLS, CONTROL_SEEDS, run_tiny, tiny_copy

from bench_port.core import data
from bench_port.core.spec import load_cell
from bench_port.reference import model as ref
from bench_port.tools.readings import readings


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_copy(tmp_path_factory.mktemp("bench"))


def _reference_in_place(cfg, seed, kind, head_kind=None):
    """``classify_videos`` replaced by the reference in ``kind`` on the
    program's selected clips, with the run's weights."""
    w = data.make_weights(ref.param_spec(cfg), seed, torch.device("cpu"))

    def control(model, clips, batch_size=32, device=None, mesh=None):
        with torch.no_grad():
            return torch.softmax(ref.logits(w, clips.float(), cfg, kind, head_kind), -1).numpy()
    return control


@pytest.mark.parametrize("seed", CONTROL_SEEDS)
@pytest.mark.parametrize("name", sorted(CELLS))
def test_control_in_the_programs_place_is_not_correct(root, monkeypatch, name, seed):
    from vct_torch.serve import deployment

    cfg = load_cell(name, root / "bench_port").config
    monkeypatch.setattr(deployment, "classify_videos", _reference_in_place(cfg, seed, "tf32"))
    result, lines = run_tiny(root, name, seed=seed)
    assert result["correct"] is False, lines
    assert result["checks"]["logp_rel"]["value"] > result["checks"]["logp_rel"]["limit"]


@pytest.mark.parametrize("name", sorted(CELLS))
def test_the_stated_reference_in_the_programs_place_is_correct(root, monkeypatch, name):
    """The planting itself is sound: the reference at float32 passes."""
    from vct_torch.serve import deployment

    seed = CONTROL_SEEDS[0]
    cfg = load_cell(name, root / "bench_port").config
    monkeypatch.setattr(deployment, "classify_videos", _reference_in_place(cfg, seed, "float32"))
    result, lines = run_tiny(root, name, seed=seed)
    assert result["correct"] is True, lines


@pytest.mark.parametrize("name", sorted(CELLS))
def test_readings_of_the_control_and_a_bf16_head_exceed_the_limit(root, name):
    cell = load_cell(name, root / "bench_port")
    got = readings(cell, CONTROL_SEEDS[1], ["sound", "ref_tf32", "ref_bf16_head"],
                   torch.device("cpu"))
    limit = cell.limits["logp_rel"]
    assert got["sound"]["logp_rel"] < limit < got["ref_tf32"]["logp_rel"], got
    assert got["ref_bf16_head"]["logp_rel"] > limit, got
