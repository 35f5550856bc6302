"""The plain reference held against the program's plain paths on the CPU at
a tiny size, so a fault in the reference shows before any chip time; and
the frozen work counts."""

from __future__ import annotations

import numpy as np
import pytest
import torch
from common import BASE

from bench_port.core import data, work
from bench_port.drivers.serve_backlog import program_model
from bench_port.reference import model as ref
from bench_port.reference.precision import round_tf32, tf32

HEADS = {
    "mamba": dict(rnn_type="mamba", rnn_input_size=8, rnn_layer=2, hidden_size=None),
    "lstm": dict(rnn_type="lstm", rnn_input_size=16, rnn_layer=3, hidden_size=8),
    "gru": dict(rnn_type="gru", rnn_input_size=16, rnn_layer=2, hidden_size=8),
}


def _cfg(head: str, rnn_out: str = "all") -> dict:
    model = dict(BASE, num_classes=5, rnn_out=rnn_out, **HEADS[head])
    return {"model": model, "sequence_length": 4, "frame": [32, 32, 3]}


@pytest.mark.parametrize("rnn_out", ["all", "last"])
@pytest.mark.parametrize("head", sorted(HEADS))
def test_logits_match_the_program_in_f32(head, rnn_out):
    cfg = _cfg(head, rnn_out)
    w = data.make_weights(ref.param_spec(cfg), 3, torch.device("cpu"))
    model = program_model(cfg, w, torch.device("cpu"))
    x = torch.rand(3, 4, 32, 32, 3, generator=torch.Generator().manual_seed(1))
    with torch.no_grad(), tf32(False):
        got, want = model(x), ref.logits(w, x, cfg)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_tf32_rounding_keeps_ten_bits():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11, -3.0e-7,
                      1.0 + 2.0 ** -12])
    got = round_tf32(x)
    want = torch.tensor([1.0, 1.0 + 2.0 ** -10, 1.0, 1.0 + 2 * 2.0 ** -10, -3.0e-7, 1.0])
    assert torch.equal(got[[0, 1, 2, 3, 5]], want[[0, 1, 2, 3, 5]])
    assert abs(got[4] / x[4] - 1) <= 2.0 ** -11
    y = torch.randn(1000, generator=torch.Generator().manual_seed(0))
    assert ((round_tf32(y) / y - 1).abs().max()) <= 2.0 ** -11


def test_backlog_lengths_hold_the_published_statistic():
    """UCF101's Table 1: min 1.06 s, mean 7.21 s, max 71.04 s."""
    spec = {"min_s": 1.06, "mean_s": 7.21, "max_s": 71.04, "fps": 25}
    seconds = data.clip_seconds(spec, 4096)
    assert abs(seconds.mean() / 7.21 - 1) < 2e-3
    assert 1.06 <= seconds.min() and seconds.max() <= 71.04
    assert np.all(np.diff(seconds) > 0)
    frames = data.backlog_lengths(spec, 512)
    assert frames.min() == 27 and frames.max() == 1091


def test_batches_pad_to_the_ports_buckets():
    from vct_torch.serve.deployment import _length_bucket

    from bench_port.drivers.serve_backlog import bucket

    for T in (40, 60):
        for n in (T + 1, 2 * T, 2 * T + 1, 1091, 1900):
            assert bucket(n, T) == _length_bucket(n, T)
        assert bucket(T, T) == T and bucket(1, T) == T


def test_sad_selection_matches_the_program():
    """Static runs tie; ties go to the earlier transition; short videos cycle."""
    from vct_torch.data.preprocess import sample_indices

    content = {"run": [1, 6], "noisy_share": 0.5, "noise": 8}
    for seed in range(4):
        lengths = np.random.default_rng(seed).integers(2, 17, size=6)
        raw = data.make_videos(seed, 100, lengths, 16, (8, 8, 3), content, torch.device("cpu"))
        got = sample_indices(raw, 5, "sad", torch.as_tensor(lengths)).numpy()
        np.testing.assert_array_equal(got, ref.sad_indices(raw, lengths, 5))


def test_padding_repeats_the_last_frame():
    content = {"run": [1, 3], "noisy_share": 1.0, "noise": 8}
    raw = data.make_videos(9, 100, np.array([3, 7]), 7, (4, 4, 3), content, torch.device("cpu"))
    assert torch.equal(raw[0, 3:], raw[0, 2:3].expand(4, -1, -1, -1))


def test_spec_names_the_program_state_dict():
    from vct_torch.core.config import ModelConfig
    from vct_torch.models import MODEL_FAMILIES

    for head in HEADS:
        cfg = _cfg(head)
        with torch.device("meta"):
            model = MODEL_FAMILIES.get("lrcn")(ModelConfig(**cfg["model"]), 4)
        want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
        assert {n: tuple(s) for n, s, _, _ in ref.param_spec(cfg)} == want


def test_flops_per_frame_of_resnet50_at_80():
    """The issue's count of a CPU copy of the port's model: 1.122 GFLOP a frame."""
    cfg = {"model": dict(BASE, **HEADS["mamba"], num_classes=4), "frame": [80, 80, 3],
           "sequence_length": 60}
    assert abs(work.backbone_flops_per_frame(cfg) / 1.122e9 - 1) < 0.01
    head = work.head_flops_per_clip(cfg)
    assert 0 < head < 0.01 * 60 * work.backbone_flops_per_frame(cfg)
