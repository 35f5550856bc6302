"""CPU tests of ``chip_smoke.py``'s helpers that need no card: the summary
of nvcc's ``-Xptxas -v`` log it prints after the build, the bound it
reports beside each kernel, the state_dict layouts its zoo phase writes
out, the files phase's AVI writer and CLI hold, the worker phase's
URL-to-file mapping, local downloader and backend/queue/worker harness,
the caption files phase's
videos, annotations, corrupt files and comparisons, and the AOT phase's
launch rule, eager forward, refusal check and no-zoo list, and the sweep
phase's trial guard, and the finetune phase's holds."""

from __future__ import annotations

import json

import pytest
import torch

import chip_smoke

# Two entries as ptxas prints them under -v: a templated kernel in an
# anonymous namespace that spills, and a plain one that does not.
_LOG = """== lstm.cu (rc 0)
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_114rnn_reg_kernelILi4ELi1ELi14EEEvPKfS2_S2_S2_S2_Pfiii' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_114rnn_reg_kernelILi4ELi1ELi14EEEvPKfS2_S2_S2_S2_Pfiii
    208 bytes stack frame, 204 bytes spill stores, 224 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 208 bytes cumulative stack size
== normalize.cu (rc 0)
ptxas info    : Compiling entry function '_Z23normalize_frames_kernelPKhPfx' for 'sm_90a'
ptxas info    : Function properties for _Z23normalize_frames_kernelPKhPfx
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 18 registers, used 0 barriers, 400 bytes cmem[0]
"""


def test_ptxas_lines_name_each_kernel_with_its_registers_and_spills():
    lines = chip_smoke._ptxas_lines(_LOG)
    assert len(lines) == 2
    reg, norm = lines
    assert "rnn_reg_kernelILi4ELi1ELi14E" in reg
    assert "255 registers" in reg and "204 bytes spill stores" in reg
    assert ("normalize_frames_kernel" in norm and "18 registers" in norm
            and "0 bytes spill stores" in norm)


# The backward's register kernel as ptxas names it: <G, KU, S, NQ>.
_BWD_LOG = """== lstm_bwd.cu (rc 0)
ptxas info    : Compiling entry function '_ZN44_GLOBAL__N__c67ee736_11_lstm_bwd_cu_2819a04d18rnn_bwd_reg_kernelILi4ELi2ELi8ELi7EEEvPKfS2_S2_S2_S2_S2_S2_PfS3_S3_ii' for 'sm_90a'
ptxas info    : Function properties for _ZN44_GLOBAL__N__c67ee736_11_lstm_bwd_cu_2819a04d18rnn_bwd_reg_kernelILi4ELi2ELi8ELi7EEEvPKfS2_S2_S2_S2_S2_S2_PfS3_S3_ii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 167 registers, used 1 barriers, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN44_GLOBAL__N__c67ee736_11_lstm_bwd_cu_2819a04d18rnn_bwd_reg_kernelILi4ELi4ELi8ELi8EEEvPKfS2_S2_S2_S2_S2_S2_PfS3_S3_ii' for 'sm_90a'
ptxas info    : Function properties for _ZN44_GLOBAL__N__c67ee736_11_lstm_bwd_cu_2819a04d18rnn_bwd_reg_kernelILi4ELi4ELi8ELi8EEEvPKfS2_S2_S2_S2_S2_S2_PfS3_S3_ii
    24 bytes stack frame, 24 bytes spill stores, 24 bytes spill loads
ptxas info    : Used 254 registers, used 1 barriers, 24 bytes cumulative stack size
"""


def test_backward_spill_check_reads_every_register_instance():
    """The spill check finds each backward register instance by its
    template arguments and reports its spill-store bytes, and fails on a
    log that holds none."""
    assert chip_smoke._bwd_spills(_BWD_LOG) == {(4, 2, 8, 7): 0, (4, 4, 8, 8): 24}
    with pytest.raises(AssertionError, match="no ptxas line"):
        chip_smoke._bwd_spills(_BWD_LOG.replace("rnn_bwd_reg_kernel", "rnn_reg_kernel"))


def test_bound_is_the_larger_of_bytes_and_operations():
    t, by = chip_smoke._bound_ms(chip_smoke.HBM_BYTES_PER_S * 1e-3, 0.0)
    assert by == "bytes" and t == pytest.approx(1.0)
    t, by = chip_smoke._bound_ms(1.0, chip_smoke.ALU_OPS_PER_S * 2e-3)
    assert by == "operations" and t == pytest.approx(2.0)


def test_ssim_bound_is_its_instruction_count_over_the_issue_rate():
    """K4 at the bench step: each frame's window sums formed once (11
    instructions an element of every frame), 17 more a valid (pair,
    element), over 128 instructions a clock on 132 SMs at 1.98 GHz; bytes
    and reciprocals take less. The count is instructions, and the kernels
    line names its bound "operations", as for every kernel."""
    B, L, H, W, C = 32, 120, 80, 80, 3
    elems = (H - 2) * (W - 2) * C
    instr = (11 * B * L + 17 * B * (L - 1)) * elems
    assert chip_smoke.ISSUE_PER_S == pytest.approx(33.45e12, rel=1e-3)
    t, by = chip_smoke._ssim_bound_ms(B, L, H, W, C)
    assert by == "operations" and t == pytest.approx(instr / chip_smoke.ISSUE_PER_S * 1e3)
    assert (chip_smoke.SSIM_FRAME_INSTRUCTIONS, chip_smoke.SSIM_PAIR_INSTRUCTIONS) == (11, 17)
    assert t > (B * L * H * W * C) / chip_smoke.HBM_BYTES_PER_S * 1e3
    assert t > B * (L - 1) * elems / chip_smoke.SFU_RCP_PER_S * 1e3


def test_k1_bound_is_one_read_of_every_frame():
    """K1 at the bench step: 32 clips of 120 80x80x3 frames read once and
    119 f32 scores a clip written, against three operations a byte of each
    pair at the f32 rate; the bytes take longer."""
    t, by = chip_smoke._k1_bound_ms(32, 120, 80, 80, 3)
    n_bytes = 32 * 120 * 80 * 80 * 3 + 32 * 119 * 4
    assert by == "bytes" and t == pytest.approx(n_bytes / chip_smoke.HBM_BYTES_PER_S * 1e3)


@pytest.mark.parametrize("shape", chip_smoke.K1_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_k1_neighbours_hold_the_plans_choice_and_plans_the_kernel_takes(shape):
    from vct_torch.ops.pair_scores import plan

    chosen = plan(*shape)
    pairs = chip_smoke._k1_neighbours(*shape)
    assert pairs[0] == (chosen["design"], chosen["chunk_pairs"], chosen["bands"])
    assert len(pairs) == len(set(pairs)) >= 4 and {d for d, _, _ in pairs} == {"bands", "chunks"}
    for design, K, nb in pairs:
        p = plan(*shape, K, nb, design)
        assert (p["design"], p["chunk_pairs"], p["bands"]) == (design, K, nb)


@pytest.mark.parametrize("argv", [[], ["--k1-timing"], ["--mesh-rank", "/nonexistent"]])
def test_main_needs_a_card(argv):
    """Without CUDA the script exits non-zero before any phase."""
    assert chip_smoke.main(argv) == 1


@pytest.mark.parametrize("shift,ok", [(0.0, True), (5e-6, True), (5e-5, False)])
def test_mesh_phase_holds_losses_and_every_parameter(shift, ok):
    """Phase 20's hold: the first losses relative, every parameter element
    absolute plus relative, within the tolerance; the differences back."""
    want = {"losses": [1.5, 1.25], "params": {"w": torch.tensor([0.5, -2.0, 0.0])},
            "largest_change": 0.25}
    got = {"losses": [1.5 * (1 + shift), 1.25],
           "params": {"w": want["params"]["w"] + shift}}
    if ok:
        out = chip_smoke._mesh_compare("t", got, want, 1e-5, losses_held=2)
        assert out["max_abs_param_diff"] == pytest.approx(shift, abs=1e-7)
        assert out["largest_param_change"] == 0.25 and out["limit"] == 1e-5
        assert out["adam_reach"] is None and "first_step" not in out
        assert out["loss_rel_diff_by_step"][1] == 0.0
    else:
        with pytest.raises(AssertionError, match="t: losses"):
            chip_smoke._mesh_compare("t", got, want, 1e-5, losses_held=1)
    got["losses"][1] = 2.0  # a later loss beyond the steps held is reported, not held
    if ok:
        assert chip_smoke._mesh_compare("t", got, want, 1e-5, losses_held=1)[
            "loss_rel_diff_by_step"][1] == pytest.approx(0.6)


@pytest.mark.parametrize("noisy_shift,ok", [(1.5e-4, True), (2.5e-4, False)])
def test_mesh_phase_holds_adam_by_the_noise_floor_after_its_first_step(noisy_shift, ok):
    """Under Adam (lr 1e-4) the first step's parameters within 1e-5, except
    an element whose first gradient lies below 1e-4 of its tensor's largest,
    within 2 lr (2.1e-4); after the last step (2 here) every element within
    2 lr a step (4.1e-4), those beyond 1e-5 counted."""
    p0 = torch.tensor([0.5, -2.0, 0.25])
    want = {"losses": [1.5, 1.25], "params": {"w": p0 + 1e-4}, "first_params": {"w": p0},
            "largest_change": 2e-4, "first_grads": {"w": torch.tensor([1.0, 0.5, 1e-6])}}
    got = {"losses": [1.5, 1.25], "params": {"w": want["params"]["w"] + torch.tensor(
               [0.0, 3e-4, 0.0])},
           "first_params": {"w": p0 + torch.tensor([0.0, 0.0, noisy_shift])}}
    if not ok:
        with pytest.raises(AssertionError, match="after step 1"):
            chip_smoke._mesh_compare("t", got, want, 1e-5, losses_held=1, adam_lr=1e-4)
        return
    out = chip_smoke._mesh_compare("t", got, want, 1e-5, losses_held=1, adam_lr=1e-4)
    assert out["first_step"]["noise_floor_share"] == pytest.approx(1 / 3)
    assert out["first_step"]["max_abs_diff_under_noise_floor"] == pytest.approx(noisy_shift,
                                                                                 rel=1e-4)
    assert out["first_step"]["max_abs_param_diff"] == 0.0
    assert out["adam_reach"] == pytest.approx(4.1e-4)
    assert out["beyond_limit_share"] == pytest.approx(1 / 3)
    got["first_params"]["w"][0] += 2e-5  # above the floor, the first step holds 1e-5
    with pytest.raises(AssertionError, match="after step 1"):
        chip_smoke._mesh_compare("t", got, want, 1e-5, losses_held=1, adam_lr=1e-4)
    got["first_params"]["w"][0] -= 2e-5
    got["params"]["w"][1] += 2e-4  # past Adam's reach after the last step
    with pytest.raises(AssertionError, match="limit 0.00041"):
        chip_smoke._mesh_compare("t", got, want, 1e-5, losses_held=1, adam_lr=1e-4)


def test_training_launches_count_each_kernel_per_pass():
    """A train step of the Mamba head launches K3 forward and backward once
    a block; of the LSTM stack K2 forward once and its backward once a
    layer; of a bidirectional head K5 forward and backward once a layer and
    direction; nothing else."""
    mamba, seq = chip_smoke.TRAIN_CONFIGS["deployed_mamba"]
    want = chip_smoke._expected_train_launches(mamba, 3, 2)
    assert {n: c for n, c in want.items() if c} == {"selective_scan": 9, "selective_scan_bwd": 6}
    lstm, _ = chip_smoke.TRAIN_CONFIGS["ucf50_lstm"]
    want = chip_smoke._expected_train_launches(lstm, 3, 2)
    assert {n: c for n, c in want.items() if c} == {"lstm_stack": 3, "lstm_stack_bwd": 8}
    bidir = {**lstm, "rnn_type": "gru", "bidirectional": True}
    want = chip_smoke._expected_train_launches(bidir, 1, 1)
    assert {n: c for n, c in want.items() if c} == {"gru_scan": 8, "gru_scan_bwd": 8}
    assert mamba == chip_smoke.DEPLOYED and seq == chip_smoke.T
    assert set(want) == set(chip_smoke.RNN_KERNELS) | set(chip_smoke.BWD_KERNELS) | {
        "selective_scan"}


def test_backward_rows_name_their_sources_and_the_vct_backward_they_replace():
    from pathlib import Path

    root = Path(chip_smoke.__file__).resolve().parent
    for name, (source, replaces) in chip_smoke.BWD_KERNELS.items():
        assert (root / source).is_file(), name
        path, line = replaces.rsplit(":", 1)
        text = (root / path).read_text().splitlines()[int(line) - 1]
        assert "def " in text and "bwd" in text, (name, text)


# ---------------------------------------------------------------------------
# the resume and weights phase


@pytest.mark.parametrize("classif_mode", ["multiclass", "multiple_binary"])
@pytest.mark.parametrize("rnn_type", ["lstm", "gru", "mamba"])
def test_reference_key_list_is_the_reference_layout_and_ports_in_full(rnn_type, classif_mode):
    """At a small config, the phase's reference-LRCN key list is the
    state_dict layout of the reference-layout torch LRCN of
    tests/test_lrcn_port.py, key for key and shape for shape, and
    ``port_reference_lrcn`` consumes a seeded dict of it in full, each
    tensor landing as written."""
    import torch
    from test_lrcn_port import CLASSES, HIDDEN, LAYERS, RNN_INPUT, T, TRefLRCNExact

    from vct_torch.core.config import ModelConfig
    from vct_torch.models import build_model
    from vct_torch.models.lrcn_port import port_reference_lrcn

    cfg = ModelConfig(num_classes=CLASSES, cnn_backbone="resnet18", rnn_type=rnn_type,
                      rnn_input_size=RNN_INPUT, rnn_layer=LAYERS, hidden_size=HIDDEN,
                      classif_mode=classif_mode)
    keys = chip_smoke._reference_lrcn_keys(cfg, T)
    reference = TRefLRCNExact(rnn_type, "all", classif_mode).state_dict()
    assert keys == {k: tuple(v.shape) for k, v in reference.items()}
    sd = chip_smoke._seeded_state_dict(torch, keys, seed=0)
    model = port_reference_lrcn(build_model(cfg, T, device="cpu"), sd, cfg)
    ported = model.state_dict()
    assert torch.equal(ported["cnn_backbone.layer2_0.downsample_conv.weight"],
                       sd["cnn_backbone.layer2.0.downsample.0.weight"])
    assert torch.equal(ported["adapt.bn3.weight"], sd["bn3.weight"])
    if rnn_type == "mamba":
        assert torch.equal(ported["mamba_1.mixer.conv.weight"], sd["rnn.1.mixer.conv1d.weight"])
    else:
        assert torch.equal(ported[f"rnn.{rnn_type}.weight_hh_l1"], sd["rnn.weight_hh_l1"].T)


def test_bidirectional_and_last_key_lists_port_in_full():
    import torch

    from vct_torch.core.config import ModelConfig
    from vct_torch.models import build_model
    from vct_torch.models.lrcn_port import port_reference_lrcn

    for kw in ({"rnn_type": "gru", "bidirectional": True, "rnn_out": "last"},
               {"rnn_type": "mamba", "bidirectional": True}):
        cfg = ModelConfig(cnn_backbone="resnet18", rnn_input_size=8, hidden_size=6, rnn_layer=2,
                          **kw)
        sd = chip_smoke._seeded_state_dict(torch, chip_smoke._reference_lrcn_keys(cfg, 5), 1)
        port_reference_lrcn(build_model(cfg, 5, device="cpu"), sd, cfg)


def test_torchvision_key_lists_map_onto_the_ports_resnets():
    """resnet18's list is tests/test_weight_port.py's, written out apart;
    resnet50's maps key for key, by the phase's name map, onto the port's
    resnet50 with the same shapes, ``fc`` aside."""
    from test_weight_port import _torchvision_resnet18_keys

    from vct_torch.models.backbones.resnet import resnet50

    assert chip_smoke._torchvision_resnet_keys("resnet18") == _torchvision_resnet18_keys()
    keys = chip_smoke._torchvision_resnet_keys("resnet50")
    ours = {k: tuple(v.shape) for k, v in resnet50().state_dict().items()}
    mapped = {chip_smoke._torchvision_to_port(k): s for k, s in keys.items()
              if not k.startswith("fc.")}
    assert mapped == ours and len(keys) == len(ours) + 2


_TRACE = {"traceEvents": [
    {"ph": "X", "cat": "kernel", "name": "void (anonymous namespace)::rnn_reg_kernel<4, 1, 14>"
                                         "(float const*, float const*, float*, int, int, int)"},
    {"ph": "X", "cat": "kernel", "name": "void (anonymous namespace)::rnn_reg_kernel<4, 1, 14>"
                                         "(float const*, float const*, float*, int, int, int)"},
    {"ph": "X", "cat": "kernel",
     "name": "_ZN44_GLOBAL__N__c67ee736_11_lstm_bwd_cu_2819a04d18rnn_bwd_reg_kernelILi4ELi2ELi8E"},
    {"ph": "X", "cat": "kernel", "name": "void rnn_bwd_cols_kernel<3>(float const*)"},
    {"ph": "X", "cat": "Kernel", "name": "void scan_bwd_kernel<1, 32>(float const*)"},
    {"ph": "X", "cat": "kernel", "name": "void selective_scan_kernel<2>(float const*)"},
    {"ph": "X", "cat": "kernel", "name": "ampere_sgemm_128x64_nn"},
    {"ph": "X", "cat": "cpu_op", "name": "selective_scan_kernel"},
    {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel"},
    {"ph": "M", "name": "process_name"},
]}


def test_trace_reader_counts_each_kernel_group(tmp_path):
    import json

    path = tmp_path / "host_1.2.pt.trace.json"
    path.write_text(json.dumps(_TRACE))
    assert chip_smoke._trace_kernel_counts(path) == {
        "selective_scan": 1, "selective_scan_bwd": 1, "lstm_gru": 2, "lstm_gru_bwd": 2}
    launches = {"selective_scan": 1, "selective_scan_bwd": 1, "lstm_stack": 1, "gru_scan": 1,
                "lstm_stack_bwd": 1, "gru_scan_bwd": 1, "normalize_frames": 5}
    assert chip_smoke._counted_groups(launches) == chip_smoke._trace_kernel_counts(path)
    assert chip_smoke._nonzero({"a": 0, "b": 2}) == {"b": 2}


def test_mobilenet_v2_key_list_and_name_map_cover_the_port():
    """Phase 13's torchvision mobilenet_v2 layout, written out in the script,
    maps by its name map onto every tensor of the port's backbone, shape for
    shape, and is torchvision's (tests/test_weight_port.py's list)."""
    from test_weight_port import _mobilenet_v2_keys

    from vct_torch.models.backbones import build_backbone

    keys = chip_smoke._torchvision_mobilenet_v2_keys()
    assert keys == _mobilenet_v2_keys()
    target = build_backbone("mobilenet_v2")[0].state_dict()
    mapped = {chip_smoke._mobilenet_v2_to_port(k): s for k, s in keys.items()
              if not k.startswith("classifier.")}
    assert mapped.keys() == target.keys()
    assert all(tuple(target[k].shape) == tuple(s) for k, s in mapped.items())


def test_reference_videomamba_key_list_is_what_the_importer_consumes():
    """Phase 13's reference VideoMamba layout, at a small width, seeded as
    the script seeds it, goes through ``port_reference_videomamba`` whole."""
    import torch

    from vct_torch.core.config import ModelConfig
    from vct_torch.models import build_model
    from vct_torch.models.lrcn_port import port_reference_videomamba

    cfg = ModelConfig(model_family="videomamba", cnn_backbone="resnet18", vm_d_model=12,
                      vm_d_inner=24, vm_n_state=4, vm_dt_rank=4, vm_n_layer=2)
    sd = chip_smoke._seeded_state_dict(torch, chip_smoke._reference_videomamba_keys(cfg), seed=1)
    model = port_reference_videomamba(build_model(cfg, 4, device="cpu"), sd, cfg)
    assert torch.equal(model.layer_1.mixer.A_log, sd["layers.1.mixer.A_log"])


# ---------------------------------------------------------------------------
# the captioning phase


class _Counted:
    def __init__(self, launches=0):
        self.launches = launches


def test_caption_phase_demands_zero_launches_from_every_kernel():
    """Captioning reaches no kernel: the phase reads every wrapper's counter
    (serving's and training's, each a ``.launches`` the wrapper keeps) and
    fails naming any that launched."""
    counters = chip_smoke._all_counters()
    assert set(counters) == (set(chip_smoke._serve_counters()) | set(chip_smoke._train_counters()))
    assert {"pair_scores", "ssim_pair_scores", "normalize_frames", "selective_scan",
            "selective_scan_bwd", "lstm_stack", "gru_scan_bwd"} <= set(counters)
    assert all(isinstance(fn.launches, int) for fn in counters.values())
    chip_smoke._require_no_launches("caption", {"a": _Counted(), "b": _Counted()})
    with pytest.raises(AssertionError, match=r"caption s2vt.*'gru_scan': 2"):
        chip_smoke._require_no_launches("caption s2vt", {"lstm_stack": _Counted(),
                                                          "gru_scan": _Counted(2)})


def test_caption_tie_rule(capsys):
    """Equal rows pass without scoring; a row that differs passes only when
    the CPU scores both sequences within the tolerance (both printed), and
    fails beyond it."""
    import torch

    card = torch.tensor([[1, 5, 6, 2], [1, 7, 2, 0]])

    def never():
        raise AssertionError("scored equal rows")

    assert chip_smoke._hold_tokens("beam", card, card.clone(), never) == 0
    cpu = torch.tensor([[1, 5, 6, 2], [1, 8, 2, 0]])
    tie = lambda: (torch.tensor([0.0, -3.00005]), torch.tensor([0.0, -3.0]))  # noqa: E731
    assert chip_smoke._hold_tokens("beam", card, cpu, tie) == 1
    out = capsys.readouterr().out
    assert "row 1 ties" in out and "[1, 7, 2, 0]" in out and "[1, 8, 2, 0]" in out
    apart = lambda: (torch.tensor([0.0, -3.001]), torch.tensor([0.0, -3.0]))  # noqa: E731
    with pytest.raises(AssertionError, match="row 1 card"):
        chip_smoke._hold_tokens("beam", card, cpu, apart)


def test_caption_sequence_scores_are_the_beams():
    """A sequence's CPU score sums its teacher-forced log-probs through its
    first <end> (a beam's score; the <pad> after it costs 0), or through
    the first position two greedy sequences part."""
    import torch

    seqs = torch.tensor([[4, 5, 2, 0], [4, 4, 4, 4]])
    assert chip_smoke._first_end(torch, seqs).tolist() == [2, 3]
    logp = torch.log_softmax(torch.randn(2, 4, 6, generator=torch.Generator().manual_seed(0)),
                             dim=-1)

    class Fixed(torch.nn.Module):
        def forward(self, video, targets):
            return logp

    got = chip_smoke._sequence_scores(torch, Fixed(), None, seqs, torch.tensor([2, 1]))
    want = [logp[0, 0, 4] + logp[0, 1, 5] + logp[0, 2, 2], logp[1, 0, 4] + logp[1, 1, 4]]
    torch.testing.assert_close(got, torch.stack(want))


def test_caption_stand_ins_are_laid_out_as_vct_lays_them():
    """The phase's vocabulary has 10,000 ids with vct's specials; its seeded
    captions are encode_caption rows: <start>, words, <end>, <pad>s."""
    import torch

    vocab = chip_smoke._caption_vocab()
    assert len(vocab) == chip_smoke.CAPTION_VOCAB == 10_000
    assert [vocab[t] for t in ("<pad>", "<start>", "<end>", "<unk>")] == [0, 1, 2, 3]
    rows = chip_smoke._seeded_captions(torch, torch.Generator().manual_seed(0), 16, 30)
    for row in rows.tolist():
        end = row.index(2)
        assert row[0] == 1 and 6 <= end <= 29 and set(row[end + 1:]) <= {0}
        assert all(4 <= t < 10_000 for t in row[1:end])


@pytest.mark.parametrize("decoder", ["cv2", "native"])
@pytest.mark.parametrize("size", [(80, 80), (15, 17)])
def test_files_phase_avi_decodes_to_the_seeded_frames(tmp_path, decoder, size):
    """The phase's uncompressed AVI files read back bit-equal through the
    port's decode (rows padded to 4 bytes at odd widths)."""
    pytest.importorskip("cv2")
    import numpy as np

    from vct_torch.data import video, videodec

    if decoder == "native" and not videodec.is_available():
        pytest.fail("the native decoder must build where the ffmpeg libraries are")
    frames = np.random.RandomState(0).randint(0, 256, (7,) + size + (3,), np.uint8)
    path = tmp_path / "v.avi"
    chip_smoke._write_avi(path, frames)
    got = video.decode_video(str(path), size[0], size[1], decoder=decoder)
    assert np.array_equal(np.stack(got), frames)


def test_files_phase_holds_cli_probabilities_by_label():
    """The CLI's sorted labels and scores are put back in class order and
    held to the in-process probabilities; names must match the requests."""
    import numpy as np

    want = np.array([[0.25, 0.75], [0.6, 0.4]], np.float32)
    results = [{"video_name": "a", "labels": ["y", "x"], "scores": [0.75, 0.25]},
               {"video_name": "b", "labels": ["x", "y"], "scores": [0.6, 0.4]}]
    text = "Final data shape: (2, 4, 8, 8, 3)\n" + json.dumps(results, indent=4) + "\nrest"
    assert chip_smoke._cli_results(text) == results
    assert chip_smoke._hold_cli_probs("t", results, ["a", "b"], ["x", "y"], want) < 1e-7
    with pytest.raises(AssertionError, match="differ"):
        chip_smoke._hold_cli_probs("t", results, ["a", "b"], ["x", "y"], want[::-1].copy())
    with pytest.raises(AssertionError, match="requests"):
        chip_smoke._hold_cli_probs("t", results, ["b", "a"], ["x", "y"], want)


# ---------------------------------------------------------------------------
# the worker phase


@pytest.mark.parametrize("name", ["@user0_video_1500.avi", "@some.user_video_7001.mp4"])
def test_video_name_inverts_construct_url(name):
    from pathlib import Path

    from vct_torch.serve.deployment import construct_url

    assert chip_smoke._video_name(construct_url(name), Path(name).suffix) == name
    with pytest.raises(ValueError, match="not a TikTok video URL"):
        chip_smoke._video_name("https://example.com/@user/photo/1", ".avi")


def test_local_downloader_copies_the_url_s_file(tmp_path):
    src, dst = tmp_path / "src", tmp_path / "videos"
    src.mkdir()
    dst.mkdir()
    for i in (1, 2):
        (src / f"@user_video_{i}.avi").write_bytes(bytes([i]) * 10)
    seconds = []
    download = chip_smoke._local_downloader(src, ".avi", seconds)
    download("https://www.tiktok.com/@user/video/2", str(dst))
    assert [p.name for p in dst.iterdir()] == ["@user_video_2.avi"]
    assert (dst / "@user_video_2.avi").read_bytes() == bytes([2]) * 10
    assert len(seconds) == 1 and seconds[0] >= 0
    with pytest.raises(FileNotFoundError):
        download("https://www.tiktok.com/@user/video/3", str(dst))


@pytest.mark.parametrize("idle_launches,ok", [(0, True), (3, False)], ids=["idle", "launched"])
def test_worker_phase_holds_a_message_that_classifies_nothing_to_no_launch(idle_launches, ok):
    """Phase 16: a message that forwards 4 videos launches K3 once a block
    (3); a message whose file the store already holds classifies nothing
    (no forward, no ``names``) and must launch nothing."""
    names = ["pair_scores", "selective_scan"]
    busy = {"url": "u0", "names": ["a", "b", "c", "d"], "forward_s": 0.01,
            "launches": {"pair_scores": 0, "selective_scan": 3}}
    idle = {"url": "u3", "check_s": 0.001,
            "launches": {"pair_scores": 0, "selective_scan": idle_launches}}
    if not ok:
        with pytest.raises(AssertionError, match="message u3: launches"):
            chip_smoke._worker_messages([busy, idle], names)
        return
    got = chip_smoke._worker_messages([busy, idle], names)
    assert [m["videos"] for m in got] == [4, 0]
    assert got[0]["launches"] == {"selective_scan": 3} and got[1]["launches"] == {}
    assert got[1]["forward_s"] is None and got[1]["check_s"] == 0.001


def test_serve_urls_runs_the_worker_flow_and_returns_the_stored_rows(tmp_path, monkeypatch):
    """Phase 16's harness, which phase 18 shares, on the CPU: a tiny
    checkpoint behind the backend, the queue and a worker in threads; every
    URL answered with its stored labels and every confirmed file deleted."""
    import os

    import numpy as np
    import torch

    from vct_torch.core.config import Config
    from vct_torch.models import build_model
    from vct_torch.serve import deployment, worker
    from vct_torch.train.checkpoint import save_checkpoint

    pytest.importorskip("cv2")
    t, hw = 4, 24
    monkeypatch.setattr(chip_smoke, "T", t)
    monkeypatch.setattr(worker, "resolve_device", lambda device=None: torch.device("cpu"))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *args, **kwargs: None)
    cfg = Config().replace(**{"model.num_classes": "3", "model.cnn_backbone": "resnet18",
                              "model.rnn_type": "lstm", "model.rnn_input_size": "8",
                              "model.rnn_layer": "1", "data.sequence_length": str(t),
                              "data.img_height": str(hw), "data.img_width": str(hw),
                              "data.sampling_method": "sad"})
    model = build_model(cfg.model, t, device="cpu")
    save_checkpoint(str(tmp_path / "ck"), model.state_dict(), cfg, ["a", "b", "c"])
    src, videos = tmp_path / "serve", tmp_path / "videos"
    src.mkdir()
    videos.mkdir()
    rng = np.random.RandomState(0)
    names = [f"@user_video_{i}.avi" for i in (1, 2)]
    for name in names:
        chip_smoke._write_avi(src / name, rng.randint(0, 256, (9, hw, hw, 3), np.uint8))
    urls = [deployment.construct_url(n) for n in names]
    seen, downloads = [], []
    w, rows, replies, load_s, log = chip_smoke._serve_urls(
        torch, tmp_path, str(tmp_path / "ck"), urls, videos, tmp_path / "results.db",
        downloads, instrument=seen.append)
    assert seen == [w] and sorted(rows) == sorted(urls)
    assert [r[:2] for r in replies] == [(200, {"url": u, "labels": rows[u]["labels"]})
                                        for u in urls]
    assert sorted(rows[urls[0]]["labels"]) == ["a", "b", "c"]
    assert len(downloads) == 2 and load_s > 0 and "Processing message" in log
    assert os.listdir(videos) == []


# ---------------------------------------------------------------------------
# the caption files phase


@pytest.fixture
def small_capfiles(monkeypatch):
    monkeypatch.setattr(chip_smoke, "CAPFILES_VIDEOS", 3)
    monkeypatch.setattr(chip_smoke, "CAPFILES_FRAMES", (8, 40))
    monkeypatch.setattr(chip_smoke, "CAPFILES_HW", (24, 32))


def test_caption_files_annotations_and_corrupt_files(tmp_path, small_capfiles):
    """Two captions a file, words of the stand-in vocabulary, the readable
    videos first; the readable annotations leave the corrupt files out; both
    corrupt files exist and fail the port's extraction."""
    pytest.importorskip("cv2")
    from vct_torch.caption import data

    videos, ann, readable = chip_smoke._capfiles_write(tmp_path)
    names = list(videos) + list(chip_smoke.CAPFILES_CORRUPT)
    pairs, _ = data.preprocess_annotations(str(ann))
    assert [n for n, _ in pairs] == [n for n in names for _ in range(2)]
    vocab = chip_smoke._caption_vocab()
    for _, caption in pairs:
        words = caption.split()
        assert 5 <= len(words) <= 12 and all(vocab[w] >= 4 for w in words)
    kept, _ = data.preprocess_annotations(str(readable))
    assert kept == [p for p in pairs if p[0] in videos]
    for name, frames in videos.items():
        assert 8 <= len(frames) <= 40 and frames.shape[1:] == (24, 32, 3)
        assert (tmp_path / "videos" / f"{name}.avi").is_file()
    errors = []
    for name in chip_smoke.CAPFILES_CORRUPT:
        with pytest.raises((OSError, ValueError)) as e:
            data.extract_frames_interval(str(tmp_path / "videos" / f"{name}.avi"), 30, 224)
        errors.append(e.type)
    assert errors == [OSError, ValueError]  # not opened; opened with no whole frame


@pytest.mark.parametrize("target", [5, 30])
def test_caption_files_expected_frames_are_what_extraction_gives(tmp_path, small_capfiles,
                                                                  target):
    """BGR, every (n // target)-th frame, cv2's resize, the last frame
    repeated: the port's extract_frames_interval on the written AVI files."""
    pytest.importorskip("cv2")
    import numpy as np

    from vct_torch.caption import data

    videos, _, _ = chip_smoke._capfiles_write(tmp_path)
    for name, frames in videos.items():
        got = data.extract_frames_interval(str(tmp_path / "videos" / f"{name}.avi"), target, 16,
                                           as_uint8=True)
        want = chip_smoke._interval_frames(frames, target, 16)
        assert np.array_equal(got, want), name
    rgb = np.zeros((3, 4, 4, 3), np.uint8)
    rgb[..., 0] = np.arange(3)[:, None, None]  # red channel = frame index
    want = chip_smoke._interval_frames(rgb, 2, 4)
    assert want.shape == (2, 4, 4, 3) and (want[..., 2] == [[[0]], [[1]]]).all()
    assert (chip_smoke._interval_frames(rgb, 5, 4)[..., 2][:, 0, 0] == [0, 1, 2, 2, 2]).all()


def test_caption_files_cli_lines_and_caption_hold():
    text = ("Vocabulary size: 9; dataset: 4 clips (lazy)\n"
            "Epoch [1/2], Loss: 4.25\nCheckpoint saved at epoch 1\n"
            "Epoch [2/2], Loss: 3.5\n[4.25, 3.5]\n"
            "v00.avi Generated Caption: w1 w2\nv01.avi Generated Caption: \n")
    assert chip_smoke._epoch_losses(text) == [4.25, 3.5]
    got = chip_smoke._generated_captions(text)
    assert got == {"v00.avi": "w1 w2", "v01.avi": ""}
    chip_smoke._hold_generated("t", got, dict(got))
    with pytest.raises(AssertionError, match=r"differ for \['v01.avi'\]"):
        chip_smoke._hold_generated("t", got, {**got, "v01.avi": "w3"})
    with pytest.raises(AssertionError, match="v02.avi"):
        chip_smoke._hold_generated("t", got, {**got, "v02.avi": "w3"})


@pytest.mark.parametrize("launches,want,ok", [
    ({"selective_scan": 3, "pair_scores": 1, "lstm_stack": 0}, {"selective_scan": 3,
                                                                "pair_scores": 1}, True),
    ({"selective_scan": 0, "pair_scores": 0}, {}, False),  # a plain version in the graph
    ({"selective_scan": 3, "pair_scores": 0}, {"selective_scan": 3, "pair_scores": 1}, False),
    ({"selective_scan": 3, "ssim_pair_scores": 1}, {"selective_scan": 3}, False),
], ids=["as_stated", "all_zero", "one_missing", "one_extra"])
def test_aot_phase_holds_each_artifact_to_its_launches(launches, want, ok):
    if ok:
        chip_smoke._aot_expect(launches, want, "dense")
    else:
        with pytest.raises(AssertionError, match="dense: launches"):
            chip_smoke._aot_expect(launches, want, "dense")


def test_aot_phase_eager_forward_is_the_artifacts(monkeypatch):
    """The eager path an artifact is held to: the model's softmax, after
    ``device_sample_clips`` for a raw artifact."""
    import numpy as np
    import torch

    from vct_torch.data.preprocess import device_sample_clips

    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Flatten(), torch.nn.Linear(4 * 5 * 5 * 3, 3))
    raw = torch.from_numpy(np.random.RandomState(0).randint(0, 256, (2, 8, 5, 5, 3),
                                                            dtype=np.uint8))
    lens = torch.tensor([8, 6], dtype=torch.int32)
    with torch.inference_mode():
        got = chip_smoke._aot_eager(torch, model, 4, "sad")(raw, lens)
        x = device_sample_clips(raw, 4, method="sad", lengths=lens)
        assert torch.equal(got, torch.softmax(model(x), dim=-1))
        dense = chip_smoke._aot_eager(torch, model, 4, None)(x)
        assert torch.equal(dense, got)


def test_caption_files_refusal_names_the_converter(tmp_path, monkeypatch):
    """Phase 17's check: a vct caption artifact as ``--model`` raises naming
    the converter (the refusal comes before any device work)."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    vids = tmp_path / "videos"
    vids.mkdir()
    (vids / "a.avi").write_bytes(b"unread")
    msg = chip_smoke._capfiles_refuse_artifact(torch, vids, tmp_path)
    assert "convert_vct_checkpoint.py SRC DST" in msg and "vct-aot-caption-v1" in msg


def test_aot_no_zoo_names_the_model_code_a_server_must_not_import():
    zoo = chip_smoke.AOT_NO_ZOO
    for name in ("vct_torch.models", "vct_torch.models.lrcn", "vct_torch.core.config",
                 "vct_torch.data.preprocess", "vct_torch.train.engine"):
        assert name.startswith(zoo)
    for name in ("vct_torch.serve.aot", "vct_torch.ops.selective_scan", "vct_torch.device",
                 "vct_torch.caption.vocab"):
        assert not name.startswith(zoo)


def test_sweep_phase_fails_a_trial_the_runner_would_log_and_skip(tmp_path, monkeypatch):
    """Phase 19's guard: a trial that raises is logged by the runner, which
    goes on, but it is recorded with its traceback, never as a result, and
    the phase's hold fails naming it."""
    import torch

    from vct_torch.core.config import Config
    from vct_torch.sweep.runner import SweepRunner

    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda: 0)

    def launch_failed(self, cfg):
        raise RuntimeError("selective_scan: kernel launch failed")

    monkeypatch.setattr(SweepRunner, "_train_inprocess", launch_failed)
    trials = []
    cfg = Config().replace(**{"sweep.checkpoint_file": str(tmp_path / "ckpt.json"),
                              "sweep.f1_threshold": "-1"})
    runner = chip_smoke._sweep_guard(torch, trials)(cfg, device="cpu")
    assert runner.run_training({"model.rnn_type": "mamba"}, test_runs=1) == (-float("inf"), None)
    assert runner.store.load() == [] and len(trials) == 1
    assert "kernel launch failed" in trials[0]["error"] and "f1" not in trials[0]
    with pytest.raises(AssertionError, match="trials raised: \\['mamba lr"):
        chip_smoke._sweep_hold_trials("grid", trials)


def _trial(memory, launches=1):
    return {"trial": f"t{memory}", "s": 1.0, "f1": 0.5, "accuracy": 0.5, "memory": memory,
            "launches": {"selective_scan": launches, "lstm_stack": 0}}


@pytest.mark.parametrize("trials,error", [
    ([_trial(100), _trial(100 + chip_smoke.SWEEP_MEMORY_SLACK), _trial(50)], None),
    ([_trial(100), _trial(101 + chip_smoke.SWEEP_MEMORY_SLACK)], "device memory grew"),
    ([_trial(100), _trial(100, launches=0)], "launched no kernel"),
], ids=["flat", "grown", "no_launch"])
def test_sweep_phase_holds_memory_flat_and_every_trial_to_a_launch(trials, error):
    if error is None:
        chip_smoke._sweep_hold_trials("grid", trials)
    else:
        with pytest.raises(AssertionError, match=error):
            chip_smoke._sweep_hold_trials("grid", trials)


@pytest.mark.parametrize("dtype,diff,ok", [
    ("bfloat16", 0.02, True), ("bfloat16", 0.0417, True), ("bfloat16", 0.05, False),
    ("bfloat16", float("nan"), False), ("float32", 1e-4, True), ("float32", 2e-4, False),
], ids=["in", "at", "over", "nan", "f32_at", "f32_over"])
def test_finetune_phase_fails_a_fold_beyond_its_limit(dtype, diff, ok):
    """The bf16 limit is FT_FOLD_BF16_OF_PLAIN times the plain model's own
    bf16 error (0.0139 here), the f32 one FT_FOLD_TOL_F32."""
    limit = chip_smoke._fold_limit(dtype, 0.0139)
    assert limit == (1e-4 if dtype == "float32" else 3.0 * 0.0139)
    if ok:
        chip_smoke._fold_hold(f"fold {dtype}", diff, limit)
    else:
        with pytest.raises(AssertionError, match=f"fold {dtype}: folded logits"):
            chip_smoke._fold_hold(f"fold {dtype}", diff, limit)


def _f64(*values):
    return torch.tensor(values, dtype=torch.float64)


def _ft_runs():
    """Phase 21's remat pair as ``_ft_stepper`` returns it: 3 steps, the
    parameter moved by 1e-3 at most, K3 9 forward and 9 backward."""
    steps, k3 = chip_smoke.FT_STEPS, {"selective_scan": 9, "selective_scan_bwd": 9}
    start = {"w": _f64(0.5, -2.0, 0.0), "d": _f64(0.0, 0.0)}
    off = {"losses": [1.5, 1.25, 1.0], "backbone_calls": [1] * steps, "launches": dict(k3),
           "start": start, "params": {"w": start["w"] + _f64(1e-3, -5e-4, 0.0),
                                      "d": start["d"].clone()}}
    on = {**off, "backbone_calls": [2] * steps, "launches": dict(k3),
          "params": {k: v.clone() for k, v in off["params"].items()}}
    return off, on, k3


@pytest.mark.parametrize("case,error", [
    ("equal", None),
    ("within", None),
    ("no_recompute", "backbone calls a step"),
    ("loss", "remat losses"),
    ("param", "remat: w differs"),
    ("moved_unchanged", "remat: d differs"),
    ("launches", "with remat: K3 launches"),
])
def test_finetune_phase_holds_remat_against_finetune(case, error):
    """Phase 21 (b): the losses bit-equal, the backbone twice a step with
    remat (once without), K3's launches in each run, every parameter within
    1e-5 of its tensor's largest change (a tensor that did not move must
    stay bit-equal)."""
    off, on, k3 = _ft_runs()
    if case == "within":
        on["params"]["w"] = on["params"]["w"] + _f64(0.0, 0.0, 9e-9)
    elif case == "no_recompute":
        on["backbone_calls"] = [1, 1, 1]
    elif case == "loss":
        on["losses"] = [1.5, 1.25, 1.0000001]
    elif case == "param":
        on["params"]["w"] = on["params"]["w"] + _f64(0.0, 0.0, 1.1e-8)
    elif case == "moved_unchanged":
        on["params"]["d"] = _f64(0.0, 1e-12)
    elif case == "launches":
        on["launches"] = {"selective_scan": 9, "selective_scan_bwd": 6}
    if error is None:
        out = chip_smoke._finetune_hold(off, on, k3)
        assert out["largest_change"] == pytest.approx(1e-3, rel=1e-9)
        assert out["limit_of_change"] == chip_smoke.FT_PARAM_TOL
        assert out["max_abs_param_diff"] == (0.0 if case == "equal" else pytest.approx(9e-9))
    else:
        with pytest.raises(AssertionError, match=error):
            chip_smoke._finetune_hold(off, on, k3)


@pytest.mark.parametrize("moved,error", [
    (["cnn_backbone.layer4_0.conv1.weight", "adapt.adapt1.weight"], None),
    (["cnn_backbone.layer4_2.bn3.bias", "cnn_backbone.layer3_5.conv3.weight"], "layer3_5"),
    (["cnn_backbone.conv1.weight"], "conv1"),
    (["adapt.adapt1.weight"], "no layer4 parameter"),
], ids=["layer4", "layer3_moved", "stem_moved", "nothing_in_the_backbone"])
def test_finetune_phase_fails_when_a_frozen_parameter_moves(moved, error):
    """Phase 21 (c): after a ``freeze_until`` step only layer4's backbone
    parameters may move, and some must."""
    names = ["cnn_backbone.conv1.weight", "cnn_backbone.layer3_5.conv3.weight",
             "cnn_backbone.layer4_0.conv1.weight", "cnn_backbone.layer4_2.bn3.bias",
             "adapt.adapt1.weight"]
    flags = {n: n in moved for n in names}
    if error is None:
        assert chip_smoke._freeze_hold(flags) == ["cnn_backbone.layer4_0.conv1.weight"]
    else:
        with pytest.raises(AssertionError, match=error):
            chip_smoke._freeze_hold(flags)
