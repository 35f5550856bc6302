"""CPU tests of ``chip_smoke.py``'s helpers that need no card: the summary
of nvcc's ``-Xptxas -v`` log it prints after the build, and the bound it
reports beside each kernel."""

from __future__ import annotations

import pytest

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


@pytest.mark.parametrize("argv", [[], ["--k1-timing"]])
def test_main_needs_a_card(argv):
    """Without CUDA the script exits non-zero before any phase."""
    assert chip_smoke.main(argv) == 1


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
