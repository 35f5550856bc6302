"""The whole served step: the counted operations of the clips classified in
the traced run's window outside its profiled stretch (the backbone's
convolutions over T frames and the head's forward, ``core/work.py``) over
those batches' host-clock seconds, as a share of the card's float32 peak
(67 TFLOP/s outside the tensor cores: the configuration states float32 with
TF32 off).
The run's earlier lines print the card's power limit."""

from bench_port.core import work


def read(view):
    cfg = view.cfg
    return view.flops_share(work.backbone_flops_per_frame(cfg) * cfg["sequence_length"]
                            + work.head_flops_per_clip(cfg), work.F32_OPS_PER_S)
