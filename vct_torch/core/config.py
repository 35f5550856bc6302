"""The configuration fields the serving path reads.

The port's own copy of ``vct.core.config``'s ``ModelConfig`` (every field,
same names and defaults) and of the ``DataConfig`` fields that frame
selection and the model input read. Immutable dataclasses; override with
``dataclasses.replace``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

__all__ = ["DataConfig", "ModelConfig"]


@dataclass(frozen=True)
class DataConfig:
    """Frame geometry and selection method of the model input."""

    img_height: int = 80
    img_width: int = 80
    sequence_length: int = 60
    # uniform | ssim | sad | optical_flow (flow-magnitude proxy)
    sampling_method: str = "uniform"


@dataclass(frozen=True)
class ModelConfig:
    """LRCN / VideoMamba model family knobs."""

    model_family: str = "lrcn"  # lrcn | videomamba | lrcn2 | td_cnn_lstm
    num_classes: int = 4
    cnn_backbone: str = "resnet50"
    rnn_type: str = "mamba"  # lstm | gru | mamba
    rnn_input_size: int = 8
    rnn_layer: int = 3
    mult_factor: int = 4
    hidden_size: Optional[int] = None  # None -> mult_factor * rnn_input_size
    rnn_out: str = "all"  # all | last
    bidirectional: bool = False
    dropout: float = 0.25
    adapt: str = "lnsd3"  # Adapt DSL string
    classif_mode: str = "multiclass"  # multiclass | multiple_binary
    finetune: bool = False
    freeze_until: str = ""
    use_adapt_dsl: bool = False
    vm_d_model: int = 512
    vm_d_inner: int = 2048
    vm_n_state: int = 16
    vm_dt_rank: int = 16
    vm_n_layer: int = 4
    vm_temporal_mode: str = "mean"  # mean | max | last | all
    # Backbone compute dtype ("bfloat16" | "float32"); the head stays f32.
    compute_dtype: str = "float32"
    remat_backbone: bool = False
    seq_shard: bool = False
    # Mamba scan: "associative" (log-depth, plain torch), "scan" (sequential,
    # plain torch) or "pallas" (the hand-written selective_scan kernel; the
    # name is the reference's).
    scan_impl: str = "associative"
    backbone_weights: str = ""

    @property
    def resolved_hidden_size(self) -> int:
        if self.hidden_size is not None:
            return self.hidden_size
        return self.mult_factor * self.rnn_input_size
