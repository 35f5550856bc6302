"""Typed configuration tree: the port's own copy of ``vct.core.config``.

Every section, field, default and derived value of ``vct``'s tree (data,
model, train, mesh, sweep, serve, caption), the dotted-path overrides
(``Config.replace``, ``apply_overrides``), YAML/JSON files
(``load_config``) and CLI overrides (``parse_cli_overrides``): the same
override strings give the same values. Immutable dataclasses.
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field, fields, is_dataclass
from typing import Any, Optional

__all__ = [
    "DataConfig",
    "ModelConfig",
    "TrainConfig",
    "SweepConfig",
    "ServeConfig",
    "MeshConfig",
    "CaptionConfig",
    "Config",
    "load_config",
    "apply_overrides",
    "parse_cli_overrides",
]


def _frozen(**kw):
    return dataclass(frozen=True, **kw)


@_frozen()
class DataConfig:
    """Video ingest / frame-sampling knobs (``all_config.py:6-22,32-35``)."""

    dataset_path: str = ""
    val_path: str = ""
    test_path: str = ""
    processed_data_path: str = "/tmp/vct_cache"
    img_height: int = 80
    img_width: int = 80
    sequence_length: int = 60
    # uniform | ssim | sad | optical_flow (flow-magnitude proxy)
    sampling_method: str = "uniform"
    max_videos: int = 1000
    # Host decode workers feeding the device preprocessing kernel.
    decode_workers: int = 4
    # Decode backend: cv2 (reference-exact) | native (ffmpeg C++ decoder,
    # GIL-free, cv2-exact pixels via source-size decode + cv2 resize) |
    # auto (native when the library builds, else cv2).
    decoder: str = "cv2"

    prefetch_depth: int = 2
    # Cache backend: hdf5 (reference parity, float32) | clipcache (native
    # uint8 mmap store + threaded prefetch loader, ~170x faster shuffled
    # epoch reads; normalization moves on-device)
    cache_format: str = "hdf5"
    val_fraction: float = 0.2
    split_seed: int = 42
    # Synthetic-data harness (the reference's own smoke pattern,
    # lrcn/mamba.py:440-457): train on random clips, no dataset needed.
    synthetic: bool = False
    synthetic_samples: int = 64
    # Out-of-core training: stream batches straight from the dataset cache
    # (HDF5 or clipcache) instead of materializing the arrays in host RAM —
    # at reference scale (4000 x 60 x 80 x 80 x 3 f32 ~ 18 GB) in-RAM breaks.
    stream: bool = False

    @property
    def cache_key(self) -> str:
        # Mirrors the reference's cache-file naming (all_config.py:32-35).
        return f"{self.max_videos}_{self.sequence_length}fr_{self.sampling_method}"

    @property
    def data_file(self) -> str:
        ext = "vctc" if self.cache_format == "clipcache" else "h5"
        return os.path.join(self.processed_data_path, f"X_data_{self.cache_key}.{ext}")

    @property
    def labels_file(self) -> str:
        return os.path.join(self.processed_data_path, f"y_labels_{self.cache_key}.npy")

    @property
    def classes_file(self) -> str:
        return os.path.join(self.processed_data_path, f"class_labels_{self.cache_key}.npy")


@_frozen()
class ModelConfig:
    """LRCN / VideoMamba model family knobs (``all_config.py:14-31``)."""

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
    adapt: str = "lnsd3"  # Adapt DSL string (all_config.py:26, adapt.py:6-60)
    classif_mode: str = "multiclass"  # multiclass | multiple_binary
    # Train the backbone too. The reference's FINETUNE flag is dead code (it
    # defaults True yet the backbone is always frozen, models.py:144-145);
    # here the flag actually works, defaulting to the reference's real
    # behavior (frozen).
    finetune: bool = False
    # Partial freezing with finetune=True: comma-separated backbone param
    # prefixes to keep frozen, e.g. "conv1,bn1,layer1,layer2" (the
    # freeze_until_layer pattern of lrcn/rgb_lrcn.py:208-245).
    freeze_until: str = ""
    # Route the adapter through the Adapt DSL string in `adapt` instead of
    # the canonical hardcoded 3-stage MLP (models_bidir.py:119-155 variant).
    use_adapt_dsl: bool = False
    # VideoMamba-specific (lrcn/videomamba.py:332-386)
    vm_d_model: int = 512
    vm_d_inner: int = 2048
    vm_n_state: int = 16
    vm_dt_rank: int = 16
    vm_n_layer: int = 4
    vm_temporal_mode: str = "mean"  # mean | max | last | all
    # Compute dtype for the jitted forward path ("bfloat16" | "float32").
    compute_dtype: str = "float32"
    # Rematerialize the backbone in the backward pass (activation checkpointing):
    # trades recompute FLOPs for the conv-stack activation memory. Only
    # matters when finetune=True (frozen backbones never backprop).
    remat_backbone: bool = False
    # Sequence parallelism: shard the B*T frame batch over BOTH mesh axes
    # through the conv stack, resharding to data-only for the temporal scan.
    seq_shard: bool = False
    # Mamba scan: "associative" (log-depth, plain torch), "scan" (sequential,
    # plain torch) or "pallas" (the hand-written CUDA kernels; the name is
    # the reference's).
    scan_impl: str = "associative"
    # Path to a torchvision state_dict (.pth / .npz) for the backbone — the
    # reference's ``pretrained=True`` (models.py:133) with the download
    # replaced by a user-supplied file (vct_torch.models.backbones.port; the
    # ResNet family so far).
    backbone_weights: str = ""

    @property
    def resolved_hidden_size(self) -> int:
        if self.hidden_size is not None:
            return self.hidden_size
        return self.mult_factor * self.rnn_input_size


@_frozen()
class TrainConfig:
    """Train/eval engine knobs (``all_config.py:12-30``, ``train_eval.py:9-54``)."""

    batch_size: int = 32
    epochs: int = 8
    learning_rate: float = 1e-4
    optimizer: str = "adam"
    weight_decay: float = 0.0
    grad_clip: float = 0.0  # 0 = off (videomamba uses 1.0: lrcn/mamba.py:310-313)
    weighted_loss: bool = False
    early_stop: float = 0.0  # stop when epoch loss < early_stop (0 = off)
    early_stop_patience: int = 0  # patience-based variant (videomamba.py:632-658)
    # ReduceLROnPlateau (the VideoMambaTrainer recipe, lrcn/mamba.py:474-476
    # factor 0.1 / patience 5, stepped on val loss when fit gets val data,
    # else on train loss). factor 0 = scheduler off.
    lr_plateau_factor: float = 0.0
    lr_plateau_patience: int = 5
    seed: int = 42
    model_path: str = "/tmp/vct_model"
    save_model: bool = True
    # Warm-start: checkpoint directory whose params initialize training
    # (config must build a compatible model).
    init_from: str = ""
    # Crash-tolerant training: save the full train state (params + optimizer
    # + epoch) every epoch under model_path and auto-resume from it. The
    # reference has this only for captioning
    # (s2vt/main_configurable.py:337-357) and sweeps; here the classification
    # trainer gets it too.
    resume: bool = False
    log_every: int = 0  # steps; 0 = per-epoch only
    checkpoint_keep: int = 3
    # Frozen-backbone feature caching: extract the (bit-constant) backbone
    # features once before the epoch loop and train the adapter/RNN/head
    # from the cached (N, T, F) block — identical loss trajectory, no conv
    # stack recompute per epoch. Ignored when model.finetune is true or the
    # model family trains its convs (scratch CNNs).
    feature_cache: bool = False
    # Observability: profiler trace directory (first profiled epoch) and
    # per-epoch history JSON (lrcn/training_history.json counterpart).
    profile_dir: str = ""
    history_path: str = ""


@_frozen()
class MeshConfig:
    """Device mesh / parallelism layout (the reference is single-device,
    ``all_config.py:70``; the port's trainer runs on one card)."""

    data_axis: int = -1  # -1 = all remaining devices
    model_axis: int = 1
    # Donate params in the train step; turn off for debugging.
    donate: bool = True


@_frozen()
class SweepConfig:
    """HPO sweep knobs (``all_config.py:39-45``, ``hyperparam.py``)."""

    strategy: str = "grid"  # grid | bayesian | genetic
    test_runs: int = 3
    checkpoint_file: str = "/tmp/vct_sweep/checkpoint.json"
    best_model_dir: str = "/tmp/vct_sweep/best_models"
    log_file: str = "/tmp/vct_sweep/sweep_log.txt"
    f1_threshold: float = 0.71  # keep-model threshold (runner.py:67-79)
    n_trials: int = 50
    # genetic
    population: int = 10
    generations: int = 5
    cx_prob: float = 0.7
    mut_prob: float = 0.2


@_frozen()
class ServeConfig:
    """Serving stack knobs (``all_config.py:46-51``, ``worker.py:24-28``)."""

    app_stage: str = "devel"  # devel | prod
    video_dir: str = "/tmp/vct_videos"
    backend_host: str = "0.0.0.0"
    backend_port: int = 5000
    queue_port: int = 54000
    db_path: str = "/tmp/vct_serve/results.db"
    model_path: str = ""
    sampling_method: str = "uniform"
    sequence_length: int = 60
    # Base URL of the backend service. Empty -> derived from app_stage
    # (localhost in devel, the backend_rt container in prod); the worker
    # honors the BACKEND_URL env var (its documented surface).
    backend_base_url: str = ""

    @property
    def _backend_base(self) -> str:
        if self.backend_base_url:
            return self.backend_base_url.rstrip("/")
        host = "backend_rt" if self.app_stage == "prod" else "localhost"
        return f"http://{host}:{self.backend_port}"

    @property
    def backend_url(self) -> str:
        return f"{self._backend_base}/classify"

    @property
    def backend_checker(self) -> str:
        return f"{self._backend_base}/video_labels"


@_frozen()
class CaptionConfig:
    """S2VT captioning knobs (``s2vt/beam_search.py``, ``main_configurable.py``)."""

    # s2vt (v2 GRU+Luong, beam_search.py:229-382) | transformer |
    # v1_lstm | v1_gru (the stepwise v1 decoders, main_configurable.py:192-313)
    model_kind: str = "s2vt"
    cnn_backbone: str = "resnet50"
    cnn_output_size: int = 512
    hidden_size: int = 512
    # GRU depth for the s2vt encoder AND decoder (they must match — the
    # encoder's per-layer final hiddens seed the decoder's stack). 1 = the
    # v2 model (beam_search.py:235 nn.GRU default), 4 = the 1s2vt variant
    # (1s2vt_models.py:233,301 num_layers=4, last-layer attention query).
    encoder_layers: int = 1
    num_frames: int = 30
    max_caption_len: int = 30
    freq_threshold: int = 1
    beam_width: int = 3
    dropout: float = 0.1
    learning_rate: float = 1e-4
    epochs: int = 10
    grad_clip: float = 5.0
    checkpoint_dir: str = "/tmp/vct_caption"
    # Engine-discipline knobs (mirror TrainConfig): per-step sync logging
    # every N steps (0 = one device fetch per epoch), per-run history JSON.
    log_every: int = 0
    history_path: str = ""
    # Frozen-backbone feature caching (mirrors train.feature_cache): the
    # caption pipeline is ~98.5% CNN (docs/performance.md) and the backbone
    # is frozen, so its features are extracted once and fc/encoder/decoder
    # train from the cached block — identical loss trajectory.
    feature_cache: bool = False


@_frozen()
class Config:
    """Root config tree."""

    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    sweep: SweepConfig = field(default_factory=SweepConfig)
    serve: ServeConfig = field(default_factory=ServeConfig)
    caption: CaptionConfig = field(default_factory=CaptionConfig)

    # ------------------------------------------------------------------
    def replace(self, **dotted: Any) -> "Config":
        """Return a new Config with dotted-path overrides applied.

        ``cfg.replace(**{"model.rnn_type": "lstm", "train.epochs": 3})``
        """
        return apply_overrides(self, dotted)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "Config":
        return _from_dict(cls, d)

    def artifact_name(self, prefix: str = "model") -> str:
        """Config-encoded artifact filename, keeping the reference's
        convention of best-model files named by their hyperparameters
        (``runner.py:69-75``)."""
        m, t, d = self.model, self.train, self.data
        # Field fragments match the reference's best_model_filename exactly
        # (rnn{input}, rnnType{..}, method{..}, epochs{..}) so reference-era
        # globs and cross-referencing keep working.
        return (
            f"{prefix}_seq{d.sequence_length}_batch{t.batch_size}"
            f"_hidden{m.resolved_hidden_size}_cnn{m.cnn_backbone}"
            f"_rnn{m.rnn_input_size}_layer{m.rnn_layer}_rnnType{m.rnn_type}"
            f"_method{d.sampling_method}_out{m.rnn_out}_max{d.max_videos}"
            f"_epochs{t.epochs}_classifmode{m.classif_mode}"
        )


# ----------------------------------------------------------------------
# (de)serialisation helpers


def _from_dict(cls, d):
    if not is_dataclass(cls):
        return d
    kwargs = {}
    field_map = {f.name: f for f in fields(cls)}
    for key, val in d.items():
        if key not in field_map:
            raise KeyError(f"Unknown config field {cls.__name__}.{key}")
        f = field_map[key]
        sub = _DATACLASS_FIELDS.get((cls.__name__, key))
        if sub is not None and isinstance(val, dict):
            kwargs[key] = _from_dict(sub, val)
        else:
            kwargs[key] = val
    return cls(**kwargs)


_DATACLASS_FIELDS = {
    ("Config", "data"): DataConfig,
    ("Config", "model"): ModelConfig,
    ("Config", "train"): TrainConfig,
    ("Config", "mesh"): MeshConfig,
    ("Config", "sweep"): SweepConfig,
    ("Config", "serve"): ServeConfig,
    ("Config", "caption"): CaptionConfig,
}


def _coerce(value: str, current: Any) -> Any:
    """Coerce a CLI string override to the type of the current value."""
    if not isinstance(value, str):
        return value
    if current is None:
        try:
            return json.loads(value)
        except (ValueError, TypeError):
            return value
    if isinstance(current, bool):
        return value.lower() in ("1", "true", "yes", "on")
    if isinstance(current, int):
        return int(value)
    if isinstance(current, float):
        return float(value)
    return value


def apply_overrides(cfg: Config, overrides: dict) -> Config:
    """Apply {'model.rnn_type': 'lstm', ...} dotted overrides immutably."""
    grouped: dict = {}
    for path, value in overrides.items():
        parts = path.split(".")
        if len(parts) == 1:
            raise KeyError(
                f"Override '{path}' must be dotted, e.g. 'model.rnn_type'"
            )
        grouped.setdefault(parts[0], {})[".".join(parts[1:])] = value

    updates = {}
    for section, subover in grouped.items():
        node = getattr(cfg, section)
        sub_updates = {}
        for path, value in subover.items():
            if "." in path:
                raise KeyError(f"Config nesting deeper than 2 not supported: {path}")
            if not hasattr(node, path):
                raise KeyError(
                    f"Unknown config field {section}.{path}. "
                    f"Available: {[f.name for f in fields(node)]}"
                )
            current = getattr(node, path)
            sub_updates[path] = _coerce(value, current)
        updates[section] = dataclasses.replace(node, **sub_updates)
    return dataclasses.replace(cfg, **updates)


def load_config(path: Optional[str] = None, overrides: Optional[dict] = None) -> Config:
    """Load a Config from a YAML/JSON file plus dotted overrides."""
    cfg = Config()
    if path:
        with open(path) as f:
            if path.endswith((".yaml", ".yml")):
                import yaml

                d = yaml.safe_load(f)
            else:
                d = json.load(f)
        cfg = Config.from_dict(_merge_into(cfg.to_dict(), d or {}))
    if overrides:
        cfg = apply_overrides(cfg, overrides)
    return cfg


def _merge_into(base: dict, upd: dict) -> dict:
    out = dict(base)
    for k, v in upd.items():
        if isinstance(v, dict) and isinstance(base.get(k), dict):
            out[k] = _merge_into(base[k], v)
        else:
            out[k] = v
    return out


def parse_cli_overrides(argv) -> dict:
    """Parse ``--model.rnn_type lstm`` / ``--train.epochs=3`` style args."""
    overrides = {}
    i = 0
    while i < len(argv):
        arg = argv[i]
        if not arg.startswith("--"):
            raise ValueError(f"Unexpected argument: {arg}")
        body = arg[2:]
        if "=" in body:
            key, value = body.split("=", 1)
            i += 1
        else:
            key = body
            if i + 1 >= len(argv):
                raise ValueError(f"Missing value for --{key}")
            value = argv[i + 1]
            i += 2
        overrides[key] = value
    return overrides
