"""What the vct_torch captioning tests share: the small captioner
configurations (resnet18 on 32x32 frames, T=3, max_len 6, width 16, as
tests/test_caption.py sizes vct's), seeded inputs, and one set of random
weights carried from a vct variables tree into the port by the bridge."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from vct.caption import train as vct_train
from vct.caption.data import encode_caption as vct_encode_caption
from vct.caption.vocab import Vocabulary as VctVocabulary
from vct.core.config import CaptionConfig as VctCaptionConfig
from vct_torch.bridge import load_vct_variables
from vct_torch.caption import train as port_train
from vct_torch.core.config import CaptionConfig

SENTENCES = ["a man is cooking", "a dog runs fast", "a man runs", "a dog runs"]
B, T, HW, MAX_LEN = 4, 3, 32, 6
SMALL = dict(cnn_backbone="resnet18", cnn_output_size=16, hidden_size=16, num_frames=T,
             max_caption_len=MAX_LEN, beam_width=3, dropout=0.0)
# The five captioners: S2VT v2, 1s2vt, the transformer (8 heads, 2
# layers), the v1 LSTM and GRU (3 decoder layers, 8 heads).
KINDS = {
    "s2vt": dict(model_kind="s2vt"),
    "1s2vt": dict(model_kind="s2vt", encoder_layers=4),
    "transformer": dict(model_kind="transformer"),
    "v1_lstm": dict(model_kind="v1_lstm"),
    "v1_gru": dict(model_kind="v1_gru"),
}
# The v1 decoder reaches the loss only through its cross-attention's query:
# under near-uniform attention over nearly equal frames its gradient sits
# at the f32 floor, so the v1 captioners' query and key kernels are drawn 8x
# wider (sharper attention), which lifts it to about 2e-4 of the largest.
ATTENTION_GAIN = {"v1_lstm": 8.0, "v1_gru": 8.0}


def vocab():
    v = VctVocabulary(freq_threshold=1)
    v.build_vocabulary(SENTENCES)
    return v


def configs(kind: str, **extra):
    """(vct's CaptionConfig, the port's) for ``kind``."""
    kw = {**SMALL, **KINDS[kind], **extra}
    return VctCaptionConfig(**kw), CaptionConfig(**kw)


def inputs(seed: int = 0, n: int = B):
    """Seeded f32 clips (n, T, 32, 32, 3) and encoded captions (n, MAX_LEN)."""
    rng = np.random.RandomState(seed)
    # Frames of 8x8 blocks of signed values, each frame its own: frames of
    # uniform noise give nearly equal pooled features, and attention over
    # nearly equal keys leaves its query a gradient at the f32 noise floor.
    blocks = 2.0 * rng.randn(n, T, HW // 8, HW // 8, 3)
    videos = np.repeat(np.repeat(blocks, 8, axis=2), 8, axis=3).astype(np.float32)
    v = vocab()
    captions = np.stack([vct_encode_caption(SENTENCES[i % len(SENTENCES)], v, MAX_LEN)
                         for i in range(n)])
    return videos, captions


def random_variables(model, videos, captions, seed: int = 0, attention_gain: float = 1.0):
    """A numpy variables tree for the vct captioner ``model`` from a seed,
    shaped by ``jax.eval_shape`` of its init: kernels N(0, 1/fan_in) (so
    activations keep their scale through the backbone; the attention's
    query and key kernels ``attention_gain`` times that),
    scales near 1, BatchNorm variances in [1, 1.5), embeddings N(0, 1),
    other leaves N(0, 0.1)."""
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.asarray(videos[:1]),
                            jnp.asarray(captions[:1]))
    rng = np.random.RandomState(seed)

    def make(path, leaf):
        name, shape = getattr(path[-1], "key", ""), leaf.shape
        if name == "var":
            v = 1.0 + 0.5 * rng.rand(*shape)
        elif name == "scale":
            v = 1.0 + 0.1 * rng.randn(*shape)
        elif name == "embedding":
            v = rng.randn(*shape)
        elif len(shape) >= 2:
            # fan-in: every axis but the output's, except that the attention's
            # query/key/value kernels (in, heads, head_dim) take only ``in``.
            parent = getattr(path[-2], "key", "") if len(path) > 1 else ""
            fan_in = shape[0] if parent in ("query", "key", "value") else np.prod(shape[:-1])
            gain = attention_gain if parent in ("query", "key") else 1.0
            v = gain * rng.randn(*shape) / np.sqrt(fan_in)
        else:
            v = 0.1 * rng.randn(*shape)
        return np.asarray(v, np.float32)

    return jax.tree_util.tree_map_with_path(make, shapes)


def vct_state(trainer, variables):
    """vct's CaptionState over ``variables`` for ``trainer`` (no Flax init)."""
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    return vct_train.CaptionState(
        step=jnp.zeros((), jnp.int32), params=params,
        extra_vars={k: jax.tree_util.tree_map(jnp.asarray, v) for k, v in variables.items()
                    if k != "params"},
        opt_state=trainer._tx.init(params), rng=jax.random.PRNGKey(0))


def write_video(path, frames: int, rng, size: int, fourcc: str = "mp4v"):
    """``frames`` seeded noise frames of size x size written by this host's
    cv2 (mp4v .mp4 as tests/test_caption_stream.py writes them, or MJPG
    .avi)."""
    import cv2

    w = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*fourcc), 10.0, (size, size))
    for _ in range(frames):
        w.write(rng.randint(0, 256, (size, size, 3), np.uint8))
    w.release()


def pair(kind: str, seed: int = 0, **extra):
    """(vct model, its variables, the port's model holding the same weights
    on the CPU, the port's config) for ``kind``."""
    cfg_v, cfg_t = configs(kind, **extra)
    v = vocab()
    videos, captions = inputs()
    vct_model = vct_train.build_captioner(cfg_v, len(v))
    variables = random_variables(vct_model, videos, captions, seed,
                                 ATTENTION_GAIN.get(kind, 1.0))
    model = port_train.build_captioner(cfg_t, len(v), device="cpu")
    load_vct_variables(model, variables)
    return vct_model, variables, model, cfg_t
