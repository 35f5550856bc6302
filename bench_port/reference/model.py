"""The LRCN classifier, written from its semantics.

Input: decoded uint8 videos (B, L, H, W, 3), each padded to the bucket L
with its own last frame, and each video's true frame count. Then:

1. SAD frame selection: the score of transition t is the sum of absolute
   byte differences of frames t and t + 1; transitions at or past a video's
   end score lowest; the T highest scores win, ties to the earlier
   transition; each winner keeps its earlier frame; the frames in time
   order. A video of T frames or fewer repeats its frames cyclically.
2. Frames as float32 in [0, 1] (x / 255).
3. The ResNet backbone over every frame (NCHW; batch norm at its running
   statistics), its global average pool as the frame's features.
4. The adapter: three times linear, exact GELU, layer norm (eps 1e-5), F to
   F/2 to F/4 to the head's input width.
5. The temporal head: Mamba residual blocks (RMS norm, input projection, a
   causal depthwise convolution of width 3, SiLU, the (dt, B, C)
   projection, softplus, the diagonal selective scan, the SiLU gate, the
   output projection), or a stack of LSTM / GRU layers in torch's gate
   orders with weights laid out (in, gates x H).
6. All steps flattened (``rnn_out`` "all") or the last step, then layer
   norm, two linear-GELU-layer-norm stages and the classifier; dropout is
   inert.

Parameter names follow the state_dict that the benchmark hands to the
program, so one weight list serves both.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .precision import check_stated, head_context, operands

__all__ = ["RESNETS", "PROBE_UNIT", "param_spec", "sad_indices",
           "frames_f32", "backbone", "head", "probe_features", "logits"]

LN_EPS = 1e-5
BN_EPS = 1e-5
RMS_EPS = 1e-5

# name -> (block kind, blocks a stage)
RESNETS = {
    "resnet18": ("basic", (2, 2, 2, 2)),
    "resnet34": ("basic", (3, 4, 6, 3)),
    "resnet50": ("bottleneck", (3, 4, 6, 3)),
    "resnet101": ("bottleneck", (3, 4, 23, 3)),
    "resnet152": ("bottleneck", (3, 8, 36, 3)),
}


def _check(m: dict) -> None:
    wants = {"model_family": "lrcn", "bidirectional": False, "classif_mode": "multiclass",
             "use_adapt_dsl": False}
    for key, value in wants.items():
        if m.get(key, value) != value:
            raise ValueError(f"the reference has no {key}={m[key]!r}")
    if m["cnn_backbone"] not in RESNETS:
        raise ValueError(f"the reference has no backbone {m['cnn_backbone']!r}")
    if m["rnn_type"] not in ("mamba", "lstm", "gru"):
        raise ValueError(f"the reference has no rnn_type {m['rnn_type']!r}")
    if m.get("rnn_out", "all") not in ("all", "last"):
        raise ValueError(f"the reference has no rnn_out {m['rnn_out']!r}")


def _hidden(m: dict) -> int:
    h = m.get("hidden_size")
    return int(h) if h is not None else int(m.get("mult_factor", 4)) * int(m["rnn_input_size"])


def _blocks(name: str):
    """(block name, input channels, width, stride, downsample, kind) of each block."""
    kind, sizes = RESNETS[name]
    expansion = 4 if kind == "bottleneck" else 1
    cin = 64
    for stage, (width, n) in enumerate(zip((64, 128, 256, 512), sizes)):
        for i in range(n):
            stride = 2 if stage > 0 and i == 0 else 1
            down = stride != 1 or cin != width * expansion
            yield f"layer{stage + 1}_{i}", cin, width, stride, down, kind
            cin = width * expansion


def _feature_dim(name: str) -> int:
    return 512 * (4 if RESNETS[name][0] == "bottleneck" else 1)


def param_spec(cfg: dict) -> list:
    """Every tensor of the model: (name, shape, draw, argument). Draws:
    "fan" normal / sqrt(argument); "small" 0.1 normal; "unit" 1 + 0.1
    normal; "var" uniform in [0.75, 1.25]; "normal" standard normal;
    "uniform" uniform in [-argument, argument]; "zero_long" an int64 0."""
    m = cfg["model"]
    _check(m)
    spec = []

    def conv(name, cout, cin, k):
        spec.append((f"{name}.weight", (cout, cin, k, k), "fan", cin * k * k))

    def bn(name, c):
        spec.extend([(f"{name}.weight", (c,), "unit", None), (f"{name}.bias", (c,), "small", None),
                     (f"{name}.running_mean", (c,), "small", None),
                     (f"{name}.running_var", (c,), "var", None),
                     (f"{name}.num_batches_tracked", (), "zero_long", None)])

    def linear(name, out, inp, bias=True):
        spec.append((f"{name}.weight", (out, inp), "fan", inp))
        if bias:
            spec.append((f"{name}.bias", (out,), "small", None))

    def norm(name, c, bias=True):
        spec.append((f"{name}.weight", (c,), "unit", None))
        if bias:
            spec.append((f"{name}.bias", (c,), "small", None))

    bb = "cnn_backbone"
    conv(f"{bb}.conv1", 64, 3, 7)
    bn(f"{bb}.bn1", 64)
    for blk, cin, w, _, down, kind in _blocks(m["cnn_backbone"]):
        p = f"{bb}.{blk}"
        if kind == "bottleneck":
            conv(f"{p}.conv1", w, cin, 1)
            bn(f"{p}.bn1", w)
            conv(f"{p}.conv2", w, w, 3)
            bn(f"{p}.bn2", w)
            conv(f"{p}.conv3", 4 * w, w, 1)
            bn(f"{p}.bn3", 4 * w)
            out = 4 * w
        else:
            conv(f"{p}.conv1", w, cin, 3)
            bn(f"{p}.bn1", w)
            conv(f"{p}.conv2", w, w, 3)
            bn(f"{p}.bn2", w)
            out = w
        if down:
            conv(f"{p}.downsample_conv", out, cin, 1)
            bn(f"{p}.downsample_bn", out)
    f = _feature_dim(m["cnn_backbone"])
    d = int(m["rnn_input_size"])
    for i, (a, b) in enumerate(((f, f // 2), (f // 2, f // 4), (f // 4, d)), start=1):
        linear(f"adapt.adapt{i}", b, a)
        norm(f"adapt.bn{i}", b)
    h = _hidden(m)
    layers = int(m["rnn_layer"])
    if m["rnn_type"] == "mamba":
        di = 2 * d
        for i in range(layers):
            p = f"mamba_{i}"
            spec.append((f"{p}.mixer.A_log", (di, h), "normal", None))
            spec.append((f"{p}.mixer.D", (di,), "normal", None))
            linear(f"{p}.mixer.in_proj", 2 * di, d)
            spec.append((f"{p}.mixer.conv.weight", (di, 1, 3), "fan", 3))
            spec.append((f"{p}.mixer.conv.bias", (di,), "small", None))
            linear(f"{p}.mixer.x_proj", h + 2 * h, di, bias=False)
            linear(f"{p}.mixer.dt_proj", di, h)
            linear(f"{p}.mixer.out_proj", d, di)
            norm(f"{p}.norm", d, bias=False)
        width = d
    else:
        gates = 4 if m["rnn_type"] == "lstm" else 3
        k = h ** -0.5
        for layer in range(layers):
            inp = d if layer == 0 else h
            p = f"rnn.{m['rnn_type']}"
            spec.extend([(f"{p}.weight_ih_l{layer}", (inp, gates * h), "uniform", k),
                         (f"{p}.weight_hh_l{layer}", (h, gates * h), "uniform", k),
                         (f"{p}.bias_ih_l{layer}", (gates * h,), "uniform", k),
                         (f"{p}.bias_hh_l{layer}", (gates * h,), "uniform", k)])
        width = h
    pooled = width * (int(cfg["sequence_length"]) if m.get("rnn_out", "all") == "all" else 1)
    norm("head.bn0", pooled)
    linear("head.fc", pooled // 2, pooled)
    norm("head.bna", pooled // 2)
    linear("head.fca", pooled // 4, pooled // 2)
    norm("head.bnb", pooled // 4)
    linear("head.fcb", int(m["num_classes"]), pooled // 4)
    return spec


# --- 1, 2: selection and the frames -----------------------------------------

def sad_indices(raw: torch.Tensor, lengths, T: int) -> np.ndarray:
    """(B, T) int64 frame indices of SAD selection; scores summed exactly
    in int64 on ``raw``'s device, ranked on the host."""
    B, L = raw.shape[:2]
    lengths = np.asarray(lengths, np.int64)
    idx = np.empty((B, T), np.int64)
    if L > 1:
        flat = raw.reshape(B, L, -1)
        scores = torch.stack([(flat[:, t + 1].to(torch.int32) - flat[:, t].to(torch.int32))
                              .abs().sum(dim=-1, dtype=torch.int64) for t in range(L - 1)], dim=1)
        scores = scores.cpu().numpy()
    for b in range(B):
        n = int(lengths[b])
        if n <= T or L <= T:
            idx[b] = np.arange(T) % max(n, 1)
            continue
        s = scores[b].copy()
        s[n - 1:] = -1  # transitions into the padding
        order = np.lexsort((np.arange(L - 1), -s))  # highest first, earlier on ties
        idx[b] = np.sort(order[:T])
    return idx


def frames_f32(raw: torch.Tensor, idx: np.ndarray) -> torch.Tensor:
    """The selected frames of each video as float32 in [0, 1]."""
    rows = torch.arange(raw.shape[0], device=raw.device)[:, None]
    return raw[rows, torch.as_tensor(idx, device=raw.device)].to(torch.float32) / 255.0


# --- 3: the backbone ---------------------------------------------------------

def _bn(w, name, x):
    scale = w[f"{name}.weight"] * torch.rsqrt(w[f"{name}.running_var"] + BN_EPS)
    shift = w[f"{name}.bias"] - w[f"{name}.running_mean"] * scale
    return x * scale[:, None, None] + shift[:, None, None]


def _conv(w, name, x, stride, pad, kind):
    xi, wi = operands(x, w[f"{name}.weight"], kind)
    return F.conv2d(xi, wi, stride=stride, padding=pad)


def backbone(w: dict, frames: torch.Tensor, cfg: dict, kind: str = "float32") -> torch.Tensor:
    """(N, H, W, 3) float32 frames -> (N, F) float32 features; ``kind``
    "tf32" rounds every convolution's operands to TF32."""
    check_stated(cfg)
    m = cfg["model"]
    bb = "cnn_backbone"

    def conv_bn(name, bn_name, x, stride, pad):
        return _bn(w, f"{bb}.{bn_name}", _conv(w, f"{bb}.{name}", x, stride, pad, kind))

    def add_relu(a, b):
        return torch.relu(a + b)

    x = frames.permute(0, 3, 1, 2).contiguous()
    x = torch.relu(conv_bn("conv1", "bn1", x, 2, 3))
    x = F.max_pool2d(x, 3, stride=2, padding=1)
    for blk, _, _, stride, down, kind in _blocks(m["cnn_backbone"]):
        identity = x
        if kind == "bottleneck":
            out = torch.relu(conv_bn(f"{blk}.conv1", f"{blk}.bn1", x, 1, 0))
            out = torch.relu(conv_bn(f"{blk}.conv2", f"{blk}.bn2", out, stride, 1))
            out = conv_bn(f"{blk}.conv3", f"{blk}.bn3", out, 1, 0)
        else:
            out = torch.relu(conv_bn(f"{blk}.conv1", f"{blk}.bn1", x, stride, 1))
            out = conv_bn(f"{blk}.conv2", f"{blk}.bn2", out, 1, 1)
        if down:
            identity = conv_bn(f"{blk}.downsample_conv", f"{blk}.downsample_bn", x, stride, 0)
        x = add_relu(out, identity)
    return x.mean(dim=(2, 3))


# --- 4-6: the head -----------------------------------------------------------

def _linear(w, name, x, kind):
    xi, wi = operands(x, w[f"{name}.weight"], kind)
    return F.linear(xi, wi, w.get(f"{name}.bias"))


def _ln(w, name, x):
    return F.layer_norm(x, x.shape[-1:], w[f"{name}.weight"], w[f"{name}.bias"], LN_EPS)


def _rms(w, name, x):
    return x * torch.rsqrt(x.float().square().mean(-1, keepdim=True) + RMS_EPS).to(x.dtype) \
        * w[f"{name}.weight"]


def _mamba(w, p, x, n_state, kind):
    di = w[f"{p}.mixer.D"].shape[0]
    u, res = _linear(w, f"{p}.mixer.in_proj", x, kind).split([di, di], dim=-1)
    L = u.shape[1]
    kernel = w[f"{p}.mixer.conv.weight"]
    k = kernel.shape[-1]
    u = F.silu(F.conv1d(u.transpose(1, 2), kernel, w[f"{p}.mixer.conv.bias"], padding=k - 1,
                        groups=di)[..., :L].transpose(1, 2))
    rank = w[f"{p}.mixer.dt_proj.weight"].shape[1]
    dt, Bm, Cm = _linear(w, f"{p}.mixer.x_proj", u, kind).split([rank, n_state, n_state],
                                                                dim=-1)
    delta = F.softplus(_linear(w, f"{p}.mixer.dt_proj", dt, kind)).float()
    A = -torch.exp(w[f"{p}.mixer.A_log"].float())
    u, Bm, Cm = u.float(), Bm.float(), Cm.float()
    h = torch.zeros(u.shape[0], di, n_state, device=u.device)
    ys = []
    for t in range(L):
        h = torch.exp(delta[:, t, :, None] * A) * h \
            + (delta[:, t] * u[:, t])[:, :, None] * Bm[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, Cm[:, t]))
    y = torch.stack(ys, dim=1)
    return _linear(w, f"{p}.mixer.out_proj", y * F.silu(res), kind)


def _matmul(x, weight, kind):
    xi, wi = operands(x, weight, kind)
    return xi @ wi


def _recurrent(w, prefix, x, layers, hidden, cell, kind):
    for layer in range(layers):
        xp = _matmul(x, w[f"{prefix}.weight_ih_l{layer}"], kind) + w[f"{prefix}.bias_ih_l{layer}"]
        w_hh, b_hh = w[f"{prefix}.weight_hh_l{layer}"], w[f"{prefix}.bias_hh_l{layer}"]
        h = torch.zeros(x.shape[0], hidden, device=x.device, dtype=xp.dtype)
        c = torch.zeros_like(h)
        outs = []
        for t in range(x.shape[1]):
            gh = _matmul(h, w_hh, kind) + b_hh
            if cell == "lstm":
                i, f, g, o = (xp[:, t] + gh).split(hidden, dim=-1)
                c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
                h = torch.sigmoid(o) * torch.tanh(c)
            else:
                xr, xz, xn = xp[:, t].split(hidden, dim=-1)
                hr, hz, hn = gh.split(hidden, dim=-1)
                r, z = torch.sigmoid(xr + hr), torch.sigmoid(xz + hz)
                n = torch.tanh(xn + r * hn)
                h = (1 - z) * n + z * h
            outs.append(h)
        x = torch.stack(outs, dim=1)
    return x


def head(w: dict, feats: torch.Tensor, cfg: dict, kind: str = "float32") -> torch.Tensor:
    """(B, T, F) float32 features -> (B, num_classes) float32 logits;
    ``kind`` "tf32" rounds every product's operands to TF32, "bfloat16"
    computes under bfloat16 autocast."""
    m = cfg["model"]
    with head_context(feats.device, kind):
        x = feats
        for i in (1, 2, 3):
            x = _ln(w, f"adapt.bn{i}", F.gelu(_linear(w, f"adapt.adapt{i}", x, kind)))
        if m["rnn_type"] == "mamba":
            for i in range(int(m["rnn_layer"])):
                x = x + _mamba(w, f"mamba_{i}", _rms(w, f"mamba_{i}.norm", x), _hidden(m), kind)
        else:
            x = _recurrent(w, f"rnn.{m['rnn_type']}", x, int(m["rnn_layer"]), _hidden(m),
                           m["rnn_type"], kind)
        x = x.reshape(x.shape[0], -1) if m.get("rnn_out", "all") == "all" else x[:, -1]
        x = _ln(w, "head.bn0", x)
        x = _ln(w, "head.bna", F.gelu(_linear(w, "head.fc", x, kind)))
        x = _ln(w, "head.bnb", F.gelu(_linear(w, "head.fca", x, kind)))
        return _linear(w, "head.fcb", x, kind).float()


# TF32's unit roundoff (10 stored bits of significand): the probe's step,
# the rounding of the precision one step below the stated float32.
PROBE_UNIT = 2.0 ** -11


def probe_features(feats: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """The features, each moved by one TF32 unit of its own size, up or down
    at random. Where the answers move by that, a head amplifies a rounding
    of its inputs by that much."""
    signs = torch.randint(0, 2, feats.shape, generator=gen, device=feats.device) * 2 - 1
    return feats * (1 + PROBE_UNIT * signs)


def logits(w: dict, frames: torch.Tensor, cfg: dict, kind: str = "float32",
           head_kind: str | None = None) -> torch.Tensor:
    """(B, T, H, W, 3) float32 clips -> (B, num_classes) float32 logits: the
    backbone in ``kind``, the head in ``head_kind`` (``kind`` where None)."""
    B, T = frames.shape[:2]
    feats = backbone(w, frames.reshape((B * T,) + tuple(frames.shape[2:])), cfg, kind)
    return head(w, feats.reshape(B, T, -1), cfg, head_kind or kind)
