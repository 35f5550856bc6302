"""vct_torch's LSTM/GRU kernels' plain versions, modules and LRCN heads
against vct, on the CPU.

The vct side runs its Pallas kernels in interpret mode (as
tests/test_pallas_ops.py does) and its lax.scan references; the port's
wrappers run their plain PyTorch versions on CPU tensors.
tests/test_torch_cuda.py holds the CUDA kernels against those plain
versions on the card. Module weights are initialised in Flax, moved off
their init values from a numpy seed, and carried into the port by
``vct_torch.bridge.load_vct_variables``.

Tolerances: the ops atol = rtol = 1e-5 (f32, summation order); the
modules and LRCN logits atol = rtol = 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vct.core import config as vct_config
from vct.models import build_model as vct_build_model
from vct.models import recurrent as vct_recurrent
from vct.ops import lstm_pallas as vct_lstm
from vct_torch.bridge import load_vct_variables
from vct_torch.core import config
from vct_torch.models import build_model, recurrent
from vct_torch.ops import lstm as ops

OPS_TOL = dict(atol=1e-5, rtol=1e-5)
TOL = dict(atol=1e-4, rtol=1e-4)
GATES = {"lstm": 4, "gru": 3}


def _perturb(variables, seed=0):
    """numpy copy of a Flax tree with every leaf moved off its init value."""
    rng = np.random.RandomState(seed)

    def move(path, leaf):
        leaf = np.asarray(leaf, np.float32)
        if getattr(path[-1], "key", None) == "var":
            return (1.0 + 0.5 * rng.rand(*leaf.shape)).astype(np.float32)
        scale = 0.1 * (float(leaf.std()) or 1.0)
        return (leaf + scale * rng.randn(*leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(move, jax.tree_util.tree_map(np.asarray, variables))


def _layer_args(cell, B, T, H, seed=0):
    rng = np.random.RandomState(seed)
    G = GATES[cell]
    return (
        rng.randn(B, T, G * H).astype(np.float32),
        (rng.randn(H, G * H) * 0.3).astype(np.float32),
        (rng.randn(G * H) * 0.1).astype(np.float32),
    )


def _stack_args(cell, B, T, H, L, seed=0):
    rng = np.random.RandomState(seed)
    G = GATES[cell]
    return (
        rng.randn(B, T, G * H).astype(np.float32),
        (rng.randn(L, H, G * H) * 0.3).astype(np.float32),
        (rng.randn(L, G * H) * 0.1).astype(np.float32),
        (rng.randn(L - 1, H, G * H) * 0.3).astype(np.float32),
        (rng.randn(L - 1, G * H) * 0.1).astype(np.float32),
    )


@pytest.mark.parametrize("dims", [(2, 7, 6), (3, 1, 5), (1, 9, 13)], ids=["small", "T1", "oddH"])
@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_scan_ref_matches_vct(cell, dims):
    args = _layer_args(cell, *dims)
    kernel = {"lstm": vct_lstm.lstm_scan_pallas, "gru": vct_lstm.gru_scan_pallas}[cell]
    vct_ref = {"lstm": vct_lstm._lstm_ref, "gru": vct_lstm._gru_ref}[cell]
    ref = {"lstm": ops.lstm_scan_ref, "gru": ops.gru_scan_ref}[cell]
    wrapper = {"lstm": ops.lstm_scan, "gru": ops.gru_scan}[cell]
    want = np.asarray(kernel(*map(jnp.asarray, args)))
    got = ref(*map(torch.from_numpy, args)).numpy()
    assert got.shape == want.shape == (dims[0], dims[1], dims[2])
    np.testing.assert_allclose(got, want, **OPS_TOL)
    np.testing.assert_allclose(got, np.asarray(vct_ref(*map(jnp.asarray, args))), **OPS_TOL)
    before = wrapper.launches
    np.testing.assert_array_equal(wrapper(*map(torch.from_numpy, args)).numpy(), got)
    assert wrapper.launches == before  # CPU tensors never reach the kernel


@pytest.mark.parametrize("dims", [(2, 9, 6, 3), (1, 1, 5, 2), (3, 4, 7, 4), (2, 6, 96, 2)],
                         ids=["small", "T1", "oddH_L4", "H96"])
@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_stack_ref_matches_vct(cell, dims):
    args = _stack_args(cell, *dims)
    kernel = {"lstm": vct_lstm.lstm_stack_pallas, "gru": vct_lstm.gru_stack_pallas}[cell]
    vct_ref = {"lstm": vct_lstm._lstm_stack_ref, "gru": vct_lstm._gru_stack_ref}[cell]
    wrapper = {"lstm": ops.lstm_stack, "gru": ops.gru_stack}[cell]
    want = np.asarray(kernel(*map(jnp.asarray, args)))
    got = ops.stack_ref(*map(torch.from_numpy, args)).numpy()
    assert got.shape == want.shape == dims[:3]
    np.testing.assert_allclose(got, want, **OPS_TOL)
    np.testing.assert_allclose(got, np.asarray(vct_ref(*map(jnp.asarray, args))), **OPS_TOL)
    before = wrapper.launches
    np.testing.assert_array_equal(wrapper(*map(torch.from_numpy, args)).numpy(), got)
    assert wrapper.launches == before


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_stack_needs_two_layers(cell):
    args = _stack_args(cell, 2, 3, 4, 2)
    one_layer = (args[0], args[1][:1], args[2][:1], args[3][:0], args[4][:0])
    with pytest.raises(ValueError, match="num_layers >= 2"):
        {"lstm": vct_lstm.lstm_stack_pallas, "gru": vct_lstm.gru_stack_pallas}[cell](
            *map(jnp.asarray, one_layer))
    wrapper = {"lstm": ops.lstm_stack, "gru": ops.gru_stack}[cell]
    for fn in (wrapper, ops.stack_ref):
        with pytest.raises(ValueError, match="num_layers >= 2"):
            fn(*map(torch.from_numpy, one_layer))


def test_wrappers_reject_bad_shapes():
    xp, w_hh, b_hh = map(torch.from_numpy, _layer_args("lstm", 2, 3, 4))
    with pytest.raises(ValueError):
        ops.lstm_scan(xp[..., :-1], w_hh, b_hh)
    with pytest.raises(ValueError):
        ops.gru_scan(xp, w_hh, b_hh)  # 4H columns are not a GRU's 3H
    with pytest.raises(ValueError):
        ops.lstm_scan(xp, w_hh, b_hh[:-1])
    stack = list(map(torch.from_numpy, _stack_args("gru", 2, 3, 4, 3)))
    with pytest.raises(ValueError, match="4H"):
        ops.lstm_stack(*stack)
    with pytest.raises(ValueError, match="w_ih"):
        ops.gru_stack(stack[0], stack[1], stack[2], stack[3][:1], stack[4])


def _module_pair(cls_name, in_size=5, **kw):
    flax_mod = getattr(vct_recurrent, cls_name)(hidden_size=6, **kw)
    torch_mod = getattr(recurrent, cls_name)(in_size, 6, **kw)
    return flax_mod, torch_mod


def _apply_pair(flax_mod, torch_mod, x, **apply_kw):
    variables = _perturb(flax_mod.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    want = flax_mod.apply(variables, jnp.asarray(x), **apply_kw)
    load_vct_variables(torch_mod, variables)
    with torch.no_grad():
        got = torch_mod.eval()(torch.from_numpy(x), **apply_kw)
    return got, want


def _x(*shape, seed=1):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("scan_impl", ["scan", "pallas"])
@pytest.mark.parametrize("bidirectional", [False, True], ids=["uni", "bidir"])
@pytest.mark.parametrize("num_layers", [1, 2, 3])
@pytest.mark.parametrize("cls_name", ["LSTM", "GRU"])
def test_rnn_module_matches_vct(cls_name, num_layers, bidirectional, scan_impl):
    flax_mod, torch_mod = _module_pair(cls_name, num_layers=num_layers,
                                       bidirectional=bidirectional, scan_impl=scan_impl)
    got, want = _apply_pair(flax_mod, torch_mod, _x(2, 7, 5))
    assert got.dtype == torch.float32
    assert got.shape == (2, 7, 12 if bidirectional else 6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("scan_impl", ["scan", "pallas"])
@pytest.mark.parametrize("num_layers", [1, 3])
@pytest.mark.parametrize("cls_name", ["LSTM", "GRU"])
def test_rnn_return_final_matches_vct(cls_name, num_layers, scan_impl):
    flax_mod, torch_mod = _module_pair(cls_name, num_layers=num_layers, scan_impl=scan_impl)
    (got, got_final), (want, want_final) = _apply_pair(
        flax_mod, torch_mod, _x(2, 7, 5), return_final=True)
    assert got_final.shape == (2, num_layers, 6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got_final.numpy(), np.asarray(want_final), **TOL)


@pytest.mark.parametrize("num_layers,bidirectional,return_final,stacks,scans", [
    (3, False, False, 1, 0),  # unidirectional stack: one K2 launch
    (1, False, False, 0, 1),  # one layer: K5
    (2, True, False, 0, 4),   # bidirectional: K5 per layer and direction
    (2, False, True, 0, 2),   # return_final: K5 per layer
])
def test_pallas_dispatch_follows_vct(monkeypatch, num_layers, bidirectional, return_final,
                                     stacks, scans):
    calls = {"stack": 0, "scan": 0}

    def spy(kind, fn):
        def wrapped(*args):
            calls[kind] += 1
            return fn(*args)
        return wrapped

    monkeypatch.setattr(recurrent.GRU, "_stack", spy("stack", ops.gru_stack))
    monkeypatch.setitem(recurrent.GRU._scan, "pallas", spy("scan", ops.gru_scan))
    _, torch_mod = _module_pair("GRU", num_layers=num_layers, bidirectional=bidirectional,
                                scan_impl="pallas")
    with torch.no_grad():
        torch_mod(torch.zeros(1, 3, 5), return_final=return_final)
    assert calls == {"stack": stacks, "scan": scans}


def test_return_final_refuses_bidirectional():
    _, torch_mod = _module_pair("GRU", bidirectional=True)
    with pytest.raises(ValueError, match="unidirectional"):
        torch_mod(torch.zeros(1, 2, 5), return_final=True)


@pytest.mark.parametrize("rnn_type", ["lstm", "gru"])
def test_rnn_stack_matches_vct(rnn_type):
    kw = dict(rnn_type=rnn_type, num_layers=2, scan_impl="pallas")
    flax_mod = vct_recurrent.RNNStack(hidden_size=6, **kw)
    torch_mod = recurrent.RNNStack(input_size=5, hidden_size=6, **kw)
    got, want = _apply_pair(flax_mod, torch_mod, _x(3, 4, 5))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _lrcn_pair(seq_len=4, **overrides):
    kw = dict(num_classes=4, cnn_backbone="resnet18", rnn_input_size=8, hidden_size=6,
              rnn_layer=2, scan_impl="pallas")
    kw.update(overrides)
    return (vct_build_model(vct_config.ModelConfig(**kw), seq_len),
            build_model(config.ModelConfig(**kw), seq_len, device="cpu"))


@pytest.mark.parametrize("bidirectional", [False, True], ids=["uni", "bidir"])
@pytest.mark.parametrize("rnn_out", ["all", "last"])
@pytest.mark.parametrize("rnn_type", ["lstm", "gru"])
def test_lrcn_recurrent_logits_match_vct(rnn_type, rnn_out, bidirectional):
    flax_model, torch_model = _lrcn_pair(rnn_type=rnn_type, rnn_out=rnn_out,
                                         bidirectional=bidirectional)
    x = np.random.RandomState(0).rand(2, 4, 32, 32, 3).astype(np.float32)
    got, want = _apply_pair(flax_model, torch_model, x)
    assert got.shape == (2, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_lrcn_scan_impl_maps_like_vct():
    _, torch_model = _lrcn_pair(rnn_type="gru", scan_impl="associative")
    assert torch_model.rnn.gru.scan_impl == "scan"
    _, torch_model = _lrcn_pair(rnn_type="gru", scan_impl="pallas")
    assert torch_model.rnn.gru.scan_impl == "pallas"


def test_recurrent_weights_are_seeded_uniform():
    cfg = config.ModelConfig(cnn_backbone="resnet18", rnn_type="lstm", rnn_input_size=8,
                             hidden_size=16, rnn_layer=2, bidirectional=True)
    a = build_model(cfg, 4, device="cpu", seed=3).state_dict()
    b = build_model(cfg, 4, device="cpu", seed=3).state_dict()
    c = build_model(cfg, 4, device="cpu", seed=4).state_dict()
    rnn = [k for k in a if k.startswith("rnn.lstm.")]
    assert len(rnn) == 2 * 2 * 4  # layers x directions x (W_ih, W_hh, b_ih, b_hh)
    assert a["rnn.lstm.weight_ih_l1_reverse"].shape == (32, 64)
    for k in rnn:
        assert torch.equal(a[k], b[k]) and not torch.equal(a[k], c[k])
        assert a[k].abs().max() <= 16 ** -0.5 and a[k].std() > 0.1


def test_recurrent_model_refuses_cpu_fallback(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(config.ModelConfig(cnn_backbone="resnet18", rnn_type="gru"), 4)


def test_bridge_is_strict_on_recurrent_leaves():
    flax_mod, torch_mod = _module_pair("LSTM", num_layers=2)
    variables = _perturb(flax_mod.init(jax.random.PRNGKey(0), jnp.zeros((1, 3, 5))))
    del variables["params"]["bias_hh_l1"]
    with pytest.raises(KeyError, match="bias_hh_l1"):
        load_vct_variables(torch_mod, variables)


@pytest.mark.parametrize("dims", [(2, 7, 6), (1, 9, 13)], ids=["small", "oddH"])
@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_scan_gradients_match_vct(cell, dims):
    """Autograd through K5's op (the plain version on the CPU) against
    jax.vjp of vct's (interpret-mode kernel under its custom_vjp), and
    ``*_scan_bwd`` the same; atol = rtol = 1e-5."""
    args = _layer_args(cell, *dims)
    gy = np.random.RandomState(5).randn(*dims).astype(np.float32)
    kernel = {"lstm": vct_lstm.lstm_scan_pallas, "gru": vct_lstm.gru_scan_pallas}[cell]
    _, vjp = jax.vjp(kernel, *map(jnp.asarray, args))
    want = vjp(jnp.asarray(gy))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in args]
    wrapper = {"lstm": ops.lstm_scan, "gru": ops.gru_scan}[cell]
    y = wrapper(*leaves)
    got = torch.autograd.grad(y, leaves, torch.from_numpy(gy))
    bwd = {"lstm": ops.lstm_scan_bwd, "gru": ops.gru_scan_bwd}[cell]
    direct = bwd(*map(torch.from_numpy, args), y.detach(), torch.from_numpy(gy))
    for name, g, d, w in zip(("xp", "w_hh", "b_hh"), got, direct, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **OPS_TOL, err_msg=name)
        assert torch.equal(g, d), name
    assert bwd.launches == 0


@pytest.mark.parametrize("dims", [(2, 9, 6, 3), (3, 4, 7, 2), (2, 6, 96, 2)],
                         ids=["L3", "oddH_L2", "H96"])
@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_stack_gradients_match_vct(cell, dims):
    """Autograd through K2's op against jax.vjp of vct's fused-stack op
    (interpret mode, custom_vjp), and ``*_stack_bwd`` the same; atol = rtol
    = 1e-5. H = 96 is a width the card's "clusters" design takes, which
    tests/test_torch_cuda.py holds against these plain versions."""
    args = _stack_args(cell, *dims)
    gy = np.random.RandomState(6).randn(*dims[:3]).astype(np.float32)
    kernel = {"lstm": vct_lstm.lstm_stack_pallas, "gru": vct_lstm.gru_stack_pallas}[cell]
    _, vjp = jax.vjp(kernel, *map(jnp.asarray, args))
    want = vjp(jnp.asarray(gy))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in args]
    wrapper = {"lstm": ops.lstm_stack, "gru": ops.gru_stack}[cell]
    got = torch.autograd.grad(wrapper(*leaves), leaves, torch.from_numpy(gy))
    bwd = {"lstm": ops.lstm_stack_bwd, "gru": ops.gru_stack_bwd}[cell]
    direct = bwd(*map(torch.from_numpy, args), None, None, torch.from_numpy(gy))
    for name, g, d, w in zip(("xp0", "w_hh", "b_hh", "w_ih", "b_ih"), got, direct, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **OPS_TOL, err_msg=name)
        assert torch.equal(g, d), name
    assert bwd.launches == 0


def _layer_outputs(cell, xp0, w_hh, b_hh, w_ih, b_ih):
    """Every layer's outputs (L, B, T, H) of a stack, by the plain version."""
    layer = {"lstm": ops.lstm_scan_ref, "gru": ops.gru_scan_ref}[cell]
    outs, buf = [], xp0
    for l in range(w_hh.shape[0]):
        outs.append(layer(buf, w_hh[l], b_hh[l]))
        if l < w_hh.shape[0] - 1:
            buf = outs[-1] @ w_ih[l] + b_ih[l]
    return torch.stack(outs)


@pytest.mark.parametrize("dims", [(2, 9, 7, 3), (3, 5, 5, 2)], ids=["oddH_L3", "oddH_L2"])
@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_stack_backward_plumbing_matches_vct(monkeypatch, cell, dims):
    """What the CUDA backward runs around its kernel, on the CPU: the
    batched recurrent and input products, a launch a layer (here
    ``layer_bwd_ref``, the kernel's contract in plain PyTorch), dy between
    layers, the batched weight products and the bias sums, against jax.vjp
    of vct's fused-stack op (interpret mode, custom_vjp); atol = rtol =
    1e-5. The launch count it returns is the number of launches made."""
    calls = []

    def layer_bwd(*a):
        calls.append(a[5].shape)
        ops.layer_bwd_ref(*a)

    monkeypatch.setattr(ops, "_layer_bwd", layer_bwd)
    args = _stack_args(cell, *dims)
    gy = np.random.RandomState(7).randn(*dims[:3]).astype(np.float32)
    kernel = {"lstm": vct_lstm.lstm_stack_pallas, "gru": vct_lstm.gru_stack_pallas}[cell]
    _, vjp = jax.vjp(kernel, *map(jnp.asarray, args))
    want = vjp(jnp.asarray(gy))
    targs = list(map(torch.from_numpy, args))
    outs = _layer_outputs(cell, *targs)
    *got, launches = ops._stack_backward(GATES[cell], *targs, outs, torch.from_numpy(gy))
    assert launches == len(calls) == dims[3]
    for name, g, w in zip(("xp0", "w_hh", "b_hh", "w_ih", "b_ih"), got, want):
        assert tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **OPS_TOL, err_msg=name)


@pytest.mark.parametrize("dims", [(2, 9, 7), (3, 1, 5)], ids=["oddH", "T1"])
@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_layer_backward_plumbing_matches_vct(monkeypatch, cell, dims):
    """K5's CUDA backward path, the one-layer stack, on the CPU with
    ``layer_bwd_ref`` for the launch, against jax.vjp of vct's single-layer
    op (interpret mode); atol = rtol = 1e-5; one launch."""
    calls = []

    def layer_bwd(*a):
        calls.append(a[5].shape)
        ops.layer_bwd_ref(*a)

    monkeypatch.setattr(ops, "_layer_bwd", layer_bwd)
    args = _layer_args(cell, *dims)
    gy = np.random.RandomState(8).randn(*dims).astype(np.float32)
    kernel = {"lstm": vct_lstm.lstm_scan_pallas, "gru": vct_lstm.gru_scan_pallas}[cell]
    _, vjp = jax.vjp(kernel, *map(jnp.asarray, args))
    want = vjp(jnp.asarray(gy))
    xp, w_hh, b_hh = map(torch.from_numpy, args)
    y = {"lstm": ops.lstm_scan_ref, "gru": ops.gru_scan_ref}[cell](xp, w_hh, b_hh)
    *got, launches = ops._layer_backward(GATES[cell], xp, w_hh, b_hh, y, torch.from_numpy(gy))
    assert launches == len(calls) == 1
    for name, g, w in zip(("xp", "w_hh", "b_hh"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **OPS_TOL, err_msg=name)


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_layer_bwd_ref_writes_the_kernel_layout(cell):
    """One launch's contract in plain PyTorch against autograd through the
    plain layer: dx the gradient of the input parts, dR the gradient of the
    recurrent products h_t @ W_hh (so 0 at the last step), db the sums over
    time of the recurrent parts' gradients (step 0's included) and of dx."""
    B, T, H = 2, 6, 5
    G = GATES[cell]
    xp, w_hh, b_hh = map(torch.from_numpy, _layer_args(cell, B, T, H, seed=3))
    bx = torch.from_numpy(np.random.RandomState(4).randn(G * H).astype(np.float32) * 0.1)
    gy = torch.from_numpy(np.random.RandomState(5).randn(B, T, H).astype(np.float32))
    # The layer with R_t = h_t @ W_hh + e_t: the gradient of the zero leaf e
    # is the gradient of R.
    leaves = [t.clone().requires_grad_(True) for t in (xp, torch.zeros_like(xp), b_hh)]
    x_, e_, bh_ = leaves
    h, c, ys = xp.new_zeros(B, H), xp.new_zeros(B, H), []
    for t in range(T):
        rec = ((h @ w_hh + e_[:, t - 1]) if t else 0.0) + bh_
        if G == 4:
            i, f, g, o = (x_[:, t] + bx + rec).chunk(4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
        else:
            xr, xz, xn = (x_[:, t] + bx).chunk(3, dim=-1)
            hr, hz, hn = rec.chunk(3, dim=-1)
            rg, z = torch.sigmoid(xr + hr), torch.sigmoid(xz + hz)
            h = (1 - z) * torch.tanh(xn + rg * hn) + z * h
        ys.append(h)
    y = torch.stack(ys, 1)
    want_dx, want_dr, want_db = torch.autograd.grad(y, leaves, gy)
    y, r = y.detach(), y.detach() @ w_hh
    dx, dr, db = torch.empty_like(xp), torch.empty_like(xp), xp.new_empty(2, B, G * H)
    ops.layer_bwd_ref(G, xp, r, bx, b_hh, y, w_hh, gy, dx, dr, db)
    torch.testing.assert_close(dx, want_dx, **OPS_TOL)
    torch.testing.assert_close(dr, want_dr, **OPS_TOL)
    assert torch.equal(dr[:, -1], torch.zeros_like(dr[:, -1]))
    torch.testing.assert_close(db[0].sum(0), want_db, **OPS_TOL)
    torch.testing.assert_close(db[1], dx.sum(1), **OPS_TOL)


@pytest.mark.parametrize("bidirectional", [False, True], ids=["uni", "bidir"])
@pytest.mark.parametrize("cls_name", ["LSTM", "GRU"])
def test_rnn_module_gradients_match_vct(cls_name, bidirectional):
    """Input and per-parameter gradients of the port's LSTM/GRU module
    (``scan_impl="pallas"``: K2 for the unidirectional stack, K5 per
    direction otherwise) against jax.vjp of vct's; atol = rtol = 1e-5."""
    flax_mod, torch_mod = _module_pair(cls_name, num_layers=2, bidirectional=bidirectional,
                                       scan_impl="pallas")
    x = _x(2, 7, 5)
    variables = _perturb(flax_mod.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    gy = np.random.RandomState(3).randn(2, 7, 12 if bidirectional else 6).astype(np.float32)
    _, vjp = jax.vjp(lambda p, xx: flax_mod.apply({"params": p}, xx),
                     jax.tree_util.tree_map(jnp.asarray, variables["params"]), jnp.asarray(x))
    want_p, want_x = vjp(jnp.asarray(gy))
    load_vct_variables(torch_mod, variables)
    xt = torch.from_numpy(x).requires_grad_(True)
    torch_mod(xt).backward(torch.from_numpy(gy))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_x), **OPS_TOL)
    for name, p in torch_mod.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(want_p[name]), **OPS_TOL,
                                   err_msg=name)
