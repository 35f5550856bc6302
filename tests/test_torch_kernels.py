"""vct_torch kernels (K1 pair_scores, K3 selective_scan) against vct.

On the CPU the port's wrappers run their plain PyTorch versions; the vct
side runs its Pallas kernels in interpret mode, as tests/test_pallas_ops.py
does. tests/test_torch_cuda.py holds the CUDA kernels against their plain
versions on the card.

Tolerances: SAD is bit-exact (both sides sum exactly in integers); flow
rtol 1e-5 (vct accumulates flow in f32, the port sums exactly); the scan
atol = rtol = 1e-4 (test_pallas_ops.py's tolerance).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vct.ops.pair_scores_pallas import pair_scores as vct_pair_scores
from vct.ops.selective_scan_pallas import selective_scan_pallas as vct_selective_scan
from vct_torch.ops.pair_scores import pair_scores
from vct_torch.ops.selective_scan import decode_plan, selective_scan

# (B, L, H, W, C): L=2, the kernel-audit geometries (odd H, C=1, L crossing
# vct's 16-transition chunk), and odd H*W*C.
PAIR_SHAPES = [
    (2, 2, 5, 7, 3),
    (2, 12, 16, 16, 3),
    (1, 9, 11, 44, 3),
    (1, 7, 9, 86, 3),
    (2, 21, 16, 48, 1),
    (1, 11, 5, 7, 1),
]


def _clips(shape, seed=0):
    return np.random.RandomState(seed).randint(0, 256, size=shape, dtype=np.uint8)


@pytest.mark.parametrize("method", ["sad", "flow"])
@pytest.mark.parametrize("shape", PAIR_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_pair_scores_matches_vct(shape, method):
    x = _clips(shape)
    want = np.asarray(vct_pair_scores(jnp.asarray(x), method))
    got = pair_scores(torch.from_numpy(x), method).numpy()
    assert got.shape == want.shape == (shape[0], shape[1] - 1)
    assert got.dtype == np.float32
    if method == "sad":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("L", [0, 1])
def test_pair_scores_short_clip(L):
    x = _clips((3, L, 4, 4, 3))
    want = np.asarray(vct_pair_scores(jnp.asarray(x), "sad"))
    got = pair_scores(torch.from_numpy(x), "sad").numpy()
    assert got.shape == want.shape == (3, 0)


def test_pair_scores_static_frames_score_zero():
    frame = _clips((1, 1, 6, 6, 3))
    x = np.repeat(frame, 5, axis=1)
    want = np.asarray(vct_pair_scores(jnp.asarray(x), "sad"))
    got = pair_scores(torch.from_numpy(x), "sad").numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.zeros((1, 4), np.float32))


def test_pair_scores_rejects_float():
    x = _clips((1, 3, 4, 4, 3)).astype(np.float32)
    with pytest.raises(TypeError):
        vct_pair_scores(jnp.asarray(x), "sad")
    with pytest.raises(TypeError):
        pair_scores(torch.from_numpy(x), "sad")


def test_pair_scores_unknown_method():
    x = _clips((1, 3, 4, 4, 3))
    with pytest.raises(KeyError):
        vct_pair_scores(jnp.asarray(x), "ssim")
    with pytest.raises(KeyError):
        pair_scores(torch.from_numpy(x), "ssim")


def _scan_inputs(B, L, D, N, seed=0):
    rng = np.random.RandomState(seed)
    return (
        rng.randn(B, L, D).astype(np.float32),
        (np.abs(rng.randn(B, L, D)) * 0.5).astype(np.float32),
        (-np.abs(rng.randn(D, N))).astype(np.float32),
        rng.randn(B, L, N).astype(np.float32),
        rng.randn(B, L, N).astype(np.float32),
    )


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("dims", [(2, 12, 8, 4), (2, 9, 16, 32), (2, 9, 16, 1), (2, 9, 16, 24),
                                  (2, 9, 16, 64), (2, 9, 16, 12), (2, 9, 16, 33),
                                  (2, 9, 16, 100)],
                         ids=["small", "deployed_widths", "N1", "N24", "N64", "N12", "N33",
                              "N100"])
def test_selective_scan_matches_vct(dims, reverse):
    args = _scan_inputs(*dims)
    want = np.asarray(vct_selective_scan(*map(jnp.asarray, args), reverse=reverse))
    got = selective_scan(*map(torch.from_numpy, args), reverse=reverse).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_selective_scan_rejects_bad_shapes():
    u, delta, A, B, C = map(torch.from_numpy, _scan_inputs(2, 5, 8, 4))
    with pytest.raises(ValueError):
        selective_scan(u, delta, A[:4], B, C)
    with pytest.raises(ValueError):
        selective_scan(u, delta, A, B[:, :3], C)


@pytest.mark.parametrize("code,N,want", [
    (1 | 32 << 4 | 2 << 16 | 2 << 20, 32, (1, 32, 1, 1, 128, 64)),
    (2 | 8 << 4 | 2 << 16 | 2 << 20, 16, (2, 8, 1, 1, 128, 64)),
    (1 | 128 << 4 | 2 << 16 | 2 << 20, 100, (1, 128, 4, 1, 128, 64)),
    (1 | 256 << 4 | 2 << 16 | 2 << 20, 300, (1, 256, 8, 2, 128, 64)),
    (2 | 32 << 4 | 4 << 16 | 1 << 20, 64, (2, 32, 1, 1, 256, 32)),
    (1 | 16 << 4 | 1 << 16 | 8 << 20, 12, (1, 16, 1, 1, 64, 256)),
])
def test_decode_plan_reads_the_packed_plan(code, N, want):
    """The kernel library packs a plan as S | lanes << 4 | threads / 64 << 16
    | chunk / 32 << 20."""
    p = decode_plan(code, N)
    assert (p["states_per_lane"], p["lanes_per_channel"], p["warps_per_channel"],
            p["state_tiles"], p["block_threads"], p["chunk_steps"]) == want


@pytest.mark.parametrize("code,N,want", [
    (1 | 32 << 4 | 2 << 16 | 8 << 20, 32, (1, 32, 1, 1, 128, 64)),
    (2 | 8 << 4 | 2 << 16 | 7 << 20, 16, (2, 8, 1, 1, 128, 56)),
    (1 | 256 << 4 | 4 << 16 | 4 << 20, 300, (1, 256, 8, 2, 256, 32)),
    (1 | 1 << 4 | 2 << 16 | 1 << 20, 1, (1, 1, 1, 1, 128, 8)),
])
def test_decode_plan_reads_the_packed_backward_plan(code, N, want):
    """The backward's plan (``vct_scan_bwd_plan``) is packed as the
    forward's, with its chunk in steps of 8: chunk / 8 << 20."""
    p = decode_plan(code, N, chunk_unit=8)
    assert (p["states_per_lane"], p["lanes_per_channel"], p["warps_per_channel"],
            p["state_tiles"], p["block_threads"], p["chunk_steps"]) == want


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("dims", [(2, 9, 16, 1), (2, 9, 16, 24), (2, 12, 8, 4), (2, 70, 8, 4),
                                  (2, 130, 8, 4)],
                         ids=["N1", "N24", "small", "L70", "L130"])
def test_selective_scan_gradients_match_vct(dims, reverse):
    """Autograd through the port's K3 op (its plain version on the CPU)
    against jax.vjp of vct's (the Pallas kernel in interpret mode under its
    custom_vjp), and the port's ``selective_scan_bwd`` the same; atol = rtol
    = 1e-5."""
    import jax

    from vct_torch.ops.selective_scan import selective_scan_bwd

    args = _scan_inputs(*dims)
    gy = np.random.RandomState(7).randn(*dims[:3]).astype(np.float32)
    _, vjp = jax.vjp(lambda *a: vct_selective_scan(*a, reverse=reverse), *map(jnp.asarray, args))
    want = vjp(jnp.asarray(gy))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in args]
    got = torch.autograd.grad(selective_scan(*leaves, reverse=reverse), leaves,
                              torch.from_numpy(gy))
    direct = selective_scan_bwd(*map(torch.from_numpy, args), torch.from_numpy(gy),
                                reverse=reverse)
    for name, g, d, w in zip("u delta A B C".split(), got, direct, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=1e-5, err_msg=name)
        assert torch.equal(g, d), name
    assert selective_scan_bwd.launches == 0  # CPU tensors never reach the kernel
