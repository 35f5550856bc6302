"""K1's plan (``vct_torch.ops.pair_scores.plan``) on the CPU.

The plan cuts (B, L, H, W, C) clips into tiles of (clip, chunk of K
transitions, band of the frame's 16-byte words) for the CUDA kernel. It is
pure Python, so every property the kernel relies on is checked here: each
word in exactly one band and each transition in exactly one chunk, bands on
16-byte boundaries, the limits the kernel's C entry point checks, and that
one video fills the card, and which design each batch takes. The kernel
itself is held bit-equal to ``pair_scores_ref`` on the card
(tests/test_torch_cuda.py, chip_smoke.py); tests/test_torch_kernels.py holds
the port against ``vct`` on the CPU.
"""

import pytest

from vct_torch.ops import pair_scores as k1

# (B, L, H, W, C): the bench step, both served buckets, a decoded 320x240
# and a 1080p video, L=2, the kernel-audit geometries, frames off a multiple
# of 16 bytes, a frame of one word, a long clip, a small batch.
SHAPES = [
    (32, 120, 80, 80, 3), (1, 120, 80, 80, 3), (1, 240, 80, 80, 3), (1, 120, 240, 320, 3),
    (1, 5, 1080, 1920, 3), (4, 2, 80, 80, 3), (2, 12, 16, 16, 3), (1, 9, 11, 44, 3),
    (2, 21, 16, 48, 1), (3, 13, 7, 5, 1), (2, 9, 4, 4, 1), (1, 2000, 80, 80, 3),
    (4, 120, 80, 80, 3), (7, 33, 19, 23, 3),
]


def _ids(s):
    return "x".join(map(str, s))


def _check_tiles(shape, p):
    """Every 16-byte word of a frame in exactly one band, every band on a
    16-byte boundary and in exactly one block of its cluster, every
    transition in exactly one chunk; the limits vct_pair_scores checks."""
    B, L, H, W, C = shape
    words, pairs = -(-(H * W * C) // 16), L - 1
    K, nb, bw, cl = p["chunk_pairs"], p["bands"], p["band_words"], p["cluster"]
    if p["design"] == "chunks":
        assert (K, nb, bw, cl, p["threads"]) == (k1.CHUNK, 1, words, 1, k1.CHUNK_THREADS)
        assert B <= k1.MAX_CHUNK_CLIPS
    covered = []
    for rank in range(cl):
        mine = range(rank, nb, cl)
        assert len(mine) >= 1  # every block of a cluster takes a band
        for j in mine:
            band = range(j * bw, min((j + 1) * bw, words))
            assert len(band) >= 1 and (j * bw * 16) % 16 == 0
            covered += band
    assert sorted(covered) == list(range(words))
    chunks = [range(c * K, min((c + 1) * K, pairs)) for c in range(p["chunks"])]
    assert all(len(c) >= 1 for c in chunks)
    assert sorted(t for c in chunks for t in c) == list(range(pairs))
    assert p["blocks"] == B * p["chunks"] * cl <= k1.MAX_BLOCKS
    assert 1 <= K <= min(k1.MAX_CHUNK_PAIRS, pairs)
    assert 1 <= cl <= min(nb, k1.MAX_CLUSTER)
    assert p["threads"] % 32 == 0 and 32 <= p["threads"] <= k1.MAX_THREADS
    if p["design"] == "bands":
        assert p["words_per_thread"] in k1.WORDS_PER_THREAD
        assert bw <= p["words_per_thread"] * p["threads"] < bw + 32 * p["words_per_thread"]
        assert p["smem_bytes"] == (1 + p["threads"] // 32) * K * 8


@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_plan_tiles_cover_each_word_and_transition_once(shape):
    _check_tiles(shape, k1.plan(*shape))


@pytest.mark.parametrize("shape", SHAPES[:4], ids=_ids)
def test_plan_is_a_pure_function_of_the_shape(shape):
    first = dict(k1.plan(*shape))
    k1.plan.cache_clear()
    assert k1.plan(*shape) == first


@pytest.mark.parametrize("shape", [(1, 120, 80, 80, 3), (1, 240, 80, 80, 3),
                                   (1, 120, 240, 320, 3)], ids=_ids)
def test_one_served_video_fills_the_card(shape):
    """One video, as the served path calls K1: about a block an SM, no SM
    holding two (the first design ran 15 blocks), in clusters of 8 bands."""
    p = k1.plan(*shape)
    assert p["design"] == "bands" and p["cluster"] == k1.MAX_CLUSTER
    assert 0.9 * k1.SMS <= p["blocks"] <= k1.SMS


@pytest.mark.parametrize("B,design", [(1, "bands"), (2, "bands"), (4, "chunks"), (32, "chunks")])
def test_plan_takes_the_chunks_design_for_many_clips(B, design):
    """The served bucket and a pair of clips take bands in clusters; from
    four clips of 120 frames the chunk tiling (480 blocks at the bench
    batch, 3.64 an SM) fills the card without clusters, and it timed
    fastest there on the H100."""
    p = k1.plan(B, 120, 80, 80, 3)
    assert p["design"] == design
    if design == "chunks":
        assert p["blocks"] == B * 15


def test_plan_cuts_a_huge_frame_into_bands_a_block_holds():
    """A 4K frame (24.9 MB) needs hundreds of bands: whole clusters, each
    block taking many in turn, each band at most two words a thread."""
    p = k1.plan(1, 9, 2160, 3840, 3)
    _check_tiles((1, 9, 2160, 3840, 3), p)
    assert p["cluster"] == k1.MAX_CLUSTER and p["bands"] > 100 * k1.MAX_CLUSTER
    assert p["band_words"] <= max(k1.WORDS_PER_THREAD) * k1.MAX_THREADS


@pytest.mark.parametrize("K,nb", [(1, 3), (3, 5), (7, 17), (7, 20), (119, 3), (119, 8),
                                  (5, 1200)])
def test_forced_plans_are_taken(K, nb):
    shape = (2, 120, 80, 80, 3)
    p = k1.plan(*shape, K, nb)
    assert (p["design"], p["chunk_pairs"], p["bands"]) == ("bands", K, nb)
    assert p["cluster"] == min(nb, k1.MAX_CLUSTER)
    _check_tiles(shape, p)


def test_forced_bands_beyond_words_of_a_band_are_normalised():
    """1200 words in 7 bands: six of 172 words and a short last one; 8
    words in 6 bands of 2 would leave two empty, so the plan takes 4."""
    p = k1.plan(1, 10, 80, 80, 3, 0, 7)
    assert p["bands"] == 7 and p["band_words"] == 172
    p = k1.plan(1, 10, 11, 11, 1, 0, 6)  # 121 bytes: 8 words, 6 bands of 2 words
    assert p["band_words"] == 2 and p["bands"] == 4
    _check_tiles((1, 10, 11, 11, 1), p)


@pytest.mark.parametrize("args", [
    (2, 120, 80, 80, 3, 120, 0),    # K beyond the clip's 119 transitions
    (2, 120, 80, 80, 3, -1, 0),
    (2, 120, 80, 80, 3, 0, -1),
    (2, 120, 80, 80, 3, 0, 1201),   # more bands than 16-byte words
    (2, 120, 80, 80, 3, 0, 2),      # two bands of 600 words: more than two a thread
    (1, 3, 1080, 1920, 3, 0, 1),    # one band of 6.2 MB
    (1, 1, 80, 80, 3, 0, 0),        # no transition
    (0, 4, 80, 80, 3, 0, 0),
    (1, 4, 0, 80, 3, 0, 0),
], ids=["K_beyond_clip", "K_negative", "bands_negative", "bands_beyond_words", "band_of_600",
        "band_too_big",
        "L1", "B0", "empty_frame"])
def test_impossible_plans_raise(args):
    with pytest.raises(ValueError):
        k1.plan(*args)


def test_large_batches_have_no_clip_limit():
    """The bands design's grid x dimension carries (clip, chunk, rank):
    100000 clips give a plan, though the chunks design (its clip on the
    grid's y dimension) stops at 65535 and refuses them."""
    p = k1.plan(100000, 120, 16, 16, 3)
    assert p["design"] == "bands"
    assert p["blocks"] == 100000 * p["chunks"] * p["cluster"] <= k1.MAX_BLOCKS
    assert k1.plan(65535, 120, 16, 16, 3, design="chunks")["blocks"] == 65535 * 15
    with pytest.raises(ValueError):
        k1.plan(65536, 120, 16, 16, 3, design="chunks")


@pytest.mark.parametrize("args", [(2, 120, 80, 80, 3, 7, 0, "chunks"),
                                  (2, 120, 80, 80, 3, 0, 2, "chunks"),
                                  (2, 120, 80, 80, 3, 0, 0, "tma")],
                         ids=["chunks_other_K", "chunks_two_bands", "unknown_design"])
def test_forced_designs_refuse_what_they_do_not_take(args):
    with pytest.raises(ValueError):
        k1.plan(*args)
