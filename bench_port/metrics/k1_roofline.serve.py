"""K1, SAD pair scores (``vct_torch/csrc/pair_scores.cu``): the least time of
the scores of the stretch's batches (``core/work.py::k1_sad``, at each
batch's bucket; a batch padded only to T is not scored) over K1's device
time."""

from bench_port.core import work

KERNELS = ("pair_scores_chunks", "pair_scores_words", "pair_scores_bytes")


def read(view):
    T, (H, W, C) = view.cfg["sequence_length"], view.cfg["frame"]
    least = sum(work.least_s(work.k1_sad(s["batch"], s["L"], H, W, C))
                for s in view.shapes if s["L"] > T)
    return view.roofline(view.trace.kernels(KERNELS), least)
