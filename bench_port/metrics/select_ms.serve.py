"""Frame selection (``vct_torch/data/preprocess.py::device_sample_clips``:
K1 scores, the top-k, the gather, x / 255): device ms a batch, the kernels
launched inside the benchmark's span around the call."""


def read(view):
    return view.ms_per_unit(view.trace.kernels(range_name="bp.select"))
