"""K3, the selective scan's forward (``vct_torch/csrc/selective_scan.cu``):
the least time of the stretch's scans, one a Mamba block a batch
(``core/work.py::k3_forward``), over K3's device time."""

from bench_port.core import work

KERNELS = ("selective_scan_kernel",)


def read(view):
    m, T = view.cfg["model"], view.cfg["sequence_length"]
    n = m["hidden_size"] or m["mult_factor"] * m["rnn_input_size"]
    least = sum(int(m["rnn_layer"])
                * work.least_s(work.k3_forward(s["batch"], T, 2 * m["rnn_input_size"], n))
                for s in view.shapes)
    return view.roofline(view.trace.kernels(KERNELS), least)
