"""K2, the LSTM / GRU stack's forward (``vct_torch/csrc/lstm.cu``): the least
time of the stretch's stacks, one a batch (``core/work.py::
rnn_stack_forward``), over K2's device time."""

from bench_port.core import work

KERNELS = ("rnn_reg_kernel", "rnn_cluster_kernel", "rnn_stack_kernel")


def read(view):
    m, T = view.cfg["model"], view.cfg["sequence_length"]
    h = m["hidden_size"] or m["mult_factor"] * m["rnn_input_size"]
    gates = 4 if m["rnn_type"] == "lstm" else 3
    least = sum(work.least_s(work.rnn_stack_forward(s["batch"], T, h, int(m["rnn_layer"]),
                                                    gates)) for s in view.shapes)
    return view.roofline(view.trace.kernels(KERNELS), least)
