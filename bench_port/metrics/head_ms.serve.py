"""The temporal head (adapter, Mamba blocks or the LSTM stack, the
classifier: ``vct_torch/models/lrcn.py``, ``ssm.py``, ``recurrent.py``):
device ms a batch, the kernels launched between the hooks that open at the
adapter and close at the classifier."""


def read(view):
    return view.ms_per_unit(view.trace.kernels(range_name="bp.head"))
