"""The backbone (``vct_torch/models/backbones/resnet.py``, in float32 with
TF32 off): device ms a batch, the kernels launched between the forward
hooks on the model's backbone module."""


def read(view):
    return view.ms_per_unit(view.trace.kernels(range_name="bp.backbone"))
