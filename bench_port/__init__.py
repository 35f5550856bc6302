"""The benchmark of vct_torch on the NVIDIA H100; see run.py."""
