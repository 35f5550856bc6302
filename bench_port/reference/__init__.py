"""The benchmark's plain reference: an LRCN video classifier written from its
semantics in plain PyTorch and NumPy.

It imports torch and numpy alone: nothing of the program under test (the
package ``vct_torch``), of the JAX package ``vct``, or of JAX. It takes its
weights and inputs from the benchmark, never from the program, and works
out on its own everything the program derives from them.

- ``model``: the parameter list of a configuration (names, shapes, how each
  is drawn), SAD frame selection, the ResNet backbone, the adapter, the
  Mamba / LSTM / GRU heads, the classifier.
- ``precision``: the stated float32 with TF32 off, and the kinds below it
  (TF32, a bfloat16 head) that the control and the readings run.
"""
