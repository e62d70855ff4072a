"""Plain PyTorch references, one module per model family.

Each family module gives ``layout(m)`` (the parameter leaves, their
shapes and init rules; leaves under ``blocks/`` are stacked over the
layers), ``loss(params, batch, m, products)`` and ``model_flops(m,
batch, seq)`` (a train step's model FLOPs, from the yardstick's
counts).  They import torch, :mod:`perfbench.reference.common` and
:mod:`perfbench.yardstick` only: nothing of the program under test.
"""
