"""The plain reference of the benchmark's models, in plain PyTorch at
float32 with TF32 off: one module a model, named by the configuration's
``model`` (``aread.py``: AREAD on its MMoE base; ``mmoe.py``: MMoE), each
with its parameters, forward, loss and multiply-add count over the shared
layers (``layers.py``); the two Adam updates and the bf16 stochastic
rounding (``optim.py``); a HEMP candidate chain (``hemp.py``).

It imports nothing of the measured package and takes nothing that the
package made: the benchmark draws the weights, the data and the masks from
the seed (``perfbench.inputs``) and hands the same to both sides; the
reference works out everything else again (row offsets and padding, pooled
embeddings, gradients, optimizer state, dropout from its own generator
seeded as the configuration states).
"""
