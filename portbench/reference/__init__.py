"""The plain reference: a language model's forward, its loss and AdamW in
float32 PyTorch (:mod:`.lm` with the layers of :mod:`portbench.families`,
:mod:`.optim`), and frozen copies of the stream's semantics that decide
which records reach which operator and which tokens a training step sees
(:mod:`.stream`).  It imports nothing of the program and of the JAX
package, and calls none of the program's kernels or their plain
versions."""
