"""repro_torch — the PyTorch / CUDA port of ``repro`` for NVIDIA Hopper.

The JAX package ``repro`` stays the reference; this package grows beside it
slice by slice and imports nothing from it (it keeps its own copies of the
numpy-only modules it needs).  Public entry points run on the card unless
the caller passes ``device="cpu"``.  See README.md at the repository root.
"""
