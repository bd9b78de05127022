"""``repro_torch`` — the PyTorch/CUDA port of the integer lifting DWT.

A second package beside the JAX reference ``repro``: the same module
names (``core.schemes``, ``core.lifting``, ``kernels.fused2d``,
``kernels.tiled2d``, ``serve.engine``, ...), so each module names its
counterpart.  It imports ``torch``, numpy and the stdlib only — never
``jax`` and nothing of ``repro``.

Device placement: every transform runs where its input tensor lives.  A
CUDA tensor goes through the hand-written Hopper kernels under
``csrc/`` (built with ``nvcc`` at first use, see ``kernels/_build.py``);
a CPU tensor goes through each kernel's plain PyTorch version.  Nothing
falls back from one to the other: a kernel that fails to build or
launch raises.
"""
