"""Training (port of ``repro.train``): ``optim.py`` (AdamW with global-norm
clipping, the reference's formula in plain torch ops), ``train_step.py``
(the plain step with microbatch accumulation, and the wavelet-synced
multi-pod step, SPMD over a mesh's ``pod`` axis) and ``grad_compress.py``
(the cross-pod gradient sync through the integer-DWT codec and its byte
accounting).  Gradients come from ``torch.autograd`` through
``repro_torch.models``; the driver is ``repro_torch.launch.train``."""
