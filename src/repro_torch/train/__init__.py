"""Training-side codecs.  Port of ``repro.train``: so far
``grad_compress.py``, the cross-pod gradient sync and its byte
accounting.  The optimizer and the train step (``optim.py``,
``train_step.py``) come next, on the LM stack's models
(``repro_torch.models``; ROADMAP.md Queue 1 item 9)."""
