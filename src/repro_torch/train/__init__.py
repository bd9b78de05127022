"""Training-side codecs.  Port of ``repro.train``: so far
``grad_compress.py``, the cross-pod gradient sync and its byte
accounting (the train step and optimizer come with the LM stack,
ROADMAP.md Queue 1 item 9)."""
