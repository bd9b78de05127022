"""Training-side codecs.  Port of ``repro.train``: so far the byte
accounting half of ``grad_compress.py`` (the pod sync itself waits for
collectives, ROADMAP.md Queue 1 item 8)."""
