"""Launch-side helpers of the port.  So far the device-mesh makers
(``mesh.py``, port of ``repro.launch.mesh``); the train launcher comes
with the train step, then the dry-run launchers (ROADMAP.md Queue 1,
item 9)."""
