"""Launch-side helpers of the port.  So far the device-mesh makers
(``mesh.py``, port of ``repro.launch.mesh``); the train and dry-run
launchers come with the LM stack (ROADMAP.md Queue 1, item 9)."""
