"""Launch-side code of the port: the device-mesh makers (``mesh.py``, port
of ``repro.launch.mesh``) and the training driver (``train.py``:
``init_train_state``, ``state_from_numpy``, ``train`` and its command
line).  The dry-run launchers and the roofline come next (ROADMAP.md
Queue 1, item 9c)."""
