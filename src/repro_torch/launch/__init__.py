"""Launch-side code of the port: the device-mesh makers (``mesh.py``, port
of ``repro.launch.mesh``), the training driver (``train.py``:
``init_train_state``, ``state_from_numpy``, ``train`` and its command
line), and the dry runs (``dryrun.py``: every (arch x shape x mesh) cell
of the LM stack traced on ``meta`` tensors and priced for the H100 by
``repro_torch.roofline``; ``dryrun_wavelet.py``: the wavelet pod sync's
wire against the plain step's)."""
