"""Checkpoints: the codecs and manager (``checkpoint.py``) and the
fault-tolerant train loop over them (``ft.py``).  Port of ``repro.ckpt``.

    from repro_torch.ckpt import CheckpointManager
    mgr = CheckpointManager("ckpts", codec="wz-rice")  # device="cuda"
    mgr.save(100, params)                # nested dicts / lists of tensors
    step, params = mgr.restore(template=params)

:func:`tree_from_numpy` / :func:`tree_to_numpy` carry the JAX package's
host state (bfloat16 included) across to tensors and back, leaf names
unchanged.
"""
from repro_torch.ckpt.checkpoint import (  # noqa: F401
    ENC_VERSION,
    CheckpointManager,
    tree_from_numpy,
    tree_to_numpy,
)
from repro_torch.ckpt.ft import (  # noqa: F401
    StragglerWatchdog,
    TrainLoopRunner,
    reshard_to_mesh,
)

__all__ = [
    "ENC_VERSION",
    "CheckpointManager",
    "StragglerWatchdog",
    "TrainLoopRunner",
    "reshard_to_mesh",
    "tree_from_numpy",
    "tree_to_numpy",
]
