"""Logical-axis sharding: rules mapping logical axes -> mesh axes.

Port of ``repro.sharding``, plain Python over
``torch.distributed``'s ``DeviceMesh`` and DTensor placements.  Model code
names its tensors' axes with *logical* names (``batch``, ``heads``,
``embed``, ...); a rule set maps each onto mesh axes (``pod``, ``data``,
``model``).  Rules are context-scoped (:func:`logical_rules`), so the
same code runs unsharded in the CPU tests and sharded on a mesh.

Rule sets (MaxText-style), as in the reference:
  * TP  : heads/mlp/experts/vocab over ``model``; batch over data(+pod)
  * FSDP: additionally shard the ``embed`` axis of params over ``data``

A :class:`PartitionSpec` is the reference's: one part per tensor dim,
each ``None``, a mesh-axis name, or a tuple of names.  DTensor speaks in
placements instead, one per MESH dim; :func:`placements` translates.
Where one tensor dim is split over several mesh axes, DTensor nests the
splits in mesh-dim order, which is the spec's major-to-minor order
whenever the spec names the axes in the mesh's order (``("pod",
"data")`` on a ``(pod, data, model)`` mesh, as the rules do).

The mesh arguments of :func:`rules_for` and :func:`validate_divisibility`
need only the axis sizes: a ``DeviceMesh``, or any object whose ``shape``
maps axis names to sizes (``launch.mesh.axis_sizes``).
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any, Dict, Optional, Sequence, Tuple, Union

from repro_torch import tree as T
from repro_torch.launch.mesh import axis_sizes

MeshAxes = Union[None, str, Tuple[str, ...]]
PyTree = Any

_state = threading.local()


class PartitionSpec(tuple):
    """Per-dim mesh axes of a tensor: ``PartitionSpec("data", None)``."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def _current_rules() -> Optional[Dict[str, MeshAxes]]:
    return getattr(_state, "rules", None)


def _current_mesh():
    return getattr(_state, "mesh", None)


@contextlib.contextmanager
def logical_rules(rules: Dict[str, MeshAxes], mesh=None):
    prev_r = getattr(_state, "rules", None)
    prev_m = getattr(_state, "mesh", None)
    _state.rules = rules
    _state.mesh = mesh
    try:
        yield
    finally:
        _state.rules = prev_r
        _state.mesh = prev_m


def base_rules(multi_pod: bool, fsdp: bool = False) -> Dict[str, MeshAxes]:
    """The standard TP(+FSDP) rule set for the production meshes."""
    data_axes: MeshAxes = ("pod", "data") if multi_pod else "data"
    rules: Dict[str, MeshAxes] = {
        "batch": data_axes,
        "seq": None,
        "embed": None,
        "heads": "model",
        "kv_heads": "model",
        "heads_flat": "model",
        "head_dim": None,
        "mlp": "model",
        "experts": "model",
        "vocab": "model",
        "layers": None,
    }
    if fsdp:
        rules["embed"] = "data"  # shard params' embed dim over data (ZeRO-3)
    return rules


def spec_for(axes: Sequence[Optional[str]], rules: Dict[str, MeshAxes]) -> PartitionSpec:
    """Logical axes tuple -> PartitionSpec, dropping unmapped axes (and a
    mesh axis an earlier dim already took)."""
    parts = []
    used: set = set()

    def resolve(ax):
        if ax is None:
            return None
        m = rules.get(ax, None)
        if m is None:
            return None
        ms = (m,) if isinstance(m, str) else tuple(m)
        ms = tuple(a for a in ms if a not in used)
        if not ms:
            return None
        used.update(ms)
        return ms if len(ms) > 1 else ms[0]

    for ax in axes:
        parts.append(resolve(ax))
    return PartitionSpec(*parts)


def placements(spec: Sequence, mesh) -> tuple:
    """The DTensor placements of ``spec`` on ``mesh``: for each mesh dim,
    ``Shard(d)`` where the spec splits tensor dim d over that axis, else
    ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    dim_of: Dict[str, int] = {}
    for d, part in enumerate(spec):
        for ax in (() if part is None else (part,) if isinstance(part, str) else part):
            dim_of[ax] = d
    names = tuple(mesh.mesh_dim_names)
    unknown = sorted(set(dim_of) - set(names))
    if unknown:
        raise ValueError(f"spec {tuple(spec)} names axes {unknown} the mesh {names} lacks")
    return tuple(Shard(dim_of[ax]) if ax in dim_of else Replicate() for ax in names)


def constrain(x, axes: Sequence[Optional[str]]):
    """Redistribute a DTensor to the placements of its logical axes under
    the current rules; the identity outside a rules context, and for a
    plain tensor (it has no global view to constrain)."""
    rules = _current_rules()
    if rules is None:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    mesh = _current_mesh() or x.device_mesh
    return x.redistribute(mesh, placements(spec_for(axes, rules), mesh))


def _is_axes(v) -> bool:
    return isinstance(v, tuple) and all(a is None or isinstance(a, str) for a in v)


def tree_specs(axes_tree: PyTree, rules: Dict[str, MeshAxes]) -> PyTree:
    """Pytree of logical-axes tuples -> pytree of PartitionSpec."""
    return T.map_leaves(lambda axes: spec_for(axes, rules), axes_tree, is_leaf=_is_axes)


def is_sharding(v) -> bool:
    """True for one ``(mesh, placements)`` pair of :func:`tree_shardings`."""
    return (isinstance(v, tuple) and len(v) == 2 and hasattr(v[0], "mesh_dim_names")
            and isinstance(v[1], tuple))


def tree_shardings(axes_tree: PyTree, rules: Dict[str, MeshAxes], mesh) -> PyTree:
    """Pytree of logical-axes tuples -> pytree of ``(mesh, placements)``
    pairs (the reference's ``NamedSharding``), for ``distribute_tensor``
    (``ckpt.ft.reshard_to_mesh``)."""
    return T.map_leaves(lambda axes: (mesh, placements(spec_for(axes, rules), mesh)),
                        axes_tree, is_leaf=_is_axes)


def rules_for(
    mesh,
    *,
    multi_pod: bool,
    fsdp: bool,
    n_heads: int,
    n_kv_heads: int,
    head_dim: int,
    d_model: int,
    d_ff: int,
    vocab: int,
    global_batch: int,
    prefer_replicated_kv: bool = False,
    prefer_replicated_attn: bool = False,
) -> Dict[str, MeshAxes]:
    """Divisibility-aware rule set for a concrete (arch, shape, mesh) cell.

    Fallback chains (first divisible option wins), as in the reference:
      heads    : model -> head_dim over model -> replicate
      kv_heads : model -> head_dim over model -> replicate
                 (or straight to replicate when prefer_replicated_kv)
      vocab    : model -> replicate
      batch    : data(+pod) -> replicate
    """
    rules = base_rules(multi_pod, fsdp=fsdp)
    sizes = axis_sizes(mesh)
    model_k = sizes.get("model", 1)
    data_k = sizes.get("data", 1) * (sizes.get("pod", 1) if multi_pod else 1)

    def shard_head_axis(kind: str) -> None:
        n = n_heads if kind == "heads" else n_kv_heads
        if n % model_k == 0:
            rules[kind] = "model"
        elif prefer_replicated_attn or (kind == "kv_heads" and prefer_replicated_kv):
            rules[kind] = None
        elif head_dim % model_k == 0:
            rules[kind] = None
            rules["head_dim"] = "model"
        else:
            rules[kind] = None

    shard_head_axis("heads")
    shard_head_axis("kv_heads")
    rules["heads_flat"] = "model" if d_model % model_k == 0 else None
    if vocab % model_k != 0:
        rules["vocab"] = None
    if d_ff % model_k != 0:
        rules["mlp"] = None
    if global_batch % data_k != 0:
        rules["batch"] = None
    if fsdp and d_model % (sizes.get("data", 1)) != 0:
        rules["embed"] = None
    return rules


def validate_divisibility(shape: Tuple[int, ...], spec: Sequence, mesh) -> bool:
    """True iff every sharded dim divides by its mesh-axis product."""
    sizes = axis_sizes(mesh)
    for dim, part in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        if part is None:
            continue
        k = 1
        for p in (part,) if isinstance(part, str) else part:
            k *= sizes[p]
        if dim % k != 0:
            return False
    return True
