"""Count arithmetic primitives in a traced torch graph.

Port of ``repro.core.opcount``: the evidence generator for the paper's
Table 2 (adders / shifters) and the "LS needs fewer operations than the
standard (5,3) filter bank" claim.  The reference counts the primitives
of a jaxpr; here :func:`count_primitives` traces the function with
``torch.fx.experimental.proxy_tensor.make_fx`` on example tensors and
counts the ``call_function`` nodes of the graph by their aten name
(``aten.add.Tensor``), so the numbers come from the code that runs.

Buckets, by the op's name without its overload (``aten.add``), an
in-place form (``aten.add_``) counted as its out-of-place op:

- adders: ``add``, ``sub`` (jaxpr ``add``, ``sub``); ``rsub`` too, a
  subtract with its operands swapped, which jnp never emits.
- shifters: ``bitwise_right_shift``, ``bitwise_left_shift``,
  ``__rshift__``, ``__lshift__`` (jaxpr ``shift_right_arithmetic``,
  ``shift_right_logical``, ``shift_left``).
- multipliers: ``mul`` (jaxpr ``mul``) and every matrix product or
  convolution (jaxpr ``dot_general``, ``conv_general_dilated``): ``mm``,
  ``bmm``, ``addmm``, ``addbmm``, ``baddbmm``, ``addmv``, ``mv``,
  ``dot``, ``vdot``, ``matmul``, ``linear``, ``einsum``, ``tensordot``,
  ``convolution`` and its named forms.  ``addcmul`` multiplies, so it is
  a multiplier too.
- skipped: the ops that move or re-type data without arithmetic, the
  reference's ``_SKIP``: views and reshapes (``view``, ``_unsafe_view``,
  ``reshape``, ``alias``, ``expand``: jaxpr ``reshape``,
  ``broadcast_in_dim``), ``squeeze`` / ``unsqueeze``, slicing and
  indexing (``slice``, ``select``, ``narrow``: jaxpr ``slice``;
  ``index``, ``index_select``, ``gather``: jaxpr ``gather``; ``scatter``,
  ``index_put``), ``flip`` (``rev``), ``cat`` (``concatenate``),
  ``permute`` / ``transpose`` / ``t``, ``roll``, copies (``clone``,
  ``copy``, ``_to_copy``: jaxpr ``convert_element_type``, ``copy``;
  ``lift_fresh_copy``, ``detach``: jaxpr ``stop_gradient``) and the
  constants a trace materialises (``zeros_like``, ``scalar_tensor``).
- everything else is "other arithmetic" (``neg``, as in the reference).

A strided slice (``x[..., 0::2]``) is a view here, so the reference's
``gather`` index arithmetic (2 ``mul`` and 2 ``add`` in the traced
``filterbank53_fwd_float``) has no twin: the port's trace of that
function holds only the convolutions' 8 multiplies and 6 adds.
"""
from __future__ import annotations

from collections import Counter
from typing import Any, Callable, Dict

import torch

ADDER_PRIMS = {"aten.add", "aten.sub", "aten.rsub"}
SHIFT_PRIMS = {
    "aten.bitwise_right_shift",
    "aten.bitwise_left_shift",
    "aten.__rshift__",
    "aten.__lshift__",
}
MUL_PRIMS = {
    "aten.mul",
    "aten.addcmul",
    "aten.mm",
    "aten.bmm",
    "aten.addmm",
    "aten.addbmm",
    "aten.baddbmm",
    "aten.addmv",
    "aten.mv",
    "aten.dot",
    "aten.vdot",
    "aten.matmul",
    "aten.linear",
    "aten.einsum",
    "aten.tensordot",
    "aten.convolution",
    "aten._convolution",
    "aten.conv1d",
    "aten.conv2d",
    "aten.conv3d",
    "aten.conv_transpose1d",
    "aten.conv_transpose2d",
    "aten.conv_transpose3d",
    "aten.cudnn_convolution",
}
_SKIP = {
    "aten._to_copy",
    "aten._unsafe_view",
    "aten.alias",
    "aten.cat",
    "aten.clone",
    "aten.copy",
    "aten.detach",
    "aten.expand",
    "aten.flip",
    "aten.gather",
    "aten.index",
    "aten.index_put",
    "aten.index_select",
    "aten.lift_fresh_copy",
    "aten.narrow",
    "aten.permute",
    "aten.reshape",
    "aten.roll",
    "aten.scalar_tensor",
    "aten.scatter",
    "aten.select",
    "aten.slice",
    "aten.squeeze",
    "aten.t",
    "aten.transpose",
    "aten.unsqueeze",
    "aten.view",
    "aten.zeros_like",
}


def _op_name(target: str) -> str:
    """``aten.add`` for ``aten.add.Tensor`` and ``aten.add_.Tensor``."""
    parts = target.split(".")
    if len(parts) < 2:
        return target
    op = parts[1] if parts[1].startswith("__") else parts[1].rstrip("_")
    return f"{parts[0]}.{op}"


def count_primitives(fn: Callable, *example_args: Any) -> Counter:
    """Trace ``fn`` on the example args and count the graph's calls by
    their aten name (``aten.add.Tensor``)."""
    from torch.fx.experimental.proxy_tensor import make_fx

    graph = make_fx(fn)(*example_args)
    return Counter(str(node.target) for node in graph.graph.nodes
                   if node.op == "call_function")


def arithmetic_summary(fn: Callable, *example_args: Any) -> Dict[str, int]:
    """Bucketed counts: adders (add/sub), shifters, multipliers, other."""
    by_op: Counter = Counter()
    for name, v in count_primitives(fn, *example_args).items():
        by_op[_op_name(name)] += v
    adders = sum(v for k, v in by_op.items() if k in ADDER_PRIMS)
    shifts = sum(v for k, v in by_op.items() if k in SHIFT_PRIMS)
    muls = sum(v for k, v in by_op.items() if k in MUL_PRIMS)
    other = sum(
        v
        for k, v in by_op.items()
        if k not in ADDER_PRIMS | SHIFT_PRIMS | MUL_PRIMS | _SKIP
    )
    return {
        "adders": adders,
        "shifters": shifts,
        "multipliers": muls,
        "other_arith": other,
        "total_arith": adders + shifts + muls + other,
    }


# ---------------------------------------------------------------------------
# The per-output-pair computations, exactly as Table 2 frames them.
# ---------------------------------------------------------------------------


def lifting_pair(x0, x1, x2, d_prev):
    """One output pair (s[n], d[n]) of the paper's LS — eqs. (5)+(7)."""
    d = x1 - torch.bitwise_right_shift(x0 + x2, 1)
    s = x0 + torch.bitwise_right_shift(d + d_prev, 2)
    return s, d


def direct_form_pair(x0, x1, x2, x3, x4):
    """One output pair of the multiplierless DIRECT-form (5,3) filterbank.

    hi:  d[n] = x[2n+1] - (x[2n] + x[2n+2] ) >> 1
    lo:  s[n] = (-(x0+x4) + ((x1+x3) << 1) + (x2 << 2) + (x2 << 1)) >> 3
    This is the Kishore-style baseline the paper compares against.
    """
    d = x1 - torch.bitwise_right_shift(x0 + x2, 1)
    e = x0 + x4
    o = torch.bitwise_left_shift(x1 + x3, 1)
    c = torch.bitwise_left_shift(x2, 2) + torch.bitwise_left_shift(x2, 1)
    s = torch.bitwise_right_shift(o + c - e, 3)
    return s, d


def example_int_args(k: int):
    """k 0-dim int32 example tensors for tracing."""
    return tuple(torch.tensor(i + 1, dtype=torch.int32) for i in range(k))


# ---------------------------------------------------------------------------
# Per-scheme pair functions: trace the registry's step algebra the same
# way Table 2 frames the (5,3) — one (s, d) output pair per invocation.
# ---------------------------------------------------------------------------


def scheme_pair_fn(scheme):
    """(fn, n_args): one output pair of the named scheme, for tracing.

    ``fn`` applies every lifting step once to fresh scalar reads, which
    is exactly the steady-state per-pair hardware cost; tracing it must
    reproduce ``LiftingScheme.pair_op_counts()`` (tests assert this) and
    contain zero multiplies for every registered scheme.
    """
    from repro_torch.core import schemes as S

    sch = S.get_scheme(scheme)
    n_args = 2 + sum(len(st.taps) for st in sch.steps)

    def fn(*args):
        it = iter(args)
        cur = {"even": next(it), "odd": next(it)}
        for st in sch.steps:
            # the engines' own step application (schemes._apply_taps), so
            # the traced ledger cannot drift from what the kernels run
            reads = [next(it) for _ in st.taps]
            tgt = "odd" if st.kind == "predict" else "even"
            cur[tgt] = S._apply_taps(st, cur[tgt], reads, inverse=False)
        return cur["even"], cur["odd"]

    return fn, n_args


def scheme_arithmetic_summary(scheme) -> Dict[str, int]:
    """Traced per-pair op counts for a registered scheme (Table-2 style)."""
    fn, n_args = scheme_pair_fn(scheme)
    return arithmetic_summary(fn, *example_int_args(n_args))
