"""Scalarization: stage a ``logp: (d,) -> scalar`` into per-coordinate
plane ops for the fused kernels (``ops/hmc_fused.py``).

Why this exists:

1. A kernel holds one chain per lane and each coordinate as a lane vector
   (a "plane"). ``jax.vmap`` over a chain block would instead turn every
   small intermediate of the model's logp — a stacked coefficient vector,
   a Gram quadratic form — into a block with the tiny model axes as extra
   dimensions, which the kernel language neither lays out well nor, for
   most reductions and matrix products at those shapes, lowers at all.
2. Data-dependent subgraphs (the ``normal_linear`` Gram build, observed
   choice maps) must not be re-executed inside the kernel's leapfrog loop.

The pass:

- **Inline** all sub-jaxprs (pjit / custom_jvp / custom_vjp calls) into one
  flat equation list.
- **Partial-evaluate**: every equation whose inputs depend only on closure
  constants is executed eagerly at staging time (outer jit trace), OUTSIDE
  the kernel — XLA computes it once per call; the kernel never sees the
  data. This is the generalization of the `normal_linear` hoisting trick
  to arbitrary models.
- **Scalarize the residual**: every remaining value is a ``ScalarArray`` —
  its original shape plus a flat list of per-element "scalars", where each
  scalar is either a Python constant, a staged residual constant, or a
  PLANE (one value per chain). Array primitives become Python-level loops
  over elements; every emitted JAX op is an elementwise op on planes.
  A residual `dot_general` becomes an explicit sum of products; a
  `reduce_sum` becomes a Python sum — no in-kernel reductions at all.

Supported residual primitives are the scalar-PPL set (arithmetic,
transcendentals, comparisons, select, stack/concat/reshape/slice/transpose/
broadcast, reductions, dot_general, convert_element_type, erf & friends via
inlining) plus structured pieces that unroll statically:

- ``scan``: unrolled over its (static) length — the body jaxpr is inlined
  and evaluated per step at the ScalarArray level, so collapsed
  state-space likelihoods (Kalman-filter scans) stage into the fused
  kernel; the observed sequence arrives as staged residual constants.
- ``cond``: every branch is evaluated (they are element-level expressions
  after scalarization) and combined with a branchless where-chain on the
  traced index — the standard masked-universe trick.
- ``cholesky`` / ``triangular_solve``: unrolled Cholesky-Banachiewicz and
  forward/back substitution — exact for the small (D <= ~8) matrices PPL
  likelihoods build; each output element is plain arithmetic.

``while_loop`` (data-dependent trip count) remains unsupported — callers
fall back to the XLA path.

No reference analogue: this is the fused kernel's staging machinery.
"""

from __future__ import annotations

import math
from typing import Any, Callable, List, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.extend import core as jex_core


class ScalarArray:
    """An array value represented as original shape + flat element list."""

    __slots__ = ("shape", "elems")

    def __init__(self, shape: Tuple[int, ...], elems: List[Any]):
        self.shape = tuple(shape)
        assert len(elems) == math.prod(self.shape) if self.shape else 1
        self.elems = list(elems)

    @property
    def size(self):
        return len(self.elems)

    def __repr__(self):
        return f"ScalarArray(shape={self.shape}, n={len(self.elems)})"


class StreamArray:
    """A LARGE per-datapoint value, represented symbolically (round 4).

    Element-unrolling (ScalarArray) is the right representation for the
    small residual of a sufficient-statistic likelihood, but a
    non-collapsible per-point likelihood (robust-t errors, per-point GLM
    links) has an x-dependent array as long as the dataset — unrolling
    it would emit n x ops plane equations. A StreamArray instead holds a
    tiny expression DAG over (data leaves, x-dependent plane scalars);
    the DAG is only materialized when a ``reduce_sum`` over the data
    axis appears, as an IN-KERNEL fori loop streaming the data table
    (:func:`_stream_loop`) — the dataset never enters the unrolled
    program.

    ``node``: ('leaf', data_row_index) | ('plane', plane_value)
            | ('const', python_scalar) | (op_name, params, (args...)).
    """

    __slots__ = ("length", "node")

    def __init__(self, length: int, node):
        self.length = int(length)
        self.node = node

    def __repr__(self):
        return f"StreamArray(n={self.length})"


def _ravel_index(idx, shape):
    out = 0
    for i, s in zip(idx, shape):
        out = out * s + i
    return out


def _broadcast_elems(a: ScalarArray, shape) -> List[Any]:
    """Elements of ``a`` broadcast to ``shape`` (numpy semantics)."""
    if a.shape == tuple(shape):
        return a.elems
    idx = np.broadcast_to(np.arange(max(a.size, 1)).reshape(a.shape), shape)
    return [a.elems[i] for i in idx.reshape(-1)]


def _eager_op(op, *xs):
    """Apply ``op``; when every input is concrete, evaluate at staging time
    (jax omnistaging would otherwise turn constant index arithmetic into
    tracers, breaking static-gather detection inside jit)."""
    from jax.core import Tracer
    if any(isinstance(x, Tracer) for x in xs):
        return op(*xs)
    with jax.ensure_compile_time_eval():
        # numpy result: embeds as a LITERAL downstream — a jax Array would
        # become a captured constant, which pallas kernels reject
        return np.asarray(op(*xs))


def _elementwise(op, *args: ScalarArray) -> ScalarArray:
    shape = np.broadcast_shapes(*[a.shape for a in args])
    cols = [_broadcast_elems(a, shape) for a in args]
    return ScalarArray(shape, [_eager_op(op, *xs) for xs in zip(*cols)])


_UNARY = {
    "exp": jnp.exp, "log": jnp.log, "log1p": jnp.log1p, "expm1": jnp.expm1,
    "neg": lambda x: -x, "sign": jnp.sign, "floor": jnp.floor,
    "ceil": jnp.ceil, "round": jnp.round, "abs": jnp.abs,
    "sqrt": jnp.sqrt, "rsqrt": jax.lax.rsqrt, "cbrt": jnp.cbrt,
    "sin": jnp.sin, "cos": jnp.cos, "tan": jnp.tan, "tanh": jnp.tanh,
    "sinh": jnp.sinh, "cosh": jnp.cosh, "asin": jnp.arcsin,
    "acos": jnp.arccos, "atan": jnp.arctan, "asinh": jnp.arcsinh,
    "acosh": jnp.arccosh, "atanh": jnp.arctanh,
    "erf": jax.lax.erf, "erfc": jax.lax.erfc,
    "erf_inv": jax.lax.erf_inv, "lgamma": jax.lax.lgamma,
    "digamma": jax.lax.digamma, "logistic": jax.lax.logistic,
    "is_finite": jnp.isfinite, "not": jnp.logical_not,
    "stop_gradient": jax.lax.stop_gradient,
    "copy": lambda x: x, "real": jnp.real,
    "square": jnp.square,
}

_BINARY = {
    "add": jnp.add, "sub": jnp.subtract, "mul": jnp.multiply,
    "div": jnp.divide, "rem": jnp.remainder, "pow": jnp.power,
    "max": jnp.maximum, "min": jnp.minimum, "atan2": jnp.arctan2,
    "lt": jnp.less, "le": jnp.less_equal, "gt": jnp.greater,
    "ge": jnp.greater_equal, "eq": jnp.equal, "ne": jnp.not_equal,
    "and": jnp.logical_and, "or": jnp.logical_or, "xor": jnp.logical_xor,
    "nextafter": jnp.nextafter,
}


class _Pending:
    """Marker element: the (deferred) result of a stream reduction."""

    __slots__ = ("idx",)

    def __init__(self, idx):
        self.idx = idx


class _Affine:
    """Scalar-part value carrying deferred stream sums additively:
    ``base + sum(coeff_j * stream_term_j)``. The only shapes a deferred
    data-sum may take downstream of its reduction — PPL log-likelihoods
    enter the joint additively (possibly scaled by known constants), and
    the additive structure is what lets plane_vag assemble the exact
    gradient from per-term partials without differentiating through the
    data loop."""

    __slots__ = ("base", "terms")

    def __init__(self, base, terms):
        self.base = base          # jax/np scalar or plane
        self.terms = list(terms)  # [(known_coeff, term_idx)]


_STREAM_CTX: List[Any] = []       # innermost stream-term collection list


def _is_pending(x):
    return isinstance(x, (_Pending, _Affine))


def _as_affine(x):
    if isinstance(x, _Affine):
        return x
    if isinstance(x, _Pending):
        return _Affine(0.0, [(1.0, x.idx)])
    return _Affine(x, [])


def _apply_pending(name, params, args: Sequence[ScalarArray]):
    """Scalar ops on values containing deferred stream sums: additive
    structure only (add/sub/neg, scaling by KNOWN constants)."""
    for a in args:
        if isinstance(a, StreamArray):
            raise NotImplementedError(
                "stream staging: a deferred data-sum re-entering per-point "
                "arithmetic is not supported; use the XLA path "
                "instead")
        if a.size != 1:
            raise NotImplementedError(
                "stream staging: a deferred data-sum combined with a "
                "non-scalar is not supported; use the XLA path "
                "instead")
    vals = [_as_affine(a.elems[0]) for a in args]

    def known(v):
        from jax.core import Tracer
        return not v.terms and not isinstance(v.base, Tracer)

    if name == "add":
        x, y = vals
        out = _Affine(x.base + y.base, x.terms + y.terms)
    elif name == "sub":
        x, y = vals
        out = _Affine(x.base - y.base,
                      x.terms + [(-c, i) for c, i in y.terms])
    elif name == "neg":
        x, = vals
        out = _Affine(-x.base, [(-c, i) for c, i in x.terms])
    elif name == "mul":
        x, y = vals
        if y.terms and not x.terms:
            x, y = y, x
        if y.terms or not known(y):
            raise NotImplementedError(
                "stream staging: a deferred data-sum may only be scaled "
                "by a known constant (the additive-log-likelihood "
                "restriction); use the XLA path instead")
        c = y.base
        out = _Affine(x.base * c, [(cc * c, i) for cc, i in x.terms])
    elif name == "div":
        x, y = vals
        if y.terms or not known(y):
            raise NotImplementedError(
                "stream staging: a deferred data-sum may only be divided "
                "by a known constant; use the XLA path instead")
        c = y.base
        out = _Affine(x.base / c, [(cc / c, i) for cc, i in x.terms])
    elif name == "convert_element_type":
        x, = vals
        if not jnp.issubdtype(params["new_dtype"], jnp.floating):
            raise NotImplementedError(
                "stream staging: non-float conversion of a deferred "
                "data-sum; use the XLA path instead")
        out = x
    elif name in ("reshape", "squeeze", "expand_dims", "broadcast_in_dim"):
        x, = vals
        shape = params.get("new_sizes") or params.get("shape") or ()
        if math.prod(shape) not in (1,):
            raise NotImplementedError(
                "stream staging: broadcasting a deferred data-sum; use "
                "the XLA path instead")
        out = x
    else:
        raise NotImplementedError(
            f"stream staging: primitive '{name}' applied to a deferred "
            "data-sum (only additive combination is supported); use the "
            "XLA path instead")
    return [ScalarArray((), [out])]


# stream-node evaluators: name -> fn(params, *vals)
def _stream_eval(name, params, *vals):
    if name in _UNARY:
        return _UNARY[name](*vals)
    if name in _BINARY:
        return _BINARY[name](*vals)
    if name == "integer_pow":
        return vals[0] ** params["y"]
    if name == "select_n":
        c, a, b = vals
        return jnp.where(c, b, a)
    if name == "convert_element_type":
        return jnp.asarray(vals[0]).astype(params["new_dtype"])
    raise NotImplementedError(name)


def _apply_stream(name, params, args):
    """Elementwise ops involving StreamArrays build DAG nodes lazily —
    the dataset axis is never unrolled; a reduce_sum over it defers to an
    in-kernel streaming loop (registered in _STREAM_CTX)."""
    lengths = [a.length for a in args if isinstance(a, StreamArray)]
    n = lengths[0]
    if any(l != n for l in lengths):
        raise NotImplementedError(
            f"stream staging: mixed stream lengths {lengths}; use the "
            "XLA path instead")

    def as_node(a):
        if isinstance(a, StreamArray):
            return a.node
        if isinstance(a, ScalarArray):
            if a.size != 1:
                raise NotImplementedError(
                    "stream staging: a non-scalar unrolled value combined "
                    "with a stream (per-point) value; use the XLA path "
                    "instead")
            e = a.elems[0]
            if _is_pending(e):
                raise NotImplementedError(
                    "stream staging: a deferred data-sum re-entering "
                    "per-point arithmetic; use the XLA path "
                    "instead")
            from jax.core import Tracer
            if isinstance(e, Tracer) or isinstance(e, jnp.ndarray):
                return ("plane", e)
            return ("const", e)
        return ("const", a)

    if name in _UNARY or name in ("integer_pow",):
        return [StreamArray(n, (name, dict(params),
                                (as_node(args[0]),)))]
    if name in _BINARY:
        return [StreamArray(n, (name, dict(params),
                                (as_node(args[0]), as_node(args[1]))))]
    if name == "select_n" and len(args) == 3:
        return [StreamArray(n, (name, dict(params),
                                tuple(as_node(a) for a in args)))]
    if name == "convert_element_type":
        if not jnp.issubdtype(params["new_dtype"], jnp.floating):
            raise NotImplementedError(
                "stream staging: non-float stream conversion; use the "
                "XLA path instead")
        return [StreamArray(n, (name, dict(params),
                                (as_node(args[0]),)))]
    if name in ("reshape", "squeeze", "expand_dims"):
        a = args[0]
        shape = (params.get("new_sizes") if name == "reshape" else None)
        if shape is not None and math.prod(shape) != a.length:
            raise NotImplementedError(
                "stream staging: size-changing reshape of a stream "
                "value; use the XLA path instead")
        return [a]
    if name == "broadcast_in_dim":
        a = args[0]
        shape = tuple(params["shape"])
        if math.prod(shape) != a.length:
            raise NotImplementedError(
                "stream staging: size-changing broadcast of a stream "
                "value; use the XLA path instead")
        return [a]
    if name in ("reduce_sum",):
        a = args[0]
        # the deferred reduction: whatever the axes, a 1-D stream summed
        # over its (only) real axis
        _STREAM_CTX[-1].append(a)
        return [ScalarArray((), [_Pending(len(_STREAM_CTX[-1]) - 1)])]
    raise NotImplementedError(
        f"stream staging: primitive '{name}' on a per-point stream value "
        "is not supported; use the XLA path instead")


def _eval_node_now(nd):
    """Evaluate a LEAF-FREE stream DAG node eagerly (hoisting)."""
    if nd[0] in ("plane", "const"):
        return nd[1]
    return _stream_eval(nd[0], nd[1],
                        *[_eval_node_now(a) for a in nd[2]])


def _hoist_node(nd):
    """Hoist maximal data-independent subtrees out of the per-point DAG:
    a t-logpdf's gammaln/log-scale terms depend only on chain planes and
    would otherwise be recomputed n times inside the data loop (measured
    on the robust-t n=10k bench: hoisting moved the fused/XLA ratio from
    0.85x to the reported number in benchmarks/RESULTS.md). Hoisted
    values become ('plane', value) leaves — canonicalized into loop
    inputs, so the vjp chain rule through them is closed by plane_vag's
    outer pull automatically. Returns (node, depends_on_data)."""
    kind = nd[0]
    if kind in ("leaf", "index"):
        return nd, True
    if kind in ("plane", "const"):
        return nd, False
    pairs = [_hoist_node(a) for a in nd[2]]
    if any(dep for _, dep in pairs):
        outargs = []
        for a, dep in pairs:
            if not dep and a[0] not in ("plane", "const"):
                outargs.append(("plane", _eval_node_now(a)))
            else:
                outargs.append(a)
        return (kind, nd[1], tuple(outargs)), True
    return (kind, nd[1], tuple(a for a, _ in pairs)), False


def _canon_stream(term: StreamArray):
    """Canonicalize a stream DAG: hoist data-independent subtrees, then
    collect the distinct x-dependent plane inputs and the data rows it
    reads; replace them with indices."""
    planes, rows = [], []

    def canon(nd):
        kind = nd[0]
        if kind == "plane":
            v = nd[1]
            for j, p in enumerate(planes):
                if p is v:
                    return ("input", j)
            planes.append(v)
            return ("input", len(planes) - 1)
        if kind == "leaf":
            if nd[1] not in rows:
                rows.append(nd[1])
            return nd
        if kind in ("const", "index"):
            return nd
        return (kind, nd[1], tuple(canon(a) for a in nd[2]))

    hoisted, _ = _hoist_node(term.node)
    cnode = canon(hoisted)
    return cnode, planes, rows, term.length


# Points evaluated per loop iteration as ONE (P, *plane) op block: the
# block's data arrive as one (P,) vector load per data row, broadcast
# against the chain planes, so the loop overhead (index arithmetic, the
# per-point vjp bookkeeping) is paid once per P points. Pad points are
# masked inside the block so their cotangents are exactly zero.
STREAM_BLOCK = 16


def _loader(data):
    """``load(row, first, size) -> (size,)`` over a stream-data table: an
    array (read with a dynamic slice) or a loader already (the kernels
    pass one that reads their table in device memory)."""
    if callable(data):
        return data
    table = jnp.asarray(data)

    def load(row, first, size):
        return jax.lax.dynamic_slice_in_dim(table[row], first, size)

    return load


def _block_contrib(cnode, rows, load, base, ss, length, zero):
    """Contribution of STREAM_BLOCK consecutive points starting at
    ``base``, evaluated as one set of (P, *plane) ops and summed over the
    block axis; points at or past ``length`` (edge-padded) contribute
    exactly zero."""
    P = STREAM_BLOCK
    col = (P,) + (1,) * zero.ndim
    dvals = {r: jnp.reshape(load(r, base, P), col) + zero for r in rows}
    idx = base + jax.lax.iota(jnp.int32, P)
    dvals["__i__"] = jnp.reshape(idx.astype(zero.dtype), col) + zero
    # multiplicative 0/1 mask; pad values are EDGE data (finite), so
    # mask-by-multiply is NaN-safe and its vjp zeroes pad cotangents
    valid = jnp.reshape(jnp.where(idx < length, 1.0, 0.0).astype(zero.dtype),
                        col)

    def ev(nd):
        kind = nd[0]
        if kind == "leaf":
            return dvals[nd[1]]
        if kind == "const":
            return nd[1]
        if kind == "index":
            return dvals["__i__"]
        if kind == "input":
            return ss[nd[1]]
        return _stream_eval(kind, nd[1], *[ev(a) for a in nd[2]])

    out = (ev(cnode) + zero).astype(zero.dtype)     # (P, *plane)
    return jnp.sum(out * valid, axis=0)


def _stream_loop(cnode, s_vals, rows, length, data, plane_zero,
                 want_grad=True):
    """The data loop: stream the table in STREAM_BLOCK-point blocks,
    evaluating the per-point DAG as plane ops and accumulating the sum AND
    its partials w.r.t. each plane input (per-block jax.vjp of the PURE
    block function — data are read before the vjp, so gradient memory is
    O(#inputs) planes, not O(n)).

    The VALUE accumulator is KAHAN-COMPENSATED: a plain sequential f32 sum
    over n/16 block contributions carries ~sqrt(n_blocks) * eps * |partial
    sums| of absolute noise — at n = 1M with |logp| ~ 1e6 that is O(10),
    which drowns the O(1) MH energy differences. Compensation cuts it to
    ~eps * |sum|. The GRADIENT accumulators are compensated too: near the
    posterior mode the gradient is a cancellation of |sum|-magnitude
    contributions, and its rounding noise biases the leapfrog drift."""
    if not s_vals:
        raise NotImplementedError(
            "stream staging: a data-sum with no x-dependent part should "
            "have been partial-evaluated away")
    load = _loader(data)
    P = STREAM_BLOCK
    n_blocks = (length + P - 1) // P
    zero = plane_zero

    def _kadd(acc, comp, val):
        y = val - comp
        t = acc + y
        return t, (t - acc) - y

    def body(b, accs):
        base = b * P
        if want_grad:
            val, pullp = jax.vjp(
                lambda *ss: _block_contrib(cnode, rows, load, base, ss,
                                           length, zero), *s_vals)
            gs = pullp(jnp.ones_like(val))
        else:
            val = _block_contrib(cnode, rows, load, base, s_vals, length,
                                 zero)
            gs = ()
        out = []
        for i, v in enumerate((val,) + tuple(gs)):
            a, c = _kadd(accs[2 * i], accs[2 * i + 1], v)
            out += [a, c]
        return tuple(out)

    # the VALUE accumulator is a full plane (anchored by plane_zero); each
    # GRADIENT accumulator matches ITS input's shape — inputs may be
    # scalars (staged residual constants in the per-point expression)
    zeros = [zero, zero]
    if want_grad:
        for sv in s_vals:
            zeros += [sv * 0.0, sv * 0.0]
    accs = jax.lax.fori_loop(0, n_blocks, body, tuple(zeros))
    n_acc = 1 + (len(s_vals) if want_grad else 0)
    return accs[0], tuple(accs[2 * i] for i in range(1, n_acc))


def _inline_jaxpr(jaxpr, consts) -> Tuple[list, dict, list, list]:
    """Flatten all call-like sub-jaxprs into one equation list.

    Returns (eqns, env_const: var->concrete, invars, outvars) where vars in
    the flattened eqns are the original Var objects (uniqueness preserved
    by jax's var identity)."""
    eqns = []
    const_env = {v: c for v, c in zip(jaxpr.constvars, consts)}

    def go_inline(jx, m):
        """Inline jx's eqns with var substitution m; return substituted
        outvars."""
        for eqn in jx.eqns:
            name = eqn.primitive.name
            sub_jaxpr = None
            if name in ("pjit", "jit", "closed_call", "core_call",
                        "xla_call"):
                sub_jaxpr = eqn.params.get("jaxpr")
            elif name in ("custom_jvp_call", "custom_vjp_call",
                          "custom_jvp_call_jaxpr", "custom_vjp_call_jaxpr"):
                sub_jaxpr = (eqn.params.get("call_jaxpr")
                             or eqn.params.get("fun_jaxpr"))
            if sub_jaxpr is not None:
                inner = getattr(sub_jaxpr, "jaxpr", sub_jaxpr)
                inner_consts = getattr(sub_jaxpr, "consts", [])
                for v, c in zip(inner.constvars, inner_consts):
                    const_env[v] = c
                m2 = dict(m)
                for iv, ov in zip(inner.invars, eqn.invars):
                    m2[iv] = (ov if isinstance(ov, jex_core.Literal)
                              else m.get(ov, ov))
                outs = go_inline(inner, m2)
                for ov, val in zip(eqn.outvars, outs):
                    m[ov] = val
            else:
                new_invars = [v if isinstance(v, jex_core.Literal)
                              else m.get(v, v) for v in eqn.invars]
                eqns.append(eqn.replace(invars=new_invars))
                for ov in eqn.outvars:
                    m[ov] = ov
        return [v if isinstance(v, jex_core.Literal) else m.get(v, v)
                for v in jx.outvars]

    top_map = {}
    outs = go_inline(jaxpr, top_map)
    return eqns, const_env, list(jaxpr.invars), outs


class StagedLogp:
    """Result of :func:`stage_scalarized`.

    - ``plane_fn(planes, res, data=None)``: value-only plane logp.
    - ``plane_vag(planes, res, data=None)``: (logp, grad) with the stream
      terms' gradients hand-assembled (never differentiates through the
      data loop) — what the fused kernel calls.
    - ``res_consts``: f32 vector of staged residual scalars.
    - ``stream_data``: f32 (rows, n_max) data table for the streaming
      loops, or None when the model fully collapses. ``data`` above is
      this table, or a ``load(row, first, size)`` function reading it.

    Unpacks as the 2-tuple ``plane_fn, res_consts = staged``.
    """

    def __init__(self, plane_fn, res_consts, plane_vag, stream_data):
        self.plane_fn = plane_fn
        self.res_consts = res_consts
        self.plane_vag = plane_vag
        self.stream_data = stream_data

    def __iter__(self):
        return iter((self.plane_fn, self.res_consts))


def stage_scalarized(logp: Callable, d: int,
                     max_residual_scalars: int = 1024,
                     stream_threshold: int = 2048,
                     allow_stream: bool = True) -> StagedLogp:
    """Stage ``logp`` for plane evaluation; see :class:`StagedLogp`.

    Small x-dependent residuals unroll into per-element plane ops
    (sufficient-statistic likelihoods). A NON-collapsible per-point
    likelihood stages too: large known float arrays (>=
    ``stream_threshold`` elements) become rows of a data table, per-point
    arithmetic on them builds a lazy :class:`StreamArray` DAG, and the
    final ``reduce_sum`` runs as an in-kernel streaming loop
    (:func:`_stream_loop`) with hand-assembled gradients.
    """
    closed = jax.make_jaxpr(lambda x: logp(x))(jnp.zeros((d,), jnp.float32))
    eqns, const_env, invars, outvars = _inline_jaxpr(closed.jaxpr,
                                                     closed.consts)
    x_var = invars[0]

    # ---- partial evaluation: execute every const-only eqn eagerly now ----
    known = dict(const_env)          # var -> concrete/traced value (outside)
    unknown = {x_var}
    residual_eqns = []

    def val_of(v):
        return v.val if isinstance(v, jex_core.Literal) else known[v]

    for eqn in eqns:
        deps_unknown = any((not isinstance(v, jex_core.Literal))
                           and v in unknown for v in eqn.invars)
        if not deps_unknown:
            invals = [val_of(v) for v in eqn.invars]
            out = eqn.primitive.bind(*invals, **eqn.params)
            outs = out if eqn.primitive.multiple_results else [out]
            for ov, val in zip(eqn.outvars, outs):
                known[ov] = val
        else:
            residual_eqns.append(eqn)
            for ov in eqn.outvars:
                unknown.add(ov)

    # ---- collect residual constants (known values used by residual);
    # large float arrays become STREAM ROWS instead of staged scalars ----
    res_vars, stream_vars = [], []
    seen = set()
    for eqn in residual_eqns:
        for v in eqn.invars:
            if (not isinstance(v, jex_core.Literal) and v not in unknown
                    and v not in seen):
                seen.add(v)
                size = (int(np.prod(v.aval.shape)) if v.aval.shape else 1)
                if (allow_stream and size >= stream_threshold
                        and jnp.issubdtype(v.aval.dtype, jnp.floating)
                        and sum(s > 1 for s in v.aval.shape) <= 1):
                    stream_vars.append(v)
                else:
                    res_vars.append(v)
    for v in outvars:
        if (not isinstance(v, jex_core.Literal) and v not in unknown
                and v not in seen):
            seen.add(v)
            res_vars.append(v)

    sizes = [int(np.prod(v.aval.shape)) if v.aval.shape else 1
             for v in res_vars]
    total = sum(sizes)
    if total > max_residual_scalars:
        raise ValueError(
            f"scalarized residual needs {total} staged scalars (> "
            f"{max_residual_scalars}): the x-dependent part of this logp "
            "touches large arrays (non-sufficient-statistic likelihood?); "
            "use the XLA path instead")
    for v in res_vars:
        if not jnp.issubdtype(v.aval.dtype, jnp.floating):
            raise ValueError(
                f"staged residual constant has dtype {v.aval.dtype}; only "
                "float residuals are supported (use the XLA path)")
    res_consts = (jnp.concatenate(
        [jnp.ravel(known[v]).astype(jnp.float32) for v in res_vars])
        if res_vars else jnp.zeros((1,), jnp.float32))

    offsets = {}
    off = 0
    for v, s in zip(res_vars, sizes):
        offsets[v] = off
        off += s

    # ---- stream data table: rows padded to a common length, a whole
    # number of evaluation blocks, with each row's EDGE value (finite,
    # in-domain): padded points are masked out of the sums, but they
    # still flow through the per-point DAG, and a 0.0 pad can NaN it
    # (log, /0), which would then poison the masked vjp (0 * NaN) ----
    stream_data = None
    stream_lengths = []
    if stream_vars:
        lens = [int(np.prod(v.aval.shape)) for v in stream_vars]
        n_max = -(-max(lens) // STREAM_BLOCK) * STREAM_BLOCK
        rows = [jnp.pad(jnp.ravel(known[v]).astype(jnp.float32),
                        (0, n_max - ln), mode="edge")
                for v, ln in zip(stream_vars, lens)]
        stream_data = jnp.stack(rows)
        stream_lengths = lens

    def _eval(planes, res, data):
        if stream_vars and data is None:
            raise ValueError(
                "this staged logp streams a dataset: pass the "
                "StagedLogp.stream_data table (or a loader) as data")
        env = {}
        env[x_var] = ScalarArray((d,), [planes[i] for i in range(d)])
        for v in res_vars:
            base = offsets[v]
            n = int(np.prod(v.aval.shape)) if v.aval.shape else 1
            env[v] = ScalarArray(v.aval.shape,
                                 [res[base + i] for i in range(n)])
        for row, v in enumerate(stream_vars):
            env[v] = StreamArray(stream_lengths[row], ("leaf", row))
        ctx: List[StreamArray] = []
        _STREAM_CTX.append(ctx)
        try:
            _run_eqns(residual_eqns, env)
            out = _read_var(outvars[0], env)
        finally:
            _STREAM_CTX.pop()
        if out.shape not in ((), (1,)):
            raise ValueError(f"logp output has shape {out.shape}; expected "
                             "scalar")
        elem = out.elems[0]
        if _is_pending(elem):
            aff = _as_affine(elem)
            return aff.base, aff.terms, ctx
        return elem, [], ctx

    # ---- the scalarized plane function (value only) -------------------
    def plane_fn(planes, res, data=None):
        """planes: (d, *plane); res: staged scalars; data: the
        stream-data table or a loader (see :class:`StagedLogp`)."""
        base, aterms, ctx = _eval(planes, res, data)
        val = base
        pz = planes[0] * 0.0
        for coeff, idx in aterms:
            cnode, s_vals, rows, length = _canon_stream(ctx[idx])
            v, _ = _stream_loop(cnode, s_vals, rows, length, data,
                                pz, want_grad=False)
            val = val + coeff * v
        return val

    # ---- value-and-grad with hand-assembled stream gradients ----------
    def plane_vag(planes, res, data=None):
        """logp = base(v) + sum_j c_j * S_j(s_j(v)) with S_j the data
        sums: grad = vjp of (base, s_1..s_J) with cotangents
        (1, c_1*g_1, ..., c_J*g_J) where g_j = dS_j/ds_j comes from the
        forward data loop — exact, and never differentiates through the
        fori (whose scan-vjp residuals would be O(n) planes)."""
        cell = {}

        def f(v):
            base, aterms, ctx = _eval(v, res, data)
            canon = [_canon_stream(ctx[idx]) for _, idx in aterms]
            cell["aterms"] = aterms
            cell["canon"] = canon
            return base, tuple(tuple(c[1]) for c in canon)

        (base, s_groups), pull = jax.vjp(f, planes)
        val = base
        g_groups = []
        pz = planes[0] * 0.0
        for (coeff, _), (cnode, _, rows, length), s_vals in zip(
                cell["aterms"], cell["canon"], s_groups):
            v, gs = _stream_loop(cnode, list(s_vals), rows, length,
                                 data, pz, want_grad=True)
            val = val + coeff * v
            g_groups.append(tuple(coeff * g for g in gs))
        grad = pull((jnp.ones_like(base), tuple(g_groups)))[0]
        return val, grad

    return StagedLogp(plane_fn, res_consts, plane_vag, stream_data)


def _read_var(v, env) -> ScalarArray:
    if isinstance(v, jex_core.Literal):
        arr = np.asarray(v.val)
        return ScalarArray(arr.shape, list(arr.reshape(-1)))
    return env[v]


def _run_eqns(eqns, env):
    """Evaluate a flattened equation list at the ScalarArray level."""
    for eqn in eqns:
        name = eqn.primitive.name
        args = [_read_var(v, env) for v in eqn.invars]
        if name == "scan":
            outs = _eval_scan(eqn, args)
        elif name == "cond":
            outs = _eval_cond(eqn, args)
        else:
            outs = _apply(name, eqn.params, args)
        for ov, val in zip(eqn.outvars, outs):
            env[ov] = val


def _eval_closed(closed, in_vals: Sequence[ScalarArray]):
    """Evaluate a ClosedJaxpr (e.g. a scan body / cond branch) on
    ScalarArray inputs; returns ScalarArray outputs."""
    jx = getattr(closed, "jaxpr", closed)
    consts = getattr(closed, "consts", [])
    eqns, const_env, invars, outs = _inline_jaxpr(jx, consts)
    env = {}
    for v, c in const_env.items():
        arr = np.asarray(c)
        env[v] = ScalarArray(arr.shape, list(arr.reshape(-1)))
    for v, val in zip(invars, in_vals):
        env[v] = val
    _run_eqns(eqns, env)
    return [_read_var(v, env) for v in outs]


def _lead_slice(a: ScalarArray, t: int) -> ScalarArray:
    """Index a ScalarArray's leading axis at t."""
    rest = a.shape[1:]
    n = int(np.prod(rest)) if rest else 1
    return ScalarArray(rest, a.elems[t * n:(t + 1) * n])


def _eval_scan(eqn, args: Sequence[ScalarArray]):
    """Unroll a ``scan`` statically: the body is evaluated ``length``
    times at the ScalarArray level (this is what lets Kalman-filter
    likelihoods stage into the fused kernels)."""
    p = eqn.params
    length = int(p["length"])
    nc, ncar = int(p["num_consts"]), int(p["num_carry"])
    consts = list(args[:nc])
    carry = list(args[nc:nc + ncar])
    xs = list(args[nc + ncar:])
    n_out = len(eqn.outvars)
    n_ys = n_out - ncar
    ys_slices = [[None] * length for _ in range(n_ys)]
    order = range(length - 1, -1, -1) if p.get("reverse") else range(length)
    for t in order:
        ins = consts + carry + [_lead_slice(x, t) for x in xs]
        outs = _eval_closed(p["jaxpr"], ins)
        carry = outs[:ncar]
        for i, y in enumerate(outs[ncar:]):
            ys_slices[i][t] = y
    ys = []
    for i in range(n_ys):
        shape = (length,) + ys_slices[i][0].shape
        elems = [e for sl in ys_slices[i] for e in sl.elems]
        ys.append(ScalarArray(shape, elems))
    return carry + ys


def _eval_cond(eqn, args: Sequence[ScalarArray]):
    """Branchless ``cond``: every branch is evaluated (element-level
    expressions after scalarization) and combined with a where-chain on
    the traced index — the masked-universe trick."""
    pred = args[0]
    ops = list(args[1:])
    branches = eqn.params["branches"]
    idx0 = pred.elems[0]
    if isinstance(idx0, (int, np.integer)):
        # concrete index (e.g. a platform_index dispatch resolved at
        # staging time): evaluate only the selected branch — the others
        # may hold platform-specific lowerings we cannot scalarize
        k = min(max(int(idx0), 0), len(branches) - 1)
        return _eval_closed(branches[k], ops)
    branch_outs = [_eval_closed(b, ops) for b in branches]
    nb = len(branch_outs)
    idx = pred.elems[0]
    outs = []
    for j in range(len(branch_outs[0])):
        # out = branch_0; for k: where(idx >= k, branch_k, out) — also
        # implements lax.cond's index clamping
        acc = branch_outs[0][j]
        for k in range(1, nb):
            ge_k = ScalarArray((), [jnp.greater_equal(idx, k)])
            acc = _elementwise(
                lambda ci, ai, bi: jnp.where(ci, bi, ai),
                ge_k, acc, branch_outs[k][j])
        outs.append(acc)
    return outs


def _apply(name: str, params: dict, args: Sequence[ScalarArray]):
    if any(isinstance(a, StreamArray) for a in args):
        return _apply_stream(name, params, args)
    if any(_is_pending(e) for a in args
           if isinstance(a, ScalarArray) for e in a.elems):
        return _apply_pending(name, params, args)
    if name in _UNARY:
        return [_elementwise(_UNARY[name], args[0])]
    if name in _BINARY:
        return [_elementwise(_BINARY[name], args[0], args[1])]
    if name == "integer_pow":
        y = params["y"]
        return [_elementwise(lambda x: x ** y, args[0])]
    if name == "select_n":
        if len(args) == 3:
            c, a, b = args
            return [_elementwise(
                lambda ci, ai, bi: jnp.where(ci, bi, ai), c, a, b)]
        # general ordinal select: where-chain (pred >= k picks case k)
        pred = args[0]
        acc = args[1]
        for k in range(2, len(args)):
            acc = _elementwise(
                lambda ci, ai, bi, k=k - 1: jnp.where(
                    jnp.greater_equal(ci, k), bi, ai), pred, acc, args[k])
        return [acc]
    if name == "convert_element_type":
        dt = params["new_dtype"]
        return [ScalarArray(args[0].shape,
                            [_eager_op(lambda x: jnp.asarray(x).astype(dt),
                                       e) if not isinstance(e, (int, float))
                             else np.dtype(dt).type(e)
                             for e in args[0].elems])]
    if name in ("reshape", "squeeze", "expand_dims"):
        a = args[0]
        if name == "reshape":
            new_shape = params["new_sizes"]
        elif name == "squeeze":
            dims = set(params["dimensions"])
            new_shape = tuple(s for i, s in enumerate(a.shape)
                              if i not in dims)
        else:
            new_shape = list(a.shape)
            for dim in sorted(params["dimensions"]):
                new_shape.insert(dim, 1)
            new_shape = tuple(new_shape)
        return [ScalarArray(new_shape, a.elems)]
    if name == "broadcast_in_dim":
        a = args[0]
        shape = tuple(params["shape"])
        bdims = params["broadcast_dimensions"]
        src = np.empty(a.shape or (), dtype=np.int64)
        src = np.arange(max(a.size, 1)).reshape(a.shape)
        expand = [1] * len(shape)
        for i, bd in enumerate(bdims):
            expand[bd] = a.shape[i]
        idx = np.broadcast_to(src.reshape(expand), shape)
        return [ScalarArray(shape, [a.elems[i] for i in idx.reshape(-1)])]
    if name == "transpose":
        a = args[0]
        perm = params["permutation"]
        idx = np.transpose(np.arange(a.size).reshape(a.shape), perm)
        return [ScalarArray(idx.shape, [a.elems[i] for i in idx.reshape(-1)])]
    if name == "concatenate":
        dim = params["dimension"]
        shapes = [a.shape for a in args]
        out_shape = list(shapes[0])
        out_shape[dim] = sum(s[dim] for s in shapes)
        elems = []
        for out_idx in np.ndindex(*out_shape):
            j = out_idx[dim]
            acc = 0
            for k, a in enumerate(args):
                if j < acc + a.shape[dim]:
                    src_idx = list(out_idx)
                    src_idx[dim] = j - acc
                    elems.append(a.elems[_ravel_index(src_idx, a.shape)])
                    break
                acc += a.shape[dim]
        return [ScalarArray(tuple(out_shape), elems)]
    if name == "slice":
        a = args[0]
        starts = params["start_indices"]
        limits = params["limit_indices"]
        strides = params["strides"] or (1,) * len(a.shape)
        idx = np.arange(a.size).reshape(a.shape)[tuple(
            slice(s, l, st) for s, l, st in zip(starts, limits, strides))]
        return [ScalarArray(idx.shape, [a.elems[i] for i in idx.reshape(-1)])]
    if name == "rev":
        a = args[0]
        idx = np.arange(a.size).reshape(a.shape)
        for dim in params["dimensions"]:
            idx = np.flip(idx, dim)
        return [ScalarArray(a.shape, [a.elems[i] for i in idx.reshape(-1)])]
    if name in ("reduce_sum", "reduce_max", "reduce_min", "reduce_prod",
                "reduce_and", "reduce_or"):
        a = args[0]
        axes = params["axes"]
        keep = [i for i in range(len(a.shape)) if i not in axes]
        out_shape = tuple(a.shape[i] for i in keep)
        idx = np.arange(a.size).reshape(a.shape)
        perm = keep + list(axes)
        idx = np.transpose(idx, perm).reshape(
            int(np.prod(out_shape)) if out_shape else 1, -1)
        combine = {"reduce_sum": lambda x, y: x + y,
                   "reduce_prod": lambda x, y: x * y,
                   "reduce_max": jnp.maximum, "reduce_min": jnp.minimum,
                   "reduce_and": jnp.logical_and,
                   "reduce_or": jnp.logical_or}[name]
        elems = []
        for row in idx:
            acc = a.elems[row[0]]
            for i in row[1:]:
                acc = combine(acc, a.elems[i])
            elems.append(acc)
        return [ScalarArray(out_shape, elems)]
    if name == "dot_general":
        lhs, rhs = args
        (lc, rc), (lb, rb) = params["dimension_numbers"]
        lhs_other = [i for i in range(len(lhs.shape))
                     if i not in set(lc) | set(lb)]
        rhs_other = [i for i in range(len(rhs.shape))
                     if i not in set(rc) | set(rb)]
        batch_shape = tuple(lhs.shape[i] for i in lb)
        lo_shape = tuple(lhs.shape[i] for i in lhs_other)
        ro_shape = tuple(rhs.shape[i] for i in rhs_other)
        c_shape = tuple(lhs.shape[i] for i in lc)
        out_shape = batch_shape + lo_shape + ro_shape
        li = np.arange(lhs.size).reshape(lhs.shape)
        ri = np.arange(rhs.size).reshape(rhs.shape)
        li = np.transpose(li, list(lb) + lhs_other + list(lc)).reshape(
            int(np.prod(batch_shape or (1,))),
            int(np.prod(lo_shape or (1,))), -1)
        ri = np.transpose(ri, list(rb) + rhs_other + list(rc)).reshape(
            int(np.prod(batch_shape or (1,))),
            int(np.prod(ro_shape or (1,))), -1)
        elems = []
        for b in range(li.shape[0]):
            for i in range(li.shape[1]):
                for j in range(ri.shape[1]):
                    acc = None
                    for k in range(li.shape[2]):
                        t = lhs.elems[li[b, i, k]] * rhs.elems[ri[b, j, k]]
                        acc = t if acc is None else acc + t
                    elems.append(acc)
        return [ScalarArray(out_shape, elems)]
    if name == "iota":
        shape = tuple(params["shape"])
        dim = params["dimension"]
        idx = np.indices(shape)[dim].astype(np.dtype(params["dtype"]))
        return [ScalarArray(shape, list(idx.reshape(-1)))]
    if name == "platform_index":
        # platform-specialized lowering dispatch (e.g. cholesky has a
        # 'mosaic' branch): resolve to the default (None) entry — we
        # scalarize the generic primitives ourselves
        platforms = params["platforms"]
        idx = (platforms.index(None) if None in platforms
               else len(platforms) - 1)
        return [ScalarArray((), [int(idx)])]
    if name == "cholesky":
        a = args[0]
        if len(a.shape) != 2 or a.shape[0] != a.shape[1]:
            raise NotImplementedError(
                f"scalarize cholesky: shape {a.shape} (2-D square only)")
        n = a.shape[0]
        A = [[a.elems[i * n + j] for j in range(n)] for i in range(n)]
        L = [[0.0] * n for _ in range(n)]
        # unrolled Cholesky-Banachiewicz: every element plain arithmetic
        for i in range(n):
            for j in range(i + 1):
                s = A[i][j]
                for k in range(j):
                    s = s - L[i][k] * L[j][k]
                L[i][j] = jnp.sqrt(s) if i == j else s / L[j][j]
        return [ScalarArray((n, n),
                            [L[i][j] for i in range(n) for j in range(n)])]
    if name == "triangular_solve":
        a, b = args
        if len(a.shape) != 2 or len(b.shape) not in (1, 2):
            raise NotImplementedError(
                f"scalarize triangular_solve: shapes {a.shape}, {b.shape}")
        n = a.shape[0]
        lower = params["lower"]
        trans = params["transpose_a"]
        left = params["left_side"]
        unit = params["unit_diagonal"]
        A = [[a.elems[i * n + j] for j in range(n)] for i in range(n)]
        if trans:
            A = [[A[j][i] for j in range(n)] for i in range(n)]
            lower = not lower
        b_shape = b.shape
        if len(b_shape) == 1:
            if not left:
                raise NotImplementedError(
                    "scalarize triangular_solve: 1-D b with "
                    "left_side=False (lax always emits left_side for "
                    "vector solves)")
            B = [[b.elems[i]] for i in range(n)]
            m = 1
        elif left:
            m = b_shape[1]
            B = [[b.elems[i * m + j] for j in range(m)] for i in range(n)]
        else:
            # X A = B  <=>  A^T X^T = B^T
            m = b_shape[0]
            B = [[b.elems[j * n + i] for j in range(m)] for i in range(n)]
            A = [[A[j][i] for j in range(n)] for i in range(n)]
            lower = not lower
        X = [[None] * m for _ in range(n)]
        rows = range(n) if lower else range(n - 1, -1, -1)
        for i in rows:
            for c in range(m):
                s = B[i][c]
                ks = range(i) if lower else range(i + 1, n)
                for k in ks:
                    s = s - A[i][k] * X[k][c]
                X[i][c] = s if unit else s / A[i][i]
        if len(b_shape) == 1:
            elems = [X[i][0] for i in range(n)]
        elif left:
            elems = [X[i][c] for i in range(n) for c in range(m)]
        else:
            elems = [X[i][c] for c in range(m) for i in range(n)]
        return [ScalarArray(b_shape, elems)]
    if name == "gather":
        a, ind = args
        from jax.core import Tracer
        if any(isinstance(e, Tracer) for e in ind.elems):
            raise NotImplementedError(
                "gather with TRACED indices in the x-dependent part of "
                "logp is not scalarizable; use the XLA path")
        # static indices: run the gather eagerly on an element-id array to
        # get the element mapping, then permute the ScalarArray
        ids = np.arange(max(a.size, 1)).reshape(a.shape)
        ind_arr = np.asarray([np.asarray(e) for e in ind.elems],
                             dtype=np.int64).reshape(ind.shape)
        with jax.ensure_compile_time_eval():
            mapping = np.asarray(jax.lax.gather(
                ids, ind_arr, params["dimension_numbers"],
                params["slice_sizes"],
                unique_indices=params.get("unique_indices", False),
                indices_are_sorted=params.get("indices_are_sorted", False),
                mode=params.get("mode")))
        return [ScalarArray(mapping.shape,
                            [a.elems[i] for i in mapping.reshape(-1)])]
    raise NotImplementedError(
        f"scalarize: primitive '{name}' not supported; use the XLA path "
        "instead")
