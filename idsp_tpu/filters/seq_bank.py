"""Sequential lane bank: one GPU kernel for every per-lane recurrence.

A fixed-point recurrence (DF1, PLL, lowpass, ...) quantizes inside its
feedback loop, so time stays serial; its only parallelism is across
lanes (channels x I/Q).  XLA runs `lax.scan` over time as a device
while-loop, at least one kernel launch per iteration.  This harness
runs the whole time loop inside one Pallas kernel (Triton route):

* the grid walks blocks of lanes, which are independent and run in
  parallel on the SMs;
* the time loop is a `fori_loop` inside the block, the state stays in
  registers, integer arithmetic is native i64;
* the input rows of the next loop chunk are loaded while the current
  chunk computes (a software pipeline one chunk deep), so the global
  load latency hides behind the serial arithmetic;
* a keep-1-in-``dec`` output store replaces a separate decimation pass;
* lanes are masked, so any lane count works.

The per-step body is the family's own scan step, e.g.
``functools.partial(biquad.df1_step_q, ba, f)``.  It is traced once per
lane (state leaves without their lane axis, a scalar input) and the
resulting jaxpr is re-evaluated in the kernel with every per-lane array
held as a Python array of lane vectors (`_Lifter`).  The kernel therefore
runs the very primitives of the scan step, element by element, and is
bit-exact with `lax.scan` by construction on integer paths.  Float paths
may differ in the last bits: the GPU compiler may contract ``a*b + c``
into one FMA.

`seq_bank` always runs the kernel (``interpret=True`` runs it on the
CPU for tests); `idsp_tpu.dispatch.lane_scan` picks it or `lax.scan`
from the platform.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

# Primitives that act element by element; `_lift` maps them over lanes.
_ELEMENTWISE = frozenset(
    """abs add and atan2 cbrt ceil clamp clz convert_element_type cos div
    eq exp exp2 floor ge gt integer_pow is_finite le log log1p logistic lt
    max min mul ne neg nextafter not or population_count pow rem round
    rsqrt select_n shift_left shift_right_arithmetic shift_right_logical
    sign sin sqrt square sub tan tanh xor copy copy_p""".split()
)
# nested jitted functions (e.g. `jnp.clip`), evaluated inline
_CALLS = ("jit", "pjit")

# Lanes per block: one warp.  The loop is latency-bound, so small blocks
# spread the serial chains over the most SMs; 32, 64 and 128 lanes per
# block measured alike at 1024 and 2048 lanes.
BLOCK = 32


def chunk_steps(dec: int, target: int = 32) -> int:
    """Time steps per loop iteration: a multiple of ``dec`` (one output
    row on a static slot every ``dec`` steps) and at least ``target``,
    enough serial work to cover the prefetch of the next chunk's rows."""
    return dec * max(1, -(-target // dec))


# --- per-lane jaxpr evaluation over lane vectors -----------------------------


def _obj(shape, fill=None):
    out = np.empty(shape, dtype=object)
    if fill is not None:
        for idx in np.ndindex(*shape):
            out[idx] = fill(idx)
    return out


def _const(val):
    """A constant as an object array of numpy scalars."""
    arr = np.asarray(val)
    return _obj(arr.shape, lambda idx: arr[idx])


def _high_unsigned(e) -> bool:
    dt = np.dtype(e.dtype)
    return dt.kind == "u" and bool(int(e) >> (8 * dt.itemsize - 1))


class _Lifter:
    """Evaluates a per-lane jaxpr where every value is an object array
    of the per-lane shape whose elements are lane vectors (shape
    ``(block,)``) or numpy scalars (trace-time constants)."""

    def __init__(self, block: int):
        self.block = block

    def lane(self, e, dtype):
        """Element -> a (block,) vector of ``dtype``.

        An unsigned constant with its top bit set is splat from the
        signed type of its width and bitcast: the Triton lowering emits
        integer constants as signed values."""
        if isinstance(e, np.generic) and _high_unsigned(e):
            signed = np.asarray(e).view(np.dtype(f"i{e.dtype.itemsize}"))
            e = lax.bitcast_convert_type(
                jnp.full((self.block,), signed), e.dtype)
        if isinstance(e, np.generic) or e.shape == ():
            return jnp.full((self.block,), e, dtype)
        return e if e.dtype == dtype else e.astype(dtype)

    def _bind(self, prim, params, elems):
        if any(not isinstance(e, np.generic) or _high_unsigned(e)
               for e in elems):
            elems = [self.lane(e, e.dtype) for e in elems]
        else:
            elems = [jnp.asarray(e) for e in elems]
        out = prim.bind(*elems, **params)
        if isinstance(out, (list, tuple)):
            return list(out)
        return [out]

    def eval(self, jaxpr, consts, args):
        env = {}

        def read(v):
            if isinstance(v, jax.extend.core.Literal):
                return _const(v.val)
            return env[v]

        for v, c in zip(jaxpr.constvars, consts):
            env[v] = _const(c)
        for v, a in zip(jaxpr.invars, args):
            env[v] = a
        for eqn in jaxpr.eqns:
            ins = [read(v) for v in eqn.invars]
            outs = self.eqn(eqn, ins)
            for v, o in zip(eqn.outvars, outs):
                env[v] = o
        return [read(v) for v in jaxpr.outvars]

    def eqn(self, eqn, ins):
        name = eqn.primitive.name
        p = eqn.params
        out_avals = [v.aval for v in eqn.outvars]
        if name in _CALLS:
            closed = p["jaxpr"]
            return self.eval(closed.jaxpr, closed.consts, ins)
        if name in _ELEMENTWISE:
            shape = out_avals[0].shape
            ins = np.broadcast_arrays(*ins) if len(ins) > 1 else ins
            outs = [_obj(shape) for _ in out_avals]
            for idx in np.ndindex(*shape):
                vals = self._bind(eqn.primitive, p, [a[idx] for a in ins])
                for o, val in zip(outs, vals):
                    o[idx] = val
            return outs
        x = ins[0]
        if name == "slice":
            strides = p["strides"] or (1,) * x.ndim
            idx = tuple(
                slice(s, e, st) for s, e, st in
                zip(p["start_indices"], p["limit_indices"], strides)
            )
            return [x[idx]]
        if name in ("squeeze", "reshape"):
            return [np.reshape(x, out_avals[0].shape)]
        if name == "broadcast_in_dim":
            shape = p["shape"]
            tmp = [1] * len(shape)
            for src, dst in enumerate(p["broadcast_dimensions"]):
                tmp[dst] = x.shape[src]
            return [np.broadcast_to(np.reshape(x, tmp), shape).copy()]
        if name == "concatenate":
            return [np.concatenate(ins, axis=p["dimension"])]
        raise NotImplementedError(
            f"seq_bank: primitive {name!r} is not lane-elementwise"
        )


# --- the kernel --------------------------------------------------------------


def _storage(dtype):
    """Kernel-side dtype of a state leaf (bool rides as i32)."""
    return jnp.dtype(jnp.int32) if dtype == jnp.bool_ else jnp.dtype(dtype)


def _kernel(*refs, closed, n_leaves, leaf_shapes, leaf_dtypes, y_dtypes,
            t, c, block, dec, chunk):
    x_ref = refs[0]
    st_refs = refs[1:1 + n_leaves]
    y_refs = refs[1 + n_leaves:1 + n_leaves + len(y_dtypes)]
    st_out_refs = refs[1 + n_leaves + len(y_dtypes):]

    start = pl.program_id(0) * block
    mask = start + lax.broadcasted_iota(jnp.int32, (block,), 0) < c
    lanes = pl.ds(start, block)

    # row indices are i32 like the lane start (x64 would make Python
    # ints i64, and the two index types must agree)
    def load(ref, row):
        row = jnp.asarray(row, jnp.int32)
        return plt.load(ref.at[row, lanes], mask=mask, other=0)

    def store(ref, row, val):
        row = jnp.asarray(row, jnp.int32)
        plt.store(ref.at[row, lanes], val, mask=mask)

    lift = _Lifter(block)
    sizes = [math.prod(s) for s in leaf_shapes]

    def unflat(cols):
        leaves, k = [], 0
        for shape, n, dt in zip(leaf_shapes, sizes, leaf_dtypes):
            obj = _obj((n,))
            for j in range(n):
                v = cols[k + j]
                obj[j] = v != 0 if dt == jnp.bool_ else v
            leaves.append(obj.reshape(shape))
            k += n
        return leaves

    def flat(leaves):
        cols = []
        for obj, dt in zip(leaves, leaf_dtypes):
            for e in obj.reshape(-1):
                cols.append(lift.lane(e, _storage(dt)) if dt != jnp.bool_
                            else lift.lane(e, jnp.bool_).astype(jnp.int32))
        return tuple(cols)

    def step(cols, x):
        outs = lift.eval(
            closed.jaxpr, closed.consts, unflat(cols) + [_obj((), lambda _: x)]
        )
        new_cols = flat(outs[:n_leaves])
        ys = [lift.lane(o[()], dt) for o, dt in zip(outs[n_leaves:], y_dtypes)]
        return new_cols, ys

    def emit(row, ys):
        for ref, y in zip(y_refs, ys):
            store(ref, row, y)

    # Each loop iteration runs ``chunk`` steps (a multiple of ``dec``)
    # and loads the next chunk's input rows at its top, so the loads are
    # in flight while the chunk's serial arithmetic runs.  The rows past
    # the last chunk are the tail's, prefetched the same way.
    n_chunks, tail = divmod(t, chunk)
    cols0 = tuple(
        load(ref, k) for ref, n in zip(st_refs, sizes) for k in range(n)
    )
    xs0 = tuple(load(x_ref, min(u, t - 1)) for u in range(chunk))

    def run(cols, rows, base):
        for u, x in enumerate(rows):
            cols, ys = step(cols, x)
            if u % dec == 0:
                emit(base // dec + u // dec, ys)
        return cols

    def body(j, carry):
        cols, rows = carry
        base = j * chunk
        nxt = tuple(
            load(x_ref, jnp.minimum(base + (chunk + u), t - 1))
            for u in range(chunk)
        )
        return run(cols, rows, base), nxt

    cols, rows = lax.fori_loop(
        jnp.int32(0), jnp.int32(n_chunks), body, (cols0, xs0)
    )
    cols = run(cols, rows[:tail], n_chunks * chunk)
    k = 0
    for ref, n in zip(st_out_refs, sizes):
        for j in range(n):
            store(ref, j, cols[k + j])
        k += n


def seq_bank(step, carry, xs, *, dec: int = 1, out_dtype=None,
             interpret: bool = False):
    """Run ``step`` over time, lanes in parallel, in one GPU kernel.

    Same result as::

        carry, ys = lax.scan(step, carry, xs)
        ys = ys[::dec]            # cast to out_dtype when given

    Args:
      step: ``step(carry, x) -> (carry, y)``, elementwise over lanes
        (every bank step of this package is).  Coefficients are closed
        over as trace-time constants, or carried in ``carry`` when they
        are runtime data (they then pass through unchanged).
      carry: pytree whose leaves have the lane shape ``xs.shape[1:]``
        as their leading axes.
      xs: (t, *lanes) input; t % dec == 0.
      dec: keep-1-in-``dec`` output decimation.  The carried state is
        the full-rate recurrence, exact.
      out_dtype: optional cast of every output leaf.

    Returns (carry, ys), each ys leaf (t // dec, *lanes).
    """
    leaves, treedef = jax.tree.flatten(carry)
    return _seq_bank(
        step, treedef, tuple(leaves), xs, dec=int(dec),
        out_dtype=None if out_dtype is None else jnp.dtype(out_dtype),
        interpret=bool(interpret),
    )


@functools.partial(
    jax.jit,
    static_argnames=("step", "treedef", "dec", "out_dtype", "interpret",
                     "chunk"),
)
def _seq_bank(step, treedef, leaves, xs, *, dec, out_dtype, interpret,
              chunk=None):
    t = xs.shape[0]
    lanes_shape = xs.shape[1:]
    nl = len(lanes_shape)
    c = math.prod(lanes_shape)
    assert dec >= 1 and t % dec == 0, (t, dec)
    for leaf in leaves:
        assert leaf.shape[:nl] == lanes_shape, (leaf.shape, lanes_shape)

    # trace the step once per lane: leaves without the lane axes, scalar x
    lane_leaves = [
        jax.ShapeDtypeStruct(leaf.shape[nl:], leaf.dtype) for leaf in leaves
    ]
    closed, (new_carry, y_shape) = jax.make_jaxpr(
        lambda ls, x: step(jax.tree.unflatten(treedef, ls), x),
        return_shape=True,
    )(lane_leaves, jax.ShapeDtypeStruct((), xs.dtype))
    new_leaves, new_treedef = jax.tree.flatten(new_carry)
    if new_treedef != treedef or [
        (a.shape, a.dtype) for a in new_leaves
    ] != [(a.shape, a.dtype) for a in lane_leaves]:
        raise TypeError("seq_bank: step changes the carry's structure")
    y_leaves, y_treedef = jax.tree.flatten(y_shape)
    if any(y.shape != () for y in y_leaves):
        raise TypeError("seq_bank: step outputs must be scalar per lane")
    y_dtypes = tuple(
        jnp.dtype(y.dtype) if out_dtype is None else out_dtype
        for y in y_leaves
    )

    leaf_shapes = tuple(leaf.shape[nl:] for leaf in leaves)
    leaf_dtypes = tuple(jnp.dtype(leaf.dtype) for leaf in leaves)
    # state leaf -> (columns, lanes): one row per per-lane element
    st_in = [
        leaf.reshape(c, -1).T.astype(_storage(leaf.dtype)) for leaf in leaves
    ]
    vma = getattr(jax.typeof(xs), "vma", None)

    def sds(shape, dtype):
        return jax.ShapeDtypeStruct(shape, dtype, vma=vma)

    kernel = functools.partial(
        _kernel, closed=closed, n_leaves=len(leaves),
        leaf_shapes=leaf_shapes, leaf_dtypes=leaf_dtypes, y_dtypes=y_dtypes,
        t=t, c=c, block=BLOCK, dec=dec,
        # Interpret mode runs one output row per iteration by default: it
        # exists to be compared with `lax.scan` on the CPU, and XLA:CPU
        # contracts float multiply-adds across a longer unrolled chunk
        # differently from the scan (integer paths are exact either way).
        chunk=chunk or (dec if interpret else chunk_steps(dec)),
    )
    outs = pl.pallas_call(
        kernel,
        out_shape=[sds((t // dec, c), dt) for dt in y_dtypes]
        + [sds(s.shape, s.dtype) for s in st_in],
        grid=(pl.cdiv(c, BLOCK),),
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=1, num_stages=1),
        interpret=interpret,
        name=f"seq_bank_{getattr(step, '__name__', None) or _name(step)}",
    )(xs.reshape(t, c), *st_in)
    ys = outs[:len(y_dtypes)]
    st_out = outs[len(y_dtypes):]
    new = [
        (s.T if leaf.dtype != jnp.bool_ else s.T != 0)
        .astype(leaf.dtype).reshape(leaf.shape)
        for s, leaf in zip(st_out, leaves)
    ]
    ys = [y.reshape((t // dec,) + lanes_shape) for y in ys]
    return jax.tree.unflatten(treedef, new), jax.tree.unflatten(y_treedef, ys)


def _name(step) -> str:
    fn = getattr(step, "func", None)
    return getattr(fn, "__name__", "step")
