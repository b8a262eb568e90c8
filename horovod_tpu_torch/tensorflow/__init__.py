"""TensorFlow binding shim — the reference ``horovod.tensorflow`` API
surface over the port's eager engine (the port's copy of
``horovod_tpu/tensorflow/__init__.py``).

Reference: horovod/tensorflow/__init__.py (allreduce :54-154,
DistributedOptimizer :465-561, DistributedGradientTape :564-629),
horovod/tensorflow/functions.py:47-135 (broadcast_variables),
horovod/keras + horovod/_keras (callbacks, create_distributed_optimizer).

Role: host-side TF components during a migration — tf.data pipelines,
Keras evaluation, legacy TF training scripts. Tensors cross at the numpy
boundary: a TF tensor becomes a torch tensor on this process's device
(``device()``: the GPU unless ``init(device="cpu")``), the port's
collective runs on it, and this rank's result comes back through numpy
in the caller's dtype. As in every port surface, one process is one
rank: ``allgather``, ``broadcast``, ``alltoall`` and ``reducescatter``
follow reference Horovod's per-rank semantics. Integer and float64
tensors reduce at their full width (the JAX package computes them in 32
bits).

Inside a ``tf.function`` each collective is a ``tf.py_function`` that
runs the engine call when the graph executes. The port's engine issues a
collective when it is called, so every rank must issue in the same
order: each graph chains its collectives by control dependencies in the
order they were traced, and one lock keeps two TF threads from issuing
at once.
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np

import horovod_tpu_torch as _hvd
from ..common.basics import export_capability_queries as _ecq
from ..common.host_bridge import to_numpy as _to_numpy
from ..common.host_bridge import to_torch as _to_torch
from ..ops.collectives import ReduceOp

# re-exported basics (reference tensorflow/__init__.py surface)
init = _hvd.init
shutdown = _hvd.shutdown
is_initialized = _hvd.is_initialized
rank = _hvd.rank
size = _hvd.size
local_rank = _hvd.local_rank
local_size = _hvd.local_size
cross_rank = _hvd.cross_rank
cross_size = _hvd.cross_size
Average, Sum, Adasum, Min, Max, Product = (
    _hvd.Average, _hvd.Sum, _hvd.Adasum, _hvd.Min, _hvd.Max, _hvd.Product)
Compression = _hvd.Compression
# graceful early exit (reference tensorflow join, operations.cc:1085-1109)
join = _hvd.join
# capability queries (reference TF re-exports of basics.py:160-258)
_ecq(globals())

# One TF-thread at a time issues a collective (see the module docstring).
_issue_lock = threading.RLock()


def _tf():
    import tensorflow as tf

    return tf


def _no_autograph(fn):
    """Keep autograph out of the shim: the "kernel" is Python engine
    code, and letting autograph convert it is slow and fragile. Applied
    lazily so importing the shim does not import tensorflow."""
    import functools

    cell = []

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if not cell:  # convert once, off the per-op hot path
            cell.append(
                _tf().autograph.experimental.do_not_convert(fn))
        return cell[0](*args, **kwargs)

    return wrapper


def _communicator_size(process_set=None) -> int:
    return size() if process_set is None else process_set.size()


def _run(np_fn, *arrays):
    with _issue_lock:
        return np_fn(*arrays)


def _chained(make):
    """Build a graph op with ``make()`` after the previous collective
    traced into the same graph (a control dependency), and record it as
    the graph's last one."""
    tf = _tf()
    graph = tf.compat.v1.get_default_graph()
    last = getattr(graph, "_hvd_tpu_torch_last", None)
    with tf.control_dependencies([last] if last is not None else []):
        out = make()
    first = out[0] if isinstance(out, (list, tuple)) else out
    graph._hvd_tpu_torch_last = first
    return out


# -- collectives (reference tensorflow/__init__.py:54-208) ------------------

def _bridge(np_fn, tensor, out_shape=None):
    """Run ``np_fn(numpy_array) -> numpy_array`` against a TF tensor in
    either eager or graph context. Inside a tf.function the call bridges
    through py_function so the engine collective runs at execution time —
    the role the reference's registered TF ops play
    (tensorflow/mpi_ops.cc HorovodAllreduceOp)."""
    tf = _tf()
    if tf.is_tensor(tensor) and not tf.executing_eagerly():
        out = _chained(lambda: tf.py_function(
            lambda t: _run(np_fn, t.numpy()), [tensor], tensor.dtype))
        out.set_shape(out_shape if out_shape is not None else tensor.shape)
        return out
    return tf.convert_to_tensor(_run(np_fn, np.asarray(tensor)))


def _allreduce_np(arr: np.ndarray, op: ReduceOp, name: Optional[str],
                  prescale_factor: float, postscale_factor: float,
                  compression=None, process_set=None) -> np.ndarray:
    out = _hvd.allreduce(_to_torch(arr), op, name,
                         prescale_factor=prescale_factor,
                         postscale_factor=postscale_factor,
                         compression=compression, process_set=process_set)
    return _to_numpy(out, arr.dtype)


@_no_autograph
def allreduce(tensor, op: ReduceOp = Average, name: Optional[str] = None,
              prescale_factor: float = 1.0, postscale_factor: float = 1.0,
              compression=None, sparse_as_dense: bool = False,
              process_set=None):
    """Dense allreduce; a tf.IndexedSlices input takes the
    SPARSE-AS-ALLGATHER path (reference tensorflow/__init__.py:92-108):
    values and indices are allgathered (ranks may hold different numbers
    of slices) — the mathematical equivalent of summing the sparse
    gradients — with AVERAGE dividing the gathered values by the
    communicator's size. ``sparse_as_dense=True`` densifies first
    instead (the reference's DistributedOptimizer knob)."""
    tf = _tf()
    if isinstance(tensor, tf.IndexedSlices):
        if sparse_as_dense:
            return allreduce(tf.convert_to_tensor(tensor), op, name,
                             prescale_factor, postscale_factor,
                             compression, process_set=process_set)
        if op not in (Average, Sum):
            raise NotImplementedError(
                "sparse allreduce supports Average/Sum (reference "
                "tensorflow/__init__.py:101)")
        n = _communicator_size(process_set)
        gathered = []
        for part, leaf in (("values", tensor.values),
                           ("indices", tensor.indices)):
            arr = np.asarray(leaf)
            gathered.append(tf.convert_to_tensor(_run(
                lambda a: _to_numpy(_hvd.allgatherv(
                    _to_torch(a), name=f"{name or 'sparse'}.{part}",
                    process_set=process_set), a.dtype), arr)))
        values, indices = gathered
        if op == Average:
            values = values / n
        return tf.IndexedSlices(values, indices,
                                dense_shape=tensor.dense_shape)
    return _bridge(
        lambda a: _allreduce_np(a, op, name, prescale_factor,
                                postscale_factor, compression,
                                process_set), tensor)


def _grouped_allreduce_np(arrs, op: ReduceOp, name: Optional[str],
                          compression=None, prescale_factor=1.0,
                          postscale_factor=1.0, process_set=None):
    """Fused grouped reduction through the engine's bucketed
    ``grouped_allreduce`` (one collective per fusion bucket, not one per
    tensor)."""
    outs = _hvd.grouped_allreduce([_to_torch(a) for a in arrs], op, name,
                                  compression, prescale_factor,
                                  postscale_factor, process_set)
    return [_to_numpy(o, a.dtype) for o, a in zip(outs, arrs)]


@_no_autograph
def grouped_allreduce(tensors, op: ReduceOp = Average,
                      name: Optional[str] = None, compression=None,
                      prescale_factor: float = 1.0,
                      postscale_factor: float = 1.0, process_set=None):
    tf = _tf()
    tensors = list(tensors)
    if not tensors:
        return []

    def np_fn(*arrs):
        return _grouped_allreduce_np(list(arrs), op, name, compression,
                                     prescale_factor, postscale_factor,
                                     process_set)

    if any(tf.is_tensor(t) for t in tensors) and not tf.executing_eagerly():
        outs = _chained(lambda: tf.py_function(
            lambda *ts: _run(np_fn, *[t.numpy() for t in ts]),
            tensors, [t.dtype for t in tensors]))
        for o, t in zip(outs, tensors):
            o.set_shape(t.shape)
        return list(outs)
    return [tf.convert_to_tensor(o) for o in _run(
        np_fn, *[np.asarray(t) for t in tensors])]


@_no_autograph
def allgather(tensor, name: Optional[str] = None, process_set=None):
    """Every rank's tensor (one shape on every rank) concatenated along
    dim 0 in rank order (reference allgather)."""
    tf = _tf()

    def np_fn(arr):
        return _to_numpy(_hvd.allgather(_to_torch(arr), name,
                                        process_set=process_set), arr.dtype)

    gather_n = _communicator_size(process_set)
    out_shape = None
    if tf.is_tensor(tensor) and tensor.shape.rank and \
            tensor.shape[0] is not None:
        out_shape = tf.TensorShape(
            [tensor.shape[0] * gather_n]).concatenate(tensor.shape[1:])
    return _bridge(np_fn, tensor, out_shape)


@_no_autograph
def reducescatter(tensor, op: Optional[ReduceOp] = None,
                  name: Optional[str] = None, process_set=None):
    """This rank's 1/n slice (dim 0) of the elementwise reduction over
    ranks. The default op is Average, upstream's reducescatter
    default."""
    tf = _tf()

    def np_fn(arr):
        return _to_numpy(_hvd.reducescatter(_to_torch(arr), op, name,
                                            process_set=process_set),
                         arr.dtype)

    n = _communicator_size(process_set)
    out_shape = None
    if tf.is_tensor(tensor) and tensor.shape.rank and \
            tensor.shape[0] is not None:
        if tensor.shape[0] % n != 0:
            # Fail loudly instead of declaring a floor-divided static
            # shape that silently disagrees with the engine.
            raise ValueError(
                f"reducescatter dim 0 ({tensor.shape[0]}) must be "
                f"divisible by the communicator size ({n})")
        out_shape = tf.TensorShape(
            [tensor.shape[0] // n]).concatenate(tensor.shape[1:])
    return _bridge(np_fn, tensor, out_shape)


@_no_autograph
def grouped_allgather(tensors, name: Optional[str] = None,
                      process_set=None):
    # name=None passes through per leaf: the engine auto-names each
    # uniquely (a constant default prefix would collide across calls).
    return [allgather(t, f"{name}.{i}" if name else None,
                      process_set=process_set)
            for i, t in enumerate(tensors)]


@_no_autograph
def grouped_reducescatter(tensors, op: Optional[ReduceOp] = None,
                          name: Optional[str] = None, process_set=None):
    return [reducescatter(t, op, f"{name}.{i}" if name else None,
                          process_set=process_set)
            for i, t in enumerate(tensors)]


@_no_autograph
def broadcast(tensor, root_rank: int = 0, name: Optional[str] = None,
              process_set=None):
    """``root_rank``'s tensor on every rank. With ``process_set``,
    ``root_rank`` is the GLOBAL rank of the root."""
    return _bridge(
        lambda arr: _to_numpy(_hvd.broadcast(
            _to_torch(arr), root_rank, name, process_set=process_set),
            arr.dtype),
        tensor)


@_no_autograph
def alltoall(tensor, name: Optional[str] = None, process_set=None):
    """Dim 0 in n equal chunks, chunk ``j`` to rank ``j``; returns the
    chunks received, in source-rank order."""
    return _bridge(
        lambda arr: _to_numpy(_hvd.alltoall(_to_torch(arr), name,
                                            process_set=process_set),
                              arr.dtype),
        tensor)


def broadcast_variables(variables, root_rank: int = 0,
                        process_set=None) -> None:
    """In-place assign of root's values onto tf.Variables (reference
    tensorflow/functions.py:47 broadcast_variables). Handles both
    tf.Variable (.value() method) and keras-3 Variable (.value
    property) via convert_to_tensor."""
    tf = _tf()
    for i, v in enumerate(variables):
        v.assign(broadcast(tf.convert_to_tensor(v), root_rank,
                           name=f"bcast.{getattr(v, 'name', i)}",
                           process_set=process_set))


broadcast_object = _hvd.broadcast_object
allgather_object = _hvd.allgather_object


def BroadcastGlobalVariablesHook(root_rank: int = 0, device: str = "",
                                 process_set=None):
    """TF1 estimator/MonitoredSession hook (reference
    tensorflow/__init__.py:211-244): broadcasts ALL global variables
    from ``root_rank`` right after session creation, so every worker
    starts from identical state under random init or a root-only
    checkpoint restore.

    Factory returning a ``tf.compat.v1.train.SessionRunHook`` instance
    (a factory, not a module-level class, because the shim loads TF
    lazily). The values round-trip through the port's broadcast at
    ``after_create_session`` and re-enter the graph through
    placeholder-fed assigns. ``device`` is accepted for API parity and
    ignored (the port's collectives run on ``device()``).

    Usage (drop-in):
        hooks = [hvd.BroadcastGlobalVariablesHook(0)]
        with tf.compat.v1.train.MonitoredTrainingSession(
                hooks=hooks, ...) as sess: ...
    """
    tf = _tf()
    v1 = tf.compat.v1

    class _BroadcastGlobalVariablesHook(v1.train.SessionRunHook):
        def __init__(self):
            self.root_rank = root_rank
            self._vars = []
            self._placeholders = []
            self._assigns = []

        def begin(self):
            # Graph-build time: one placeholder-fed assign per global
            # variable (ops must exist before the session finalizes the
            # graph — MonitoredSession forbids post-begin graph edits).
            self._vars = list(v1.global_variables())
            self._placeholders = [
                v1.placeholder(v.dtype.base_dtype, v.shape)
                for v in self._vars]
            self._assigns = [
                v1.assign(v, ph)
                for v, ph in zip(self._vars, self._placeholders)]

        def after_create_session(self, session, coord):
            values = session.run(self._vars)
            for i, (var, ph, assign, val) in enumerate(
                    zip(self._vars, self._placeholders, self._assigns,
                        values)):
                arr = np.asarray(val)
                out = _run(lambda a: _to_numpy(_hvd.broadcast(
                    _to_torch(a), self.root_rank,
                    name=f"v1hook.{getattr(var, 'name', i)}",
                    process_set=process_set), a.dtype), arr)
                session.run(assign,
                            feed_dict={ph: out.reshape(arr.shape)})

    return _BroadcastGlobalVariablesHook()


# -- DistributedGradientTape (reference tensorflow/__init__.py:564-629) -----

class _DistributedGradientTape:
    def __init__(self, tape, op: ReduceOp = Average,
                 compression=None, process_set=None):
        self._tape = tape
        self._op = op
        self._compression = compression
        self._process_set = process_set

    def __getattr__(self, item):
        return getattr(self._tape, item)

    def __enter__(self):
        self._tape.__enter__()
        return self

    def __exit__(self, *exc):
        return self._tape.__exit__(*exc)

    def gradient(self, target, sources, output_gradients=None, **kwargs):
        """Same contract as tf.GradientTape.gradient (structure of the
        result mirrors ``sources``; extra kwargs like
        unconnected_gradients pass through), with every gradient
        allreduced via the fused grouped path."""
        tf = _tf()
        grads = self._tape.gradient(target, sources, output_gradients,
                                    **kwargs)
        flat = tf.nest.flatten(grads)
        present = [(i, g) for i, g in enumerate(flat) if g is not None]
        if present:
            reduced = grouped_allreduce([g for _, g in present],
                                        op=self._op, name="tape.grads",
                                        compression=self._compression,
                                        process_set=self._process_set)
            for (i, _), r in zip(present, reduced):
                flat[i] = r
        return tf.nest.pack_sequence_as(grads, flat)


def DistributedGradientTape(tape, op: ReduceOp = Average,
                            compression=None,
                            process_set=None) -> _DistributedGradientTape:
    return _DistributedGradientTape(tape, op, compression, process_set)


# -- Keras optimizer wrapper (reference _keras/__init__.py:28-135) ----------

def _reduce_grads_and_vars(gv, reduce_op, name_prefix,
                           sparse_as_dense=False,
                           gradient_predivide_factor=1.0,
                           process_set=None):
    """Reduce a grads_and_vars list: dense grads through ONE fused
    grouped allreduce, IndexedSlices through the sparse-as-allgather
    path (reference _make_allreduce_grads_fn semantics, incl. the
    predivide split: scale by 1/f before the SUM and f/size after —
    size being the communicator's, i.e. the set's when one is given)."""
    tf = _tf()
    pre = post = 1.0
    sparse_op = reduce_op
    if gradient_predivide_factor != 1.0:
        f = gradient_predivide_factor
        n = _communicator_size(process_set)
        # Dense path: split the average around a SUM. The sparse
        # (allgather) path keeps the original AVERAGE — predivide is a
        # dense-reduction scaling trick and must not turn gathered
        # slices into an unscaled sum.
        reduce_op, pre, post = Sum, 1.0 / f, f / n
    gv = [list(x) for x in gv]
    dense = [(i, g) for i, (g, _) in enumerate(gv)
             if g is not None and not isinstance(g, tf.IndexedSlices)]
    sparse = [(i, g) for i, (g, _) in enumerate(gv)
              if isinstance(g, tf.IndexedSlices)]
    if dense:
        reduced = grouped_allreduce([g for _, g in dense],
                                    op=reduce_op,
                                    name=f"{name_prefix}.grads",
                                    prescale_factor=pre,
                                    postscale_factor=post,
                                    process_set=process_set)
    else:
        reduced = []
    for (i, _), r in zip(dense, reduced):
        gv[i][0] = r
    for i, g in sparse:
        gv[i][0] = allreduce(g, op=sparse_op,
                             name=f"{name_prefix}.sparse{i}",
                             sparse_as_dense=sparse_as_dense,
                             process_set=process_set)
    return [tuple(x) for x in gv]


def DistributedOptimizer(optimizer, op: ReduceOp = Average,
                         name: Optional[str] = None,
                         backward_passes_per_step: int = 1,
                         average_aggregated_gradients: bool = False,
                         sparse_as_dense: bool = False,
                         gradient_predivide_factor: float = 1.0,
                         process_set=None):
    """Wrap a keras optimizer so apply_gradients allreduces first. Like
    the reference (_keras/__init__.py:28-135 create_distributed_optimizer)
    this dynamically subclasses the optimizer's own class and rebuilds it
    from config — keras requires a genuine Optimizer instance in
    compile().

    ``backward_passes_per_step > 1`` aggregates that many local
    apply_gradients calls before one fused allreduce + global apply (the
    LocalGradientAggregationHelper, reference
    tensorflow/gradient_aggregation.py:16 /
    gradient_aggregation_eager.py); ``average_aggregated_gradients``
    divides the aggregate by the pass count (reference default False:
    aggregated passes SUM unless asked to average).
    ``gradient_predivide_factor`` splits averaging around the sum —
    1/f before, f/size after (reference tensorflow/__init__.py:487)."""
    if gradient_predivide_factor != 1.0 and op != Average:
        raise ValueError(
            "gradient_predivide_factor requires op=Average (reference "
            "tensorflow/__init__.py:507)")
    cls = optimizer.__class__
    reduce_op = op
    k = int(backward_passes_per_step)

    def apply_gradients(self, grads_and_vars, *args, **kwargs):
        tf = _tf()
        gv = list(grads_and_vars)
        if k > 1:
            if not tf.executing_eagerly():
                # Graph mode: Python counters would only advance at TRACE
                # time, baking one branch into the graph — so the state
                # lives in tf.Variables and the flush is a tf.cond (the
                # reference's LocalGradientAggregationHelper,
                # gradient_aggregation.py:16).
                return self._hvd_graph_aggregate(gv, args, kwargs)
            # Eager helper semantics (gradient_aggregation_eager.py):
            # bank the grads; reduce+apply on the k-th call.
            if not hasattr(self, "_hvd_agg"):
                self._hvd_agg = {}
                self._hvd_agg_count = 0
            for i, (g, _) in enumerate(gv):
                if g is None:
                    continue
                if isinstance(g, tf.IndexedSlices):
                    g = tf.convert_to_tensor(g)
                acc = self._hvd_agg.get(i)
                self._hvd_agg[i] = g if acc is None else acc + g
            self._hvd_agg_count += 1
            if self._hvd_agg_count < k:
                return None
            scale = 1.0 / k if average_aggregated_gradients else 1.0
            gv = [list(x) for x in gv]
            for i, acc in self._hvd_agg.items():
                gv[i][0] = acc * scale
            gv = [tuple(x) for x in gv]
            self._hvd_agg = {}
            self._hvd_agg_count = 0
        reduced = _reduce_grads_and_vars(gv, reduce_op, "opt",
                                         sparse_as_dense,
                                         gradient_predivide_factor,
                                         process_set)
        return super(dist_cls, self).apply_gradients(reduced, *args,
                                                     **kwargs)

    def _hvd_graph_aggregate(self, gv, fwd_args, fwd_kwargs):
        """tf.Variable-backed local aggregation for traced (tf.function)
        apply_gradients — accumulate every call, tf.cond-flush through
        the fused reduce on the k-th (reference
        gradient_aggregation.py)."""
        tf = _tf()
        variables = [v for _, v in gv]
        if not hasattr(self, "_hvd_agg_vars"):
            with tf.init_scope():
                self._hvd_counter = tf.Variable(
                    0, dtype=tf.int64, trainable=False,
                    name="hvd_agg_counter")
                # Accumulators only for connected (non-None) gradients —
                # a None gradient stays None through the flush, matching
                # the eager path (an all-zeros stand-in would still move
                # momentum/weight-decay state on untouched variables).
                self._hvd_agg_idx = [i for i, (g, _) in enumerate(gv)
                                     if g is not None]
                self._hvd_agg_vars = [
                    tf.Variable(tf.zeros(gv[i][1].shape,
                                         dtype=gv[i][0].dtype),
                                trainable=False, name="hvd_agg")
                    for i in self._hvd_agg_idx]
                self._hvd_agg_var_ids = [id(v) for v in variables]
        if [id(v) for v in variables] != self._hvd_agg_var_ids:
            raise ValueError(
                "apply_gradients called with a different variable list "
                "than the first call; local gradient aggregation keys "
                "its accumulators to a stable grads_and_vars order")
        assigns = []
        for acc, i in zip(self._hvd_agg_vars, self._hvd_agg_idx):
            g = gv[i][0]
            if g is None:
                continue
            if isinstance(g, tf.IndexedSlices):
                g = tf.convert_to_tensor(g)
            assigns.append(acc.assign_add(tf.cast(g, acc.dtype)))
        with tf.control_dependencies(assigns):
            count = self._hvd_counter.assign_add(1)

        def _flush():
            scale = (1.0 / k) if average_aggregated_gradients else 1.0
            grads = [None] * len(gv)
            for acc, i in zip(self._hvd_agg_vars, self._hvd_agg_idx):
                grads[i] = tf.convert_to_tensor(acc) * scale
            reduced = _reduce_grads_and_vars(
                list(zip(grads, variables)), reduce_op, "opt",
                sparse_as_dense, gradient_predivide_factor, process_set)
            result = super(dist_cls, self).apply_gradients(
                reduced, *fwd_args, **fwd_kwargs)
            # Order the zeroing after the apply for v1-graph fetches
            # too: control_dependencies accepts Operations as well as
            # Tensors, so gate only on None.
            deps = [result] if result is not None else []
            with tf.control_dependencies(deps):
                zeros = [acc.assign(tf.zeros_like(acc))
                         for acc in self._hvd_agg_vars]
            with tf.control_dependencies(zeros):
                return tf.constant(True)

        return tf.cond(tf.equal(count % k, 0), _flush,
                       lambda: tf.constant(False))

    dist_cls = type(f"Distributed{cls.__name__}", (cls,),
                    {"apply_gradients": apply_gradients,
                     "_hvd_graph_aggregate": _hvd_graph_aggregate})
    return dist_cls.from_config(optimizer.get_config())


def _DistributedAdasumOptimizer(optimizer, name: Optional[str] = None):
    """Delta-based Adasum optimizer (reference
    tensorflow/__init__.py:368-462 _DistributedAdasumOptimizer): each
    rank applies the inner optimizer LOCALLY, extracts the resulting
    weight delta, rolls the weights back, Adasum-reduces the delta, and
    applies the reduced delta — so the adaptive-summation math sees
    optimizer-shaped steps, not raw gradients."""
    cls = optimizer.__class__

    def apply_gradients(self, grads_and_vars, *args, **kwargs):
        tf = _tf()
        gv = list(grads_and_vars)
        variables = [v for _, v in gv]
        before = [tf.identity(v) for v in variables]
        result = super(adasum_cls, self).apply_gradients(gv, *args,
                                                         **kwargs)
        deltas = [v - b for v, b in zip(variables, before)]
        reduced = grouped_allreduce(deltas, op=Adasum,
                                    name="adasum.delta")
        for v, b, d in zip(variables, before, reduced):
            v.assign(b + d)
        return result

    adasum_cls = type(f"DistributedAdasum{cls.__name__}", (cls,),
                      {"apply_gradients": apply_gradients})
    return adasum_cls.from_config(optimizer.get_config())


# -- Keras callbacks (reference keras/callbacks.py) -------------------------

def _keras_callback_base():
    import tensorflow as tf

    return tf.keras.callbacks.Callback


def BroadcastGlobalVariablesCallback(root_rank: int = 0):
    """Keras callback: broadcast all model/optimizer variables from root
    at train start (reference _keras/callbacks.py
    BroadcastGlobalVariablesCallbackImpl)."""
    Base = _keras_callback_base()

    class _Cb(Base):
        def __init__(self):
            super().__init__()
            self._done = False

        def on_train_begin(self, logs=None):
            if self._done:
                return
            broadcast_variables(self.model.variables, root_rank)
            self._done = True

    return _Cb()


def MetricAverageCallback():
    """Keras callback: allreduce-average epoch metrics (reference
    _keras/callbacks.py MetricAverageCallbackImpl)."""
    Base = _keras_callback_base()

    class _Cb(Base):
        def on_epoch_end(self, epoch, logs=None):
            if not logs:
                return
            for k, v in list(logs.items()):
                if isinstance(v, (int, float, np.floating)):
                    out = allreduce(np.full((), float(v), np.float32),
                                    op=Average, name=f"metric.{k}")
                    logs[k] = float(np.asarray(out))

    return _Cb()


def _set_keras_lr(optimizer, lr: float) -> None:
    # keras 3 uses .learning_rate; tf.keras 2 accepts either name.
    attr = ("learning_rate" if hasattr(optimizer, "learning_rate")
            else "lr")
    setattr(optimizer, attr, lr)


def LearningRateScheduleCallback(initial_lr: float, multiplier,
                                 start_epoch: int = 0,
                                 end_epoch: Optional[int] = None,
                                 staircase: bool = True,
                                 steps_per_epoch: Optional[int] = None):
    """Keras callback: lr = initial_lr * multiplier(epoch) within
    [start_epoch, end_epoch] (reference _keras/callbacks.py
    LearningRateScheduleCallbackImpl — the smooth/staircase contract of
    the port's ``callbacks.py``)."""
    import math

    Base = _keras_callback_base()
    mult = multiplier if callable(multiplier) else (lambda _e: multiplier)

    class _Cb(Base):
        def __init__(self):
            super().__init__()
            self._epoch = 0.0

        def _in_range(self):
            return (self._epoch >= start_epoch
                    and (end_epoch is None or self._epoch <= end_epoch))

        def _apply(self):
            if self._in_range():
                _set_keras_lr(self.model.optimizer,
                              initial_lr * mult(self._epoch))

        def on_epoch_begin(self, epoch, logs=None):
            self._epoch = float(epoch)
            if staircase or not steps_per_epoch:
                self._apply()

        def on_batch_begin(self, batch, logs=None):
            if not staircase and steps_per_epoch:
                self._epoch = math.floor(self._epoch) + \
                    batch / steps_per_epoch
                self._apply()

    return _Cb()


def LearningRateWarmupCallback(initial_lr: float, warmup_epochs: int = 5,
                               steps_per_epoch: Optional[int] = None,
                               verbose: int = 0):
    """Keras callback: Goyal et al. gradual warmup from initial_lr/size
    to initial_lr over warmup_epochs, inert afterwards (reference
    _keras/callbacks.py LearningRateWarmupCallbackImpl)."""
    n = size()

    def mult(epoch: float) -> float:
        progress = min(epoch / warmup_epochs, 1.0)
        return (1.0 + progress * (n - 1)) / n

    cb = LearningRateScheduleCallback(
        initial_lr, mult, start_epoch=0, end_epoch=warmup_epochs,
        staircase=False, steps_per_epoch=steps_per_epoch)

    if verbose:
        orig = cb.on_epoch_begin

        def on_epoch_begin(epoch, logs=None):
            orig(epoch, logs)
            if epoch == warmup_epochs:
                print(f"Epoch {epoch}: finished gradual learning rate "
                      f"warmup to {initial_lr}.")

        cb.on_epoch_begin = on_epoch_begin
    return cb


def BestModelCheckpoint(filepath: str, monitor: str = "val_loss",
                        mode: str = "auto", save_best_only: bool = True,
                        **kwargs):
    """Keras ModelCheckpoint that only rank 0 writes (reference
    keras/callbacks.py:157 BestModelCheckpoint: save_best_only rank-0
    writer). The decision metric must already be rank-consistent (use
    MetricAverageCallback before it)."""
    tf = _tf()
    if not save_best_only:
        raise ValueError(
            "BestModelCheckpoint requires save_best_only=True "
            "(reference keras/callbacks.py BestModelCheckpoint)")

    class _Cb(tf.keras.callbacks.ModelCheckpoint):
        def _save_model(self, *args, **kw):
            if rank() == 0:
                super()._save_model(*args, **kw)

    return _Cb(filepath=filepath, monitor=monitor, mode=mode,
               save_best_only=True, **kwargs)
