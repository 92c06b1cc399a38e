"""Logical-axis sharding rules (port of ``repro.dist.sharding``).

Every parameter records the logical axis names of its dimensions
(``embed``, ``mlp``, ``heads``, ...) as ``logical_axes`` when its module
builds it (``models.layers.param``), with the tuple the reference boxes
its leaf with.  :func:`axes_of` and :func:`unbox` give them, and the
tensors, under the reference tree's dotted keys
(``models.convert.reference_groups``), a leaf stacked over its layers
with the reference's leading layer axis (``None``, as ``stack_init``
prepends it).

``ShardingRules`` maps logical axes to mesh axes; ``spec`` resolves an
axes tuple to a :class:`PartitionSpec`, dropping mesh axes absent from
the mesh (e.g. ``pod`` on a single-pod run) and deduplicating mesh axes
that an earlier dimension already consumed (GSPMD allows each mesh axis
at most once per spec).  :func:`local_shape` is the per-device shard of
a shape under a spec, rounded up as GSPMD pads an uneven split.

Placement is DTensor's (``torch.distributed.tensor``), GSPMD's
counterpart: :func:`placements` turns a spec into one ``Shard(dim)`` or
``Replicate()`` per mesh axis, :func:`distribute` places a module's
parameters by their logical axes, :func:`place` a batch or cache leaf,
and :func:`gather` brings a placed tensor back whole.  They need a mesh
with a ``DeviceMesh`` (``launch.mesh``: a process group spans it).

``shard(x, *axes)``, the counterpart of ``with_sharding_constraint``,
is a no-op outside an ``axis_rules(mesh, rules)`` context.  Inside one
it checks that ``axes`` names every dimension of ``x``; on a mesh with
a ``DeviceMesh`` it redistributes ``x`` to its placements (a plain
tensor counts as replicated: every rank computed it alike), and on a
mesh of one device without one it returns ``x``.  A larger mesh that
no process group spans cannot place anything: it raises.

Not carried: the reference's ``P`` boxes and ``box_like`` re-box
plain arrays into pytrees; the port's parameters carry their axes
themselves, so there is nothing to box.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, Optional, Sequence, Tuple, Union

import torch
from torch import nn
from torch.distributed.tensor import (DTensor, Partial, Placement,
                                      Replicate, Shard, distribute_tensor)
from torch.distributed.tensor.experimental import (implicit_replication,
                                                   local_map)


Axis = Optional[str]
MeshAxes = Union[None, str, Tuple[str, ...]]


class PartitionSpec(tuple):
    """One entry per dimension: None (replicated), a mesh axis, or a
    tuple of mesh axes (as ``jax.sharding.PartitionSpec``)."""

    def __new__(cls, *entries: MeshAxes):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PartitionSpec{tuple(self)}"


def axes_of(module: nn.Module) -> Dict[str, Tuple[Axis, ...]]:
    """{reference key: the leaf's logical axes}; a stacked leaf's start
    with the layer axis None.  Raises if a stack's layers disagree."""
    from repro_torch.models.convert import reference_groups

    out = {}
    for key, (stacked, named) in reference_groups(module).items():
        distinct = {p.logical_axes for _, p in named}
        if len(distinct) != 1:
            raise ValueError(f"{key}: its layers' axes differ: {distinct}")
        (ax,) = distinct
        out[key] = ((None,) + ax) if stacked else ax
    return out


def unbox(module: nn.Module) -> Dict[str, torch.Tensor]:
    """{reference key: tensor}, a stacked leaf's layers stacked along a
    new leading axis (a copy; on the meta device, shapes only)."""
    from repro_torch.models.convert import reference_groups

    return {key: torch.stack([p for _, p in named]) if stacked
            else named[0][1]
            for key, (stacked, named) in reference_groups(module).items()}


class ShardingRules(dict):
    """logical axis -> mesh axis (or tuple of mesh axes, or None)."""

    def spec(self, axes: Sequence[Axis], mesh=None) -> PartitionSpec:
        mesh_axes = set(mesh.axis_names) if mesh is not None else None
        used = set()
        entries = []
        for ax in axes:
            mapped = self.get(ax) if ax is not None else None
            if mapped is None:
                entries.append(None)
                continue
            cand = (mapped,) if isinstance(mapped, str) else tuple(mapped)
            keep = [c for c in cand
                    if (mesh_axes is None or c in mesh_axes)
                    and c not in used]
            used.update(keep)
            if not keep:
                entries.append(None)
            elif len(keep) == 1:
                entries.append(keep[0])
            else:
                entries.append(tuple(keep))
        return PartitionSpec(*entries)


# Batch prefers (pod, data); params FSDP-shard embed over data and tensor-
# shard the wide dims over model.  Axes not listed stay replicated.
TRAIN_RULES = ShardingRules({
    "batch": ("pod", "data"),
    "embed": "data",
    "mlp": "model",
    "vocab": "model",
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "expert": "model",
    "expert_mlp": "model",
    "ssm_inner": "model",
    "ssm_heads": "model",
})

# Serving replicates small params, tensor-shards wide dims, and data-
# parallelizes the batch.
SERVE_RULES = ShardingRules({
    "batch": "data",
    "mlp": "model",
    "vocab": "model",
    "heads": "model",
    "kv_heads": "model",
    "expert": "model",
    "expert_mlp": "model",
    "ssm_inner": "model",
    "ssm_heads": "model",
})

# Long-context decode: context-parallel KV over data (callers override
# batch/kv_seq per shape; see launch/dryrun.rules_for).
LONG_CTX_RULES = ShardingRules({**SERVE_RULES, "batch": None,
                                "kv_seq": "data"})


def named_sharding_tree(axes: Dict[str, Tuple[Axis, ...]], mesh,
                        rules: ShardingRules) -> Dict[str, PartitionSpec]:
    """{key: the spec ``rules`` give its axes on ``mesh``}."""
    return {key: rules.spec(ax, mesh) for key, ax in axes.items()}


def local_shape(shape: Sequence[int], spec: PartitionSpec,
                mesh) -> Tuple[int, ...]:
    """The per-device shard of a ``shape`` tensor placed by ``spec`` on
    ``mesh``: each dimension divided by the sizes of its mesh axes,
    rounded up (GSPMD pads an uneven split)."""
    out = []
    for i, dim in enumerate(shape):
        entry = spec[i] if i < len(spec) else None
        names = () if entry is None else \
            (entry,) if isinstance(entry, str) else entry
        out.append(-(-dim // math.prod(mesh.shape[a] for a in names)))
    return tuple(out)


class _Context:
    """The active ``(mesh, rules)``, for the whole process: autograd runs
    a backward, and the forward that remat recomputes inside it, on its
    own device threads, which must see the constraints the step was
    traced under (the reference's context is per thread: JAX traces in
    the caller's)."""
    active = None


_ctx = _Context()


@contextlib.contextmanager
def axis_rules(mesh, rules: ShardingRules):
    """Activate ``shard``'s constraints for ``mesh`` (process-wide, as
    ``_Context`` says).  On a mesh with a ``DeviceMesh`` a placed step
    runs inside, so a plain
    tensor that every rank makes alike mid-step (the plain kernels'
    masks and tables, the SSD's chunk masks, the optimizer's scalars)
    meets a DTensor as a replicated one (DTensor's
    ``implicit_replication``)."""
    prev = _ctx.active
    _ctx.active = (mesh, rules)
    try:
        with (implicit_replication() if mesh.device_mesh is not None
              else contextlib.nullcontext()):
            yield
    finally:
        _ctx.active = prev


def placements(spec: PartitionSpec, mesh) -> Tuple[Placement, ...]:
    """One placement per axis of ``mesh``, in its order: ``Shard(d)`` for
    the tensor dimension d whose entry names the axis, else
    ``Replicate()``.  A dimension on several mesh axes (``batch`` on
    ``("pod", "data")``) is split by each, the first named the major
    one, as GSPMD splits it; DTensor splits a dimension in mesh order,
    so the entry's axes must come in that order."""
    names = tuple(mesh.axis_names)
    out = []
    for axis in names:
        dims = [i for i, e in enumerate(spec)
                if e == axis or (isinstance(e, tuple) and axis in e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    for entry in spec:
        if isinstance(entry, tuple) and \
                list(entry) != sorted(entry, key=names.index):
            raise ValueError(f"{entry}: a dimension's mesh axes must come "
                             f"in the mesh's order {names}")
    return tuple(out)


def _device_mesh(mesh):
    if mesh.device_mesh is None:
        raise ValueError(f"a mesh of {mesh.size} devices that no process "
                         f"group spans places nothing")
    return mesh.device_mesh


def place(x: torch.Tensor, mesh, rules: ShardingRules,
          axes: Sequence[Axis]) -> DTensor:
    """``x``, which every rank holds whole and alike, as a DTensor placed
    by the spec ``rules`` give ``axes`` (each rank keeps its chunk; no
    collective)."""
    if len(axes) != x.ndim:
        raise ValueError(f"axes {tuple(axes)} do not name the {x.ndim} "
                         f"dimensions of a {tuple(x.shape)} tensor")
    return distribute_tensor(x, _device_mesh(mesh),
                             placements(rules.spec(axes, mesh), mesh),
                             src_data_rank=None)


def clear_propagation_cache() -> None:
    """Empty DTensor's cache of op placements.  It keys an op by its
    arguments' placements and shapes but not by every argument that
    sets its output's shape (``topk``'s k, in torch 2.13), so a model
    placed after another with another top-k would read the first one's
    shapes: :func:`distribute` clears it."""
    prop = DTensor._op_dispatcher.sharding_propagator
    prop.propagate_op_sharding.cache_clear()
    prop._propagate_tensor_meta_cached.cache_clear()
    torch._C._clear_DTensor_sharding_propagator_cache()


class _GatherOnUse:
    """Mixed into a placed module's class by :func:`distribute`: reading
    a parameter split over an axis the batch is split over (the train
    rules' ``embed`` over ``data``: FSDP) returns it gathered over that
    axis inside ``axis_rules``, as GSPMD gathers it for its products,
    and its gradient is reduce-scattered back.  Without the gather
    DTensor may instead split a product over its contraction, which
    gathers the activations and repeats their FLOPs on every device.
    A lookup table (``table``: embeddings read by rows) is not
    gathered: each device looks up its own columns."""

    def __getattr__(self, name):
        value = super().__getattr__(name)
        active = _ctx.active
        if active is None or not isinstance(value, DTensor):
            return value
        mesh, rules = active
        if getattr(value, "table", False):
            return value
        batch = rules.get("batch")
        batch = {batch} if isinstance(batch, str) else set(batch or ())
        want = tuple(Replicate() if axis in batch else pl
                     for axis, pl in zip(mesh.axis_names, value.placements))
        if want == tuple(value.placements):
            return value
        return _Gathered.apply(value, want)


class _Gathered(torch.autograd.Function):
    """A parameter redistributed to ``want`` (gathered over the batch
    axes), its gradient, a partial sum over those axes, reduce-scattered
    back onto the parameter's placements: GSPMD's FSDP collectives,
    asked for here rather than left to DTensor's backward."""

    @staticmethod
    def forward(ctx, p, want):
        ctx.placements = tuple(p.placements)
        return p.redistribute(p.device_mesh, want)

    @staticmethod
    def backward(ctx, grad):
        return grad.redistribute(grad.device_mesh, ctx.placements), None


def _gathering(cls):
    if issubclass(cls, _GatherOnUse):
        return cls
    return type(cls.__name__, (_GatherOnUse, cls), {})


def distribute(module: nn.Module, mesh, rules: ShardingRules) -> nn.Module:
    """Place every parameter of ``module`` by its ``logical_axes``, in
    place (each becomes a DTensor parameter that keeps its axes and its
    ``requires_grad``, and its module gathers it on use as
    :class:`_GatherOnUse` says); returns ``module``.  Every rank must
    hold the same weights, as a seeded ``model.init`` draws them."""
    clear_propagation_cache()
    for mod in module.modules():
        for name, p in list(mod._parameters.items()):
            if p is None or isinstance(p.data, DTensor):
                continue
            d = nn.Parameter(place(p.detach(), mesh, rules, p.logical_axes),
                             requires_grad=p.requires_grad)
            d.__dict__.update(p.__dict__)       # logical_axes, table
            mod._parameters[name] = d
        if mod._parameters:
            mod.__class__ = _gathering(type(mod))
    return module


def is_placed(x) -> bool:
    """Whether ``x`` is a DTensor (placed on a mesh)."""
    return isinstance(x, DTensor)


def place_tree(tree: Dict, axes: Dict, mesh, rules: ShardingRules) -> Dict:
    """:func:`place` on every leaf of a nested dict, by the axes tree of
    the same structure (a batch, a decode cache)."""
    return {k: place_tree(v, axes[k], mesh, rules) if isinstance(v, dict)
            else place(v, mesh, rules, axes[k]) for k, v in tree.items()}


def placed_like(ref: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``x`` (a gradient) placed as ``ref`` (its parameter): DTensor
    leaves a gradient a partial sum over the axes its batch was split
    on, and this is where it is reduced (all-reduce, or reduce-scatter
    onto a split parameter)."""
    if isinstance(x, DTensor) and tuple(x.placements) != \
            tuple(ref.placements):
        return x.redistribute(ref.device_mesh, ref.placements)
    return x


class _ContiguousGrad(torch.autograd.Function):
    """Identity whose gradient is made contiguous: a shard's gradient out
    of ``local_map`` may be strided (an einsum's), and DTensor's view
    ops on it (the backward of a reshape) need it contiguous."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad.contiguous()


def _local_layout(x, batch, heads):
    """x's placements if each mesh axis splits only its ``batch`` or
    ``heads`` dimension (or nothing), else None."""
    kept = [Replicate()] + [Shard(d) for d in (batch, heads) if d is not None]
    return tuple(x.placements) if all(p in kept for p in x.placements) \
        else None


def on_shards(name: str, fn, lead, args, dims, outs, strict: bool = False):
    """``fn(*args)`` on each device's local shards (``local_map``), for an
    op that is local over its batch and its heads (attention, the SSD
    scan, a depthwise conv).  ``dims`` gives each of ``args`` its (batch
    dim, heads dim), either None where it has none, ``outs`` each
    output's; ``lead`` is the placed argument whose layout decides.  An
    axis that splits lead's batch or heads splits each argument's own
    (an argument without that dim is replicated over it); an axis that
    splits neither gathers any argument split over it (K/V over their
    sequence).  Where lead is split otherwise (a head_dim), ``strict``
    raises (a kernel on the card takes no other placement); else ``fn``
    runs on the DTensors, which DTensor partitions itself."""
    b0, h0 = dims[0]
    layout = _local_layout(lead, b0, h0)
    if layout is None:
        if strict:
            raise ValueError(f"{name}: placement {tuple(lead.placements)} "
                             f"is not one the kernel takes (a split of "
                             f"the batch or of the heads)")
        return fn(*args)

    def per_arg(b, h, missing=Replicate()):
        return tuple(Shard(b) if p == Shard(b0) and b is not None
                     else Shard(h) if p == Shard(h0) and h is not None
                     else missing if p != Replicate()
                     else Replicate() for p in layout)

    mesh = lead.device_mesh
    in_pl = tuple(per_arg(b, h) for b, h in dims)
    # an argument whole over an axis that splits the work (the SSD's B and
    # C over the heads, a conv's weights over the batch) gets a partial
    # gradient from each shard: summed over that axis
    grad_pl = tuple(per_arg(b, h, Partial()) for b, h in dims)
    out_pl = tuple(per_arg(b, h) for b, h in outs)
    args = tuple(a if isinstance(a, DTensor) else
                 DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim,
                                    run_check=False) for a in args)
    args = tuple(a if tuple(a.placements) == pl
                 else a.redistribute(mesh, pl)
                 for a, pl in zip(args, in_pl))

    def local(*shards):
        return fn(*(_ContiguousGrad.apply(t) if t.requires_grad else t
                    for t in shards))

    # one output's placements as a list: local_map reads a tuple as one
    # entry per output
    wrapped = local_map(local, out_placements=out_pl if len(outs) > 1
                        else list(out_pl[0]), in_placements=in_pl,
                        in_grad_placements=grad_pl, device_mesh=mesh)
    return wrapped(*args)


def _summed(x):
    """``x`` with its partial sums all-reduced (``Partial`` ->
    ``Replicate``), else ``x``."""
    if not any(p.is_partial() for p in x.placements):
        return x
    return x.redistribute(x.device_mesh, [Replicate() if p.is_partial()
                                          else p for p in x.placements])


class _Reduced(torch.autograd.Function):
    """:func:`reduced` (``forward`` True) or :func:`reduced_grad`: the
    gradient's partial sums all-reduced, and with ``forward`` x's."""

    @staticmethod
    def forward(ctx, x, forward):
        out = _summed(x) if forward else x
        return out.view_as(out) if out is x else out

    @staticmethod
    def backward(ctx, grad):
        return _summed(grad), None


def reduced(x):
    """``x`` with any partial sum it holds all-reduced (``Partial`` ->
    ``Replicate``), and its gradient alike: the collective GSPMD emits
    where a product contracts over a split dimension and an op that is
    not linear follows (attention's Q K^T over a split head_dim, a norm's
    mean over split channels).  Asked for here rather than left to
    DTensor, whose choice depends on the torch version (2.11
    all-reduces, 2.13 reduce-scatters, or re-splits the other operand
    by an all-to-all).  Anything not placed as it is; a placed ``x``
    that has no gradient as :func:`_summed` gives it."""
    if not isinstance(x, DTensor):
        return x
    if not x.requires_grad:
        return _summed(x)
    return _Reduced.apply(x, True)


def reduced_grad(x):
    """``x`` as it is, its gradient's partial sums all-reduced: GSPMD's
    collective where a tensor whole over an axis meets one split over it
    in a product (a norm's output feeding a projection that contracts
    over a split dimension, the SSM gate norm's scale meeting its split
    channels), which leaves the gradient a partial sum; DTensor would
    reduce it wherever an op next needs it whole, which the torch
    version decides.  Anything without a gradient as it is."""
    if not isinstance(x, DTensor) or not x.requires_grad:
        return x
    return _Reduced.apply(x, False)


class _Product(torch.autograd.Function):
    """:func:`product`'s ``x @ w`` with ``w``'s gradient formed split by
    its rows over ``axes`` (mesh dims over which both operands are
    whole)."""

    @staticmethod
    def forward(ctx, x, w, axes):
        ctx.save_for_backward(x, w)
        ctx.axes = axes
        return x @ w

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx = dy @ w.T if ctx.needs_input_grad[0] else None
        # each device its own rows of w's gradient: x split by its last
        # dimension over the axes (a local slice: x is whole there)
        xs = x.redistribute(x.device_mesh, [
            Shard(x.ndim - 1) if i in ctx.axes else p
            for i, p in enumerate(x.placements)])
        dw = xs.reshape(-1, w.shape[0]).T @ dy.reshape(-1, w.shape[1])
        return dx, dw, None


def product(x, w):
    """``x @ w`` for a weight ``w`` (2-D).  Placed in a step that trains,
    where a mesh axis splits neither operand (both whole on every device
    of it: attention's projections where the head_dim, not the heads, is
    split), the forward and x's gradient are formed whole, as GSPMD
    forms them, but w's gradient x^T dy is formed split by w's rows over
    that axis, each device its own rows, and gathered back where w is
    read: GSPMD's partitioned program forms no device's copy of that
    product whole either.  Anything else: ``x @ w``."""
    if not (isinstance(x, DTensor) and isinstance(w, DTensor)
            and torch.is_grad_enabled() and w.requires_grad):
        return x @ w
    axes = tuple(i for i, (a, b) in enumerate(zip(x.placements,
                                                   w.placements))
                 if a == Replicate() and b == Replicate()
                 and x.device_mesh.size(i) > 1)
    if not axes:
        return x @ w
    return _Product.apply(x, w, axes)


def gather(x):
    """A placed tensor as a plain tensor every rank holds whole (a
    collective where it is split; differentiable: its gradient returns
    to the placement), for host copies and checks; anything else as it
    is."""
    return x.full_tensor() if isinstance(x, DTensor) else x


def row_axes(x: DTensor, name: str) -> Tuple[int, ...]:
    """The mesh dims that split ``x``'s rows (dim 0), in mesh order.
    Raises where an axis splits another dimension or holds a partial
    sum: work on each device's own rows (``row_pieces``) takes neither."""
    if any(p not in (Replicate(), Shard(0)) for p in x.placements):
        raise ValueError(f"{name}: placement {tuple(x.placements)} is not "
                         f"one a split of the rows takes")
    return tuple(i for i, p in enumerate(x.placements) if p == Shard(0))


def row_pieces(counts: torch.Tensor, x: DTensor,
               name: str) -> Tuple[torch.Tensor, int]:
    """``counts``, a plain (n,) tensor this device computed from its own
    rows of ``x``, all-gathered over the mesh axes that split the rows:
    an (R, n) plain tensor, a row a piece in the rows' order, and the
    index of this device's piece.  A row split's pieces are contiguous
    in mesh order, the first axis major (DTensor's and GSPMD's), so
    ``every[:r].sum(0)`` counts what the rows before this piece hold."""
    mesh = x.device_mesh
    axes = row_axes(x, name)
    pl = [Shard(0) if i in axes else Replicate() for i in range(mesh.ndim)]
    R, n = math.prod(mesh.size(i) for i in axes), counts.numel()
    every = DTensor.from_local(counts[None], mesh, pl, run_check=False,
                               shape=(R, n), stride=(n, 1)).full_tensor()
    coord, r = mesh.get_coordinate(), 0
    for i in axes:
        r = r * mesh.size(i) + coord[i]
    return every, r


def chunk(n: int, parts: int, j: int) -> Tuple[int, int]:
    """[lo, hi) of chunk j of a dimension of n split in ``parts`` (DTensor's
    chunks: ceil(n / parts) each, the last ones short or empty)."""
    size = -(-n // parts)
    return min(j * size, n), min((j + 1) * size, n)


def _exchange(rows: torch.Tensor, send, recv, n: int, add: bool,
              group) -> torch.Tensor:
    """One all-to-all over ``group``: the row ranges ``send[j]`` of
    ``rows`` (dim 0) go to device j in that order, and what device i
    sends lands in the row ranges ``recv[i]`` of an ``n``-row result,
    written, or with ``add`` summed into zeros (ranges may repeat)."""
    from torch.distributed._functional_collectives import \
        all_to_all_single

    data = all_to_all_single(
        torch.cat([rows[:0]] + [rows[lo:hi] for ranges in send
                                for lo, hi in ranges]),
        [sum(hi - lo for lo, hi in ranges) for ranges in recv],
        [sum(hi - lo for lo, hi in ranges) for ranges in send], group)
    out = (rows.new_zeros if add else rows.new_empty)(
        (n,) + tuple(rows.shape[1:]))
    at = 0
    for ranges in recv:
        for lo, hi in ranges:
            if add:
                out[lo:hi] += data[at:at + hi - lo]
            else:
                out[lo:hi] = data[at:at + hi - lo]
            at += hi - lo
    return out


class _Take(torch.autograd.Function):
    """:func:`take`'s all-to-all on the local rows (dim 0), with its
    gradient: the same all-to-all reversed, each piece's gradient sent
    back to the device it came from and added at the piece's place (a
    range two devices took gets the sum of both)."""

    @staticmethod
    def forward(ctx, rows, send, recv, n, group):
        ctx.plan = (rows.shape[0], send, recv, group)
        return _exchange(rows, send, recv, n, False, group)

    @staticmethod
    def backward(ctx, grad):
        m, send, recv, group = ctx.plan
        return _exchange(grad, recv, send, m, True, group), None, None, \
            None, None


def take(x: DTensor, dim: int, want, name: str) -> torch.Tensor:
    """The pieces of ``x``'s dimension ``dim`` that ``want(j)`` names for
    the device at coordinate j of the one mesh axis that splits ``dim``
    (a list of global ``(lo, hi)`` ranges), laid end to end in that
    order, as this device's plain local tensor.  One all-to-all over
    that axis, each device sending each other only the parts of its
    chunk they want: GSPMD's collective-permute of a dimension split
    anew, where a DTensor slice across chunk bounds gathers the whole
    dimension.  The sizes follow from the shape and the mesh alone.
    Differentiable: the gradient returns by the reverse all-to-all
    (:class:`_Take`) to ``x``'s placements."""
    mesh = x.device_mesh
    axes = [i for i, p in enumerate(x.placements) if p == Shard(dim)]
    if len(axes) != 1 or any(p.is_partial() for p in x.placements):
        raise ValueError(f"{name}: placement {tuple(x.placements)} does "
                         f"not split dim {dim} over one mesh axis, or "
                         f"holds a partial sum")
    (a,) = axes
    parts, n = mesh.size(a), x.shape[dim]
    me = mesh.get_coordinate()[a]

    def clip(lo, hi, i):
        """[lo, hi) within chunk i (possibly empty)."""
        lo_i, hi_i = chunk(n, parts, i)
        lo = min(max(lo, lo_i), hi_i)
        return lo, max(lo, min(hi, hi_i))

    own = chunk(n, parts, me)[0]
    send = [[(lo - own, hi - own) for lo, hi in
             (clip(lo, hi, me) for lo, hi in want(j))] for j in range(parts)]
    # each wanted range in turn, its piece from each device in turn
    recv, at = [[] for _ in range(parts)], 0
    for lo, hi in want(me):
        for i in range(parts):
            lo_i, hi_i = clip(lo, hi, i)
            recv[i].append((at, at + hi_i - lo_i))
            at += hi_i - lo_i
    local = x.to_local().movedim(dim, 0)
    return _Take.apply(local, send, recv, at, (mesh, a)).movedim(0, dim)


def constraint(*axes: Axis) -> Tuple[Placement, ...]:
    """The placements ``shard(x, *axes)`` gives ``x`` under the active
    rules (which must be on a mesh with a ``DeviceMesh``)."""
    mesh, rules = _ctx.active
    return placements(rules.spec(axes, mesh), mesh)


def from_pieces(local: torch.Tensor, mesh, pl: Sequence[Placement],
                shape: Sequence[int]) -> DTensor:
    """``local``, this device's piece of a ``shape`` tensor placed by
    ``pl`` (over a ``Partial()`` axis a term of a sum), as a DTensor;
    differentiable, its gradient returned in ``pl`` (replicated over a
    partial axis: each term's gradient is the sum's)."""
    return _FromPieces.apply(local, mesh, tuple(pl), torch.Size(shape))


class _FromPieces(torch.autograd.Function):
    """:func:`from_pieces`, its gradient redistributed to the pieces'
    placements (a partial sum all-reduced, or reduce-scattered onto a
    split) by the port rather than by DTensor's backward."""

    @staticmethod
    def forward(ctx, local, mesh, pl, shape):
        ctx.mesh, ctx.want = mesh, tuple(Replicate() if p.is_partial()
                                         else p for p in pl)
        stride = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))
        return DTensor.from_local(local, mesh, pl, run_check=False,
                                  shape=shape, stride=stride)

    @staticmethod
    def backward(ctx, grad):
        if tuple(grad.placements) != ctx.want:
            grad = grad.redistribute(ctx.mesh, ctx.want)
        return grad.to_local(), None, None, None


class _Constrain(torch.autograd.Function):
    """``x`` redistributed to ``want``, and its gradient too, as GSPMD
    constrains a cotangent like its primal.  ``redistribute``'s own
    backward returns the gradient to ``x``'s placements, a partial sum
    where ``x`` was one, which the producer's backward then gathers
    around instead of reducing."""

    @staticmethod
    def forward(ctx, x, mesh, want):
        ctx.mesh, ctx.want = mesh, want
        if tuple(x.placements) == want:
            return x.view_as(x)
        return x.redistribute(mesh, want)

    @staticmethod
    def backward(ctx, grad):
        if tuple(grad.placements) != ctx.want:
            grad = grad.redistribute(ctx.mesh, ctx.want)
        return grad, None, None


class _Unflatten(torch.autograd.Function):
    """``x.view(shape)`` whose gradient is first put back in the view's
    own placements: torch 2.11's DTensor refuses the backward's flatten
    of a dimension a constraint split after the view (K/V's head_dim)."""

    @staticmethod
    def forward(ctx, x, shape):
        out = x.view(shape)
        ctx.shape, ctx.placements = x.shape, tuple(out.placements)
        return out

    @staticmethod
    def backward(ctx, grad):
        if tuple(grad.placements) != ctx.placements:
            grad = grad.redistribute(grad.device_mesh, ctx.placements)
        return grad.reshape(ctx.shape), None


def unflatten(x: torch.Tensor, *shape: int) -> torch.Tensor:
    """``x.view(shape)``, through :class:`_Unflatten` where placed."""
    if not isinstance(x, DTensor):
        return x.view(shape)
    return _Unflatten.apply(x, shape)


def shard(x: torch.Tensor, *axes: Axis) -> torch.Tensor:
    """``x``, whose dimensions ``axes`` names, placed by the active
    rules; no-op without an active ``axis_rules`` context.  Raises
    unless ``axes`` names every dimension, and on a mesh of more than
    one device that no process group spans."""
    active = _ctx.active
    if active is None:
        return x
    mesh, rules = active
    if len(axes) != x.ndim:
        raise ValueError(f"axes {axes} do not name the {x.ndim} dimensions "
                         f"of a {tuple(x.shape)} tensor")
    if mesh.device_mesh is None and mesh.size == 1:
        return x
    dm = _device_mesh(mesh)
    want = placements(rules.spec(axes, mesh), mesh)
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, dm, [Replicate()] * dm.ndim,
                               run_check=False)
    # through _Constrain even where x is placed so already: its gradient
    # must be constrained too
    return _Constrain.apply(x, dm, want)


def replicated_like(ref: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``x``, a tensor every rank makes alike mid-step (positions, masks,
    tables), replicated on ``ref``'s mesh when ``ref`` is placed, so
    that it meets ``ref``'s operands as a DTensor; else ``x``."""
    if not isinstance(ref, DTensor) or isinstance(x, DTensor):
        return x
    mesh = ref.device_mesh
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)
