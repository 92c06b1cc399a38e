"""``dist.sharding.take``, the all-to-all that splits a dimension anew, and
its gradient, on fake process groups.

A fake group moves no data, so each rank of a 1-D mesh runs in a thread
of its own: the mesh's coordinate is the thread's rank, and the one
collective ``take`` issues (``all_to_all_single``) is carried out
between the threads.  Each rank's pieces are held to slices of the
whole tensor, and x's gradient (the reverse all-to-all, added into each
rank's chunk) to the gradient of those slices by autograd, exactly
(float64).  The ranges cross chunk bounds, are taken by several ranks,
twice by one rank, or are empty, over chunks that are uneven or empty.
The same check on 4 gloo processes is ``tests/test_torch_placement.py``
(``test_gloo_take_gradient_equals_slicing``).
"""
import threading
from unittest import mock

import pytest
import torch
from torch.distributed import _functional_collectives as fc
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import DTensor, Shard

from repro_torch.dist import sharding as sh
from repro_torch.launch.mesh import fake_group

torch.set_num_threads(1)

TIMEOUT_S = 60           # a rank's wait at the exchange, and its join


def _wants(n: int):
    """What rank j takes of a dimension of n: across chunk bounds, what
    other ranks take too, an empty range and one range twice."""
    def want(j):
        lo = min(j, n - 1)
        return [(0, min(4, n)), (lo, min(lo + 5, n)), (n, n),
                (lo, min(lo + 2, n)), (lo, min(lo + 2, n))]
    return want


class _Ranks:
    """The ranks of a fake group as threads: ``all_to_all_single`` between
    them, and each thread's own coordinate on the mesh."""

    def __init__(self, world: int):
        self.world, self.local = world, threading.local()
        self.barrier = threading.Barrier(world, timeout=TIMEOUT_S)
        self.box, self.calls = {}, []

    def all_to_all_single(self, x, out_sizes, in_sizes, group, tag=""):
        me = self.local.rank
        self.box[me] = list(x.split(list(in_sizes)))
        self.calls.append((me, list(in_sizes), list(out_sizes)))
        self.barrier.wait()
        got = [self.box[i][me] for i in range(self.world)]
        assert [g.shape[0] for g in got] == list(out_sizes)
        self.barrier.wait()
        return torch.cat(got)

    def run(self, fn):
        """fn(rank) on every rank, each in its thread; the results."""
        out, errors = [None] * self.world, []

        def body(rank):
            self.local.rank = rank
            try:
                out[rank] = fn(rank)
            except BaseException as e:      # re-raised below
                errors.append(e)
                self.barrier.abort()

        threads = [threading.Thread(target=body, args=(r,))
                   for r in range(self.world)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(TIMEOUT_S)
        assert not any(t.is_alive() for t in threads), "a rank hung"
        if errors:
            raise errors[0]
        return out


def _reference(x, ups, want, world):
    x = x.clone().requires_grad_(True)
    outs = [torch.cat([x[lo:hi] for lo, hi in want(j)])
            for j in range(world)]
    sum((o * u).sum() for o, u in zip(outs, ups)).backward()
    return [o.detach() for o in outs], x.grad


@pytest.mark.parametrize("dim", [0, 1])
@pytest.mark.parametrize("world,n", [(4, 10), (4, 5), (2, 7), (3, 9)])
def test_take_and_its_gradient_equal_slicing(world, n, dim):
    want = _wants(n)
    g = torch.Generator().manual_seed(world * 100 + n)
    whole = torch.randn(n, 3, 2, generator=g, dtype=torch.float64)
    ups = [torch.randn(sum(hi - lo for lo, hi in want(j)), 3, 2,
                       generator=g, dtype=torch.float64)
           for j in range(world)]
    want_out, want_grad = _reference(whole, ups, want, world)
    if dim:
        whole, ups = whole.movedim(0, dim), [u.movedim(0, dim) for u in ups]
        want_out = [o.movedim(0, dim) for o in want_out]
        want_grad = want_grad.movedim(0, dim)
    ranks = _Ranks(world)

    with fake_group(world):
        mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("model",))

        def rank_run(rank):
            lo, hi = sh.chunk(n, world, rank)
            local = whole.narrow(dim, lo, hi - lo).contiguous()
            x = DTensor.from_local(local, mesh, [Shard(dim)],
                                   run_check=False, shape=whole.shape,
                                   stride=whole.stride())
            x.requires_grad_(True)
            out = sh.take(x, dim, want, "test")
            (out * ups[rank]).sum().backward()
            return out.detach(), x.grad

        with mock.patch.object(fc, "all_to_all_single",
                               ranks.all_to_all_single), \
                mock.patch.object(DeviceMesh, "get_coordinate",
                                  lambda self: [ranks.local.rank]):
            results = ranks.run(rank_run)

    for rank, (out, grad) in enumerate(results):
        assert torch.equal(out, want_out[rank]), rank
        assert tuple(grad.placements) == (Shard(dim),)
        assert grad.shape == whole.shape
        lo, hi = sh.chunk(n, world, rank)
        assert torch.allclose(grad.to_local(),
                              want_grad.narrow(dim, lo, hi - lo),
                              rtol=0, atol=1e-12), rank
    # two all-to-alls a rank: the backward's sends what the forward
    # received, and receives what it sent
    by_rank = {}
    for me, sent, got in ranks.calls:
        by_rank.setdefault(me, []).append((sent, got))
    for me, ((fsent, fgot), (bsent, bgot)) in by_rank.items():
        assert (bsent, bgot) == (fgot, fsent), me


def test_take_refuses_a_partial_sum_or_an_unsplit_dim():
    with fake_group(2):
        mesh = init_device_mesh("cpu", (2,), mesh_dim_names=("model",))
        x = DTensor.from_local(torch.zeros(2, 4), mesh, [Shard(0)],
                               run_check=False)
        with pytest.raises(ValueError, match="does not split dim 1"):
            sh.take(x, 1, lambda j: [(0, 1)], "test")
        p = DTensor.from_local(torch.zeros(2, 4), mesh,
                               [torch.distributed.tensor.Partial()],
                               run_check=False)
        with pytest.raises(ValueError, match="partial sum"):
            sh.take(p, 0, lambda j: [(0, 1)], "test")


def test_reduced_all_reduces_a_partial_sum_only():
    """``sharding.reduced``: Partial -> Replicate (what the split-head_dim
    scores get), anything else as it is."""
    from torch.distributed.tensor import Partial, Replicate

    with fake_group(4):
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data",
                                                               "model"))
        p = DTensor.from_local(torch.zeros(2, 3), mesh, [Shard(0), Partial()],
                               run_check=False)
        assert tuple(sh.reduced(p).placements) == (Shard(0), Replicate())
        s = DTensor.from_local(torch.zeros(2, 3), mesh, [Shard(0), Shard(1)],
                               run_check=False)
        assert sh.reduced(s) is s
    plain = torch.zeros(3)
    assert sh.reduced(plain) is plain


@pytest.mark.parametrize("fn", ["reduced", "reduced_grad"])
def test_reduced_all_reduces_a_partial_gradient(fn):
    """``sharding.reduced``'s and ``reduced_grad``'s gradient: a partial
    sum (a tensor whole over an axis met one split over it in a product,
    as a norm's output meets a projection split over its input) is
    all-reduced to the forward's placements, GSPMD's collective, not
    left to DTensor; a gradient that holds no partial sum passes as it
    is.  ``reduced_grad`` leaves its input as it is, a partial sum too
    (the long-context decode's attention partitions one itself)."""
    from torch.distributed.tensor import Partial, Replicate

    with fake_group(4):
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data",
                                                               "model"))
        for grad_pl, local, want in (
                ((Shard(0), Partial()), (2, 4), (Shard(0), Replicate())),
                ((Shard(0), Shard(1)), (2, 2), (Shard(0), Shard(1)))):
            x = DTensor.from_local(torch.zeros(2, 4), mesh,
                                   [Shard(0), Replicate()],
                                   run_check=False).requires_grad_(True)
            y = getattr(sh, fn)(x)
            assert tuple(y.placements) == (Shard(0), Replicate())
            y.backward(DTensor.from_local(torch.ones(local), mesh,
                                          list(grad_pl), run_check=False))
            assert tuple(x.grad.placements) == want, grad_pl
        p = DTensor.from_local(torch.zeros(2, 4), mesh, [Shard(0), Partial()],
                               run_check=False).requires_grad_(True)
        want = (Shard(0), Replicate() if fn == "reduced" else Partial())
        assert tuple(getattr(sh, fn)(p).placements) == want
