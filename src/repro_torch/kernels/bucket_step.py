"""The vector engine's bucket step: wrapper of the CUDA kernel ``csrc/bucket_step.cu``.

Port of the JAX program ``repro.sim.vector.engine._build_step`` run by
``_compiled_segments`` (a ``lax.scan`` over a segment of buckets,
``jax.vmap``-ed over replicas).  One block per replica runs every bucket
of the segment in order: one warp holds the carry of the replica's cells
in registers from the first bucket to the last, three more sum the
acquisition ring for the next bucket meanwhile; replicas never interact,
so a replica's result is the same bits alone, in any batch and in any
order.  Kernel and plain version (``ref.bucket_segment_ref``) round
every op alike and agree bit for bit.  This wrapper only launches: it
raises for tensors that are not on a CUDA device.  ``ops.bucket_segment``
picks between it and the plain version.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.kernels import _build, ref

#: launches of the kernel since the count was last set to 0
LAUNCHES = 0
#: shared memory a block may use (227 KB)
SMEM_BYTES = 232_448
#: per-cell values a bucket publishes in shared memory for other cells'
#: folds (``csrc/bucket_step.cu``'s ``Pub`` enum)
PUBLISHED_PER_CELL = 14
#: buckets of outputs staged in shared memory (``YS_BUFS``)
YS_BUFS = 3
#: cells (C x J) a warp holds: 32 lanes x 32 cells each
MAX_CELLS = 1024


class Layout(ctypes.Structure):
    """``csrc/bucket_step.cu``'s ``Layout``, passed by value: the dims,
    the packed widths and each key's offset in ``ref.BUCKET_*`` order."""

    _fields_ = ([(n, ctypes.c_int) for n in
                 ("M", "P", "J", "L", "LD", "C", "F", "K", "X", "Y", "NC")]
                + [("dt", ctypes.c_float),
                   ("carry", ctypes.c_int * len(ref.BUCKET_CARRY)),
                   ("prm", ctypes.c_int * len(ref.BUCKET_PRM)),
                   ("xs", ctypes.c_int * len(ref.BUCKET_XS)),
                   ("ys", ctypes.c_int * len(ref.BUCKET_YS)),
                   ("consts", ctypes.c_int * len(ref.BUCKET_CONSTS))])


def c_layout(lay: ref.BucketLayout) -> Layout:
    out = Layout(M=lay.M, P=lay.P, J=lay.J, L=lay.L, LD=lay.LD, C=lay.C,
                 F=lay.F, K=lay.K, X=lay.X, Y=lay.Y, NC=lay.NC, dt=lay.dt)
    for field, keys, off in (("carry", ref.BUCKET_CARRY, lay.carry_off),
                             ("prm", ref.BUCKET_PRM, lay.prm_off),
                             ("xs", ref.BUCKET_XS, lay.xs_off),
                             ("ys", ref.BUCKET_YS, lay.ys_off),
                             ("consts", ref.BUCKET_CONSTS, lay.consts_off)):
        getattr(out, field)[:] = [off[k] for k in keys]
    return out


def _smem_floats(lay: ref.BucketLayout, stride: int, ybufs: int) -> int:
    cj = lay.C * lay.J
    return (lay.L * stride + 2 * cj * lay.J + PUBLISHED_PER_CELL * cj
            + 2 * lay.X + ybufs * lay.Y + 1)


def smem_plan(lay: ref.BucketLayout):
    """How the kernel lays the replica out in shared memory (its
    ``smem_plan``): the ring's row stride (C x J made odd, so the 32 lanes
    that fold one column read 32 banks, or not) and the buckets of
    outputs staged there (``YS_BUFS``, or 0: written straight to device
    memory); the first that fits of padded and staged, unpadded and
    staged, unpadded and not staged."""
    cj = lay.C * lay.J
    for stride, ybufs in ((cj | 1, YS_BUFS), (cj, YS_BUFS)):
        if 4 * _smem_floats(lay, stride, ybufs) <= SMEM_BYTES:
            return stride, ybufs
    return cj, 0


def smem_bytes(lay: ref.BucketLayout) -> int:
    """Shared memory of one replica's block: the ring, omega, the routing
    matrix, the published per-cell values, two buckets' inputs and the
    staged outputs (the kernel's ``smem_floats``)."""
    return 4 * _smem_floats(lay, *smem_plan(lay))


@functools.lru_cache(maxsize=None)
def _fn():
    fn = _build.load("bucket_step").bucket_segment
    fn.argtypes = ([Layout] + [ctypes.c_void_p] * 6
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def check_args(lay: ref.BucketLayout, consts, prm, carry, xs, b0: int,
               b1: int) -> None:
    """Raise unless the kernel takes these arguments (shapes, the
    segment's range and the shared memory of one block; the device is
    checked by ``bucket_segment``)."""
    if smem_bytes(lay) > SMEM_BYTES:
        raise ValueError(
            f"bucket_step: the carry of C={lay.C} cells x J={lay.J} "
            f"regions with a ring of L={lay.L} buckets needs "
            f"{smem_bytes(lay)} bytes of shared memory; the limit is "
            f"{SMEM_BYTES} (227 KB)")
    if lay.C * lay.J > MAX_CELLS or lay.LD != ref.DRAIN_RING:
        raise ValueError(
            f"bucket_step: C={lay.C} x J={lay.J} cells (at most "
            f"{MAX_CELLS}) and a drain ring of {lay.LD} rows (must be "
            f"{ref.DRAIN_RING})")
    n_rep = carry.shape[0] if carry.dim() == 2 else -1
    want = {"consts": (consts, (lay.NC,)), "prm": (prm, (n_rep, lay.K)),
            "carry": (carry, (n_rep, lay.F)),
            "xs": (xs, (max(b1 - b0, 0), lay.X))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(f"bucket_step: {name} is {tuple(t.shape)} "
                             f"{t.dtype}, must be {shape} float32")
    if not 0 <= b0 < b1 or b1 >= 2 ** 24:
        raise ValueError(f"bucket_step: segment [{b0}, {b1}) must be "
                         f"non-empty, from 0, below 2^24 buckets")


def bucket_segment(lay: ref.BucketLayout, consts, prm, carry, xs, b0: int,
                   b1: int):
    """Buckets b0..b1-1 for R replicas, every tensor on one CUDA device:
    consts (NC,), prm (R, K), carry (R, F), xs (b1 - b0, X) float32,
    packed as ``lay``.  Returns (carry (R, F), ys (R, b1 - b0, Y)), new
    tensors."""
    global LAUNCHES
    check_args(lay, consts, prm, carry, xs, b0, b1)
    for name, t in (("consts", consts), ("prm", prm), ("carry", carry),
                    ("xs", xs)):
        if not t.is_cuda or t.device != carry.device:
            raise ValueError(f"bucket_step kernel: {name} is on {t.device},"
                             f" not a CUDA device (that of carry)")
    consts, prm, carry, xs = (t.contiguous() for t in
                              (consts, prm, carry, xs))
    n_rep = carry.shape[0]
    out = torch.empty_like(carry)
    ys = torch.empty((n_rep, b1 - b0, lay.Y), dtype=torch.float32,
                     device=carry.device)
    if n_rep == 0:
        return out, ys
    with torch.cuda.device(carry.device):
        stream = torch.cuda.current_stream(carry.device).cuda_stream
        err = _fn()(c_layout(lay), consts.data_ptr(), prm.data_ptr(),
                    carry.data_ptr(), out.data_ptr(), xs.data_ptr(),
                    ys.data_ptr(), n_rep, b0, b1 - b0, stream)
    _build.check(err, "bucket_step")
    LAUNCHES += 1
    return out, ys


#: replica modes of the step: (mode, lt_i, lt_ua) as ``engine._prm``
#: lowers them
MODES = {"reactive": (0.0, 0.0, 0.0), "lt-i": (1.0, 1.0, 0.0),
         "lt-u": (1.0, 0.0, 0.0), "lt-ua": (1.0, 0.0, 1.0),
         "chiron": (2.0, 0.0, 0.0)}


def synthetic_case(seed: int, modes, M: int = 4, P: int = 1, J: int = 3,
                   L: int = 481, buckets: int = 240, collide: bool = False,
                   down: bool = False, dead: bool = False,
                   plan: bool = True):
    """Seeded inputs of one segment, numpy float32, for holding the
    kernel to its plain version (and the plain version to the JAX step):
    one replica per entry of ``modes`` (keys of ``MODES``), M models x P
    pools x J regions, a ring of L buckets.  Values span the thresholds
    the step compares against: live and dead cells, targets set and not,
    queues, parked NIW work, a sparse ring.  ``collide``: model 0's swap,
    local and remote delays are equal, so the ring's three adds of a cell
    hit one row; ``down``: region 0 is down; ``dead``: model 0 has no
    live, pending or draining instance and is past its drop budget;
    ``plan``: half the replicas route by the plan's omega, on half the
    (cell, home) rows.  Returns (layout, consts (NC,), prm (R, K), carry
    (R, F), xs (buckets, X))."""
    rng = np.random.default_rng(seed)
    lay = ref.BucketLayout(M, P, J, L, 15.0)
    C, R = lay.C, len(modes)
    u = lambda lo, hi, *s: rng.uniform(lo, hi, s).astype(np.float32)
    ints = lambda lo, hi, *s: rng.integers(lo, hi, s).astype(np.float32)
    cs = {"kv": u(2e5, 2e6, C), "ptps": u(2e3, 2e4, C),
          "tbt0": u(0.02, 0.1, C), "alpha": u(0.5, 2.0, C),
          "mb": ints(32, 257, C), "swap_b": ints(1, 9, C),
          "local_b": ints(9, 60, C), "remote_b": ints(60, L, C)}
    cs["remote_b"][0] = L - 1
    if collide:
        for k in ("swap_b", "local_b", "remote_b"):
            cs[k][:P] = 5.0
    consts = np.zeros(lay.NC, np.float32)
    lay.pack_into(consts, cs, lay.consts_shapes, lay.consts_off)

    prm = np.zeros((R, lay.K), np.float32)
    carry = np.zeros((R, lay.F), np.float32)
    for r, name in enumerate(modes):
        mode, lt_i, lt_ua = MODES[name]
        caps = np.where(rng.random(J) < 0.5, 1e9, ints(8, 40, J))
        p = {"mode": mode, "lt_i": lt_i, "lt_ua": lt_ua,
             "up": u(0.7, 0.9)[()], "down": u(0.2, 0.4)[()],
             "cd_b": ints(1, 9)[()], "min_inst": ints(1, 3)[()],
             "ua_hi": u(1.05, 1.3)[()], "ua_lo": u(0.6, 0.95)[()],
             "ua_win_b": 80.0, "hour_b": 240.0, "route_thr": u(0.5, 0.9)[()],
             "plan_router": float(plan and r % 2 == 1),
             "has_qm": float(r % 3 != 2), "qm_sig": 0.8, "qm_one": 0.6,
             "qm_two": 0.5, "qm_age": 36000.0, "chiron_theta": 0.6,
             "chiron_mixed": 1.0, "chiron_prof": u(500, 5000, C),
             "drop_budget_b": ints(2, 12)[()], "caps": caps}
        lay.pack_into(prm[r], {k: np.asarray(v, np.float32)
                               for k, v in p.items()},
                      lay.prm_shapes, lay.prm_off)
        ring = np.where(rng.random((L, C, J)) < 0.03, ints(1, 4, L, C, J),
                        0.0)
        drainq = np.where(rng.random((3, C, J)) < 0.2,
                          ints(1, 3, 3, C, J), 0.0)
        omega = u(0, 1, C, J, J) * (rng.random((C, J, J)) < 0.7)
        c = {"live": ints(0, 7, C, J), "f_tok": u(0, 1e6, C, J),
             "qp": u(0, 2e6, C, J), "qo": u(0, 5e5, C, J),
             "qn": u(0, 500, C, J), "d_o": u(0, 1e5, C, J),
             "d_n": u(0, 200, C, J), "ring": ring, "drainq": drainq,
             "spot": ints(2, 30, J), "warm": ints(0, 4, M, J),
             "wloc": ints(0, 2, M, J), "cd": ints(0, 4, C, J),
             "tgt": np.where(rng.random((C, J)) < 0.6, ints(0, 9, C, J),
                             -1.0),
             "fc": u(0, 1e4, C, J), "dep": (rng.random((M, J)) < 0.85),
             "down": np.zeros(J), "dead": ints(0, 3, C),
             "park_p": u(0, 1e5, C, J), "park_o": u(0, 2e4, C, J),
             "park_n": u(0, 40, C, J), "relcum": u(0, 100, C),
             "omega": omega, "has_om": rng.random((C, J)) < 0.5}
        if down:
            c["down"][0] = 1.0
        if dead:
            for k in ("live", "ring", "drainq"):
                c[k][..., :P, :] = 0.0
            c["dead"][:P] = 50.0
        lay.pack_into(carry[r], {k: np.asarray(v, np.float32)
                                 for k, v in c.items()},
                      lay.carry_shapes, lay.carry_off)
    xs = np.zeros((buckets, lay.X), np.float32)
    n = u(0, 30, buckets, C, J) * (rng.random((buckets, C, J)) < 0.8)
    nn = u(0, 10, buckets, C, J) * (rng.random((buckets, C, J)) < 0.5)
    fcum = 100.0 + np.cumsum(u(0, 2, buckets, C), axis=0)
    lay.pack_into(xs, {"iw_n": n, "iw_p": n * u(200, 3000, buckets, C, J),
                       "iw_o": n * u(50, 500, buckets, C, J),
                       "niw_n": nn, "niw_p": nn * u(200, 3000, buckets, C, J),
                       "niw_o": nn * u(50, 500, buckets, C, J),
                       "obs": u(0, 1e4, buckets, C, J),
                       "fcum": fcum.astype(np.float32)},
                  lay.xs_shapes, lay.xs_off)
    return lay, consts, prm, carry, xs
