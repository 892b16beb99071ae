"""Hierarchical collectives: a local leg over the ranks of one node, a
cross-node leg over the ranks with the same local index, and the wire
codecs of the cross-node leg with error feedback.

Counterpart of the hierarchical half of
``horovod_tpu.ops.multihost.GlobalMeshCollectives`` (``_WireCodec``,
``_resolve_codec``, ``_axis0_reduce``, ``_hier_eligible``,
``_wire_codec``, ``_wire_nbytes``, ``_count_path`` and the five
``_hier_*`` legs).  There a rank is a host of k chips, one payload split
j-major across them; here a rank is one GPU, so the NCCL hierarchy
applies directly.  A process set is hierarchical when every node it
touches holds the same number k >= 2 of its ranks and its ranks are
node-major (set rank ``c * k + j``: node c, local index j); it then has a
**local group** per node and a **cross group** per local index.  The
legs, for a set of ``N = k * p`` ranks (p nodes):

* allreduce: ``reduce_scatter_tensor`` over the local group in the
  payload dtype (local rank j holds the node's sum of chunk j), the cross
  leg on that chunk, ``all_gather_into_tensor`` over the local group;
* reducescatter: the local reduce-scatter of the segments of every set
  rank with local index j, then a cross reduce-scatter of those p
  segments (no all-gather: the result is one rank's);
* allgather: a cross all-gather of the rank's rows, then a local one;
* broadcast: the root's node scatters the payload over its local group,
  each chunk crosses nodes by a cross broadcast, a local all-gather
  reassembles it;
* alltoall: a local all-to-all that gathers, on local rank j, every
  block its node sends to local index j, then a cross all-to-all.

The cross leg carries the codec (``HOROVOD_CROSS_HOST_COMPRESSION``):
a cast codec (fp16, bf16) runs the cross collective in the wire dtype; a
quant codec (int8, absmax-scaled e4m3) never does arithmetic on the
wire.  The quantized allreduce is the reference's two-phase exchange on
the chunk: an ``all_to_all`` of wire slices and an ``all_gather`` of the
senders' f32 scales, dequantize, prescale, reduce in f32, Average's
divisor (the set's N), postscale, then a requantize through a second,
leg-2 residual for Sum and Average and an ``all_gather`` of wire and
scales.  The other ops quantize plainly with one scale per sender
(reducescatter through error feedback for Sum and Average).  e4m3 moves
as ``uint8``.  Residuals are f32 on the payload's device, in LRUs of
``HOROVOD_COMPRESSION_RESIDUAL_BUCKETS``.  Nothing in a leg reads a value
back to the host.

The gate (``Hierarchy.eligible``) is one for all five ops: a
hierarchical set, and mode ``on`` or a payload of at least
``HOROVOD_HIERARCHICAL_ALLREDUCE_THRESHOLD`` bytes; Adasum never takes
it.  Every member computes it from negotiated sizes, so every member
takes the same path.  The legs take their groups, sizes and ranks from a
``Hierarchy``, which a caller may also build by hand (on one-member
groups, say).

Each hierarchical call runs under the leg guard (``_guarded``, the
reference's ``multihost.py:492``, around its five dispatches):
``common/resilience.py``'s ``run_hier_leg`` retries a transient fault
and checks the wire CRC of a CPU payload under a quant codec; every
attempt starts from the caller's payload (the legs only read it;
``broadcast_`` writes the caller's tensor once the call succeeded) and
from the residuals as the call found them; a spent budget runs the call
flat.  A size class that rank 0 demoted (``resilience.demoted``) is flat
on every rank, ahead of the gate.
"""

from __future__ import annotations

import collections
import logging
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from .. import compression as comp
from ..common import metrics, resilience
from . import collectives as C
from .collectives import AVERAGE, MAX, MIN, PRODUCT, SUM

LOG = logging.getLogger("horovod_tpu_torch")


class _WireCodec:
    """A resolved cross-node codec: ``kind`` "cast" runs the cross
    collective in ``wire``; "quant" moves ``wire`` values and f32 scales
    and dequantizes before any arithmetic."""

    __slots__ = ("name", "kind", "wire")

    def __init__(self, name: str, kind: str, wire: torch.dtype):
        self.name, self.kind, self.wire = name, kind, wire


def _resolve_codec(name: Optional[str]) -> Optional[_WireCodec]:
    """A parsed ``HOROVOD_CROSS_HOST_COMPRESSION`` value -> its codec
    (None for none)."""
    if name in (None, "", "none"):
        return None
    if name == "fp16":
        return _WireCodec("fp16", "cast", torch.float16)
    if name == "bf16":
        return _WireCodec("bf16", "cast", torch.bfloat16)
    if name == "int8":
        return _WireCodec("int8", "quant", torch.int8)
    if name == "fp8":
        return _WireCodec("fp8", "quant", comp.FP8_WIRE_DTYPE)
    raise ValueError("unknown cross-host compression codec %r" % name)


_REDUCERS = {SUM: lambda d: d.sum(0), AVERAGE: lambda d: d.sum(0),
             MIN: lambda d: d.amin(0), MAX: lambda d: d.amax(0),
             PRODUCT: lambda d: d.prod(0)}


def _axis0_reduce(deq: torch.Tensor, red_op: str, size: int) -> torch.Tensor:
    """Reduce f32 contributions [members, n] -> [n]; Average divides by
    ``size``, the set's full rank count, as a multiplication by its
    reciprocal: what the reference's compiled leg computes (XLA folds a
    division by a constant so), on every device alike.  One contribution
    is itself, -0 included, as XLA elides a reduction over one member (a
    sum from +0 would turn -0 into +0)."""
    if red_op not in _REDUCERS:
        raise NotImplementedError(red_op)
    r = deq[0] if deq.shape[0] == 1 else _REDUCERS[red_op](deq)
    return r * (1.0 / size) if red_op == AVERAGE else r


def _size_class(nbytes: int) -> str:
    """The power-of-two class of a payload of ``nbytes``: what the leg
    guard's streaks and the demoted routes are keyed by (the reference's
    ``_pow2_class``)."""
    return str(1 << (max(int(nbytes), 1) - 1).bit_length())


def _count_path(op: str, nbytes: int, hier: bool,
                codec: Optional[_WireCodec] = None, wire_bytes=None):
    """The path one executed collective took, and its wire bytes: the
    payload's, or with a codec the wire's (``mh_bus_bytes_total``)."""
    path = "hier" if hier else "flat"
    metrics.counter("mh_collective_path_total", op=op, path=path).inc()
    wire = int(wire_bytes) if codec is not None and wire_bytes else nbytes
    metrics.counter("mh_bus_bytes_total", op=op, path=path).inc(wire)
    if codec is not None and wire_bytes:
        metrics.counter("mh_compressed_collectives_total", op=op,
                        codec=codec.name).inc()
        metrics.gauge("mh_compression_ratio", op=op,
                      codec=codec.name).set(nbytes / float(wire_bytes))


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """e4m3 crosses the wire as its bytes (gloo has no float8 type, and
    nothing may reduce one)."""
    return t.view(torch.uint8) if t.dtype == comp.FP8_WIRE_DTYPE else t


def _padded(flat: torch.Tensor, total: int) -> torch.Tensor:
    """``flat`` zero-padded to ``total`` elements (itself if it fits)."""
    n = flat.numel()
    if n == total:
        return flat
    out = flat.new_zeros(total)
    out[:n] = flat
    return out


def layout(ranks: Sequence[int], node_of: Sequence[int]):
    """``(grid, why)``: a set's world ranks by node, ``grid[c][j]``, when
    every node it touches holds the same k >= 2 of them in node-major
    order; otherwise None, and why it cannot be hierarchical ("" when
    each node holds one rank: nothing to say)."""
    by_node = collections.OrderedDict()
    for r in ranks:
        by_node.setdefault(node_of[r], []).append(r)
    grid = list(by_node.values())
    counts = sorted({len(m) for m in grid})
    if counts[-1] < 2:
        return None, ""
    if len(counts) > 1:
        return None, ("its nodes hold %s of its ranks (a hierarchical set "
                      "needs the same number on every node)"
                      % [len(m) for m in grid])
    if [r for m in grid for r in m] != list(ranks):
        return None, "its ranks are not numbered node by node"
    return grid, ""


def build(ranks: Sequence[int], node_of: Sequence[int], me: int, config,
          label: str) -> Optional["Hierarchy"]:
    """The hierarchy of the set of world ranks ``ranks``, or None when it
    stays flat (one warning then, on its members, if it could not be
    hierarchical or a codec is set).  Every rank of the world calls it
    for every set, in the same order: it creates the set's local and
    cross groups, and ``new_group`` needs every rank."""
    ranks = list(ranks)
    codec_name = config.cross_host_compression
    grid, why = (layout(ranks, node_of)
                 if config.hierarchical_allreduce != "off" else (None, ""))
    if grid is None:
        if me in ranks and (why or codec_name != "none"):
            LOG.warning(
                "%s stays flat%s%s", label,
                ": " + why if why else
                " (one rank per node, or HOROVOD_HIERARCHICAL_ALLREDUCE="
                "off)",
                "; HOROVOD_CROSS_HOST_COMPRESSION=%s is set but its "
                "payloads stay full precision" % codec_name
                if codec_name != "none" else "")
        return None
    p, k = len(grid), len(grid[0])
    local = [dist.new_group(m) for m in grid]
    cross = [dist.new_group([grid[c][j] for c in range(p)])
             for j in range(k)]
    if me not in ranks:
        return None
    c = next(i for i, m in enumerate(grid) if me in m)
    j = grid[c].index(me)
    return Hierarchy(local[c], cross[j], grid, c, j,
                     codec=_resolve_codec(codec_name),
                     mode=config.hierarchical_allreduce,
                     threshold=config.hierarchical_allreduce_threshold,
                     residual_buckets=config.compression_residual_buckets)


class Hierarchy:
    """One process set's hierarchical plane on this rank: its local
    group (``local_size`` ranks, this one ``local_rank``), its cross group
    (``cross_size`` ranks, this one ``cross_rank``), ``grid[c][j]`` the
    world rank of node c's local index j, the codec and its residuals."""

    def __init__(self, local_group, cross_group, grid, cross_rank: int,
                 local_rank: int, codec: Optional[_WireCodec] = None,
                 mode: str = "auto", threshold: int = 64 * 1024,
                 residual_buckets: int = 64):
        self.local_group, self.cross_group = local_group, cross_group
        self.grid = [list(m) for m in grid]
        self.cross_size, self.local_size = len(grid), len(grid[0])
        self.cross_rank, self.local_rank = cross_rank, local_rank
        self.size = self.cross_size * self.local_size
        self.rank = cross_rank * self.local_size + local_rank
        self.codec = codec
        self.mode, self.threshold = mode, int(threshold)
        self.quantizer = self.ef = None
        if codec is not None and codec.kind == "quant":
            # The absmax-scaled e4m3, never the plain cast: a reduced
            # value past +-464 must not turn into NaN.
            self.quantizer = (comp.Int8Quantizer if codec.name == "int8"
                              else comp.ScaledFP8Quantizer)
            self.ef = comp.ErrorFeedback(self.quantizer, residual_buckets)
        self._res2 = comp.ResidualLRU(residual_buckets)

    def residuals(self) -> list:
        """The residual stores as they stand: (store, its entries).  A
        leg replaces an entry and never writes one in place, so the
        entries' tensors stay as they were."""
        stores = [self._res2] + ([self.ef._residuals] if self.ef else [])
        return [(lru, collections.OrderedDict(lru)) for lru in stores]

    @staticmethod
    def restore(saved: list):
        """Put the residual stores back as ``residuals()`` found them."""
        for lru, entries in saved:
            lru.clear()
            lru.update(entries)

    # -- the gate -------------------------------------------------------------

    def eligible(self, nbytes: int) -> bool:
        """Hierarchical for a payload of ``nbytes`` (a negotiated size,
        the same on every member)?"""
        return nbytes > 0 and (self.mode == "on"
                               or nbytes >= self.threshold)

    def wire_codec(self, dtype: torch.dtype,
                   red_op: Optional[str] = None) -> Optional[_WireCodec]:
        """The codec for a payload of ``dtype``: floating payloads only,
        a strictly narrower wire only, and no quant codec for Product (an
        element under its chunk's absmax/254 would zero the product)."""
        c = self.codec
        if c is None or (red_op == PRODUCT and c.kind == "quant"):
            return None
        if not dtype.is_floating_point or c.wire.itemsize >= dtype.itemsize:
            return None
        return c

    def wire_nbytes(self, codec: _WireCodec, n_elems: int) -> int:
        """The payload's elements at the wire width, plus the quant
        codecs' f32 scales (two per rank at most: one a leg)."""
        return int(n_elems) * codec.wire.itemsize + (
            8 if codec.kind == "quant" else 0)

    # -- codec plumbing -------------------------------------------------------

    def _encode(self, flat: torch.Tensor, ef_key=None):
        """``flat`` quantized as one row (through the residual of
        ``ef_key`` when given): (wire [n], scale [1] f32)."""
        row = flat.reshape(1, -1)
        if ef_key is not None:
            wire, ctx = self.ef.compress(row, bucket=ef_key)
        else:
            wire, ctx = self.quantizer.compress(row)
        return wire.reshape(-1), ctx[0].float().reshape(1)

    def _exchange(self, wire: torch.Tensor, scale: torch.Tensor):
        """All-to-all of ``wire``'s equal slices and all-gather of the
        senders' scales over the cross group: (wire [p, slice], scales
        [p, 1])."""
        p = self.cross_size
        got = torch.empty_like(wire)
        dist.all_to_all_single(_bytes(got), _bytes(wire),
                               group=self.cross_group)
        return got.view(p, -1), self._gather(scale).view(p, 1)

    def _gather(self, t: torch.Tensor) -> torch.Tensor:
        """All-gather of ``t`` over the cross group: [p * t.numel()]."""
        out = t.new_empty(self.cross_size * t.numel())
        dist.all_gather_into_tensor(_bytes(out), _bytes(t.reshape(-1)),
                                    group=self.cross_group)
        return out

    def _local_gather(self, t: torch.Tensor) -> torch.Tensor:
        out = t.new_empty(self.local_size * t.numel())
        dist.all_gather_into_tensor(out, t.reshape(-1),
                                    group=self.local_group)
        return out

    # -- the legs -------------------------------------------------------------

    def allreduce(self, flat: torch.Tensor, red_op: str,
                  prescale: float = 1.0, postscale: float = 1.0,
                  codec: Optional[_WireCodec] = None,
                  ef_name: Optional[str] = None) -> torch.Tensor:
        """The reduction of a flat payload over the set: a new [n]
        tensor in its dtype.  Sum and Average scale by ``prescale`` after
        the local leg (the reference's order: after dequantize, on a
        host's contribution); Min, Max and Product scale every rank's
        payload before it, as the flat path does, since for them a factor
        on a node's partial result is not one on each rank's."""
        k, p = self.local_size, self.cross_size
        n, dtype = flat.numel(), flat.dtype
        quant = codec is not None and codec.kind == "quant"
        if red_op not in (SUM, AVERAGE) and prescale != 1.0:
            flat = flat.clone()
            C.scale_(flat, prescale)
            prescale = 1.0
        chunk = -(-n // k)
        if quant:
            chunk = -(-chunk // p) * p  # leg-1 slices split evenly
        part = flat.new_empty(chunk)
        dist.reduce_scatter_tensor(part, _padded(flat, chunk * k),
                                   op=C.reduce_op(red_op),
                                   group=self.local_group)
        if quant:
            out = self._quant_allreduce(part, red_op, prescale, postscale,
                                        ("allreduce", n, str(dtype),
                                         ef_name))
        else:
            v = part if codec is None else part.to(codec.wire)
            C.scale_(v, prescale)
            dist.all_reduce(v, op=C.reduce_op(red_op),
                            group=self.cross_group)
            if red_op == AVERAGE and self.size > 1:
                v = C.average(v, self.size)
            C.scale_(v, postscale)
            out = v.to(dtype)
        return self._local_gather(out)[:n]

    def _quant_allreduce(self, part, red_op, prescale, postscale, key):
        """The reference's two-phase exchange on this rank's chunk."""
        linear = red_op in (SUM, AVERAGE)
        wire, scale = self._encode(part, key if linear else None)
        got, scales = self._exchange(wire, scale)
        deq = got.float() * scales
        C.scale_(deq, prescale)
        r = _axis0_reduce(deq, red_op, self.size)
        C.scale_(r, postscale)
        if linear:
            # Zeros on first use or when the slice length changed.
            res = self._res2.take(key, r.shape)
            r = r + (res if res is not None else torch.zeros_like(r))
        q2, s2 = self._requantize(r)
        if linear:
            self._res2.put(key, r - q2.float() * s2)
        g = self._gather(q2).view(self.cross_size, -1)
        s2g = self._gather(s2).view(self.cross_size, 1)
        return (g.float() * s2g).reshape(-1).to(part.dtype)

    def _requantize(self, r: torch.Tensor):
        """The reduced f32 slice quantized as one chunk: (wire, scale
        [1]).  The scale is ``absmax * (1 / top)``, not ``absmax / top``:
        the reference requantizes inside its compiled program, where XLA
        turns a division by a constant into a multiplication by its
        reciprocal (the eager leg-1 encode divides, in both)."""
        amax = r.abs().max()
        s2 = torch.where(amax > 0, amax, torch.ones_like(amax)) * (
            1.0 / self.quantizer.top)
        s2 = s2.reshape(1)
        return self.quantizer.quantize(r, s2), s2

    def reducescatter(self, tensor: torch.Tensor, red_op: str,
                      codec: Optional[_WireCodec] = None,
                      ef_name: Optional[str] = None) -> torch.Tensor:
        """This rank's rows of the reduction (earlier set ranks take the
        larger shards, ``collectives.uneven_chunks``)."""
        k, p, n = self.local_size, self.cross_size, self.size
        d0, trailing = tensor.shape[0], tensor.shape[1:]
        telems = trailing.numel()
        rows, offs = C.uneven_chunks(d0, n)
        seg = rows[0] * telems
        flat = tensor.reshape(-1)
        if rows[0] * n == d0:
            segs = flat.view(n, seg)
        else:
            segs = flat.new_zeros(n, seg)
            for s in range(n):
                segs[s, :rows[s] * telems] = \
                    flat[offs[s] * telems:(offs[s] + rows[s]) * telems]
        # Local rank j's block: the segments of set ranks c * k + j.
        blocks = segs.view(p, k, seg).transpose(0, 1).contiguous()
        part = flat.new_empty(p * seg)
        dist.reduce_scatter_tensor(part, blocks.view(-1),
                                   op=C.reduce_op(red_op),
                                   group=self.local_group)
        if codec is not None and codec.kind == "quant":
            key = (("reducescatter", d0 * telems, str(tensor.dtype),
                    ef_name) if red_op in (SUM, AVERAGE) else None)
            got, scales = self._exchange(*self._encode(part, key))
            out = _axis0_reduce(got.float() * scales, red_op,
                                n).to(tensor.dtype)
        else:
            v = part if codec is None else part.to(codec.wire)
            out = v.new_empty(seg)
            dist.reduce_scatter_tensor(out, v, op=C.reduce_op(red_op),
                                       group=self.cross_group)
            if red_op == AVERAGE and n > 1:
                out = C.average(out, n)
            out = out.to(tensor.dtype)
        me = self.rank
        return out[:rows[me] * telems].view(rows[me], *trailing)

    def allgather(self, tensor: torch.Tensor, counts: Sequence[int],
                  codec: Optional[_WireCodec] = None) -> torch.Tensor:
        """Every set rank's rows in set order; set rank s has
        ``counts[s]``."""
        k, p = self.local_size, self.cross_size
        trailing = tensor.shape[1:]
        telems = trailing.numel()
        width = max(counts) * telems
        mine = _padded(tensor.reshape(-1), width)
        if codec is not None and codec.kind == "quant":
            wire, scale = self._encode(mine)
            g = (self._gather(wire).view(p, width).float()
                 * self._gather(scale).view(p, 1)).to(tensor.dtype)
        else:
            v = mine if codec is None else mine.to(codec.wire)
            g = self._gather(v).to(tensor.dtype)
        # [k local, p nodes, width] -> set order c * k + j.
        gg = self._local_gather(g).view(k, p, width).transpose(0, 1) \
            .reshape(k * p, width)
        parts = [gg[s, :c * telems] for s, c in enumerate(counts) if c]
        out = torch.cat(parts) if parts else gg[:0, :0].reshape(-1)
        return out.view(sum(counts), *trailing)

    def broadcast(self, tensor: torch.Tensor, root: int,
                  codec: Optional[_WireCodec] = None) -> torch.Tensor:
        """Set rank ``root``'s tensor on every rank (dequantized on every
        rank, the root too, under a quant codec): a new tensor."""
        k = self.local_size
        dtype = tensor.dtype
        flat = tensor.reshape(-1)
        if dtype == torch.bool:
            flat = flat.view(torch.uint8)
        n = flat.numel()
        chunk = -(-n // k)
        root_node, root_j = divmod(root, k)
        part = flat.new_empty(chunk)
        if self.cross_rank == root_node:
            pieces = (list(_padded(flat, chunk * k).view(k, chunk))
                      if self.rank == root else None)
            dist.scatter(part, pieces, src=self.grid[root_node][root_j],
                         group=self.local_group)
        src = self.grid[root_node][self.local_rank]
        if codec is not None and codec.kind == "quant":
            if self.cross_rank == root_node:
                wire, scale = self._encode(part)
            else:
                wire = torch.empty(chunk, dtype=codec.wire,
                                   device=part.device)
                scale = torch.empty(1, dtype=torch.float32,
                                    device=part.device)
            dist.broadcast(_bytes(wire), src=src, group=self.cross_group)
            dist.broadcast(scale, src=src, group=self.cross_group)
            part = (wire.float() * scale).to(dtype)
        else:
            v = part if codec is None else part.to(codec.wire)
            dist.broadcast(v, src=src, group=self.cross_group)
            part = v.to(part.dtype)
        out = self._local_gather(part)[:n]
        if dtype == torch.bool:
            out = out.view(torch.bool)
        return out.view(tensor.shape)

    def alltoall(self, tensor: torch.Tensor, matrix: Sequence[int],
                 codec: Optional[_WireCodec] = None) -> torch.Tensor:
        """``matrix[s * N + d]`` rows go from set rank s to d; returns
        the rows this rank receives, in sender order."""
        k, p, n = self.local_size, self.cross_size, self.size
        me = self.rank
        trailing = tensor.shape[1:]
        telems = trailing.numel()
        send = list(matrix[me * n:(me + 1) * n])
        recv = list(matrix[me::n])
        block = max(matrix) * telems
        flat = tensor.reshape(-1)
        if all(s * telems == block for s in send):
            blocks = flat.view(n, block)
        else:
            blocks = flat.new_zeros(n, block)
            off = 0
            for d, s in enumerate(send):
                blocks[d, :s * telems] = flat[off:off + s * telems]
                off += s * telems
        # Local leg: local rank j gathers its node's blocks for every
        # destination with local index j, as [k sources, p nodes, block].
        local = torch.empty_like(blocks)
        dist.all_to_all_single(local.view(-1), blocks.view(p, k, block)
                               .transpose(0, 1).reshape(-1),
                               group=self.local_group)
        # Cross leg: node c's k blocks for (c, j) go to cross rank c.
        out_blocks = local.view(k, p, block).transpose(0, 1).reshape(-1)
        if codec is not None and codec.kind == "quant":
            got, scales = self._exchange(*self._encode(out_blocks))
            got = (got.float() * scales).to(tensor.dtype)
        else:
            v = out_blocks if codec is None else out_blocks.to(codec.wire)
            got = torch.empty_like(v)
            dist.all_to_all_single(got, v, group=self.cross_group)
            got = got.to(tensor.dtype)
        got = got.reshape(n, block)  # sender order c * k + j
        parts = [got[s, :r * telems] for s, r in enumerate(recv) if r]
        out = torch.cat(parts) if parts else got[:0, :0].reshape(-1)
        return out.view(sum(recv), *trailing)


# -- routing: what the engine executes -----------------------------------------

def _hierarchy(ps, op: str, nbytes: int) -> Optional[Hierarchy]:
    """The set's hierarchy when ``op`` on a payload of ``nbytes`` (a
    negotiated size, the same on every member) takes it: it passes the
    gate and rank 0 has not demoted its size class to the flat path."""
    h = ps.hierarchy
    if h is None or not h.eligible(nbytes):
        return None
    if resilience.demoted(op, _size_class(nbytes)):
        return None
    return h


def _guarded(h: Hierarchy, op: str, nbytes: int, payload_bytes: int,
             run_hier, run_flat, codec=None, payloads=(), wire_bytes=None):
    """Run a hierarchical call under the leg guard
    (``resilience.run_hier_leg``: the fault sites, the wire checksum of
    ``payloads`` under a quant codec, transient retry under the group
    deadline) and count the path that moved it.  Each attempt starts from
    the residuals as they were before the call, so that a retry or a
    fallback applies error feedback once at most.  On ``LegDegraded``
    this call runs flat; routing changes only by rank 0's verdict."""
    saved = h.residuals()
    attempts = 0

    def attempt():
        nonlocal attempts
        if attempts:
            h.restore(saved)
        attempts += 1
        return run_hier()

    try:
        out = resilience.run_hier_leg(
            op, _size_class(nbytes), attempt, payloads=payloads,
            quantized=codec is not None and codec.kind == "quant")
    except resilience.LegDegraded as exc:
        h.restore(saved)
        LOG.warning("%s[%s]: hierarchical leg degraded (%s); this call runs "
                    "flat", op, _size_class(nbytes), exc.cause)
        _count_path(op, payload_bytes, False)
        return run_flat()
    except BaseException:
        h.restore(saved)
        raise
    _count_path(op, payload_bytes, True, codec, wire_bytes)
    return out


def _nbytes(t: torch.Tensor, n_elems: Optional[int] = None) -> int:
    return (t.numel() if n_elems is None else n_elems) * t.element_size()


def allreduce(tensors: Sequence[torch.Tensor], red_op: str, prescale: float,
              postscale: float, ps, name: Optional[str] = None
              ) -> List[torch.Tensor]:
    """A fused allreduce of ``tensors`` over set ``ps``, routed by its
    total bytes; ``name`` (one entry) keys its residuals, as the
    reference's does."""
    nbytes = sum(_nbytes(t) for t in tensors)

    def flat():
        return C.allreduce(tensors, red_op, prescale, postscale, ps.size(),
                           ps.group)

    h = _hierarchy(ps, "allreduce", nbytes)
    if h is None:
        _count_path("allreduce", nbytes, False)
        return flat()
    codec = h.wire_codec(tensors[0].dtype, red_op)
    buf = (tensors[0].reshape(-1) if len(tensors) == 1
           else _flatten_dense_tensors(tensors))
    return _guarded(h, "allreduce", nbytes, nbytes,
                    lambda: list(_unflatten_dense_tensors(
                        h.allreduce(buf, red_op, prescale, postscale, codec,
                                    name), tensors)), flat,
                    codec, (buf,),
                    h.wire_nbytes(codec, buf.numel()) if codec else None)


def reducescatter(tensor: torch.Tensor, red_op: str, ps,
                  name: Optional[str] = None) -> torch.Tensor:
    n = ps.size()
    shard = C.uneven_chunks(tensor.shape[0], n)[0][0]
    per_row = _nbytes(tensor) // max(tensor.shape[0], 1)

    def flat():
        return C.reducescatter(tensor, red_op, n, ps.rank(), ps.group)

    h = _hierarchy(ps, "reducescatter", n * shard * per_row)
    if h is None:
        _count_path("reducescatter", _nbytes(tensor), False)
        return flat()
    codec = h.wire_codec(tensor.dtype, red_op)
    t = tensor.detach().contiguous()
    return _guarded(h, "reducescatter", n * shard * per_row, _nbytes(tensor),
                    lambda: h.reducescatter(t, red_op, codec, name), flat,
                    codec, (t,),
                    h.wire_nbytes(codec, tensor.numel()) if codec else None)


def allgather(tensor: torch.Tensor, counts: Sequence[int],
              ps) -> torch.Tensor:
    row = tensor.shape[1:].numel() * tensor.element_size()

    def flat():
        return C.allgather(tensor, counts, ps.group)

    h = _hierarchy(ps, "allgather", max(counts) * row)
    if h is None:
        _count_path("allgather", _nbytes(tensor), False)
        return flat()
    codec = h.wire_codec(tensor.dtype)
    t = tensor.detach().contiguous()
    return _guarded(h, "allgather", max(counts) * row, _nbytes(tensor),
                    lambda: h.allgather(t, counts, codec), flat, codec, (t,),
                    h.wire_nbytes(codec, tensor.numel()) if codec else None)


def broadcast_(tensor: torch.Tensor, root_rank: int, ps) -> torch.Tensor:
    """Overwrite ``tensor`` with world rank ``root_rank``'s.  The
    hierarchical legs only read it, and it is written once they have
    succeeded: a retried or degraded call starts from the caller's
    payload."""

    def flat():
        return C.broadcast_(tensor, root_rank, ps.group)

    h = _hierarchy(ps, "broadcast", _nbytes(tensor))
    if h is None:
        _count_path("broadcast", _nbytes(tensor), False)
        return flat()
    codec = h.wire_codec(tensor.dtype)
    root = root_rank if ps.ranks is None else ps.ranks.index(root_rank)
    t = tensor.contiguous()
    out = _guarded(h, "broadcast", _nbytes(tensor), _nbytes(tensor),
                   lambda: h.broadcast(t, root, codec), flat, codec,
                   (t,) if h.rank == root else (),
                   h.wire_nbytes(codec, tensor.numel()) if codec else None)
    # The flat path (a degraded call) has written the tensor already.
    return out if out is tensor else tensor.copy_(out)


def alltoall(tensor: torch.Tensor, matrix: Sequence[int],
             ps) -> torch.Tensor:
    """``matrix`` is the negotiated splits, sender-major over the set."""
    n, me = ps.size(), ps.rank()
    row = tensor.shape[1:].numel() * tensor.element_size()

    def flat():
        return C.alltoall(tensor, matrix[me * n:(me + 1) * n],
                          matrix[me::n], ps.group)

    h = _hierarchy(ps, "alltoall", n * max(matrix) * row)
    if h is None:
        _count_path("alltoall", _nbytes(tensor), False)
        return flat()
    codec = h.wire_codec(tensor.dtype)
    t = tensor.detach().contiguous()
    return _guarded(h, "alltoall", n * max(matrix) * row, _nbytes(tensor),
                    lambda: h.alltoall(t, matrix, codec), flat, codec, (t,),
                    h.wire_nbytes(codec, tensor.numel()) if codec else None)


def count_flat(op: str, nbytes: int):
    """A collective that never takes the gate (Adasum) still counts."""
    _count_path(op, nbytes, False)
