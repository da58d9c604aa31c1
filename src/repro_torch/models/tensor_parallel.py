"""Tensor-parallel compute of one data-parallel row's "model" group.

The reference has no counterpart: its sharded step is one SPMD program,
and GSPMD partitions every product by the parameters' shardings and
inserts the collectives.  The port computes that per-position program
explicitly.  A row's positions, in "model" order, each compute with their
own block of every parameter leaf (``mesh.param_shardings`` cut over
"model", whole over the data axes) on their own device:

* :class:`ModelGroup` -- the row's devices in position order and the
  bytes its positions exchanged;
* :class:`TpLeaf` -- a parameter leaf as its "model" blocks (block p on
  position p's device) and the dim they cut; a leaf the plan leaves whole
  over "model" is held whole by every position and read by the first;
* :class:`Parts` -- an activation cut over the positions.

An activation every position would hold whole (the residual stream, the
norms, the router's logits and the routing, the loss) is one tensor on
the row's first device: the positions would hold the same values, so a
row computes it once.  The products the layers need:

* :func:`matmul` -- column-parallel where the weight's output dim is cut
  (each output element is computed whole by one position: exact; the
  backward's sum over the positions of the input's gradient is float32,
  rounded once), row-parallel where its contraction dim is cut (each
  position a float32 partial sum; the partial sums are added in position
  order and rounded once, the one place the forward's float order
  changes), expert-parallel where a batched weight's leading dim is cut;
* :func:`whole` -- the all-gather of a cut activation (exact), or the
  gather of a small leaf whose cut does not fit its product (a bias, a
  norm scale, the router);
* :func:`each` -- a function of the positions' blocks run by each
  position on its own device;
* :func:`attention_heads` -- q, k and v as each position's whole heads,
  the kv heads of its query heads as the GQA fold reads them (MLA's
  MHA too: q, k and v of their own head dims);
* :func:`lookup` -- the vocab-parallel embedding (each position looks up
  the tokens in its vocab range; the rows are selected, not summed).

Without a group (plain tensors) every helper is the plain op it
replaces, so the layers keep one code path.  :func:`route` names the
families that compute this way.  A group knows the position whose work
is running (``ModelGroup.position``) and calls its ``hook``, where one is
set, after each position's work (``launch.op_cost`` splits a trace into
positions so).
"""
from __future__ import annotations

import contextlib
from typing import Callable, List, Optional, Sequence, Tuple, Union

import torch

__all__ = ["TENSOR_PARALLEL", "ROW_GATHERED", "route", "ModelGroup",
           "TpLeaf", "Parts", "group_of", "whole", "matmul", "add_bias",
           "each", "transpose", "lookup", "attention_heads", "kv_whole"]

TENSOR_PARALLEL = "tensor_parallel"
ROW_GATHERED = "row_gathered"


def route(cfg) -> str:
    """The sharded step's route for ``cfg``: tensor-parallel for every
    family of attention layers (dense, MoE, MLA with DeepSeek's MoE, the
    VLM and the encoder); row-gathered for the Mamba2 families (ssm and
    the hybrid: each row gathers the parameters whole, ROADMAP item
    18c)."""
    if cfg.family in ("ssm", "hybrid"):
        return ROW_GATHERED
    return TENSOR_PARALLEL


class ModelGroup:
    """A data-parallel row's "model" positions: ``devices`` in position
    order, ``exchanged`` the bytes of activations its positions gathered
    or summed (each gather's or sum's whole result, as a collective's
    result counts on every position), ``leaf_bytes`` those of the small
    leaves gathered whole, ``position`` the position whose work is
    running (None for the row's own), ``hook`` a function called as
    ``hook(p, args, out)`` after position p's work in :meth:`run`."""

    def __init__(self, devices: Sequence):
        self.devices = [torch.device(d) for d in devices]
        self.exchanged = 0
        self.leaf_bytes = 0
        self.position: Optional[int] = None
        self.hook: Optional[Callable] = None

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def lead(self) -> torch.device:
        return self.devices[0]

    @contextlib.contextmanager
    def at(self, p: int):
        """While open, position ``p``'s work is running."""
        before, self.position = self.position, p
        try:
            yield
        finally:
            self.position = before

    def run(self, p: int, fn: Callable, *args):
        """``fn(*args)`` as position ``p``'s work, ``args`` on its
        device."""
        dev = self.devices[p]
        with self.at(p):
            out = fn(*[a.to(dev) if isinstance(a, torch.Tensor) else a
                       for a in args])
        if self.hook is not None:
            self.hook(p, args, out)
        return out

    def __repr__(self) -> str:
        return f"ModelGroup({[str(d) for d in self.devices]})"


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class TpLeaf:
    """A parameter leaf as its "model" blocks: ``blocks[p]`` on position
    p's device, cut on ``dim`` (None: every position holds the leaf whole
    and the first reads it); ``shape`` the whole leaf's."""

    __slots__ = ("group", "blocks", "dim", "shape")

    def __init__(self, group: ModelGroup, blocks: Sequence[torch.Tensor],
                 dim: Optional[int], shape: Tuple[int, ...]):
        self.group = group
        self.blocks = list(blocks)
        self.dim = dim
        self.shape = tuple(shape)

    @property
    def device(self) -> torch.device:
        return self.group.lead

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def __getitem__(self, i: int) -> "TpLeaf":
        """Layer ``i`` of a stacked leaf (the leading axis is never cut),
        each block indexed as its position's work."""
        if self.dim == 0:
            raise ValueError("the stacked layers axis of a leaf is not cut")
        if self.dim is None:
            blocks = [self.blocks[0][i]] * len(self.blocks)
        else:
            blocks = [self.group.run(p, lambda b: b[i], b)
                      for p, b in enumerate(self.blocks)]
        return TpLeaf(self.group, blocks,
                      None if self.dim is None else self.dim - 1,
                      self.shape[1:])

    def __repr__(self) -> str:
        return (f"TpLeaf(shape={self.shape}, dim={self.dim}, "
                f"blocks={[tuple(b.shape) for b in self.blocks]})")


class Parts:
    """An activation cut over a group's positions: ``blocks[p]`` on
    position p's device; ``dim`` the dim the blocks cut, in position
    order."""

    __slots__ = ("group", "blocks", "dim")

    def __init__(self, group: ModelGroup, blocks: Sequence[torch.Tensor],
                 dim: int):
        self.group = group
        self.blocks = list(blocks)
        self.dim = dim


Value = Union[torch.Tensor, Parts]


def group_of(p) -> Optional[ModelGroup]:
    """The group of the first :class:`TpLeaf` in a mapping of parameters
    (nested one level); None for plain tensors and for a group of one
    position (whose helpers are the plain ops)."""
    for v in p.values():
        if isinstance(v, TpLeaf):
            return v.group if v.group.size > 1 else None
        if isinstance(v, dict):
            g = group_of(v)
            if g is not None:
                return g
    return None


def whole(v):
    """``v`` whole on the row's first device: a tensor as it is; a cut
    activation gathered in position order (exact; counted as exchanged);
    a leaf's blocks put together (exact; counted as a leaf gather)."""
    if isinstance(v, torch.Tensor):
        return v
    g = v.group
    if isinstance(v, TpLeaf):
        if v.dim is None:
            return v.blocks[0]
        out = torch.cat([b.to(g.lead) for b in v.blocks], dim=v.dim)
        g.leaf_bytes += _nbytes(out)
        return out
    out = torch.cat([b.to(g.lead) for b in v.blocks], dim=v.dim)
    g.exchanged += _nbytes(out)
    return out


def _slices(x: torch.Tensor, dim: int, sizes: Sequence[int]
            ) -> List[torch.Tensor]:
    return list(torch.split(x, list(sizes), dim=dim))


def _cut_like(x: Value, g: ModelGroup, dim: int, sizes: Sequence[int]
              ) -> List[torch.Tensor]:
    """``x`` as blocks of ``sizes`` along ``dim``: a cut activation whose
    blocks fit as they are, else the whole value sliced."""
    if isinstance(x, Parts) and \
            x.dim % x.blocks[0].ndim == dim % x.blocks[0].ndim and \
            [b.shape[dim] for b in x.blocks] == list(sizes):
        return x.blocks
    return _slices(whole(x), dim, sizes)


def _mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return torch.bmm(x, w) if w.ndim == 3 else x @ w


def _mm32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``_mm(x, w)`` accumulated and returned in float32: the bf16 / fp16
    tensor-core product with a float32 output on the card, the float32
    product of the exact float32 values elsewhere."""
    if x.is_cuda and x.dtype in (torch.bfloat16, torch.float16):
        if w.ndim == 3:
            return torch.bmm(x, w, out_dtype=torch.float32)
        return torch.mm(x.reshape(-1, x.shape[-1]), w,
                        out_dtype=torch.float32).reshape(
                            *x.shape[:-1], w.shape[-1])
    return _mm(x.float(), w.float())


def _grad_w(x: torch.Tensor, grad: torch.Tensor, w_ndim: int
            ) -> torch.Tensor:
    """The gradient of ``w`` in ``_mm(x, w)``, as autograd forms it."""
    if w_ndim == 3:
        return torch.bmm(x.transpose(1, 2), grad)
    return x.reshape(-1, x.shape[-1]).T @ grad.reshape(-1, grad.shape[-1])


class _Column(torch.autograd.Function):
    """The column-parallel product: each position's ``x @ w_p`` (the
    forward is the whole product's columns); the backward sums the
    positions' float32 products ``grad_p @ w_p^T`` in position order and
    rounds once, as the whole product's backward rounds its float32
    accumulation once."""

    @staticmethod
    def forward(ctx, g, x, *ws):
        ctx.g = g
        ctx.save_for_backward(x, *ws)
        outs = []
        for p, w in enumerate(ws):
            with g.at(p):
                outs.append(_mm(x.to(g.devices[p]), w))
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        g = ctx.g
        x, *ws = ctx.saved_tensors
        gx, gws = None, []
        for p, (w, gr) in enumerate(zip(ws, grads)):
            with g.at(p):
                xp = x.to(g.devices[p])
                t = _mm32(gr, w.transpose(-1, -2)).to(g.lead)
                gws.append(_grad_w(xp, gr, w.ndim))
            gx = t if gx is None else gx + t
        return (None, gx.to(x.dtype), *gws)


class _Row(torch.autograd.Function):
    """The row-parallel product: each position's float32 partial sum
    ``x_p @ w_p``, added in position order on the row's first device and
    rounded once to ``dt``, as the whole product rounds its float32
    accumulation once; the backward gives each position the whole
    product's gradients of its blocks (``grad @ w_p^T``, ``x_p^T @
    grad``)."""

    @staticmethod
    def forward(ctx, g, dt, *xw):
        m = len(xw) // 2
        xs, ws = xw[:m], xw[m:]
        ctx.g = g
        ctx.save_for_backward(*xs, *ws)
        out = None
        for p, (x, w) in enumerate(zip(xs, ws)):
            with g.at(p):
                t = _mm32(x, w).to(g.lead)
            out = t if out is None else out + t
        g.exchanged += _nbytes(out)
        return out.to(dt)

    @staticmethod
    def backward(ctx, grad):
        g = ctx.g
        saved = ctx.saved_tensors
        m = len(saved) // 2
        xs, ws = saved[:m], saved[m:]
        gxs, gws = [], []
        for p, (x, w) in enumerate(zip(xs, ws)):
            with g.at(p):
                gp = grad.to(g.devices[p])
                gxs.append(_mm(gp, w.transpose(-1, -2)))
                gws.append(_grad_w(x, gp, w.ndim))
        return (None, None, *gxs, *gws)


def matmul(x: Value, w, dt: torch.dtype) -> Value:
    """``x @ w`` (``torch.bmm`` for an expert-batched ``w``) with ``w``
    cast to ``dt``.  A plain ``w`` is the plain product.  A :class:`TpLeaf`
    cut on its output dim is column-parallel (``x`` whole; the result cut
    as ``w``; :class:`_Column`), on its contraction dim row-parallel (``x``
    cut to fit; the float32 partial sums added in position order on the
    row's first device; :class:`_Row`), on a batched weight's leading dim
    expert-parallel (``x`` cut along it); a leaf held whole multiplies on
    the row's first device."""
    if not isinstance(w, TpLeaf):
        return _mm(whole(x), w.to(dt))
    g = w.group
    if w.dim is None:
        return _mm(whole(x), w.blocks[0].to(dt))
    d = w.dim - w.ndim                       # -1 output, -2 contraction
    sizes = [b.shape[w.dim] for b in w.blocks]
    if d in (-1, -2):
        ws = [g.run(p, lambda b: b.to(dt), b)
              for p, b in enumerate(w.blocks)]
        if d == -1:
            return Parts(g, list(_Column.apply(g, whole(x), *ws)), -1)
        xs = [t.to(dev) for t, dev in
              zip(_cut_like(x, g, -1, sizes), g.devices)]
        return _Row.apply(g, dt, *xs, *ws)
    if w.ndim == 3 and w.dim == 0:           # experts
        xs = _cut_like(x, g, 0, sizes)
        return Parts(g, [g.run(p, lambda a, b: _mm(a, b.to(dt)), xs[p], b)
                         for p, b in enumerate(w.blocks)], 0)
    raise ValueError(f"a product with a leaf cut on dim {w.dim} of "
                     f"{w.shape} is not tensor-parallel")


def add_bias(y: Value, b, dt: torch.dtype) -> Value:
    """``y + b`` (``b`` cast to ``dt``): a cut ``y`` adds each position's
    slice of the bias (its own block where the cuts fit, else the bias
    gathered and sliced), a whole ``y`` the bias whole."""
    if not isinstance(y, Parts):
        return y + whole(b).to(dt)
    g = y.group
    sizes = [t.shape[-1] for t in y.blocks]
    if isinstance(b, TpLeaf) and b.dim == 0 and \
            [t.shape[0] for t in b.blocks] == sizes:
        bs = b.blocks
    else:
        bs = _slices(whole(b), 0, sizes)
    return Parts(g, [g.run(p, lambda a, c: a + c.to(dt), t, bs[p])
                     for p, t in enumerate(y.blocks)], y.dim)


def each(g: Optional[ModelGroup], fn: Callable, *args,
         dim: int = -1) -> Value:
    """``fn`` of the positions' blocks, each position on its own device
    (a whole argument goes to every position as it is); the results cut
    on ``dim``.  Without a group, or without a cut argument, ``fn(*args)``
    once."""
    if g is None or not any(isinstance(a, Parts) for a in args):
        return fn(*args)
    return Parts(g, [g.run(p, fn, *[a.blocks[p] if isinstance(a, Parts)
                                    else a for a in args])
                     for p in range(g.size)], dim)


def transpose(w):
    """A 2-D leaf transposed (a :class:`TpLeaf` keeps its blocks' cut)."""
    if not isinstance(w, TpLeaf):
        return w.T
    return TpLeaf(w.group, [b.T for b in w.blocks],
                  None if w.dim is None else 1 - w.dim, w.shape[::-1])


def lookup(table, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]``.  A table cut over its rows (the vocab) is looked
    up by each position in its own range, and each token's row is taken
    from the position that holds it (a selection in position order:
    exact); cut over its columns, each position looks up its columns and
    they are gathered."""
    if not isinstance(table, TpLeaf):
        return table[ids]
    g = table.group
    if table.dim is None:
        return table.blocks[0][ids]
    if table.dim == 1:
        return whole(Parts(g, [g.run(p, lambda t, i: t[i], b, ids)
                               for p, b in enumerate(table.blocks)], -1))
    out, lo = None, 0
    for p, b in enumerate(table.blocks):
        n = b.shape[0]
        rows = g.run(p, lambda t, i, lo=lo, n=n: t[torch.clamp(
            i - lo, 0, n - 1)], b, ids).to(g.lead)
        if out is None:
            out = rows
        else:
            mine = ((ids >= lo) & (ids < lo + n))[..., None]
            out = torch.where(mine, rows, out)
        lo += n
    g.exchanged += _nbytes(out)
    return out


def _head_blocks(g: ModelGroup, t: Value, n: int, hd: int,
                 ranges: Sequence[Tuple[int, int]]) -> Parts:
    """``t`` (B, S, n * hd) as each position's heads of ``ranges``
    (B, S, heads, hd): its own block where it holds exactly those heads,
    else sliced from the whole."""
    if isinstance(t, Parts) and t.dim == -1 and \
            [b.shape[-1] for b in t.blocks] == [(hi - lo) * hd
                                                for lo, hi in ranges]:
        blocks = t.blocks
    else:
        full = whole(t)
        blocks = [full[..., lo * hd:hi * hd] for lo, hi in ranges]
    return Parts(g, [g.run(p, lambda b: b.reshape(*b.shape[:-1], -1, hd),
                           b) for p, b in enumerate(blocks)], 2)


def attention_heads(g: Optional[ModelGroup], q: Value, k: Value, v: Value,
                    H: int, KV: int, hd):
    """q (B, S, H * dq) and k (B, S, KV * dk), v (B, S, KV * dv) as heads,
    ``hd`` the head dim of all three or the triple (dq, dk, dv) (MLA's
    MHA: KV = H, q of nope + rope dims, k of the nope dims alone, whose
    shared rope part the caller adds to each position's heads): without
    a group the reshaped tensors; with one, each position's query heads
    (its column block where q is cut, which must hold whole heads; H /
    size heads each where q is whole) and the kv heads those query heads
    read under the GQA fold (query head h reads kv head h // (H / KV)).
    A position's query heads must fold onto its kv heads as the kernel
    folds them: whole groups, or a part of one group.  Returns (q, k, v,
    kv_ranges)."""
    dq, dk, dv = (hd, hd, hd) if isinstance(hd, int) else hd
    if g is None:
        B, S = q.shape[:2]
        return (q.reshape(B, S, H, dq), k.reshape(B, S, KV, dk),
                v.reshape(B, S, KV, dv), None)
    M, G = g.size, H // KV
    if isinstance(q, Parts) and q.dim == -1:
        widths = [b.shape[-1] for b in q.blocks]
        if any(w % dq for w in widths):
            raise ValueError(f"query column blocks of widths {widths} do "
                             f"not hold whole heads of {dq}")
        counts = [w // dq for w in widths]
    else:
        if H % M:
            raise ValueError(f"{H} query heads do not divide over {M} "
                             "positions")
        counts = [H // M] * M
    q_ranges, lo = [], 0
    for c in counts:
        q_ranges.append((lo, lo + c))
        lo += c
    kv_ranges = []
    for a, b in q_ranges:
        if not (a % G == 0 and (b - a) % G == 0) and a // G != (b - 1) // G:
            raise ValueError(f"query heads [{a}, {b}) of a position do not "
                             f"fold onto whole kv heads (group {G})")
        kv_ranges.append((a // G, (b - 1) // G + 1))
    return (_head_blocks(g, q, H, dq, q_ranges),
            _head_blocks(g, k, KV, dk, kv_ranges),
            _head_blocks(g, v, KV, dv, kv_ranges), kv_ranges)


def kv_whole(t: Value, ranges) -> torch.Tensor:
    """The positions' kv heads (B, S, heads, hd) put back together, each
    head from the first position that holds it (exact)."""
    if not isinstance(t, Parts):
        return t
    g, blocks, seen = t.group, [], 0
    for (lo, hi), b in zip(ranges, t.blocks):
        if hi > seen:
            blocks.append(b[:, :, seen - lo:].to(g.lead))
            seen = hi
    out = torch.cat(blocks, dim=2)
    g.exchanged += _nbytes(out)
    return out
