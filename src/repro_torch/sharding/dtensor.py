"""The LM on a device mesh: DTensor parameters laid out by the rules.

The JAX package gives ``jax.jit`` its parameters' ``NamedSharding``s and
lets GSPMD partition the whole step. PyTorch's DTensor propagates
placements op by op and picks its own redistributions; left alone, a
product of a batch-sharded activation and an FSDP-sharded weight gathers
the activation and leaves a partial sum. So the port makes the rules'
layout explicit where the JAX package's scan makes it:

* :meth:`Layout.at_use` gives a layer group's weights with their dp dims
  gathered (``Replicate``) and their tp dim kept, at the group's point of
  use, as GSPMD's all-gather inside the layer scan; its backward
  reduce-scatters the gradients back onto the FSDP shards;
* activations enter batch-sharded over the dp dims (:meth:`Layout.shard`);
* attention runs per rank through ``local_map`` (:meth:`Layout.attend`):
  each rank attends its own batch rows and query heads (a ctypes kernel
  cannot take a DTensor). Where the kv heads do not split over tp as the
  query heads do, k and v are gathered over tp and each rank keeps the kv
  heads of its query heads (or expands them to its query heads, where a
  rank's query heads do not map onto whole kv heads);
* routed experts run per rank through ``local_map`` (:meth:`Layout.moe`):
  each tp rank routes its tokens over every expert, runs its own experts'
  slots and gives a partial sum over tp (expert parallelism).

:func:`distribute_model` turns a model's parameters into DTensors by the
rules; :func:`load_sharded` puts already sharded tensors
(:func:`repro_torch.train.checkpoint.reshard`) into a model.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence

import torch
from torch import nn

from repro_torch.sharding import rules


def _dt():
    from torch.distributed.tensor import DTensor
    return DTensor


# layer kinds whose weights a layer uses gathered over tp as well
_TP_REPLICATED = ("_mlstm.", "_slstm.")

_POINTWISE_DONE = []


def _register_pointwise() -> None:
    """Sharding strategies DTensor lacks for pointwise ops of the model's
    backward passes (``log_sigmoid_backward``: the mLSTM gates): every
    input and the output sharded alike, or all replicated."""
    if _POINTWISE_DONE:
        return
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding
    aten = torch.ops.aten

    @register_sharding(aten.log_sigmoid_backward.default)
    def _log_sigmoid_backward(grad, x, buffer):
        out = [([Replicate()], [Replicate()] * 3)]
        for d in range(x.ndim):
            out.append(([Shard(d)], [Shard(d)] * 3))
        return out

    @register_sharding(aten.log_sigmoid_forward.default)
    def _log_sigmoid_forward(x):
        out = [([Replicate(), Replicate()], [Replicate()])]
        for d in range(x.ndim):
            out.append(([Shard(d), Shard(d)], [Shard(d)]))
        return out

    _POINTWISE_DONE.append(True)


def distribute(t: torch.Tensor, mesh, placements) -> torch.Tensor:
    """``t`` (the same global values on every rank) as a DTensor of
    ``placements``, each rank keeping its own shard (no scatter). A shard
    is copied out of ``t``, so the global tensor is not kept alive by it."""
    from torch.distributed.tensor import distribute_tensor
    out = distribute_tensor(t, mesh, list(placements), src_data_rank=None)
    loc = out.to_local()
    if loc.numel() < t.numel():
        out = _dt().from_local(loc.clone(memory_format=torch.contiguous_format),
                               mesh, out.placements, run_check=False,
                               shape=out.shape, stride=out.stride())
    return out


class _View:
    """A module's attributes with every parameter passed through ``fn``
    (sub-modules likewise; ``view[key]`` reads a ``ModuleDict``'s entry)."""

    def __init__(self, module: nn.Module, fn: Callable, prefix: str = ""):
        for name, child in module.named_children():
            self.__dict__[name] = _View(child, fn, f"{prefix}{name}.")
        for name, p in module.named_parameters(recurse=False):
            self.__dict__[name] = fn(f"{prefix}{name}", p)

    def __getitem__(self, key):
        return self.__dict__[key]


class Layout:
    """How an LM's tensors lie on ``mesh``: ``dp`` the mesh dims of the
    data / FSDP group (``("data",)``, ``("pod", "data")``, or for the
    ``dp_only`` layout every dim), the tp dim ``"model"`` where it is not
    one of them."""

    def __init__(self, mesh, dp: Sequence[str]):
        _register_pointwise()
        self.mesh = mesh
        names = tuple(mesh.mesh_dim_names)
        self.names = names
        self.dp = tuple(n for n in names if n in dp)
        self.tp = "model" if "model" in names and "model" not in dp else None
        self.dp_size = math.prod(mesh.size(names.index(n)) for n in self.dp)
        self.tp_size = mesh.size(names.index(self.tp)) if self.tp else 1

    def batch_sharded(self, b: int) -> bool:
        return rules._fits(b, self.dp_size)

    def shard(self, t: torch.Tensor, spec: Optional[rules.Spec] = None):
        """A global tensor, every rank holding the same values, as a
        DTensor by ``spec`` (default: batch on dp where it divides), each
        rank keeping its own shard (no scatter)."""
        if spec is None:
            spec = rules.batch_specs(t, self.dp, self.tp, self.dp_size)
        return distribute(t, self.mesh, rules.placements(spec, self.mesh))

    def shard_tree(self, tree, specs):
        """A tree (dicts and lists) of global tensors as DTensors by the
        matching tree of ``specs`` (:func:`rules.cache_specs`,
        :func:`rules.batch_specs`), each rank keeping its own shard."""
        if isinstance(tree, dict):
            return {k: self.shard_tree(v, specs[k]) for k, v in tree.items()}
        if isinstance(tree, list):
            return [self.shard_tree(v, s) for v, s in zip(tree, specs)]
        return self.shard(tree, specs)

    def activation(self, x):
        """``x`` ``[B, ...]`` in the activations' layout: batch on dp
        (where it divides), replicated over tp (an embedding's partial sum
        over the vocab shards reduced here)."""
        if not isinstance(x, _dt()):
            return x
        batch = 0 if self.batch_sharded(x.shape[0]) else None
        return x.redistribute(self.mesh, self.pl(batch))

    def replicate_tp(self, t):
        """``t`` gathered over tp (its dp placements kept)."""
        from torch.distributed.tensor import Replicate
        if not isinstance(t, _dt()) or self.tp is None:
            return t
        return t.redistribute(self.mesh, [
            Replicate() if n == self.tp else q
            for n, q in zip(self.names, t.placements)])

    # -- weights at their point of use ------------------------------------

    def _gather(self, path: str, p):
        from torch.distributed.tensor import Replicate, Shard
        if not isinstance(p, _dt()):
            return p
        name = path.rsplit(".", 1)[-1]
        # a head weight whose head count does not divide tp has its
        # head_dim on tp (the rules' fallback); a layer flattens (heads,
        # head_dim), which DTensor cannot shard: gather it over tp too
        minor = {"wq": 2, "wk": 2, "wv": 2, "wo": 1, "wq_b": 2, "wk_b": 2,
                 "wv_b": 2}.get(name) if p.ndim == 3 else None
        # the xLSTM blocks fold heads into their products' batch dims,
        # which DTensor cannot shard either: they run replicated over tp
        whole = any(k in path for k in _TP_REPLICATED)
        want = [Replicate() if n in self.dp or (n == self.tp and (
                    whole or isinstance(q, Shard) and q.dim == minor))
                else q for n, q in zip(self.names, p.placements)]
        if list(want) == list(p.placements):
            return p
        return p.redistribute(self.mesh, want)

    def at_use(self, module: nn.Module) -> _View:
        """``module``'s weights as a layer uses them: dp dims gathered."""
        return _View(module, self._gather)

    # -- per-rank regions ------------------------------------------------

    def pl(self, batch_dim: Optional[int] = None, tp_dim: Optional[int] = None,
           *, dp_partial: Optional[str] = None,
           tp_partial: Optional[str] = None) -> list:
        """Placements: ``batch_dim`` on the dp dims (or ``Partial(
        dp_partial)`` there), ``tp_dim`` on tp (or ``Partial(tp_partial)``
        there), else ``Replicate``."""
        from torch.distributed.tensor import Partial, Replicate, Shard
        out = []
        for n in self.names:
            if n in self.dp:
                out.append(Partial(dp_partial) if dp_partial else
                           Shard(batch_dim) if batch_dim is not None
                           else Replicate())
            elif n == self.tp:
                out.append(Partial(tp_partial) if tp_partial else
                           Shard(tp_dim) if tp_dim is not None
                           else Replicate())
            else:
                out.append(Replicate())
        return out

    @staticmethod
    def _rows_sum(batch: Optional[int]) -> Optional[str]:
        """How a weight's gradient lies over dp in a per-rank region: a
        part of a sum where each rank holds its own batch rows; whole (the
        same on every rank) where every rank computes all of them."""
        return "sum" if batch is not None else None

    def per_rank(self, fn: Callable, args: Sequence, in_pl: Sequence,
                 out_pl, grad_pl: Optional[Sequence] = None):
        """``fn`` on each rank's local tensors, as ``local_map`` does, with
        the gradients placed as they are: ``args`` redistributed to
        ``in_pl`` (``None``: passed as is); ``grad_pl`` the placements of
        each input's local gradient (``Partial`` where a rank uses the
        input for a part of a sum: a weight replicated over the batch
        shards, an activation replicated over tp whose vocab or experts a
        rank holds a share of; default ``in_pl``); ``out_pl`` the outputs'
        placements (one list, or one per output): a ``Partial`` output's
        local part gets the whole gradient (an average's its share) —
        ``local_map`` would instead split a replicated gradient over the
        ranks of a partial sum."""
        grad_pl = in_pl if grad_pl is None else grad_pl
        local = []
        for a, p, g in zip(args, in_pl, grad_pl):
            if p is None or not isinstance(a, _dt()):
                local.append(a)
            else:
                local.append(a.redistribute(self.mesh, p).to_local(
                    grad_placements=g))
        out = fn(*local)
        if isinstance(out, tuple):
            return tuple(_FromLocal.apply(o, self.mesh, tuple(p))
                         for o, p in zip(out, out_pl))
        return _FromLocal.apply(out, self.mesh, tuple(out_pl))

    # -- the token embedding ----------------------------------------------

    def _vocab(self, w, dim: int) -> bool:
        from torch.distributed.tensor import Shard
        return self.tp is not None and any(
            isinstance(q, Shard) and q.dim == dim and n == self.tp
            for n, q in zip(self.names, w.placements))

    def embed(self, w, ids):
        """``F.embedding(ids, w)`` per rank (Megatron's vocab-parallel
        lookup): ``w`` ``[V, D]`` at its point of use, its vocab over tp
        where the rules put it there; each rank looks up the ids of its
        vocab shard, zeros the others, and the sum over tp (a partial
        result, reduced by :meth:`activation`) is the lookup."""
        import torch.nn.functional as F
        vocab = self._vocab(w, 0)
        batch = 0 if self.batch_sharded(ids.shape[0]) else None
        rows = w.shape[0] // self.tp_size if vocab else w.shape[0]
        lo = self.mesh.get_local_rank(self.tp) * rows if vocab else 0

        def local(wl, il):
            il = il.long()
            if not vocab:
                return F.embedding(il, wl)
            out = (il < lo) | (il >= lo + rows)
            y = F.embedding((il - lo).masked_fill(out, 0), wl)
            return y.masked_fill(out.unsqueeze(-1), 0.0)

        w_pl = self.pl(None, 0 if vocab else None)
        return self.per_rank(
            local, (w, ids), (w_pl, self.pl(batch)),
            self.pl(batch, tp_partial="sum" if vocab else None),
            grad_pl=(self.pl(None, 0 if vocab else None,
                             dp_partial=self._rows_sum(batch)),
                     None))

    # -- the loss --------------------------------------------------------

    def xent_sums(self, x, w, labels, mask, *, plain: Callable):
        """``plain(x, w, labels, mask)`` (:func:`repro_torch.models.lm.
        _xent_sums`: ``(sum of the masked losses, sum of the mask)``) on a
        mesh: x ``[B, c, D]``, w ``[D, V]`` at its point of use, labels
        and mask ``[B, c]``. Without the vocab on tp, ``plain`` runs per
        rank on its batch rows and the sums add over dp. With it
        (Megatron's vocab-parallel cross entropy), each rank computes its
        vocab shard's logits; their row maximum (one pass without a
        gradient), the sum of exp(logit − max) and the gold logit are
        reduced over tp."""
        vocab = self._vocab(w, 1)
        batch = 0 if self.batch_sharded(x.shape[0]) else None
        rows = self.pl(batch)
        w_pl = self.pl(None, 1 if vocab else None)
        if not vocab:
            sums = self.pl(dp_partial=self._rows_sum(batch))
            return self.per_rank(
                plain, (x, w, labels, mask), (rows, w_pl, rows, rows),
                (sums, sums), grad_pl=(rows, self.pl(
                    dp_partial=self._rows_sum(batch)),
                    None, None))
        part = self.pl(batch, tp_partial="sum" if vocab else None)
        cols = w.shape[1] // self.tp_size if vocab else w.shape[1]
        lo = self.mesh.get_local_rank(self.tp) * cols if vocab else 0

        def logits(xl, wl):
            return (xl @ wl.to(xl.dtype)).float()

        with torch.no_grad():
            m = self.per_rank(lambda xl, wl: logits(xl, wl).amax(-1),
                              (x, w), (rows, w_pl),
                              self.pl(batch, tp_partial="max" if vocab
                                      else None))
            m = m.redistribute(self.mesh, rows)

        def local(xl, wl, ll, ml):
            lg = logits(xl, wl)
            se = torch.exp(lg - ml.unsqueeze(-1)).sum(-1)
            ll = ll.long() - lo
            inside = (ll >= 0) & (ll < cols)
            gold = torch.gather(lg, -1, ll.clamp(0, cols - 1).unsqueeze(-1))
            return se, torch.where(inside, gold.squeeze(-1), 0.0)

        se, gold = self.per_rank(
            local, (x, w, labels, m), (rows, w_pl, rows, rows), (part, part),
            grad_pl=(self.pl(batch, tp_partial="sum" if vocab else None),
                     self.pl(None, 1 if vocab else None,
                             dp_partial=self._rows_sum(batch)),
                     None, None))
        se = se.redistribute(self.mesh, rows)
        gold = gold.redistribute(self.mesh, rows)
        logz = m + torch.log(se)
        mask = mask.redistribute(self.mesh, rows)
        return torch.sum((logz - gold) * mask), torch.sum(mask)

    # -- attention -------------------------------------------------------

    def attend(self, inner: Callable) -> Callable:
        """``inner(q, k, v, causal=)`` run per rank on its batch rows and
        query heads; q ``[B, Hq, Sq, d]``, k / v ``[B, Hkv, Skv, d]``."""

        def fn(q, k, v, causal: bool = True):
            if not isinstance(q, _dt()):
                return inner(q, k, v, causal=causal)
            return self._attend(inner, q, k, v, causal)

        return fn

    def _attend(self, inner, q, k, v, causal):
        b, hq = q.shape[:2]
        hkv = k.shape[1]
        g = hq // hkv
        batch = 0 if self.batch_sharded(b) else None
        heads = self.tp_size > 1 and hq % self.tp_size == 0
        kv_heads = heads and hkv % self.tp_size == 0
        q_pl = self.pl(batch, 1 if heads else None)
        kv_pl = self.pl(batch, 1 if kv_heads else None)
        # k, v gathered over tp for a rank's share of the query heads:
        # their gradient is that rank's part of a sum
        kv_grad = self.pl(batch, 1 if kv_heads else None,
                          tp_partial="sum" if heads and not kv_heads
                          else None)
        n_local = hq // self.tp_size if heads else hq
        lo = self.mesh.get_local_rank(self.tp) * n_local if heads else 0

        def local(ql, kl, vl):
            if heads and not kv_heads:
                if g % n_local == 0 or n_local % g == 0:
                    # this rank's query heads use whole kv heads
                    k0, k1 = lo // g, (lo + n_local - 1) // g + 1
                    kl, vl = kl[:, k0:k1], vl[:, k0:k1]
                else:
                    kl = kl.repeat_interleave(g, 1)[:, lo:lo + n_local]
                    vl = vl.repeat_interleave(g, 1)[:, lo:lo + n_local]
            return inner(ql.contiguous(), kl.contiguous(), vl.contiguous(),
                         causal=causal)

        return self.per_rank(local, (q, k, v), (q_pl, kv_pl, kv_pl), q_pl,
                             grad_pl=(q_pl, kv_grad, kv_grad))

    # -- decode caches ---------------------------------------------------

    def decode_attend(self, scores: Callable, finish: Callable, q, k, v):
        """One decode step's attention against its cache, ``finish(
        scores(q, k), v)`` (q ``[B, Hq, 1, d]``, k / v ``[B, Hkv, S, d]``),
        per rank on its batch rows and, where the cache has its kv heads
        on tp and the query heads divide, its heads. Where the cache has
        its head_dim on tp, q is split alike: each rank's scores are a part
        of the sum over d, all-reduced before ``finish`` (the scores are
        ``S`` wide, the cache ``S × d``); its output's head_dim shards are
        gathered. A cache with its positions on tp is gathered over tp."""
        from torch.distributed.tensor import Partial, Replicate, Shard
        if not isinstance(k, _dt()):
            return finish(scores(q, k), v)
        qw, kw, sw, fw = [], [], [], []     # q, k/v, scores, reduced scores
        for i, pk in enumerate(k.placements):
            whole = isinstance(pk, Shard) and (pk.dim == 0 or (
                pk.dim == 1 and q.shape[1] % self.mesh.size(i) == 0))
            if whole:
                qw.append(Shard(pk.dim))
                kw.append(pk)
                sw.append(Shard(pk.dim))
                fw.append(Shard(pk.dim))
            elif isinstance(pk, Shard) and pk.dim == 3:
                qw.append(Shard(3))
                kw.append(pk)
                sw.append(Partial())
                fw.append(Replicate())
            else:
                qw.append(Replicate())
                kw.append(Replicate())
                sw.append(Replicate())
                fw.append(Replicate())
        s = self.per_rank(scores, (q, k), (qw, kw), sw)
        s = s.redistribute(self.mesh, fw)
        out = self.per_rank(finish, (s, v), (fw, kw), qw)
        return out.redistribute(self.mesh, [
            Replicate() if isinstance(p, Shard) and p.dim == 3 else p
            for p in qw])

    @staticmethod
    def cache_write(t, dim: int, start: int, new) -> None:
        """``t`` along ``dim`` from ``start`` = ``new``, in place, on a
        DTensor cache: each rank writes the part that lies in its shard
        (a cache sharded along ``dim`` is written by the ranks holding
        those positions only)."""
        from torch.distributed.tensor import Replicate, Shard
        mesh = t.device_mesh
        pl = [Replicate() if isinstance(p, Shard) and p.dim == dim else p
              for p in t.placements]
        nl = new.redistribute(mesh, pl).to_local()
        tl = t.to_local()
        # this rank's first position along dim (torch.chunk's split)
        lo, n = 0, t.shape[dim]
        for i, p in enumerate(t.placements):
            if isinstance(p, Shard) and p.dim == dim:
                step = -(-n // mesh.size(i))
                c = mesh.get_local_rank(i)
                lo, n = lo + c * step, max(0, min(step, n - c * step))
        a = max(start, lo)
        b = min(start + new.shape[dim], lo + tl.shape[dim])
        if a < b:
            tl.narrow(dim, a - lo, b - a).copy_(nl.narrow(dim, a - start,
                                                          b - a))

    # -- routed experts --------------------------------------------------

    def moe(self, apply_moe: Callable, p, x, *, n_experts: int, **kw):
        """``apply_moe(p, x, n_experts=, ...)`` with the experts split over
        tp (where ``n_experts`` divides): each rank routes its batch rows
        over every expert, runs the slots of its own experts and returns a
        partial sum over tp; the load-balancing loss from the routing
        statistics averaged over the dp ranks."""
        if not isinstance(x, _dt()):
            return apply_moe(p, x, n_experts=n_experts, **kw)
        ep = self.tp_size > 1 and n_experts % self.tp_size == 0
        batch = 0 if self.batch_sharded(x.shape[0]) else None
        # the tokens are cut into groups of g with a capacity each; where a
        # rank's rows do not make whole groups and slots can be dropped,
        # every rank routes all the tokens, as one unsharded layer does
        n_tok = math.prod(x.shape[:-1])
        g = min(kw.get("group_size", 512), n_tok)
        drops = kw.get("capacity_factor", 1.25) < n_experts / kw["top_k"]
        if batch is not None and drops and (n_tok // self.dp_size) % g:
            batch = None
        names = [n for n in ("router", "wi", "wg", "wo", "wi_scale",
                             "wg_scale", "wo_scale") if n in p.__dict__]
        part = "sum" if ep else None
        w_pl = [self.pl(None, 0 if ep and n != "router" else None)
                for n in names]
        # a weight serves this rank's batch rows (a part of a sum over dp);
        # with experts split, x and the router serve this rank's experts
        w_grad = [self.pl(None, 0 if ep and n != "router" else None,
                          dp_partial=self._rows_sum(batch),
                          tp_partial=part if n == "router" else None)
                  for n in names]
        n_local = n_experts // self.tp_size if ep else n_experts
        first = self.mesh.get_local_rank(self.tp) * n_local if ep else 0
        # the routing statistics are the same on every tp rank: each gives
        # 1/tp of them, so their sum over tp (and its gradient) is whole
        share = self.tp_size if ep else 1
        stat_pl = self.pl(dp_partial="avg" if batch is not None else None,
                          tp_partial=part)

        def local(xl, *ws):
            pl = _View.__new__(_View)
            pl.__dict__.update(zip(names, ws))
            y, (frac, mean_p) = apply_moe(pl, xl, n_experts=n_experts,
                                          experts=(first, n_local),
                                          return_stats=True, **kw)
            return y, frac / share, mean_p / share

        y, frac, mean_p = self.per_rank(
            local, (x, *(p.__dict__[n] for n in names)),
            (self.pl(batch), *w_pl),
            (self.pl(batch, tp_partial=part), stat_pl, stat_pl),
            grad_pl=(self.pl(batch, tp_partial=part), *w_grad))
        aux = torch.sum(frac * mean_p) * n_experts
        return y, aux


class _FromLocal(torch.autograd.Function):
    """A rank's local tensor as a DTensor of ``placements``. Backward: a
    ``Partial`` dim's local part gets the whole gradient there (an
    average's its share)."""

    @staticmethod
    def forward(ctx, t, mesh, placements):
        ctx.mesh, ctx.placements = mesh, placements
        return _dt().from_local(t, mesh, list(placements), run_check=False)

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import Replicate
        want = [Replicate() if q.is_partial() else q for q in ctx.placements]
        gl = g.redistribute(ctx.mesh, want).to_local()
        for i, q in enumerate(ctx.placements):
            if q.is_partial() and q.reduce_op == "avg":
                gl = gl / ctx.mesh.size(i)
        return gl, None, None


# ---------------------------------------------------------------------------
# the model's parameters as DTensors
# ---------------------------------------------------------------------------

def load_sharded(model: nn.Module, tensors: Dict[str, torch.Tensor],
                 layout: Layout) -> nn.Module:
    """Put ``tensors`` ``{parameter name: DTensor}`` into ``model`` as its
    parameters (each keeps its ``requires_grad``), and give the model the
    ``layout`` its steps read. Returns ``model``."""
    for name, p in list(model.named_parameters()):
        mod_name, _, leaf = name.rpartition(".")
        mod = model.get_submodule(mod_name) if mod_name else model
        t = tensors[name]
        if tuple(t.shape) != tuple(p.shape):
            raise ValueError(f"{name}: {tuple(t.shape)} != {tuple(p.shape)}")
        setattr(mod, leaf, nn.Parameter(t, requires_grad=p.requires_grad))
    model.layout = layout
    return model


def distribute_model(model: nn.Module, layout: Layout,
                     specs: Dict[str, rules.Spec]) -> nn.Module:
    """``model``'s parameters as DTensors laid out by ``specs``
    (:func:`rules.param_specs`), in place. Every rank must hold the same
    values: each keeps its own shard (no scatter)."""
    tensors = {name: distribute(p.detach(), layout.mesh,
                                rules.placements(specs[name], layout.mesh))
               for name, p in model.named_parameters()}
    return load_sharded(model, tensors, layout)
