"""Partitioning rules: parameter, batch and cache layouts on a mesh.

A port of ``repro.sharding.rules``, with the same decision procedure.
Scheme: a 2D logical layout on mesh dims (dp, tp), where dp is the
data / FSDP group — ``("data",)`` on one pod, ``("pod", "data")`` on two —
and tp = ``"model"`` carries tensor / expert parallelism.

* dense weights: contraction dim on dp (FSDP; gathered at each layer's
  point of use), output-feature / head dim on tp (Megatron-style TP);
* MoE expert stacks: expert dim on tp (EP congruent with TP), d_model on dp;
* embeddings / lm head: vocab on tp, d_model on dp;
* caches: batch on dp, heads (or the widest feature dim) on tp.

Everything falls back to a divisibility-checked heuristic, so reduced
configs (tiny dims) simply replicate.

A spec has the JAX form: one entry per tensor dim, each a mesh-dim name, a
tuple of names or ``None``. The JAX package stacks a segment's groups and
gives its leaves a leading ``None``; the port holds one parameter per group
(``segments.0.3.0_dense.attn.wq`` is group 3), so its spec is the JAX
spec without that ``None``. :func:`placements` turns a spec into DTensor
placements on a mesh.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

from repro_torch.config import ArchConfig

Spec = Tuple[Any, ...]


def axes_for_mesh(multi_pod: bool) -> Tuple[Tuple[str, ...], str]:
    dp = ("pod", "data") if multi_pod else ("data",)
    return dp, "model"


def _fits(dim: int, size: int) -> bool:
    return dim >= size and dim % size == 0


def _param_spec(path: str, shape, dp, tp, dp_size: int,
                tp_size: int) -> Spec:
    """Spec for one parameter (one layer group's: no scan dim)."""
    dims = list(shape)
    nd = len(dims)
    spec = [None] * nd

    def put(d, axis, size):
        if size <= 1 or axis is None:
            return False   # axis unused in this layout (e.g. dp_only: tp=1)
        if 0 <= d < nd and spec[d] is None and _fits(dims[d], size):
            spec[d] = axis
            return True
        return False

    leaf = path.rsplit("/", 1)[-1]
    if leaf == "tokens" or "embed" in path:          # [V, D]
        put(0, tp, tp_size)
        put(1, dp, dp_size)
    elif "lm_head" in path:                          # [D, V]
        put(1, tp, tp_size)
        put(0, dp, dp_size)
    elif leaf in ("wq", "wk", "wv") and nd == 3:     # [D, H, hd]
        put(1, tp, tp_size) or put(2, tp, tp_size)
        put(0, dp, dp_size)
    elif leaf == "wo" and nd == 3 and "moe" not in path:  # [H, hd, D]
        put(0, tp, tp_size) or put(1, tp, tp_size)
        put(2, dp, dp_size)
    elif "moe" in path and nd == 3:                  # [E, D, F] / [E, F, D]
        put(0, tp, tp_size)
        put(1, dp, dp_size) if leaf in ("wi", "wg") else put(2, dp, dp_size)
    elif leaf == "router":                           # [D, E]
        put(0, dp, dp_size)
    elif leaf in ("wq_b", "wk_b", "wv_b") and nd == 3:  # [r, H, x]
        put(1, tp, tp_size)
    elif leaf in ("wq_a", "wkv_a", "wk_rope"):       # [D, r]
        put(0, dp, dp_size)
    elif leaf in ("wi", "wg", "wx", "wgate", "w_up", "w_gate", "wz",
                  "wo_gate") and nd == 2:            # [D, F]-like
        put(1, tp, tp_size)
        put(0, dp, dp_size)
    elif leaf in ("wo", "w_down") and nd == 2:       # [F, D]-like
        put(0, tp, tp_size)
        put(1, dp, dp_size)
    elif leaf == "w_if" and nd == 2:                 # [W, 2H]
        put(0, dp, dp_size)
    elif leaf in ("wa",) and nd == 2:                # [W, W] recurrent gates
        put(1, tp, tp_size)
    elif leaf == "w" and nd == 2 and "conv" in path:  # [K, W]
        put(1, tp, tp_size)
    elif nd >= 2:
        # fallback: tp on last fitting dim, dp on first remaining
        for d in range(nd - 1, -1, -1):
            if put(d, tp, tp_size):
                break
        for d in range(nd):
            if spec[d] is None and put(d, dp, dp_size):
                break
    return tuple(spec)


def jax_path(name: str) -> str:
    """A port parameter's JAX tree path, ``/``-joined, without the group:
    ``segments.0.3.0_dense.attn.wq`` -> ``segments/0/0_dense/attn/wq``."""
    from repro_torch.models.convert import _path
    path, _ = _path(name)
    return "/".join(str(k) for k in path)


def param_specs(model, cfg: ArchConfig, dp, tp, dp_size: int,
                tp_size: int) -> Dict[str, Spec]:
    """``{parameter name: spec}`` for every parameter of ``model`` (an
    :class:`~repro_torch.models.lm.LM`, on any device, ``meta`` included)."""
    return {name: _param_spec(jax_path(name), tuple(p.shape), dp, tp,
                              dp_size, tp_size)
            for name, p in model.named_parameters()}


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def batch_specs(batch_tree, dp, tp, dp_size: int):
    """Input batches: batch dim on dp when divisible; else replicate."""

    def one(leaf):
        shape = tuple(leaf.shape)
        if len(shape) == 0:
            return ()
        spec = [None] * len(shape)
        if _fits(shape[0], dp_size):
            spec[0] = dp
        return tuple(spec)

    return _tree_map(one, batch_tree)


def cache_specs(cache_tree, dp, tp, dp_size: int, tp_size: int):
    """Decode caches ``[G, B, ...]``: B on dp; heads / feature dim on tp."""

    def one(leaf):
        shape = tuple(leaf.shape)
        nd = len(shape)
        spec = [None] * nd
        # dim 0 is the stacked layer groups; dim 1 is batch
        if nd >= 2 and _fits(shape[1], dp_size) and shape[1] > 1:
            spec[1] = dp
        # tp: prefer the head dim (2), then the last dim, then the seq dim
        if tp_size > 1:
            for d in ([2, nd - 1, 3] if nd >= 4 else [nd - 1]):
                if 2 <= d < nd and spec[d] is None and _fits(shape[d], tp_size):
                    spec[d] = tp
                    break
        return tuple(spec)

    return _tree_map(one, cache_tree)


def _names(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def placements(spec: Spec, mesh) -> list:
    """DTensor placements of ``spec`` on ``mesh`` (one per mesh dim): a
    tensor dim over ``("pod", "data")`` is ``Shard(d)`` on both mesh dims,
    major to minor; a mesh dim no entry names replicates."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        for name in _names(entry):
            out[names.index(name)] = Shard(d)
    return out
