"""The port's sharding rules, LM shapes and input specs against the JAX
package's.

* Every parameter group's spec of all ten architectures at 16x16, at
  2x16x16 (32 x 16) and at the ``dp_only`` 256 x 1 layout equals
  ``repro.sharding.rules.param_specs`` on ``jax.eval_shape(init_params)``
  with its leading (layer-group) ``None`` removed; the port's model is
  built on ``meta``.
* ``batch_specs`` and ``cache_specs`` on every shape's ``input_specs``,
  ``LM_SHAPES`` and ``shape_applicable`` are equal; ``input_specs``'
  shapes and dtypes equal the JAX ``ShapeDtypeStruct``s.
* On a 2x4 mesh the block each rank holds (``distribute_tensor`` by
  :func:`rules.placements`, one fake group a rank, in a subprocess) equals
  ``NamedSharding(...).devices_indices_map`` (8 virtual CPU devices with
  ``AxisType.Auto`` axes, in another subprocess).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import config as jax_config
from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.configs import get_arch as jax_get_arch
from repro.models import lm as jax_lm
from repro.sharding import rules as jax_rules
from repro_torch import config
from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.models import lm
from repro_torch.models.convert import _path
from repro_torch.sharding import rules

SRC = Path(__file__).resolve().parents[1] / "src"
TIMEOUT = 120
# (layout, dp, tp, dp_size, tp_size) as the JAX package's dry run sets them
LAYOUTS = [("16x16", ("data",), "model", 16, 16),
           ("2x16x16", ("pod", "data"), "model", 32, 16),
           ("dp_only", ("data", "model"), "model", 256, 1)]


def norm(spec):
    """A spec's entries as tuples of names (or None)."""
    out = []
    for e in spec:
        if e is None:
            out.append(None)
        else:
            out.append(tuple(e) if isinstance(e, (tuple, list)) else (e,))
    return tuple(out)


@pytest.fixture(scope="module")
def jax_shapes():
    return {a: jax.eval_shape(
        lambda c=jax_get_arch(a): jax_lm.init_params(jax.random.PRNGKey(0),
                                                     c, jnp.float32))
        for a in JAX_ARCH_IDS}


def test_arch_registries_agree():
    assert tuple(ARCH_IDS) == tuple(JAX_ARCH_IDS)


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda l: l[0])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_match_jax(jax_shapes, arch, layout):
    _, dp, tp, dp_size, tp_size = layout
    cfg = get_arch(arch)
    jspecs = jax_rules.param_specs(jax_shapes[arch], jax_get_arch(arch), dp,
                                   tp, dp_size, tp_size)
    model = lm.init_params(cfg, device="meta")
    got = rules.param_specs(model, cfg, dp, tp, dp_size, tp_size)
    assert set(got) == {n for n, _ in model.named_parameters()}
    for name, spec in got.items():
        path, group = _path(name)
        node = jspecs
        for key in path:
            node = node[key]
        want = norm(node)
        if group is not None:
            assert want[0] is None, name
            want = want[1:]
        assert norm(spec) == want, (name, spec, want)


def test_lm_shapes_and_applicability_match_jax():
    assert [tuple(vars(s).values()) for s in config.LM_SHAPES] == \
        [tuple(vars(s).values()) for s in jax_config.LM_SHAPES]
    assert list(config.SHAPES_BY_NAME) == list(jax_config.SHAPES_BY_NAME)
    for arch in ARCH_IDS:
        for ts, js in zip(config.LM_SHAPES, jax_config.LM_SHAPES):
            assert config.shape_applicable(get_arch(arch), ts) == \
                jax_config.shape_applicable(jax_get_arch(arch), js)


_DT = {torch.int32: jnp.int32, torch.bfloat16: jnp.bfloat16,
       torch.float32: jnp.float32}


def _leaves(tree):
    if isinstance(tree, dict):
        return [(k,) + p for k in sorted(tree) for p in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "shape"):
        return [(i,) + p for i, v in enumerate(tree) for p in _leaves(v)]
    return [()]


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_batch_and_cache_specs_match_jax(arch):
    cfg, jcfg = get_arch(arch), jax_get_arch(arch)
    for ts, js in zip(config.LM_SHAPES, jax_config.LM_SHAPES):
        got = lm.input_specs(cfg, ts)
        want = jax_lm.input_specs(jcfg, js)
        paths = _leaves(got)
        assert paths == _leaves(want), (arch, ts.name)
        for path in paths:
            g, w = _at(got, path), _at(want, path)
            assert g.device.type == "meta"
            assert tuple(g.shape) == tuple(w.shape), (arch, ts.name, path)
            assert _DT[g.dtype] == w.dtype, (arch, ts.name, path)
        for _, dp, tp, dp_size, tp_size in LAYOUTS:
            batch = {k: v for k, v in got.items() if k != "cache"}
            jbatch = {k: v for k, v in want.items() if k != "cache"}
            gb = rules.batch_specs(batch, dp, tp, dp_size)
            wb = jax_rules.batch_specs(jbatch, dp, tp, dp_size)
            for k in batch:
                assert norm(gb[k]) == norm(wb[k]), (arch, ts.name, k)
            if "cache" in got:
                gc = rules.cache_specs(got["cache"], dp, tp, dp_size, tp_size)
                wc = jax_rules.cache_specs(want["cache"], dp, tp, dp_size,
                                           tp_size)
                for path in _leaves(got["cache"]):
                    assert norm(_at(gc, path)) == norm(_at(wc, path)), \
                        (arch, ts.name, path)


def test_placements_put_a_dim_over_two_mesh_dims_major_to_minor():
    from torch.distributed.tensor import Replicate, Shard

    class Mesh:
        mesh_dim_names = ("pod", "data", "model")

    assert rules.placements((("pod", "data"), "model"), Mesh()) == \
        [Shard(0), Shard(0), Shard(1)]
    assert rules.placements((None, "data"), Mesh()) == \
        [Replicate(), Shard(1), Replicate()]


# ---------------------------------------------------------------------------
# the blocks a rank holds on a 2x4 mesh
# ---------------------------------------------------------------------------

# (shape, spec) cases on a ("data", "model") 2x4 mesh
BLOCK_CASES = [
    ((16, 8), ("data", "model")),
    ((16, 8), ("model", "data")),
    ((8, 12, 4), (None, "model", "data")),
    ((16, 6), (("data", "model"), None)),
    ((4, 8, 6), ("data", None, None)),
    ((6, 10), (None, None)),
]

_PORT_BLOCKS = r"""
import json, sys
import torch, torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import distribute_tensor
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.sharding.rules import placements
cases = json.loads(sys.argv[1])
out = []
for shape, spec in cases:
    spec = [tuple(e) if isinstance(e, list) else e for e in spec]
    blocks = []
    for rank in range(8):
        dist.init_process_group("fake", store=FakeStore(), rank=rank,
                                world_size=8)
        mesh = DeviceMesh("cpu", torch.arange(8).reshape(2, 4),
                          mesh_dim_names=("data", "model"))
        n = 1
        for d in shape:
            n *= d
        full = torch.arange(n).reshape(shape)
        loc = distribute_tensor(full, mesh, placements(spec, mesh),
                                src_data_rank=None).to_local()
        idx = torch.nonzero(full[..., None] == loc.reshape(-1)).tolist()
        lo = [min(i[d] for i in idx) for d in range(len(shape))]
        hi = [max(i[d] for i in idx) + 1 for d in range(len(shape))]
        blocks.append([[a, b] for a, b in zip(lo, hi)])
        dist.destroy_process_group()
    out.append(blocks)
print(json.dumps(out))
"""

_JAX_BLOCKS = r"""
import json, sys
import jax, numpy as np
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
assert jax.device_count() == 8, jax.devices()
mesh = jax.make_mesh((2, 4), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
cases = json.loads(sys.argv[1])
out = []
for shape, spec in cases:
    spec = [tuple(e) if isinstance(e, list) else e for e in spec]
    idx = NamedSharding(mesh, P(*spec)).devices_indices_map(tuple(shape))
    order = list(mesh.devices.reshape(-1))
    blocks = []
    for dev in order:
        sl = idx[dev]
        blocks.append([[s.start or 0, shape[d] if s.stop is None else s.stop]
                       for d, s in enumerate(sl)])
    out.append(blocks)
print(json.dumps(out))
"""


def _run(code, env):
    res = subprocess.run([sys.executable, "-c", code, json.dumps(BLOCK_CASES)],
                         env=env, capture_output=True, text=True,
                         timeout=TIMEOUT)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


def test_rank_blocks_match_jax_devices_indices_map():
    base = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu")
    port = _run(_PORT_BLOCKS, base)
    jx = _run(_JAX_BLOCKS, dict(
        base, XLA_FLAGS="--xla_force_host_platform_device_count=8"))
    assert port == jx
