"""The port's launch layer on the CPU against the JAX package: the shape
cells and parameter counts (``common/config.py``), the parameters' and
caches' logical axes (``models/param.py``, ``LM.cache_shapes``), the
logical-to-mesh rules (``common/sharding.py``), the cells' abstract
inputs (``launch/specs.py``), the roofline's analytic terms
(``launch/roofline.py``), and the dry run's operation count on meta
tensors (``launch/dryrun.py``) against a count from the config's shapes.

Every comparison is exact: integers, shapes, dtypes, axis names, specs.
The reference's ``logical_to_mesh`` reads only its mesh's ``axis_names``,
so it is called here with an object that has just those.
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from repro.common import config as jconfig  # noqa: E402
from repro.common import sharding as jsharding  # noqa: E402
from repro.configs import ASSIGNED as JAX_ASSIGNED  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.launch import roofline as jroofline  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.models import LM as JaxLM  # noqa: E402
from repro.models.param import axes_tree as jax_axes_tree  # noqa: E402

from repro_torch.bridge import flatten  # noqa: E402
from repro_torch.common import config as tconfig  # noqa: E402
from repro_torch.common import sharding as tsharding  # noqa: E402
from repro_torch.configs import ASSIGNED, get_config  # noqa: E402
from repro_torch.launch import roofline as troofline  # noqa: E402
from repro_torch.launch import specs as tspecs  # noqa: E402
from repro_torch.launch.dryrun import run_cell  # noqa: E402
from repro_torch.models.model import LM, cache_shapes  # noqa: E402
from repro_torch.models.param import axes_tree  # noqa: E402

CELLS = [(a, c) for a in ASSIGNED
         for c in tconfig.applicable_cells(get_config(a))]
AXIS_NAMES = [("data", "model"), ("pod", "data", "model")]


def test_assigned_archs_and_shape_cells_equal_the_reference():
    assert ASSIGNED == JAX_ASSIGNED
    assert {k: vars(v) for k, v in tconfig.SHAPE_CELLS.items()} == \
        {k: vars(v) for k, v in jconfig.SHAPE_CELLS.items()}


@pytest.mark.parametrize("arch", ASSIGNED)
def test_cells_and_parameter_counts_equal_the_reference(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    assert tconfig.applicable_cells(cfg) == jconfig.applicable_cells(jcfg)
    assert cfg.n_params_dense_equiv() == jcfg.n_params_dense_equiv()
    assert cfg.n_params_active() == jcfg.n_params_active()
    assert (cfg.grad_accum, cfg.sub_quadratic, cfg.has_attention) == \
        (jcfg.grad_accum, jcfg.sub_quadratic, jcfg.has_attention)


def _ref_cache_axes(tree):
    """The reference's cache (shape, axes) tree with each cross (k, v)
    pair named as the port names it."""
    out = dict(tree)
    if "cross" in out:
        out["cross"] = {key: {"k": kv[0], "v": kv[1]}
                        for key, kv in out["cross"].items()}
    return out


@pytest.mark.parametrize("arch", ASSIGNED)
def test_axes_and_cache_shapes_equal_the_reference(arch):
    cfg = get_config(arch)
    jlm = JaxLM(jax_get_config(arch), tp=1)
    assert flatten(axes_tree(LM.spec(cfg))) == \
        flatten(jax_axes_tree(jlm.spec()))
    t_src = 8 if cfg.encoder_decoder else 0
    assert flatten(cache_shapes(cfg, 3, 64, t_src)) == \
        flatten(_ref_cache_axes(jlm.cache_shapes(3, 64, t_src)))


def _every_axes(arch):
    """Every logical-axes tuple of the arch's parameters and cache."""
    cfg = get_config(arch)
    out = set(flatten(axes_tree(LM.spec(cfg))).values())
    t_src = 8 if cfg.encoder_decoder else 0
    for shape, axes in flatten(cache_shapes(cfg, 2, 16, t_src)).values():
        out.add(axes)
    return sorted(out, key=str) + [("batch", "seq"), ("batch", None),
                                   ("batch", None, "embed"), ()]


@pytest.mark.parametrize("names", AXIS_NAMES)
@pytest.mark.parametrize("arch", ASSIGNED)
def test_logical_to_mesh_equals_the_reference(arch, names):
    """Every leaf's spec under the default rules and under every
    applicable cell's rules."""
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    sizes = (2, 16, 16)[-len(names):]
    mesh = tsharding.AbstractMesh(names, sizes)
    jmesh = types.SimpleNamespace(axis_names=names)
    rule_sets = [{}] + [tspecs.cell_rules(cfg, tconfig.SHAPE_CELLS[c])
                        for c in tconfig.applicable_cells(cfg)]
    for c in jconfig.applicable_cells(jcfg):
        assert tspecs.cell_rules(cfg, tconfig.SHAPE_CELLS[c]) == \
            jspecs.cell_rules(jcfg, jconfig.SHAPE_CELLS[c])
    for rules in rule_sets:
        with tsharding.rules_scope(**rules), \
                jsharding.rules_scope(**rules):
            for axes in _every_axes(arch):
                assert tsharding.logical_to_mesh(axes, mesh) == \
                    tuple(jsharding.logical_to_mesh(axes, jmesh)), axes
    assert tsharding.dp_size(mesh) == int(np.prod(sizes[:-1]))
    assert tsharding.tp_size(mesh) == 16
    assert tsharding.chips(mesh) == int(np.prod(sizes))


def _leaves(tree, is_leaf, prefix=""):
    """{path joined with '/': leaf} of nested dicts, lists and tuples;
    dotted parameter names split into the path; the reference's cross
    (k, v) pair named as the port names it."""
    if prefix and is_leaf(tree):
        return {prefix.replace("cross/i0/0", "cross/i0/k").replace(
            "cross/i0/1", "cross/i0/v"): tree}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        key = str(k).replace(".", "/")
        out.update(_leaves(v, is_leaf, f"{prefix}/{key}" if prefix else key))
    return out


def _has_shape(x):
    return hasattr(x, "shape")


def _is_spec(x):
    """A port's partition spec."""
    return isinstance(x, tuple)


def _is_named(x):
    """A reference's ``NamedSharding``."""
    return hasattr(x, "spec")


def _shape_dtype(x):
    if isinstance(x, torch.Tensor):
        return tuple(x.shape), str(x.dtype).replace("torch.", "")
    return tuple(x.shape), str(x.dtype)


@pytest.fixture(scope="module")
def mesh11():
    return Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1),
                ("data", "model"))


@pytest.mark.parametrize("arch,cell", CELLS)
def test_cell_spec_equals_the_reference(mesh11, arch, cell):
    """Shapes, dtypes, donation, parameter bytes and rules of every
    applicable cell, on the reference's (1, 1) mesh; the partition specs
    mirror the arguments leaf for leaf."""
    got = tspecs.cell_spec(get_config(arch), cell,
                           tsharding.AbstractMesh(("data", "model"), (1, 1)))
    with jsharding.mesh_scope(mesh11):
        want = jspecs.cell_spec(jax_get_config(arch), cell, mesh11)
    assert (got.step_kind, got.donate, got.param_bytes, got.rules) == \
        (want.step_kind, want.donate, want.param_bytes, want.rules)
    w = {k: _shape_dtype(v)
         for k, v in _leaves(want.args, _has_shape).items()}
    g = {k: _shape_dtype(v)
         for k, v in _leaves(got.args, _has_shape).items()}
    assert g == w
    specs = _leaves(got.in_shardings, _is_spec)
    assert set(specs) == set(g)
    assert specs == {k: tuple(v.spec) for k, v in
                     _leaves(want.in_shardings, _is_named).items()}


@pytest.mark.parametrize("arch,cell", CELLS)
def test_roofline_terms_equal_the_reference(arch, cell):
    assert troofline.model_flops(arch, cell) == \
        jroofline.model_flops(arch, cell)
    assert troofline.memory_floor_bytes(arch, cell) == \
        jroofline.memory_floor_bytes(arch, cell)


def _dense_forward_flops(cfg, b, s, logits_rows):
    """Products of a dense GQA decoder's forward at (b, s), as (the
    stack's, the head's): projections, the plain attention's full S x S
    scores and P.V, the gated MLP, and the unembedding of ``logits_rows``
    positions a sequence."""
    a = cfg.attention
    d, h, hk, dh = cfg.d_model, a.n_heads, a.n_kv_heads, a.head_dim
    layer = (2 * b * s * d * (h + 2 * hk) * dh + 2 * b * s * h * dh * d
             + 4 * b * h * s * s * dh + 6 * b * s * d * cfg.d_ff)
    return cfg.n_layers * layer, 2 * b * logits_rows * d * cfg.padded_vocab


@pytest.mark.parametrize("arch", ["chatglm3-6b", "phi3-mini-3.8b"])
def test_dry_run_counts_equal_the_config_count(arch):
    """``run_cell`` on meta tensors (no card): the prefill's operations
    equal the count from the config's shapes, and the train step's three
    times the forward's at the global batch (each product's backward is
    two products), and the stack's forward once more (the config's remat
    recomputes each period in the backward); the report says a world of
    one."""
    cfg = get_config(arch)
    assert cfg.remat
    pre = run_cell(arch, "prefill_32k", card=False, verbose=False,
                   save=False)
    assert pre["status"] == "meta_only" and pre["world"] == 1
    assert pre["flops"] == sum(_dense_forward_flops(cfg, 32, 32768, 1))
    train = run_cell(arch, "train_4k", card=False, verbose=False,
                     save=False)
    stack, head = _dense_forward_flops(cfg, 256, 4096, 4096)
    assert train["flops"] == 4 * stack + 3 * head
    assert train["bytes_batch1"]["params"] == 4 * cfg.n_params_dense_equiv()
    rows = [troofline.analyze_report(r) for r in (pre, train)]
    assert [r["dominant"] for r in rows] == ["compute", "compute"]
    assert rows[1]["model_flops"] == jroofline.model_flops(arch, "train_4k")


def test_restore_places_leaves_and_refuses_a_larger_mesh(tmp_path):
    """The elastic restore: a sharding on a mesh of one rank leaves the
    loaded tensor as it is (a world of one); a (16, 16) mesh is refused
    with both sizes named; ``make_test_mesh`` gives a (data, model)
    ``DeviceMesh`` over a world of one, and a larger mesh without the
    ranks is refused."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_production_mesh, make_test_mesh
    from repro_torch.training.checkpoint import CheckpointManager

    ckpt = CheckpointManager(str(tmp_path), device="cpu")
    w = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    ckpt.save(1, {"params": {"w": w}, "step": 1})
    one = tsharding.AbstractMesh(("data", "model"), (1, 1))
    tree = ckpt.restore(1, shardings={"params": {
        "w": tsharding.NamedSharding(one, ("data", "model"))}})
    assert torch.equal(tree["params"]["w"], w)
    big = make_production_mesh()
    with pytest.raises(ValueError, match="256 ranks .* world of 1"):
        ckpt.restore(1, shardings={"params": {
            "w": tsharding.named_sharding(("fsdp", "mlp"), big)}})
    started = not dist.is_initialized()
    try:
        mesh = make_test_mesh(1, 1, device="cpu")
        assert tsharding.mesh_shape(mesh) == {"data": 1, "model": 1}
        from torch.distributed.tensor import Replicate, Shard

        assert tsharding.placements(("data", None), mesh) == \
            (Shard(0), Replicate())
        assert tsharding.placements((None, ("data", "model")), mesh) == \
            (Shard(1), Shard(1))
        with pytest.raises(ValueError, match="takes 2 ranks"):
            make_test_mesh(2, 1, device="cpu")
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()


def test_launcher_trains_at_bf16_with_the_mesh_flags():
    """``launch/train.py --dtype bfloat16 --data-axis 1 --model-axis 1`` on
    the CPU (the smoke config): the loss computed at bf16 from fp32
    masters, finite, the summary naming the dtype."""
    import math

    import torch.distributed as dist

    from repro_torch.launch.train import main

    started = not dist.is_initialized()
    try:
        out = main(["--arch", "chatglm3-6b", "--smoke", "--device", "cpu",
                    "--steps", "2", "--batch", "4", "--seq", "16",
                    "--dtype", "bfloat16", "--data-axis", "1",
                    "--model-axis", "1"])
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()
    assert out["dtype"] == "bfloat16" and len(out["losses"]) == 2
    assert all(math.isfinite(x) for x in out["losses"])
