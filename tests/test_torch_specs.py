"""The dry run's plan against the JAX package's: input specs, the
production meshes, every leaf's mesh axes and shard shape, and the
argument bytes one device holds.

The reference's side runs on a ``jax.sharding.AbstractMesh``, which needs
no devices.  Importing ``repro.launch.dryrun`` writes a 512-device
``XLA_FLAGS`` into the environment (its prologue); the fixture restores
the variable at once, so neither this process's backend nor a later
subprocess sees it.
"""
import math
import os

import pytest

torch = pytest.importorskip("torch")

from jax.sharding import AbstractMesh, NamedSharding  # noqa: E402

from repro import sharding as jsh  # noqa: E402
from repro.configs import ARCH_IDS, get_config as jax_config  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.models import transformer as JT  # noqa: E402

from repro_torch import sharding as tsh  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import dryrun, specs  # noqa: E402
from repro_torch.launch.mesh import (  # noqa: E402
    make_host_mesh,
    make_production_mesh,
)
from repro_torch.models import transformer as TT  # noqa: E402

MESHES = {"16x16": False, "2x16x16": True}
RULES = {"fed_mesh": "FED_MESH_RULES", "fsdp": "FSDP_RULES",
         "replicated_server": "REPLICATED_SERVER_RULES"}


@pytest.fixture(scope="module")
def ref_dryrun():
    before = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as ref
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before
    return ref


def _abstract_mesh(multi_pod):
    sizes = make_production_mesh(multi_pod=multi_pod)
    return AbstractMesh(tuple(sizes.values()), tuple(sizes))


def _norm(spec):
    """A spec's entries as tuples of axis names (``()`` unsharded), its
    trailing unsharded entries dropped: ``P('data')``, ``P(('data',),
    None)`` and ``(('data',), None)`` name one placement."""
    out = [() if e is None else ((e,) if isinstance(e, str) else tuple(e))
           for e in spec]
    while out and out[-1] == ():
        out.pop()
    return tuple(out)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {prefix: tree}


def test_production_and_host_meshes():
    assert make_production_mesh() == {"data": 16, "model": 16}
    assert make_production_mesh(multi_pod=True) == {"pod": 2, "data": 16,
                                                    "model": 16}
    for multi_pod in (False, True):
        am = _abstract_mesh(multi_pod)
        assert dict(am.shape) == make_production_mesh(multi_pod=multi_pod)
    assert make_host_mesh(device="cpu") == {"data": 1, "model": 1}
    with pytest.raises(ValueError):
        make_host_mesh(model=2, device="cpu")


def test_host_mesh_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: make_host_mesh() uses it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_host_mesh()


def _check_tree(jax_tree, jax_axes, torch_tree, torch_axes, rules_name,
                multi_pod):
    am = _abstract_mesh(multi_pod)
    mesh = make_production_mesh(multi_pod=multi_pod)
    jrules, trules = getattr(jsh, RULES[rules_name]), getattr(
        tsh, RULES[rules_name])
    shard = _flat(tsh.tree_shardings(torch_axes, trules, mesh, torch_tree))
    plain = _flat(tsh.tree_shardings(torch_axes, trules, mesh))
    fa, fj = _flat(jax_axes), _flat(jax_tree)
    assert sorted(shard) == sorted(fa)
    for path, axes in fa.items():
        shape = fj[path].shape
        ref = jsh.logical_spec(axes, jrules, am, shape)
        got = shard[path]
        assert _norm(got.spec) == _norm(ref), (path, got.spec, ref)
        assert got.shard_shape(shape) == NamedSharding(am, ref).shard_shape(
            shape), path
        assert _norm(plain[path].spec) == _norm(
            jsh.logical_spec(axes, jrules, am)), path


@pytest.mark.parametrize("multi_pod", MESHES.values(), ids=MESHES.keys())
@pytest.mark.parametrize("rules_name", RULES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_and_cache_shardings_equal_the_reference(arch, rules_name,
                                                       multi_pod):
    jp, ja = JT.abstract_params(jax_config(arch))
    tp, ta = TT.abstract_params(get_config(arch))
    _check_tree(jp, ja, tp, ta, rules_name, multi_pod)
    for shape in specs.INPUT_SHAPES.values():
        if shape.kind == "train":
            continue
        jc, jca = JT.init_cache(jax_config(arch), shape.global_batch,
                                shape.seq, abstract=True)
        tc, tca = TT.init_cache(get_config(arch), shape.global_batch,
                                shape.seq, abstract=True)
        _check_tree(jc, jca, tc, tca, rules_name, multi_pod)


def _check_specs(jtree, jspec, ttree, tspec, am):
    fj, fjs = _flat(jtree), _flat(jspec)
    ft, fts = _flat(ttree), _flat(tspec)
    assert sorted(fj) == sorted(ft)
    sizes = dict(am.shape)
    for path in fj:
        assert tuple(ft[path].shape) == tuple(fj[path].shape), path
        assert ft[path].dtype == getattr(torch, str(fj[path].dtype)), path
        assert ft[path].device.type == "meta"
        assert _norm(fts[path]) == _norm(fjs[path]), path
        got = tsh.MeshSharding(fts[path], tuple(sizes.items()))
        assert got.shard_shape(ft[path].shape) == NamedSharding(
            am, fjs[path]).shard_shape(fj[path].shape), path


@pytest.mark.parametrize("multi_pod", MESHES.values(), ids=MESHES.keys())
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_specs_equal_the_reference(arch, multi_pod):
    am = _abstract_mesh(multi_pod)
    mesh = make_production_mesh(multi_pod=multi_pod)
    jcfg, tcfg = jax_config(arch), get_config(arch)
    assert specs.placement_for(arch) == jspecs.placement_for(arch)
    for name, shape in specs.INPUT_SHAPES.items():
        jshape = jspecs.INPUT_SHAPES[name]
        assert (shape.kind, shape.seq, shape.global_batch) == (
            jshape.kind, jshape.seq, jshape.global_batch)
        ok, why = specs.shape_applicable(arch, tcfg, shape)
        assert (ok, why) == jspecs.shape_applicable(arch, jcfg, jshape)
        if not ok:
            continue
        if shape.kind == "train":
            placement = specs.placement_for(arch)
            assert specs.round_geometry(shape, placement, mesh) == \
                jspecs.round_geometry(jshape, placement, am)
            jb, jbs, jw, jws = jspecs.train_batch_specs(
                arch, jcfg, jshape, placement, am)
            tb, tbs, tw, tws = specs.train_batch_specs(
                arch, tcfg, shape, placement, mesh)
            _check_specs({"b": jb, "w": jw}, {"b": jbs, "w": jws},
                         {"b": tb, "w": tw}, {"b": tbs, "w": tws}, am)
        else:
            jb, jbs = jspecs.serve_batch_specs(arch, jcfg, jshape, am)
            tb, tbs = specs.serve_batch_specs(arch, tcfg, shape, mesh)
            _check_specs(jb, jbs, tb, tbs, am)


def test_round_geometry_refuses_a_batch_that_does_not_split():
    shape = specs.InputShape("odd", "train", 16, 100)
    with pytest.raises(ValueError, match="does not split"):
        specs.round_geometry(shape, "mesh", make_production_mesh())


def test_shard_shape_refuses_an_indivisible_dimension():
    sh = tsh.logical_sharding(("heads",), tsh.FED_MESH_RULES,
                              make_production_mesh())
    assert sh.spec == ("model",)
    assert sh.shard_shape((32,)) == (2,)
    with pytest.raises(ValueError, match="not divisible"):
        sh.shard_shape((40,))
    # with the shape, the mesh axis that does not divide is dropped
    assert tsh.logical_sharding(("heads",), tsh.FED_MESH_RULES,
                                make_production_mesh(), (40,)).spec == (None,)


def _ref_arg_bytes(ref, arch, shape_name, multi_pod, variant):
    am = _abstract_mesh(multi_pod)
    cfg = jax_config(arch)
    shape = jspecs.INPUT_SHAPES[shape_name]
    placement = jspecs.placement_for(arch)
    rules = ref.rules_for(placement, variant, shape.kind)
    with jsh.axis_rules(am, rules):
        build = ref.build_train if shape.kind == "train" else ref.build_serve
        _, _, _, geo = build(arch, cfg, shape, am, variant, rules)
    return geo


@pytest.mark.parametrize("variant", ["zero", "replicated", "mp_serve",
                                     "seq_cache"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_arg_bytes_per_dev_equal_the_reference(ref_dryrun, arch, variant):
    assert dryrun.VARIANT_OVERRIDES == ref_dryrun.VARIANT_OVERRIDES
    n = 0
    for multi_pod in MESHES.values():
        mesh = make_production_mesh(multi_pod=multi_pod)
        for name, shape in specs.INPUT_SHAPES.items():
            cfg = get_config(arch)
            if not specs.shape_applicable(arch, cfg, shape)[0]:
                continue
            placement = specs.placement_for(arch)
            rules = dryrun.rules_for(placement, variant, shape.kind)
            assert rules == ref_dryrun.rules_for(placement, variant,
                                                 shape.kind)
            build = (dryrun.build_train if shape.kind == "train"
                     else dryrun.build_serve)
            _, _, geo = build(arch, cfg, shape, mesh, variant, rules)
            ref = _ref_arg_bytes(ref_dryrun, arch, name, multi_pod, variant)
            assert geo["arg_bytes_per_dev"] == ref["arg_bytes_per_dev"], (
                name, multi_pod)
            if shape.kind == "train":
                assert (geo["C"], geo["H"], geo["b"]) == (
                    ref["C"], ref["H"], ref["b"])
            n += 1
    assert n >= 6


def test_arg_bytes_count_every_leaf_once():
    """The sum is over the plan's leaves: a replicated mesh (every rule
    None) holds every argument whole."""
    arch, shape = "gemma3-1b", specs.INPUT_SHAPES["decode_32k"]
    cfg = get_config(arch)
    rules = {k: None for k in tsh.FED_MESH_RULES}
    _, _, geo = dryrun.build_serve(arch, cfg, shape, make_production_mesh(),
                                   "zero", rules)
    params, _ = TT.abstract_params(cfg)
    cache, _ = TT.init_cache(cfg, shape.global_batch, shape.seq,
                             abstract=True)
    whole = sum(math.prod(x.shape) * x.element_size()
                for x in list(_flat(params).values())
                + list(_flat(cache).values()))
    # the request tokens shard over the data axis whatever the rules, as
    # the reference's serve_batch_specs places them; pos is one int32
    assert geo["arg_bytes_per_dev"] == whole + shape.global_batch // 16 * 4 + 4
