"""The reference's layouts, for the port's dry-run tests (run as a script,
in a process of its own).

    python tests/_torch_ref_layouts.py specs OUT.json
    python tests/_torch_ref_layouts.py moe OUT.json

``specs``: 512 host devices (``--xla_force_host_platform_device_count``),
the reference's production meshes (16x16 and 2x16x16), and for every
(arch x supported shape x mesh x layout) the leaves of
``repro.launch.specs.input_specs``: each leaf's path (the port's
``training.tree.flatten_with_paths`` naming), global shape, dtype, logical
axes and the shape of device 0's shard (``sharding.shard_shape``).  The
layouts: ``mixserve`` for every arch, ``dp_ep`` and ``pure_tp`` too for the
MoE archs; training plans with FSDP, as the reference's dry run does.
Nothing is lowered or compiled.

``moe``: the shard_map jaxpr of ``repro.models.moe.moe_block`` on a 2x2
host mesh (the first four devices), traced abstractly as
``repro.analysis.trace_contract`` traces it, for the reduced phi3.5 and
deepseek-v2 under mixserve (fused), dp_ep and pure_tp (dropless, no
exchange chunks): the bytes of each collective equation's outputs, summed
by (kind, mesh axes), one device's.
"""

import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import json  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.configs as RC  # noqa: E402
from repro.configs.base import INPUT_SHAPES  # noqa: E402
from repro.core.partitioner import make_plan  # noqa: E402

MOE_ARCHS = ("phi3.5-moe-42b", "deepseek-v2-236b")
MOE_CASE = {"batch": 4, "seq": 8}


def layouts(arch):
    return ("mixserve", "dp_ep", "pure_tp") if arch in MOE_ARCHS \
        else ("mixserve",)


def _path(keys) -> list:
    out = []
    for k in keys:
        if isinstance(k, jax.tree_util.DictKey):
            out.append(k.key)
        elif isinstance(k, jax.tree_util.SequenceKey):
            out.append(k.idx)
        else:                                  # a named tuple's field
            out.append("." + k.name)
    return out


def _axes(cfg, shape, args):
    """The logical axes of every leaf of ``args``, in flatten order."""
    from repro.models.model import cache_axes, param_axes
    is_axes = lambda t: isinstance(t, tuple) and all(  # noqa: E731
        a is None or isinstance(a, str) for a in t)
    pax = param_axes(cfg)
    batch_ax = {"tokens": ("batch", "seq"), "labels": ("batch", "seq"),
                "mask": ("batch", "seq"),
                "embeds": ("batch", "seq", "embed"),
                "frames": ("batch", "seq", "embed")}
    if shape.kind == "train":
        params, opt, batch = args
        trees = (pax, type(opt)(step=(), m=pax, v=pax),
                 {k: batch_ax[k] for k in batch})
    else:
        cax = {**cache_axes(cfg, shape.global_batch, shape.seq_len)}
        if shape.kind == "decode":
            cax["length"] = ("batch",)
            trees = (pax, ("batch", "seq"), cax)
        else:
            trees = (pax, {k: batch_ax[k] for k in args[1]}, cax)
    return jax.tree.leaves(trees, is_leaf=is_axes)


def specs() -> dict:
    from repro.launch.mesh import make_production_mesh
    from repro.launch.specs import input_specs
    out = {}
    for mesh_kind in ("single", "multi"):
        mesh = make_production_mesh(multi_pod=mesh_kind == "multi")
        for arch in RC.ARCH_IDS:
            cfg = RC.get(arch)
            for name, shape in INPUT_SHAPES.items():
                if not RC.shape_supported(cfg, shape):
                    continue
                for layout in layouts(arch):
                    plan = make_plan(layout, mesh,
                                     fsdp=shape.kind == "train")
                    args, shard = input_specs(cfg, shape, plan)
                    leaves = jax.tree_util.tree_flatten_with_path(args)[0]
                    shards = jax.tree.leaves(shard)
                    axes = _axes(cfg, shape, args)
                    assert len(leaves) == len(shards) == len(axes)
                    out[f"{arch}|{name}|{mesh_kind}|{layout}"] = [
                        {"path": _path(p), "shape": list(a.shape),
                         "dtype": str(a.dtype), "axes": list(ax),
                         "shard": list(s.shard_shape(a.shape))}
                        for (p, a), s, ax in zip(leaves, shards, axes)]
    return out


_KIND = {"psum": "all_reduce", "pmax": "all_reduce",
         "all_to_all": "all_to_all", "all_gather": "all_gather",
         "reduce_scatter": "reduce_scatter"}


def _walk(jaxpr, acc: dict) -> None:
    from repro.analysis.trace_contract import _axes_of, _sub_jaxprs
    for eqn in jaxpr.eqns:
        kind = _KIND.get(eqn.primitive.name)
        if kind is not None:
            key = f"{kind} {','.join(sorted(_axes_of(eqn)))}"
            nbytes = sum(int(np.prod(v.aval.shape)) * v.aval.dtype.itemsize
                         for v in eqn.outvars)
            calls, total = acc.get(key, (0, 0))
            acc[key] = (calls + 1, total + nbytes)
            continue
        assert eqn.primitive.name not in ("cond", "while", "scan"), \
            eqn.primitive.name
        for sub in _sub_jaxprs(eqn):
            _walk(sub, acc)


def moe() -> dict:
    from jax.sharding import Mesh
    from repro.models import moe as M
    from repro.models.param import init_tree
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2),
                ("data", "model"))
    out = {}
    for arch in MOE_ARCHS:
        cfg = RC.get_reduced(arch)
        for layout in layouts(arch):
            plan = make_plan(layout, mesh)
            p = jax.eval_shape(
                lambda k: init_tree(k, M.moe_spec(cfg), jnp.float32),
                jax.ShapeDtypeStruct((2,), jnp.uint32))
            x = jax.ShapeDtypeStruct(
                (MOE_CASE["batch"], MOE_CASE["seq"], cfg.d_model),
                jnp.float32)
            jaxpr = jax.make_jaxpr(
                lambda pp, xx: M.moe_block(pp, xx, cfg, plan))(p, x)
            acc: dict = {}
            _walk(jaxpr.jaxpr, acc)
            out[f"{arch}|{layout}"] = {k: {"calls": c, "bytes": b}
                                       for k, (c, b) in sorted(acc.items())}
    return out


if __name__ == "__main__":
    mode, path = sys.argv[1], sys.argv[2]
    res = {"specs": specs, "moe": moe}[mode]()
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(res, f)
    os.replace(tmp, path)
