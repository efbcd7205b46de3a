"""The reference's own mesh gradient of a dropless training objective, in
float64 (run as a script, in a process of its own).

    python tests/_torch_ref_mesh_grads.py WORKDIR ARCH CASE [CASE ...]

Reads the reference's numpy weights from ``WORKDIR/weights-<ARCH>.pkl``
(as ``_torch_dist_train_ranks.write_weights`` leaves them), makes 4 host
devices (``--xla_force_host_platform_device_count=4``), turns on
``jax_enable_x64`` and makes ``jnp.float32`` name float64 in this process
(the reference's float32 upcasts then run in float64, as
``_torch_dist_train_ranks.float_is_f64`` does for the port), and takes
``jax.value_and_grad`` of the reference's ``loss_fn`` under the reference's
own ``make_plan(layout, 2x2 mesh, comm_algo, dispatch="dropless",
ep_overlap=...)``: cross-entropy on the whole batch plus the coefficient
times the router aux, which the mesh defines as the mean of every rank's.
Each CASE is a ``_torch_dist_train_dropless_ranks.REF_CASES`` id; its loss
and its whole gradient, in the port's layout and leaf paths, go to
``WORKDIR/ref-<CASE>.npz`` (written whole, then renamed into place).
"""

import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402

jnp.float32 = jnp.float64

import dataclasses  # noqa: E402
import pathlib  # noqa: E402
import pickle  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

import _torch_dist_train_dropless_ranks as DR  # noqa: E402
import _torch_dist_train_ranks as D  # noqa: E402
import repro.configs as RC  # noqa: E402
from repro.core.cost_model import EpOverlap  # noqa: E402
from repro.core.partitioner import make_plan  # noqa: E402
from repro.kernels.policy import KernelPolicy  # noqa: E402
from repro.training.train_step import loss_fn  # noqa: E402
from repro_torch.bridge import from_reference  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.training.tree import flatten_with_paths  # noqa: E402


def main(workdir, arch, case_ids):
    workdir = pathlib.Path(workdir)
    weights = pickle.loads((workdir / f"weights-{arch}.pkl").read_bytes())
    params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), weights)
    rcfg = dataclasses.replace(RC.get_reduced(arch), capacity_factor=D.CF)
    tcfg = D.cfg_for(arch)
    b = {k: jnp.asarray(v.numpy()) for k, v in DR.ref_batch(tcfg).items()}
    # Auto axes: the reference's sharding constraints need them (jax's
    # make_mesh now defaults to Explicit axes)
    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    for cid in case_ids:
        lay, algo, _ = DR.REF_CASES[cid]
        # the port's plan of the case (its layout alone: no ranks join)
        ovl = DR.ref_plan(cid, Mesh(("data", "model"), (2, 2), 0),
                          tcfg).ep_overlap
        ovl = None if ovl is None else EpOverlap(chunks=ovl.chunks,
                                                 cap_rows=ovl.cap_rows)
        plan = make_plan(lay, mesh, algo, kernels=KernelPolicy(),
                         dispatch="dropless", ep_overlap=ovl)
        with mesh:
            (loss, _), g = jax.jit(jax.value_and_grad(
                lambda p, bb: loss_fn(p, bb, rcfg, plan, remat=False),
                has_aux=True))(params, b)
        whole = from_reference(jax.tree.map(np.asarray, g), tcfg,
                               dtype=torch.float64)
        out = {"/".join(map(str, p)): t.numpy()
               for p, t in flatten_with_paths(whole)}
        out["loss"] = np.asarray(float(loss))
        tmp = workdir / f"ref-{cid}.tmp.npz"
        np.savez(tmp, **out)
        tmp.rename(workdir / f"ref-{cid}.npz")


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2], sys.argv[3:])
